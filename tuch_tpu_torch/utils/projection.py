"""Camera projection and the weak-perspective translation, batched.

Counterpart of tuch_tpu/utils/projection.py (the parts serving needs).
"""

import torch


def perspective_projection(points: torch.Tensor, rotation: torch.Tensor,
                           translation: torch.Tensor, focal_length,
                           camera_center: torch.Tensor) -> torch.Tensor:
    """Project 3D points to the image plane.

    points (B, N, 3); rotation (B, 3, 3); translation (B, 3); focal_length a
    scalar or (B,); camera_center (B, 2). Returns (B, N, 2).
    """
    pts = torch.einsum('bij,bkj->bki', rotation, points) \
        + translation[:, None, :]
    xy = pts[..., :2] / pts[..., 2:3]
    f = torch.as_tensor(focal_length, dtype=points.dtype,
                        device=points.device)
    f = f.reshape(-1, 1, 1) if f.dim() else f
    return f * xy + camera_center[:, None, :]


def weak_perspective_to_translation(pred_camera: torch.Tensor,
                                    focal_length: float,
                                    img_res: int) -> torch.Tensor:
    """(s, tx, ty) weak-perspective camera -> 3D translation
    [tx, ty, 2 f / (img_res * s + 1e-9)]."""
    return torch.stack([
        pred_camera[:, 1],
        pred_camera[:, 2],
        2.0 * focal_length / (img_res * pred_camera[:, 0] + 1e-9),
    ], dim=-1)
