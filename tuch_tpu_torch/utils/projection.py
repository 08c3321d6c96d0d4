"""Camera projection and the weak-perspective translation, batched.

Counterpart of tuch_tpu/utils/projection.py.
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
    if isinstance(focal_length, (int, float)) and points.dtype in (
            torch.float32, torch.float64):
        # a number multiplies as it is, rounded to points' dtype as the
        # tensor below would be: that tensor is copied to the device at
        # each call, which waits for the device
        f = float(focal_length)
    else:
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


def estimate_translation(S: torch.Tensor, joints_2d: torch.Tensor,
                         focal_length: float = 5000.0,
                         img_size: float = 224.0,
                         has_2d_kp_anno: torch.Tensor = None
                         ) -> torch.Tensor:
    """Weighted least-squares camera translation, batched.

    S (B, J, 3) 3D joints; joints_2d (B, J, 3) pixels and confidence;
    has_2d_kp_anno (B,) bool: such samples use the ground-truth joints
    (25:), the others the OpenPose joints (:25), by zeroing the other
    slice's confidences. Per sample, t = (tx, ty, tz) minimises
        sum_j w_j || f (X_j + t_xy) - (p_j - c) (Z_j + t_z) ||^2,
    linear in t: the normal equations of the rows [f, 0, c_x - p_x] and
    [0, f, c_y - p_y] against (p - c) Z - f XY, each row weighted by
    sqrt(conf). A sample whose confidences are all 0 gets t = 0.
    """
    B, J, _ = S.shape
    conf = joints_2d[..., 2]
    if has_2d_kp_anno is not None:
        op_mask = torch.arange(J, device=S.device) < 25
        keep = torch.where(has_2d_kp_anno.bool()[:, None], ~op_mask[None],
                           op_mask[None])
        conf = conf * keep.to(conf.dtype)
    p = joints_2d[..., :2]
    f = focal_length
    c = img_size / 2.0
    Z = S[..., 2]
    XY = S[..., :2]

    zeros = torch.zeros_like(Z)
    f_arr = torch.full_like(Z, f)
    row_x = torch.stack([f_arr, zeros, c - p[..., 0]], dim=-1)  # (B, J, 3)
    row_y = torch.stack([zeros, f_arr, c - p[..., 1]], dim=-1)
    Q = torch.stack([row_x, row_y], dim=2).reshape(B, 2 * J, 3)
    rhs = torch.stack([(p[..., 0] - c) * Z - f * XY[..., 0],
                       (p[..., 1] - c) * Z - f * XY[..., 1]],
                      dim=-1).reshape(B, 2 * J)

    w = torch.sqrt(torch.clamp(conf, min=0.0))
    w2 = torch.repeat_interleave(w, 2, dim=-1)   # each joint's two rows
    Qw = Q * w2[..., None]
    rw = rhs * w2
    A = torch.einsum('bij,bik->bjk', Qw, Qw)
    b = torch.einsum('bij,bi->bj', Qw, rw)
    # regularise the all-zero-confidence sample so the solve is defined
    valid = conf.sum(-1) > 0
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    A = A + (1e-6 + (~valid).to(A.dtype))[:, None, None] * eye[None]
    t = torch.linalg.solve(A, b[..., None])[..., 0]
    return torch.where(valid[:, None], t, torch.zeros_like(t))
