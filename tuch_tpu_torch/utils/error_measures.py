"""Joint-angle error measures (MPJAE variants) on tensors.

Counterpart of tuch_tpu/utils/error_measures.py (the reference's
tuch/utils/error_measures.py): geodesic rotation distance via quaternions
and the mean per-joint angle error.
"""

import math

import torch

from tuch_tpu_torch.utils.rotations import batch_rodrigues, rotmat_to_quat


def quat_angle_distance(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Geodesic angle between quaternions (..., 4) -> (...) radians."""
    dot = (q1 * q2).sum(dim=-1).abs()
    return 2.0 * torch.arccos(dot.clamp(-1.0, 1.0))


def rotmat_angle_distance(R1: torch.Tensor, R2: torch.Tensor
                          ) -> torch.Tensor:
    """Geodesic angle between rotation matrices (..., 3, 3) -> (...)."""
    return quat_angle_distance(rotmat_to_quat(R1), rotmat_to_quat(R2))


def mpjae(pred_pose: torch.Tensor, gt_pose: torch.Tensor,
          degrees: bool = True) -> torch.Tensor:
    """Mean per-joint angle error for (B, 72) axis-angle poses -> (B,)."""
    R1 = batch_rodrigues(pred_pose.reshape(-1, 24, 3))
    R2 = batch_rodrigues(gt_pose.reshape(-1, 24, 3))
    out = rotmat_angle_distance(R1, R2).mean(dim=-1)  # (B, 24) -> (B,)
    return out * (180.0 / math.pi) if degrees else out
