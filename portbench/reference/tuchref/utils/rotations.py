"""Rotation representations on batched tensors.

Counterpart of tuch_tpu/utils/rotations.py, with the same numerics: the
+1e-8 inside the Rodrigues angle norm, the row-interleaved 6d layout and the
branch-free rotation-matrix -> quaternion conversion.
"""

import torch


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """Quaternions (..., 4) (w, x, y, z) -> rotation matrices (..., 3, 3)."""
    quat = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
    w, x, y, z = quat.unbind(-1)
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    rot = torch.stack([
        w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
        2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
        2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
    ], dim=-1)
    return rot.reshape(quat.shape[:-1] + (3, 3))


def batch_rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3).

    The angle is the norm of (theta + 1e-8) and the conversion goes through
    a quaternion, as in the reference.
    """
    angle = torch.linalg.norm(aa + 1e-8, dim=-1, keepdim=True)
    axis = aa / angle
    half = angle * 0.5
    quat = torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)
    return quat_to_rotmat(quat)


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """6D rotation representation -> (N, 3, 3) by Gram-Schmidt.

    The input is reshaped to (-1, 3, 2): row-interleaved
    [r11, r12, r21, r22, r31, r32]; the two columns are orthonormalised.
    """
    x = x.reshape(-1, 3, 2)
    a1, a2 = x[:, :, 0], x[:, :, 1]
    b1 = a1 / torch.clamp(torch.linalg.norm(a1, dim=-1, keepdim=True),
                          min=1e-8)
    dot = torch.sum(b1 * a2, dim=-1, keepdim=True)
    b2u = a2 - dot * b1
    b2 = b2u / torch.clamp(torch.linalg.norm(b2u, dim=-1, keepdim=True),
                           min=1e-8)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> quaternions (..., 4) (w, x, y, z).

    Branch-free Shepperd-style conversion: all four candidate constructions
    are computed and the one with the largest squared pivot is selected.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    # Four candidates, each scaled by 4 * q_i^2 (all >= 0 up to fp error).
    qw2 = 1.0 + m00 + m11 + m22
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def safe_sqrt(v):
        return torch.sqrt(torch.clamp(v, min=1e-12))

    w_w = safe_sqrt(qw2) / 2.0
    cand_w = torch.stack([
        w_w, (m21 - m12) / (4 * w_w), (m02 - m20) / (4 * w_w),
        (m10 - m01) / (4 * w_w)], dim=-1)
    x_x = safe_sqrt(qx2) / 2.0
    cand_x = torch.stack([
        (m21 - m12) / (4 * x_x), x_x, (m01 + m10) / (4 * x_x),
        (m02 + m20) / (4 * x_x)], dim=-1)
    y_y = safe_sqrt(qy2) / 2.0
    cand_y = torch.stack([
        (m02 - m20) / (4 * y_y), (m01 + m10) / (4 * y_y), y_y,
        (m12 + m21) / (4 * y_y)], dim=-1)
    z_z = safe_sqrt(qz2) / 2.0
    cand_z = torch.stack([
        (m10 - m01) / (4 * z_z), (m02 + m20) / (4 * z_z),
        (m12 + m21) / (4 * z_z), z_z], dim=-1)

    mags = torch.stack([qw2, qx2, qy2, qz2], dim=-1)
    idx = torch.argmax(mags, dim=-1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], dim=-2)
    quat = torch.take_along_dim(
        cands, idx[..., None, None].expand(idx.shape + (1, 4)),
        dim=-2).squeeze(-2)
    quat = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
    # Canonicalise the sign (w >= 0).
    return quat * torch.where(quat[..., :1] < 0, -1.0, 1.0)


def quat_to_aa(quat: torch.Tensor) -> torch.Tensor:
    """Quaternions (..., 4) -> axis-angle (..., 3)."""
    w = torch.clamp(quat[..., 0], -1.0, 1.0)
    xyz = quat[..., 1:]
    s2 = torch.sum(xyz * xyz, dim=-1, keepdim=True)
    pos = s2 > 0
    sin_half = torch.sqrt(torch.where(pos, s2, torch.ones_like(s2))) * pos
    angle = 2.0 * torch.atan2(sin_half[..., 0], w)[..., None]
    # Near angle 0 the axis is ill-defined; the small-angle limit of
    # axis * angle is 2 * xyz / w, taken to first order.
    axis = xyz / torch.clamp(sin_half, min=1e-12)
    small = sin_half < 1e-6
    return torch.where(small, 2.0 * xyz, axis * angle)


def rotmat_to_aa(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> axis-angle (..., 3)."""
    return quat_to_aa(rotmat_to_quat(R))


def rot_z_deg(deg: torch.Tensor) -> torch.Tensor:
    """Rotation about +z by -deg degrees, (...) -> (..., 3, 3): a crop
    rotated by rot degrees rotates the global orientation by R_z(-rot)."""
    rad = -torch.deg2rad(deg)
    c, s = torch.cos(rad), torch.sin(rad)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, z], dim=-1),
                        torch.stack([s, c, z], dim=-1),
                        torch.stack([z, z, o], dim=-1)], dim=-2)


def rot_aa(aa: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """Rotate axis-angle global orientations (..., 3) by deg image degrees
    (broadcastable to aa.shape[:-1])."""
    return rotmat_to_aa(rot_z_deg(deg) @ batch_rodrigues(aa))


def flip_pose(pose: torch.Tensor, flip_perm) -> torch.Tensor:
    """Flip SMPL poses (..., 72) left <-> right: permute the joints by
    flip_perm (constants.SMPL_POSE_FLIP_PERM) and negate the y and z
    axis-angle components."""
    pose = pose[..., torch.as_tensor(flip_perm, device=pose.device)]
    sign = torch.ones(pose.shape[-1], dtype=pose.dtype, device=pose.device)
    sign[1::3] = -1.0
    sign[2::3] = -1.0
    return pose * sign
