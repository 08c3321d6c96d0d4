"""Procrustes alignment and the reconstruction-error metrics, batched.

Counterpart of tuch_tpu/utils/procrustes.py: one batched torch.linalg.svd
in place of the reference's per-sample numpy loop
(tuch/utils/pose_utils.py:28-93), the same math.
"""

import torch


def compute_similarity_transform(S1: torch.Tensor,
                                 S2: torch.Tensor) -> torch.Tensor:
    """Batched orthogonal Procrustes: S1 (B, N, 3) aligned to S2 by a
    scale, rotation and translation, s R S1 + t, (B, N, 3)."""
    mu1 = S1.mean(dim=1, keepdim=True)
    mu2 = S2.mean(dim=1, keepdim=True)
    X1, X2 = S1 - mu1, S2 - mu2
    var1 = (X1 ** 2).sum(dim=(1, 2))
    K = torch.einsum('bni,bnj->bij', X1, X2)
    U, _, Vh = torch.linalg.svd(K)
    V = Vh.transpose(-1, -2)
    det = torch.linalg.det(torch.einsum('bij,bkj->bik', U, V))
    # Z = diag(1, 1, sign(det)): a rotation, det(R) = 1
    Z = torch.eye(3, dtype=K.dtype, device=K.device).repeat(K.shape[0], 1, 1)
    Z[:, -1, -1] = torch.sign(det)
    R = torch.einsum('bij,bjk,blk->bil', V, Z, U)
    # trace(R K), as pose_utils.py:64 (not the Frobenius product)
    scale = torch.einsum('bij,bji->b', R, K) / var1.clamp(min=1e-12)
    t = mu2 - scale[:, None, None] * torch.einsum('bij,bkj->bki', R, mu1)
    return scale[:, None, None] * torch.einsum('bij,bnj->bni', R, S1) + t


def reconstruction_error(S1, S2, reduction='mean'):
    """Procrustes-aligned mean joint error (PA-MPJPE), (B, N, 3) -> the
    mean, the sum or (B,) (reduction None)."""
    S1_hat = compute_similarity_transform(S1, S2)
    re = torch.sqrt(((S1_hat - S2) ** 2).sum(dim=-1)).mean(dim=-1)
    if reduction == 'mean':
        return re.mean()
    if reduction == 'sum':
        return re.sum()
    return re


def mpjpe(pred_joints, gt_joints):
    """Mean per-joint position error, (B, N, 3) -> (B,)."""
    return torch.sqrt(((pred_joints - gt_joints) ** 2).sum(dim=-1)).mean(
        dim=-1)
