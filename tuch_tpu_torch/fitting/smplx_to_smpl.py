"""SMPL-X -> SMPL parameter conversion by vertex fitting.

Counterpart of tuch_tpu/fitting/smplx_to_smpl.py (which replaces the
reference's tuch/utils/smplxtosmpl_mtp.py): a batched Adam fit of SMPL
pose, betas and translation to target vertices, the whole shard at once.
The JAX package runs the steps as one jitted `lax.scan`; here they are an
eager loop on tensors, on whatever device the targets lie on. Reference
semantics by default: the loss is the MEAN PER-VERTEX L2 NORM
(losses/smplify.zero_safe_norm: zero gradient at a coincident vertex), the
global orientation pose[:3] is held fixed, and the translation is a real
parameter started at the centroid difference and frozen (its updates zero)
unless fit_translation. Adam is optax's, with its fp32 bias corrections
(fitting/smplify_dc.Adam). Deviations (MSE loss, free global orient) are
opt-in arguments.
"""

from typing import NamedTuple, Optional

import torch

from tuch_tpu_torch.fitting.smplify_dc import Adam, value_and_grad
from tuch_tpu_torch.losses.smplify import zero_safe_norm
from tuch_tpu_torch.models.smpl import SMPL, smpl_forward_pose72


class VertexFitResult(NamedTuple):
    pose: torch.Tensor    # (B, 72)
    betas: torch.Tensor   # (B, 10)
    loss: torch.Tensor    # (B,) final per-sample loss (see `loss` arg)


def _correspond(correspondence: torch.Tensor, v: torch.Tensor
                ) -> torch.Tensor:
    """(T, V) x (B, V, 3) -> (B, T, 3) in full fp32: TF32 off whatever the
    global flag says (a single-pass TF32 product keeps 10 mantissa bits,
    far coarser than the fit's fp32 bar)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.einsum('tv,bvd->btd', correspondence, v)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def fit_smpl_to_vertices(model: SMPL,
                         target_vertices: torch.Tensor,
                         init_pose: Optional[torch.Tensor] = None,
                         init_betas: Optional[torch.Tensor] = None,
                         correspondence: Optional[torch.Tensor] = None,
                         num_steps: int = 5000,
                         lr: float = 1e-2,
                         fit_translation: bool = False,
                         optimize_global_orient: bool = False,
                         loss: str = 'norm') -> VertexFitResult:
    """Fit SMPL parameters to target vertices (B, T, 3).

    correspondence: optional (T, V) matrix mapping SMPL vertices to the
    target topology (identity when T == V). loss='norm' is the reference's
    mean per-vertex L2 norm; loss='mse' (opt-in) the mean squared error.
    Returns the fitted pose (pose[:3] the init's unless
    optimize_global_orient), betas and each sample's loss after the last
    step.
    """
    B = target_vertices.shape[0]
    dev, dt = target_vertices.device, target_vertices.dtype
    pose0 = torch.zeros(B, 72, device=dev, dtype=dt) if init_pose is None \
        else init_pose
    betas0 = torch.zeros(B, 10, device=dev, dtype=dt) if init_betas is None \
        else init_betas

    def vertices(pose, betas, transl):
        v = smpl_forward_pose72(model, betas, pose).vertices
        if correspondence is not None:
            v = _correspond(correspondence, v)
        return v + transl[:, None, :]

    def full_pose(pose):
        return pose if optimize_global_orient else \
            torch.cat([pose0[:, :3], pose[:, 3:]], dim=1)

    def per_sample(p):
        d = vertices(full_pose(p['pose']), p['betas'], p['transl']) \
            - target_vertices
        if loss == 'mse':
            return (d * d).mean(dim=(1, 2))
        return zero_safe_norm(d).mean(dim=1)

    transl0 = torch.zeros(B, 3, device=dev, dtype=dt)
    if fit_translation:
        with torch.no_grad():
            v0 = vertices(pose0, betas0, transl0)
        transl0 = target_vertices.mean(dim=1) - v0.mean(dim=1)

    params = {'pose': pose0, 'betas': betas0, 'transl': transl0}
    opt = Adam(params, lr)
    for _ in range(num_steps):
        _, grads = value_and_grad(lambda p: per_sample(p).mean(), params)
        if not fit_translation:   # optax.masked(set_to_zero()) before adam
            grads['transl'] = torch.zeros_like(grads['transl'])
        params = opt.step(params, grads)
    with torch.no_grad():
        final = per_sample(params)
    return VertexFitResult(pose=full_pose(params['pose']).detach(),
                           betas=params['betas'].detach(), loss=final)
