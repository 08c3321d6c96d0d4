"""Training losses of the HMR regressor: the SPIN terms and self-contact.

Counterpart of tuch_tpu/losses/regressor.py. Every term is batched and
every "empty selection gives 0" is a mask.

With a mesh (parallel/mesh.Mesh) the batch is this rank's dp slice, and
each mean over the batch divides by the global batch's count (the count
summed over dp, never a mean of local means), so the loss of a rank is its
share of the global loss and the shares' gradients sum over dp to the
global gradient. The contact loss's compaction picks from the global
batch, and with cp > 1 its quadratics split over cp.

The contact loss pulls every exterior vertex towards its nearest allowed
vertex and pushes interior ones out (the in-loop fit's push_pull_terms
pulls only exterior vertices in contact: the two differ on purpose, as in
the JAX package). With the HD surface the same energies are evaluated on a
fixed top-K of dense points nearest to contact: their in/out test is
kernel 2 at Q = K, and their masked nearest HD point is a Gram-form
product in full fp32 (ops/contact.masked_sq_dists_highest).
"""

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from tuch_tpu_torch.losses.smplify import (ContactAssets, _top_k,
                                           compact_overflow_frac,
                                           compact_take, self_contact_terms,
                                           zero_safe_norm)
from tuch_tpu_torch.ops import contact as contact_ops
from tuch_tpu_torch.ops import contact_kernels as CK
from tuch_tpu_torch.parallel import mesh as PM
from tuch_tpu_torch.utils.rotations import batch_rodrigues


class LossWeights(NamedTuple):
    shape: float = 0.0
    keypoint: float = 5.0
    pose: float = 1.0
    beta: float = 0.01
    contact: float = 1e-5
    openpose_train_weight: float = 1.0
    gt_train_weight: float = 1.0


def _masked_mean(values: torch.Tensor, mask: torch.Tensor,
                 mesh=None) -> torch.Tensor:
    """Mean of values[mask], 0 when the mask is empty; under a dp mesh
    this rank's share of the global batch's mean (its sum over the global
    count)."""
    m = mask.to(values.dtype)
    denom = PM.dp_sum(m.sum(), mesh)
    return torch.where(denom > 0, (values * m).sum() / denom.clamp(min=1.0),
                       torch.zeros_like(denom))


def keypoint_loss(pred_kp2d, gt_kp2d, openpose_weight, gt_weight,
                  valid_fit, mesh=None):
    """Confidence-weighted 2D reprojection MSE: pred (B, 49, 2), gt
    (B, 49, 3) with confidence; per-sample mean, then the mean over
    valid_fit."""
    conf = gt_kp2d[..., 2:3]
    w = torch.cat([torch.full((25,), openpose_weight),
                   torch.full((24,), gt_weight)]).to(conf)
    conf = conf * w[None, :, None]
    per_sample = (conf * (pred_kp2d - gt_kp2d[..., :2]) ** 2).mean((1, 2))
    return _masked_mean(per_sample, valid_fit, mesh)


def keypoint_3d_loss(pred_joints, gt_joints, has_pose_3d, mesh=None):
    """Pelvis-aligned 3D keypoint MSE over the 24 ground-truth joints of
    pred_joints (B, 49, 3) (25:) against gt_joints (B, 24, 4)."""
    pred = pred_joints[:, 25:, :]
    conf = gt_joints[..., 3:4]
    gt = gt_joints[..., :3]
    gt = gt - ((gt[:, 2, :] + gt[:, 3, :]) / 2)[:, None, :]
    pred = pred - ((pred[:, 2, :] + pred[:, 3, :]) / 2)[:, None, :]
    per_sample = (conf * (pred - gt) ** 2).mean((1, 2))
    return _masked_mean(per_sample, has_pose_3d, mesh)


def shape_loss(pred_vertices, gt_vertices, has_smpl, mesh=None):
    """Per-vertex L1 over samples with SMPL annotations."""
    per_sample = (pred_vertices - gt_vertices).abs().mean((1, 2))
    return _masked_mean(per_sample, has_smpl, mesh)


def smpl_param_loss(pred_rotmat, pred_betas, opt_pose, opt_betas,
                    valid_pose, valid_shape, mesh=None):
    """Rotation-matrix MSE and betas MSE over valid fits."""
    gt_rotmat = batch_rodrigues(opt_pose.reshape(-1, 24, 3))
    pose_per_sample = ((pred_rotmat - gt_rotmat) ** 2).mean((1, 2, 3))
    betas_per_sample = ((pred_betas - opt_betas) ** 2).mean(1)
    return (_masked_mean(pose_per_sample, valid_pose, mesh),
            _masked_mean(betas_per_sample, valid_shape, mesh))


def camera_depth_loss(pred_camera, mesh=None):
    """Penalise a negative or small weak-perspective scale (the mean over
    the global batch)."""
    pen = torch.exp(-pred_camera[:, 0] * 10) ** 2
    if mesh is None or mesh.dp == 1:
        return torch.mean(pen)
    return pen.sum() / (pen.shape[0] * mesh.dp)


class HDAssets(NamedTuple):
    """The dense (HD) surface in compact barycentric form: each HD point is
    a weighted sum of a few SMPL vertices, sampled from one face."""
    vert_ids: torch.Tensor       # (H, k) int64 SMPL vertex ids
    bary: torch.Tensor           # (H, k) float32 weights
    geovec: torch.Tensor         # (H,) int64 face each point samples from
    geovec_verts: torch.Tensor   # (H,) int64 that face's first vertex
    face_verts: torch.Tensor     # (H, 3) int64 that face's vertices

    def to(self, device) -> 'HDAssets':
        return HDAssets(*(t.to(device) for t in self))


def compact_hd_regressor(vert_regressor: np.ndarray, k: int = 4):
    """(H, V) upsampling matrix -> (vert_ids (H, k), bary (H, k)): each
    row's k largest weights by magnitude."""
    vr = np.asarray(vert_regressor)
    order = np.argpartition(-np.abs(vr), k - 1, axis=1)[:, :k]
    rows = np.arange(vr.shape[0])[:, None]
    return order, vr[rows, order]


def make_hd_assets(vert_regressor: np.ndarray, geovec: np.ndarray,
                   faces: np.ndarray, k: int = 4, device='cpu') -> HDAssets:
    """HDAssets from an (H, V) upsampling matrix, compacted to k weights."""
    order, weights = compact_hd_regressor(vert_regressor, k)
    return make_hd_assets_compact(order, weights, geovec, faces, device)


def make_hd_assets_compact(vert_ids: np.ndarray, bary: np.ndarray,
                           geovec: np.ndarray, faces: np.ndarray,
                           device='cpu') -> HDAssets:
    """HDAssets on `device` from barycentric tables (numpy)."""
    geovec = np.asarray(geovec).astype(np.int64)
    face_verts = np.asarray(faces).astype(np.int64)[geovec]      # (H, 3)

    def t(x, dtype=torch.long):
        return torch.tensor(np.ascontiguousarray(x), dtype=dtype,
                            device=device)

    return HDAssets(vert_ids=t(np.asarray(vert_ids)),
                    bary=t(np.asarray(bary, np.float32), torch.float32),
                    geovec=t(geovec), geovec_verts=t(face_verts[:, 0]),
                    face_verts=t(face_verts))


def _rows(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values (B, N, D) rows by idx (B, ...) -> (B, ..., D), with the
    plain scatter-add gradient."""
    B, D = values.shape[0], values.shape[-1]
    flat = idx.reshape(B, math.prod(idx.shape[1:]), 1).expand(-1, -1, D)
    return torch.gather(values, 1, flat).reshape(*idx.shape, D)


def _push_pull(d: torch.Tensor, exterior: torch.Tensor,
               weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample pull (exterior) plus push (interior) energies."""
    pull = 0.005 * torch.tanh(d / 0.005) ** 2 * exterior
    push = 1.0 * torch.tanh(d / 0.04) ** 2 * (~exterior)
    if weight is not None:
        pull, push = pull * weight, push * weight
    return pull.sum(-1) + push.sum(-1)


@torch.no_grad()
def hd_candidates(hd: HDAssets, exterior: torch.Tensor,
                  v2v_min: torch.Tensor, in_contact: torch.Tensor,
                  hd_k: int):
    """The HD points of the contact loss: the min(hd_k, H) points whose face
    has a vertex in contact or interior, nearest first (inactive points
    rank last, +inf). Returns (top_idx (B, K), sel (B, K) the point is
    active, trunc (B,) the share of active points beyond K)."""
    K = min(hd_k, int(hd.geovec.shape[0]))
    active = (in_contact | ~exterior)[:, hd.face_verts].any(-1)  # (B, H)
    d_rep = v2v_min.detach()[:, hd.face_verts].amin(-1)
    key = torch.where(active, d_rep, float('inf'))
    top_idx = _top_k(-key, K)                                    # (B, K)
    sel = torch.gather(active, 1, top_idx)
    n_active = active.sum(-1)
    trunc = ((n_active - K).clamp(min=0)
             / n_active.clamp(min=1)).to(v2v_min.dtype)
    return top_idx, sel, trunc


def hd_points(verts: torch.Tensor, hd: HDAssets,
              top_idx: torch.Tensor) -> torch.Tensor:
    """The selected HD points (B, K, 3), barycentric sums of the vertices
    (differentiable in verts)."""
    w_b = hd.bary[top_idx]                                       # (B, K, k)
    return (w_b[..., None] * _rows(verts, hd.vert_ids[top_idx])).sum(2)


@torch.no_grad()
def hd_offset_points(hd_pts: torch.Tensor, verts: torch.Tensor,
                     faces: torch.Tensor, hd: HDAssets,
                     top_idx: torch.Tensor) -> torch.Tensor:
    """Each HD point moved 1 mm along its face's normal: the points whose
    winding number against the body decides that the point is exterior."""
    normals = contact_ops.batch_face_normals(verts[:, faces])
    return hd_pts + 0.001 * _rows(normals, hd.geovec[top_idx])


def contact_loss(verts: torch.Tensor, assets: ContactAssets,
                 valid_fit: torch.Tensor, euclthres: float,
                 hd: Optional[HDAssets] = None, hd_k: int = 1024,
                 candidate_k: int = 0, capacity: int = 0, mesh=None):
    """The TUCH self-contact push/pull loss: (loss, aux).

    The loss is the mean over valid_fit samples of
        sum_pull 0.005 tanh(d / 0.005)^2  (exterior points)
      + sum_push 1.0 tanh(d / 0.04)^2     (interior points)
    with d the distance to the geodesically allowed nearest vertex. With
    `hd`, the points are the min(hd_k, H) HD points whose face has a vertex
    in contact or interior, nearest first (candidates beyond K are dropped
    and aux['hd_truncated_frac'] says how many); their in/out test is the
    winding number of each point moved 1 mm along its face's normal.

    capacity > 0 runs the quadratic machinery for at most `capacity`
    valid samples of the global batch (the same loss while capacity >=
    #valid; the overflow is aux['contact_valid_truncated_frac']); under dp
    each rank runs those in its slice.
    """
    B = verts.shape[0]
    Bg = B * (1 if mesh is None else mesh.dp)
    aux = {}
    if 0 < capacity < Bg:
        vmask = valid_fit.bool()
        gmask = PM.dp_gather(vmask, mesh)
        idx = PM.local_compact(compact_take(gmask, capacity), mesh, B)
        aux['contact_valid_truncated_frac'] = compact_overflow_frac(
            gmask, capacity)
        verts = verts[idx]
        valid_fit = vmask[idx]

    exterior, v2v_min, in_contact = self_contact_terms(
        verts, assets, euclthres, candidate_k=candidate_k, mesh=mesh)
    if hd is None:
        return (_masked_mean(_push_pull(v2v_min, exterior), valid_fit, mesh),
                {'hd_truncated_frac': verts.new_zeros(()), **aux})

    top_idx, sel, trunc = hd_candidates(hd, exterior, v2v_min, in_contact,
                                        hd_k)
    hd_pts = hd_points(verts, hd, top_idx)

    with torch.no_grad():
        hd_stop = hd_pts.detach()
        verts_stop = verts.detach()
        offset = hd_offset_points(hd_stop, verts_stop, assets.faces, hd,
                                  top_idx)
        wn = CK.winding_numbers_faces(offset, verts_stop, assets.faces)
        hd_ext = wn <= 0.99                                      # (B, K)

        # the masked nearest HD point (the mask of each point's face)
        rep = hd.geovec_verts[top_idx]                           # (B, K)
        geo = assets.geomask[rep[:, :, None], rep[:, None, :]].bool()
        geo = geo & sel[:, None, :] & sel[:, :, None]
        d2 = contact_ops.masked_sq_dists_highest(hd_stop, hd_stop, geo)
        argmin = torch.argmin(d2, dim=-1)                        # first min
        has_neighbor = torch.isfinite(d2.amin(-1))
    d_hd = zero_safe_norm(hd_pts - _rows(hd_pts, argmin))
    w_valid = (sel & has_neighbor).to(verts.dtype)
    per_sample = _push_pull(d_hd, hd_ext, w_valid)
    return (_masked_mean(per_sample, valid_fit, mesh),
            {'hd_truncated_frac': _masked_mean(trunc, valid_fit, mesh),
             **aux})


def regressor_loss(weights: LossWeights,
                   pred_rotmat, pred_betas, opt_pose, opt_betas,
                   pred_keypoints_2d, gt_keypoints_2d,
                   pred_joints, gt_joints, has_pose_3d,
                   pred_vertices, opt_vertices, pred_camera,
                   valid_fit, valid_fit_shape,
                   contact_assets: Optional[ContactAssets] = None,
                   euclthres: float = 0.02,
                   hd: Optional[HDAssets] = None, hd_k: int = 1024,
                   candidate_k: int = 0, contact_capacity: int = 0,
                   mesh=None):
    """The full training loss: (total, dict of the terms). Under a dp
    mesh, total is this rank's share (its gradient summed over dp is the
    global gradient) and the dict holds each term's global value."""
    loss_contact = pred_vertices.new_zeros(())
    contact_aux = {}
    if weights.contact > 0 and contact_assets is not None:
        loss_contact, contact_aux = contact_loss(
            pred_vertices, contact_assets, valid_fit, euclthres, hd=hd,
            hd_k=hd_k, candidate_k=candidate_k, capacity=contact_capacity,
            mesh=mesh)

    l_pose, l_betas = smpl_param_loss(pred_rotmat, pred_betas, opt_pose,
                                      opt_betas, valid_fit, valid_fit_shape,
                                      mesh)
    l_kp2d = keypoint_loss(pred_keypoints_2d, gt_keypoints_2d,
                           weights.openpose_train_weight,
                           weights.gt_train_weight, valid_fit, mesh)
    l_kp3d = keypoint_3d_loss(pred_joints, gt_joints, has_pose_3d, mesh)
    l_shape = shape_loss(pred_vertices, opt_vertices, valid_fit, mesh)
    l_cam = camera_depth_loss(pred_camera, mesh)

    total = (weights.shape * l_shape
             + weights.keypoint * l_kp2d
             + weights.keypoint * l_kp3d
             + weights.pose * l_pose
             + weights.beta * l_betas
             + l_cam
             + weights.contact * loss_contact)
    terms = {
        'loss_shape': l_shape,
        'loss_keypoints': l_kp2d,
        'loss_keypoints_3d': l_kp3d,
        'loss_regr_pose': l_pose,
        'loss_regr_betas': l_betas,
        'loss_cam': l_cam,
        'loss_contact': loss_contact,
        **contact_aux,
    }
    if mesh is not None and mesh.dp > 1:
        # every term but the compaction's overflow (global already) is a
        # share: one all_reduce of them all
        shares = [k for k in terms if k != 'contact_valid_truncated_frac']
        summed = PM.dp_sum(torch.stack([terms[k].detach() for k in shares]),
                           mesh)
        terms.update(zip(shares, summed.unbind()))
    return total, terms
