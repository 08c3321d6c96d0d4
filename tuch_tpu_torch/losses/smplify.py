"""Fitting losses for SMPLify-DC: reprojection, priors and contact terms.

Counterpart of tuch_tpu/losses/smplify.py. Every term is batched; the
per-sample enablement of the reference (ignore_idxs, has_discrete_contact)
is masking. With a mesh (parallel/mesh.Mesh) of cp > 1 the two quadratic
searches split their triangle and searched axes over cp
(parallel/contact_parallel.py); the batch is this rank's slice.

The contact terms split in two halves. contact_neighbors, without
gradient, runs the winding in/out test (kernel 2, twice with segments) and
the geodesically masked nearest-vertex search (kernel 4).
contact_distances, with gradient, re-gathers each vertex's nearest vertex
through gather_rows (kernel 5 forward, kernel 6 backward).
"""

from typing import NamedTuple, Optional

import torch

from tuch_tpu_torch.losses.prior import GMMPrior, gmm_prior_nll
from tuch_tpu_torch.ops import contact as contact_ops
from tuch_tpu_torch.ops import contact_kernels as CK
from tuch_tpu_torch.ops.gather import gather_rows
from tuch_tpu_torch.ops.segments import (SegmentTables,
                                         forgive_segment_interiors,
                                         to_device)
from tuch_tpu_torch.parallel import contact_parallel as CPAR
from tuch_tpu_torch.utils.projection import perspective_projection

_ANGLE_IDX = (52, 55, 9, 12)   # knees and elbows in the 69-dim body pose
_ANGLE_SIGN = (1.0, -1.0, -1.0, -1.0)


def gmof(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Geman-McClure robust error."""
    x2 = x ** 2
    s2 = sigma ** 2
    return (s2 * x2) / (s2 + x2)


def angle_prior(body_pose: torch.Tensor) -> torch.Tensor:
    """Penalty for unnatural knee and elbow bending, (B, 69) -> (B, 4)."""
    sign = body_pose.new_tensor(_ANGLE_SIGN)
    return torch.exp(body_pose[:, list(_ANGLE_IDX)] * sign) ** 2


def reprojection_term(model_joints, camera_t, camera_center, joints_2d,
                      joints_conf, focal_length=5000.0, sigma=100.0):
    """Per-joint conf²-weighted robust reprojection error, (B, J)."""
    B = model_joints.shape[0]
    rot = torch.eye(3, dtype=model_joints.dtype,
                    device=model_joints.device).expand(B, 3, 3)
    proj = perspective_projection(model_joints, rot, camera_t, focal_length,
                                  camera_center)
    err = gmof(proj - joints_2d, sigma).sum(-1)
    return (joints_conf ** 2) * err


def camera_fitting_loss(model_joints, betas, camera_t, camera_t_est,
                        camera_center, joints_2d, joints_conf,
                        focal_length=5000.0, depth_loss_weight=100.0,
                        sigma=100.0, shape_prior_weight=0.0):
    """Stage-1 loss (camera translation [+ betas]), a scalar."""
    reproj = reprojection_term(model_joints, camera_t, camera_center,
                               joints_2d, joints_conf, focal_length, sigma)
    depth = (depth_loss_weight ** 2) * (camera_t[:, 2]
                                        - camera_t_est[:, 2]) ** 2
    shape_prior = (shape_prior_weight ** 2) * (betas ** 2).sum(-1)
    return (reproj.sum(-1) + depth + shape_prior).sum()


def body_fitting_loss(body_pose, betas, model_joints, camera_t,
                      camera_center, joints_2d, joints_conf,
                      prior: GMMPrior, focal_length=5000.0, sigma=100.0,
                      pose_prior_weight=4.78, shape_prior_weight=5.0,
                      angle_prior_weight=15.2, output='sum'):
    """SPIN-style stage-2 loss without contact; output='reprojection'
    returns the per-joint (B, J) reprojection term."""
    reproj = reprojection_term(model_joints, camera_t, camera_center,
                               joints_2d, joints_conf, focal_length, sigma)
    if output == 'reprojection':
        return reproj
    pose_prior_l = (pose_prior_weight ** 2) * gmm_prior_nll(prior, body_pose)
    angle_l = (angle_prior_weight ** 2) * angle_prior(body_pose).sum(-1)
    shape_l = (shape_prior_weight ** 2) * (betas ** 2).sum(-1)
    return (reproj.sum(-1) + pose_prior_l + angle_l + shape_l).sum()


class ContactAssets(NamedTuple):
    """Static data of the contact terms, on the device.

    geomask is the (V, V) uint8 mask of geodesically distant (allowed)
    pairs, allowed[query, searched]; geomask_bits is the same mask packed
    for the masked-min kernel, ops/contact_kernels.pack_mask_bits
    (models/convert.py contact_assets_from_numpy builds both).
    """
    geomask: torch.Tensor        # (V, V) uint8
    faces: torch.Tensor          # (F, 3) int64
    region_idx_a: torch.Tensor   # (P, R) int64
    region_idx_b: torch.Tensor   # (P, R) int64
    region_mask_a: torch.Tensor  # (P, R) bool
    region_mask_b: torch.Tensor  # (P, R) bool
    segment_tables: Optional[SegmentTables] = None
    geomask_bits: Optional[torch.Tensor] = None   # (V, ceil(V / 32)) int32

    def to(self, device) -> 'ContactAssets':
        """A copy on `device`."""
        tables, bits = self.segment_tables, self.geomask_bits
        return ContactAssets(
            *(t.to(device) for t in self[:6]),
            segment_tables=None if tables is None else to_device(tables,
                                                                 device),
            geomask_bits=None if bits is None else bits.to(device))


def _candidate_flags(shape, prev_exterior, cand, wn_c):
    """Tested vertices get their fresh in/out result; untested ones keep
    their previous flag when prev_exterior is given (sticky), else read
    exterior."""
    B, V = shape
    tested = torch.zeros((B, V), dtype=torch.bool, device=cand.device)
    tested.scatter_(1, cand, True)
    int_scatter = torch.zeros_like(tested)
    int_scatter.scatter_(1, cand, wn_c > 0.99)
    if prev_exterior is None:
        return ~int_scatter
    return ~torch.where(tested, int_scatter, ~prev_exterior)


def _candidate_key(min_d2, prev_exterior):
    """Selection key: previously interior vertices first, then nearest."""
    if prev_exterior is None:
        return -min_d2
    return -torch.where(prev_exterior, min_d2, float('-inf'))


def _top_k(key: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest keys per row; ties go to the lower index,
    as jax.lax.top_k gives them."""
    return torch.sort(key, dim=1, descending=True, stable=True).indices[:, :k]


@torch.no_grad()
def contact_neighbors(verts: torch.Tensor, assets: ContactAssets,
                      candidate_k: int = 0, prev_exterior=None, mesh=None):
    """The half without gradient: winding in/out flags and the masked
    nearest vertex, (exterior (B, V) bool, argmin (B, V) int32).

    candidate_k = 0 tests all V vertices (the reference). K > 0 tests only
    K candidates: vertices flagged interior by prev_exterior first, then
    the vertices nearest a geodesically distant neighbour; untested
    vertices keep their previous flag when prev_exterior is given (sticky),
    else read exterior. In-the-loop fitters seed with one exact pass (see
    fitting/smplify_dc.py) and thread prev_exterior through refreshes.

    mesh: with cp > 1 both routes split their quadratic axes over cp
    (parallel/contact_parallel.py); every rank of the cp group passes the
    same verts. An empty batch returns empty flags, with no collective.
    """
    vd = verts.detach()
    B, V, _ = vd.shape
    K = max(0, int(candidate_k))
    if B == 0:
        return (torch.ones((0, V), dtype=torch.bool, device=vd.device),
                torch.zeros((0, V), dtype=torch.int32, device=vd.device))
    cp = mesh is not None and mesh.cp > 1
    if cp and not (K and K < V):
        wn, argmin = CPAR.contact_neighbors_cp(
            vd, assets.faces, assets.geomask, assets.geomask_bits, mesh)
        exterior = wn <= 0.99
    else:
        if cp:
            min_d2, argmin = CPAR.masked_min_cp(
                vd, assets.geomask, assets.geomask_bits, mesh)
        else:
            min_d2, argmin = CK.masked_min_dist(vd, assets.geomask,
                                                assets.geomask_bits)
        if K and K < V:
            cand = _top_k(_candidate_key(min_d2, prev_exterior), K)
            qpts = gather_rows(vd, cand.int())                # (B, K, 3)
            wn_c = CPAR.winding_numbers_cp(qpts, vd, assets.faces, mesh) \
                if cp else CK.winding_numbers_faces(qpts, vd, assets.faces)
            exterior = _candidate_flags((B, V), prev_exterior, cand, wn_c)
        else:
            exterior = CK.winding_numbers_faces(vd, vd, assets.faces) <= 0.99
    if assets.segment_tables is not None:
        exterior = forgive_segment_interiors(assets.segment_tables, vd,
                                             exterior)
    return exterior, argmin


def zero_safe_norm(diff: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """||diff|| with a ZERO gradient at exactly coincident points (the
    plain norm's gradient is NaN there, and the pull term drives pairs to
    exactly that point)."""
    d2 = (diff * diff).sum(dim)
    pos = d2 > 0
    return torch.sqrt(torch.where(pos, d2, torch.ones_like(d2))) * pos


def contact_distances(verts: torch.Tensor, argmin: torch.Tensor
                      ) -> torch.Tensor:
    """The half with gradient: distance to the cached nearest vertex; the
    backward reaches both endpoints (the scatter of gather_rows)."""
    return zero_safe_norm(verts - gather_rows(verts, argmin))


def self_contact_terms(verts: torch.Tensor, assets: ContactAssets,
                       euclthres: float, candidate_k: int = 0, mesh=None):
    """Both halves at once: (exterior (B, V) bool, v2v_min (B, V) with
    gradient, in_contact (B, V) bool), in_contact the vertices whose
    nearest allowed vertex lies within euclthres."""
    exterior, argmin = contact_neighbors(verts, assets,
                                         candidate_k=candidate_k, mesh=mesh)
    v2v_min = contact_distances(verts, argmin)
    return exterior, v2v_min, v2v_min.detach() < euclthres


def push_pull_terms(exterior, v2v_min, in_contact):
    """The TUCH push/pull energies per sample (B,): exterior vertices in
    contact are pulled tight, interior vertices pushed out."""
    pull = 0.005 * torch.tanh(v2v_min / 0.005) ** 2
    push = 1.0 * torch.tanh(v2v_min / 0.04) ** 2
    pull_mask = (exterior & in_contact).to(v2v_min.dtype)
    push_mask = (~exterior).to(v2v_min.dtype)
    return (pull * pull_mask).sum(-1) + (push * push_mask).sum(-1)


def compact_take(active: torch.Tensor, capacity: int) -> torch.Tensor:
    """Indices of the first `capacity` active samples, in order, then the
    inactive ones: a fixed-capacity sub-batch."""
    order = torch.argsort((~active).int(), stable=True)
    return order[:capacity]


def compact_overflow_frac(active: torch.Tensor, capacity: int
                          ) -> torch.Tensor:
    """Fraction of active samples beyond the compaction capacity."""
    n_active = active.sum()
    return ((n_active - capacity).clamp(min=0)
            / n_active.clamp(min=1)).float()


def contact_fitting_loss(body_pose, global_orient, betas, model_joints,
                         verts, camera_t, camera_center, joints_2d,
                         joints_conf, prior: GMMPrior,
                         assets: ContactAssets, gt_contact, ignore_idxs,
                         has_discrete_contact, euclthres: float,
                         focal_length=5000.0, sigma=100.0,
                         pose_prior_weight=1.0, contact_loss_weight=1000.0,
                         cached_neighbors=None, candidate_k=0,
                         compact_idx=None, mesh=None):
    """Stage-2 loss with self-contact, a scalar:

      sum_b [reproj_b + pose_prior_b + 10 contact_b + w r2r_b]

    with contact_b and r2r_b masked to ~ignore_idxs and r2r_b to
    has_discrete_contact. compact_idx (C,) restricts the quadratic terms to
    a sub-batch (compact_take); cached_neighbors, when given, are then
    (C, V)-shaped. mesh: the contact neighbours' cp split
    (contact_neighbors); under dp the batch is this rank's slice, its loss
    this slice's share of the sum, and compact_idx this rank's part of the
    global compaction (parallel/mesh.local_compact), possibly empty.
    """
    reproj = reprojection_term(model_joints, camera_t, camera_center,
                               joints_2d, joints_conf, focal_length,
                               sigma).sum(-1)
    pose_prior_l = (pose_prior_weight ** 2) * gmm_prior_nll(prior, body_pose)

    B = verts.shape[0]
    cverts = verts if compact_idx is None else verts[compact_idx]
    if cached_neighbors is None:
        exterior, argmin = contact_neighbors(cverts, assets,
                                             candidate_k=candidate_k,
                                             mesh=mesh)
    else:
        exterior, argmin = cached_neighbors
    v2v_min = contact_distances(cverts, argmin)
    in_contact = v2v_min.detach() < euclthres
    contact_b = push_pull_terms(exterior, v2v_min, in_contact)
    if compact_idx is not None:
        contact_b = contact_b.new_zeros(B).index_copy(0, compact_idx,
                                                      contact_b)

    # region-to-region term, geodesically masked like the reference's
    # SMPLify r2r term (distant pairs only), on the same sub-batch
    cgt = gt_contact if compact_idx is None else gt_contact[compact_idx]
    if cverts.shape[0]:
        pair_min = contact_ops.region_pair_min_dists(
            cverts, assets.region_idx_a, assets.region_idx_b,
            assets.region_mask_a, assets.region_mask_b,
            geomask=assets.geomask)
        r2r_b = (pair_min * cgt).sum(-1)
    else:                        # this rank holds none of the compaction
        r2r_b = cverts.new_zeros(0)
    if compact_idx is not None:
        r2r_b = r2r_b.new_zeros(B).index_copy(0, compact_idx, r2r_b)

    opt_mask = (~ignore_idxs).to(verts.dtype)
    contact_b = contact_b * opt_mask
    r2r_b = r2r_b * opt_mask * has_discrete_contact.to(verts.dtype)
    total = reproj + pose_prior_l + 10.0 * contact_b \
        + contact_loss_weight * r2r_b
    return total.sum()
