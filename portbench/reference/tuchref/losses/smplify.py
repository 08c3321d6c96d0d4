"""The self-contact terms of SMPLify-DC, which the EFT loss runs.

A frozen copy of the contact half of tuch_tpu_torch/losses/smplify.py, on
one rank (no contact-parallel split). contact_neighbors, without gradient,
runs the winding in/out test (kernel 2, twice with segments) and the
geodesically masked nearest-vertex search (kernel 4). contact_distances,
with gradient, re-gathers each vertex's nearest vertex through gather_rows
(kernel 5 forward, kernel 6 backward). Here every kernel entry is its
plain version (ops/).
"""

from typing import NamedTuple, Optional

import torch

from portbench.reference.tuchref.ops import contact_kernels as CK
from portbench.reference.tuchref.ops.gather import gather_rows
from portbench.reference.tuchref.ops.segments import (SegmentTables,
                                                      forgive_segment_interiors,
                                                      to_device)


class ContactAssets(NamedTuple):
    """Static data of the contact terms, on the device.

    geomask is the (V, V) uint8 mask of geodesically distant (allowed)
    pairs, allowed[query, searched]; geomask_bits is the same mask packed
    for the masked-min kernel, ops/contact_kernels.pack_mask_bits
    (runtime.contact_assets builds both).
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
                      candidate_k: int = 0, prev_exterior=None):
    """The half without gradient: winding in/out flags and the masked
    nearest vertex, (exterior (B, V) bool, argmin (B, V) int32).

    candidate_k = 0 tests all V vertices (the reference). K > 0 tests only
    K candidates: vertices flagged interior by prev_exterior first, then
    the vertices nearest a geodesically distant neighbour; untested
    vertices keep their previous flag when prev_exterior is given (sticky),
    else read exterior. An empty batch returns empty flags.
    """
    vd = verts.detach()
    B, V, _ = vd.shape
    K = max(0, int(candidate_k))
    if B == 0:
        return (torch.ones((0, V), dtype=torch.bool, device=vd.device),
                torch.zeros((0, V), dtype=torch.int32, device=vd.device))
    min_d2, argmin = CK.masked_min_dist(vd, assets.geomask,
                                        assets.geomask_bits)
    if K and K < V:
        cand = _top_k(_candidate_key(min_d2, prev_exterior), K)
        qpts = gather_rows(vd, cand.int())                # (B, K, 3)
        wn_c = CK.winding_numbers_faces(qpts, vd, assets.faces)
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
                       euclthres: float, candidate_k: int = 0):
    """Both halves at once: (exterior (B, V) bool, v2v_min (B, V) with
    gradient, in_contact (B, V) bool), in_contact the vertices whose
    nearest allowed vertex lies within euclthres."""
    exterior, argmin = contact_neighbors(verts, assets,
                                         candidate_k=candidate_k)
    v2v_min = contact_distances(verts, argmin)
    return exterior, v2v_min, v2v_min.detach() < euclthres
