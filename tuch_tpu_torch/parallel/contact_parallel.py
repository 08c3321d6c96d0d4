"""The contact quadratics with their big axes split over the mesh's cp axis.

Counterpart of tuch_tpu/parallel/contact_parallel.py. The V x F point-
triangle winding sum and the V x V masked nearest-vertex search are this
workload's big-axis problem. Each cp rank of a dp row holds the row's
batch slice and reduces its part of the quadratic axis; one collective
over the cp group merges the parts, a (B, V) tensor against the O(V^2)
work it splits:

  * winding: a rank runs kernel 2 (winding_numbers_tris_cuda, plain
    ops/contact on a CPU rank) on its triangle shard; the partials, each
    already scaled by 1/4pi, are summed by all_reduce(SUM). The JAX package
    sums the raw solid angles and scales once: another rounding order.
  * nearest vertex: a rank runs kernel 4's range entry on its searched
    range and gets each query's first minimum as a 64-bit key, d2's bits
    above the index; one all_reduce(MIN) of the keys gives the least d2,
    then the lowest index, exactly the JAX package's two pmins.

A min over a union and a sum over a partition do not depend on where the
cuts fall, so both axes are cut at multiples of ALIGN (32: whole words of
kernel 4's packed mask), not at ceil(n / cp). CP_CALLS counts the calls of
each function, so that a run can show the step went through them.
"""

from typing import Tuple

import torch
import torch.distributed as dist

from tuch_tpu_torch.ops import contact_kernels as CK
from tuch_tpu_torch.parallel.mesh import Mesh, all_reduce_

ALIGN = 32
CP_CALLS = {'winding_numbers_cp': 0, 'masked_min_cp': 0,
            'contact_neighbors_cp': 0}


def shard_range(n: int, parts: int, index: int, align: int = ALIGN
                ) -> Tuple[int, int]:
    """[lo, hi) of part `index` of an axis of n items cut into `parts`
    contiguous pieces at multiples of `align` (the last may be short or
    empty)."""
    chunk = -(-(-(-n // parts)) // align) * align
    lo = min(index * chunk, n)
    return lo, min(lo + chunk, n)


def _winding_part(points, verts, faces, mesh: Mesh):
    """This rank's partial winding numbers over its triangle shard."""
    lo, hi = shard_range(faces.shape[0], mesh.cp, mesh.cp_rank)
    return CK.winding_numbers_faces(points, verts, faces[lo:hi])


def _masked_min_keys(verts, mask, bits, mesh: Mesh):
    lo, hi = shard_range(verts.shape[1], mesh.cp, mesh.cp_rank)
    return CK.masked_min_keys(verts, mask, bits, lo, hi)


@torch.no_grad()
def winding_numbers_cp(points: torch.Tensor, verts: torch.Tensor,
                       faces: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Winding numbers (B, Q) of points (B, Q, 3) against (verts (B, V, 3),
    faces (F, 3)), the triangle axis split over cp."""
    CP_CALLS['winding_numbers_cp'] += 1
    return all_reduce_(_winding_part(points, verts, faces, mesh),
                       mesh.cp_group)


@torch.no_grad()
def masked_min_cp(verts: torch.Tensor, mask: torch.Tensor,
                  bits: torch.Tensor, mesh: Mesh):
    """The masked nearest vertex, (min d2 (B, V), argmin (B, V) int32) as
    ops/contact_kernels.masked_min_dist gives it, the searched axis split
    over cp. mask (V, V) uint8 allowed[query, searched]; bits its packed
    form (ContactAssets.geomask_bits), which kernel 4 reads."""
    CP_CALLS['masked_min_cp'] += 1
    keys = all_reduce_(_masked_min_keys(verts, mask, bits, mesh),
                       mesh.cp_group, dist.ReduceOp.MIN)
    return CK.decode_keys(keys)


@torch.no_grad()
def contact_neighbors_cp(verts: torch.Tensor, faces: torch.Tensor,
                         mask: torch.Tensor, bits: torch.Tensor,
                         mesh: Mesh):
    """The contact half without gradient on the cp axis: (winding numbers
    of the vertices (B, V), argmin (B, V) int32), each rank reducing its
    triangle shard and its searched range."""
    CP_CALLS['contact_neighbors_cp'] += 1
    wn = all_reduce_(_winding_part(verts, verts, faces, mesh),
                     mesh.cp_group)
    keys = all_reduce_(_masked_min_keys(verts, mask, bits, mesh),
                       mesh.cp_group, dist.ReduceOp.MIN)
    return wn, CK.decode_keys(keys)[1]
