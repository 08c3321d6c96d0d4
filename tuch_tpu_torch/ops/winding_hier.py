"""Hierarchical winding numbers: exact near field plus dipole far field.

Counterpart of tuch_tpu/ops/winding_hier.py, after "Fast Winding Numbers
for Soups and Clouds" (Barill et al., SIGGRAPH 2018). The structure is
flat and tile-granular:

  * faces are permuted once (host, from the template) into K spatially
    compact clusters of C triangles (Morton order of face centroids), and
    vertices into tiles of TQ points;
  * per call, cluster centroids, area vectors and radii come from the posed
    vertices in plain PyTorch;
  * each tile selects its M nearest clusters; those get the exact
    Van Oosterom-Strackee sum in kernel 7 (csrc/winding_near.cu, see its
    header), every other cluster its dipole term a_k . (c_k - p) /
    |c_k - p|^3, evaluated densely in PyTorch.

STATUS: experimental, as in the JAX package: no path of this package calls
it. The in/out decisions follow the exact winding numbers closely; values
near unselected cluster boundaries are approximate.

The dense parts are plain PyTorch on tensors, where the JAX package leaves
them to XLA; the near field dispatches like the other kernels: a CPU tensor
takes near_field_ref, a CUDA tensor near_field_cuda, which launches the
kernel or raises and counts its launches.
"""

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from tuch_tpu_torch import resolve_device
from tuch_tpu_torch.ops import _build
from tuch_tpu_torch.ops import contact
from tuch_tpu_torch.ops.contact_kernels import (_cross, _dot3, _split,
                                                _stream, kernel_shape)


class WindingClusters(NamedTuple):
    """Static clustering tables (host-precomputed from the template)."""
    face_perm: torch.Tensor     # (K*C,) permutation of face indices
    faces_sorted: torch.Tensor  # (K*C, 3) faces in cluster order (padded)
    vert_perm: torch.Tensor     # (Qp,) spatial permutation of vertices
    vert_inv: torch.Tensor      # (V,) inverse permutation
    num_clusters: int           # K
    cluster_size: int           # C
    tile_q: int                 # TQ
    num_real_verts: int         # V (before padding)
    num_real_faces: int         # F


def _morton_code(x: np.ndarray, bits: int = 10) -> np.ndarray:
    """Interleave 3D quantized coords into a Morton code."""
    mn = x.min(axis=0)
    span = (x.max(axis=0) - mn).max() + 1e-9
    q = np.clip(((x - mn) / span * (2 ** bits - 1)).astype(np.int64), 0,
                2 ** bits - 1)

    def spread(v):
        out = np.zeros_like(v)
        for b in range(bits):
            out |= ((v >> b) & 1) << (3 * b)
        return out

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def build_winding_clusters(template_verts: np.ndarray, faces: np.ndarray,
                           cluster_size: int = 256, tile_q: int = 512,
                           device=None) -> WindingClusters:
    """The clustering tables of a template, equal to the JAX package's.

    Faces are padded to a multiple of cluster_size with a degenerate face
    (one vertex three times): its exact solid angle and its area vector are
    0, so neither the near nor the far field counts it. Vertices are padded
    to a multiple of tile_q by repeating the last one. The tables land on
    `device` (CUDA unless 'cpu' is asked for).
    """
    from tuch_tpu_torch.models.convert import winding_clusters_from_numpy
    device = resolve_device(device)
    template_verts = np.asarray(template_verts)
    faces = np.asarray(faces)
    F = faces.shape[0]
    V = template_verts.shape[0]

    centroids = template_verts[faces].mean(axis=1)
    face_order = np.argsort(_morton_code(centroids))
    pad_f = (-F) % cluster_size
    degen = np.full((pad_f,), faces[face_order[-1]][0])
    faces_sorted = np.concatenate(
        [faces[face_order],
         np.stack([degen, degen, degen], axis=-1)], axis=0) \
        if pad_f else faces[face_order]
    face_perm = np.concatenate(
        [face_order, np.full(pad_f, face_order[-1])]) if pad_f \
        else face_order

    vert_order = np.argsort(_morton_code(template_verts))
    pad_q = (-V) % tile_q
    vert_perm = np.concatenate(
        [vert_order, np.full(pad_q, vert_order[-1])]) if pad_q \
        else vert_order
    vert_inv = np.zeros(V, np.int64)
    vert_inv[vert_order] = np.arange(V)

    return winding_clusters_from_numpy(dict(
        face_perm=face_perm, faces_sorted=faces_sorted, vert_perm=vert_perm,
        vert_inv=vert_inv, num_clusters=(F + pad_f) // cluster_size,
        cluster_size=cluster_size, tile_q=tile_q, num_real_verts=V,
        num_real_faces=F), device=device)


class HierProblem(NamedTuple):
    """The dense half of one call: kernel 7's inputs and the far field."""
    sel: torch.Tensor    # (B, T, M) int32: each tile's nearest clusters
    pts: torch.Tensor    # (B, 3, Qp) points in tile order
    tris: torch.Tensor   # (B, K, 9, C) cluster triangles, corner rows
    far: torch.Tensor    # (B, Qp) dipole sum of the unselected clusters


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, as jnp.linalg.norm computes it."""
    return torch.sqrt((x * x).sum(-1))


def nearest(dist: torch.Tensor, m: int) -> torch.Tensor:
    """Indices (int64) of the m smallest entries of float32 dist's last
    axis, as jax.lax.top_k(-dist, m) picks them: the smallest first, -0
    before +0 (top_k orders floats totally), and the lower index first on
    ties. torch.topk promises no tie order, so this is a stable sort of the
    float bits mapped to integers of the same total order."""
    bits = dist.contiguous().view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    return torch.sort(key, dim=-1, stable=True).indices[..., :m]


def hier_problem(verts: torch.Tensor, clusters: WindingClusters,
                 num_near: int = 16) -> HierProblem:
    """Cluster and tile summaries, the near selection and the far field
    (tuch_tpu/ops/winding_hier.py:187-231), in plain PyTorch."""
    B = verts.shape[0]
    TQ, C, K = clusters.tile_q, clusters.cluster_size, clusters.num_clusters
    M = min(num_near, K)

    pts = verts[:, clusters.vert_perm, :]                  # (B, Qp, 3)
    Qp = pts.shape[1]
    T = Qp // TQ
    tris_k = verts[:, clusters.faces_sorted, :].reshape(B, K, C, 3, 3)

    # Cluster summaries from posed geometry.
    c_cent = tris_k.mean(dim=(2, 3))                       # (B, K, 3)
    e1 = tris_k[..., 1, :] - tris_k[..., 0, :]
    e2 = tris_k[..., 2, :] - tris_k[..., 0, :]
    a_vec = 0.5 * _cross(e1, e2).sum(dim=2)                # (B, K, 3)
    c_rad = _norm(tris_k.reshape(B, K, C * 3, 3)
                  - c_cent[:, :, None, :]).amax(dim=2)     # (B, K)

    # Near selection: the M clusters with the smallest surface-to-tile
    # distance.
    t_cent = pts.reshape(B, T, TQ, 3).mean(dim=2)          # (B, T, 3)
    d_tc = _norm(t_cent[:, :, None, :] - c_cent[:, None, :, :]) \
        - c_rad[:, None, :]
    sel = nearest(d_tc, M)

    # Far field: the dipole of every cluster at every point, minus the
    # selected ones. The squared distance is clamped to the cluster radius:
    # a point inside an unselected cluster must not blow up the sum.
    diff = c_cent[:, None, :, :] - pts[:, :, None, :]      # (B, Qp, K, 3)
    d2 = torch.maximum(contact._sq_norm(*diff.unbind(-1)),
                       (c_rad ** 2)[:, None, :])
    dip = _dot3(a_vec[:, None], diff) * d2 ** -1.5         # (B, Qp, K)
    del diff, d2
    far_sel = torch.gather(dip, 2, sel.repeat_interleave(TQ, dim=1))
    far = dip.sum(-1) - far_sel.sum(-1)

    return HierProblem(
        sel=sel.int().contiguous(),
        pts=pts.transpose(1, 2).contiguous(),
        tris=tris_k.reshape(B, K, C, 9).transpose(2, 3).contiguous(),
        far=far)


def near_field_ref(sel: torch.Tensor, pts: torch.Tensor,
                   tris: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 7: sel (B, T, M), pts (B, 3, Qp), tris
    (B, K, 9, C) -> (B, Qp) solid-angle sums in radians, over each tile's
    selected clusters in m order. The solid angles are ops/contact.py's, in
    the JAX kernel's order of operations."""
    B, T, M = sel.shape
    Qp = pts.shape[2]
    K, C = tris.shape[1], tris.shape[3]
    p = pts.transpose(1, 2).reshape(B * T, Qp // T, 3)
    tri = tris.transpose(2, 3).reshape(B, K, C, 3, 3)
    rows = torch.arange(B, device=sel.device)[:, None]
    acc = pts.new_zeros((B * T, Qp // T))
    for m in range(M):
        chosen = tri[rows, sel[:, :, m].long()]            # (B, T, C, 3, 3)
        acc = acc + contact._solid_angle_sum(p, chosen.reshape(B * T, C, 3,
                                                               3))
    return acc.reshape(B, Qp)


def near_shape():
    """(threads, points per thread, triangles per stage) of the built
    csrc/winding_near.cu."""
    return kernel_shape('winding_near', 3)


def near_plan(B: int, T: int, TQ: int, M: int, shape):
    """(mchunk, splits) of kernel 7's selected clusters for B rows of T
    tiles of TQ points, given near_shape(): the blocks of a tile times the
    splits approach the card's target."""
    NT, R, _ = shape
    return _split(B * T * -(-TQ // (NT * R)), M, 1)


def near_field_cuda(sel: torch.Tensor, pts: torch.Tensor,
                    tris: torch.Tensor) -> torch.Tensor:
    """Launch kernel 7 on near_field_ref's contract; sel must lie in
    [0, K) (the kernel skips other indices, the plain version raises)."""
    what = 'near_field_cuda'
    for name, x, dtype in (('sel', sel, torch.int32),
                           ('pts', pts, torch.float32),
                           ('tris', tris, torch.float32)):
        if x.device.type != 'cuda':
            raise ValueError(f'{what} needs CUDA tensors, got {name} on '
                             f'{x.device}')
        if x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f'{what}: {name} must be contiguous {dtype}, '
                             f'got {x.dtype}')
    if sel.dim() != 3 or pts.dim() != 3 or tris.dim() != 4:
        raise ValueError(f'{what}: want sel (B, T, M), pts (B, 3, Qp), tris '
                         f'(B, K, 9, C); got {tuple(sel.shape)}, '
                         f'{tuple(pts.shape)}, {tuple(tris.shape)}')
    B, T, M = sel.shape
    Qp = pts.shape[2]
    K, C = tris.shape[1], tris.shape[3]
    if pts.shape[:2] != (B, 3) or tris.shape[0] != B or tris.shape[2] != 9 \
            or Qp % T or pts.device != sel.device \
            or tris.device != sel.device:
        raise ValueError(f'{what}: want sel (B, T, M), pts (B, 3, T * TQ), '
                         f'tris (B, K, 9, C) on one device; got '
                         f'{tuple(sel.shape)}, {tuple(pts.shape)}, '
                         f'{tuple(tris.shape)}')
    TQ = Qp // T
    out = torch.empty((B, Qp), dtype=torch.float32, device=pts.device)
    if B * Qp == 0:
        return out
    if M * K * C == 0:
        return out.zero_()
    mchunk, splits = near_plan(B, T, TQ, M, near_shape())
    partial = torch.empty((B, splits, Qp), dtype=torch.float32,
                          device=pts.device) if splits > 1 else None
    lib, fn = _build.entry('winding_near', 'tuch_winding_near',
                           [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                           + [ctypes.c_void_p])
    with torch.cuda.device(pts.device):
        err = fn(sel.data_ptr(), pts.data_ptr(), tris.data_ptr(),
                 out.data_ptr(),
                 None if partial is None else partial.data_ptr(), B, T, TQ,
                 M, K, C, mchunk, _stream(pts))
    _build.check(lib, err, 'near-field kernel launch')
    near_field_cuda.launches += 1
    return out


near_field_cuda.launches = 0


def near_field(sel: torch.Tensor, pts: torch.Tensor,
               tris: torch.Tensor) -> torch.Tensor:
    """Kernel 7's function: the plain version for a CPU tensor, the kernel
    for a CUDA tensor."""
    if pts.device.type == 'cpu':
        return near_field_ref(sel, pts, tris)
    return near_field_cuda(sel, pts, tris)


def combine(near: torch.Tensor, far: torch.Tensor,
            clusters: WindingClusters) -> torch.Tensor:
    """(near + far) / (4 pi), back from tile order to vertex order."""
    return ((near + far) * contact.INV_4PI)[:, clusters.vert_inv]


def winding_numbers_hier(verts: torch.Tensor, clusters: WindingClusters,
                         num_near: int = 16) -> torch.Tensor:
    """Winding numbers of a mesh's own vertices with respect to itself.

    verts (B, V, 3) -> (B, V), the contract of the JAX package's
    winding_numbers_hier. Experimental (module note).
    """
    prob = hier_problem(verts, clusters, num_near)
    return combine(near_field(prob.sel, prob.pts, prob.tris), prob.far,
                   clusters)
