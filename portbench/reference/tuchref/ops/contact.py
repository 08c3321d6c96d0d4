"""Self-contact geometry, plain PyTorch: winding numbers, masked nearest
vertices, region-pair distances, face normals.

Counterpart of tuch_tpu/ops/contact.py. These are the plain versions of
the CUDA kernels in ops/contact_kernels.py (the tests and the CPU path use
them; the card runs the kernels). The two quadratic searches are streamed:
triangle or column blocks are reduced as they are formed, so no (Q, F) or
(V, V) tensor is built whole, and the batch is a tensor dimension.

Distances are direct coordinate differences summed as (dx² + dy²) + dz²,
never the Gram form xx + yy - 2xy: that form cancels at contact distances
(and torch.cdist switches to it for large inputs). The one exception is
masked_sq_dists_highest, the JAX package's sanctioned Gram form for small
sets, in full fp32.
"""

import numpy as np
import torch

INV_4PI = 1.0 / (4.0 * np.pi)


def _sq_norm(x, y, z):
    return x * x + y * y + z * z


def solid_angles(points: torch.Tensor, triangles: torch.Tensor
                 ) -> torch.Tensor:
    """Van Oosterom-Strackee solid angles, (B, Q, 3) x (B, F, 3, 3) ->
    (B, Q, F), built whole: for tests and tiny meshes only."""
    centered = triangles[:, None] - points[:, :, None, None]  # (B,Q,F,3,3)
    norms = torch.linalg.norm(centered, dim=-1)               # (B,Q,F,3)
    cross = torch.linalg.cross(centered[..., 1, :], centered[..., 2, :],
                               dim=-1)
    numerator = (centered[..., 0, :] * cross).sum(-1)
    dot01 = (centered[..., 0, :] * centered[..., 1, :]).sum(-1)
    dot12 = (centered[..., 1, :] * centered[..., 2, :]).sum(-1)
    dot02 = (centered[..., 0, :] * centered[..., 2, :]).sum(-1)
    denominator = (norms.prod(dim=-1) + dot01 * norms[..., 2]
                   + dot02 * norms[..., 1] + dot12 * norms[..., 0])
    return 2.0 * torch.atan2(numerator, denominator)


def _solid_angle_sum(points: torch.Tensor, tris: torch.Tensor
                     ) -> torch.Tensor:
    """Solid angles of a triangle block summed per point.

    points (B, Q, 3), tris (B, f, 3, 3) -> (B, Q), in the JAX package's
    order of operations; every intermediate is one (B, Q, f) tensor.
    A query on a triangle corner gives a = 0, a denominator that starts
    from +0 and adds only zeros, and atan2(±0, +0) = ±0: that face adds 0.
    """
    q = points[:, :, None, :]                                 # (B, Q, 1, 3)
    a = tris[:, None, :, 0, :] - q                            # (B, Q, f, 3)
    b = tris[:, None, :, 1, :] - q
    c = tris[:, None, :, 2, :] - q
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    cx, cy, cz = c.unbind(-1)
    la = torch.sqrt(_sq_norm(ax, ay, az))
    lb = torch.sqrt(_sq_norm(bx, by, bz))
    lc = torch.sqrt(_sq_norm(cx, cy, cz))
    numer = (ax * (by * cz - bz * cy) + ay * (bz * cx - bx * cz)
             + az * (bx * cy - by * cx))
    dab = ax * bx + ay * by + az * bz
    dbc = bx * cx + by * cy + bz * cz
    dac = ax * cx + ay * cy + az * cz
    denom = la * lb * lc + dab * lc + dac * lb + dbc * la
    return (2.0 * torch.atan2(numer, denom)).sum(-1)


def winding_numbers(points: torch.Tensor, triangles: torch.Tensor,
                    block_f: int = 1024) -> torch.Tensor:
    """Generalized winding numbers, streamed over triangle blocks.

    points (B, Q, 3); triangles (B, F, 3, 3) -> (B, Q).
    """
    B, Q, _ = points.shape
    acc = points.new_zeros((B, Q))
    for f0 in range(0, triangles.shape[1], block_f):
        acc = acc + _solid_angle_sum(points, triangles[:, f0:f0 + block_f])
    return acc * INV_4PI


def winding_numbers_same_tris(points: torch.Tensor, vertices: torch.Tensor,
                              faces: torch.Tensor, block_f: int = 1024
                              ) -> torch.Tensor:
    """Winding numbers where triangles come from (vertices, faces).

    points (B, Q, 3); vertices (B, V, 3); faces (F, 3) integer. Each
    block's (B, f, 3, 3) triangles are gathered as the block is reached.
    """
    B, Q, _ = points.shape
    faces = faces.long()
    acc = points.new_zeros((B, Q))
    for f0 in range(0, faces.shape[0], block_f):
        tris = vertices[:, faces[f0:f0 + block_f]]            # (B, f, 3, 3)
        acc = acc + _solid_angle_sum(points, tris)
    return acc * INV_4PI


def masked_min_dist(verts: torch.Tensor, geomask: torch.Tensor,
                    block_m: int = 1024, m_begin: int = 0, m_end=None):
    """For each vertex, the least squared distance to a vertex the mask
    allows, and that vertex: the exact first minimum (lowest index).

    verts (B, V, 3); geomask (V, V) bool, allowed[query, searched].
    Returns (min_d2 (B, V) float, argmin (B, V) int32); a vertex whose
    every pair is banned gets inf and index 0. Streams over column blocks.
    m_begin, m_end: search only the vertices [m_begin, m_end) (the whole
    axis by default); each pair's d2 is the same in any range.
    """
    B, V, _ = verts.shape
    m_end = V if m_end is None else m_end
    geomask = geomask.bool()
    qx, qy, qz = (verts[..., k][:, :, None] for k in range(3))  # (B, V, 1)
    best_d2 = verts.new_full((B, V), float('inf'))
    best_idx = torch.zeros((B, V), dtype=torch.int32, device=verts.device)
    for m0 in range(m_begin, m_end, block_m):
        m1 = min(m0 + block_m, m_end)
        cols = verts[:, m0:m1]                                # (B, m, 3)
        d2 = _sq_norm(*(q - cols[..., k][:, None, :]
                        for k, q in enumerate((qx, qy, qz))))  # (B, V, m)
        d2 = torch.where(geomask[None, :, m0:m1], d2, float('inf'))
        blk_min, blk_arg = d2.min(dim=2)
        upd = blk_min < best_d2
        best_d2 = torch.where(upd, blk_min, best_d2)
        best_idx = torch.where(upd, (blk_arg + m0).int(), best_idx)
    return best_d2, best_idx


# ---------------------------------------------------------------------------
# Region-pair contact signature
# ---------------------------------------------------------------------------

def build_region_pairs(classes, csig, max_region_size=None):
    """Pack the region-pair tables into padded index arrays (numpy).

    classes: list of (name_a, name_b); csig: name -> vertex ids. Returns
    (idx_a (P, R) int32, idx_b, mask_a (P, R) bool, mask_b), R the largest
    region (padding: index 0, mask False).
    """
    if max_region_size is None:
        max_region_size = max(len(np.asarray(v)) for v in csig.values())
    P, R = len(classes), max_region_size
    idx_a = np.zeros((P, R), np.int32)
    idx_b = np.zeros((P, R), np.int32)
    mask_a = np.zeros((P, R), bool)
    mask_b = np.zeros((P, R), bool)
    for p, (na, nb) in enumerate(classes):
        va = np.asarray(csig[na])[:R]
        vb = np.asarray(csig[nb])[:R]
        idx_a[p, :len(va)] = va
        idx_b[p, :len(vb)] = vb
        mask_a[p, :len(va)] = True
        mask_b[p, :len(vb)] = True
    return idx_a, idx_b, mask_a, mask_b


def region_pair_min_dists(verts: torch.Tensor, idx_a, idx_b, mask_a,
                          mask_b, geomask=None) -> torch.Tensor:
    """Least squared distance between the two regions of each pair.

    verts (B, V, 3) -> (B, P); idx_*/mask_* (P, R) tensors; geomask an
    optional (V, V) mask that bans geodesically near pairs. Two phases, as
    in the JAX package: the (R, R) matrix of each pair only picks the
    closest pair (first minimum, without gradient); the value is the direct
    difference of that pair, so the gradient reaches those two vertices
    only. Pairs whose every vertex pair is banned give inf.

    The selection matrix is direct differences here (the JAX package uses
    an fp32-exact Gram form); only near-ties can pick another pair, and the
    value returned is the same direct difference in both.
    """
    B = verts.shape[0]
    R = idx_b.shape[1]
    rows, cols, banned = [], [], []
    with torch.no_grad():
        vd = verts.detach()
        for p in range(idx_a.shape[0]):
            ia, ib = idx_a[p].long(), idx_b[p].long()
            allowed = mask_a[p][:, None] & mask_b[p][None, :]
            if geomask is not None:
                allowed = allowed & geomask[ia][:, ib].bool()
            va, vb = vd[:, ia], vd[:, ib]                     # (B, R, 3)
            d2 = _sq_norm(*(va[..., k][:, :, None] - vb[..., k][:, None, :]
                            for k in range(3)))               # (B, R, R)
            d2 = torch.where(allowed[None], d2, float('inf'))
            flat = d2.reshape(B, -1).argmin(dim=1)
            rows.append(ia[flat // R])
            cols.append(ib[flat % R])
            banned.append(~allowed.any())
    ia_s = torch.stack(rows, dim=1)                           # (B, P)
    ib_s = torch.stack(cols, dim=1)
    va = torch.gather(verts, 1, ia_s[..., None].expand(-1, -1, 3))
    vb = torch.gather(verts, 1, ib_s[..., None].expand(-1, -1, 3))
    diff = va - vb
    d2 = _sq_norm(diff[..., 0], diff[..., 1], diff[..., 2])
    return torch.where(torch.stack(banned)[None], float('inf'), d2)


def masked_sq_dists_highest(a: torch.Tensor, b: torch.Tensor,
                            allowed: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) x (..., M, 3) -> (..., N, M) squared distances in the
    Gram form aa + bb - 2 ab, banned pairs (allowed False) at +inf.

    The one Gram-form distance of the package, for small masked sets (the
    HD contact loss): its product runs in full fp32, with TF32 off whatever
    the global flag says. A TF32 product keeps 10 mantissa bits, ~1e-3
    relative on ab, far above d² at contact distances; in fp32 the
    cancellation leaves ~1e-7 absolute against the 2e-2 contact threshold.
    """
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ab = torch.matmul(a, b.transpose(-1, -2))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    d2 = ((a * a).sum(-1)[..., :, None] + (b * b).sum(-1)[..., None, :]
          - 2.0 * ab)
    return torch.where(allowed.bool(), d2, float('inf'))


def batch_face_normals(triangles: torch.Tensor) -> torch.Tensor:
    """(..., F, 3, 3) -> unit normals (..., F, 3); a zero-area face gives
    a zero normal with a zero gradient."""
    e0 = triangles[..., 1, :] - triangles[..., 0, :]
    e1 = triangles[..., 2, :] - triangles[..., 0, :]
    n = torch.linalg.cross(e0, e1, dim=-1)
    n2 = (n * n).sum(-1, keepdim=True)
    pos = n2 > 0
    return n * pos / torch.sqrt(torch.where(pos, n2, torch.ones_like(n2)))
