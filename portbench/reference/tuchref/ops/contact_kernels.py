"""The contact kernels: winding numbers and the masked nearest vertex.

Counterpart of tuch_tpu/ops/contact_pallas.py. The kernels are CUDA C++ in
csrc/winding.cu (kernel 2), csrc/masked_min.cu (kernel 4) and
csrc/winding_affine.cu (kernel 3); see their headers for the design. The
plain versions of kernels 2 and 4 are in ops/contact.py, that of kernel 3
is here. The dispatching functions here take the plain version for a CPU
tensor and the kernel for a CUDA tensor; the *_cuda wrappers launch, raise
on anything the kernel does not take, and count their launches.

No kernel has a backward: every caller uses them without gradient (the
in/out test and the neighbour search are stop-gradient in the loss).

The affine route (winding_numbers_affine) is experimental, as in the JAX
package: no path of this package calls it. Its 1 mm corner mask zeroes
real solid angle for queries in tight self-contact
(tuch_tpu/ops/contact_pallas.py, _winding_affine_kernel).
"""

import ctypes

import torch

from portbench.reference.tuchref.ops import _build
from portbench.reference.tuchref.ops import contact

WINDING_TQ, WINDING_TF = 512, 128   # csrc/winding.cu BQ (TQ x QPT), TF
# Blocks that fill the card: 132 SMs x 8 resident blocks. A kernel whose
# query blocks fall short splits its reduction axis over the grid.
TARGET_BLOCKS = 132 * 8


def _split(base_blocks: int, n: int, tile: int, target=TARGET_BLOCKS):
    """(chunk, splits) of an axis of n items, chunk a multiple of tile, so
    that base_blocks * splits approaches target."""
    tiles = -(-n // tile)
    want = max(1, min(tiles, -(-target // base_blocks)))
    chunk = -(-tiles // want) * tile
    return chunk, -(-n // chunk)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_points(x: torch.Tensor, dims: int, what: str, name: str):
    if x.device.type != 'cuda':
        raise ValueError(f'{what} needs CUDA tensors, got {name} on '
                         f'{x.device}')
    if x.dtype != torch.float32 or x.dim() != dims or x.shape[-1] != 3 \
            or not x.is_contiguous():
        raise ValueError(f'{what}: {name} must be a contiguous float32 '
                         f'tensor of {dims} dims ending in 3, got '
                         f'{x.dtype} {tuple(x.shape)}')


def winding_numbers_tris_cuda(points: torch.Tensor, tris: torch.Tensor
                              ) -> torch.Tensor:
    """Launch kernel 2: points (B, Q, 3), tris (B, F, 3, 3) -> (B, Q)."""
    what = 'winding_numbers_tris_cuda'
    _check_points(points, 3, what, 'points')
    _check_points(tris, 4, what, 'tris')
    B, Q, _ = points.shape
    F = tris.shape[1]
    if tris.shape[0] != B or tris.shape[2] != 3 \
            or tris.device != points.device:
        raise ValueError(f'{what}: tris must be (B={B}, F, 3, 3) on '
                         f'{points.device}, got {tuple(tris.shape)} on '
                         f'{tris.device}')
    out = torch.empty((B, Q), dtype=torch.float32, device=points.device)
    if B * Q == 0:
        return out
    if F == 0:
        return out.zero_()
    chunk, splits = _split(B * -(-Q // WINDING_TQ), F, WINDING_TF)
    partial = torch.empty((B, splits, Q), dtype=torch.float32,
                          device=points.device) if splits > 1 else None
    lib, fn = _build.entry(
        'winding', 'tuch_winding_numbers',
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(points.device):
        err = fn(points.data_ptr(), tris.data_ptr(), out.data_ptr(),
                 None if partial is None else partial.data_ptr(), B, Q, F,
                 chunk, contact.INV_4PI, _stream(points))
    _build.check(lib, err, 'winding kernel launch')
    winding_numbers_tris_cuda.launches += 1
    return out


def pack_mask_bits(mask: torch.Tensor) -> torch.Tensor:
    """Kernel 4's mask: (Q, V) allowed[query, searched], bool or uint8 in
    any layout -> (Q, ceil(V / 32)) int32 words on the same device; bit b
    of word w of row q is allowed[q, 32 w + b], and the bits past V are 0
    (banned). The main path packs once, with the contact assets
    (runtime.contact_assets)."""
    Q, V = mask.shape
    W = -(-V // 32)
    padded = torch.zeros((Q, 32 * W), dtype=torch.uint8, device=mask.device)
    padded[:, :V] = mask != 0
    weights = torch.tensor([1 << k for k in range(8)], dtype=torch.uint8,
                           device=mask.device)
    packed = (padded.view(Q, 4 * W, 8) * weights).sum(-1, dtype=torch.uint8)
    return packed.view(torch.int32)       # little-endian: byte k, bits 8k+


def kernel_shape(name: str, n: int):
    """The n ints that csrc/<name>.cu's tuch_<name>_shape reports: the
    built kernel's tile shape, which its wrapper plans the grid from."""
    lib, fn = _build.entry(name, f'tuch_{name}_shape', [ctypes.c_void_p])
    out = (ctypes.c_int * n)()
    fn(out)
    return tuple(out)


def masked_min_shape():
    """(threads, queries per thread, bodies per block, searched vertices
    per tile) of the built csrc/masked_min.cu."""
    return kernel_shape('masked_min', 4)


def masked_min_plan(B: int, V: int, shape):
    """(chunk, splits) of kernel 4's searched axis for B bodies of V
    vertices, given masked_min_shape()."""
    T, R, G, TM = shape
    return _split(-(-B // G) * -(-V // (T * R)), V, TM)


def masked_min_dist_cuda(verts: torch.Tensor, mask: torch.Tensor,
                         bits: torch.Tensor = None):
    """Launch kernel 4: verts (B, V, 3), mask (V, V) uint8 allowed[query,
    searched] -> (min d2 (B, V) float32, argmin (B, V) int32).

    The kernel reads the mask as bits, pack_mask_bits(mask): pass them as
    `bits` (ContactAssets.geomask_bits); without them this call packs
    first.
    """
    what = 'masked_min_dist_cuda'
    _check_points(verts, 3, what, 'verts')
    B, V, _ = verts.shape
    if mask.dtype != torch.uint8 or tuple(mask.shape) != (V, V) \
            or mask.device != verts.device:
        raise ValueError(f'{what}: mask must be uint8 ({V}, {V}) on '
                         f'{verts.device}, got {mask.dtype} '
                         f'{tuple(mask.shape)} on {mask.device}')
    W = -(-V // 32)
    if bits is None:
        bits = pack_mask_bits(mask)
    elif bits.dtype != torch.int32 or tuple(bits.shape) != (V, W) \
            or not bits.is_contiguous() or bits.device != verts.device:
        raise ValueError(f'{what}: bits must be contiguous int32 ({V}, {W}) '
                         f'on {verts.device} (pack_mask_bits), got '
                         f'{bits.dtype} {tuple(bits.shape)} on {bits.device}')
    d2 = torch.empty((B, V), dtype=torch.float32, device=verts.device)
    idx = torch.empty((B, V), dtype=torch.int32, device=verts.device)
    if B * V == 0:
        return d2, idx
    shape = masked_min_shape()
    if -(-B // shape[2]) > 65535:
        raise ValueError(f'{what}: B={B} is too large for the grid')
    chunk, splits = masked_min_plan(B, V, shape)
    keys = torch.empty((B, splits, V), dtype=torch.int64,
                       device=verts.device)
    lib, fn = _build.entry(
        'masked_min', 'tuch_masked_min',
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    with torch.cuda.device(verts.device):
        err = fn(verts.data_ptr(), bits.data_ptr(), keys.data_ptr(),
                 d2.data_ptr(), idx.data_ptr(), B, V, W, chunk,
                 _stream(verts))
    _build.check(lib, err, 'masked-min kernel launch')
    masked_min_dist_cuda.launches += 1
    return d2, idx


# A merged key of kernel 4's range entry: d2's float bits above the index;
# +inf and index 0 where nothing is allowed (csrc/masked_min.cu EMPTY_KEY).
EMPTY_KEY = 0x7f800000 << 32


def encode_keys(d2: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(d2 (B, V) float32 >= 0, idx (B, V) int32) -> (B, V) int64 keys, as
    the range entry writes them: d2 >= 0, so a key is a non-negative int64
    and a signed MIN orders keys by d2, then by index."""
    return (d2.contiguous().view(torch.int32).long() << 32) | idx.long()


def decode_keys(keys: torch.Tensor):
    """(B, V) int64 keys -> (min d2 (B, V) float32, argmin (B, V) int32)."""
    d2 = (keys >> 32).to(torch.int32).view(torch.float32)
    return d2, (keys & 0xffffffff).to(torch.int32)


def masked_min_keys_ref(verts: torch.Tensor, mask: torch.Tensor,
                        m_begin: int, m_end: int) -> torch.Tensor:
    """Plain version of kernel 4's range entry: the first minimum over the
    searched vertices [m_begin, m_end) as (B, V) int64 keys, EMPTY_KEY
    where the range allows nothing. The MIN of the keys of ranges that
    cover the axis decodes to masked_min_dist over the whole axis."""
    d2, idx = contact.masked_min_dist(verts, mask, m_begin=m_begin,
                                      m_end=m_end)
    return encode_keys(d2, idx)


def masked_min_keys_cuda(verts: torch.Tensor, mask: torch.Tensor,
                         bits: torch.Tensor, m_begin: int, m_end: int
                         ) -> torch.Tensor:
    """Launch kernel 4's range entry: verts (B, V, 3), mask (V, V) uint8,
    bits pack_mask_bits(mask) -> (B, V) int64 keys over the searched
    vertices [m_begin, m_end); m_begin a multiple of 32 (or the range
    empty), m_end a multiple of 32 or V."""
    what = 'masked_min_keys_cuda'
    _check_points(verts, 3, what, 'verts')
    B, V, _ = verts.shape
    W = -(-V // 32)
    if mask.dtype != torch.uint8 or tuple(mask.shape) != (V, V) \
            or bits is None or bits.dtype != torch.int32 \
            or tuple(bits.shape) != (V, W) or not bits.is_contiguous() \
            or bits.device != verts.device or mask.device != verts.device:
        raise ValueError(f'{what}: mask must be uint8 ({V}, {V}) and bits '
                         f'contiguous int32 ({V}, {W}) on {verts.device}')
    if not (0 <= m_begin <= m_end <= V) \
            or (m_begin % 32 and m_begin != m_end) \
            or (m_end % 32 and m_end != V):
        raise ValueError(f'{what}: range [{m_begin}, {m_end}) must lie in '
                         f'[0, {V}] and start and end on mask words')
    keys = torch.empty((B, V), dtype=torch.int64, device=verts.device)
    if B * V == 0:
        return keys
    shape = masked_min_shape()
    T, R, G, TM = shape
    if -(-B // G) > 65535:
        raise ValueError(f'{what}: B={B} is too large for the grid')
    chunk, _ = _split(-(-B // G) * -(-V // (T * R)),
                      max(1, m_end - m_begin), TM)
    lib, fn = _build.entry(
        'masked_min', 'tuch_masked_min_range',
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    with torch.cuda.device(verts.device):
        err = fn(verts.data_ptr(), bits.data_ptr(), keys.data_ptr(), B, V,
                 W, chunk, m_begin, m_end, _stream(verts))
    _build.check(lib, err, 'masked-min range kernel launch')
    masked_min_keys_cuda.launches += 1
    return keys


def affine_shape():
    """(threads, queries per thread, triangles per tile) of the built
    csrc/winding_affine.cu."""
    return kernel_shape('winding_affine', 3)


def affine_plan(B: int, Q: int, F: int, shape):
    """(chunk, splits) of kernel 3's triangle axis for B rows of Q queries
    against F triangles, given affine_shape()."""
    T, R, TF = shape
    return _split(B * -(-Q // (T * R)), F, TF)


def winding_numbers_affine_cuda(points4: torch.Tensor, rows: torch.Tensor
                                ) -> torch.Tensor:
    """Launch kernel 3: points4 (B, 4, Q) rows [qx qy qz q.q], rows (B, F,
    28) from affine_constant_rows (each triangle's seven groups in a row;
    affine_triangle_constants is its transpose) -> (B, Q)."""
    what = 'winding_numbers_affine_cuda'
    for name, x, dim, size in (('points4', points4, 1, 4),
                               ('rows', rows, 2, 28)):
        if x.device.type != 'cuda':
            raise ValueError(f'{what} needs CUDA tensors, got {name} on '
                             f'{x.device}')
        if x.dtype != torch.float32 or x.dim() != 3 \
                or x.shape[dim] != size or not x.is_contiguous():
            want = '(B, 4, Q)' if dim == 1 else '(B, F, 28)'
            raise ValueError(f'{what}: {name} must be a contiguous float32 '
                             f'{want} tensor, got {x.dtype} '
                             f'{tuple(x.shape)}')
    B, _, Q = points4.shape
    F = rows.shape[1]
    if rows.shape[0] != B or rows.device != points4.device \
            or rows.data_ptr() % 16:
        raise ValueError(f'{what}: rows must be (B={B}, F, 28), 16-byte '
                         f'aligned, on {points4.device}; got '
                         f'{tuple(rows.shape)} on {rows.device}')
    out = torch.empty((B, Q), dtype=torch.float32, device=points4.device)
    if B * Q == 0:
        return out
    if F == 0:
        return out.zero_()
    chunk, splits = affine_plan(B, Q, F, affine_shape())
    partial = torch.empty((B, splits, Q), dtype=torch.float32,
                          device=points4.device) if splits > 1 else None
    lib, fn = _build.entry(
        'winding_affine', 'tuch_winding_affine',
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(points4.device):
        err = fn(points4.data_ptr(), rows.data_ptr(), out.data_ptr(),
                 None if partial is None else partial.data_ptr(), B, Q, F,
                 chunk, contact.INV_4PI, _stream(points4))
    _build.check(lib, err, 'affine winding kernel launch')
    winding_numbers_affine_cuda.launches += 1
    return out


winding_numbers_tris_cuda.launches = 0
masked_min_dist_cuda.launches = 0
masked_min_keys_cuda.launches = 0
winding_numbers_affine_cuda.launches = 0


def winding_numbers_tris(points: torch.Tensor, tris: torch.Tensor
                         ) -> torch.Tensor:
    """Winding numbers against per-row explicit triangles (B, F, 3, 3);
    padding triangles with all corners at one point add exactly 0."""
    if True:  # the reference runs the plain version on every device
        return contact.winding_numbers(points, tris,
                                       block_f=min(1024, tris.shape[1]))
    return winding_numbers_tris_cuda(points, tris)


def winding_numbers_faces(points: torch.Tensor, verts: torch.Tensor,
                          faces: torch.Tensor) -> torch.Tensor:
    """Winding numbers against (verts (B, V, 3), faces (F, 3)). On the card
    the (B, F, 3, 3) triangles are gathered in PyTorch, as the JAX wrapper
    gathers them outside its kernel."""
    if True:  # the reference runs the plain version on every device
        return contact.winding_numbers_same_tris(points, verts, faces)
    return winding_numbers_tris_cuda(points, verts[:, faces.long()])


def masked_min_dist(verts: torch.Tensor, mask: torch.Tensor,
                    bits: torch.Tensor = None):
    """Masked nearest vertex: (min d2 (B, V), argmin (B, V) int32); inf
    and 0 where every pair is banned. bits: pack_mask_bits(mask), which the
    kernel reads (the plain version reads the mask)."""
    if True:  # the reference runs the plain version on every device
        return contact.masked_min_dist(verts, mask)
    return masked_min_dist_cuda(verts, mask, bits)


def masked_min_keys(verts: torch.Tensor, mask: torch.Tensor,
                    bits: torch.Tensor, m_begin: int, m_end: int
                    ) -> torch.Tensor:
    """The masked nearest vertex over the searched vertices [m_begin,
    m_end) as (B, V) int64 keys (encode_keys): the plain version for a CPU
    tensor, kernel 4's range entry for a CUDA one."""
    if True:  # the reference runs the plain version on every device
        return masked_min_keys_ref(verts, mask, m_begin, m_end)
    return masked_min_keys_cuda(verts, mask, bits, m_begin, m_end)


# ---------------------------------------------------------------------------
# Kernel 3: affine-form winding numbers (experimental)
# ---------------------------------------------------------------------------

CORNER_EPS2 = 1e-6   # (1 mm)^2: a pair this close to a corner adds 0


def _cross(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u x v over the last axis, in jnp.cross's order of operations."""
    ux, uy, uz = u.unbind(-1)
    vx, vy, vz = v.unbind(-1)
    return torch.stack([uy * vz - uz * vy, uz * vx - ux * vz,
                        ux * vy - uy * vx], dim=-1)


def _dot3(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u . v over the last axis, summed as (x + y) + z."""
    ux, uy, uz = u.unbind(-1)
    vx, vy, vz = v.unbind(-1)
    return ux * vx + uy * vy + uz * vz


def affine_constant_rows(tris: torch.Tensor) -> torch.Tensor:
    """(B, F, 3, 3) corners -> (B, F, 28): each triangle's constants of
    kernel 3 in a row, the layout the kernel reads.

    Seven groups of four, each [-vec, const], so that [q, 1] . group is
    const - q . vec (tuch_tpu/ops/contact_pallas.py,
    _affine_triangle_constants):
      numer  BxC + CxA + AxB, det(A, B, C);   dab  A+B, A.B;
      dbc    B+C, B.C;   dac  A+C, A.C;   la2  2A, A.A;   lb2  2B, B.B;
      lc2    2C, C.C.
    """
    A, Bc, C = tris[..., 0, :], tris[..., 1, :], tris[..., 2, :]
    n = _cross(Bc, C) + _cross(C, A) + _cross(A, Bc)
    groups = [(n, _dot3(A, _cross(Bc, C))), (A + Bc, _dot3(A, Bc)),
              (Bc + C, _dot3(Bc, C)), (A + C, _dot3(A, C)),
              (2 * A, _dot3(A, A)), (2 * Bc, _dot3(Bc, Bc)),
              (2 * C, _dot3(C, C))]
    return torch.cat([torch.cat([-vec, const[..., None]], dim=-1)
                      for vec, const in groups], dim=-1).contiguous()


def affine_triangle_constants(tris: torch.Tensor) -> torch.Tensor:
    """(B, F, 3, 3) corners -> (B, 28, F): affine_constant_rows
    transposed, the JAX package's layout and the plain version's."""
    return affine_constant_rows(tris).transpose(1, 2).contiguous()


def affine_points(points: torch.Tensor) -> torch.Tensor:
    """(B, Q, 3) -> (B, 4, Q) rows [qx qy qz q.q], kernel 3's queries."""
    qq = contact._sq_norm(*points.unbind(-1))
    return torch.cat([points, qq[..., None]], dim=-1).transpose(1, 2) \
        .contiguous()


def winding_numbers_affine_ref(points4: torch.Tensor, tc: torch.Tensor,
                               block_f: int = 1024) -> torch.Tensor:
    """Plain version of kernel 3, (B, 4, Q) x (B, 28, F) -> (B, Q).

    Per pair: seven dots [q, 1] . group as ((qx c0 + qy c1) + qz c2) + c3,
    q.q added to all but the first, la = sqrt(max(la2, 0)) and the others
    alike, the denominator, 2 atan2(numer, denom), and 0 where
    min(la2, lb2, lc2) < 1e-6. Each operation is its own tensor op, so
    nothing is fused: the kernel's la2, lb2 and lc2 equal these bit for
    bit. Streamed over blocks of block_f triangles; every intermediate is
    one (B, Q, f) tensor.
    """
    B, _, Q = points4.shape
    qx, qy, qz, qq = (points4[:, k, :, None] for k in range(4))  # (B, Q, 1)
    eps2 = torch.tensor(CORNER_EPS2, dtype=points4.dtype,
                        device=points4.device)
    zero = torch.zeros((), dtype=points4.dtype, device=points4.device)
    acc = points4.new_zeros((B, Q))
    for f0 in range(0, tc.shape[2], block_f):
        c = tc[:, :, None, f0:f0 + block_f]                 # (B, 28, 1, f)

        def dot4(g):
            return ((qx * c[:, 4 * g] + qy * c[:, 4 * g + 1])
                    + qz * c[:, 4 * g + 2]) + c[:, 4 * g + 3]

        numer = dot4(0)
        dab, dbc, dac, la2, lb2, lc2 = (dot4(g) + qq for g in range(1, 7))
        la, lb, lc = (torch.sqrt(torch.maximum(x, zero))
                      for x in (la2, lb2, lc2))
        denom = la * lb * lc + dab * lc + dac * lb + dbc * la
        ang = 2.0 * torch.atan2(numer, denom)
        corner = torch.minimum(torch.minimum(la2, lb2), lc2) < eps2
        acc = acc + torch.where(corner, zero, ang).sum(-1)
    return acc * contact.INV_4PI


def winding_numbers_affine(points: torch.Tensor, verts: torch.Tensor,
                           faces: torch.Tensor) -> torch.Tensor:
    """Affine-form winding numbers, the contract of the JAX package's
    winding_numbers_pallas_affine: points (B, Q, 3), verts (B, V, 3), faces
    (F, 3) -> (B, Q). The constants are formed in PyTorch, as the JAX
    wrapper forms them outside its kernel. Experimental (module note)."""
    points4 = affine_points(points)
    tris = verts[:, faces.long()]
    if True:  # the reference runs the plain version on every device
        return winding_numbers_affine_ref(points4,
                                          affine_triangle_constants(tris))
    return winding_numbers_affine_cuda(points4, affine_constant_rows(tris))
