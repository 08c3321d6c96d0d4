"""The contact kernels: winding numbers and the masked nearest vertex.

Counterpart of tuch_tpu/ops/contact_pallas.py. The kernels are CUDA C++ in
csrc/winding.cu (kernel 2) and csrc/masked_min.cu (kernel 4); see their
headers for the design. Their plain versions are in ops/contact.py. The
dispatching functions here take the plain version for a CPU tensor and the
kernel for a CUDA tensor; the *_cuda wrappers launch, raise on anything the
kernel does not take, and count their launches.

Neither kernel has a backward: every caller uses them without gradient
(the in/out test and the neighbour search are stop-gradient in the loss).
"""

import ctypes

import torch

from tuch_tpu_torch.ops import _build
from tuch_tpu_torch.ops import contact

WINDING_TQ, WINDING_TF = 128, 128   # csrc/winding.cu TQ, TF
MASKED_TN, MASKED_TM = 128, 256     # csrc/masked_min.cu TN, TM
# Blocks that fill the card: 132 SMs x 8 resident blocks. A kernel whose
# query blocks fall short splits its reduction axis over the grid.
TARGET_BLOCKS = 132 * 8


def _split(base_blocks: int, n: int, tile: int):
    """(chunk, splits) of an axis of n items, chunk a multiple of tile, so
    that base_blocks * splits approaches TARGET_BLOCKS."""
    tiles = -(-n // tile)
    want = max(1, min(tiles, -(-TARGET_BLOCKS // base_blocks)))
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


def masked_min_dist_cuda(verts: torch.Tensor, mask: torch.Tensor):
    """Launch kernel 4: verts (B, V, 3), mask (V, V) uint8 allowed[query,
    searched] -> (min d2 (B, V) float32, argmin (B, V) int32).

    The kernel reads the mask through its transpose: mask.t() must be
    contiguous (ContactAssets stores it so). A contiguous mask is
    transposed here, one (V, V) copy per call.
    """
    what = 'masked_min_dist_cuda'
    _check_points(verts, 3, what, 'verts')
    B, V, _ = verts.shape
    if mask.dtype != torch.uint8 or tuple(mask.shape) != (V, V) \
            or mask.device != verts.device:
        raise ValueError(f'{what}: mask must be uint8 ({V}, {V}) on '
                         f'{verts.device}, got {mask.dtype} '
                         f'{tuple(mask.shape)} on {mask.device}')
    mask_t = mask.t().contiguous()      # a no-op for the stored layout
    d2 = torch.empty((B, V), dtype=torch.float32, device=verts.device)
    idx = torch.empty((B, V), dtype=torch.int32, device=verts.device)
    if B * V == 0:
        return d2, idx
    chunk, splits = _split(B * -(-V // MASKED_TN), V, MASKED_TM)
    keys = torch.empty((B, splits, V), dtype=torch.int64,
                       device=verts.device)
    lib, fn = _build.entry(
        'masked_min', 'tuch_masked_min',
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    with torch.cuda.device(verts.device):
        err = fn(verts.data_ptr(), mask_t.data_ptr(), keys.data_ptr(),
                 d2.data_ptr(), idx.data_ptr(), B, V, chunk,
                 _stream(verts))
    _build.check(lib, err, 'masked-min kernel launch')
    masked_min_dist_cuda.launches += 1
    return d2, idx


winding_numbers_tris_cuda.launches = 0
masked_min_dist_cuda.launches = 0


def winding_numbers_tris(points: torch.Tensor, tris: torch.Tensor
                         ) -> torch.Tensor:
    """Winding numbers against per-row explicit triangles (B, F, 3, 3);
    padding triangles with all corners at one point add exactly 0."""
    if points.device.type == 'cpu':
        return contact.winding_numbers(points, tris,
                                       block_f=min(1024, tris.shape[1]))
    return winding_numbers_tris_cuda(points, tris)


def winding_numbers_faces(points: torch.Tensor, verts: torch.Tensor,
                          faces: torch.Tensor) -> torch.Tensor:
    """Winding numbers against (verts (B, V, 3), faces (F, 3)). On the card
    the (B, F, 3, 3) triangles are gathered in PyTorch, as the JAX wrapper
    gathers them outside its kernel."""
    if points.device.type == 'cpu':
        return contact.winding_numbers_same_tris(points, verts, faces)
    return winding_numbers_tris_cuda(points, verts[:, faces.long()])


def masked_min_dist(verts: torch.Tensor, mask: torch.Tensor):
    """Masked nearest vertex: (min d2 (B, V), argmin (B, V) int32); inf
    and 0 where every pair is banned."""
    if verts.device.type == 'cpu':
        return contact.masked_min_dist(verts, mask)
    return masked_min_dist_cuda(verts, mask)
