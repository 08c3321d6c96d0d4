"""Fused multi-head self-attention for the ViT backbone.

Counterpart of tuch_tpu/ops/attention_pallas.py. The kernel is CUDA C++ in
csrc/mha.cu (see its header for the design); this module holds its plain
PyTorch version, its wrapper and its launch count.

Layout: qkv is the (B, N, 3C) output of the fused qkv Linear, head-major
within each third (column ((i3 * H) + h) * hd + d, models/vit.py); the
result is (B, N, C) with column h * hd + d.
"""

import ctypes
import math

import torch

from tuch_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64)


def mha_reference(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain attention on the fused qkv tensor, in qkv.dtype.

    Mirrors attention_pallas.mha_reference: fp32 logits and softmax, the
    probabilities cast to qkv.dtype, the value product accumulated in fp32
    and cast back.
    """
    B, N, C3 = qkv.shape
    C = C3 // 3
    hd = C // heads
    q, k, v = qkv.reshape(B, N, 3, heads, hd).unbind(2)
    logits = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float())
    logits = logits * (1.0 / math.sqrt(hd))
    probs = torch.softmax(logits, dim=-1).to(qkv.dtype)
    out = torch.einsum('bhqk,bkhd->bqhd', probs.float(), v.float())
    return out.reshape(B, N, C).to(qkv.dtype)


def _entry():
    lib = _build.load('mha')
    fn = lib.tuch_mha_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, fn


def mha_cuda(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Launch csrc/mha.cu on a CUDA tensor; counts each launch."""
    if qkv.device.type != 'cuda':
        raise ValueError(f'mha_cuda needs a CUDA tensor, got {qkv.device}')
    if qkv.dtype not in _DTYPE_CODES:
        raise ValueError(f'mha_cuda takes float32 or bfloat16, got '
                         f'{qkv.dtype}')
    if qkv.dim() != 3 or qkv.shape[2] % (3 * heads):
        raise ValueError(f'qkv must be (B, N, 3 * heads * hd), got '
                         f'{tuple(qkv.shape)} with heads={heads}')
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError('mha_cuda needs a contiguous, 16-byte aligned qkv '
                         'tensor (the kernel copies 16-byte chunks)')
    B, N, C3 = qkv.shape
    C = C3 // 3
    hd = C // heads
    if hd not in HEAD_DIMS:
        raise ValueError(f'mha_cuda supports head dims {HEAD_DIMS}, got {hd}')
    out = torch.empty((B, N, C), dtype=qkv.dtype, device=qkv.device)
    lib, fn = _entry()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(qkv.data_ptr(), out.data_ptr(), B, N, heads, hd,
                 _DTYPE_CODES[qkv.dtype], 1.0 / math.sqrt(hd), stream)
    _build.check(lib, err, 'mha kernel launch')
    mha_cuda.launches += 1
    return out


mha_cuda.launches = 0


def _forward(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """The plain version for a CPU tensor, the CUDA kernel for a CUDA
    tensor (which raises rather than fall back)."""
    if qkv.device.type == 'cpu':
        return mha_reference(qkv, heads)
    return mha_cuda(qkv, heads)


class _FusedMHA(torch.autograd.Function):
    """Counterpart of attention_pallas.fused_mha's custom_vjp: the forward
    by device (kernel 1 on the card), the backward the gradient of
    mha_reference recomputed on the saved qkv, as _fused_mha_bwd does.
    There is no backward kernel: the JAX package has none."""

    @staticmethod
    def forward(ctx, qkv, heads):
        ctx.heads = heads
        ctx.save_for_backward(qkv)
        with torch.no_grad():
            return _forward(qkv, heads)

    @staticmethod
    def backward(ctx, grad):
        qkv, = ctx.saved_tensors
        with torch.enable_grad():
            x = qkv.detach().requires_grad_(True)
            gx, = torch.autograd.grad(mha_reference(x, ctx.heads), x, grad)
        return gx, None


def fused_mha(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Attention by device, differentiable on both: through _FusedMHA when
    a gradient is wanted, else straight to the plain version or the
    kernel (serving builds no graph)."""
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _FusedMHA.apply(qkv, heads)
    return _forward(qkv, heads)
