"""ViT backbone for the HMR regressor.

Counterpart of tuch_tpu/models/vit.py, and able to run its weights: patch
reshape in (py, px, c) order plus a Linear embed, fixed 2D sin-cos position
embedding, pre-LN blocks, a final LayerNorm and a mean pool over tokens.
Flax's conventions are kept where they differ from torch's defaults:
LayerNorm eps 1e-6 and the tanh approximation of gelu.

Attention goes through ops/attention.fused_mha: the CUDA kernel on the card,
its plain version on the CPU. The Linears are plain torch (cuBLAS).

Compute dtype (``dtype``, float32 or bfloat16), as the JAX package's ViT:
the image is cast to it before the patch reshape, the Linears and the
position embedding run in it, and so does the residual stream; the
LayerNorms run in float32 on a float32 copy and are cast back, and the final
LayerNorm and the mean pool are float32. Parameters stay float32: a Linear
casts its weights to the input's dtype at each call.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tuch_tpu_torch.ops.attention import fused_mha

# name -> (width, depth, heads, patch); vit_t8 is the toy size of the tests.
VIT_CONFIGS = {
    'vit_t8': (64, 2, 2, 8),
    'vit_s16': (384, 12, 6, 16),
    'vit_b16': (768, 12, 12, 16),
}

LN_EPS = 1e-6  # flax.linen.LayerNorm's default


def sincos_posemb_2d(h: int, w: int, dim: int) -> np.ndarray:
    """Fixed 2D sin-cos position embedding, (h * w, dim) float32.

    Half the channels encode the row, half the column, each as sin then cos
    over a geometric frequency ladder (the MAE convention).
    """
    if dim % 4:
        raise ValueError(f'posemb dim must be divisible by 4, got {dim}')
    quarter = dim // 4
    omega = 1.0 / (10000.0 ** (np.arange(quarter, dtype=np.float32)
                               / quarter))

    def axis_emb(n):
        pos = np.arange(n, dtype=np.float32)
        ang = np.einsum('p,f->pf', pos, omega)
        return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)

    row = np.repeat(axis_emb(h), w, axis=0)   # (h * w, dim / 2)
    col = np.tile(axis_emb(w), (h, 1))        # (h * w, dim / 2)
    return np.concatenate([row, col], axis=-1).astype(np.float32)


class Linear(nn.Linear):
    """nn.Linear in the input's dtype, on float32 weights cast per call
    (a no-op for a float32 input)."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def layer_norm(ln: nn.LayerNorm, x):
    """ln in float32, cast back to x's dtype."""
    return ln(x.float()).to(x.dtype)


class Attention(nn.Module):
    """Multi-head self-attention with a fused, head-major qkv Linear."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(width, 3 * width)
        self.proj = Linear(width, width)

    def forward(self, x):
        return self.proj(fused_mha(self.qkv(x), self.heads))


class Block(nn.Module):
    """Pre-LN transformer block: x + MHA(LN(x)); x + MLP(LN(x))."""

    def __init__(self, width: int, heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.ln1 = nn.LayerNorm(width, eps=LN_EPS)
        self.attn = Attention(width, heads)
        self.ln2 = nn.LayerNorm(width, eps=LN_EPS)
        self.fc1 = Linear(width, mlp_ratio * width)
        self.fc2 = Linear(mlp_ratio * width, width)

    def forward(self, x):
        x = x + self.attn(layer_norm(self.ln1, x))
        h = F.gelu(self.fc1(layer_norm(self.ln2, x)), approximate='tanh')
        return x + self.fc2(h)


class ViT(nn.Module):
    """ViT feature extractor: NHWC images -> (B, width) pooled features."""

    def __init__(self, width: int = 384, depth: int = 12, heads: int = 6,
                 patch: int = 16, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.width, self.patch, self.dtype = width, patch, dtype
        self.embed = Linear(patch * patch * 3, width)
        self.blocks = nn.ModuleList(Block(width, heads) for _ in range(depth))
        self.ln_final = nn.LayerNorm(width, eps=LN_EPS)
        self._posemb = {}  # (gh, gw, device, dtype) -> (gh * gw, width)

    def posemb(self, gh: int, gw: int, device, dtype) -> torch.Tensor:
        """The float32 embedding rounded to dtype, cached."""
        key = (gh, gw, str(device), dtype)
        if key not in self._posemb:
            self._posemb[key] = torch.from_numpy(
                sincos_posemb_2d(gh, gw, self.width)).to(device, dtype)
        return self._posemb[key]

    def forward(self, x):
        B, H, W, C = x.shape
        p = self.patch
        if H % p or W % p:
            raise ValueError(
                f'ViT patch {p} needs H, W divisible by it, got {H}x{W}')
        gh, gw = H // p, W // p
        x = x.to(self.dtype)
        # (py, px, c) flattening order, as the JAX package's reshape
        x = x.reshape(B, gh, p, gw, p, C).permute(0, 1, 3, 2, 4, 5)
        x = self.embed(x.reshape(B, gh * gw, p * p * C))
        x = x + self.posemb(gh, gw, x.device, self.dtype)
        for block in self.blocks:
            x = block(x)
        return self.ln_final(x.float()).mean(dim=1)


def create_vit(name: str, dtype: torch.dtype = torch.float32) -> ViT:
    if name not in VIT_CONFIGS:
        raise ValueError(
            f'unknown ViT config {name!r}; have {sorted(VIT_CONFIGS)}')
    width, depth, heads, patch = VIT_CONFIGS[name]
    return ViT(width=width, depth=depth, heads=heads, patch=patch,
               dtype=dtype)
