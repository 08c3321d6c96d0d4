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

ViTPose is the other backbone here: ViTPose's ViT as HMR 2.0 runs it
(github.com/shubham-goel/4D-Humans, hmr2/models/backbones/vit.py;
arXiv:2204.12484), under its module names: a padded convolution for the
patch embedding, a learned position embedding whose cls slot is added to
every token, pre-LN blocks with exact gelu and drop path, and the tokens
out (no pool). Its dtype rules are the ViT's above.
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


class PatchEmbed(nn.Module):
    """ViTPose's patch embedding: a Conv2d of kernel and stride `patch`
    with padding 2 (ViTPose's 4 + 2 (ratio // 2 - 1) at ratio 1), 3 ->
    width, on NCHW images; tokens (B, gh * gw, width) in row-major grid
    order."""

    PADDING = 2

    def __init__(self, width: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(3, width, patch, stride=patch,
                              padding=self.PADDING)

    def forward(self, x):
        w = self.proj.weight.to(x.dtype)
        x = self.proj._conv_forward(x, w, self.proj.bias.to(x.dtype))
        return x.flatten(2).transpose(1, 2)

    @staticmethod
    def grid(size: int, patch: int) -> int:
        """Tokens along an axis of `size` pixels."""
        return (size + 2 * PatchEmbed.PADDING - patch) // patch + 1


class Mlp(nn.Module):
    """fc1, exact gelu, fc2."""

    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(width, hidden)
        self.fc2 = Linear(hidden, width)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


def drop_path(x, keep, prob: float):
    """timm's DropPath on per-sample keep-masks (B,) bool: kept samples
    x / prob, dropped ones 0; x as it is where prob is 1 (rate 0)."""
    if keep is None or prob == 1.0:
        return x
    return x.div(prob) * keep.to(x.dtype)[:, None, None]


class PoseBlock(nn.Module):
    """ViTPose's block: x + dp(attn(LN(x))); x + dp(mlp(LN(x))), LayerNorm
    eps 1e-6, each branch's drop path kept with probability `keep_prob`."""

    def __init__(self, width: int, heads: int, mlp_ratio: int,
                 keep_prob: float):
        super().__init__()
        self.keep_prob = keep_prob
        self.norm1 = nn.LayerNorm(width, eps=LN_EPS)
        self.attn = Attention(width, heads)
        self.norm2 = nn.LayerNorm(width, eps=LN_EPS)
        self.mlp = Mlp(width, mlp_ratio * width)

    def forward(self, x, keep_attn=None, keep_mlp=None):
        y = self.attn(layer_norm(self.norm1, x))
        x = x + drop_path(y, keep_attn, self.keep_prob)
        y = self.mlp(layer_norm(self.norm2, x))
        return x + drop_path(y, keep_mlp, self.keep_prob)


def drop_path_keep_probs(depth: int, rate: float):
    """Each block's keep probability, 1 - linspace(0, rate, depth) as timm
    and ViTPose compute it (the rates in float32, then Python floats)."""
    rates = torch.linspace(0, rate, depth, device='cpu')
    return [1.0 - r for r in rates.tolist()]


class ViTPose(nn.Module):
    """ViTPose's ViT: NHWC (B, H, W, 3) crops -> tokens (B, gh * gw,
    width), float32 after the last LayerNorm.

    The position embedding (1, 1 + gh * gw, width) is learned for one input
    size: its first slot (ViTPose's cls slot; there is no cls token) is
    added to every token, x + pos[:, 1:] + pos[:, :1]. In train mode the
    blocks' branches take drop path on the keep-masks (2 depth, B) bool
    passed in (row 2 i block i's attention, 2 i + 1 its MLP); None (eval)
    has none."""

    def __init__(self, width: int, depth: int, heads: int, patch: int,
                 grid, mlp_ratio: int = 4, drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.width, self.patch, self.dtype = width, patch, dtype
        self.grid = tuple(grid)
        self.patch_embed = PatchEmbed(width, patch)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, 1 + self.grid[0] * self.grid[1], width))
        self.blocks = nn.ModuleList(
            PoseBlock(width, heads, mlp_ratio, keep)
            for keep in drop_path_keep_probs(depth, drop_path_rate))
        self.last_norm = nn.LayerNorm(width, eps=LN_EPS)

    def forward(self, x, keep=None):
        B, H, W, _ = x.shape
        grid = (PatchEmbed.grid(H, self.patch), PatchEmbed.grid(W, self.patch))
        if grid != self.grid:
            raise ValueError(f'ViTPose was built for a {self.grid} token '
                             f'grid; a {H}x{W} input gives {grid}')
        x = self.patch_embed(x.to(self.dtype).permute(0, 3, 1, 2))
        pos = self.pos_embed.to(self.dtype)
        x = x + pos[:, 1:] + pos[:, :1]
        for i, block in enumerate(self.blocks):
            if keep is None:
                x = block(x)
            else:
                x = block(x, keep[2 * i], keep[2 * i + 1])
        return self.last_norm(x.float())
