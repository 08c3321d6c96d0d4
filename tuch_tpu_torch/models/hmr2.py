"""HMR 2.0: a ViTPose-H/16 backbone and a transformer-decoder SMPL head.

"Humans in 4D" (Goel et al., ICCV 2023, arXiv:2305.20091),
github.com/shubham-goel/4D-Humans: hmr2/models/backbones/vit.py (ViTPose,
arXiv:2204.12484), hmr2/models/heads/smpl_head.py,
hmr2/models/components/pose_transformer.py and the widths of
hmr2/configs_hydra/experiment/hmr_vit_transformer.yaml, under their module
names (backbone.*, smpl_head.*).

  crop     the square NHWC image's columns W/8 : W - W/8 (256 -> 256x192)
  backbone ViTPose (models/vit.ViTPose): 32 blocks of width 1280, 16 heads
           of dim 80 through ops/attention.fused_mha (kernel 1 on the card),
           drop path ramped to 0.55 over the blocks; tokens (B, 192, 1280)
  head     one query from a zero input, Linear(1, 1024) plus a learned
           position; 6 layers of x = SA(LN(x)) + x, x = CA(LN(x), tokens)
           + x, x = FF(LN(x)) + x (LayerNorm eps 1e-5; 8 heads of dim 64;
           the tokens read as they come); no final norm, no dropout; one
           refinement, pose = decpose(t) + init_pose, betas = decshape(t)
           + init_shape, cam = deccam(t) + init_cam

The decoder's attentions are plain torch: one query each. Departures from
4D-Humans: the 6D pose goes through this port's rot6d_to_rotmat (SPIN's
(3, 2) layout; 4D-Humans reads (2, 3), a fixed permutation of decpose's
outputs and of init_pose); the keypoints, losses and body are this port's.

forward(images, dropout=None) -> (rotmat (B, 24, 3, 3), betas (B, 10), cam
(B, 3)), float32, as models/hmr.HMR. In train() `dropout` is the drop-path
keep-masks, (2 depth, B) bool (draw_drop_path_masks; None draws them from
torch's default generator); eval() has no drop path. Nothing inside draws
random numbers when the masks are given. The backbone computes in `dtype`
(models/vit's rules); the head in float32. The forward opens the
record_function spans 'hmr.backbone' and 'hmr.head'.
"""

import functools

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from tuch_tpu_torch.models import vit as vit_mod
from tuch_tpu_torch.utils.rotations import rot6d_to_rotmat

NPOSE = 24 * 6

# name -> widths. hmr2_vith16 is the published model; hmr2_toy the CPU
# tests' size, with kernel 1's head dim 80 and the crop kept.
HMR2_CONFIGS = {
    'hmr2_vith16': dict(width=1280, depth=32, heads=16, patch=16,
                        mlp_ratio=4, drop_path=0.55, img_res=256,
                        dec_dim=1024, dec_depth=6, dec_heads=8,
                        dec_head_dim=64, dec_mlp=1024),
    'hmr2_toy': dict(width=160, depth=2, heads=2, patch=16, mlp_ratio=4,
                     drop_path=0.55, img_res=64, dec_dim=64, dec_depth=2,
                     dec_heads=2, dec_head_dim=32, dec_mlp=64),
}

DEC_LN_EPS = 1e-5


def crop_columns(img_res: int):
    """The columns the model reads of a square crop: W/8 cut each side."""
    c = img_res // 8
    return c, img_res - c


def draw_drop_path_masks(B: int, generator=None, device=None,
                         depth: int = 32, rate: float = 0.55):
    """The backbone's drop-path keep-masks for one forward, (2 depth, B)
    bool: row 2 i is block i's attention branch, 2 i + 1 its MLP, each kept
    with block i's probability (1 - linspace(0, rate, depth)[i]), from
    `generator` (a torch.Generator on `device`; None takes the default
    one)."""
    keep = _keep_probs(depth, rate, device)
    u = torch.rand(2 * depth, B, generator=generator, device=device)
    return u < keep[:, None]


@functools.lru_cache(maxsize=None)
def _keep_probs(depth: int, rate: float, device):
    """(2 depth,) each branch's keep probability on `device`, made once:
    the copy from the host waits for the device, which a draw every step
    must not. Made outside inference mode, as any later caller may need."""
    with torch.inference_mode(False):
        return torch.tensor(vit_mod.drop_path_keep_probs(depth, rate),
                            device=device).repeat_interleave(2)


class SelfAttention(nn.Module):
    """to_qkv (no bias), softmax(q k^T / sqrt(d)) v per head, to_out."""

    def __init__(self, dim: int, heads: int, head_dim: int):
        super().__init__()
        self.heads, self.scale = heads, head_dim ** -0.5
        self.to_qkv = nn.Linear(dim, 3 * heads * head_dim, bias=False)
        self.to_out = nn.Sequential(nn.Linear(heads * head_dim, dim))

    def forward(self, x):
        q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        return self.to_out(_attend(q, k, v, self.heads, self.scale))


class CrossAttention(nn.Module):
    """to_kv (no bias) on the context, to_q (no bias) on x, softmax
    attention per head, to_out."""

    def __init__(self, dim: int, context_dim: int, heads: int,
                 head_dim: int):
        super().__init__()
        self.heads, self.scale = heads, head_dim ** -0.5
        self.to_kv = nn.Linear(context_dim, 2 * heads * head_dim,
                               bias=False)
        self.to_q = nn.Linear(dim, heads * head_dim, bias=False)
        self.to_out = nn.Sequential(nn.Linear(heads * head_dim, dim))

    def forward(self, x, context):
        k, v = self.to_kv(context).chunk(2, dim=-1)
        return self.to_out(_attend(self.to_q(x), k, v, self.heads,
                                   self.scale))


def _attend(q, k, v, heads, scale):
    """(B, n, h d) queries over (B, m, h d) keys and values -> (B, n, h d)."""
    B, n, _ = q.shape

    def split(t):
        return t.reshape(B, t.shape[1], heads, -1).transpose(1, 2)

    q, k, v = split(q), split(k), split(v)
    attn = torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1)
    return (attn @ v).transpose(1, 2).reshape(B, n, -1)


class PreNorm(nn.Module):
    """fn(LayerNorm(x), ...)."""

    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=DEC_LN_EPS)
        self.fn = fn

    def forward(self, x, *args):
        return self.fn(self.norm(x), *args)


class FeedForward(nn.Module):
    """net.0, exact gelu, net.3 as 4D-Humans' FeedForward (its dropouts
    of 0 are left out: in train mode they would draw random numbers)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(dim, hidden), nn.GELU(),
                                 nn.Identity(), nn.Linear(hidden, dim))

    def forward(self, x):
        return self.net(x)


class CrossAttnLayers(nn.Module):
    """4D-Humans' TransformerCrossAttn: `depth` layers of [SA, CA, FF],
    each pre-normed and added to x."""

    def __init__(self, dim, depth, heads, head_dim, mlp, context_dim):
        super().__init__()
        self.layers = nn.ModuleList(nn.ModuleList([
            PreNorm(dim, SelfAttention(dim, heads, head_dim)),
            PreNorm(dim, CrossAttention(dim, context_dim, heads, head_dim)),
            PreNorm(dim, FeedForward(dim, mlp))]) for _ in range(depth))

    def forward(self, x, context):
        for sa, ca, ff in self.layers:
            x = sa(x) + x
            x = ca(x, context) + x
            x = ff(x) + x
        return x


class TransformerDecoder(nn.Module):
    """One token: to_token_embedding(input) + pos_embedding, then the
    cross-attention layers over the context."""

    def __init__(self, dim, depth, heads, head_dim, mlp, context_dim):
        super().__init__()
        self.to_token_embedding = nn.Linear(1, dim)
        self.pos_embedding = nn.Parameter(torch.zeros(1, 1, dim))
        self.transformer = CrossAttnLayers(dim, depth, heads, head_dim, mlp,
                                           context_dim)

    def forward(self, token, context):
        x = self.to_token_embedding(token) + self.pos_embedding
        return self.transformer(x, context)


class SMPLHead(nn.Module):
    """4D-Humans' SMPLTransformerDecoderHead with a zero input token and
    one refinement."""

    def __init__(self, cfg):
        super().__init__()
        dim = cfg['dec_dim']
        self.transformer = TransformerDecoder(
            dim, cfg['dec_depth'], cfg['dec_heads'], cfg['dec_head_dim'],
            cfg['dec_mlp'], cfg['width'])
        self.decpose = nn.Linear(dim, NPOSE)
        self.decshape = nn.Linear(dim, 10)
        self.deccam = nn.Linear(dim, 3)

    def forward(self, tokens, init_pose, init_shape, init_cam):
        B = tokens.shape[0]
        t = self.transformer(tokens.new_zeros(B, 1, 1), tokens)[:, 0]
        return (self.decpose(t) + init_pose.expand(B, -1),
                self.decshape(t) + init_shape.expand(B, -1),
                self.deccam(t) + init_cam.expand(B, -1))


class HMR2(nn.Module):
    """HMR 2.0 (see the module's docstring). img_res: the square crop it
    takes (the position embedding is learned for its grid); None is the
    configuration's (256)."""

    def __init__(self, mean_pose6d, mean_shape, mean_cam,
                 backbone: str = 'hmr2_vith16',
                 dtype: torch.dtype = torch.float32, img_res=None):
        super().__init__()
        if backbone not in HMR2_CONFIGS:
            raise ValueError(f'unknown HMR 2.0 config {backbone!r}; have '
                             f'{sorted(HMR2_CONFIGS)}')
        cfg = HMR2_CONFIGS[backbone]
        self.backbone_name, self.dtype = backbone, dtype
        self.img_res = img_res or cfg['img_res']
        self.depth, self.drop_path_rate = cfg['depth'], cfg['drop_path']
        lo, hi = crop_columns(self.img_res)
        grid = (vit_mod.PatchEmbed.grid(self.img_res, cfg['patch']),
                vit_mod.PatchEmbed.grid(hi - lo, cfg['patch']))
        self.backbone = vit_mod.ViTPose(
            cfg['width'], cfg['depth'], cfg['heads'], cfg['patch'], grid,
            cfg['mlp_ratio'], cfg['drop_path'], dtype=dtype)
        self.smpl_head = SMPLHead(cfg)
        for name, value in (('init_pose', mean_pose6d),
                            ('init_shape', mean_shape),
                            ('init_cam', mean_cam)):
            self.register_buffer(name, torch.as_tensor(
                np.asarray(value, np.float32).reshape(1, -1)),
                persistent=False)

    def draw_masks(self, B: int, generator=None, device=None):
        """draw_drop_path_masks at this model's depth and rate."""
        return draw_drop_path_masks(B, generator, device, self.depth,
                                    self.drop_path_rate)

    def mask_buffer(self, B: int, device):
        """A static buffer of one train-mode forward's masks for B images,
        all kept (models/hmr.HMRGraphs)."""
        return torch.ones(2 * self.depth, B, dtype=torch.bool,
                          device=device)

    @staticmethod
    def masks_in(buf):
        """The forward's `dropout` argument read from mask_buffer's
        buffer."""
        return buf

    @staticmethod
    def load_masks(buf, masks):
        """Copy masks into mask_buffer's buffer."""
        buf.copy_(masks)

    def forward(self, images, dropout=None):
        B, H, W, _ = images.shape
        if H != self.img_res or W != self.img_res:
            raise ValueError(f'{self.backbone_name} takes {self.img_res}x'
                             f'{self.img_res} crops, got {H}x{W}')
        keep = None
        if self.training:
            keep = (self.draw_masks(B, device=images.device)
                    if dropout is None else dropout)
        lo, hi = crop_columns(self.img_res)
        with record_function('hmr.backbone'):
            tokens = self.backbone(images[:, :, lo:hi], keep)
        with record_function('hmr.head'):
            pose, shape, cam = self.smpl_head(tokens, self.init_pose,
                                              self.init_shape, self.init_cam)
        return rot6d_to_rotmat(pose).reshape(B, 24, 3, 3), shape, cam
