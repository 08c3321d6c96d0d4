"""The plain reference of HMR 2.0, float32 torch only.

HMR 2.0 from "Humans in 4D" (Goel et al., ICCV 2023, arXiv:2305.20091),
github.com/shubham-goel/4D-Humans, written out from its equations
(hmr2/models/backbones/vit.py, hmr2/models/heads/smpl_head.py,
hmr2/models/components/pose_transformer.py, the widths of
hmr2/configs_hydra/experiment/hmr_vit_transformer.yaml) with plain softmax
attention everywhere and no kernel. It imports nothing but torch and numpy,
so that it stands apart from the program it checks (models/hmr2.py); its
parameter names and shapes are the program's, so one state dict fits both.
Its copy for the benchmark is portbench/reference/hmr2_ref.py, the same
file.

  crop      columns W/8 : W - W/8 of the square NHWC crop (256 -> 256x192)
  backbone  ViTPose-H/16: Conv2d(3, 1280, 16, stride 16, padding 2) -> 16x12
            = 192 tokens; + pos[:, 1:] + pos[:, :1] (pos (1, 193, 1280),
            the cls slot added to every token); 32 blocks of x + dp(attn(
            LN(x))), x + dp(mlp(LN(x))), LayerNorm eps 1e-6, qkv 1280 ->
            3840 with bias, head-major, 16 heads of dim 80, scale 80^-0.5,
            proj 1280 -> 1280, mlp 1280 -> 5120 -> 1280 with exact gelu;
            drop path at linspace(0, 0.55, 32)[i] on block i, one mask a
            branch, kept branches scaled by 1 / (1 - p); last LayerNorm
  head      token = Linear(1, 1024)(zeros (B, 1, 1)) + pos (1, 1, 1024);
            6 layers of x = SA(LN(x)) + x, x = CA(LN(x), tokens) + x,
            x = FF(LN(x)) + x, LayerNorm eps 1e-5; SA to_qkv 1024 -> 1536
            without bias, 8 heads of dim 64, to_out 512 -> 1024; CA to_q
            1024 -> 512 and to_kv 1280 -> 1024 without bias on the tokens
            as they come, to_out 512 -> 1024; FF 1024 -> 1024, gelu,
            1024 -> 1024; no final norm, dropout 0
  output    one refinement: pose = decpose(t) + init_pose (1024 -> 144),
            betas = decshape(t) + init_shape, cam = deccam(t) + init_cam

Departures from 4D-Humans, as in the program: the 6D pose is read in SPIN's
(3, 2) layout (4D-Humans reads (2, 3): a fixed permutation of decpose's
outputs and init_pose); the keypoints, losses and body around it are
TUCH's. forward(images, dropout) -> (rotmat (B, 24, 3, 3), betas, cam); in
train mode `dropout` is the drop-path keep-masks (2 depth, B) bool, row
2 i block i's attention branch and 2 i + 1 its MLP, and must be given.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

CONFIGS = {
    'hmr2_vith16': dict(width=1280, depth=32, heads=16, patch=16,
                        mlp_ratio=4, drop_path=0.55, img_res=256,
                        dec_dim=1024, dec_depth=6, dec_heads=8,
                        dec_head_dim=64, dec_mlp=1024),
    'hmr2_toy': dict(width=160, depth=2, heads=2, patch=16, mlp_ratio=4,
                     drop_path=0.55, img_res=64, dec_dim=64, dec_depth=2,
                     dec_heads=2, dec_head_dim=32, dec_mlp=64),
}
PADDING = 2


def rot6d_to_rotmat(x):
    """SPIN's 6D -> rotation matrix: (-1, 3, 2) columns by Gram-Schmidt."""
    x = x.reshape(-1, 3, 2)
    a1, a2 = x[:, :, 0], x[:, :, 1]
    b1 = a1 / torch.clamp(torch.linalg.norm(a1, dim=-1, keepdim=True),
                          min=1e-8)
    b2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = b2 / torch.clamp(torch.linalg.norm(b2, dim=-1, keepdim=True),
                          min=1e-8)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], dim=-1)


def softmax_attention(q, k, v, heads):
    """(B, n, h d), (B, m, h d), (B, m, h d) -> (B, n, h d)."""
    B, n, _ = q.shape
    q, k, v = (t.reshape(B, t.shape[1], heads, -1).transpose(1, 2)
               for t in (q, k, v))
    attn = (q @ k.transpose(-2, -1)) * q.shape[-1] ** -0.5
    return (attn.softmax(dim=-1) @ v).transpose(1, 2).reshape(B, n, -1)


class Attention(nn.Module):
    def __init__(self, width, heads):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)

    def forward(self, x):
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        return self.proj(softmax_attention(q, k, v, self.heads))


class PatchEmbed(nn.Module):
    def __init__(self, width, patch):
        super().__init__()
        self.proj = nn.Conv2d(3, width, patch, stride=patch, padding=PADDING)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)


class Mlp(nn.Module):
    def __init__(self, width, hidden):
        super().__init__()
        self.fc1 = nn.Linear(width, hidden)
        self.fc2 = nn.Linear(hidden, width)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, width, heads, mlp_ratio, rate):
        super().__init__()
        self.rate = rate
        self.norm1 = nn.LayerNorm(width, eps=1e-6)
        self.attn = Attention(width, heads)
        self.norm2 = nn.LayerNorm(width, eps=1e-6)
        self.mlp = Mlp(width, mlp_ratio * width)

    def drop_path(self, y, keep):
        if keep is None or self.rate == 0.0:
            return y
        p = 1.0 - self.rate
        return y.div(p) * keep.float()[:, None, None]

    def forward(self, x, keep_attn, keep_mlp):
        x = x + self.drop_path(self.attn(self.norm1(x)), keep_attn)
        return x + self.drop_path(self.mlp(self.norm2(x)), keep_mlp)


class ViTPose(nn.Module):
    def __init__(self, cfg, grid):
        super().__init__()
        width, depth = cfg['width'], cfg['depth']
        self.patch_embed = PatchEmbed(width, cfg['patch'])
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + grid[0] * grid[1],
                                                  width))
        rates = torch.linspace(0, cfg['drop_path'], depth,
                               device='cpu').tolist()
        self.blocks = nn.ModuleList(
            Block(width, cfg['heads'], cfg['mlp_ratio'], r) for r in rates)
        self.last_norm = nn.LayerNorm(width, eps=1e-6)

    def forward(self, x, keep):
        x = self.patch_embed(x)
        x = x + self.pos_embed[:, 1:] + self.pos_embed[:, :1]
        for i, block in enumerate(self.blocks):
            x = block(x, *((None, None) if keep is None
                           else (keep[2 * i], keep[2 * i + 1])))
        return self.last_norm(x)


class SelfAttention(nn.Module):
    def __init__(self, dim, heads, head_dim):
        super().__init__()
        self.heads = heads
        self.to_qkv = nn.Linear(dim, 3 * heads * head_dim, bias=False)
        self.to_out = nn.Sequential(nn.Linear(heads * head_dim, dim))

    def forward(self, x):
        q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        return self.to_out(softmax_attention(q, k, v, self.heads))


class CrossAttention(nn.Module):
    def __init__(self, dim, context_dim, heads, head_dim):
        super().__init__()
        self.heads = heads
        self.to_kv = nn.Linear(context_dim, 2 * heads * head_dim,
                               bias=False)
        self.to_q = nn.Linear(dim, heads * head_dim, bias=False)
        self.to_out = nn.Sequential(nn.Linear(heads * head_dim, dim))

    def forward(self, x, context):
        k, v = self.to_kv(context).chunk(2, dim=-1)
        return self.to_out(softmax_attention(self.to_q(x), k, v, self.heads))


class FeedForward(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(dim, hidden), nn.GELU(),
                                 nn.Identity(), nn.Linear(hidden, dim))

    def forward(self, x):
        return self.net(x)


class PreNorm(nn.Module):
    def __init__(self, dim, fn):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.fn = fn

    def forward(self, x, *args):
        return self.fn(self.norm(x), *args)


class CrossAttnLayers(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d, h, hd = cfg['dec_dim'], cfg['dec_heads'], cfg['dec_head_dim']
        self.layers = nn.ModuleList(nn.ModuleList([
            PreNorm(d, SelfAttention(d, h, hd)),
            PreNorm(d, CrossAttention(d, cfg['width'], h, hd)),
            PreNorm(d, FeedForward(d, cfg['dec_mlp']))])
            for _ in range(cfg['dec_depth']))

    def forward(self, x, context):
        for sa, ca, ff in self.layers:
            x = sa(x) + x
            x = ca(x, context) + x
            x = ff(x) + x
        return x


class TransformerDecoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.to_token_embedding = nn.Linear(1, cfg['dec_dim'])
        self.pos_embedding = nn.Parameter(torch.zeros(1, 1, cfg['dec_dim']))
        self.transformer = CrossAttnLayers(cfg)

    def forward(self, token, context):
        x = self.to_token_embedding(token) + self.pos_embedding
        return self.transformer(x, context)


class SMPLHead(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.transformer = TransformerDecoder(cfg)
        self.decpose = nn.Linear(cfg['dec_dim'], 24 * 6)
        self.decshape = nn.Linear(cfg['dec_dim'], 10)
        self.deccam = nn.Linear(cfg['dec_dim'], 3)


class HMR2(nn.Module):
    """The reference model for a name of CONFIGS, for img_res crops (None:
    the configuration's)."""

    def __init__(self, mean_pose6d, mean_shape, mean_cam, name='hmr2_vith16',
                 img_res=None):
        super().__init__()
        cfg = CONFIGS[name]
        self.img_res = img_res or cfg['img_res']
        c = self.img_res // 8
        self.crop = (c, self.img_res - c)
        grid = tuple((n + 2 * PADDING - cfg['patch']) // cfg['patch'] + 1
                     for n in (self.img_res, self.img_res - 2 * c))
        self.backbone = ViTPose(cfg, grid)
        self.smpl_head = SMPLHead(cfg)
        for key, value in (('init_pose', mean_pose6d),
                           ('init_shape', mean_shape),
                           ('init_cam', mean_cam)):
            self.register_buffer(key, torch.as_tensor(
                np.asarray(value, np.float32).reshape(1, -1)),
                persistent=False)

    def forward(self, images, dropout=None):
        if self.training and dropout is None:
            raise ValueError('the reference draws no drop-path masks: pass '
                             'them in train mode')
        keep = dropout if self.training else None
        B = images.shape[0]
        x = images[:, :, self.crop[0]:self.crop[1]].permute(0, 3, 1, 2)
        tokens = self.backbone(x.float(), keep)
        head = self.smpl_head
        t = head.transformer(tokens.new_zeros(B, 1, 1), tokens)[:, 0]
        pose = head.decpose(t) + self.init_pose
        betas = head.decshape(t) + self.init_shape
        cam = head.deccam(t) + self.init_cam
        return rot6d_to_rotmat(pose).reshape(B, 24, 3, 3), betas, cam
