"""Operation and byte counts of HMR 2.0's EFT step and of kernel 1, from the
configuration's published shapes (configs/hmr2_vith16.json). Nothing here
imports the program."""

from portbench import common

# H100 SXM (data sheet, 700 W): HBM3 bytes a second
PEAK_BYTES = 3.35e12


def grid(config):
    """(rows, columns) of ViTPose's token grid: the padded patch
    convolution over the crop."""
    p, pad = config['patch_size'], config['patch_padding']
    lo, hi = config['crop_columns']
    return tuple((n + 2 * pad - p) // p + 1
                 for n in (config['img_res'], hi - lo))


def tokens(config):
    gh, gw = grid(config)
    return gh * gw


def backbone_fwd_flops(config):
    """One image through ViTPose: the patch convolution, then per block the
    qkv, proj, fc1 and fc2 products (2 N C (3C + C + 2 I)) and attention's
    two products (4 N^2 C); LayerNorms, gelu and softmax are vector work
    and left out."""
    N, C = tokens(config), config['hidden_size']
    inner = config['intermediate_size']
    conv = 2 * 3 * config['patch_size'] ** 2 * C * N
    block = 2 * N * C * (4 * C + 2 * inner) + 4 * N * N * C
    return conv, config['num_hidden_layers'] * block


def head_fwd_flops(config):
    """One image through the decoder (one query over N tokens) and the three
    decoders: per layer to_qkv, to_out (twice), to_q, FF's two Linears,
    to_kv over the N tokens and the cross-attention's two products."""
    d = config['decoder']
    N, D, I = tokens(config), d['dim'], d['heads'] * d['dim_head']
    layer = 2 * (D * 3 * I + 2 * I * D + D * I + 2 * D * d['mlp_dim']
                 + N * d['context_dim'] * 2 * I + 2 * N * I + 2 * I)
    return d['depth'] * layer + 2 * D * (config['npose'] + 13)


def step_flops(config):
    """The operations one EFT step needs at B=1: forward and backward
    (twice the forward) of every product, the patch convolution's backward
    without the image's gradient (once the forward)."""
    conv, blocks = backbone_fwd_flops(config)
    return 2 * conv + 3 * blocks + 3 * head_fwd_flops(config)


def mha_bound_s(B, N, H, hd, itemsize=4):
    """Kernel 1's least time a launch: the larger of its bytes (qkv read
    once, the output written once) over the HBM peak and its operations
    (4 B H N^2 hd; three TF32 products each in float32) over the TF32
    peak."""
    nbytes = 4 * H * hd * N * B * itemsize
    flops = 4 * B * H * N * N * hd * (3 if itemsize == 4 else 1)
    peak = common.PEAK_FLOPS['tf32' if itemsize == 4 else 'bfloat16']
    return max(nbytes / PEAK_BYTES, flops / peak)
