"""tuch_tpu_torch's bfloat16 compute dtype against the JAX package's.

The Flax HMR runs in float32 and in bfloat16 on the same variables; the
port's HMR(dtype=bfloat16) runs those variables carried over with
from_jax_variables, on the same numpy images, on the CPU. bf16 rounds at
other places in the two frameworks (XLA rounds a Dense's product before its
bias, torch once after both), so the port is held to the JAX package's own
bf16 error: the port-vs-JAX difference in bf16 is at most twice the JAX
package's bf16-vs-fp32 gap on the same input, plus 1e-3.

Measured on this host at B=2, img_res 64 (max abs, rotmat / betas / cam):
  vit_t8:   JAX gap 8.9e-05 / 9.4e-05 / 7.5e-05; port vs JAX 5.3e-05 /
            3.9e-05 / 5.0e-05
  resnet50: JAX gap 7.8e-04 / 9.9e-04 / 2.9e-04; port vs JAX 5.6e-04 /
            4.2e-04 / 3.6e-04
The pooled features (before the IEF head's small output gain hides a
difference), mean abs over B=1: vit_t8 JAX gap 1.3e-03, port vs JAX
4.4e-04; resnet50 4.0e-03 and 2.7e-03.
"""

import base64
import copy
import io
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tuch_tpu import assets as jax_assets
from tuch_tpu.models import hmr as jax_hmr
from tuch_tpu.models import vit as jax_vit
from tuch_tpu_torch import runtime as prt
from tuch_tpu_torch.models import convert as pt_convert
from tuch_tpu_torch.models import hmr as pt_hmr

BACKBONES = ['vit_t8', 'resnet50']
# Card bf16 vertices against card fp32 vertices for the same image, the bar
# chip_smoke.py holds the serving path to (BF16_VERTEX_ATOL there). Measured
# here, port bf16 vs port fp32: 1.9e-04 (vit_t8, 64), 7.8e-04 (resnet50, 64),
# 5.1e-04 (vit_s16, 224), 6.8e-04 (resnet50, 224) on a body of ~1.7 m.
BF16_VERTEX_ATOL = 5e-3


@pytest.fixture(scope='module')
def carried():
    """backbone -> (Flax fp32 model, Flax bf16 model, variables, port bf16
    HMR with them)."""
    _, extras = jax_assets.synthetic_smpl(num_verts=170)
    means = (extras.mean_pose6d, extras.mean_shape, extras.mean_cam)
    out = {}
    for backbone in BACKBONES:
        m32 = jax_hmr.create_hmr(*means, backbone=backbone)
        m16 = jax_hmr.create_hmr(*means, backbone=backbone,
                                 dtype=jnp.bfloat16)
        variables = jax.tree_util.tree_map(
            np.asarray, jax_hmr.init_hmr(m32, jax.random.PRNGKey(0)))
        port = pt_hmr.create_hmr(*means, backbone=backbone,
                                 dtype=torch.bfloat16).eval()
        prt.load_hmr_weights(port, pt_convert.from_jax_variables(variables))
        out[backbone] = (m32, m16, variables, port)
    return out


@pytest.mark.parametrize('backbone', BACKBONES)
def test_bf16_hmr_matches_flax_bf16(carried, backbone):
    m32, m16, variables, port = carried[backbone]
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    want32 = m32.apply(variables, jnp.asarray(x), train=False)
    want16 = m16.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for name, g, w16, w32 in zip(('rotmat', 'betas', 'cam'), got, want16,
                                 want32):
        w16 = np.asarray(w16, np.float32)
        gap = np.abs(w16 - np.asarray(w32, np.float32)).max()
        assert g.dtype == torch.float32, name
        err = np.abs(g.numpy() - w16).max()
        assert err <= 2 * gap + 1e-3, (name, err, gap)


@pytest.mark.parametrize('backbone', BACKBONES)
def test_bf16_backbone_features_match_flax_bf16(carried, backbone):
    """Mean abs over the pooled features: each value is rounded to bf16 at
    the pool, so the max moves by whole bf16 steps (0.03 near 5)."""
    _, _, variables, port = carried[backbone]
    x = np.random.RandomState(1).randn(1, 64, 64, 3).astype(np.float32)
    if backbone == 'resnet50':
        bb_vars = {'params': variables['params']['backbone'],
                   'batch_stats': variables['batch_stats']['backbone']}
        feats = {dt: jax_hmr.ResNet50(dtype=dt, name='backbone').apply(
            bb_vars, jnp.asarray(x).astype(dt), train=False)
            for dt in (jnp.float32, jnp.bfloat16)}
    else:
        bb_vars = {'params': variables['params']['backbone']}
        feats = {dt: jax_vit.create_vit(backbone, dtype=dt).apply(
            bb_vars, jnp.asarray(x).astype(dt))
            for dt in (jnp.float32, jnp.bfloat16)}
    f32, f16 = (np.asarray(feats[dt], np.float32)
                for dt in (jnp.float32, jnp.bfloat16))
    with torch.no_grad():
        got = port.features(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == f16.shape
    gap = np.abs(f16 - f32).mean()
    assert np.abs(got.numpy() - f16).mean() <= 2 * gap, gap


def test_bf16_residual_stream_and_layers_run_in_bf16(carried):
    """The compute dtype where the JAX package puts it: the ViT's residual
    stream and Linears in bf16, its LayerNorms in fp32; the ResNet's convs
    and BatchNorms in bf16; the weights stay fp32."""
    seen = {}

    def hook(name):
        def fn(mod, args, out):
            seen[name] = (args[0].dtype, out.dtype)
        return fn

    vit = carried['vit_t8'][3]
    res = carried['resnet50'][3]
    handles = [vit.backbone.blocks[0].register_forward_hook(hook('block')),
               vit.backbone.blocks[0].ln1.register_forward_hook(hook('ln')),
               vit.backbone.blocks[0].fc1.register_forward_hook(hook('fc1')),
               res.layer1[0].bn1.register_forward_hook(hook('bn')),
               res.layer1[0].conv2.register_forward_hook(hook('conv')),
               vit.fc1.register_forward_hook(hook('head'))]
    x = torch.zeros(1, 64, 64, 3)
    with torch.no_grad():
        vit(x)
        res(x)
    for h in handles:
        h.remove()
    bf, fp = torch.bfloat16, torch.float32
    assert seen == {'block': (bf, bf), 'ln': (fp, fp), 'fc1': (bf, bf),
                    'bn': (bf, bf), 'conv': (bf, bf), 'head': (fp, fp)}
    assert all(p.dtype == fp for p in vit.parameters())
    assert all(p.dtype == fp for p in res.state_dict().values()
               if p.is_floating_point())


@pytest.mark.parametrize('backbone', BACKBONES)
def test_stored_bf16_weights_give_the_same_bits(carried, backbone):
    """store_compute_weights (the serving copy: weights cast once) against
    casting per call; the head and the norms stay float32."""
    port = carried[backbone][3]
    stored = pt_hmr.store_compute_weights(copy.deepcopy(port))
    x = torch.from_numpy(
        np.random.RandomState(3).randn(2, 64, 64, 3).astype(np.float32))
    with torch.no_grad():
        for a, b in zip(stored(x), port(x)):
            assert torch.equal(a, b)
    dtypes = {n: p.dtype for n, p in stored.named_parameters()}
    assert dtypes['fc1.weight'] == torch.float32
    if backbone == 'resnet50':
        assert dtypes['layer1.0.conv1.weight'] == torch.bfloat16
        assert dtypes['layer1.0.bn1.weight'] == torch.float32
    else:
        assert dtypes['backbone.blocks.0.fc1.weight'] == torch.bfloat16
        assert dtypes['backbone.blocks.0.fc1.bias'] == torch.bfloat16
        assert dtypes['backbone.blocks.0.ln1.weight'] == torch.float32


def _png_b64(seed, res=64):
    img = (np.random.RandomState(seed).rand(res, res, 3) * 255).astype(
        np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format='PNG')
    return base64.b64encode(buf.getvalue()).decode()


@pytest.mark.parametrize('backbone', BACKBONES)
def test_bf16_predictor_serves_on_cpu(backbone):
    """TuchPredictor(dtype='bfloat16') builds, warms up and answers with
    finite fp32 outputs; its vertices stay within BF16_VERTEX_ATOL of the
    fp32 predictor's on the same crop (as tests/test_cli_demos.py's
    test_serve_predictor_bf16 for the JAX package)."""
    from tuch_tpu_torch.cli.serve import TuchPredictor
    kw = dict(synthetic=True, img_res=64, num_verts=170, backbone=backbone,
              device='cpu')
    p16 = TuchPredictor(dtype='bfloat16', **kw)
    p16.warmup()
    assert p16.warm and p16.hmr.dtype == torch.bfloat16
    out = p16.predict({'image_b64': _png_b64(2), 'return_vertices': True})
    assert len(out['pose']) == 72 and len(out['betas']) == 10
    for key in ('pose', 'betas', 'camera', 'cam_t', 'vertices'):
        assert np.isfinite(np.asarray(out[key])).all(), key
    norm = np.random.RandomState(7).randn(2, 64, 64, 3).astype(np.float32)
    got = p16._run_forward(norm)
    want = TuchPredictor(dtype='float32', **kw)._run_forward(norm)
    assert all(g.dtype == np.float32 for g in got)
    assert np.abs(got[4] - want[4]).max() <= BF16_VERTEX_ATOL


def test_serve_dtype_option_reaches_the_model():
    from tuch_tpu_torch.cli.serve import build_server
    httpd = build_server(SimpleNamespace(
        checkpoint=None, synthetic=True, img_res=64, synthetic_num_verts=170,
        max_batch=1, backbone='vit_t8', device='cpu', dtype='bfloat16',
        host='127.0.0.1', port=0))
    try:
        vit = httpd.predictor.hmr.backbone
        assert vit.dtype == torch.bfloat16 and httpd.predictor.warm
    finally:
        httpd.predictor.close()
        httpd.server_close()
    with pytest.raises(ValueError, match='compute dtype'):
        prt.build_runtime(device='cpu', synthetic=True, num_verts=170,
                          dtype='float16')
