"""tuch_tpu_torch HMR and ViT against the Flax models of tuch_tpu.

The Flax HMR is initialised with init_hmr, its variables are carried into
the port with from_jax_variables, and both run the same numpy images on the
CPU. Tolerances are the existing torch-parity bar (atol 2e-4, rtol 1e-3;
5e-4 on rotation matrices).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from tuch_tpu import assets as jax_assets
from tuch_tpu.models import convert as jax_convert
from tuch_tpu.models import hmr as jax_hmr
from tuch_tpu.models import vit as jax_vit
from tuch_tpu_torch.models import convert as pt_convert
from tuch_tpu_torch.models import hmr as pt_hmr
from tuch_tpu_torch.models import vit as pt_vit
from tuch_tpu_torch.runtime import load_hmr_weights

BACKBONES = ['resnet50', 'vit_t8']


@pytest.fixture(scope='module')
def carried():
    """backbone -> (Flax model, variables as numpy, port HMR with them)."""
    _, extras = jax_assets.synthetic_smpl(num_verts=170)
    means = (extras.mean_pose6d, extras.mean_shape, extras.mean_cam)
    out = {}
    for backbone in BACKBONES:
        model = jax_hmr.create_hmr(*means, backbone=backbone)
        variables = jax.tree_util.tree_map(
            np.asarray, jax_hmr.init_hmr(model, jax.random.PRNGKey(0)))
        port = pt_hmr.create_hmr(*means, backbone=backbone).eval()
        load_hmr_weights(port, pt_convert.from_jax_variables(variables))
        out[backbone] = (model, variables, port)
    return out


@pytest.mark.parametrize('backbone', BACKBONES)
def test_hmr_matches_flax(carried, backbone):
    model, variables, port = carried[backbone]
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    rot_j, betas_j, cam_j = model.apply(variables, jnp.asarray(x),
                                        train=False)
    with torch.no_grad():
        rot_t, betas_t, cam_t = port(torch.from_numpy(x))
    assert rot_t.shape == (2, 24, 3, 3)
    np.testing.assert_allclose(betas_t.numpy(), np.asarray(betas_j),
                               atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(cam_t.numpy(), np.asarray(cam_j),
                               atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(rot_t.numpy(), np.asarray(rot_j), atol=5e-4)


@pytest.mark.parametrize('backbone', BACKBONES)
def test_backbone_features_match_flax(carried, backbone):
    # the pooled features, before the IEF head can shrink a difference
    model, variables, port = carried[backbone]
    x = np.random.RandomState(1).randn(1, 64, 64, 3).astype(np.float32)
    if backbone == 'resnet50':
        flax_bb = jax_hmr.ResNet50(name='backbone')
        bb_vars = {'params': variables['params']['backbone'],
                   'batch_stats': variables['batch_stats']['backbone']}
    else:
        flax_bb = jax_vit.create_vit(backbone)
        bb_vars = {'params': variables['params']['backbone']}
    want = np.asarray(flax_bb.apply(bb_vars, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = port.features(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_resnet_keys_are_the_reference_keys(carried):
    # the keys the JAX package exports for the reference's torch loader
    _, variables, port = carried['resnet50']
    ref_keys = set(jax_convert.convert_to_torch_state_dict(variables))
    assert set(port.state_dict()) == ref_keys


def test_vit_posemb_matches_flax():
    np.testing.assert_array_equal(
        pt_vit.sincos_posemb_2d(14, 14, 384),
        np.asarray(jax_vit.sincos_posemb_2d(14, 14, 384)))


@pytest.mark.parametrize('backbone', BACKBONES)
def test_load_checkpoint_npz_and_pt(carried, backbone, tmp_path):
    _, variables, port = carried[backbone]
    flat = traverse_util.flatten_dict(variables)
    npz = str(tmp_path / 'hmr.npz')
    np.savez(npz, **{'/'.join(k): v for k, v in flat.items()})
    from_npz = pt_convert.load_checkpoint(npz)
    want = port.state_dict()
    for k, v in from_npz.items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)
    # a reference-style {'model': state_dict} .pt round trip
    pt = str(tmp_path / 'hmr.pt')
    torch.save({'model': want, 'epoch': 3}, pt)
    from_pt = pt_convert.load_checkpoint(pt)
    assert set(from_pt) == set(want)
    fresh = pt_hmr.init_weights(pt_hmr.create_hmr(
        port.init_pose, port.init_shape, port.init_cam, backbone=backbone),
        seed=1)
    load_hmr_weights(fresh, from_pt)
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)


def test_init_weights_is_seeded():
    means = (np.zeros(144, np.float32), np.zeros(10, np.float32),
             np.zeros(3, np.float32))
    a = pt_hmr.init_weights(pt_hmr.create_hmr(*means, backbone='vit_t8'), 7)
    b = pt_hmr.init_weights(pt_hmr.create_hmr(*means, backbone='vit_t8'), 7)
    c = pt_hmr.init_weights(pt_hmr.create_hmr(*means, backbone='vit_t8'), 8)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa['fc1.weight'], sc['fc1.weight'])
