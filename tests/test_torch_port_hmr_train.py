"""tuch_tpu_torch's HMR in train() against the Flax HMR with train=True.

BatchNorm on batch statistics with Flax's update of the running ones (the
biased variance, momentum 0.9) at n = 8 and n = 2 values per channel; the
IEF head's dropout on the JAX step's own masks; ResNet-50 in train mode
in float64 on both sides (forward, running statistics, every parameter's
gradient), where float32 cannot be compared element by element (see
tests/test_torch_port_train_step.py); and the port's own mask draw.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from flax import linen as nn

from tuch_tpu import assets as jax_assets
from tuch_tpu.models import hmr as jax_hmr
from tuch_tpu_torch.models import convert as PC
from tuch_tpu_torch.models import hmr as pt_hmr
from tuch_tpu_torch.runtime import load_hmr_weights

MEANS = None


def _means():
    global MEANS
    if MEANS is None:
        _, ex = jax_assets.synthetic_smpl(num_verts=170)
        MEANS = (ex.mean_pose6d, ex.mean_shape, ex.mean_cam)
    return MEANS


def _apply_train(model, variables, img, rng):
    """The Flax HMR with train=True: (outputs, batch_stats, drop1 outputs,
    drop2 outputs), three calls each (jit-able)."""
    outs, state = model.apply(
        variables, img, train=True, rngs={'dropout': rng},
        mutable=['batch_stats', 'intermediates'],
        capture_intermediates=lambda m, _: isinstance(m, nn.Dropout))
    inter = state['intermediates']
    return (outs, state.get('batch_stats', {}),
            inter['Dropout_0']['__call__'], inter['Dropout_1']['__call__'])


def _keep_masks(d1, d2):
    """The dropout outputs' non-zeros in draw_dropout_masks' layout."""
    return [(torch.from_numpy(np.array(a) != 0),
             torch.from_numpy(np.array(b) != 0)) for a, b in zip(d1, d2)]


@pytest.mark.parametrize('hw', [2, 1], ids=['n8', 'n2'])
def test_batchnorm_update_is_flax_at_few_values(hw):
    """(2, hw, hw, C): n = 8 and n = 2 values per channel. The running
    variance takes the biased batch variance (nn.BatchNorm2d's own update
    takes the unbiased one, n / (n - 1) larger), momentum 0.9; output and
    input gradient as Flax's. Running statistics at rtol 1e-5; output and
    gradient at 1e-5 of their scale."""
    C = 16
    rng = np.random.RandomState(hw)
    x = (rng.randn(2, hw, hw, C) * 2 + 0.5).astype(np.float32)
    g = rng.randn(2, hw, hw, C).astype(np.float32)
    stats0 = {'mean': rng.randn(C).astype(np.float32) * 0.1,
              'var': rng.uniform(0.5, 2.0, C).astype(np.float32)}
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    params = {'scale': rng.uniform(0.5, 1.5, C).astype(np.float32),
              'bias': rng.randn(C).astype(np.float32) * 0.1}

    def f(x):
        y, st = bn.apply({'params': params, 'batch_stats': stats0}, x,
                         mutable=['batch_stats'])
        return (y * g).sum(), (y, st['batch_stats'])

    (_, (y_j, st_j)), gx_j = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(x))

    port = pt_hmr.BatchNorm2d(C).train()
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(params['scale']))
        port.bias.copy_(torch.from_numpy(params['bias']))
        port.running_mean.copy_(torch.from_numpy(stats0['mean']))
        port.running_var.copy_(torch.from_numpy(stats0['var']))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = port(xt)
    (y * torch.from_numpy(g).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(st_j['mean']), rtol=1e-5)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(st_j['var']), rtol=1e-5)
    # the input gradient cancels to ~eps / var at n = 2: it is held on
    # the scale of its terms, max |g scale| / min std
    std = x.reshape(-1, C).std(0).min()
    g_scale = np.abs(g).max() * params['scale'].max() / std
    for got, want, scale in ((y.detach().permute(0, 2, 3, 1), y_j, None),
                             (xt.grad.permute(0, 2, 3, 1), gx_j, g_scale)):
        want = np.asarray(want)
        scale = np.abs(want).max() if scale is None else scale
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * scale)
    # the trap: torch's own update is off by the unbiased factor
    ref = torch.nn.BatchNorm2d(C, eps=1e-5, momentum=0.1).train()
    ref.running_var.copy_(torch.from_numpy(stats0['var']))
    ref(xt.detach())
    gap = np.abs(ref.running_var.numpy() - np.asarray(st_j['var'])).max()
    assert gap > 1e-3


def test_resnet50_train_mode_equals_flax_in_float64():
    """Forward, running statistics and every parameter's gradient of a
    scalar loss of the outputs, both sides in float64 on the same weights
    and dropout masks: held at 1e-6 of each tensor's largest entry (the
    comparison reads the JAX side through float32, ~6e-8)."""
    rng = np.random.RandomState(4)
    img = rng.randn(2, 64, 64, 3) * 0.1
    w = [rng.randn(2, 24, 3, 3), rng.randn(2, 10), rng.randn(2, 3)]
    with jax.enable_x64(True):
        model = jax_hmr.create_hmr(*_means(), dtype=jnp.float64)
        variables = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64),
            jax_hmr.init_hmr(model, jax.random.PRNGKey(0)))
        drop = jax.random.PRNGKey(3)
        outs, stats, d1, d2 = jax.jit(
            lambda v: _apply_train(model, v, jnp.asarray(img), drop))(
            variables)
        masks = _keep_masks(d1, d2)

        def loss(params):
            o, _ = model.apply({**variables, 'params': params},
                               jnp.asarray(img), train=True,
                               rngs={'dropout': drop},
                               mutable=['batch_stats'])
            return sum((a * jnp.asarray(b)).sum() for a, b in zip(o, w))

        grads = jax.jit(jax.grad(loss))(variables['params'])
        outs, stats, grads = jax.tree_util.tree_map(
            np.asarray, (outs, stats, grads))

    port = pt_hmr.create_hmr(*_means(), dtype=torch.float64)
    load_hmr_weights(port, PC.from_jax_variables(variables))
    port = port.double().train()
    got = port(torch.from_numpy(img), dropout=masks)
    sum((a * torch.from_numpy(b)).sum() for a, b in zip(got, w)).backward()

    def close(a, b, what):
        b = np.asarray(b, np.float64)
        np.testing.assert_allclose(np.asarray(a, np.float64), b, rtol=0,
                                   atol=1e-6 * np.abs(b).max(), err_msg=what)

    for a, b in zip(got, outs):
        close(a.detach().numpy(), b, 'outputs')
    bufs = dict(port.named_buffers())
    want_stats = PC.batch_stats_from_jax(stats)
    assert len(want_stats) == 2 * 53
    for k, v in want_stats.items():
        close(bufs[k].numpy(), v.numpy(), k)
    want = PC.params_from_jax(grads)
    assert set(want) == {k for k, _ in port.named_parameters()}
    for k, p in port.named_parameters():
        close(p.grad.numpy(), want[k].numpy(), k)


@pytest.fixture(scope='module')
def vit_t8():
    model = jax_hmr.create_hmr(*_means(), backbone='vit_t8')
    variables = jax.tree_util.tree_map(
        np.asarray, jax_hmr.init_hmr(model, jax.random.PRNGKey(0)))
    port = pt_hmr.create_hmr(*_means(), backbone='vit_t8')
    load_hmr_weights(port, PC.from_jax_variables(variables))
    return model, variables, port


def test_dropout_on_the_jax_masks_matches_flax(vit_t8):
    """The Flax HMR with train=True and a dropout key against the port's
    train() forward on the masks read from it: rotations, betas and camera
    at the torch-parity bar (atol 2e-4, rtol 1e-3); other masks move the
    outputs (the dropout is live), and eval() takes no dropout."""
    model, variables, port = vit_t8
    img = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    outs, _, d1, d2 = _apply_train(model, variables, jnp.asarray(img),
                                   jax.random.PRNGKey(7))
    masks = _keep_masks(d1, d2)
    assert len(masks) == pt_hmr.N_ITER
    for keep in (m for pair in masks for m in pair):
        assert keep.shape == (2, pt_hmr.HEAD_WIDTH)
        assert 0.4 < keep.float().mean().item() < 0.6
    x = torch.from_numpy(img)
    with torch.no_grad():
        got = port.train()(x, dropout=masks)
        other = port(x, dropout=pt_hmr.draw_dropout_masks(
            2, torch.Generator().manual_seed(0)))
        served = port.eval()(x)
        served_masked = port(x, dropout=masks)
    for a, b in zip(got, outs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3,
                                   atol=2e-4)
    assert (other[0] - got[0]).abs().max() > 1e-3
    for a, b in zip(served, served_masked):
        assert torch.equal(a, b)
    eval_j = model.apply(variables, jnp.asarray(img), train=False)
    np.testing.assert_allclose(served[0].numpy(), np.asarray(eval_j[0]),
                               rtol=1e-3, atol=2e-4)


def test_draw_dropout_masks_follow_the_generator():
    a = pt_hmr.draw_dropout_masks(4, torch.Generator().manual_seed(11))
    b = pt_hmr.draw_dropout_masks(4, torch.Generator().manual_seed(11))
    c = pt_hmr.draw_dropout_masks(4, torch.Generator().manual_seed(12))
    flat = [m for pair in a for m in pair]
    assert len(flat) == 2 * pt_hmr.N_ITER
    assert all(torch.equal(x, y) for x, y in
               zip(flat, [m for pair in b for m in pair]))
    assert not torch.equal(flat[0], c[0][0])
    # each draw is fresh: the six masks differ from one another
    assert len({m.numpy().tobytes() for m in flat}) == len(flat)
