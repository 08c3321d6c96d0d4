"""The gradient of tuch_tpu_torch's attention against the JAX package's.

The JAX package's fused_mha is a custom_vjp whose backward recomputes
through mha_reference (tuch_tpu/ops/attention_pallas.py); the port's is a
torch.autograd.Function that does the same on the saved qkv, whichever
forward ran (kernel 1 on the card, the plain version here). Both take the
same numpy qkv and cotangent on the CPU.

Tolerances: float32 atol 1e-6 + rtol 1e-5 (the two frameworks sum the
einsums in other orders). bfloat16 rounds at other places in the two
frameworks, so the port is held to twice the JAX package's own bf16-vs-fp32
gap on the same input, plus 1e-3 of the largest gradient, as
tests/test_torch_port_bf16.py holds the forward. The HMR parameter
gradients (vit_t8, weights carried by from_jax_variables) at atol 1e-5 of
each tensor's largest entry + rtol 1e-3, the forward's torch-parity bar
scaled to the gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tuch_tpu import assets as jax_assets
from tuch_tpu.models import hmr as jax_hmr
from tuch_tpu.ops import attention_pallas as jax_attn
from tuch_tpu_torch.models import convert as pt_convert
from tuch_tpu_torch.models import hmr as pt_hmr
from tuch_tpu_torch.ops import attention as pt_attn
from tuch_tpu_torch.runtime import load_hmr_weights

HEADS = 2


def _inputs(hd, B=2, N=17, seed=0):
    rng = np.random.RandomState(seed)
    C = HEADS * hd
    return (rng.randn(B, N, 3 * C).astype(np.float32),
            rng.randn(B, N, C).astype(np.float32))


def _jax_grad(x, g, dtype):
    _, vjp = jax.vjp(lambda q: jax_attn.fused_mha(q, HEADS),
                     jnp.asarray(x).astype(dtype))
    return np.asarray(vjp(jnp.asarray(g).astype(dtype))[0], np.float32)


def _port_grad(x, g, dtype):
    qkv = torch.from_numpy(x).to(dtype).requires_grad_(True)
    out = pt_attn.fused_mha(qkv, HEADS)
    assert out.grad_fn is not None and out.dtype == dtype
    out.backward(torch.from_numpy(g).to(dtype))
    assert qkv.grad.dtype == dtype
    return qkv.grad.float().numpy()


@pytest.mark.parametrize('hd', [32, 64])
def test_fused_mha_gradient_matches_jax_fp32(hd):
    x, g = _inputs(hd)
    np.testing.assert_allclose(_port_grad(x, g, torch.float32),
                               _jax_grad(x, g, jnp.float32),
                               atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize('hd', [32, 64])
def test_fused_mha_gradient_matches_jax_bf16(hd):
    x, g = _inputs(hd, seed=1)
    want32 = _jax_grad(x, g, jnp.float32)
    want16 = _jax_grad(x, g, jnp.bfloat16)
    gap = np.abs(want16 - want32).max()
    err = np.abs(_port_grad(x, g, torch.bfloat16) - want16).max()
    assert err <= 2 * gap + 1e-3 * np.abs(want32).max(), (err, gap)


def test_fused_mha_gradient_is_mha_reference_recomputed():
    """The Function's backward is the autograd of the plain version on the
    saved qkv, bit for bit, and its forward is the plain version's."""
    x, g = _inputs(32, seed=2)
    qkv = torch.from_numpy(x).requires_grad_(True)
    out = pt_attn.fused_mha(qkv, HEADS)
    out.backward(torch.from_numpy(g))
    ref_in = torch.from_numpy(x).requires_grad_(True)
    ref = pt_attn.mha_reference(ref_in, HEADS)
    ref.backward(torch.from_numpy(g))
    assert torch.equal(out.detach(), ref.detach())
    assert torch.equal(qkv.grad, ref_in.grad)


def test_fused_mha_builds_no_graph_without_gradient():
    x, _ = _inputs(32, seed=3)
    qkv = torch.from_numpy(x).requires_grad_(True)
    with torch.no_grad():
        out = pt_attn.fused_mha(qkv, HEADS)
    assert out.grad_fn is None and not out.requires_grad
    plain = pt_attn.fused_mha(torch.from_numpy(x), HEADS)
    assert plain.grad_fn is None
    assert torch.equal(out, plain)
    with torch.enable_grad():
        assert type(pt_attn.fused_mha(qkv, HEADS).grad_fn).__name__ \
            == '_FusedMHABackward'


@pytest.fixture(scope='module')
def vit_t8():
    """(Flax HMR, its variables as numpy, the port's HMR with them)."""
    _, extras = jax_assets.synthetic_smpl(num_verts=170)
    means = (extras.mean_pose6d, extras.mean_shape, extras.mean_cam)
    model = jax_hmr.create_hmr(*means, backbone='vit_t8')
    variables = jax.tree_util.tree_map(
        np.asarray, jax_hmr.init_hmr(model, jax.random.PRNGKey(0)))
    port = pt_hmr.create_hmr(*means, backbone='vit_t8').eval()
    load_hmr_weights(port, pt_convert.from_jax_variables(variables))
    return model, variables, port


def test_vit_t8_hmr_parameter_gradients_match_jax(vit_t8):
    """A scalar loss of rotation matrices, betas and camera, with weights
    from numpy, differentiated against every parameter in both packages."""
    model, variables, port = vit_t8
    rng = np.random.RandomState(4)
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    w = [rng.randn(2, 24, 3, 3), rng.randn(2, 10), rng.randn(2, 3)]
    w = [a.astype(np.float32) for a in w]

    def loss_j(params):
        outs = model.apply({**variables, 'params': params}, jnp.asarray(x),
                           train=False)
        return sum((o * jnp.asarray(a)).sum() for o, a in zip(outs, w))

    grads_j = jax.grad(loss_j)(variables['params'])
    want = pt_convert.from_jax_variables(
        {'params': jax.tree_util.tree_map(np.asarray, grads_j)})
    port.zero_grad()
    outs = port(torch.from_numpy(x))
    sum((o * torch.from_numpy(a)).sum() for o, a in zip(outs, w)).backward()
    got = {k: p.grad for k, p in port.named_parameters()}
    assert set(got) == set(want)
    qkv = [k for k in got if k.endswith('attn.qkv.weight')]
    assert len(qkv) == 2 and all(got[k].abs().max() > 0 for k in qkv)
    for k, g in got.items():
        ref = want[k].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-3,
                                   atol=1e-5 * np.abs(ref).max() + 1e-12,
                                   err_msg=k)
