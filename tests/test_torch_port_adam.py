"""fitting/smplify_dc.Adam's step, which updates every leaf at once through
torch._foreach_*, against the per-leaf expression it replaces, bit for bit:
the parameters and both moments after each of four steps, in float32 and
float64 (the parameters' precisions: a bfloat16 HMR keeps float32 weights
and casts them per call), on the CPU and on the card (marked cuda; skipped
without one). Eager division by a Python number rounds differently on the
two devices (the card multiplies by the reciprocal), so both are held.
"""

import numpy as np
import pytest
import torch

from tuch_tpu_torch.fitting.smplify_dc import Adam

SHAPES = {'w': (64, 3, 7, 7), 'b': (64,), 'fc': (517, 129), 's': (3,),
          'empty': (0, 5)}
LR = 1e-5


def per_leaf_step(state, params, grads, lr, b1=0.9, b2=0.999, eps=1e-8):
    """The per-leaf step as written before the foreach one: a dozen eager
    operations for each leaf."""
    state['count'] += 1
    n = np.float32(state['count'])
    c1 = float(1 - np.float32(b1) ** n)
    c2 = float(1 - np.float32(b2) ** n)
    out = {}
    for k, p in params.items():
        g = grads[k]
        state['mu'][k] = (1 - b1) * g + b1 * state['mu'][k]
        state['nu'][k] = (1 - b2) * (g * g) + b2 * state['nu'][k]
        upd = (state['mu'][k] / c1) / (torch.sqrt(state['nu'][k] / c2) + eps)
        out[k] = p + (-lr) * upd
    return out


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.view(torch.uint8) if a.numel() else a,
                       b.view(torch.uint8) if b.numel() else b)


@pytest.mark.parametrize('device', [
    'cpu', pytest.param('cuda', marks=pytest.mark.cuda)])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_foreach_step_is_the_per_leaf_step_bit_for_bit(device, dtype):
    if device == 'cuda' and not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    gen = torch.Generator().manual_seed(3)

    def tree(scale):
        # magnitudes over many octaves, and exact zeros, so that the
        # roundings of every operation are exercised
        return {k: (torch.randn(s, generator=gen)
                    * torch.exp2(torch.randint(-30, 4, s, generator=gen))
                    * (torch.rand(s, generator=gen) > 0.1) * scale
                    ).to(device=device, dtype=dtype)
                for k, s in SHAPES.items()}

    params = tree(1.0)
    opt = Adam(params, LR)
    ref = dict(count=0, mu={k: torch.zeros_like(v) for k, v in params.items()},
               nu={k: torch.zeros_like(v) for k, v in params.items()})
    got, want = params, dict(params)
    for _ in range(4):
        grads = tree(1e-2)
        got = opt.step(got, grads)
        want = per_leaf_step(ref, want, grads, LR)
        for k in SHAPES:
            _same(got[k], want[k])
            _same(opt.mu[k], ref['mu'][k])
            _same(opt.nu[k], ref['nu'][k])


def test_step_leaves_the_given_tensors_unchanged():
    """The step is functional: the parameters, gradients and the moments
    of the step before are not written (callers keep them, as
    tests/_torch_train_parity.snapshot does)."""
    gen = torch.Generator().manual_seed(5)
    params = {k: torch.randn(s, generator=gen) for k, s in SHAPES.items()}
    grads = {k: torch.randn(s, generator=gen) for k, s in SHAPES.items()}
    opt = Adam(params, LR)
    opt.step(params, grads)
    before = [{k: v.clone() for k, v in d.items()}
              for d in (params, grads, opt.mu, opt.nu)]
    held = (params, grads, opt.mu, opt.nu)
    out = opt.step(params, grads)
    for d, b in zip(held, before):
        for k in SHAPES:
            _same(d[k], b[k])
    assert all(out[k] is not params[k] for k in SHAPES)
