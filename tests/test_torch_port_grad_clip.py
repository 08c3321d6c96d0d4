"""train/module.clip_by_global_norm followed by the port's Adam, against
optax.chain(optax.clip_by_global_norm(c), optax.adam(lr)), for 3 steps on
a random tree of float32 tensors, with c below the gradients' global norm
(clipping) and above it (no clipping). Gradients after the clip and the
parameters after each step are held at 1e-6 of each tensor's largest
entry: the norm's sums run in another order in the two packages, so the
clipped gradients may differ in their last bits, and nothing more.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tuch_tpu_torch.ops.adam import Adam
from tuch_tpu_torch.train.module import clip_by_global_norm

SHAPES = {'a': (64, 3, 7, 7), 'b': (64,), 'c': (1024, 2061), 'd': (3,)}
LR = 1e-2
RTOL = 1e-6


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize('scale', [0.5, 2.0], ids=['clips', 'keeps'])
def test_clip_then_adam_matches_optax(scale):
    rng = np.random.RandomState(0)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(3)]
    norm0 = np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                        for g in grads[0].values()))
    c = float(scale * norm0)
    tx = optax.chain(optax.clip_by_global_norm(c), optax.adam(LR))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = tx.init(jp)
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = Adam(pp, LR)
    names = sorted(SHAPES)              # the JAX tree's leaf order
    for g in grads:
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        clipped = optax.clip_by_global_norm(c).update(jg, None)[0]
        upd, js = tx.update(jg, js, jp)
        jp = optax.apply_updates(jp, upd)
        pg = clip_by_global_norm([torch.from_numpy(g[k]) for k in names], c)
        for k, t in zip(names, pg):
            _close(t, clipped[k])
        opt.step(pp, dict(zip(names, pg)))
        for k in names:
            _close(pp[k], jp[k])
    if scale < 1:
        assert float(jnp.abs(clipped['c']).max()) < np.abs(
            grads[-1]['c']).max()
    else:
        np.testing.assert_array_equal(np.asarray(clipped['c']),
                                      grads[-1]['c'])
