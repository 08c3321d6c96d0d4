"""Set-up of the bf16 training-step tests (not a test module): steps of
each package in bfloat16 and of the JAX package in float32 from the same
weights, batch, fits and dropout masks, and the bars
(tests/test_torch_port_bf16_step.py says which and why).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from tests import _torch_train_parity as T
from tuch_tpu.models import hmr as jax_hmr
from tuch_tpu.train import module as JM
from tuch_tpu_torch.models import convert as PC
from tuch_tpu_torch.models import hmr as pt_hmr
from tuch_tpu_torch.runtime import load_hmr_weights
from tuch_tpu_torch.train import module as PM

ON = dict(run_smplify=True, num_smplify_iters=2, smplify_threshold=1e9)


def _flat(d):
    return np.concatenate([np.asarray(d[k], np.float64).ravel()
                           for k in sorted(d)])


def bf16_steps(backbone, seeds):
    """Per batch seed: {quantity: (port bf16, JAX bf16, JAX fp32)} for
    'losses' (every loss_dict entry, by name), 'opt_vertices' and
    'gradients' (Adam's first moment, by parameter name), as numpy."""
    pair = T.Pair(backbone)
    jopts, popts = pair.options(compute_dtype='bfloat16', **ON)
    ex = pair.jr.extras
    j16 = jax_hmr.create_hmr(T.fold_pose6d(), ex.mean_shape, ex.mean_cam,
                             backbone=backbone, dtype=jnp.bfloat16)
    jstep16 = jax.jit(JM.make_train_step(
        j16, pair.jr.assets, jopts, optax.adam(jopts.lr), pair.num_classes))
    jstep32 = pair.jax_step(**ON)
    out = []
    for seed in seeds:
        batch = T.make_batch(pair.num_classes, np.random.RandomState(seed))
        fits = T.initial_fits()
        js0 = pair.jax_state(fits)
        masks = pair.dropout_masks(js0)
        js32, jm32, jo32 = jstep32(js0, batch)
        js16, jm16, jo16 = jstep16(js0, batch)
        p16 = pt_hmr.create_hmr(T.fold_pose6d(), pair.pr.hmr.init_shape,
                                pair.pr.hmr.init_cam, backbone=backbone,
                                dtype=torch.bfloat16)
        load_hmr_weights(p16, PC.from_jax_variables(pair.variables))
        state = PM.init_train_state(p16, torch.tensor(fits), popts.lr)
        ps, pm, po = PM.make_train_step(pair.assets, popts)(state, batch,
                                                             dropout=masks)
        assert all(v.dtype == torch.float32 for v in ps.opt.mu.values())
        assert all(p.dtype == torch.float32 for p in ps.hmr.parameters())
        assert set(pm) == set(jm16)
        assert float(pm['loss_contact']) > 0
        out.append(dict(
            losses=tuple({k: float(m[k]) for k in jm16}
                         for m in (pm, jm16, jm32)),
            opt_vertices=(po['opt_vertices'].numpy(),
                          np.asarray(jo16['opt_vertices']),
                          np.asarray(jo32['opt_vertices'])),
            gradients=({k: v.numpy() for k, v in ps.opt.mu.items()},
                       T.jax_tensors(js16)['mu'], T.jax_tensors(js32)['mu'])))
    return out
