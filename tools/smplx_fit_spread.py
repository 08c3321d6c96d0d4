#!/usr/bin/env python3
"""How far float32 rounding moves the SMPL-X -> SMPL vertex fit, on the CPU:
the numbers behind the bars of tests/test_torch_port_smplx_to_smpl.py and
chip_smoke.py phase 17.

    JAX_PLATFORMS=cpu python3 tools/smplx_fit_spread.py    # ~1 minute

On the 170-vertex synthetic body (the test's problem: four bodies posed
from a numpy seed, shifted, init poses 0.1 rad off), for seeds 0-3, with
and without the translation fitted, at 20 and 50 steps: the largest pose,
betas and relative loss difference between tuch_tpu_torch's fit and the
JAX package's, and between the port's own fit at 1 and 8 CPU threads;
and the opt-in MSE loss with a free global orientation at 20 steps.
Then on the full body (chip_smoke.py phase 17's shard, four bodies), the
port at 1 against 8 threads after 20 steps. Prints one JSON line per
case.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def largest(a, b):
    import numpy as np
    a, b = (np.asarray(x, np.float64) for x in (a, b))
    return float(np.abs(a - b).max())


def main() -> int:
    import jax
    jax.config.update('jax_platforms', 'cpu')
    import jax.numpy as jnp
    import numpy as np
    import torch

    import chip_smoke as CS
    from tuch_tpu import assets as jassets
    from tuch_tpu.fitting.smplx_to_smpl import fit_smpl_to_vertices as jfit
    from tuch_tpu.models.smpl import smpl_forward_pose72 as jforward
    from tuch_tpu_torch import assets as passets
    from tuch_tpu_torch.fitting.smplx_to_smpl import \
        fit_smpl_to_vertices as pfit
    from tuch_tpu_torch.models.smpl import SMPL

    jm, _ = jassets.synthetic_smpl(num_verts=170, seed=0)
    pm = SMPL(passets.synthetic_smpl(num_verts=170, seed=0)[0])
    for seed in range(4):
        rng = np.random.RandomState(seed)
        pose = (rng.randn(4, 72) * 0.2).astype(np.float32)
        betas = (rng.randn(4, 10) * 0.5).astype(np.float32)
        target = np.asarray(jforward(jm, jnp.asarray(betas),
                                     jnp.asarray(pose)).vertices) \
            + np.array([0.1, -0.05, 0.2], np.float32)
        init = pose + (rng.randn(4, 72) * 0.1).astype(np.float32)
        for translation in (False, True):
            for steps in (20, 50):
                kw = dict(num_steps=steps, fit_translation=translation)
                want = jfit(jm, jnp.asarray(target),
                            init_pose=jnp.asarray(init), **kw)
                port = {}
                for threads in (1, 8):
                    torch.set_num_threads(threads)
                    port[threads] = pfit(pm, torch.as_tensor(target),
                                         init_pose=torch.as_tensor(init),
                                         **kw)
                got = port[8]
                print(json.dumps({
                    'body': 170, 'seed': seed, 'translation': translation,
                    'steps': steps,
                    'port_vs_jax': {
                        'pose': largest(got.pose, want.pose),
                        'betas': largest(got.betas, want.betas),
                        'loss_rel': float(np.max(np.abs(
                            got.loss.numpy() - np.asarray(want.loss))
                            / np.asarray(want.loss)))},
                    'port_1_vs_8_threads': {
                        'pose': largest(port[1].pose, got.pose),
                        'betas': largest(port[1].betas, got.betas)}}),
                    flush=True)
        kw = dict(num_steps=20, loss='mse', optimize_global_orient=True)
        want = jfit(jm, jnp.asarray(target), init_pose=jnp.asarray(init),
                    **kw)
        got = pfit(pm, torch.as_tensor(target),
                   init_pose=torch.as_tensor(init), **kw)
        print(json.dumps({'body': 170, 'seed': seed, 'loss': 'mse',
                          'free_orient': True, 'steps': 20, 'port_vs_jax': {
                              k: largest(getattr(got, k), getattr(want, k))
                              for k in ('pose', 'betas', 'loss')}}),
              flush=True)

    CS.DEV = 'cpu'
    smpl = SMPL(passets.synthetic_smpl()[0])
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        _, targets, inits = CS.write_smplx_shard(d, smpl, 4, 17)
    full = {}
    for threads in (1, 8):
        torch.set_num_threads(threads)
        full[threads] = pfit(smpl, torch.as_tensor(targets),
                             init_pose=torch.as_tensor(inits),
                             num_steps=20, fit_translation=True)
    print(json.dumps({'body': 6890, 'steps': 20, 'translation': True,
                      'port_1_vs_8_threads': {
                          'pose': largest(full[1].pose, full[8].pose),
                          'betas': largest(full[1].betas, full[8].betas)}}),
          flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
