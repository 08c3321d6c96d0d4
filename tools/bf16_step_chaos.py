#!/usr/bin/env python3
"""How far the bf16 training step's check sits from its bar, by CPU thread
count (on the CPU, with JAX; ~2 minutes a thread count).

Runs tests/_torch_bf16_step.bf16_steps at each thread count and prints,
for ResNet-50 over 4 batches, the share of the bar that
tests/test_torch_port_bf16_step_resnet.py asserts (the port's bf16
distance from the JAX package's fp32 step over twice the JAX package's
bf16 one, in L2) and the port's bf16 loss of batch 0; for vit_t8 (batch
0) the largest share of tests/test_torch_port_bf16_step.py's bars.

    JAX_PLATFORMS=cpu python3 tools/bf16_step_chaos.py [THREADS ...]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _vec(x):
    import numpy as np
    if isinstance(x, dict):
        return np.concatenate([np.asarray(x[k], np.float64).ravel()
                               for k in sorted(x)])
    return np.asarray(x, np.float64).ravel()


def main() -> int:
    import numpy as np
    import torch

    from tests import _torch_train_parity as T
    from tests._torch_bf16_step import bf16_steps
    for n in [int(a) for a in sys.argv[1:]] or [8, 3, 2]:
        torch.set_num_threads(n)
        steps = bf16_steps('resnet50', range(4))
        shares = {}
        for q in ('losses', 'opt_vertices', 'gradients'):
            port = sum(np.sum((_vec(s[q][0]) - _vec(s[q][2])) ** 2)
                       for s in steps)
            jax = sum(np.sum((_vec(s[q][1]) - _vec(s[q][2])) ** 2)
                      for s in steps)
            shares[q] = round(float(np.sqrt(port) / (2 * np.sqrt(jax))), 3)
        print(f'[resnet50, {n} threads] share of the bar {shares}; batch 0 '
              f'loss: port bf16 {steps[0]["losses"][0]["loss"]:.6f}, JAX '
              f'bf16 {steps[0]["losses"][1]["loss"]:.6f}, JAX fp32 '
              f'{steps[0]["losses"][2]["loss"]:.6f}', flush=True)
        (step,) = bf16_steps('vit_t8', [0])
        worst = {}
        for q, atol in (('losses', None), ('opt_vertices', T.VERTEX_ATOL),
                        ('gradients', T.GRAD_ATOL)):
            got, w16, w32 = step[q]
            keys = sorted(w16) if isinstance(w16, dict) else [None]
            for k in keys:
                g, a, b = ((x if k is None else x[k]) for x in (got, w16,
                                                               w32))
                g, a, b = (np.asarray(x, np.float64) for x in (g, a, b))
                if q == 'losses':
                    bar = 2 * abs(a - b) + T.LOSS_RTOL * abs(b) + \
                        T.LOSS_ATOL * max(1.0, abs(b))
                elif q == 'opt_vertices':
                    bar = 2 * np.abs(a - b).max() + atol
                else:
                    bar = 2 * np.abs(a - b).max() + atol * np.abs(b).max()
                worst[q] = max(worst.get(q, 0.0),
                               float(np.abs(g - a).max() / bar))
        print(f'[vit_t8, {n} threads] largest share of a bar '
              f'{ {k: round(v, 3) for k, v in worst.items()} }', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
