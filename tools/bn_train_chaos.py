#!/usr/bin/env python3
"""How far float32 rounding carries through ResNet-50's batch-statistics
BatchNorm at random init, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/bn_train_chaos.py   # from the repo root

The HMR with the JAX package's random weights (seed 0) at 64 px, B=2, the
IEF head's dropout on fixed masks; float32 against float64, in train mode
(batch statistics) and in eval mode (running statistics):

  * for the port, the largest |float32 - float64| of each bottleneck's
    output, and its growth per bottleneck;
  * for both packages, the relative L2 distance of every parameter's
    gradient of a fixed scalar loss of the outputs, float32 from float64
    (the JAX package's HMR in both dtypes under jax.enable_x64, which
    draws its dropout masks alike for both).

Prints one line per mode. It is why tests/test_torch_port_train_step.py
holds ResNet-50's gradients through float64 rather than element by
element.
"""

import copy
import os
import sys

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from tuch_tpu import assets as jax_assets  # noqa: E402
from tuch_tpu.models import hmr as jax_hmr  # noqa: E402
from tuch_tpu_torch.models import convert as PC  # noqa: E402
from tuch_tpu_torch.models import hmr as pt_hmr  # noqa: E402
from tuch_tpu_torch.runtime import load_hmr_weights  # noqa: E402


def _flat(grads):
    return np.concatenate([np.asarray(g, np.float64).ravel()
                           for _, g in sorted(grads.items())])


def main() -> int:
    jax.config.update('jax_platforms', 'cpu')
    _, ex = jax_assets.synthetic_smpl(num_verts=170)
    means = (ex.mean_pose6d, ex.mean_shape, ex.mean_cam)
    rng = np.random.RandomState(4)
    img = rng.randn(2, 64, 64, 3) * 0.1
    w = [rng.randn(2, 24, 3, 3), rng.randn(2, 10), rng.randn(2, 3)]
    masks = pt_hmr.draw_dropout_masks(2, torch.Generator().manual_seed(0))
    variables = jax.tree_util.tree_map(np.asarray, jax_hmr.init_hmr(
        jax_hmr.create_hmr(*means), jax.random.PRNGKey(0)))

    for train in (True, False):
        grads, outs = {}, {}
        for dtype in (torch.float32, torch.float64):
            port = pt_hmr.create_hmr(*means, dtype=dtype)
            load_hmr_weights(port, PC.from_jax_variables(variables))
            port = port.to(dtype).train(train)
            acts = []
            for i in range(1, 5):
                for block in getattr(port, f'layer{i}'):
                    block.register_forward_hook(
                        lambda m, a, o: acts.append(o.detach().double()))
            got = port(torch.from_numpy(img).to(dtype), dropout=masks)
            sum((a * torch.from_numpy(b).to(dtype)).sum()
                for a, b in zip(got, w)).backward()
            grads[dtype] = {k: p.grad.numpy()
                            for k, p in port.named_parameters()}
            outs[dtype] = acts
        diffs = [(a - b).abs().max().item()
                 for a, b in zip(outs[torch.float32], outs[torch.float64])]
        growth = (diffs[-1] / diffs[0]) ** (1 / (len(diffs) - 1))

        jgrads = {}
        for x64 in (False, True):
            # both under x64, so that Flax draws the same dropout masks
            with jax.enable_x64(True):
                dt = jnp.float64 if x64 else jnp.float32
                model = jax_hmr.create_hmr(*means, dtype=dt)
                var = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt),
                                             variables)

                def loss(params):
                    o, _ = model.apply(
                        {**var, 'params': params}, jnp.asarray(img, dt),
                        train=train, rngs={'dropout': jax.random.PRNGKey(1)},
                        mutable=['batch_stats'])
                    return sum((a * jnp.asarray(b, dt)).sum()
                               for a, b in zip(o, w))
                g = jax.jit(jax.grad(loss))(var['params'])
                jgrads[x64] = {k: v.numpy() for k, v in PC.params_from_jax(
                    jax.tree_util.tree_map(
                        lambda a: np.asarray(a, np.float64), g)).items()}

        def rel(a, b):
            fa, fb = _flat(a), _flat(b)
            return np.linalg.norm(fa - fb) / np.linalg.norm(fb)
        print(f'[bn chaos] {"train" if train else "eval "} mode: bottleneck '
              f'output |f32 - f64| first {diffs[0]:.3g}, last {diffs[-1]:.3g}'
              f' ({len(diffs)} bottlenecks, x{growth:.3f} per bottleneck); '
              f'gradient L2 distance float32 from float64: port '
              f'{rel(grads[torch.float32], grads[torch.float64]):.3g}, JAX '
              f'package {rel(jgrads[False], jgrads[True]):.3g} (its own '
              f'dropout masks)', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
