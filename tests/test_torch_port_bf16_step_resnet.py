"""The training step with a bfloat16 HMR, the port's against the JAX
package's, ResNet-50 at 64 px (tests/test_torch_port_bf16_step.py: vit_t8
and the set-up).

ResNet-50's batch-statistics BatchNorm at random init amplifies a rounding
difference x1.44 per bottleneck (tests/test_torch_port_train_step.py), so
its bf16 step is bf16 rounding amplified into noise of the size of the
bf16-against-fp32 gap itself: the same port step moves its loss 0.048
between 8 and 3 CPU threads, where the JAX package's gap is 0.030
(tools/bf16_step_chaos.py). As the float32 ResNet-50 step is held to an
exact answer, the port's bf16 is held to the JAX package's float32 step:
over 4 batches at once, in L2, the port's bf16 lies no further from it
than twice the JAX package's bf16 does, for the loss_dict, opt_vertices
and the gradients (Adam's first moment). At 8, 3 and 2 CPU threads the
tool reads 0.38-0.51, 0.60-0.80 and 0.51-0.52 of the bar.
"""

import numpy as np
import pytest

from tests._torch_bf16_step import bf16_steps
from tests._torch_train_parity import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures('few_torch_threads')


def _vec(x):
    if isinstance(x, dict):
        return np.concatenate([np.asarray(x[k], np.float64).ravel()
                               for k in sorted(x)])
    return np.asarray(x, np.float64).ravel()


def test_bf16_step_within_twice_the_jax_error_resnet50():
    steps = bf16_steps('resnet50', range(4))
    for q in ('losses', 'opt_vertices', 'gradients'):
        port = jax = 0.0
        for step in steps:
            p16, j16, j32 = (_vec(x) for x in step[q])
            assert p16.shape == j32.shape
            assert not np.array_equal(p16, j32)     # it is bf16
            port += np.sum((p16 - j32) ** 2)
            jax += np.sum((j16 - j32) ** 2)
        assert np.sqrt(port) <= 2 * np.sqrt(jax), (q, np.sqrt(port / jax))
