"""tuch_tpu_torch's EFT fit against tuch_tpu's, ResNet-50 backbone.

The backbone of cli/fit_eft, on the 170-vertex body at 64 px with every
contact asset (tests/_torch_train_parity.py builds both packages), the JAX
fit unrolled with its key splits and its dropout masks fed to the port
(tests/_torch_eft_parity.py). ResNet-50's batch-statistics BatchNorm at
B=1 and random init amplifies float32 rounding, and Adam's first update
(+-lr on every parameter, whatever the gradient's size) turns gradients at
rounding level into whole steps of the other sign: after one update the
JAX package's float32 fit lies up to 34% (betas) from the port's float64
fit on one exemplar, and the port's float32 fit as far. So the fit is held
through float64, never element by element in float32, and over EXEMPLARS
exemplars at once in L2 (one exemplar's distance is itself chaotic: the
JAX package's float32 loss came 0.17% from float64 on one, 9% on another):
after each of 3 steps, for the pose, the betas and the loss, the port's
float32 no further from the port's float64 than twice the JAX package's
float32 is (plus 1e-3 of its size), and the JAX package's float32 near the
float64 fit (JAX_GAP of its size), so that a fault of the port in both
dtypes cannot widen the first bar. Measured on the CPU at 1, 2 and 8 torch
threads: the first ratio 0.01-0.17 at step 1 and 0.20-0.53 at steps 2-3
(<= 1 passes).
"""

import copy

import jax
import numpy as np
import pytest
import torch

from tests import _torch_eft_parity as E
from tests import _torch_train_parity as T
from tuch_tpu_torch.fitting import eft as PEF
from tuch_tpu_torch.losses.eft import EFTWeights as PW
from tuch_tpu_torch.models import convert as PC
from tuch_tpu_torch.runtime import load_hmr_weights

pytestmark = pytest.mark.usefixtures('few_torch_threads')
few_torch_threads = T.few_torch_threads

STEPS = 3
EXEMPLARS = 4
# ||JAX32 - port64|| / ||JAX32|| over the exemplars, by step: before any
# update (step 1's forward) measured 1.1e-4 (pose), 1.8e-3 (betas), 2.2e-4
# (loss); after one and two updates up to 1.9e-2 (pose), 0.30 (betas),
# 5.6% (loss)
JAX_GAP = {1: 1e-2, 2: 0.5, 3: 0.5}


@pytest.fixture(scope='module')
def fits():
    """The JAX package's unrolled fits of EXEMPLARS exemplars, and a
    function (dtype, n) -> the port's fits of n steps on their masks."""
    pair = T.Pair('resnet50')
    load_hmr_weights(pair.pr.hmr, PC.from_jax_variables(pair.variables))
    jr = pair.jr
    run = E.unrolled_jax_fit(jr.hmr, jr.smpl, jr.assets.contact, T.IMG)
    exemplars = []
    for seed in range(EXEMPLARS):
        ins = E.fit_inputs(pair.num_classes, T.IMG, seed)
        exemplars.append((ins, run(pair.variables, *ins,
                                   jax.random.PRNGKey(seed + 1), STEPS)))
    pr = pair.pr

    def port(dtype, n):
        hmr, smpl, contact = copy.deepcopy(pr.hmr), copy.deepcopy(pr.smpl), \
            pr.contact
        if dtype == torch.float64:
            hmr, smpl = hmr.double(), smpl.double()
            hmr.dtype = dtype
            tables = contact.segment_tables
            contact = contact._replace(segment_tables=type(tables)(*(
                t.double() if torch.is_tensor(t) and t.is_floating_point()
                else t for t in tables)))
        start = {k: v.clone() for k, v in hmr.state_dict().items()}
        fit = PEF.make_eft_fit_fn(hmr, smpl, contact, PW(), img_res=T.IMG,
                                  max_steps=n, min_steps=n)
        out = []
        for ins, unrolled in exemplars:
            masks = [u['masks'] for u in unrolled]
            r = fit(start, *(torch.from_numpy(x).to(dtype) for x in ins),
                    dropout=lambda i: masks[i])
            assert r.steps == n
            out.append(dict(pose=r.pose.double().numpy(),
                            betas=r.betas.double().numpy(), loss=r.loss))
        return out

    return [u for _, u in exemplars], port


def flat(fits, k):
    return np.concatenate([np.ravel(np.asarray(f[k], np.float64))
                           for f in fits])


@pytest.mark.parametrize('n', range(1, STEPS + 1))
def test_resnet50_fit_no_noisier_than_jax(fits, n):
    unrolled, port = fits
    want = [u[n - 1] for u in unrolled]
    got, exact = port(torch.float32, n), port(torch.float64, n)
    for k in ('pose', 'betas', 'loss'):
        w, g, e = flat(want, k), flat(got, k), flat(exact, k)
        assert np.isfinite(g).all()
        d_jax, d_port = np.linalg.norm(w - e), np.linalg.norm(g - e)
        norm = np.linalg.norm(w)
        assert d_jax <= JAX_GAP[n] * norm, (k, d_jax / norm)
        assert d_port <= 2 * d_jax + T.GRAD_RTOL * norm, (k, d_port, d_jax)
