"""tuch_tpu_torch's EFT fit against tuch_tpu's, vit_t8 backbone.

make_eft_fit_fn on the 170-vertex body with every contact asset at 64 px,
the HMR's IEF loop started from a folding pose so the contact terms are
live (tests/_torch_train_parity.py builds both packages). The JAX fit is
unrolled on the host with its key splits (tests/_torch_eft_parity.py),
held to the JAX package's make_eft_fit_fn, and its dropout masks fed to
the port's fit: the loss at the loss bar and the pose and betas element by
element (ViT has no BatchNorm; its float32 is well conditioned), after
each of 4 steps; the steps taken on three early-stop settings, one that
stops at min_steps + 2, one on the loss, one that never stops; no step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import _torch_eft_parity as E
from tests import _torch_train_parity as T
from tuch_tpu.fitting import eft as JEF
from tuch_tpu.losses.eft import EFTWeights as JW
from tuch_tpu_torch.fitting import eft as PEF
from tuch_tpu_torch.losses.eft import EFTWeights as PW
from tuch_tpu_torch.models import convert as PC
from tuch_tpu_torch.runtime import load_hmr_weights

pytestmark = pytest.mark.usefixtures('few_torch_threads')
few_torch_threads = T.few_torch_threads

STEPS = 4
KEY = 1
# pose (axis-angle) and betas after the Adam steps, element by element: the
# torch-parity bar of the HMR forward (tests/test_torch_port_models.py),
# atol 2e-4 and rtol 1e-3
ATOL, RTOL = 2e-4, 1e-3


@pytest.fixture(scope='module')
def setup():
    pair = T.Pair('vit_t8')
    load_hmr_weights(pair.pr.hmr, PC.from_jax_variables(pair.variables))
    start = {k: v.clone() for k, v in pair.pr.hmr.state_dict().items()}
    ins = E.fit_inputs(pair.num_classes, T.IMG)
    jr = pair.jr
    unrolled = E.unrolled_jax_fit(jr.hmr, jr.smpl, jr.assets.contact,
                                  T.IMG)(pair.variables, *ins,
                                         jax.random.PRNGKey(KEY), 6)
    return dict(pair=pair, start=start, ins=ins, unrolled=unrolled)


def jax_fit(setup, **kw):
    jr = setup['pair'].jr
    fit = JEF.make_eft_fit_fn(jr.hmr, jr.smpl, jr.assets.contact, JW(),
                              img_res=T.IMG, **kw)
    v = setup['pair'].variables
    pose, betas, steps, loss = fit(
        v['params'], v.get('batch_stats', {}),
        *(jnp.asarray(x) for x in setup['ins']), jax.random.PRNGKey(KEY))
    return dict(pose=np.asarray(pose), betas=np.asarray(betas),
                steps=int(steps), loss=float(loss))


def port_fit(setup, **kw):
    pr = setup['pair'].pr
    fit = PEF.make_eft_fit_fn(pr.hmr, pr.smpl, pr.contact, PW(),
                              img_res=T.IMG, **kw)
    masks = [u['masks'] for u in setup['unrolled']]
    r = fit(setup['start'], *(torch.from_numpy(x) for x in setup['ins']),
            dropout=lambda i: masks[i])
    return dict(pose=r.pose.numpy(), betas=r.betas.numpy(), steps=r.steps,
                loss=r.loss)


def assert_fit_close(got, want):
    assert got['steps'] == want['steps']
    assert abs(got['loss'] - want['loss']) <= T.LOSS_RTOL * abs(
        want['loss']), (got['loss'], want['loss'])
    for k in ('pose', 'betas'):
        assert np.isfinite(got[k]).all()
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_unrolled_jax_fit_equals_make_eft_fit_fn(setup):
    """The host-unrolled steps are the JAX package's fit (its while loop
    compiles otherwise: rtol 1e-5 on the loss, 1e-5 on pose and betas)."""
    want = jax_fit(setup, max_steps=STEPS, min_steps=STEPS)
    got = setup['unrolled'][STEPS - 1]
    assert want['steps'] == STEPS
    assert abs(got['loss'] - want['loss']) <= 1e-5 * abs(want['loss'])
    for k in ('pose', 'betas'):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize('n', range(1, STEPS + 1))
def test_fit_matches_jax_after_each_step(setup, n):
    """The port's fit of n steps on the JAX masks against the unrolled JAX
    fit's step n; the contact terms are live."""
    want = dict(setup['unrolled'][n - 1], steps=n)
    got = port_fit(setup, max_steps=n, min_steps=n)
    assert_fit_close(got, want)


def stop_on_the_loss(unrolled):
    """(min_steps 0, a threshold, the step it stops at): the first step s
    >= 2 whose pre-update loss falls below every loss of steps 2..s-1 by a
    margin of 1e-3, with the threshold half way."""
    losses = [u['loss'] for u in unrolled]
    for s in range(3, len(losses)):
        above = min(losses[1:s - 1])
        if losses[s - 1] < above * (1 - 1e-3):
            return 0, 0.5 * (above + losses[s - 1]), s
    raise AssertionError(f'no loss-triggered stop in {losses}')


@pytest.mark.parametrize('setting', ['min_steps', 'loss', 'never'])
def test_early_stop_steps_match_jax(setup, setting):
    if setting == 'min_steps':
        # a threshold no loss reaches below: the earliest stop, after
        # min_steps + 2 updates (tests/test_cli_viz.py: 3 steps)
        kw, expect = dict(min_steps=1, early_stop_loss=1e12, max_steps=4), 3
    elif setting == 'loss':
        min_steps, thr, expect = stop_on_the_loss(setup['unrolled'])
        kw = dict(min_steps=min_steps, early_stop_loss=thr, max_steps=6)
    else:
        kw, expect = dict(min_steps=1, early_stop_loss=0.0, max_steps=5), 5
    want = jax_fit(setup, **kw)
    assert want['steps'] == expect
    got = port_fit(setup, **kw)
    assert_fit_close(got, want)


def test_no_step_gives_identity_and_zeros(setup):
    want = jax_fit(setup, max_steps=0)
    got = port_fit(setup, max_steps=0)
    assert got['steps'] == want['steps'] == 0
    assert got['loss'] == want['loss'] == float('inf')
    np.testing.assert_array_equal(got['pose'], want['pose'])
    np.testing.assert_array_equal(got['betas'], want['betas'])
    assert not got['pose'].any() and not got['betas'].any()


def test_each_fit_starts_from_the_given_state(setup):
    """Each fit starts from the state given: a second fit of the same
    exemplar gives the same result bit for bit, though the first moved the
    HMR's parameters."""
    a = port_fit(setup, max_steps=2, min_steps=2)
    moved = any(not torch.equal(p, setup['start'][k]) for k, p in
                setup['pair'].pr.hmr.state_dict().items())
    b = port_fit(setup, max_steps=2, min_steps=2)
    assert moved
    for k in ('pose', 'betas'):
        np.testing.assert_array_equal(a[k], b[k])
    assert a['loss'] == b['loss']
