"""tuch_tpu_torch's training step against tuch_tpu's, vit_t8 backbone.

One step with run_smplify off and on (2 SMPLify-DC iterations), the HD
contact loss on, and two steps carrying the state, on the 170-vertex body
at 64 px, B=2 (tests/_torch_train_parity.py sets both packages up). The
loss and every loss_dict entry, every parameter's gradient (Adam's first
moment), the parameters after Adam, the accept mask, the fits rows and
opt_vertices, each at the bar stated in the helper. ViT has no
BatchNorm; its float32 gradients are well conditioned, so they are held
element by element.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import _torch_train_parity as T
from tuch_tpu.train import module as JM
from tuch_tpu_torch.constants import FOCAL_LENGTH
from tuch_tpu_torch.train import module as PM

ON = dict(run_smplify=True, num_smplify_iters=2, smplify_threshold=1e9)
OFF = dict(run_smplify=False)


@pytest.fixture(scope='module')
def pair():
    return T.Pair('vit_t8')


@pytest.mark.parametrize('kw', [OFF, ON], ids=['smplify_off', 'smplify_on'])
def test_vit_t8_step_matches_jax(pair, kw):
    batch = T.make_batch(pair.num_classes)
    fits = T.initial_fits()
    (js, jm, jo, ps, pm, po), = T.run_both(pair, batch, fits, **kw)
    T.assert_losses_close(jm, pm)
    assert float(pm['loss_contact']) > 0    # the HD contact loss bites
    want = T.jax_tensors(js)
    T.assert_grads_close(want, ps)
    T.assert_params_close(want, ps, T.moment_bars([want['mu']])[0])
    assert not want['buffers']
    assert not any(k.endswith('running_var') for k in ps['buffers'])
    T.assert_fits_and_vertices_close(js, jo, ps, po, fits)
    if kw['run_smplify']:
        assert po['fit_accepted'].any()


def test_vit_t8_two_steps_carrying_the_state(pair):
    batch = T.make_batch(pair.num_classes, np.random.RandomState(1))
    fits = T.initial_fits(6)
    runs = T.run_both(pair, batch, fits, n_steps=2, **ON)
    wants = [T.jax_tensors(r[0]) for r in runs]
    bars = T.moment_bars([w['mu'] for w in wants])
    lim = None
    for (js, jm, jo, ps, pm, po), want, bar in zip(runs, wants, bars):
        T.assert_losses_close(jm, pm)
        T.assert_grads_close(want, ps)
        lim = T.assert_params_close(want, ps, bar, lim)
        T.assert_fits_and_vertices_close(js, jo, ps, po, fits)
    assert runs[1][3]['step'] == 2
    assert float(runs[1][4]['loss']) != float(runs[0][4]['loss'])


def test_spin_reference_forward_matches_jax(pair):
    """The eval-mode forward for visualisation from a model in train():
    vertices and camera translation against the JAX package's at the
    torch-parity bar (atol 2e-4, rtol 1e-3), and the model is left in
    train()."""
    img = np.random.RandomState(3).randn(T.B, T.IMG, T.IMG, 3).astype(
        np.float32)
    want = JM.spin_reference_forward(pair.jr.hmr, pair.variables,
                                     jnp.asarray(img), pair.jr.smpl,
                                     FOCAL_LENGTH, T.IMG)
    hmr = pair.port_state(T.initial_fits()).hmr.train()
    got = PM.spin_reference_forward(hmr, torch.from_numpy(img), pair.pr.smpl,
                                    FOCAL_LENGTH, T.IMG)
    assert hmr.training
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3,
                                   atol=2e-4)
