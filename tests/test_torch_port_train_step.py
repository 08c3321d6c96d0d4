"""tuch_tpu_torch's training step against tuch_tpu's, ResNet-50 backbone.

One step with run_smplify off and on (2 SMPLify-DC iterations), the HD
contact loss on, on the 170-vertex body at 64 px, B=2
(tests/_torch_train_parity.py sets both packages up); then the step's
degenerate batch and a non-finite fit, on the port alone.

The loss, every loss_dict entry, the accept mask, the fits rows and
opt_vertices are held at the bars of the helper. The gradients, the
BatchNorm statistics and the parameter updates are not: with batch
statistics at random init, every BatchNorm + ReLU stage multiplies a
rounding difference (x1.44 per bottleneck, tools/bn_train_chaos.py), so
the JAX package's own float32 gradient lies percents (L2) from its exact
value at this shape. Those three are held to the exact answer instead,
the port's step in float64 (whose HMR equals Flax's in float64 to
float32 rounding: tests/test_torch_port_hmr_train.py): the port's float32
must be no further from it than twice the JAX package's float32 is, plus
the gradient bar, over all tensors at once, while that float64 step lies
within the JAX package's float32 rounding gap of the JAX package's step
(assert_no_noisier). The BatchNorm statistics are also held to the JAX
package's element by element, at a bar above that gap
(assert_bn_stats_close).
"""

import numpy as np
import pytest
import torch

from tests import _torch_train_parity as T
from tuch_tpu_torch.models import convert as PC
from tuch_tpu_torch.train import module as PM

ON = dict(run_smplify=True, num_smplify_iters=2, smplify_threshold=1e9)
OFF = dict(run_smplify=False)


@pytest.fixture(scope='module')
def pair():
    return T.Pair('resnet50')


@pytest.mark.parametrize('kw', [OFF, ON], ids=['smplify_off', 'smplify_on'])
def test_resnet50_step_matches_jax(pair, kw):
    batch = T.make_batch(pair.num_classes)
    fits = T.initial_fits()
    masks = pair.dropout_masks(pair.jax_state(fits))
    (js, jm, jo, ps, pm, po), = T.run_both(pair, batch, fits, **kw)
    T.assert_losses_close(jm, pm)
    assert float(pm['loss_contact']) > 0
    T.assert_fits_and_vertices_close(js, jo, ps, po, fits)
    if kw['run_smplify']:
        assert po['fit_accepted'].any()

    want = T.jax_tensors(js)
    exact = T.port_step64(pair, batch, fits, masks, **kw)
    assert set(ps['mu']) == set(want['mu'])
    assert len(want['buffers']) == 2 * 53      # every BatchNorm's mean, var
    p0 = PC.params_from_jax(pair.variables['params'])
    T.assert_bn_stats_close(want, ps)
    T.assert_no_noisier(want, ps, exact, 'mu')
    T.assert_no_noisier(want, ps, exact, 'buffers')
    T.assert_no_noisier(want, ps, exact, 'params', base=p0)


def _port_step(pair, batch, fits, **kw):
    state = pair.port_state(fits)
    step = PM.make_train_step(pair.assets, pair.options(**kw)[1])
    return step(state, batch)


DEGENERATE = dict(run_smplify=True, num_smplify_iters=1,
                  contact_loss_weight=1e-3)


def test_degenerate_batch_stays_finite(pair):
    """All capability flags 0 and zero keypoint confidences (the JAX
    package's test_train_step_degenerate_batch_finite): no term has data,
    yet the loss and every updated parameter stay finite."""
    batch = T.make_batch(pair.num_classes)
    for k in ('has_smpl', 'has_pgt_smpl', 'has_disc_contact', 'has_gt_kpts',
              'has_pose_3d'):
        batch[k] = np.zeros_like(batch[k])
    batch['keypoints'][..., 2] = 0.0
    batch['contact_vec'][:] = 0.0
    state, metrics, _ = _port_step(pair, batch, T.initial_fits(),
                                   **DEGENERATE)
    assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
    assert all(bool(torch.isfinite(p).all())
               for p in state.hmr.parameters())
    assert state.step == 1


def test_nonfinite_fit_is_rejected(pair):
    """NaN images make the HMR's pose and so the fit NaN; NaN compares
    false against the stored fit's loss, so no row is written."""
    batch = T.make_batch(pair.num_classes)
    batch['img'] = np.full_like(batch['img'], np.nan)
    fits = np.tile(np.linspace(0.1, 0.9, 82, dtype=np.float32), (T.NFITS, 1))
    state, _, outputs = _port_step(pair, batch, fits, **DEGENERATE)
    assert not outputs['fit_accepted'].any()
    np.testing.assert_array_equal(state.fits.numpy(), fits)
