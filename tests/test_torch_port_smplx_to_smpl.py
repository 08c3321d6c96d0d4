"""tuch_tpu_torch's SMPL-X -> SMPL vertex fit against tuch_tpu's, on the
CPU, on the 170-vertex synthetic body.

The same targets (bodies posed from a numpy seed, shifted) and init poses
go through tuch_tpu.fitting.smplx_to_smpl and the port's eager loop at the
reference's lr 1e-2. The bars come from tools/smplx_fit_spread.py (four
seeds of this problem, the port against the JAX package and against
itself at 1 and 8 CPU threads). Without translation, 50 steps element by
element: pose and betas at 5e-5, the per-sample loss at rtol 5e-5
(readings at most 4.2e-6 and 2.3e-6). With the translation fitted the
loss can reach the bodies exactly, and there Adam's +-lr steps about the
optimum make float32 rounding grow: the port moves 1e-6 between thread
counts at 20 steps and up to 9.1e-5 at 50. So it is held element by
element at 20 steps (pose and betas 1e-4, loss rtol 1e-4; readings at
most 2.4e-5 and 2.0e-5), and at 50 steps at 4x the readings (pose and
betas 4e-4, 4x the thread spread; the loss at rtol 1e-2, 4x its largest
distance from the JAX package's, 2.3e-3). The opt-in MSE loss with a
free orientation, 20 steps: rtol 1e-4 + atol 1e-5 (readings at most
5.6e-6 in pose). cli/smplx_to_smpl --synthetic
(two bodies, the translation fitted) is held against the JAX CLI's
pickles after 20 steps at the 20-step bars.
"""

import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_train_parity import few_torch_threads  # noqa: F401
from tuch_tpu import assets as jassets
from tuch_tpu.cli import smplx_to_smpl as jcli
from tuch_tpu.fitting.smplx_to_smpl import fit_smpl_to_vertices as jfit
from tuch_tpu.models.smpl import smpl_forward_pose72 as jforward
from tuch_tpu_torch import assets as passets
from tuch_tpu_torch.cli import smplx_to_smpl as pcli
from tuch_tpu_torch.fitting.smplx_to_smpl import \
    fit_smpl_to_vertices as pfit
from tuch_tpu_torch.models.smpl import SMPL

pytestmark = pytest.mark.usefixtures('few_torch_threads')

# (fit_translation, steps) -> (pose and betas atol, loss rtol)
BARS = {(False, 50): (5e-5, 5e-5), (True, 20): (1e-4, 1e-4),
        (True, 50): (4e-4, 1e-2)}


@pytest.fixture(scope='module')
def bodies():
    jm, _ = jassets.synthetic_smpl(num_verts=170, seed=0)
    pm = SMPL(passets.synthetic_smpl(num_verts=170, seed=0)[0])
    rng = np.random.RandomState(0)
    B = 4
    pose = (rng.randn(B, 72) * 0.2).astype(np.float32)
    betas = (rng.randn(B, 10) * 0.5).astype(np.float32)
    target = np.asarray(jforward(jm, jnp.asarray(betas),
                                 jnp.asarray(pose)).vertices) \
        + np.array([0.1, -0.05, 0.2], np.float32)
    init = pose + (rng.randn(B, 72) * 0.1).astype(np.float32)
    return jm, pm, target, init


@pytest.mark.parametrize('fit_translation,steps', sorted(BARS))
def test_vertex_fit_matches_jax(bodies, fit_translation, steps):
    jm, pm, target, init = bodies
    want = jfit(jm, jnp.asarray(target), init_pose=jnp.asarray(init),
                num_steps=steps, fit_translation=fit_translation)
    got = pfit(pm, torch.as_tensor(target), init_pose=torch.as_tensor(init),
               num_steps=steps, fit_translation=fit_translation)
    atol, loss_rtol = BARS[(fit_translation, steps)]
    # the global orientation is held at its init (reference semantics)
    np.testing.assert_array_equal(got.pose[:, :3].numpy(), init[:, :3])
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose),
                               rtol=0, atol=atol)
    np.testing.assert_allclose(got.betas.numpy(), np.asarray(want.betas),
                               rtol=0, atol=atol)
    assert got.loss.shape == (4,) and bool(torch.isfinite(got.loss).all())
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss),
                               rtol=loss_rtol)


def test_vertex_fit_mse_and_free_orient_match_jax(bodies):
    """The opt-in deviations, 20 steps without translation."""
    jm, pm, target, init = bodies
    kw = dict(num_steps=20, loss='mse', optimize_global_orient=True)
    want = jfit(jm, jnp.asarray(target), init_pose=jnp.asarray(init), **kw)
    got = pfit(pm, torch.as_tensor(target), init_pose=torch.as_tensor(init),
               **kw)
    assert not np.array_equal(got.pose[:, :3].numpy(), init[:, :3])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def _outputs(folder):
    out = {}
    for d, _, files in os.walk(folder):
        for f in files:
            if f.endswith('.pkl') and os.sep + 'smpl' + os.sep in \
                    os.path.join(d, f):
                with open(os.path.join(d, f), 'rb') as fh:
                    out[f] = pickle.load(fh)
    return out


def test_cli_synthetic_matches_jax(tmp_path):
    jcli.main(['--synthetic', '--folder', str(tmp_path / 'jax'),
               '--steps', '20'])
    outs = pcli.main(['--synthetic', '--folder', str(tmp_path / 'port'),
                      '--steps', '20', '--device', 'cpu'])
    assert len(outs) == 2 and all('/smpl/' in p for p in outs)
    want, got = _outputs(tmp_path / 'jax'), _outputs(tmp_path / 'port')
    assert sorted(got) == sorted(want) == ['000.pkl', '001.pkl']
    atol, _ = BARS[(True, 20)]
    for name in want:
        assert set(got[name]) == {'pose', 'betas'}
        for k in ('pose', 'betas'):
            assert got[name][k].dtype == np.float64
            assert got[name][k].shape == want[name][k].shape
            np.testing.assert_allclose(got[name][k], want[name][k], rtol=0,
                                       atol=atol, err_msg=f'{name} {k}')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pcli.main(['--synthetic', '--folder', str(tmp_path / 'x')])
