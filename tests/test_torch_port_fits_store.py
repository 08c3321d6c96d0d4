"""tuch_tpu_torch's fits store and its helpers against tuch_tpu's, CPU.

estimate_translation (with an all-zero-confidence sample), rot_z_deg,
rot_aa and flip_pose, the store's lookup and writeback under flips and
rotations (and their exact round trip), masked writeback, the rule for a
row named twice in one batch, and create_fits_store / save_fits.
Rotations and poses at atol 1e-5 (float32 trigonometry in two
frameworks); camera translations at rtol 1e-4 (a 3x3 solve whose matrix
entries span f^2 ~ 2.5e7 to ~1e4 loses ~1e-5 relative in float32).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tuch_tpu import constants as jconst
from tuch_tpu.train import fits_store as JS
from tuch_tpu.utils import projection as JP
from tuch_tpu.utils import rotations as JRot
from tuch_tpu_torch.train import fits_store as PS
from tuch_tpu_torch.utils import projection as PP
from tuch_tpu_torch.utils import rotations as PRot


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _fits_problem(seed=0, N=20, B=6):
    rng = np.random.RandomState(seed)
    return dict(
        params=(rng.randn(N, 82) * 0.3).astype(np.float32),
        gidx=rng.permutation(N)[:B].astype(np.int32),
        rot=rng.uniform(-30, 30, B).astype(np.float32),
        flip=rng.rand(B) > 0.5,
        pose=(rng.randn(B, 72) * 0.3).astype(np.float32),
        betas=rng.randn(B, 10).astype(np.float32),
        mask=rng.rand(B) > 0.4)


@pytest.mark.parametrize('with_anno', [False, True])
def test_estimate_translation_matches_jax(with_anno):
    rng = np.random.RandomState(1)
    B = 4
    S = (rng.randn(B, 49, 3) * 0.3).astype(np.float32)
    kp = np.concatenate([rng.uniform(20, 200, (B, 49, 2)),
                         rng.uniform(0, 1, (B, 49, 1))], -1).astype(
        np.float32)
    kp[2, :, 2] = 0.0                     # no confidence at all: t = 0
    anno = np.array([True, False, True, False])
    args = (5000.0, 224.0) + ((anno,) if with_anno else ())
    want = np.asarray(JP.estimate_translation(
        jnp.asarray(S), jnp.asarray(kp), *args[:2],
        *(jnp.asarray(a) for a in args[2:])))
    got = PP.estimate_translation(_t(S), _t(kp), *args[:2],
                                  *(_t(a) for a in args[2:])).numpy()
    assert np.all(got[2] == 0.0) and np.all(want[2] == 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_rotation_helpers_match_jax():
    rng = np.random.RandomState(2)
    deg = rng.uniform(-90, 90, 7).astype(np.float32)
    aa = (rng.randn(7, 3) * 0.8).astype(np.float32)
    pose = (rng.randn(5, 72) * 0.5).astype(np.float32)
    np.testing.assert_allclose(PRot.rot_z_deg(_t(deg)).numpy(),
                               np.asarray(JRot.rot_z_deg(jnp.asarray(deg))),
                               atol=1e-6)
    np.testing.assert_allclose(
        PRot.rot_aa(_t(aa), _t(deg)).numpy(),
        np.asarray(JRot.rot_aa(jnp.asarray(aa), jnp.asarray(deg))),
        atol=1e-5)
    perm = np.asarray(jconst.SMPL_POSE_FLIP_PERM)
    flipped = PRot.flip_pose(_t(pose), perm)
    np.testing.assert_array_equal(
        flipped.numpy(),
        np.asarray(JRot.flip_pose(jnp.asarray(pose), jnp.asarray(perm))))
    # a flip is an involution
    np.testing.assert_array_equal(PRot.flip_pose(flipped, perm).numpy(),
                                  pose)


def test_lookup_and_update_match_jax_under_flips_and_rotations():
    p = _fits_problem()
    pose_j, betas_j = JS.lookup_fits(jnp.asarray(p['params']),
                                     jnp.asarray(p['gidx']),
                                     jnp.asarray(p['rot']),
                                     jnp.asarray(p['flip']))
    pose_p, betas_p = PS.lookup_fits(_t(p['params']), _t(p['gidx']),
                                     _t(p['rot']), _t(p['flip']))
    np.testing.assert_allclose(pose_p.numpy(), np.asarray(pose_j),
                               atol=1e-5)
    np.testing.assert_array_equal(betas_p.numpy(), np.asarray(betas_j))
    new_j = JS.update_fits(jnp.asarray(p['params']), jnp.asarray(p['gidx']),
                           jnp.asarray(p['pose']), jnp.asarray(p['betas']),
                           jnp.asarray(p['rot']), jnp.asarray(p['flip']),
                           jnp.asarray(p['mask']))
    new_p = PS.update_fits(_t(p['params']), _t(p['gidx']), _t(p['pose']),
                           _t(p['betas']), _t(p['rot']), _t(p['flip']),
                           _t(p['mask']))
    np.testing.assert_allclose(new_p.numpy(), np.asarray(new_j), atol=1e-5)
    # masked writeback: exactly the accepted rows change
    changed = np.abs(new_p.numpy() - p['params']).max(axis=1) > 0
    want = np.zeros(len(p['params']), bool)
    want[p['gidx'][p['mask']]] = True
    np.testing.assert_array_equal(changed, want)


def test_lookup_then_update_is_a_round_trip():
    """Writing back what was looked up restores every row: the global
    orientation's rotation matrix to 1e-5 (axis-angle has sign choices),
    the body pose and betas bit for bit."""
    p = _fits_problem(3)
    params = _t(p['params'])
    gidx, rot, flip = _t(p['gidx']), _t(p['rot']), _t(p['flip'])
    pose, betas = PS.lookup_fits(params, gidx, rot, flip)
    new = PS.update_fits(params, gidx, pose, betas, rot, flip,
                         torch.ones(len(gidx), dtype=torch.bool))
    rows = p['gidx']
    np.testing.assert_allclose(
        PRot.batch_rodrigues(new[rows, :3]).numpy(),
        PRot.batch_rodrigues(params[rows, :3]).numpy(), atol=1e-5)
    np.testing.assert_array_equal(new[:, 3:].numpy(), p['params'][:, 3:])


def test_duplicate_rows_take_the_last_occurrence():
    """A row named twice: the last occurrence's row is written, its fit
    when accepted, the old row when not; it is one of the candidates."""
    N = 6
    params = torch.zeros(N, 82)
    gidx = torch.tensor([2, 4, 2, 2, 4])
    pose = 0.1 * (torch.arange(5, dtype=torch.float32)[:, None]
                  .repeat(1, 72) + 1)
    betas = pose[:, :10].clone()
    zeros = torch.zeros(5)
    nof = torch.zeros(5, dtype=torch.bool)
    mask = torch.tensor([True, True, False, True, False])
    # rotation 0 and no flip: rows are written as given (pose 0 is the
    # global orientation, rotated by 0 degrees)
    new = PS.update_fits(params, gidx, pose, betas, zeros, nof, mask)
    np.testing.assert_allclose(new[2, 3:72].numpy(), 0.4)   # entry 3
    np.testing.assert_array_equal(new[4].numpy(), np.zeros(82))  # entry 4
    np.testing.assert_array_equal(
        PS.last_occurrence(gidx).numpy(), [3, 4, 3, 3, 4])
    candidates = [np.zeros(82)] + [
        np.concatenate([pose[i].numpy(), betas[i].numpy()])
        for i in range(5)]
    for row in (2, 4):
        assert any(np.allclose(new[row].numpy(), c, atol=1e-5)
                   for c in candidates)


def test_create_and_save_fits_store(tmp_path):
    store = PS.create_fits_store({'a': 5, 'b': 3}, device='cpu')
    assert store.params.shape == (8, 82)
    assert store.offsets == {'a': 0, 'b': 5}
    store = store._replace(params=torch.arange(8 * 82, dtype=torch.float32)
                           .reshape(8, 82))
    PS.save_fits(store, str(tmp_path))
    assert os.path.exists(tmp_path / 'a_fits.npy')
    # the checkpoint's fits come before the static ones
    static = tmp_path / 'static'
    static.mkdir()
    np.save(static / 'b_fits.npy', np.ones((3, 82), np.float32))
    again = PS.create_fits_store({'a': 5, 'b': 3}, static_fits_dir=str(static),
                                 checkpoint_dir=str(tmp_path), device='cpu')
    np.testing.assert_array_equal(again.params.numpy(),
                                  store.params.numpy())
    jax_store = JS.create_fits_store({'a': 5, 'b': 3},
                                     checkpoint_dir=str(tmp_path))
    np.testing.assert_array_equal(np.asarray(jax_store.params),
                                  store.params.numpy())
    only_static = PS.create_fits_store({'b': 3}, static_fits_dir=str(static),
                                       device='cpu')
    np.testing.assert_array_equal(only_static.params.numpy(), 1.0)
    idx = PS.global_indices(again, torch.tensor([1, 0]), torch.tensor([2, 4]),
                            ['a', 'b'])
    np.testing.assert_array_equal(idx.numpy(), [7, 4])


def test_create_fits_store_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default device works')
    with pytest.raises(RuntimeError, match='CUDA'):
        PS.create_fits_store({'a': 2})
