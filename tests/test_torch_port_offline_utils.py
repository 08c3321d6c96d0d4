"""The offline tools' shared helpers against tuch_tpu's, on the CPU:
utils/error_measures (MPJAE) on poses from a numpy seed, data/transforms
uncrop_image (bit for bit), the preprocessing constants, utils/dload and
utils/timing.fetch_sync (which on the CPU has no device to wait for)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tuch_tpu import constants as jconst
from tuch_tpu.data import transforms as JT
from tuch_tpu.utils import error_measures as JE
from tuch_tpu_torch import constants as pconst
from tuch_tpu_torch.data import transforms as PT
from tuch_tpu_torch.utils import error_measures as PE
from tuch_tpu_torch.utils.dload import dict_to_device
from tuch_tpu_torch.utils.timing import fetch_sync


@pytest.mark.parametrize('degrees', [True, False])
def test_mpjae_matches_jax(degrees):
    rng = np.random.RandomState(0)
    pred = (rng.randn(5, 72) * 0.6).astype(np.float32)
    gt = (rng.randn(5, 72) * 0.6).astype(np.float32)
    gt[0] = pred[0]                     # identical poses: 0 degrees
    want = np.asarray(JE.mpjae(jnp.asarray(pred), jnp.asarray(gt), degrees))
    got = PE.mpjae(torch.from_numpy(pred), torch.from_numpy(gt), degrees)
    assert got.shape == (5,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3
                               if degrees else 2e-5)


def test_quat_and_rotmat_angle_distance_match_jax():
    rng = np.random.RandomState(1)
    q1 = rng.randn(7, 4).astype(np.float32)
    q2 = rng.randn(7, 4).astype(np.float32)
    q1 /= np.linalg.norm(q1, axis=1, keepdims=True)
    q2 /= np.linalg.norm(q2, axis=1, keepdims=True)
    np.testing.assert_allclose(
        PE.quat_angle_distance(torch.from_numpy(q1),
                               torch.from_numpy(q2)).numpy(),
        np.asarray(JE.quat_angle_distance(jnp.asarray(q1), jnp.asarray(q2))),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('rot', [0.0, 30.0])
def test_uncrop_image_matches_jax_bit_for_bit(rot):
    rng = np.random.RandomState(2)
    crop = rng.randint(0, 255, (64, 64, 3)).astype(np.uint8)
    args = (np.array([80.0, 60.0]), 0.45, (120, 160), rot)
    got = PT.uncrop_image(crop, *args)
    want = JT.uncrop_image(crop, *args)
    assert got.dtype == want.dtype and got.shape == want.shape == (120, 160,
                                                                   3)
    np.testing.assert_array_equal(got, want)
    assert got.any()


def test_preprocessing_constants_match_jax():
    assert pconst.COCO18_TO_BODY25 == jconst.COCO18_TO_BODY25
    assert pconst.COCO_TO_BODY25 == jconst.COCO_TO_BODY25


def test_dict_to_device_and_fetch_sync_on_the_cpu():
    batch = {'a': np.arange(6, dtype=np.float32).reshape(2, 3),
             'b': torch.ones(2), 'name': 'x', 'n': 3}
    out = dict_to_device(batch, 'cpu')
    assert torch.equal(out['a'], torch.arange(6.0).reshape(2, 3))
    assert out['b'] is batch['b'] and out['name'] == 'x' and out['n'] == 3
    tree = {'x': torch.zeros(100), 'y': [torch.ones(3), 'tag']}
    assert fetch_sync(tree) is tree
    assert fetch_sync(torch.ones(2)) is not None
    assert fetch_sync('no tensors') == 'no tensors'
