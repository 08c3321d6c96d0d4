"""The real-asset body segments of tuch_tpu_torch's runtime against the
JAX runtime's.

The on-disk asset tree is the one tests/test_runtime_real_assets.py
builds (its `asset_tree` fixture: a 170-vertex SMPL pickle, the contact
assets, two segment PLYs, one ascii and one binary, and segm_utils.py);
the port's config is pointed at the same paths. Segment tables must be
equal, value for value.
"""

import os

import numpy as np
import pytest
import torch

from tests.test_runtime_real_assets import _write_ply, asset_tree  # noqa: F401
from tuch_tpu import config as jcfg
from tuch_tpu import runtime as jrt
from tuch_tpu_torch import config as pcfg
from tuch_tpu_torch import runtime as prt

PATHS = ('SMPL_MODEL_DIR', 'JOINT_REGRESSOR_TRAIN_EXTRA', 'SMPL_MEAN_PARAMS',
         'PRIOR_FOLDER', 'GEODESICS_SMPL', 'DSC_ROOT', 'SEGMENT_DIR')


@pytest.fixture()
def tree(asset_tree, monkeypatch):  # noqa: F811
    """The JAX fixture's tree, with the port's config on the same paths."""
    for name in PATHS:
        monkeypatch.setattr(pcfg, name, getattr(jcfg, name))
    return asset_tree


def _port_runtime(**kw):
    return prt.build_runtime(device='cpu', synthetic=False,
                             backbone='vit_t8', with_contact=True, **kw)


def test_real_asset_segment_tables_match_jax(tree, capsys):
    want = jrt.build_runtime(synthetic=False, img_res=64,
                             with_hd=False).assets.contact.segment_tables
    got = _port_runtime().contact.segment_tables
    assert 'segments off' not in capsys.readouterr().out
    assert want is not None and got is not None
    _, _, seg_items, _ = tree
    assert got.names == want.names == tuple(n for n, _ in seg_items)
    assert got.num_verts == want.num_verts
    # the port holds its index tables as int64 tensors on the device
    for name in ('fused_vidx', 'fused_vmask', 'fused_faces', 'ring_idx',
                 'ring_w'):
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        assert a.shape == b.shape and np.array_equal(a, b), name
    for field in ('vidx', 'faces'):
        for a, b in zip(getattr(got, field), getattr(want, field)):
            assert np.array_equal(np.asarray(a), np.asarray(b)), field
    for a, b in zip(got.band_verts, want.band_verts):
        assert len(a) == len(b)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize('binary', [False, True])
def test_ply_reader_roundtrips_ascii_and_binary(tmp_path, binary):
    rng = np.random.RandomState(int(binary))
    verts = rng.randn(57, 3).astype(np.float32)
    red = np.sort(rng.choice(57, 13, replace=False))
    path = str(tmp_path / 'seg.ply')
    _write_ply(path, verts, red, binary=binary)
    got = prt._red_vertices_from_ply(path)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, red)
    np.testing.assert_array_equal(got, jrt._red_vertices_from_ply(path))


def test_segments_absent_stay_off_and_say_so(tree, tmp_path, monkeypatch,
                                             capsys):
    gone = str(tmp_path / 'no_segments')
    for mod in (jcfg, pcfg):
        monkeypatch.setattr(mod, 'SEGMENT_DIR', gone)
    want = jrt.build_runtime(synthetic=False, img_res=64, with_hd=False)
    got = _port_runtime()
    assert want.assets.contact.segment_tables is None
    assert got.contact.segment_tables is None
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if 'segments off' in ln]
    assert len(lines) == 1 and os.path.join(gone, 'segm_utils.py') in lines[0]
    # segments not asked for: off, and nothing to say
    assert _port_runtime(with_segments=False).contact.segment_tables is None
    assert 'segments off' not in capsys.readouterr().out
