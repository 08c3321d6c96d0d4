"""tuch_tpu_torch's cli/fit_eft against tuch_tpu's, on the CPU.

Both entry points with --synthetic on the 170-vertex body at 64 px and the
JAX package's ResNet-50 weights (its .npz tree as --pretrained_checkpoint),
shard 1 of 2 (--sidx 1 --cbs 2), one step an image: the port's fit draws
the JAX fitter's dropout masks (its key splits, read from Flax applies),
so the two fits are the same computation. The npz schema exactly, and the
pose and betas of each fitted image within 1e-2 of their size in L2, the
bar of tests/test_torch_port_eft_fit_resnet.py before any update (a
ResNet-50 train forward at B=1 in float32; measured there 1.8e-3). With
--merge the shards join into one db that both packages' loaders read
(written with joblib, and with pickle where joblib is missing);
--auto_shard raises; EFTDataset's samples equal the JAX package's.
"""

import io
import re
import sys
import tempfile
from contextlib import redirect_stdout
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from tests import _torch_eft_parity as E
from tests._torch_train_parity import (  # noqa: F401
    few_torch_threads, save_jax_npz)
from tuch_tpu import runtime as jrt
from tuch_tpu.cli import fit_eft as jcli
from tuch_tpu.data import dataset as JD
from tuch_tpu.data.eft_dataset import EFTDataset as JEFTDataset
from tuch_tpu_torch.cli import fit_eft as pcli
from tuch_tpu_torch.data import dataset as PD
from tuch_tpu_torch.data.eft_dataset import EFTDataset as PEFTDataset
from tuch_tpu_torch.fitting import eft as PEF

pytestmark = pytest.mark.usefixtures('few_torch_threads')

IMG, NV = 64, 170
ARGV = ['--synthetic', '--synthetic_num_verts', str(NV), '--img_res',
        str(IMG), '--sidx', '1', '--cbs', '2', '--max_steps', '1']
L2_BAR = 1e-2


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """Both CLIs' outputs and printed lines on the same weights and
    masks."""
    d = tmp_path_factory.mktemp('fit_eft')
    jr = jrt.build_runtime(synthetic=True, num_verts=NV, img_res=IMG,
                           with_hd=False)
    variables = jax.tree_util.tree_map(np.asarray, jr.variables)
    save_jax_npz(variables, d / 'w.npz')
    argv = ARGV + ['--pretrained_checkpoint', str(d / 'w.npz')]
    # the JAX fitter's keys: one split per image from PRNGKey(seed), then
    # one per step inside its fit
    read = E.mask_reader(jr.hmr)
    img = np.random.RandomState(0).randn(1, IMG, IMG, 3).astype(np.float32)
    rng, masks = jax.random.PRNGKey(0), []
    for _ in range(2):
        rng, sub = jax.random.split(rng)
        _, step_key = jax.random.split(sub)
        masks.append(read(variables, img, step_key))
    out = {}
    buf = io.StringIO()
    with redirect_stdout(buf):
        jcli.main(argv + ['--out_dir', str(d / 'jax')])
    out['jax_log'] = buf.getvalue()
    mp = pytest.MonkeyPatch()
    mp.setattr(PEF, 'draw_dropout_masks', lambda *a, **kw: masks.pop(0))
    buf = io.StringIO()
    try:
        with redirect_stdout(buf):
            out['written'] = pcli.main(argv + ['--out_dir', str(d / 'port'),
                                               '--device', 'cpu'])
    finally:
        mp.undo()
    out['port_log'] = buf.getvalue()
    assert not masks        # one mask draw per step, two steps
    for tag in ('jax', 'port'):
        with np.load(d / tag / 'dsc_df_eft_train_1.npz') as f:
            out[tag] = {k: f[k] for k in f.files}
    out['dir'] = d
    return out


def test_shard_schema_matches_jax(runs):
    assert runs['written'] == [str(runs['dir'] / 'port' /
                                   'dsc_df_eft_train_1.npz')]
    j, p = runs['jax'], runs['port']
    assert sorted(p) == sorted(j) == ['betas', 'indices', 'pose']
    for k in j:
        assert p[k].shape == j[k].shape and p[k].dtype == j[k].dtype, k
    np.testing.assert_array_equal(p['indices'], [2, 3])
    np.testing.assert_array_equal(p['indices'], j['indices'])
    # rows outside the shard stay zero in both
    assert not p['pose'][:2].any() and not j['pose'][:2].any()
    steps = [re.findall(r'\] (\d+): steps=(\d+)', runs[f'{t}_log'])
             for t in ('jax', 'port')]
    assert steps[0] == steps[1] == [('2', '1'), ('3', '1')]


def test_shard_values_match_jax(runs):
    j, p = runs['jax'], runs['port']
    for k in ('pose', 'betas'):
        for i in (2, 3):
            w, g = j[k][i].astype(np.float64), p[k][i].astype(np.float64)
            assert np.isfinite(g).all()
            assert np.linalg.norm(g - w) <= L2_BAR * np.linalg.norm(w), (
                k, i, np.linalg.norm(g - w) / np.linalg.norm(w))


@pytest.mark.parametrize('writer', ['joblib', 'pickle'])
def test_merge_read_by_both_loaders(runs, tmp_path, monkeypatch, writer):
    if writer == 'pickle':
        monkeypatch.setitem(sys.modules, 'joblib', None)  # no joblib
    shard = str(runs['dir'] / 'port' / 'dsc_df_eft_train_1.npz')
    (path,) = pcli.main(['--synthetic', '--synthetic_num_verts', str(NV),
                         '--img_res', str(IMG), '--device', 'cpu',
                         '--out_dir', str(tmp_path), '--merge', shard,
                         str(tmp_path / 'missing_0.npz')])
    monkeypatch.undo()
    assert path == str(tmp_path / 'dsc_df_eft_train.pt')
    for load in (JD.load_db, PD.load_db):
        db = load(path)
        np.testing.assert_array_equal(db['pose'][2:], runs['port']['pose'][2:])
        np.testing.assert_array_equal(db['betas'][2:],
                                      runs['port']['betas'][2:])
        assert not db['pose'][:2].any() and len(db['imgname']) == 4
    # the merged db trains as a dsc_*_eft set in both packages (its images
    # written again from the same seed)
    P = db['contact_vec_pc'].shape[1]
    opts = SimpleNamespace(img_res=IMG, seed=0)
    with tempfile.TemporaryDirectory() as d:
        PD.synthetic_db(4, img_dir=d, seed=0, num_contact_classes=P)
        want = JD.TuchDataset(opts, 'dsc_df_eft', data=JD.load_db(path),
                              img_dir=d, use_augmentation=False,
                              num_contact_classes=P).get(2)
        got = PD.TuchDataset(opts, 'dsc_df_eft', data=PD.load_db(path),
                             img_dir=d, use_augmentation=False,
                             num_contact_classes=P).get(2)
    np.testing.assert_array_equal(got['pose'], runs['port']['pose'][2])
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_auto_shard_raises(monkeypatch):
    """--auto_shard under a partial torchrun environment raises rather
    than fit every image in each process (the working split:
    tests/test_torch_port_parallel_eval.py)."""
    for k in ('MASTER_ADDR', 'MASTER_PORT', 'RANK'):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv('WORLD_SIZE', '2')
    with pytest.raises(ValueError, match='partial torchrun environment'):
        pcli.main(ARGV + ['--auto_shard', '--device', 'cpu'])


def test_eft_dataset_matches_jax(tmp_path):
    db = PD.synthetic_db(3, img_dir=str(tmp_path), seed=4,
                         num_contact_classes=5)
    opts = SimpleNamespace(img_res=IMG, seed=0)
    jds = JEFTDataset(opts, 'dsc_df', data=db, img_dir=str(tmp_path),
                      num_contact_classes=5)
    pds = PEFTDataset(opts, 'dsc_df', data=db, img_dir=str(tmp_path),
                      num_contact_classes=5)
    assert not pds.use_augmentation and not jds.use_augmentation
    for i in range(3):
        want, got = jds.get(i), pds.get(i)
        assert set(got) == set(want) and 'contact' in got
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        np.testing.assert_array_equal(got['contact'], got['contact_vec'])
    assert got['img'].shape == (IMG, IMG, 3)
