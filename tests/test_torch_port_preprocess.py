"""tuch_tpu_torch's offline extractors against tuch_tpu's, on the CPU.

The raw trees of data/preprocess/synthetic_raw.py are written by both
packages and must be the same files (scipy's .mat files up to their
116-byte text header, which holds the time of writing). Each extractor of
each package then reads its own package's tree, and the databases must be
equal key by key: every key, every entry's type, dtype, shape and value
bit for bit. The JAX extractors write with joblib, the port a plain pickle
of the same dict; joblib.load and pickle.load both read the port's.
cli/preprocess --synthetic is held the same way; without h5py it leaves
out the 3DHP test set and writes the rest unchanged; the 3DHP frame
extraction raises without cv2.
"""

import os
import pickle
import sys

import joblib
import numpy as np
import pytest

from tuch_tpu.cli import preprocess as jcli
from tuch_tpu.data.preprocess import dsc as jdsc
from tuch_tpu.data.preprocess import mpi_inf_3dhp as j3dhp
from tuch_tpu.data.preprocess import mtp as jmtp
from tuch_tpu.data.preprocess import pw3d as jpw3d
from tuch_tpu.data.preprocess import synthetic_raw as jsr
from tuch_tpu_torch.cli import preprocess as pcli
from tuch_tpu_torch.data.preprocess import dsc as pdsc
from tuch_tpu_torch.data.preprocess import mpi_inf_3dhp as p3dhp
from tuch_tpu_torch.data.preprocess import mtp as pmtp
from tuch_tpu_torch.data.preprocess import pw3d as ppw3d
from tuch_tpu_torch.data.preprocess import synthetic_raw as psr

MAT_HEADER = 116      # MATLAB 5 text header: 'Created on: <time>'

JAX = dict(dsc=jdsc, mtp=jmtp, pw3d=jpw3d, dhp=j3dhp, sr=jsr)
PORT = dict(dsc=pdsc, mtp=pmtp, pw3d=ppw3d, dhp=p3dhp, sr=psr)


def _write_trees(pkg, root):
    sr = pkg['sr']
    return dict(dsc=sr.write_dsc_raw(root), mtp=sr.write_mtp_raw(root),
                pw3d=sr.write_pw3d_raw(root), dhp=sr.write_3dhp_raw(root))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same_file(a, b):
    with open(a, 'rb') as fa, open(b, 'rb') as fb:
        x, y = fa.read(), fb.read()
    if x.startswith(b'MATLAB 5.0 MAT-file'):
        return len(x) == len(y) and x[MAT_HEADER:] == y[MAT_HEADER:]
    return x == y


def assert_same(got, want, path='db'):
    """Equal in type, dtype, shape and every bit, recursively."""
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want), (path, list(got), list(want))
        for k in want:
            assert_same(got[k], want[k], f'{path}[{k!r}]')
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f'{path}[{i}]')
    elif isinstance(want, (np.ndarray, np.generic)):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes(), path
    else:
        assert got == want, (path, got, want)


@pytest.fixture(scope='module')
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp('raw')
    dirs = {name: _write_trees(pkg, str(root / name))
            for name, pkg in (('jax', JAX), ('port', PORT))}
    return root, dirs


def test_raw_trees_are_the_same_files(trees):
    root, _ = trees
    files = _files(root / 'jax')
    assert files == _files(root / 'port') and len(files) > 50
    for f in files:
        assert _same_file(root / 'jax' / f, root / 'port' / f), f


def _static_fits(path, n):
    rng = np.random.RandomState(7)
    np.savez(path, pose=rng.randn(n, 72) * 0.2, shape=rng.randn(n, 10),
             has_smpl=np.ones(n))
    return path


# extractor -> call on (package modules, its tree's dirs, out dir, tmp)
EXTRACTORS = {
    'dsc_df': lambda m, d, out, tmp: m['dsc'].read_df_subset(
        d['dsc']['dsc_dir'], d['dsc']['df_img_dir'], out),
    'dsc_lsp': lambda m, d, out, tmp: m['dsc'].read_lsp_subset(
        d['dsc']['dsc_dir'], d['dsc']['lsp_img_dir'], 'lsp', out),
    'dsc_lspet': lambda m, d, out, tmp: m['dsc'].read_lsp_subset(
        d['dsc']['dsc_dir'], d['dsc']['lspet_img_dir'], 'lspet', out),
    'mtp_train': lambda m, d, out, tmp: m['mtp'].mtp_extract(
        ds_dir=d['mtp']['ds_dir'], out_path=out, mode='train'),
    'mtp_val': lambda m, d, out, tmp: m['mtp'].mtp_extract(
        ds_dir=d['mtp']['ds_dir'], out_path=out, mode='val'),
    '3dpw_test': lambda m, d, out, tmp: m['pw3d'].pw3d_extract(
        dataset_path=d['pw3d']['ds_dir'], out_path=out, split='test'),
    '3dhp_train': lambda m, d, out, tmp: m['dhp'].mpi_inf_3dhp_extract(
        dataset_path=d['dhp']['ds_dir'], out_path=out, mode='train'),
    '3dhp_train_fits_fold_camera': lambda m, d, out, tmp:
        m['dhp'].mpi_inf_3dhp_extract(
            dataset_path=d['dhp']['ds_dir'], out_path=out, mode='train',
            static_fits=_static_fits(os.path.join(tmp, 'fits.npz'), 2),
            fold_camera=True),
    '3dhp_test': lambda m, d, out, tmp: m['dhp'].mpi_inf_3dhp_extract(
        dataset_path=d['dhp']['ds_dir'], out_path=out, mode='test'),
}


@pytest.mark.parametrize('name', sorted(EXTRACTORS))
def test_extractor_databases_equal_bit_for_bit(trees, tmp_path, name):
    _, dirs = trees
    out = {}
    for pkg, mods in (('jax', JAX), ('port', PORT)):
        d = tmp_path / pkg
        d.mkdir()
        out[pkg] = EXTRACTORS[name](mods, dirs[pkg], str(d), str(d))
    assert os.path.basename(out['jax']) == os.path.basename(out['port'])
    want = joblib.load(out['jax'])
    with open(out['port'], 'rb') as f:
        got = pickle.load(f)
    assert len(want['imgname']) > 0
    assert_same(got, want)
    assert_same(joblib.load(out['port']), want)


def test_preprocess_cli_synthetic_matches_jax(tmp_path):
    jcli.main(['--synthetic', '--out', str(tmp_path / 'jax')])
    pcli.main(['--synthetic', '--out', str(tmp_path / 'port')])
    names = sorted(f for f in os.listdir(tmp_path / 'jax')
                   if f.endswith('.pt'))
    assert len(names) == 8
    assert names == sorted(f for f in os.listdir(tmp_path / 'port')
                           if f.endswith('.pt'))
    for name in names:
        with open(tmp_path / 'port' / name, 'rb') as f:
            assert_same(pickle.load(f),
                        joblib.load(tmp_path / 'jax' / name), name)


def test_preprocess_cli_synthetic_without_h5py_leaves_out_3dhp_test(
        monkeypatch, tmp_path, capsys):
    """On a machine without h5py everything else is extracted, the same as
    with it."""
    pcli.main(['--synthetic', '--out', str(tmp_path / 'with')])
    monkeypatch.setitem(sys.modules, 'h5py', None)
    pcli.main(['--synthetic', '--out', str(tmp_path / 'without')])
    assert '3DHP test set skipped' in capsys.readouterr().out
    names = sorted(f for f in os.listdir(tmp_path / 'without')
                   if f.endswith('.pt'))
    assert names == sorted(f for f in os.listdir(tmp_path / 'with')
                           if f.endswith('.pt')
                           and f != 'mpi_inf_3dhp_test.pt')
    for name in names:
        with open(tmp_path / 'with' / name, 'rb') as a, \
                open(tmp_path / 'without' / name, 'rb') as b:
            assert_same(pickle.load(b), pickle.load(a), name)


def test_3dhp_frame_extraction_raises_without_cv2(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, 'cv2', None)
    with pytest.raises(ImportError, match='needs cv2'):
        p3dhp.extract_frames(str(tmp_path), 0)
