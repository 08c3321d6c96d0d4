"""tuch_tpu_torch's demo and rendering path against tuch_tpu's, on the CPU.

cli/demo_tuch --synthetic --device cpu against the JAX package's
cli/demo_tuch on the same weights (its .npz tree as --checkpoint), with
--stack on a prior render of another height: the same files; the OBJ
vertices within 1e-5 m (written at 6 decimals; the forwards agree to
~1e-7 m) and the faces equal; the camera pickle within 1e-5; the input
crop PNG equal; the strip PNG equal but for at most STRIP_EDGE_PIXELS of
its 174,720 pixels (edge pixels of the rasterised body, which a vertex
~1e-7 m away covers or not: 12 differ, by 1 of 255, here). A directory
input pairs OpenPose files by stem and raises on a missing one; the box
readers equal the JAX package's. demo_smplify_dc's renders and the
trainer's image summaries are written.
"""

import glob
import json
import os
import pickle
import shutil

import jax
import numpy as np
import pytest
from PIL import Image

from tests._torch_train_parity import (  # noqa: F401
    few_torch_threads, save_jax_npz)
from tuch_tpu import runtime as jrt
from tuch_tpu.cli import demo_tuch as jdemo
from tuch_tpu_torch import config as pcfg
from tuch_tpu_torch.cli import demo_smplify_dc as pdemo_dc
from tuch_tpu_torch.cli import demo_tuch as pdemo
from tuch_tpu_torch.cli import train as ptrain
from tuch_tpu_torch.train import trainer as PT

pytestmark = pytest.mark.usefixtures('few_torch_threads')

OBJ_ATOL = 1e-5
STRIP_EDGE_PIXELS = 150      # 0.1% of the stacked strip


def _png(path):
    with Image.open(path) as im:
        return np.asarray(im.convert('RGB')).astype(np.int32)


def _obj(path):
    with open(path) as f:
        lines = f.read().splitlines()
    v = np.array([ln.split()[1:] for ln in lines if ln.startswith('v ')],
                 np.float64)
    return v, [ln for ln in lines if ln.startswith('f ')]


@pytest.fixture(scope='module')
def demos(tmp_path_factory):
    d = tmp_path_factory.mktemp('demo')
    jr = jrt.build_runtime(synthetic=True, with_segments=False,
                           with_hd=False, with_contact=False)
    save_jax_npz(jax.tree_util.tree_map(np.asarray, jr.variables),
                 d / 'w.npz')
    eft_dir = d / 'eft'
    eft_dir.mkdir()
    Image.fromarray((np.random.RandomState(3).rand(100, 80, 3) * 255)
                    .astype(np.uint8)).save(eft_dir / 'synthetic_input.png')
    argv = ['--synthetic', '--checkpoint', str(d / 'w.npz'), '--stack',
            'true', '--eft_img_dir', str(eft_dir), '--spin_img_dir',
            str(d / 'missing')]
    jdemo.main(argv + ['--outdir', str(d / 'jax')])
    records = pdemo.main(argv + ['--outdir', str(d / 'port'), '--device',
                                 'cpu'])
    return d, records


def test_demo_tuch_files_match_jax(demos):
    d, records = demos
    names = sorted(os.listdir(d / 'jax'))
    assert names == sorted(os.listdir(d / 'port'))
    assert {'synthetic_input.obj', 'synthetic_input_r60.obj',
            'synthetic_input_r300.obj', 'synthetic_input_camera.pkl',
            'synthetic_input_img_in.png', 'synthetic_input.png'} <= set(names)
    for name in names:
        want, got = d / 'jax' / name, d / 'port' / name
        if name.endswith('.obj'):
            (wv, wf), (gv, gf) = _obj(want), _obj(got)
            assert gf == wf and gv.shape == wv.shape == (6890, 3)
            np.testing.assert_allclose(gv, wv, rtol=0, atol=OBJ_ATOL,
                                       err_msg=name)
        elif name.endswith('.pkl'):
            with open(want, 'rb') as f, open(got, 'rb') as g:
                w, p = pickle.load(f), pickle.load(g)
            assert set(w) == set(p)
            for k in w:
                np.testing.assert_allclose(p[k], w[k], rtol=1e-5, atol=1e-5,
                                           err_msg=k)
        elif name == 'synthetic_input.png':
            w, p = _png(want), _png(got)
            assert w.shape == p.shape == (224, 224 * 3 + 179, 3)
            off = (w != p).any(-1)
            assert off.sum() <= STRIP_EDGE_PIXELS, off.sum()
            assert not off[:, :224].any()           # the input tile
        else:
            np.testing.assert_array_equal(_png(got), _png(want),
                                          err_msg=name)
    (stem, verts, cam_t, times), = records
    assert stem == str(d / 'port' / 'synthetic_input')
    assert np.isfinite(verts).all() and set(times) == set(pdemo.PARTS)


def test_directory_input_pairs_openpose_by_stem(demos, tmp_path):
    d, _ = demos
    imgs, ops = tmp_path / 'imgs', tmp_path / 'ops'
    imgs.mkdir()
    ops.mkdir()
    src = d / 'port' / 'synthetic_input_img_in.png'
    kp = np.random.RandomState(5).rand(25, 3) * [150, 150, 1] + [30, 30, 0]
    for stem in ('a', 'b'):
        shutil.copy(src, imgs / f'{stem}.png')
    with open(ops / 'a_keypoints.json', 'w') as f:
        json.dump({'people': [{'pose_keypoints_2d': kp.ravel().tolist()}]},
                  f)
    with open(ops / 'b.json', 'w') as f:
        json.dump({'people': [{'pose_keypoints_2d': kp.ravel().tolist()}]},
                  f)
    paths = sorted(glob.glob(str(imgs / '*')))
    assert pdemo.pair_openpose(paths, str(ops)) == [
        str(ops / 'a_keypoints.json'), str(ops / 'b.json')]
    for fn in ('bbox_from_openpose', 'bbox_from_json'):
        arg = str(ops / 'b.json')
        if fn == 'bbox_from_json':
            arg = str(tmp_path / 'box.json')
            with open(arg, 'w') as f:
                json.dump({'bbox': [10, 20, 100, 150]}, f)
        for a, b in zip(getattr(pdemo, fn)(arg), getattr(jdemo, fn)(arg)):
            np.testing.assert_array_equal(a, b)
    records = pdemo.main(['--synthetic', '--img', str(imgs), '--openpose',
                          str(ops), '--outdir', str(tmp_path / 'out'),
                          '--outfile', 'res', '--device', 'cpu'])
    assert [os.path.basename(r[0]) for r in records] == ['res_000',
                                                         'res_001']
    assert os.path.isfile(tmp_path / 'out' / 'res_001_r300.obj')
    os.remove(ops / 'b.json')
    with pytest.raises(FileNotFoundError, match='no openpose json'):
        pdemo.main(['--synthetic', '--img', str(imgs), '--openpose',
                    str(ops), '--outdir', str(tmp_path / 'out2'),
                    '--device', 'cpu'])


@pytest.mark.parametrize('out_dir', ['', 'renders'])
def test_demo_smplify_dc_writes_its_renders(tmp_path, out_dir):
    argv = ['--synthetic', '--device', 'cpu', '--synthetic_num_verts', '170',
            '--img_res', '64', '--num_images', '2', '--num_smplify_iters',
            '2', '--log_dir', str(tmp_path / 'logs'), '--name', 'dc']
    if out_dir:
        argv += ['--out_dir', str(tmp_path / out_dir)]
    pdemo_dc.main(argv)
    where = tmp_path / (out_dir or 'logs/dc')
    for i in range(2):
        fit, opti = (_png(where / f'{i:04d}_{k}.png') for k in ('fit',
                                                                'opti'))
        assert fit.shape == (64, 3 * 64, 3) and opti.shape == (64, 4 * 64, 3)
        assert fit.std() > 0


def test_trainer_draws_its_image_summaries(tmp_path, monkeypatch):
    """Without TensorBoard the summaries are PNGs under summary_dir/images:
    the predicted and fitted bodies every summary_freq of an epoch and the
    predicted body after each validation; with it, add_image."""
    import sys
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    opts = pcfg.parse_config(pcfg.TrainConfig, [
        '--synthetic', '--synthetic_num_verts', '170', '--img_res', '64',
        '--batch_size', '2', '--num_epochs', '1', '--num_workers', '0',
        '--device', 'cpu', '--log_dir', str(tmp_path), '--name', 'sum',
        '--run_smplify', '--num_smplify_iters', '1', '--summary_freq',
        '0.5', '--val_and_checkpoint_freq', '0.5'])
    tr = ptrain.build(opts)
    assert tr.renderer is not None and tr.logger.tb is None
    tr.fit()
    tr.close()
    got = sorted(os.listdir(os.path.join(opts.summary_dir, 'images')))
    assert got == sorted(f'{tag}_{s}.png' for s in (2, 4) for tag in (
        'train_pred_shape', 'train_opt_shape', 'val_pred_shape'))
    img = _png(os.path.join(opts.summary_dir, 'images', got[0]))
    assert img.shape == (64, 64, 3)

    calls = []

    class Board:
        def add_image(self, tag, img, step, dataformats):
            calls.append((tag, img.shape, step, dataformats))

    logger = PT.MetricsLogger(str(tmp_path / 'tb'))
    logger.tb = Board()
    logger.image('val/pred_shape', np.zeros((8, 8, 3), np.float32), 7)
    assert calls == [('val/pred_shape', (8, 8, 3), 7, 'HWC')]
