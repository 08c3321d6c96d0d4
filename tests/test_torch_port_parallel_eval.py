"""tuch_tpu_torch's evaluation and EFT shards on several processes, on
gloo CPU ranks (tests/_torch_dist.py), against tuch_tpu and the port's
single process.

- The eval step on dp=2 (tests/test_parallel.py's dp-sharded eval step):
  each rank's slice, gathered, against the JAX package's single-device
  step and the port's single process, per image at rtol 1e-4 (the eval
  bar of tests/test_torch_port_eval.py).
- run_evaluation on dp=2 over 12 samples in batches of 8, so that the
  last batch (4) is ragged and runs whole on every rank: the per-image
  MPJPE and reconstruction error of rank 0's result file against the
  JAX package's run and the port's single process (rtol 1e-4); rank 1
  writes nothing.
- cli/eval --mesh_dp 2 against cli/eval in one process (rtol 1e-4).
- cli/fit_eft --auto_shard on 2 processes, then --merge: each process
  fits the shard process_shard gives its rank (ceil split), and the
  merged fits equal one process fitting the same shards with --sidx and
  --cbs, bit for bit. They are not the fits of one process over all the
  images: the head's dropout stream runs per process from --seed, as the
  JAX package's key splits do, so an image's masks depend on its place in
  its shard.
"""

import os

import jax
import numpy as np
import pytest

from tests import _torch_dist as D
from tests._torch_train_parity import (  # noqa: F401
    few_torch_threads, save_jax_npz)
from tuch_tpu import runtime as jrt
from tuch_tpu.data.dataset import TuchDataset as JDataset
from tuch_tpu.eval import evaluate as JE
from tuch_tpu_torch import runtime as prt
from tuch_tpu_torch.cli import eval as peval_cli
from tuch_tpu_torch.cli import fit_eft as pfit_cli
from tuch_tpu_torch.data.dataset import TuchDataset as PDataset
from tuch_tpu_torch.data.dataset import load_db, synthetic_db
from tuch_tpu_torch.eval import evaluate as PE
from tuch_tpu_torch.models import convert as PC

pytestmark = pytest.mark.usefixtures('few_torch_threads')

RTOL = 1e-4
NV, IMG = 170, 64


@pytest.fixture(scope='module')
def models():
    jr = jrt.build_runtime(synthetic=True, num_verts=NV, img_res=IMG,
                           with_contact=False, with_hd=False)
    variables = jax.tree_util.tree_map(np.asarray, jr.variables)
    pr = prt.build_runtime(device='cpu', synthetic=True, num_verts=NV)
    weights = PC.from_jax_variables(variables)
    prt.load_hmr_weights(pr.hmr, weights)
    return jr, variables, pr, weights


@pytest.fixture(scope='module')
def dp_eval(models, tmp_path_factory):
    """The JAX package's and the port's single-process answers, and the
    two ranks' (payload: the batch of the step, the dataset of
    run_evaluation)."""
    jr, variables, pr, weights = models
    d = tmp_path_factory.mktemp('dp_eval')
    rng = np.random.RandomState(0)
    B = 8
    batch = {
        'img': rng.randn(B, IMG, IMG, 3).astype(np.float32) * 0.1,
        'pose_3d': np.concatenate(
            [rng.randn(B, 24, 3) * 0.2, np.ones((B, 24, 1))],
            -1).astype(np.float32)}
    j_reg = np.asarray(jr.smpl.J_regressor)[:17]
    jstep = JE.make_eval_step(jr.hmr, jr.smpl, None, None, j_reg,
                              'mpi-inf-3dhp')
    jm, jpa, *_ = jstep(jr.variables, batch)
    pm, ppa, *_ = PE.make_eval_step(pr.hmr, pr.smpl, None, None, j_reg,
                                    'mpi-inf-3dhp')(batch)
    db = synthetic_db(12, img_dir=str(d), seed=0, with_pose_3d=True,
                      img_size=96)
    cwd = [d / 'r0', d / 'r1', d / 'one', d / 'jax']
    for c in cwd:
        c.mkdir()
    os.chdir(cwd[3])
    JE.run_evaluation(jr.hmr, variables, JDataset(
        None, 'mpi-inf-3dhp', data=db, img_dir=str(d),
        use_augmentation=False, split='test'), 'mpi-inf-3dhp', jr.smpl,
        None, None, j_reg, batch_size=8, result_file='r.npz')
    os.chdir(cwd[2])
    one = PE.run_evaluation(pr.hmr, PDataset(
        None, 'mpi-inf-3dhp', data=db, img_dir=str(d),
        use_augmentation=False, split='test'), 'mpi-inf-3dhp', pr.smpl,
        None, None, j_reg, batch_size=8, num_workers=0, result_file='r.npz')
    out = D.spawn('eval', 2, d, dict(
        dp=2, num_verts=NV, weights=weights, j_reg=j_reg, batch=batch,
        db=db, img_dir=str(d), cwd=[str(c) for c in cwd[:2]]))
    return dict(jax=(np.asarray(jm), np.asarray(jpa)),
                one=(pm.numpy(), ppa.numpy()), one_report=one, ranks=out,
                files={k: np.load(c / 'out' / 'r.npz') for k, c in zip(
                    ('r0', 'one', 'jax'), (cwd[0], cwd[2], cwd[3]))},
                r1=cwd[1])


def test_eval_step_dp_sharded_matches_single_device(dp_eval):
    for r in dp_eval['ranks']:
        for got, jax_want, one in zip((r['mpjpe'], r['pa']), dp_eval['jax'],
                                      dp_eval['one']):
            np.testing.assert_allclose(got.numpy(), jax_want, rtol=RTOL)
            np.testing.assert_allclose(got.numpy(), one, rtol=RTOL)


@pytest.mark.parametrize('key', ['mpjpe', 'recon_err'])
def test_run_evaluation_dp_sharded_ragged(dp_eval, key):
    files = dp_eval['files']
    got = files['r0'][key]
    assert got.shape == (12,)
    np.testing.assert_allclose(got, files['jax'][key], rtol=RTOL)
    np.testing.assert_allclose(got, files['one'][key], rtol=RTOL)
    assert not os.path.exists(dp_eval['r1'] / 'out')   # rank 0 writes
    for r in dp_eval['ranks']:
        for k, v in dp_eval['one_report'].items():
            np.testing.assert_allclose(r['report'][k], v, rtol=RTOL)


def test_eval_cli_mesh_dp2(models, tmp_path):
    """cli/eval --mesh_dp 2 on 2 ranks against one process: the same
    report on every rank (rank 0 prints it)."""
    _, variables, _, _ = models
    save_jax_npz(variables, tmp_path / 'w.npz')
    argv = ['--synthetic', '--synthetic_num_verts', str(NV),
            '--synthetic_samples', '6', '--batch_size', '4',
            '--num_workers', '0', '--dataset', '3dpw', '--device', 'cpu',
            '--checkpoint', str(tmp_path / 'w.npz')]
    os.chdir(tmp_path)
    want = peval_cli.main(argv)
    got = D.spawn('eval_cli', 2, tmp_path, dict(
        cwd=str(tmp_path), argv=argv + ['--mesh_dp', '2']))
    for rep in got:
        assert set(rep) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(rep[k], v, rtol=RTOL, err_msg=k)


EFT_ARGV = ['--synthetic', '--synthetic_num_verts', str(NV), '--img_res',
            str(IMG), '--max_steps', '2', '--device', 'cpu']


def _merged(out_dir, shards):
    pfit_cli.main(EFT_ARGV + ['--out_dir', str(out_dir), '--merge',
                              *map(str, shards)])
    return load_db(str(out_dir / 'dsc_df_eft_train.pt'))


def test_fit_eft_auto_shard_two_processes_then_merge(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    auto, one = tmp_path / 'auto', tmp_path / 'one'
    written = D.spawn('fit_eft', 2, tmp_path, dict(
        cwd=str(tmp_path), argv=EFT_ARGV + ['--auto_shard', '--out_dir',
                                            str(auto)]))
    shards = [auto / f'dsc_df_eft_train_{r}.npz' for r in range(2)]
    assert [w for rank in written for w in rank] == list(map(str, shards))
    for r, path in enumerate(shards):        # 4 images: ranks own 2 each
        with np.load(path) as f:
            assert list(f['indices']) == [2 * r, 2 * r + 1]
    for r in range(2):
        pfit_cli.main(EFT_ARGV + ['--sidx', str(r), '--cbs', '2',
                                  '--out_dir', str(one)])
    got = _merged(auto, shards)
    want = _merged(one, [one / f'dsc_df_eft_train_{r}.npz'
                         for r in range(2)])
    for k in ('pose', 'betas'):
        np.testing.assert_array_equal(got[k], want[k])
        assert np.abs(got[k]).sum() > 0
