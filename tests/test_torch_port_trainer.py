"""tuch_tpu_torch's Trainer and cli/train against tuch_tpu's, on the CPU.

The batches each package's Trainer hands its step over one epoch of the
synthetic mix (cli/train's --synthetic data) are equal, fits_index
included: the step is replaced by a recorder that returns the state
unchanged (nothing in tuch_tpu changes; both crop with their default
warp, as in tests/test_torch_port_loader.py). Validation on the same weights
(carried by models/convert) gives the JAX package's v2v and joint error
at rtol 1e-4, and moves neither the BatchNorm statistics nor the dropout
generator. Then the fits store's seeding (checkpoint dir, static dir,
zeros), the flag set and fast_profile against the JAX package's, the
unported mesh raising, and `python -m tuch_tpu_torch.cli.train` on the
CPU at toy size.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests._torch_train_parity import (  # noqa: F401
    few_torch_threads)
from tuch_tpu import config as jcfg
from tuch_tpu import runtime as jrt
from tuch_tpu.data.dataset import TuchDataset as JDataset
from tuch_tpu.data.dataset import project_db_keypoints as \
    j_project_db_keypoints
from tuch_tpu.data.dataset import synthetic_db as j_synthetic_db
from tuch_tpu.data.mixed import MixedDataset as JMixed
from tuch_tpu.train import trainer as JT
from tuch_tpu_torch import config as pcfg
from tuch_tpu_torch.cli import train as ptrain
from tuch_tpu_torch.models import convert as PC
from tuch_tpu_torch.runtime import load_hmr_weights
from tuch_tpu_torch.train import trainer as PT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ['--synthetic', '--synthetic_num_verts', '170', '--img_res', '64',
         '--batch_size', '2', '--num_epochs', '1', '--num_workers', '0']
# validation against the JAX package: v2v and the joint error, relative
VAL_RTOL = 1e-4


pytestmark = pytest.mark.usefixtures('few_torch_threads')


def port_trainer(tmp_path, name, *flags):
    """The port's Trainer as its cli/train builds it, without the renderer
    (as jax_trainer builds the JAX package's)."""
    opts = pcfg.parse_config(pcfg.TrainConfig, SMALL + [
        '--device', 'cpu', '--log_dir', str(tmp_path), '--name', name,
        *flags])
    trainer = ptrain.build(opts)
    trainer.renderer = None
    return trainer


def jax_trainer(tmp_path, name, *flags):
    """The JAX package's Trainer on cli/train's --synthetic data, built as
    its cli/train main builds it (without the renderer)."""
    opts = jcfg.parse_config(jcfg.TrainConfig, SMALL + [
        '--log_dir', str(tmp_path), '--name', name, *flags])
    runtime = jrt.build_runtime(opts, synthetic=True, num_verts=170,
                                img_res=opts.img_res)
    P = len(runtime.contact_classes)
    d = os.path.join(opts.log_dir, 'synthetic_images')
    db = j_synthetic_db(max(4 * opts.batch_size, 8), img_dir=d,
                        seed=opts.seed, num_contact_classes=P)
    if opts.synthetic_projected_kpts:
        db = j_project_db_keypoints(db, runtime.assets.smpl, seed=opts.seed)
    datasets = [JDataset(opts, nm, data=db, img_dir=d, dataset_id=i,
                         num_contact_classes=P)
                for i, nm in enumerate(['dsc_lsp', 'mtp'])]
    val = JDataset(opts, 'mtp', data=db, img_dir=d, use_augmentation=False,
                   split='val', num_contact_classes=P)
    return JT.Trainer(opts, runtime.hmr, runtime.variables, runtime.assets,
                      JMixed(opts, 'train', datasets=datasets), val)


def record_batches(trainer):
    """fit() with a step that records its batch and changes nothing."""
    seen = []

    def step(state, batch, *args, **kw):
        seen.append({k: np.array(v) for k, v in batch.items()})
        return state, {}, {}

    trainer.step_fn = step
    trainer.fit()
    return seen


# keypoints projected from each package's SMPL joints differ by float32
# rounding (in [-1, 1] crop units)
PROJECTED_KPTS_ATOL = 1e-5


@pytest.mark.parametrize('flags', [
    (), ('--seed', '4', '--batch_size', '3', '--no_shuffle_train'),
    ('--synthetic_projected_kpts',)],
    ids=['defaults', 'seed4_b3_no_shuffle', 'projected_kpts'])
def test_trainer_hands_the_jax_batches(tmp_path, flags):
    flags = ('--val_and_checkpoint_freq', '0') + flags
    jt = jax_trainer(tmp_path / 'jax', 'w', *flags)
    pt = port_trainer(tmp_path / 'port', 'w', *flags)
    np.testing.assert_array_equal(pt.offsets_table, jt.offsets_table)
    assert pt.fits_layout.offsets == jt.fits_layout.offsets
    assert tuple(pt.state.fits.shape) == tuple(np.shape(jt.state.fits))
    want, got = record_batches(jt), record_batches(pt)
    assert len(got) == len(want) == pt.loader.num_batches() > 1
    projected = '--synthetic_projected_kpts' in flags
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k == 'keypoints' and projected:
                np.testing.assert_allclose(g[k], w[k], rtol=0,
                                           atol=PROJECTED_KPTS_ATOL)
            else:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    # nothing ran, so nothing was saved
    assert not pt.ckpt.list_checkpoints()


def _last_val(trainer):
    with open(os.path.join(trainer.options.summary_dir,
                           'metrics.jsonl')) as f:
        return [json.loads(x) for x in f if '"val/' in x][-1]


@pytest.mark.parametrize('regressor', [False, True],
                         ids=['v2v_proxy', 'h36m_regressor'])
def test_validate_matches_jax(tmp_path, regressor):
    import jax
    jt = jax_trainer(tmp_path / 'jax', 'v')
    pt = port_trainer(tmp_path / 'port', 'v')
    variables = jax.tree_util.tree_map(
        np.asarray, {'params': jt.state.params,
                     'batch_stats': jt.state.batch_stats})
    load_hmr_weights(pt.model, PC.from_jax_variables(variables))
    if regressor:
        J = pt.assets.smpl.J_regressor[:17].numpy()
        jt.j_regressor_h36m = pt.j_regressor_h36m = J
    stats = {k: v.clone() for k, v in pt.model.named_buffers()}
    gen = pt.state.generator.get_state().clone()
    want = jt.validate(3)
    got = pt.validate(3)
    w, g = _last_val(jt), _last_val(pt)
    name = 'val/mpjpe' if regressor else 'val/mpjpe_v2v_proxy'
    assert set(g) == set(w) == {'step', name, 'val/v2v'}
    for k in (name, 'val/v2v'):
        np.testing.assert_allclose(g[k], w[k], rtol=VAL_RTOL, err_msg=k)
    np.testing.assert_allclose(got, want, rtol=VAL_RTOL)
    for k, v in pt.model.named_buffers():
        assert torch.equal(v, stats[k]), k
    assert torch.equal(pt.state.generator.get_state(), gen)


def test_fits_seeding_priority(tmp_path):
    """{ds}_fits.npy in the checkpoint dir beats static_fits_dir, which
    beats zeros ('none' turns static seeding off)."""
    static_dir = tmp_path / 'static'
    static_dir.mkdir()
    n = 8
    for i, name in enumerate(['dsc_lsp', 'mtp']):
        np.save(static_dir / f'{name}_fits.npy',
                np.full((n, 82), 0.25 + i, np.float32))
    tr = port_trainer(tmp_path, 's', '--static_fits_dir', str(static_dir))
    fits = tr.state.fits.numpy()
    np.testing.assert_array_equal(fits[:n], 0.25)
    np.testing.assert_array_equal(fits[n:], 1.25)

    np.save(os.path.join(tr.options.checkpoint_dir, 'mtp_fits.npy'),
            np.full((n, 82), -0.5, np.float32))
    tr2 = port_trainer(tmp_path, 's', '--static_fits_dir', str(static_dir))
    fits = tr2.state.fits.numpy()
    np.testing.assert_array_equal(fits[:n], 0.25)
    np.testing.assert_array_equal(fits[n:], -0.5)

    tr3 = port_trainer(tmp_path, 's3', '--static_fits_dir', 'none')
    assert float(tr3.state.fits.abs().max()) == 0.0


def test_flags_are_the_jax_packages_plus_device():
    names = {f.name for f in dataclasses.fields(pcfg.TrainConfig)}
    want = {f.name for f in dataclasses.fields(jcfg.TrainConfig)}
    assert names == want | {'device'}
    for f in dataclasses.fields(jcfg.TrainConfig):
        if f.default is not dataclasses.MISSING:
            assert getattr(pcfg.TrainConfig, f.name) == f.default, f.name


@pytest.mark.parametrize('argv', [
    ['--fast_profile'],
    ['--fast_profile', '--contact_candidate_k', '0'],
    ['--fast_profile', '--batch_size', '16',
     '--smplify_exterior_refresh=1'],
    ['--contact_candidate_k', '12']], ids=['profile', 'explicit_k0',
                                          'explicit_refresh', 'no_profile'])
def test_fast_profile_fills_what_jax_fills(tmp_path, argv):
    argv = argv + ['--log_dir', str(tmp_path)]
    j = jcfg.parse_config(jcfg.TrainConfig, argv)
    p = pcfg.parse_config(pcfg.TrainConfig, argv)
    assert p._explicit == j._explicit
    for k in ('smplify_exterior_refresh', 'contact_candidate_k',
              'smplify_contact_capacity', 'regressor_contact_capacity',
              'log_dir', 'summary_dir', 'checkpoint_dir'):
        assert getattr(p, k) == getattr(j, k), k
    with open(os.path.join(p.log_dir, 'config.json')) as f:
        assert json.load(f)['device'] == 'cuda'


@pytest.mark.parametrize('flag', ['--mesh_dp', '--mesh_cp'])
def test_unported_mesh_raises(tmp_path, flag):
    """A 2-rank mesh asked for in one process (no torchrun): the mesh does
    not fit the world size, and the error says how to launch it (the
    working mesh: tests/test_torch_port_parallel_train.py)."""
    with pytest.raises(ValueError, match='torchrun --nproc_per_node 2'):
        port_trainer(tmp_path, 'm', flag, '2')


def test_freq_to_step():
    for freq, n in ((0.5, 100), (1.0, 100), (0.0, 100), (0.3, 7)):
        assert PT.freq_to_step(freq, n) == JT.freq_to_step(freq, n)


def test_train_cli_runs_on_the_cpu(tmp_path):
    """python -m tuch_tpu_torch.cli.train at toy size: one metrics line
    per step, two validations, two checkpoints a resume reads, the fits
    files and the torch.profiler trace TUCH_PROFILE_STEPS asks for;
    without --device cpu it raises on this card-less host."""
    cmd = [sys.executable, '-m', 'tuch_tpu_torch.cli.train', *SMALL,
           '--device', 'cpu', '--run_smplify', '--num_smplify_iters', '2',
           '--log_dir', str(tmp_path), '--name', 'cli']
    env = dict(os.environ, PYTHONPATH=REPO, TUCH_PROFILE_STEPS='1:3',
               OMP_NUM_THREADS='2')   # as few_torch_threads
    out = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    run = tmp_path / 'cli'
    with open(run / 'tensorboard' / 'metrics.jsonl') as f:
        recs = [json.loads(x) for x in f]
    train = [r for r in recs if 'train/loss' in r]
    assert [r['step'] for r in train] == [1, 2, 3, 4]
    assert all(np.isfinite(r['train/loss']) for r in train)
    assert 'train/smplify_accept_rate' in train[0]
    assert len([r for r in recs if 'val/v2v' in r]) == 2
    ckpts = sorted(p.name for p in (run / 'checkpoints').iterdir())
    assert 'dsc_lsp_fits.npy' in ckpts and 'mtp_fits.npy' in ckpts
    assert len([c for c in ckpts if c.endswith('.meta.json')]) == 2
    from tuch_tpu_torch.train.checkpoint import CheckpointManager
    latest = CheckpointManager(str(run / 'checkpoints')).latest()
    assert '_step4_' in latest
    assert torch.load(latest, weights_only=True)['step'] == 4
    # TUCH_PROFILE_STEPS=1:3 traced batches 1 and 2
    assert any(p.name.endswith('.json')
               for p in (run / 'tensorboard' / 'profile').iterdir())

    with pytest.raises(RuntimeError, match="device='cpu'"):
        ptrain.main(SMALL + ['--log_dir', str(tmp_path), '--name', 'gpu'])
    shutil.rmtree(tmp_path, ignore_errors=True)     # 0.62 GB of checkpoints
