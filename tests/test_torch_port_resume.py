"""Resume is exact on the CPU: tuch_tpu_torch's cli/train, --run_smplify
with contact in the loop and the HD contact loss, at 64 px.

Every run's HMR starts its IEF loop from a folding pose, so the contact
losses are live (tests/_torch_train_parity.fold_pose6d). One straight run
of 4 steps (validation and a checkpoint at steps 2 and 4) against runs
stopped early and resumed to step 4: with ResNet-50 (its BatchNorm
statistics too) from the straight run's step-2 checkpoint (--resume
--checkpoint, another log directory); with vit_t8 (a checkpoint of 19 MB,
not ResNet-50's 0.31 GB) after a SIGTERM during step 2 (os.kill from
within fit, as tests/test_trainer.py does) and after the time budget
(--time_to_run 0: one step). The final parameters, BatchNorm statistics,
Adam's mu, nu and count, the fits, the dropout generator's state and the
logged losses of the resumed steps must equal the straight run's bit for
bit. The stopped runs validate and checkpoint on other steps than the
straight run: neither may change the state. A resume under another --seed
keeps the checkpoint's permutation (the same samples in the same order,
and perm_seed saved again); its data and augmentation are drawn from the
new seed, as in the JAX package, so its weights are not compared.
"""

import json
import os
import shutil
import signal

import numpy as np
import pytest
import torch

from tests._torch_train_parity import (  # noqa: F401
    few_torch_threads, fold_pose6d)
from tuch_tpu_torch import config as pcfg
from tuch_tpu_torch import runtime as prt
from tuch_tpu_torch.cli import train as ptrain

FLAGS = ['--synthetic', '--synthetic_num_verts', '170', '--img_res', '64',
         '--batch_size', '2', '--num_epochs', '1', '--num_workers', '0',
         '--device', 'cpu', '--run_smplify', '--num_smplify_iters', '2',
         '--smplify_threshold', '1e9']

pytestmark = pytest.mark.usefixtures('few_torch_threads')


def trainer(log_dir, name, backbone, *flags, record=None, kill_at=None):
    """cli/train.build with FLAGS; record: a list the step's batches'
    sample_index go to; kill_at: the step call during which the process
    sends itself SIGTERM."""
    opts = pcfg.parse_config(pcfg.TrainConfig, FLAGS + [
        '--log_dir', str(log_dir), '--name', name, '--backbone', backbone,
        *flags])
    runtime = prt.build_runtime(device='cpu', synthetic=True, num_verts=170,
                                with_contact=True, with_hd=True,
                                backbone=backbone)
    runtime.hmr.init_pose.copy_(torch.from_numpy(fold_pose6d())[None])
    tr = ptrain.build(opts, runtime)
    step_fn = tr.step_fn
    calls = [0]

    def step(state, batch, *a, **kw):
        calls[0] += 1
        if record is not None:
            record.append(np.array(batch['sample_index']))
        if calls[0] == kill_at:
            os.kill(os.getpid(), signal.SIGTERM)
        return step_fn(state, batch, *a, **kw)

    tr.step_fn = step
    return tr


def fit(tr):
    # a harmless handler for the moment before fit() installs its own
    prev = signal.signal(signal.SIGTERM, lambda *a: None)
    try:
        tr.fit()
    finally:
        signal.signal(signal.SIGTERM, prev)
    return tr


def snapshot(tr):
    s = tr.state
    return dict(
        step=s.step, count=s.opt.count,
        params={k: p.detach().clone() for k, p in s.hmr.named_parameters()},
        buffers={k: b.clone() for k, b in s.hmr.named_buffers()},
        mu={k: v.clone() for k, v in s.opt.mu.items()},
        nu={k: v.clone() for k, v in s.opt.nu.items()},
        fits=s.fits.clone(), generator=s.generator.get_state().clone())


def train_records(tr):
    with open(os.path.join(tr.options.summary_dir, 'metrics.jsonl')) as f:
        recs = [json.loads(x) for x in f]
    return {r['step']: {k: v for k, v in r.items() if k.startswith('train/')
                        and k != 'train/steps_per_sec'}
            for r in recs if 'train/loss' in r}


def assert_same(got, want):
    assert got['step'] == want['step'] == 4
    assert got['count'] == want['count'] == 4
    for part in ('params', 'buffers', 'mu', 'nu'):
        assert set(got[part]) == set(want[part])
        for k, v in want[part].items():
            assert torch.equal(got[part][k], v), (part, k)
    assert torch.equal(got['fits'], want['fits'])
    assert torch.equal(got['generator'], want['generator'])


@pytest.fixture(scope='module')
def straight(tmp_path_factory):
    """backbone -> its straight run, made at first use; the runs' files
    (checkpoints of up to 0.31 GB) go when the module ends."""
    base = tmp_path_factory.mktemp('straight')
    runs = {}

    def get(backbone):
        if backbone not in runs:
            order = []
            tr = fit(trainer(base / backbone, 'a', backbone,
                             '--val_and_checkpoint_freq', '0.5',
                             record=order))
            ckpts = tr.ckpt.list_checkpoints()
            assert [os.path.basename(c).split('_step')[1].split('_')[0]
                    for c in ckpts] == ['2', '4']
            recs = train_records(tr)
            assert sorted(recs) == [1, 2, 3, 4]
            assert recs[4]['train/loss'] != recs[3]['train/loss']
            assert recs[3]['train/loss_contact'] > 0
            runs[backbone] = dict(snap=snapshot(tr), recs=recs,
                                  ckpts=ckpts, order=order)
        return runs[backbone]
    yield get
    shutil.rmtree(base, ignore_errors=True)


def _resumed_the_rest(run, tr, first):
    assert_same(snapshot(tr), run['snap'])
    recs = train_records(tr)
    for s in range(first, 5):
        assert recs[s] == run['recs'][s], s


def test_resume_from_step_2_checkpoint(straight, tmp_path):
    run = straight('resnet50')
    assert len(run['snap']['buffers']) > 100    # the BatchNorm statistics
    tr = trainer(tmp_path, 'c', 'resnet50', '--resume', '--checkpoint',
                 run['ckpts'][0], '--val_and_checkpoint_freq', '0.5')
    assert tr.state.step == 2 and tr.loader_state.batch_idx == 2
    _resumed_the_rest(run, fit(tr), 3)
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_resume_after_sigterm(straight, tmp_path):
    tr = fit(trainer(tmp_path, 's', 'vit_t8', '--val_and_checkpoint_freq',
                     '0', kill_at=2))
    assert tr.state.step == 2
    ckpts = tr.ckpt.list_checkpoints()
    assert len(ckpts) == 1 and '_step2_nan' in ckpts[0]
    with open(ckpts[0] + '.meta.json') as f:
        assert json.load(f)['loader_state'] == {
            'epoch': 0, 'batch_idx': 2, 'perm_seed': 0}
    assert tr.loader_state.batch_idx == 2
    tr2 = trainer(tmp_path, 's', 'vit_t8', '--resume',
                  '--val_and_checkpoint_freq', '0')
    _resumed_the_rest(straight('vit_t8'), fit(tr2), 3)


def test_resume_after_time_budget(straight, tmp_path):
    tr = fit(trainer(tmp_path, 't', 'vit_t8', '--time_to_run', '0'))
    assert tr.state.step == 1 and len(tr.ckpt.list_checkpoints()) == 1
    tr2 = trainer(tmp_path, 't', 'vit_t8', '--resume')
    assert tr2.state.step == 1 and tr2.loader_state.batch_idx == 1
    _resumed_the_rest(straight('vit_t8'), fit(tr2), 2)


def test_resume_under_another_seed_keeps_the_permutation(straight,
                                                        tmp_path):
    order = []
    run = straight('vit_t8')
    tr = trainer(tmp_path, 'o', 'vit_t8', '--resume', '--checkpoint',
                 run['ckpts'][0], '--seed', '5', '--time_to_run', '0',
                 record=order)
    assert tr.loader_state.perm_seed == 0
    fit(tr)   # one step, then the time budget
    assert tr.state.step == 3
    np.testing.assert_array_equal(order[0], run['order'][2])
    with open(tr.ckpt.latest() + '.meta.json') as f:
        assert json.load(f)['loader_state'] == {
            'epoch': 0, 'batch_idx': 3, 'perm_seed': 0}
