"""tuch_tpu_torch's CheckpointManager, with tests/test_trainer.py's
checkpoint tests on it: ordering of two saves within one second, GC that
keeps the newest and the best, the fallback past a checkpoint that cannot
be read (and no fallback for a given path); the dropout generator restored
only onto the device kind that wrote it; and the three formats
load_variables reads (the JAX package's .npz tree, a reference .pt and a
checkpoint of the port) giving the same HMR. The runs train vit_t8, whose
checkpoints take 19 MB (ResNet-50's 0.31 GB; its BatchNorm statistics
round-trip in tests/test_torch_port_resume.py), and leave nothing behind.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from tests._torch_train_parity import (  # noqa: F401
    few_torch_threads, save_jax_npz)
from tuch_tpu import config as jcfg
from tuch_tpu import runtime as jrt
from tuch_tpu_torch import config as pcfg
from tuch_tpu_torch import runtime as prt
from tuch_tpu_torch.cli import train as ptrain
from tuch_tpu_torch.models import convert as PC
from tuch_tpu_torch.train.checkpoint import CheckpointManager, load_variables

FLAGS = ['--synthetic', '--synthetic_num_verts', '170', '--img_res', '64',
         '--batch_size', '2', '--num_epochs', '1', '--num_workers', '0',
         '--device', 'cpu', '--backbone', 'vit_t8']

pytestmark = pytest.mark.usefixtures('few_torch_threads')


def _commit(tmp_path, name, meta):
    (tmp_path / name).write_bytes(b'')
    (tmp_path / (name + '.meta.json')).write_text(json.dumps(meta))
    return str(tmp_path / name)


def test_checkpoint_ordering_same_second(tmp_path):
    """Two saves within one timestamp second order by step, not by name
    ('step12' < 'step8')."""
    mgr = CheckpointManager(str(tmp_path))
    stamp = '2026_08_17-12_00_00'
    for step in (8, 12):
        _commit(tmp_path, f'{stamp}_step{step}_1.00', {})
    (tmp_path / f'{stamp}_step13_1.00').write_bytes(b'')   # uncommitted
    assert [os.path.basename(c) for c in mgr.list_checkpoints()] == \
        [f'{stamp}_step8_1.00', f'{stamp}_step12_1.00']
    assert mgr.latest().endswith('_step12_1.00')


def test_checkpoint_gc_keeps_best_val(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    names = [_commit(tmp_path, f'2026_08_17-12_00_{i:02d}_step{i + 1}_'
                     f'{err:.2f}', {'step': i + 1, 'val_error': err,
                                    'loader_state': {}})
             for i, err in enumerate([50.0, 10.0, 90.0, 80.0, 70.0])]
    mgr._gc()
    # the newest two (steps 4, 5) and the best (step 2, error 10.0)
    assert mgr.list_checkpoints() == [names[1], names[3], names[4]]
    assert not os.path.exists(names[0]) and not os.path.exists(
        names[0] + '.meta.json')


def _trained(tmp_path):
    """A 4-step run with checkpoints at steps 2 and 4."""
    opts = pcfg.parse_config(pcfg.TrainConfig, FLAGS + [
        '--log_dir', str(tmp_path), '--name', 'r'])
    tr = ptrain.build(opts)
    tr.fit()
    return opts, tr


@pytest.fixture()
def tmp_path(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_restore_falls_back_past_corrupt_checkpoint(tmp_path):
    opts, tr = _trained(tmp_path)
    ckpts = tr.ckpt.list_checkpoints()
    assert len(ckpts) == 2
    with open(ckpts[-1], 'r+b') as f:       # a save cut short
        f.truncate(100)
    opts.resume = True
    tr2 = ptrain.build(opts)
    assert tr2.state.step == 2 and tr2.loader_state.batch_idx == 2
    opts.checkpoint = ckpts[-1]             # a given path fails loudly
    with pytest.raises(RuntimeError):
        ptrain.build(opts)


def test_generator_restores_only_on_its_device_kind(tmp_path):
    opts, tr = _trained(tmp_path)
    path = tr.ckpt.latest()
    ckpt = torch.load(path, weights_only=True)
    assert ckpt['generator_device'] == 'cpu'
    ckpt['generator_device'] = 'cuda'       # as a card would write it
    torch.save(ckpt, path)
    opts.resume, opts.checkpoint = True, path
    with pytest.raises(ValueError, match='device kind'):
        ptrain.build(opts)


def test_load_variables_reads_all_three_formats(tmp_path):
    """The JAX package's variables as its flat .npz tree, as a reference
    .pt ({'model': state_dict}) and inside a port checkpoint load the same
    weights and statistics."""
    jr = jrt.build_runtime(jcfg.TrainConfig(backbone='vit_t8'),
                           synthetic=True, num_verts=170, img_res=64,
                           with_contact=False, with_hd=False)
    variables = jax.tree_util.tree_map(np.asarray, jr.variables)
    save_jax_npz(variables, tmp_path / 'w.npz')
    want = PC.from_jax_variables(variables)
    torch.save({'model': want}, tmp_path / 'w.pt')

    opts, tr = _trained(tmp_path)
    prt.load_hmr_weights(tr.model, want)
    saved = tr.ckpt.save(tr.state, {}, None)
    for path in (tmp_path / 'w.npz', tmp_path / 'w.pt', saved):
        hmr = prt.build_runtime(device='cpu', synthetic=True, num_verts=170,
                                backbone='vit_t8').hmr
        load_variables(str(path), hmr)
        got = hmr.state_dict()
        for k, v in want.items():
            assert torch.equal(got[k], v), (path, k)
