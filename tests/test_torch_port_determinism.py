"""runtime.deterministic, the setting that makes the training entry points'
card runs repeat bit for bit (torch only; its effect on the card is held by
chip_smoke.py phase 13 and tools/determinism_settings.py).

For a CUDA device it turns on torch's deterministic algorithms (warning,
not raising, for an op without a deterministic form), cuDNN's
deterministic convolutions without benchmarking, the fixed cuBLAS
workspace (unless one is set) and leaves torch.empty unfilled; for the CPU
it changes nothing. cli/train's build and cli/fit_eft call it with their
device before they build anything.
"""

import pytest
import torch

from tuch_tpu_torch import runtime as rt


@pytest.fixture()
def flags(monkeypatch):
    """Record use_deterministic_algorithms; every flag restored after."""
    calls = []
    monkeypatch.setattr(torch, 'use_deterministic_algorithms',
                        lambda *a, **kw: calls.append((a, kw)))
    monkeypatch.setattr(torch.backends.cudnn, 'deterministic', False)
    monkeypatch.setattr(torch.backends.cudnn, 'benchmark', True)
    monkeypatch.setattr(torch.utils.deterministic,
                        'fill_uninitialized_memory', True)
    monkeypatch.delenv('CUBLAS_WORKSPACE_CONFIG', raising=False)
    return calls


def test_deterministic_sets_the_card_flags_and_leaves_the_cpu(flags):
    import os
    rt.deterministic('cpu')
    rt.deterministic(torch.device('cpu'))
    assert flags == [] and torch.backends.cudnn.benchmark
    assert 'CUBLAS_WORKSPACE_CONFIG' not in os.environ
    rt.deterministic('cuda')
    assert flags == [((True,), {'warn_only': True})]
    assert torch.backends.cudnn.deterministic
    assert not torch.backends.cudnn.benchmark
    assert not torch.utils.deterministic.fill_uninitialized_memory
    assert os.environ['CUBLAS_WORKSPACE_CONFIG'] == ':4096:8'


def test_deterministic_keeps_a_workspace_the_caller_set(flags,
                                                        monkeypatch):
    import os
    monkeypatch.setenv('CUBLAS_WORKSPACE_CONFIG', ':16:8')
    rt.deterministic('cuda:0')
    assert os.environ['CUBLAS_WORKSPACE_CONFIG'] == ':16:8'


def test_training_entry_points_call_it_with_their_device(monkeypatch,
                                                          tmp_path):
    from tuch_tpu_torch import config as cfg
    from tuch_tpu_torch.cli import fit_eft
    from tuch_tpu_torch.cli import train as train_cli
    seen = []
    monkeypatch.setattr(rt, 'deterministic', lambda dev: seen.append(
        torch.device(dev)))
    monkeypatch.chdir(tmp_path)
    train_cli.build(cfg.parse_config(cfg.TrainConfig, [
        '--synthetic', '--device', 'cpu', '--synthetic_num_verts', '170',
        '--img_res', '64', '--batch_size', '2', '--num_epochs', '1',
        '--backbone', 'vit_t8', '--log_dir', str(tmp_path / 'logs')]))
    fit_eft.main(['--synthetic', '--device', 'cpu', '--synthetic_num_verts',
                  '170', '--img_res', '64', '--cbs', '1', '--max_steps', '1',
                  '--out_dir', str(tmp_path / 'eft')])
    assert seen == [torch.device('cpu')] * 2
