"""tuch_tpu_torch's cli/export_torch against tuch_tpu's, on the CPU.

The JAX package's ResNet-50 HMR weights (its .npz tree) go through both
packages' export_torch with the same mean params: the two reference-format
files must hold the same entries, and under 'model' the same keys with
equal dtype, shape and value (the weights are copies, so bit for bit).
The port's own checkpoint (train/checkpoint.py) exports too, with its
step. Loading an exported file through the port's runtime (which drops
the init_* buffers and num_batches_tracked) gives the HMR's outputs of
the weights it came from, bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from tests._torch_train_parity import save_jax_npz
from tuch_tpu import runtime as jrt
from tuch_tpu.cli import export_torch as jexport
from tuch_tpu_torch import runtime as prt
from tuch_tpu_torch.cli import export_torch as pexport
from tuch_tpu_torch.train.checkpoint import CheckpointManager
from tuch_tpu_torch.train.module import init_train_state

EXTRA = ('epoch', 'batch_idx', 'batch_size', 'dataset_perm',
         'total_step_count')


@pytest.fixture(scope='module')
def weights(tmp_path_factory):
    d = tmp_path_factory.mktemp('export')
    jr = jrt.build_runtime(synthetic=True, num_verts=170, img_res=64,
                           with_contact=False, with_hd=False)
    save_jax_npz(jax.tree_util.tree_map(np.asarray, jr.variables),
                 d / 'w.npz')
    ex = jr.extras
    np.savez(d / 'means.npz', pose=ex.mean_pose6d[None],
             shape=ex.mean_shape[None], cam=ex.mean_cam)
    return d


def _load(path):
    return torch.load(path, map_location='cpu', weights_only=False)


def test_export_matches_jax_key_by_key(weights, tmp_path):
    argv = ['--checkpoint', str(weights / 'w.npz'), '--mean_params',
            str(weights / 'means.npz')]
    jexport.main(argv + ['--out', str(tmp_path / 'jax.pt')])
    pexport.main(argv + ['--out', str(tmp_path / 'port.pt')])
    want, got = _load(tmp_path / 'jax.pt'), _load(tmp_path / 'port.pt')
    assert set(got) == set(want) == set(EXTRA) | {'model'}
    for k in EXTRA:
        assert got[k] == want[k], k
    assert set(got['model']) == set(want['model'])
    assert {'init_pose', 'init_shape', 'init_cam',
            'layer4.2.bn3.num_batches_tracked'} <= set(got['model'])
    for k, w in want['model'].items():
        g = got['model'][k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(g, w), k


def test_export_of_a_port_checkpoint_reloads_through_runtime(weights,
                                                             tmp_path):
    ref = prt.build_runtime(device='cpu', synthetic=True, num_verts=170,
                            checkpoint=str(weights / 'w.npz'))
    state = init_train_state(ref.hmr, torch.zeros(4, 82), 1e-5)
    state = state._replace(step=7)
    ckpt = CheckpointManager(str(tmp_path / 'ckpts')).save(state, {})
    pexport.main(['--checkpoint', ckpt, '--out', str(tmp_path / 'e.pt'),
                  '--mean_params', str(weights / 'means.npz')])
    out = _load(tmp_path / 'e.pt')
    assert out['total_step_count'] == 7
    np.testing.assert_array_equal(
        out['model']['init_cam'].numpy(),
        np.load(weights / 'means.npz')['cam'].reshape(1, -1))
    again = prt.build_runtime(device='cpu', synthetic=True, num_verts=170,
                              checkpoint=str(tmp_path / 'e.pt'))
    x = torch.from_numpy(np.random.RandomState(0).randn(
        2, 64, 64, 3).astype(np.float32))
    with torch.no_grad():
        for g, w in zip(again.hmr(x), ref.hmr(x)):
            assert torch.equal(g, w)


def test_export_without_mean_params_warns_and_omits_the_buffers(
        weights, tmp_path, capsys):
    pexport.main(['--checkpoint', str(weights / 'w.npz'), '--out',
                  str(tmp_path / 'e.pt')])
    assert 'WARNING: no smpl_mean_params.npz' in capsys.readouterr().out
    assert 'init_pose' not in _load(tmp_path / 'e.pt')['model']
