"""tuch_tpu_torch's cli/parity on the CPU: the port's HMR against the
reference's functional graph (models/torch_ref.py), and the recorded skip.

No SPIN checkpoint is in the repository, so the network mode runs on
random weights: the port's own ResNet-50 HMR's (with the init_* buffers
the reference carries) and the JAX package's reference-shaped fake state
dict; a graph that differs (two IEF iterations for three) fails the
gate. The
full-pipeline mode (--ref_dump) runs on the real-format full-topology
body of tests/_torch_real_smpl.py, against a dump in the reference's
format made by the JAX package's runtime on the same weights (vertices at
the gate's 1e-3 m).
"""

import re
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_real_smpl import (asset_tree, full_body,  # noqa: F401
                                    full_body_tree)
from tests._torch_train_parity import few_torch_threads  # noqa: F401
from tests.test_cli_viz import fake_torch_state_dict
from tuch_tpu import runtime as jrt
from tuch_tpu.models.smpl import smpl_forward as jsmpl_forward
from tuch_tpu_torch import config as pcfg
from tuch_tpu_torch import runtime as prt
from tuch_tpu_torch.cli import parity
from tuch_tpu_torch.models import torch_ref
from tuch_tpu_torch.models.convert import from_jax_variables

pytestmark = pytest.mark.usefixtures('few_torch_threads')


def _deltas(out):
    return {k: float(v) for k, v in re.findall(
        r'\] (\S+): max \|delta\| = ([-\d.e+]+)', out)}


def _save(sd, path):
    torch.save({'model': {k: torch.as_tensor(np.ascontiguousarray(v))
                          for k, v in sd.items()}}, path)
    return str(path)


def test_network_mode_on_the_ports_random_weights(tmp_path, capsys):
    rt = prt.build_runtime(device='cpu', synthetic=True, num_verts=170)
    sd = dict(rt.hmr.state_dict())
    for name in ('init_pose', 'init_shape', 'init_cam'):
        sd[name] = getattr(rt.hmr, name)
    path = _save(sd, tmp_path / 'port.pt')
    assert parity.main(['--checkpoint', path, '--device', 'cpu']) == 0
    got = _deltas(capsys.readouterr().out)
    assert set(got) == {'rotmat', 'betas', 'cam'}
    assert max(got.values()) < parity.PARAM_TOL


def test_network_mode_on_a_reference_state_dict(tmp_path, capsys,
                                                monkeypatch):
    _, extras = prt.assets_mod.synthetic_smpl(num_verts=170)
    sd = fake_torch_state_dict()
    sd['init_pose'], sd['init_shape'], sd['init_cam'] = (
        np.asarray(x, np.float32)[None] for x in extras)
    path = _save(sd, tmp_path / 'ref.pt')
    assert parity.main(['--checkpoint', path, '--device', 'cpu']) == 0
    assert max(_deltas(capsys.readouterr().out).values()) < parity.PARAM_TOL
    monkeypatch.setattr(torch_ref, 'torch_ief_head', partial(
        torch_ref.torch_ief_head, n_iter=2))
    assert parity.main(['--checkpoint', path, '--device', 'cpu']) == 1
    assert 'FAIL' in capsys.readouterr().out


def test_parity_cli_skips_cleanly(monkeypatch, tmp_path, capsys):
    argv = ['--device', 'cpu']
    # an explicitly passed missing path errors (rc 2), never skips
    assert parity.main(argv + ['--checkpoint', '/nonexistent/c.pt']) == 2
    assert parity.main(argv + ['--checkpoint', '/nonexistent/c.pt',
                               '--ref_dump', '/nonexistent/p.npz']) == 2
    dump = tmp_path / 'parity.npz'
    np.savez(str(dump), n=np.asarray(0))
    assert parity.main(argv + ['--checkpoint', '/nonexistent/c.pt',
                               '--ref_dump', str(dump)]) == 2
    assert parity.main(argv + ['--ref_dump', str(dump)]) == 2
    # without --checkpoint and no default asset: the recorded skip
    monkeypatch.setattr(pcfg, 'SPIN_MODEL_CHECKPOINT', '/nonexistent/s.pt')
    assert parity.main(argv) == 0
    assert 'SKIP: no reference checkpoint found' in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parity.main([])


def test_full_pipeline_mode_against_a_dump(full_body_tree, tmp_path,
                                           capsys):
    jr = jrt.build_runtime(synthetic=False, with_segments=False,
                           with_hd=False, with_contact=False)
    variables = jr.variables
    sd = {k: v.numpy() for k, v in from_jax_variables(
        jax.tree_util.tree_map(np.asarray, variables)).items()}
    path = _save(sd, tmp_path / 'w.pt')
    rng = np.random.RandomState(0)
    rec = {'n': np.asarray(2)}
    for i in range(2):
        norm = (rng.randn(224, 224, 3) * 0.5).astype(np.float32)
        rotmat, betas, cam = jr.hmr.apply(
            variables, jnp.asarray(norm)[None], train=False)
        out = jsmpl_forward(jr.smpl, betas, rotmat[:, 1:], rotmat[:, :1],
                            pose2rot=False)
        rec.update({f'img{i}_norm': norm, f'img{i}_rotmat': rotmat,
                    f'img{i}_betas': betas, f'img{i}_cam': cam,
                    f'img{i}_vertices': out.vertices})
    np.savez(tmp_path / 'parity.npz',
             **{k: np.asarray(v) for k, v in rec.items()})
    assert parity.main(['--checkpoint', path, '--ref_dump',
                        str(tmp_path / 'parity.npz'), '--device',
                        'cpu']) == 0
    got = _deltas(capsys.readouterr().out)
    assert set(got) == {'rotmat', 'betas', 'cam', 'vertices'}
    assert got['vertices'] < parity.VERT_TOL
    assert np.asarray(rec['img0_vertices']).shape == (1, 6890, 3)
