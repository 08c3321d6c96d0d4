"""tuch_tpu_torch's evaluation against tuch_tpu's, on the CPU.

- procrustes: the batched similarity transform and PA error against the
  JAX package's on random joints (one set mirrored, so that the
  reflection fix acts), rtol 1e-5.
- run_evaluation on a synthetic test set for '3dpw' (gendered ground
  truth: male and female synthetic bodies other than the neutral one,
  genders alternating, contact subsets from a cnc array with each kind)
  and 'mpi-inf-3dhp' (the dataset's 3D joints), the same weights carried
  by models/convert: each sample's MPJPE and PA-MPJPE at rtol 1e-4, the
  same report keys and values (rtol 1e-4), and the result_file npz with the
  same keys and shapes. Both packages crop with their default warp, as
  in tests/test_torch_port_loader.py.
- cli/eval: tests/test_torch_port_eval_cli.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_train_parity import (  # noqa: F401
    few_torch_threads)
from tuch_tpu import assets as jassets
from tuch_tpu import runtime as jrt
from tuch_tpu.data.dataset import TuchDataset as JDataset
from tuch_tpu.eval import evaluate as JE
from tuch_tpu.utils import procrustes as JP
from tuch_tpu_torch import assets as passets
from tuch_tpu_torch import runtime as prt
from tuch_tpu_torch.data.dataset import TuchDataset as PDataset
from tuch_tpu_torch.data.dataset import synthetic_db
from tuch_tpu_torch.eval import evaluate as PE
from tuch_tpu_torch.models import convert as PC
from tuch_tpu_torch.models.smpl import SMPL
from tuch_tpu_torch.utils import procrustes as PP

RTOL = 1e-4            # per-sample errors and the report
PROCRUSTES_RTOL = 1e-5
N = 10


pytestmark = pytest.mark.usefixtures('few_torch_threads')


@pytest.fixture(scope='module')
def models():
    jr = jrt.build_runtime(synthetic=True, num_verts=170, img_res=64,
                           with_contact=False, with_hd=False)
    variables = jax.tree_util.tree_map(np.asarray, jr.variables)
    pr = prt.build_runtime(device='cpu', synthetic=True, num_verts=170)
    prt.load_hmr_weights(pr.hmr, PC.from_jax_variables(variables))
    jbodies = [jassets.synthetic_smpl(170, seed=s, with_contact=False)[0]
               for s in (1, 2)]
    pbodies = [SMPL(passets.synthetic_smpl(170, seed=s)[0]) for s in (1, 2)]
    return jr, variables, pr, jbodies, pbodies


def test_procrustes_matches_jax():
    rng = np.random.RandomState(0)
    S1 = rng.randn(16, 14, 3).astype(np.float32)
    S2 = (S1 @ rng.randn(3, 3).astype(np.float32) * 0.7
          + rng.randn(16, 14, 3).astype(np.float32) * 0.1)
    S2[:4] = S1[:4] * np.array([-1, 1, 1], np.float32)     # mirrored
    want = np.asarray(JP.compute_similarity_transform(jnp.asarray(S1),
                                                      jnp.asarray(S2)))
    got = PP.compute_similarity_transform(torch.from_numpy(S1),
                                          torch.from_numpy(S2)).numpy()
    np.testing.assert_allclose(got, want, rtol=PROCRUSTES_RTOL, atol=1e-6)
    for red in (None, 'mean', 'sum'):
        np.testing.assert_allclose(
            PP.reconstruction_error(torch.from_numpy(S1),
                                    torch.from_numpy(S2), red).numpy(),
            np.asarray(JP.reconstruction_error(S1, S2, red)),
            rtol=PROCRUSTES_RTOL)
    np.testing.assert_allclose(
        PP.mpjpe(torch.from_numpy(S1), torch.from_numpy(S2)).numpy(),
        np.asarray(JP.mpjpe(S1, S2)), rtol=PROCRUSTES_RTOL)


@pytest.mark.parametrize('name', ['3dpw', 'mpi-inf-3dhp'])
def test_run_evaluation_matches_jax(models, name, tmp_path, monkeypatch):
    jr, variables, pr, jbodies, pbodies = models
    monkeypatch.chdir(tmp_path)
    db = synthetic_db(N, img_dir=str(tmp_path), seed=0,
                      with_pose_3d=(name == 'mpi-inf-3dhp'))
    db['gender'] = np.array(['m', 'f'] * (N // 2))
    J = np.asarray(jr.smpl.J_regressor)[:17]
    cnc = None
    if name == '3dpw':
        cnc = np.array([np.inf, 0.005, 0.05] * 4)[:N]
    kw = dict(batch_size=4, cnc_arr=cnc, num_workers=0)
    want = JE.run_evaluation(
        jr.hmr, variables, JDataset(None, name, data=db, img_dir=str(tmp_path),
                                    use_augmentation=False, split='test'),
        name, jr.smpl, *jbodies, J, result_file='j.npz', **kw)
    got = PE.run_evaluation(
        pr.hmr, PDataset(None, name, data=db, img_dir=str(tmp_path),
                         use_augmentation=False, split='test'),
        name, pr.smpl, *pbodies, J, result_file='p.npz', **kw)
    assert set(got) == set(want)
    if name == '3dpw':
        assert got['n_contact'] == 3 and got['n_no_contact'] == 4
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=RTOL, err_msg=k)
    j, p = np.load('out/j.npz'), np.load('out/p.npz')
    assert set(p.files) == set(j.files)
    for k in j.files:
        assert p[k].shape == j[k].shape, k
    for k in ('mpjpe', 'recon_err'):
        np.testing.assert_allclose(p[k], j[k], rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(p['pred_joints'], j['pred_joints'], rtol=0,
                               atol=1e-4)


def test_report_with_contact_subsets_matches_jax():
    rng = np.random.RandomState(2)
    err, pa = rng.rand(9), rng.rand(9) * 0.5
    cnc = np.array([np.inf, 0.001, 0.2, np.inf, 0.009, 0.5, 0.01, 1.0, 0.0])
    assert PE.report_with_contact_subsets(err, pa, cnc) == \
        JE.report_with_contact_subsets(err, pa, cnc)
    assert PE.report_with_contact_subsets(err, pa, None) == \
        JE.report_with_contact_subsets(err, pa, None)
