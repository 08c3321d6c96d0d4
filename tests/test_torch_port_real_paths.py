"""The real-data paths of tuch_tpu_torch's cli/train and cli/eval, on the
tree tests/test_runtime_real_assets.py writes (its `asset_tree` fixture:
a 170-vertex SMPL pickle and the contact assets), with preprocessed
dataset files, images, the H36M regressor, the 3DPW contact signature and
gendered SMPL pickles added; both packages' config point at it.

That body has 170 vertices while SMPL's 21 surface joints name vertices up
to 6889: the JAX package clamps those gathers and the port raises, so no
SMPL forward runs here. What is held is the wiring up to the step:
- cli/train without --synthetic hands its step the JAX package's batches
  (MixedDataset(options, 'train') over 'dsc' -> its three subsets and
  'mtp', weighted by size), fits_index included, and validates on 'mtp'
  val with the H36M regressor;
- cli/eval without --synthetic evaluates the 3DPW test set with the file's
  regressor, the contact signature's least distances and the gendered
  bodies (each with the neutral model's extra joint regressor).
"""

import pickle

import numpy as np
import pytest

from tests._torch_train_parity import few_torch_threads  # noqa: F401
from tests.test_runtime_real_assets import asset_tree  # noqa: F401
from tuch_tpu import assets as jassets
from tuch_tpu import config as jcfg
from tuch_tpu import runtime as jrt
from tuch_tpu.data.mixed import MixedDataset as JMixed
from tuch_tpu.train import trainer as JT
from tuch_tpu_torch import config as pcfg
from tuch_tpu_torch.cli import eval as peval_cli
from tuch_tpu_torch.cli import train as ptrain
from tuch_tpu_torch.data.dataset import synthetic_db
from tuch_tpu_torch.eval import evaluate as PE

PATHS = ('SMPL_MODEL_DIR', 'JOINT_REGRESSOR_TRAIN_EXTRA', 'SMPL_MEAN_PARAMS',
         'PRIOR_FOLDER', 'GEODESICS_SMPL', 'DSC_ROOT', 'SEGMENT_DIR',
         'HD_MODEL_DIR')
SIZES = {'dsc_lspet': 6, 'dsc_lsp': 4, 'dsc_df': 2, 'mtp': 8}

pytestmark = pytest.mark.usefixtures('few_torch_threads')


@pytest.fixture()
def tree(asset_tree, tmp_path, monkeypatch):  # noqa: F811
    """The asset tree plus dataset files and eval assets, both packages'
    config on it (each package on its default crop warp)."""
    model0, extras, _, _ = asset_tree
    for name in PATHS:
        monkeypatch.setattr(pcfg, name, getattr(jcfg, name))
    img_dir = tmp_path / 'images'
    dbs = tmp_path / 'dbs'
    dbs.mkdir()
    P = len(extras.contact_classes)
    files = {'train': {}, 'val': {}, 'test': {}}
    for i, (name, n) in enumerate(SIZES.items()):
        files['train'][name] = str(dbs / f'{name}_train.npz')
        np.savez(files['train'][name], **synthetic_db(
            n, img_dir=str(img_dir), seed=10 + i, num_contact_classes=P))
    files['val']['mtp'] = str(dbs / 'mtp_val.npz')
    np.savez(files['val']['mtp'], **synthetic_db(4, img_dir=str(img_dir),
                                                 seed=20))
    db = synthetic_db(6, img_dir=str(img_dir), seed=21)
    db['gender'] = np.array(['m', 'f', 'f', 'm', 'f', 'm'])
    files['test']['3dpw'] = str(dbs / '3dpw_test.npz')
    np.savez(files['test']['3dpw'], **db)
    h36m = tmp_path / 'J_regressor_h36m.npy'
    np.save(h36m, np.asarray(model0.J_regressor)[:17])
    csig = tmp_path / 'csig.npy'
    np.save(csig, np.random.RandomState(1).rand(6, 3, 2))
    smpl_dir = jcfg.SMPL_MODEL_DIR
    with open(f'{smpl_dir}/SMPL_NEUTRAL.pkl', 'rb') as f:
        neutral = pickle.load(f)
    for gender, seed in (('MALE', 1), ('FEMALE', 2)):
        m, _ = jassets.synthetic_smpl(170, seed=seed, with_contact=False)
        with open(f'{smpl_dir}/SMPL_{gender}.pkl', 'wb') as f:
            pickle.dump(dict(neutral, v_template=np.asarray(m.v_template)),
                        f)
    for mod in (jcfg, pcfg):
        for split, entries in files.items():
            for name, path in entries.items():
                monkeypatch.setitem(mod.DATASET_FILES[split], name, path)
        for name in list(SIZES) + ['3dpw']:
            monkeypatch.setitem(mod.IMAGE_FOLDERS, name, str(img_dir))
        monkeypatch.setattr(mod, 'JOINT_REGRESSOR_H36M', str(h36m))
        monkeypatch.setattr(mod, 'THREEDPW_CIG', str(csig))
    return tmp_path


FLAGS = ['--ds_names', 'dsc', 'mtp', '--ds_composition', '0.6', '0.4',
         '--img_res', '64', '--batch_size', '3', '--num_epochs', '1',
         '--num_workers', '0', '--val_and_checkpoint_freq', '0']


def _record(trainer):
    """fit() with a step that records its batch and returns no outputs, so
    no image summary is drawn (the JAX package's Trainer here has no
    renderer either)."""
    seen = []

    def step(state, batch, *a, **kw):
        seen.append(batch)
        return state, {}, {}
    trainer.step_fn = step
    trainer.renderer = None
    trainer.fit()
    return seen


def test_train_real_path_hands_the_jax_batches(tree):
    argv = FLAGS + ['--log_dir', str(tree / 'logs')]
    popts = pcfg.parse_config(pcfg.TrainConfig, argv + ['--name', 'p',
                                                        '--device', 'cpu'])
    pt = ptrain.build(popts)
    jopts = jcfg.parse_config(jcfg.TrainConfig, argv + ['--name', 'j'])
    jr = jrt.build_runtime(jopts, img_res=64)
    P = len(jr.contact_classes)
    jt = JT.Trainer(jopts, jr.hmr, jr.variables, jr.assets,
                    JMixed(jopts, 'train', num_contact_classes=P),
                    JMixed(jopts, 'val', num_contact_classes=P).datasets[0])
    assert pt.train_ds.dataset_list == jt.train_ds.dataset_list == \
        ['mtp', 'dsc_lspet', 'dsc_lsp', 'dsc_df']
    assert pt.train_ds.dataset_sizes() == SIZES
    np.testing.assert_array_equal(pt.train_ds.partition,
                                  jt.train_ds.partition)
    assert len(pt.val_ds) == 4 and pt.j_regressor_h36m.shape[0] == 17
    got, want = _record(pt), _record(jt)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_eval_real_path_wiring(tree, monkeypatch):
    seen = {}

    def capture(hmr, dataset, name, smpl, smpl_m, smpl_f, J, **kw):
        seen.update(dataset=dataset, name=name, smpl=smpl, smpl_m=smpl_m,
                    smpl_f=smpl_f, J=J, **kw)
        return {}
    monkeypatch.setattr(PE, 'run_evaluation', capture)
    peval_cli.main(['--dataset', '3dpw', '--device', 'cpu', '--batch_size',
                    '2', '--num_workers', '0'])
    assert seen['name'] == '3dpw' and len(seen['dataset']) == 6
    assert seen['dataset'].get(1)['gender'] == 1
    np.testing.assert_array_equal(
        seen['cnc_arr'], np.load(pcfg.THREEDPW_CIG).min(1).min(1))
    np.testing.assert_array_equal(seen['J'], np.load(
        pcfg.JOINT_REGRESSOR_H36M))
    for body, seed in ((seen['smpl_m'], 1), (seen['smpl_f'], 2)):
        m, _ = jassets.synthetic_smpl(170, seed=seed, with_contact=False)
        np.testing.assert_array_equal(body.v_template.numpy(),
                                      np.asarray(m.v_template))
        np.testing.assert_array_equal(body.J_regressor_extra.numpy(),
                                      seen['smpl'].J_regressor_extra.numpy())
