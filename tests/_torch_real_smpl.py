"""The real-format asset tree with the full-topology body, and the port's
own preprocessed databases on it (not a test module).

`full_body_tree` writes tests/test_runtime_real_assets.py's `asset_tree`
(that fixture's own code) with the synthetic full-topology body in place of
its 170-vertex one: a real-format SMPL_NEUTRAL.pkl of 6890 vertices and
13776 faces with the fields assets.load_smpl_pkl reads in both packages,
and the geodesics, segments, HD regressor, mean params and prior beside it.
On that body SMPL's 21 surface joints (vertex ids up to 6889) exist, so a
real-format forward runs in both packages.

`real_dbs` adds what cli/train and cli/eval read without --synthetic: the
databases written by the port's `cli/preprocess --synthetic` (plain
pickles) from the raw trees of data/preprocess/synthetic_raw.py, images
for every sample they name (random, from a numpy seed: the raw trees
carry annotations only), the DSC region tables that those databases'
contact vectors index, the H36M regressor, the 3DPW contact signature and
gendered SMPL pickles; both packages' config point at it.
"""

import os
import pickle
from types import SimpleNamespace

import numpy as np
import pytest
from PIL import Image

import tests.test_runtime_real_assets as real_assets
from tests.test_runtime_real_assets import asset_tree  # noqa: F401
from tuch_tpu import assets as jassets
from tuch_tpu import config as jcfg
from tuch_tpu_torch import config as pcfg
from tuch_tpu_torch import constants

PATHS = ('SMPL_MODEL_DIR', 'JOINT_REGRESSOR_TRAIN_EXTRA', 'SMPL_MEAN_PARAMS',
         'PRIOR_FOLDER', 'GEODESICS_SMPL', 'DSC_ROOT', 'SEGMENT_DIR',
         'HD_MODEL_DIR')
# database (as cli/preprocess --synthetic names it) -> (split, dataset,
# image folder under the raw tree, image side in pixels: the raw
# annotations' coordinates fit inside)
DBS = {'dsc_df_train': ('train', 'dsc_df', 'images/df', 320),
       'dsc_lsp_train': ('train', 'dsc_lsp', 'images/lsp', 400),
       'dsc_lspet_train': ('train', 'dsc_lspet', 'images/lspet', 400),
       'mtp_train': ('train', 'mtp', 'mtp/images', None),
       'mtp_val': ('val', 'mtp', 'mtp/images', None),
       '3dpw_test': ('test', '3dpw', '3dpw', 600)}


@pytest.fixture()
def full_body(monkeypatch):
    """asset_tree's module draws the full-topology body in place of its
    170-vertex one (the module's own `assets` name only: nothing else sees
    the change)."""
    def synthetic_smpl(num_verts=None, seed=0, with_contact=True):
        return jassets.synthetic_smpl(constants.SMPL_NUM_VERTS, seed=seed,
                                      with_contact=with_contact)
    monkeypatch.setattr(real_assets, 'assets', SimpleNamespace(
        synthetic_smpl=synthetic_smpl,
        synthetic_gmm_prior=jassets.synthetic_gmm_prior))


@pytest.fixture()
def full_body_tree(full_body, asset_tree, monkeypatch):  # noqa: F811
    """asset_tree at 6890 vertices; the port's config on it too."""
    for name in PATHS:
        monkeypatch.setattr(pcfg, name, getattr(jcfg, name))
    return asset_tree


def _write_images(db, folder, side, seed):
    """A random RGB image (PNG bytes) for every imgname of `db` that has
    none yet."""
    rng = np.random.RandomState(seed)
    for name in db['imgname']:
        path = os.path.join(folder, str(name))
        if os.path.exists(path) and os.path.getsize(path):
            continue
        os.makedirs(os.path.dirname(path), exist_ok=True)
        img = (rng.rand(side, side, 3) * 255).astype(np.uint8)
        Image.fromarray(img).save(path, format='PNG')


@pytest.fixture()
def real_dbs(full_body_tree, tmp_path, monkeypatch):
    """The port's cli/preprocess --synthetic databases on the full-body
    tree, with their images and the eval assets; both packages' config
    (DATASET_FILES, IMAGE_FOLDERS, H36M regressor, 3DPW signature) on it.
    Returns the output directory of the databases."""
    from tuch_tpu_torch.cli import preprocess
    from tuch_tpu_torch.data.dataset import load_db
    from tuch_tpu_torch.data.preprocess import synthetic_raw as sr

    model0, extras, _, _ = full_body_tree
    out = tmp_path / 'dbs'
    preprocess.main(['--synthetic', '--out', str(out)])
    raw = out / 'raw'
    for i, (db_name, (split, dataset, folder, side)) in enumerate(
            DBS.items()):
        path = str(out / f'{db_name}.pt')
        if side is not None:
            _write_images(load_db(path), str(raw / folder), side, seed=i)
        for mod in (jcfg, pcfg):
            monkeypatch.setitem(mod.DATASET_FILES[split], dataset, path)
            monkeypatch.setitem(mod.IMAGE_FOLDERS, dataset,
                                str(raw / folder))

    # the DSC release's region tables: the body-part pairs that the raw
    # tree's tuch_bodypart_pairs.pkl (and so the databases' contact
    # vectors) index, each part one of the body's contact regions
    classes = [tuple(map(str, p)) for p in sr._bodypart_classes()]
    csig = {part: extras.contact_csig[f'reg{i}']
            for i, part in enumerate(sr.BODY_PARTS)}
    with open(os.path.join(jcfg.DSC_ROOT, 'classes.pkl'), 'wb') as f:
        pickle.dump(classes, f)
    with open(os.path.join(jcfg.DSC_ROOT, 'ContactSigSMPL.pkl'), 'wb') as f:
        pickle.dump(csig, f)

    h36m = tmp_path / 'J_regressor_h36m.npy'
    np.save(h36m, np.asarray(model0.J_regressor)[:17])
    n_test = len(load_db(str(out / '3dpw_test.pt'))['imgname'])
    cig = tmp_path / 'csig.npy'
    np.save(cig, np.random.RandomState(1).rand(n_test, 3, 2))
    smpl_dir = jcfg.SMPL_MODEL_DIR
    with open(f'{smpl_dir}/SMPL_NEUTRAL.pkl', 'rb') as f:
        neutral = pickle.load(f)
    for gender, seed in (('MALE', 1), ('FEMALE', 2)):
        m, _ = jassets.synthetic_smpl(constants.SMPL_NUM_VERTS, seed=seed,
                                      with_contact=False)
        with open(f'{smpl_dir}/SMPL_{gender}.pkl', 'wb') as f:
            pickle.dump(dict(neutral, v_template=np.asarray(m.v_template)),
                        f)
    for mod in (jcfg, pcfg):
        monkeypatch.setattr(mod, 'JOINT_REGRESSOR_H36M', str(h36m))
        monkeypatch.setattr(mod, 'THREEDPW_CIG', str(cig))
    return out
