"""Runtime assembly: body model, HMR with its weights, contact assets.

Counterpart of tuch_tpu/runtime.py build_runtime: the real SMPL assets when
present (or on request), else the synthetic stand-in; HMR with random
weights from a seed, replaced by a checkpoint (a reference .pt or the JAX
package's .npz tree) when one is given. With contact on, the GMM pose
prior and the contact assets (geodesic mask, faces, region and segment
tables) are built too and held on the device; serving leaves it off and
never builds the (V, V) geodesic matrix.
"""

import os
import pickle
from typing import NamedTuple, Optional

import numpy as np

from tuch_tpu_torch import assets as assets_mod
from tuch_tpu_torch import config as cfg
from tuch_tpu_torch import constants, resolve_device
from tuch_tpu_torch.losses.prior import GMMPrior, create_gmm_prior
from tuch_tpu_torch.losses.smplify import ContactAssets
from tuch_tpu_torch.models import hmr as hmr_mod
from tuch_tpu_torch.models.convert import (contact_assets_from_numpy,
                                           load_checkpoint)
from tuch_tpu_torch.models.smpl import SMPL
from tuch_tpu_torch.ops.contact import build_region_pairs
from tuch_tpu_torch.ops.segments import build_segment_tables

# Reference checkpoint entries that are not weights of this model: the IEF
# init buffers (the runtime's mean params are used, as in the JAX package)
# and BatchNorm's step counter.
_IGNORED_KEYS = ('init_pose', 'init_shape', 'init_cam')


class Runtime(NamedTuple):
    smpl: SMPL
    hmr: hmr_mod.HMR
    # with contact only (None / empty otherwise)
    contact: Optional[ContactAssets] = None
    prior: Optional[GMMPrior] = None
    contact_classes: tuple = ()


def load_hmr_weights(hmr: hmr_mod.HMR, state_dict) -> None:
    """Load a state dict into HMR; BatchNorm running statistics missing
    from it keep their current values, anything else missing raises."""
    sd = {k: v for k, v in state_dict.items()
          if k not in _IGNORED_KEYS and not k.endswith('num_batches_tracked')}
    missing, unexpected = hmr.load_state_dict(sd, strict=False)
    missing = [k for k in missing
               if not k.endswith(('running_mean', 'running_var',
                                  'num_batches_tracked'))]
    if missing or unexpected:
        raise KeyError(f'checkpoint does not fit HMR: missing {missing}, '
                       f'unexpected {unexpected}')


def build_runtime(device=None, synthetic: Optional[bool] = None,
                  num_verts: Optional[int] = None,
                  backbone: str = 'resnet50',
                  checkpoint: Optional[str] = None,
                  with_contact: bool = False,
                  with_segments: bool = True) -> Runtime:
    """Build SMPL and HMR in eval mode on `device` (CUDA by default), and
    with_contact the GMM prior and the contact assets.

    synthetic=None picks the real assets when SMPL_NEUTRAL.pkl exists and
    says which it picked. The synthetic body, its contact extras and prior,
    and the random weights all come from seed 0.
    """
    dev = resolve_device(device)
    if synthetic is None:
        neutral = os.path.join(cfg.SMPL_MODEL_DIR, 'SMPL_NEUTRAL.pkl')
        synthetic = not os.path.isfile(neutral)
        print(f'[tuch_tpu_torch.runtime] auto-selected '
              f'{"SYNTHETIC stand-in" if synthetic else "real"} assets '
              f'({neutral} {"missing" if synthetic else "found"})',
              flush=True)
    extras = gmm = None
    if synthetic:
        nv = num_verts or constants.SMPL_NUM_VERTS
        smpl_model, means = assets_mod.synthetic_smpl(num_verts=nv)
        if with_contact:
            extras = assets_mod.synthetic_contact(nv)
            gmm = assets_mod.synthetic_gmm_prior()
    else:
        smpl_model = assets_mod.load_smpl_pkl(os.path.join(
            cfg.SMPL_MODEL_DIR, 'SMPL_NEUTRAL.pkl'))
        if os.path.isfile(cfg.JOINT_REGRESSOR_TRAIN_EXTRA):
            smpl_model = assets_mod.load_extra_joint_regressor(
                smpl_model, cfg.JOINT_REGRESSOR_TRAIN_EXTRA)
        means = assets_mod.load_mean_params(cfg.SMPL_MEAN_PARAMS)
        if with_contact:
            extras = _load_real_contact()
            gmm = assets_mod.load_gmm_prior(os.path.join(
                cfg.PRIOR_FOLDER, 'gmm_08.pkl'))

    hmr = hmr_mod.create_hmr(*means, backbone=backbone)
    hmr_mod.init_weights(hmr)
    if checkpoint:
        load_hmr_weights(hmr, load_checkpoint(checkpoint))
    runtime = Runtime(smpl=SMPL(smpl_model).to(dev).eval(),
                      hmr=hmr.to(dev).eval())
    if not with_contact:
        return runtime

    ia, ib, ma, mb = build_region_pairs(extras.contact_classes,
                                        extras.contact_csig)
    tables = None
    if with_segments and extras.segments:
        tables = build_segment_tables(extras.segments, smpl_model.faces,
                                      smpl_model.v_template.shape[0])
    contact = contact_assets_from_numpy(
        {'geomask': extras.geodists > cfg.geothres,
         'faces': smpl_model.faces, 'region_idx_a': ia, 'region_idx_b': ib,
         'region_mask_a': ma, 'region_mask_b': mb}, tables, device=dev)
    return runtime._replace(
        contact=contact, prior=create_gmm_prior(gmm, device=dev),
        contact_classes=tuple(extras.contact_classes))


def _load_real_contact() -> assets_mod.ContactExtras:
    """Geodesic distances and the region tables of the real assets (the
    reference's body segments are not read: segments stay off)."""
    with open(os.path.join(cfg.DSC_ROOT, 'classes.pkl'), 'rb') as f:
        classes = pickle.load(f)
    with open(os.path.join(cfg.DSC_ROOT, 'ContactSigSMPL.pkl'), 'rb') as f:
        csig = pickle.load(f)
    return assets_mod.ContactExtras(
        geodists=np.load(cfg.GEODESICS_SMPL), segments={},
        contact_classes=list(classes), contact_csig=csig)
