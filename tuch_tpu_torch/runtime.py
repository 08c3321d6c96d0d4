"""Runtime assembly: body model, HMR with its weights, contact assets.

Counterpart of tuch_tpu/runtime.py build_runtime: the real SMPL assets when
present (or on request), else the synthetic stand-in; HMR with random
weights from a seed, replaced by a checkpoint (a reference .pt or the JAX
package's .npz tree) when one is given. With contact on, the GMM pose
prior and the contact assets (geodesic mask, faces, region and segment
tables) are built too and held on the device; serving leaves it off and
never builds the (V, V) geodesic matrix. With HD on, the dense surface of
the training step's contact loss is built too (losses/regressor.HDAssets).
``dtype`` is HMR's compute dtype (the JAX runtime's ``compute_dtype``); its
weights load as float32 either way. ``stem_s2d`` is accepted and builds the
plain stem (models/hmr says why); ``bn_fold`` folds the
eval-mode BatchNorm into the convolutions after the checkpoint is loaded,
for serving and evaluation (as the JAX package's cli/serve and cli/eval).
"""

import os
import pickle
from typing import NamedTuple, Optional

import numpy as np
import torch

from tuch_tpu_torch import assets as assets_mod
from tuch_tpu_torch import config as cfg
from tuch_tpu_torch import constants, resolve_device
from tuch_tpu_torch.losses.prior import GMMPrior, create_gmm_prior
from tuch_tpu_torch.losses.regressor import (HDAssets, compact_hd_regressor,
                                             make_hd_assets_compact)
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

# the names the CLIs take for HMR's compute dtype
COMPUTE_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


class Runtime(NamedTuple):
    smpl: SMPL
    hmr: hmr_mod.HMR
    # with contact only (None / empty otherwise)
    contact: Optional[ContactAssets] = None
    prior: Optional[GMMPrior] = None
    contact_classes: tuple = ()
    contact_csig: dict = {}            # region name -> vertex ids
    hd: Optional[HDAssets] = None      # with HD only


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
                  with_segments: bool = True,
                  dtype: str = 'float32',
                  with_hd: bool = False, stem_s2d: bool = False,
                  bn_fold: bool = False) -> Runtime:
    """Build SMPL and HMR in eval mode on `device` (CUDA by default);
    with_contact adds the GMM prior and the contact assets, with_hd the HD
    surface. HMR computes in `dtype` ('float32' or 'bfloat16', a key of
    COMPUTE_DTYPES), folded (inference only) if bn_fold; stem_s2d is
    recorded on the HMR and changes nothing else.

    synthetic=None picks the real assets when SMPL_NEUTRAL.pkl exists and
    says which it picked. The synthetic body, its contact extras and prior,
    and the random weights all come from seed 0.
    """
    dev = resolve_device(device)
    if dtype not in COMPUTE_DTYPES:
        raise ValueError(f'unknown compute dtype {dtype!r}; have '
                         f'{sorted(COMPUTE_DTYPES)}')
    if synthetic is None:
        neutral = os.path.join(cfg.SMPL_MODEL_DIR, 'SMPL_NEUTRAL.pkl')
        synthetic = not os.path.isfile(neutral)
        print(f'[tuch_tpu_torch.runtime] auto-selected '
              f'{"SYNTHETIC stand-in" if synthetic else "real"} assets '
              f'({neutral} {"missing" if synthetic else "found"})',
              flush=True)
    extras = gmm = hd_compact = None
    if synthetic:
        nv = num_verts or constants.SMPL_NUM_VERTS
        smpl_model, means = assets_mod.synthetic_smpl(num_verts=nv)
        if with_contact or with_hd:
            extras = assets_mod.synthetic_contact(
                nv, with_geodists=with_contact)
            hd_compact = (extras.hd_vert_ids, extras.hd_bary,
                          extras.hd_geovec)
        if with_contact:
            gmm = assets_mod.synthetic_gmm_prior()
    else:
        smpl_model = assets_mod.load_smpl_pkl(os.path.join(
            cfg.SMPL_MODEL_DIR, 'SMPL_NEUTRAL.pkl'))
        if os.path.isfile(cfg.JOINT_REGRESSOR_TRAIN_EXTRA):
            smpl_model = assets_mod.load_extra_joint_regressor(
                smpl_model, cfg.JOINT_REGRESSOR_TRAIN_EXTRA)
        means = assets_mod.load_mean_params(cfg.SMPL_MEAN_PARAMS)
        if with_contact:
            extras = _load_real_contact(with_segments)
            gmm = assets_mod.load_gmm_prior(os.path.join(
                cfg.PRIOR_FOLDER, 'gmm_08.pkl'))
        if with_hd:
            hd_compact = _load_real_hd()

    hmr = hmr_mod.create_hmr(*means, backbone=backbone,
                             dtype=COMPUTE_DTYPES[dtype], stem_s2d=stem_s2d)
    hmr_mod.init_weights(hmr)
    if checkpoint:
        load_hmr_weights(hmr, load_checkpoint(checkpoint))
    if bn_fold:
        hmr = hmr_mod.folded(hmr)
    hd = None if hd_compact is None else make_hd_assets_compact(
        *hd_compact, smpl_model.faces, device=dev)
    runtime = Runtime(smpl=SMPL(smpl_model).to(dev).eval(),
                      hmr=hmr.to(dev).eval(), hd=hd)
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
        contact_classes=tuple(extras.contact_classes),
        contact_csig=dict(extras.contact_csig))


def _load_real_contact(with_segments: bool) -> assets_mod.ContactExtras:
    """Geodesic distances and the region tables of the real assets, and
    with_segments the body segments when their files are on disk (else
    segments stay off, as in the JAX package, and a line says so)."""
    with open(os.path.join(cfg.DSC_ROOT, 'classes.pkl'), 'rb') as f:
        classes = pickle.load(f)
    with open(os.path.join(cfg.DSC_ROOT, 'ContactSigSMPL.pkl'), 'rb') as f:
        csig = pickle.load(f)
    segments = _load_real_segments() if with_segments else None
    if with_segments and not segments:
        print(f'[tuch_tpu_torch.runtime] body segments off '
              f'({os.path.join(cfg.SEGMENT_DIR, "segm_utils.py")} or its '
              f'smpl_segment_*.ply missing)', flush=True)
    return assets_mod.ContactExtras(
        geodists=np.load(cfg.GEODESICS_SMPL), segments=segments or {},
        contact_classes=list(classes), contact_csig=csig)


def _load_real_hd():
    """The real HD surface, (vert_ids, bary, geovec): the (H, V) upsampling
    regressor compacted to 4 weights a point, and the face each point
    samples from. As in the JAX runtime, a missing file raises."""
    hd_reg = np.load(os.path.join(cfg.HD_MODEL_DIR,
                                  'smpl_neutral_hd_vert_regressor.npy'))
    with open(os.path.join(cfg.HD_MODEL_DIR,
                           'smpl_neutral_hd_sample_from_mesh_out.pkl'),
              'rb') as f:
        geovec = np.asarray(pickle.load(f)['faces_vert_is_sampled_from'])
    order, bary = compact_hd_regressor(hd_reg, k=4)
    return order, bary, geovec


def _load_real_segments():
    """The real body segments, {name: {'vidx', 'bands_verts'}}, or None
    when segm_utils.py or every segment's PLY is missing.

    Copy of tuch_tpu/runtime.py _load_real_segments: the reference reads
    smpl_segment_{name}.ply vertex colours and the segm_utils.py table
    (tuch/utils/segmentation.py:40-47).
    """
    seg_dir = cfg.SEGMENT_DIR
    utils_py = os.path.join(seg_dir, 'segm_utils.py')
    if not os.path.isfile(utils_py):
        return None
    namespace = {}
    with open(utils_py) as f:
        exec(f.read(), namespace)  # trusted local asset, as the reference
    out = {}
    for name, bands in namespace.get('segments', {}).items():
        ply = os.path.join(seg_dir, f'smpl_segment_{name}.ply')
        if not os.path.isfile(ply):
            continue
        out[name] = {'vidx': _red_vertices_from_ply(ply),
                     'bands_verts': [np.asarray(v) for v in bands.values()]}
    return out or None


_PLY_TYPES = {'float': 'f4', 'float32': 'f4', 'double': 'f8', 'uchar': 'u1',
              'uint8': 'u1', 'int': 'i4', 'uint': 'u4', 'short': 'i2',
              'ushort': 'u2', 'char': 'i1'}


def _red_vertices_from_ply(path: str) -> np.ndarray:
    """Vertex ids whose red channel is 255 in an ascii or binary PLY (copy
    of tuch_tpu/runtime.py's minimal reader, which replaces trimesh at the
    reference's segmentation.py:41-42)."""
    with open(path, 'rb') as f:
        header = []
        while True:
            line = f.readline().decode('ascii', errors='replace').strip()
            header.append(line)
            if line == 'end_header':
                break
        n_verts, props, fmt, in_vertex = 0, [], 'ascii', False
        for line in header:
            if line.startswith('format'):
                fmt = line.split()[1]
            elif line.startswith('element vertex'):
                n_verts = int(line.split()[-1])
                in_vertex = True
            elif line.startswith('element'):
                in_vertex = False
            elif line.startswith('property') and in_vertex:
                props.append(line.split()[1:])
        red_idx = [i for i, p in enumerate(props) if p[-1] == 'red']
        if not red_idx:
            return np.array([], np.int64)
        ri = red_idx[0]
        if fmt == 'ascii':
            reds = np.asarray([float(f.readline().split()[ri])
                               for _ in range(n_verts)])
        else:
            endian = '<' if 'little' in fmt else '>'
            dtype = np.dtype([(f'f{i}', endian + _PLY_TYPES[p[0]])
                              for i, p in enumerate(props)])
            data = np.frombuffer(f.read(dtype.itemsize * n_verts),
                                 dtype=dtype, count=n_verts)
            reds = data[f'f{ri}'].astype(np.float64)
        return np.where(reds == 255)[0].astype(np.int64)
