"""Runtime assembly of the plain reference: the synthetic body, HMR and the
contact assets.

A frozen copy of tuch_tpu_torch/runtime.py's build_runtime, cut to what
the fitting cell builds: the synthetic full-topology stand-in (no real
assets, checkpoints, HD surface or pose prior), HMR with random weights
from seed 0 (the benchmark then loads its own), and with contact on the
contact assets (geodesic mask, faces, region and segment tables) on the
device.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from portbench.reference.tuchref import assets as assets_mod
from portbench.reference.tuchref import constants, resolve_device
from portbench.reference.tuchref.losses.smplify import ContactAssets
from portbench.reference.tuchref.models import hmr as hmr_mod
from portbench.reference.tuchref.models.smpl import SMPL
from portbench.reference.tuchref.ops import segments as seg_mod
from portbench.reference.tuchref.ops.contact import build_region_pairs
from portbench.reference.tuchref.ops.contact_kernels import pack_mask_bits

# vertex pairs geodesically closer than this are never contact partners
GEOTHRES = 0.3

# the names HMR's compute dtype goes by
COMPUTE_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


class Runtime(NamedTuple):
    smpl: SMPL
    hmr: hmr_mod.HMR
    # with contact only (None / empty otherwise)
    contact: Optional[ContactAssets] = None
    contact_classes: tuple = ()


def contact_assets(fields, segment_tables=None, device='cpu'):
    """ContactAssets on `device` from numpy arrays.

    fields: geomask (V, V) bool, allowed[query, searched]; faces (F, 3);
    region_idx_a/b and region_mask_a/b (P, R). segment_tables: a
    SegmentTables with numpy arrays, or None. The mask is stored as uint8,
    and packed once as the bits the masked-min kernel reads
    (geomask_bits).
    """
    def idx(x):
        return torch.tensor(np.asarray(x), dtype=torch.long, device=device)

    def mask(x):
        return torch.tensor(np.asarray(x, bool), device=device)

    tables = None
    if segment_tables is not None:
        tables = seg_mod.to_device(segment_tables, device)
    geomask = torch.tensor(np.asarray(fields['geomask'], np.uint8),
                           device=device)
    return ContactAssets(
        geomask=geomask,
        faces=idx(fields['faces']),
        region_idx_a=idx(fields['region_idx_a']),
        region_idx_b=idx(fields['region_idx_b']),
        region_mask_a=mask(fields['region_mask_a']),
        region_mask_b=mask(fields['region_mask_b']),
        segment_tables=tables, geomask_bits=pack_mask_bits(geomask))


def build_runtime(device=None, num_verts: Optional[int] = None,
                  backbone: str = 'resnet50', with_contact: bool = False,
                  with_segments: bool = True,
                  dtype: str = 'float32') -> Runtime:
    """Build the synthetic SMPL and HMR in eval mode on `device` (CUDA by
    default); with_contact adds the contact assets. HMR computes in
    `dtype` ('float32' or 'bfloat16', a key of COMPUTE_DTYPES). The
    synthetic body, its contact extras and the random weights all come
    from seed 0.
    """
    dev = resolve_device(device)
    if dtype not in COMPUTE_DTYPES:
        raise ValueError(f'unknown compute dtype {dtype!r}; have '
                         f'{sorted(COMPUTE_DTYPES)}')
    nv = num_verts or constants.SMPL_NUM_VERTS
    smpl_model, means = assets_mod.synthetic_smpl(num_verts=nv)
    hmr = hmr_mod.create_hmr(*means, backbone=backbone,
                             dtype=COMPUTE_DTYPES[dtype])
    hmr_mod.init_weights(hmr)
    runtime = Runtime(smpl=SMPL(smpl_model).to(dev).eval(),
                      hmr=hmr.to(dev).eval())
    if not with_contact:
        return runtime

    extras = assets_mod.synthetic_contact(nv)
    ia, ib, ma, mb = build_region_pairs(extras.contact_classes,
                                        extras.contact_csig)
    tables = None
    if with_segments and extras.segments:
        tables = seg_mod.build_segment_tables(
            extras.segments, smpl_model.faces, smpl_model.v_template.shape[0])
    contact = contact_assets(
        {'geomask': extras.geodists > GEOTHRES,
         'faces': smpl_model.faces, 'region_idx_a': ia, 'region_idx_b': ib,
         'region_mask_a': ma, 'region_mask_b': mb}, tables, device=dev)
    return runtime._replace(contact=contact,
                            contact_classes=tuple(extras.contact_classes))
