"""Weights in: the JAX package's variables tree and reference checkpoints.

``from_jax_variables`` turns the ``{'params', 'batch_stats'}`` tree of the
Flax HMR (numpy arrays) into this package's state dict, for both backbones:
conv kernels HWIO -> OIHW, Dense kernels (in, out) -> (out, in), BatchNorm
scale/bias/mean/var -> weight/bias/running_mean/running_var. The fused qkv
column order is kept, so the attention layout is unchanged.

``load_checkpoint`` reads a reference ``.pt`` (a raw state dict or the
``{'model': state_dict}`` wrapper) or the JAX package's flat ``.npz`` pytree
(keys 'params/backbone/...'), the latter with numpy only.

``params_from_jax`` and ``batch_stats_from_jax`` carry the training state
across by name: a parameter-shaped tree (parameters, gradients, Adam
moments) and the BatchNorm statistics. The fits store's (N, 82) rows have
the same layout in both packages.

``contact_assets_from_numpy`` and ``prior_from_numpy`` carry the fitting
state across: they take the fields of the JAX package's ContactAssets,
SegmentTables and GMMPrior as numpy arrays (or the same fields made by
this package's numpy functions, as the runtime passes) and build this
package's. ``winding_clusters_from_numpy`` does the same for the tables of
the hierarchical winding numbers (WindingClusters).
"""

import re
from typing import Dict, Mapping

import numpy as np
import torch

_LEAVES = {'scale': 'weight', 'bias': 'bias', 'mean': 'running_mean',
           'var': 'running_var'}


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _module_path(path, vit: bool):
    """Flax module path -> torch module names."""
    parts = list(path)
    if parts and parts[0] == 'backbone' and not vit:
        parts = parts[1:]  # the reference keeps the ResNet at top level
    out = []
    for p in parts:
        m = re.fullmatch(r'layer(\d)_(\d+)', p)
        b = re.fullmatch(r'block(\d+)', p)
        if m:
            out += [f'layer{m.group(1)}', m.group(2)]
        elif b:
            out += ['blocks', b.group(1)]
        elif p == 'downsample_conv':
            out += ['downsample', '0']
        elif p == 'downsample_bn':
            out += ['downsample', '1']
        else:
            out.append(p)
    return out


def from_jax_variables(variables) -> Dict[str, torch.Tensor]:
    """Flax HMR variables (nested dicts of arrays) -> torch state dict."""
    params = _flatten(variables['params'])
    stats = _flatten(variables.get('batch_stats', {}))
    vit = any(p[:2] == ('backbone', 'embed') for p in params)
    sd = {}
    for path, v in list(params.items()) + list(stats.items()):
        v = np.asarray(v, np.float32)
        *mod, leaf = path
        mod = _module_path(mod, vit)
        if leaf == 'kernel':
            # HWIO -> OIHW for convs, (in, out) -> (out, in) for Dense
            v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T
            name = 'weight'
        elif leaf in _LEAVES:
            name = _LEAVES[leaf]
        else:
            raise KeyError(f'unexpected leaf {"/".join(path)!r} in a Flax '
                           'HMR tree')
        sd['.'.join(mod + [name])] = torch.tensor(np.ascontiguousarray(v))
    return sd


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """A tree shaped like the Flax HMR's params (the params, their
    gradient, an Adam moment), numpy arrays -> a dict under this package's
    parameter names (HMR.named_parameters), laid out as they are."""
    return from_jax_variables({'params': tree})


def batch_stats_from_jax(stats) -> Dict[str, torch.Tensor]:
    """The Flax ResNet-50 HMR's batch_stats tree -> its running_mean and
    running_var buffers by name."""
    return from_jax_variables({'params': {}, 'batch_stats': stats})


def contact_assets_from_numpy(fields: Mapping, segment_tables=None,
                              device='cpu'):
    """ContactAssets on `device` from numpy arrays.

    fields: geomask (V, V) bool or uint8, allowed[query, searched]; faces
    (F, 3); region_idx_a/b and region_mask_a/b (P, R). segment_tables: a
    SegmentTables (or a mapping of its fields) with numpy arrays, or None.
    The mask is stored as uint8, and packed once as the bits the masked-min
    kernel reads (geomask_bits).
    """
    from tuch_tpu_torch.losses.smplify import ContactAssets
    from tuch_tpu_torch.ops import segments as seg_mod
    from tuch_tpu_torch.ops.contact_kernels import pack_mask_bits

    def idx(x):
        return torch.tensor(np.asarray(x), dtype=torch.long, device=device)

    def mask(x):
        return torch.tensor(np.asarray(x, bool), device=device)

    tables = None
    if segment_tables is not None:
        if isinstance(segment_tables, Mapping):
            segment_tables = seg_mod.SegmentTables(**segment_tables)
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


def prior_from_numpy(means, precisions, nll_weights, device='cpu'):
    """GMMPrior on `device` from its three arrays (float32)."""
    from tuch_tpu_torch.losses.prior import GMMPrior
    return GMMPrior(*(torch.tensor(np.asarray(x, np.float32), device=device)
                      for x in (means, precisions, nll_weights)))


def winding_clusters_from_numpy(fields, device='cpu'):
    """WindingClusters on `device` from the fields of the JAX package's
    (a WindingClusters, or a mapping of its fields): the four tables as
    int64 tensors, the five sizes as ints."""
    from tuch_tpu_torch.ops.winding_hier import WindingClusters
    if not isinstance(fields, Mapping):
        fields = fields._asdict()
    tables = ('face_perm', 'faces_sorted', 'vert_perm', 'vert_inv')
    return WindingClusters(**{
        k: torch.tensor(np.asarray(fields[k]), dtype=torch.long,
                        device=device) if k in tables else int(fields[k])
        for k in WindingClusters._fields})


def _unflatten(flat: Dict[str, np.ndarray]):
    tree = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split('/')
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint file -> this package's state dict (CPU tensors)."""
    if path.endswith('.npz'):
        with np.load(path, allow_pickle=False) as d:
            tree = _unflatten({k: d[k] for k in d.files})
        return from_jax_variables(tree)
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    sd = ckpt.get('model', ckpt) if isinstance(ckpt, dict) else ckpt
    return {k: torch.as_tensor(v) for k, v in sd.items()}
