"""Weights in: the JAX package's variables tree and reference checkpoints.

``from_jax_variables`` turns the ``{'params', 'batch_stats'}`` tree of the
Flax HMR (numpy arrays) into this package's state dict, for both backbones:
conv kernels HWIO -> OIHW, Dense kernels (in, out) -> (out, in), BatchNorm
scale/bias/mean/var -> weight/bias/running_mean/running_var. The fused qkv
column order is kept, so the attention layout is unchanged.

``load_checkpoint`` reads a reference ``.pt`` (a raw state dict or the
``{'model': state_dict}`` wrapper) or the JAX package's flat ``.npz`` pytree
(keys 'params/backbone/...'), the latter with numpy only.
"""

import re
from typing import Dict

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
