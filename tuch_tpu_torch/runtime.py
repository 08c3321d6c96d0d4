"""Runtime assembly for inference: body model + HMR with its weights.

Counterpart of the inference subset of tuch_tpu/runtime.py build_runtime:
the real SMPL assets when present (or on request), else the synthetic
stand-in; HMR with random weights from a seed, replaced by a checkpoint
(a reference .pt or the JAX package's .npz tree) when one is given.
"""

import os
from typing import NamedTuple, Optional

from tuch_tpu_torch import assets as assets_mod
from tuch_tpu_torch import config as cfg
from tuch_tpu_torch import constants, resolve_device
from tuch_tpu_torch.models import hmr as hmr_mod
from tuch_tpu_torch.models.convert import load_checkpoint
from tuch_tpu_torch.models.smpl import SMPL

# Reference checkpoint entries that are not weights of this model: the IEF
# init buffers (the runtime's mean params are used, as in the JAX package)
# and BatchNorm's step counter.
_IGNORED_KEYS = ('init_pose', 'init_shape', 'init_cam')


class Runtime(NamedTuple):
    smpl: SMPL
    hmr: hmr_mod.HMR


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
                  checkpoint: Optional[str] = None) -> Runtime:
    """Build SMPL and HMR in eval mode on `device` (CUDA by default).

    synthetic=None picks the real assets when SMPL_NEUTRAL.pkl exists and
    says which it picked. The synthetic body and the random weights both
    come from seed 0.
    """
    dev = resolve_device(device)
    if synthetic is None:
        neutral = os.path.join(cfg.SMPL_MODEL_DIR, 'SMPL_NEUTRAL.pkl')
        synthetic = not os.path.isfile(neutral)
        print(f'[tuch_tpu_torch.runtime] auto-selected '
              f'{"SYNTHETIC stand-in" if synthetic else "real"} assets '
              f'({neutral} {"missing" if synthetic else "found"})',
              flush=True)
    if synthetic:
        smpl_model, means = assets_mod.synthetic_smpl(
            num_verts=num_verts or constants.SMPL_NUM_VERTS)
    else:
        smpl_model = assets_mod.load_smpl_pkl(os.path.join(
            cfg.SMPL_MODEL_DIR, 'SMPL_NEUTRAL.pkl'))
        if os.path.isfile(cfg.JOINT_REGRESSOR_TRAIN_EXTRA):
            smpl_model = assets_mod.load_extra_joint_regressor(
                smpl_model, cfg.JOINT_REGRESSOR_TRAIN_EXTRA)
        means = assets_mod.load_mean_params(cfg.SMPL_MEAN_PARAMS)

    hmr = hmr_mod.create_hmr(*means, backbone=backbone)
    hmr_mod.init_weights(hmr)
    if checkpoint:
        load_hmr_weights(hmr, load_checkpoint(checkpoint))
    return Runtime(smpl=SMPL(smpl_model).to(dev).eval(),
                   hmr=hmr.to(dev).eval())
