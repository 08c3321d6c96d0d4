"""Checkpoints: the training state, the fits and the loader's position.

Counterpart of tuch_tpu/train/checkpoint.py with the same names and rules;
one torch.save file replaces the Orbax directory. A checkpoint is the file
``{stamp}_step{N}_{err}`` in the checkpoint directory and its
``.meta.json`` beside it (step, validation error, loader state). The meta
file is written to a temporary name and renamed: that rename is the commit
point, and list_checkpoints counts only committed checkpoints.

The file holds a dict: the HMR's state dict under 'model' (parameters and
BatchNorm statistics, so that models/convert.load_checkpoint, and with it
--pretrained_checkpoint and cli/eval --checkpoint, reads it as a
reference checkpoint), Adam's 'mu', 'nu' and 'count', the 'fits' tensor,
the dropout generator's state and the device type it lives on, and 'step'.
"""

import json
import os
import re
import time
from typing import Any, Dict, Optional, Tuple

import torch

from tuch_tpu_torch.models.convert import load_checkpoint
from tuch_tpu_torch.runtime import load_hmr_weights
from tuch_tpu_torch.train.module import TrainState


def _cpu(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in tensors.items()}


class CheckpointManager:
    def __init__(self, save_dir: str, max_to_keep: int = 5):
        self.save_dir = os.path.abspath(save_dir)
        os.makedirs(self.save_dir, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int, val_error: Optional[float]) -> str:
        stamp = time.strftime('%Y_%m_%d-%H_%M_%S')
        err = 'nan' if val_error is None else f'{val_error:.2f}'
        return os.path.join(self.save_dir, f'{stamp}_step{step}_{err}')

    def save(self, state: TrainState, loader_state: Dict[str, Any],
             val_error: Optional[float] = None) -> str:
        """Write the state and commit it with its meta file; returns the
        checkpoint's path. Keeps max_to_keep and the best (_gc)."""
        path = self._path(state.step, val_error)
        payload = {
            'model': _cpu(state.hmr.state_dict()),
            'mu': _cpu(state.opt.mu), 'nu': _cpu(state.opt.nu),
            'count': state.opt.count,
            'fits': state.fits.detach().cpu(),
            'generator': state.generator.get_state(),
            'generator_device': state.generator.device.type,
            'step': state.step,
        }
        torch.save(payload, path + '.tmp')
        os.replace(path + '.tmp', path)
        tmp = path + '.meta.json.tmp'
        with open(tmp, 'w') as f:
            json.dump({'step': state.step, 'val_error': val_error,
                       'loader_state': loader_state}, f)
        os.replace(tmp, path + '.meta.json')
        self._gc()
        return path

    def _gc(self):
        """Keep the newest max_to_keep checkpoints and the one with the
        lowest validation error."""
        ckpts = self.list_checkpoints()
        keep = set(ckpts[-self.max_to_keep:])
        best, best_err = None, float('inf')
        for path in ckpts:
            try:
                with open(path + '.meta.json') as f:
                    ve = json.load(f).get('val_error')
            except (OSError, ValueError):
                continue
            if ve is not None and float(ve) < best_err:
                best, best_err = path, float(ve)
        if best is not None:
            keep.add(best)
        for path in ckpts:
            if path in keep:
                continue
            for name in (path + '.meta.json', path):  # uncommit first
                try:
                    os.remove(name)
                except OSError:
                    pass

    def list_checkpoints(self):
        """Committed checkpoints, oldest first, ordered by (timestamp,
        step): two saves within one second order by step."""
        out = []
        if not os.path.isdir(self.save_dir):
            return out
        for name in os.listdir(self.save_dir):
            full = os.path.join(self.save_dir, name)
            if name.endswith(('.json', '.tmp')) or '_step' not in name:
                continue
            if os.path.exists(full + '.meta.json'):
                m = re.search(r'_step(\d+)_', name)
                step = int(m.group(1)) if m else -1
                out.append((name.split('_step')[0], step, full))
        return [full for _, _, full in sorted(out)]

    def latest(self) -> Optional[str]:
        ckpts = self.list_checkpoints()
        return ckpts[-1] if ckpts else None

    def exists(self) -> bool:
        return self.latest() is not None

    def restore(self, template: TrainState, path: Optional[str] = None
                ) -> Tuple[TrainState, Dict[str, Any]]:
        """Load a checkpoint into `template` (its HMR and Adam in place);
        returns (state, loader_state). With no path, the newest one that
        reads, falling back past any it cannot read; a given path fails
        loudly."""
        if path is not None:
            return self._restore_one(template, path)
        candidates = self.list_checkpoints()
        if not candidates:
            raise FileNotFoundError('no checkpoint found in '
                                    + self.save_dir)
        last_err = None
        for cand in reversed(candidates):
            try:
                return self._restore_one(template, cand)
            except Exception as e:  # a save cut short by a crash
                print(f'checkpoint {cand} unreadable ({e!r}); '
                      'falling back to the previous one', flush=True)
                last_err = e
        raise RuntimeError(
            f'all {len(candidates)} checkpoints in {self.save_dir} '
            f'failed to restore') from last_err

    def _restore_one(self, template: TrainState, path: str
                     ) -> Tuple[TrainState, Dict[str, Any]]:
        ckpt = torch.load(path, map_location='cpu', weights_only=True)
        with open(path + '.meta.json') as f:
            meta = json.load(f)
        gen = template.generator
        if ckpt['generator_device'] != gen.device.type:
            raise ValueError(
                f'checkpoint {path} holds a dropout generator of a '
                f"{ckpt['generator_device']} device; this run's is on "
                f'{gen.device.type}: resume on the device kind that wrote '
                'it')
        opt = template.opt
        if set(ckpt['mu']) != set(opt.mu):
            raise KeyError(f'checkpoint {path} does not fit this HMR')
        load_hmr_weights(template.hmr, ckpt['model'])
        dev = template.fits.device
        opt.mu = {k: v.to(dev) for k, v in ckpt['mu'].items()}
        opt.nu = {k: v.to(dev) for k, v in ckpt['nu'].items()}
        opt.count = int(ckpt['count'])
        gen.set_state(ckpt['generator'])
        fits = ckpt['fits'].to(dev)
        if fits.shape != template.fits.shape:
            raise ValueError(f'checkpoint {path} holds fits of shape '
                             f'{tuple(fits.shape)}, this run '
                             f'{tuple(template.fits.shape)}')
        return (template._replace(fits=fits, step=int(ckpt['step'])),
                meta.get('loader_state', {}))


def load_variables(path: str, hmr) -> None:
    """Load a checkpoint's weights into `hmr`, from any of the three
    formats models/convert.load_checkpoint reads: the JAX package's .npz
    tree, a reference .pt, or a checkpoint of this package (its 'model'
    entry). BatchNorm statistics it lacks keep their values."""
    load_hmr_weights(hmr, load_checkpoint(path))
