"""FitsStore: the best fit per training image, a tensor on the device.

Counterpart of tuch_tpu/train/fits_store.py. All datasets are packed into
one (N_total, 82) tensor (pose 72 + betas 10) that the training step
carries: lookup is a gather that rotates and then flips the pose into the
crop's augmentation; writeback un-flips, un-rotates and writes the rows
the accept mask selects.

A batch may name one row twice (the loader pads short batches). The JAX
package's scatter leaves that case to the implementation, and so does
index_put_ on CUDA; here the last occurrence in the batch wins, its
accepted fit or its old row alike.
"""

import os
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from tuch_tpu_torch import constants, resolve_device
from tuch_tpu_torch.utils import rotations as rot

_FLIP_PERM = np.array(constants.SMPL_POSE_FLIP_PERM)


class FitsStore(NamedTuple):
    """Static layout and the packed tensor."""
    params: torch.Tensor         # (N_total, 82): pose 72 + betas 10
    offsets: Dict[str, int]      # dataset name -> first row
    sizes: Dict[str, int]        # dataset name -> row count


def create_fits_store(dataset_sizes: Dict[str, int],
                      static_fits_dir: Optional[str] = None,
                      checkpoint_dir: Optional[str] = None,
                      device=None) -> FitsStore:
    """Each dataset's rows from {name}_fits.npy in checkpoint_dir, else in
    static_fits_dir, else zeros (the mean pose); on `device` (CUDA unless
    'cpu' is asked for)."""
    dev = resolve_device(device)
    blocks: List[np.ndarray] = []
    offsets, sizes = {}, {}
    off = 0
    for name, n in dataset_sizes.items():
        arr = None
        for d in (checkpoint_dir, static_fits_dir):
            if d is None:
                continue
            path = os.path.join(d, f'{name}_fits.npy')
            if os.path.isfile(path):
                arr = np.load(path).astype(np.float32)
                break
        if arr is None:
            arr = np.zeros((n, 82), np.float32)
        assert arr.shape == (n, 82), (name, arr.shape)
        blocks.append(arr)
        offsets[name] = off
        sizes[name] = n
        off += n
    params = np.concatenate(blocks, axis=0) if blocks else \
        np.zeros((0, 82), np.float32)
    return FitsStore(params=torch.tensor(params, device=dev),
                     offsets=offsets, sizes=sizes)


def save_fits(store: FitsStore, checkpoint_dir: str):
    """Write {name}_fits.npy per dataset."""
    params = store.params.detach().cpu().numpy()
    os.makedirs(checkpoint_dir, exist_ok=True)
    for name, off in store.offsets.items():
        n = store.sizes[name]
        np.save(os.path.join(checkpoint_dir, f'{name}_fits.npy'),
                params[off:off + n])


def global_indices(store: FitsStore, dataset_idx: torch.Tensor,
                   sample_idx: torch.Tensor,
                   dataset_order: List[str]) -> torch.Tensor:
    """(dataset id, index in the dataset) -> row of the packed tensor;
    dataset_order fixes the ids of the dataset names."""
    table = torch.tensor([store.offsets[name] for name in dataset_order],
                         dtype=torch.long, device=dataset_idx.device)
    return table[dataset_idx.long()] + sample_idx.long()


def _flip_poses(pose: torch.Tensor, is_flipped: torch.Tensor):
    return torch.where(is_flipped.bool()[:, None],
                       rot.flip_pose(pose, _FLIP_PERM), pose)


def _rotate_poses(pose: torch.Tensor, rot_deg: torch.Tensor):
    """Rotate the global orientation by R_z(-rot_deg)."""
    return torch.cat([rot.rot_aa(pose[:, :3], rot_deg), pose[:, 3:]], dim=-1)


def lookup_fits(params: torch.Tensor, gidx: torch.Tensor,
                rot_deg: torch.Tensor, is_flipped: torch.Tensor):
    """(pose (B, 72), betas (B, 10)) of rows gidx, rotated and then flipped
    into the crop's augmentation."""
    rows = params[gidx.long()]
    pose = _flip_poses(_rotate_poses(rows[:, :72], rot_deg), is_flipped)
    return pose, rows[:, 72:]


def last_occurrence(gidx: torch.Tensor) -> torch.Tensor:
    """For each batch entry, the position of the last entry naming the
    same row, (B,) int64."""
    same = gidx[:, None] == gidx[None, :]
    pos = torch.arange(gidx.shape[0], device=gidx.device)
    return torch.where(same, pos[None, :], -1).amax(dim=1)


def update_fits(params: torch.Tensor, gidx: torch.Tensor,
                pose: torch.Tensor, betas: torch.Tensor,
                rot_deg: torch.Tensor, is_flipped: torch.Tensor,
                update_mask: torch.Tensor) -> torch.Tensor:
    """A new packed tensor with the rows of update_mask written back,
    un-flipped and then un-rotated (the inverse of lookup_fits); of
    duplicate rows the last occurrence wins."""
    gidx = gidx.long()
    pose = _rotate_poses(_flip_poses(pose, is_flipped), -rot_deg)
    rows = torch.cat([pose, betas], dim=-1)
    new = torch.where(update_mask.bool()[:, None], rows, params[gidx])
    # every duplicate writes its last occurrence's row: one value per row
    return params.index_put((gidx,), new[last_occurrence(gidx)])
