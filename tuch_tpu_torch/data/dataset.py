"""Datasets: heterogeneous annotations and deterministic augmentation.

Counterpart of tuch_tpu/data/dataset.py. Augmentation parameters are a
pure function of (seed, dataset, epoch, index) through a crc32 key, the
same key as the JAX package's, so both draw the same augmentation. Samples
are dicts of fixed-shape numpy arrays; images are decoded with PIL and
warped with one affine resample (data/transforms.py).
"""

import os
import pickle
import zlib
from typing import Dict, Optional

import numpy as np

from tuch_tpu_torch import config as cfg
from tuch_tpu_torch import constants
from tuch_tpu_torch.data import transforms as T

# Per-dataset annotation capabilities (reference base_dataset.py:74-137).
_CAPS = {
    'dsc_df': dict(disc_contact=1, smpl=0, pgt_smpl=0, pose_3d=0, gt_kpts=0),
    'dsc_lspet': dict(disc_contact=1, smpl=0, pgt_smpl=0, pose_3d=0,
                      gt_kpts=1),
    'dsc_lsp': dict(disc_contact=1, smpl=0, pgt_smpl=0, pose_3d=0,
                    gt_kpts=1),
    'dsc_df_eft': dict(disc_contact=0, smpl=0, pgt_smpl=1, pose_3d=0,
                       gt_kpts=0),
    'dsc_lspet_eft': dict(disc_contact=0, smpl=0, pgt_smpl=1, pose_3d=0,
                          gt_kpts=1),
    'dsc_lsp_eft': dict(disc_contact=0, smpl=0, pgt_smpl=1, pose_3d=0,
                        gt_kpts=1),
    'mtp': dict(disc_contact=0, smpl=0, pgt_smpl=1, pose_3d=0, gt_kpts=0),
    'mtp_scans_gt': dict(disc_contact=0, smpl=1, pgt_smpl=0, pose_3d=0,
                         gt_kpts=0),
    'mpi-inf-3dhp': dict(disc_contact=0, smpl='data', pgt_smpl=0, pose_3d=1,
                         gt_kpts=1),
    '3dpw': dict(disc_contact=0, smpl=1, pgt_smpl=0, pose_3d=0, gt_kpts=0),
}


def load_db(path: str) -> dict:
    """A preprocessed dataset dict (.npz, or a joblib / pickle file)."""
    if path.endswith('.npz'):
        with np.load(path, allow_pickle=True) as d:
            return {k: d[k] for k in d.files}
    try:
        import joblib
    except ImportError:
        joblib = None
    if joblib is not None:
        return joblib.load(path)
    with open(path, 'rb') as f:
        return pickle.load(f)


def _read_image(path: str) -> np.ndarray:
    """uint8 RGB; the crop converts only its source slice to float."""
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert('RGB'))


class TuchDataset:
    """One preprocessed dataset with deterministic augmentation; get(index,
    epoch) returns a dict of numpy arrays."""

    def __init__(self, options, dataset: str, use_augmentation: bool = True,
                 split: str = 'train', num_contact_classes: int = 12,
                 data: Optional[dict] = None, img_dir: Optional[str] = None,
                 dataset_id: int = 0):
        self.name = dataset
        self.split = split
        self.is_train = split == 'train'
        self.options = options
        self.use_augmentation = use_augmentation
        self.dataset_id = dataset_id
        self.img_dir = img_dir if img_dir is not None else \
            cfg.IMAGE_FOLDERS.get(dataset, '')
        self.data = data if data is not None else \
            load_db(cfg.DATASET_FILES[split][dataset])
        self.length = len(self.data['imgname'])
        self.num_classes = num_contact_classes
        caps = _CAPS.get(dataset, dict(disc_contact=0, smpl=0, pgt_smpl=0,
                                       pose_3d=0, gt_kpts=0))
        if not self.is_train and dataset == 'mpi-inf-3dhp':
            caps = dict(disc_contact=0, smpl=0, pgt_smpl=0, pose_3d=1,
                        gt_kpts=1)

        def expand(v):
            if v == 'data':
                return np.asarray(self.data['has_smpl']).astype(np.float32)
            return np.full(self.length, float(v), np.float32)

        self.has_disc_contact = expand(caps['disc_contact'])
        self.has_smpl = expand(caps['smpl'])
        self.has_pgt_smpl = expand(caps['pgt_smpl'])
        self.has_pose_3d = expand(caps['pose_3d'])
        self.has_gt_kpts = expand(caps['gt_kpts'])
        if options is not None and getattr(options, 'ignore_3d', False):
            self.has_smpl = np.zeros(self.length, np.float32)

        # 25 OpenPose keypoints, then the 24 ground-truth ones
        kp_gt = np.asarray(self.data['part'], np.float32) \
            if 'part' in self.data else np.zeros((self.length, 24, 3),
                                                 np.float32)
        kp_op = np.asarray(self.data['openpose'], np.float32) \
            if 'openpose' in self.data else np.zeros((self.length, 25, 3),
                                                     np.float32)
        self.keypoints = np.concatenate([kp_op, kp_gt], axis=1)
        self.seed = getattr(options, 'seed', 0) if options is not None else 0

    def __len__(self):
        return self.length

    def augm_params(self, index: int, epoch: int):
        """(flip, channel noise (3,), rotation, scale), drawn from a numpy
        stream keyed by crc32(seed|name|epoch|index): the same on every
        process and in both packages (Python's hash() is salted)."""
        flip, rot, sc = 0, 0.0, 1.0
        pn = np.ones(3)
        if self.is_train and self.use_augmentation \
                and self.options is not None:
            key = f'{self.seed}|{self.name}|{epoch}|{index}'.encode()
            rng = np.random.RandomState(zlib.crc32(key) & 0x7fffffff)
            o = self.options
            if rng.uniform() <= 0.5:
                flip = 1
            pn = rng.uniform(1 - o.noise_factor, 1 + o.noise_factor, 3)
            rot = float(np.clip(rng.randn() * o.rot_factor,
                                -2 * o.rot_factor, 2 * o.rot_factor))
            sc = float(np.clip(rng.randn() * o.scale_factor + 1,
                               1 - o.scale_factor, 1 + o.scale_factor))
            if rng.uniform() <= 0.6:
                rot = 0.0
        return flip, pn, rot, sc

    def get(self, index: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        index = int(index) % self.length
        scale = np.asarray(self.data['scale'][index], np.float64).copy()
        center = np.asarray(self.data['center'][index], np.float64).copy()
        img_res = self.options.img_res if self.options is not None else \
            constants.IMG_RES

        img_path = os.path.join(self.img_dir, str(self.data['imgname'][index]))
        orig_img = _read_image(img_path)
        orig_shape = np.array(orig_img.shape[:2], np.float32)

        flip, pn, rot, sc = self.augm_params(index, epoch)
        img = T.crop_image(orig_img, center, sc * scale, (img_res, img_res),
                           rot=rot)
        if flip:
            img = T.flip_img(img)
        img = np.clip(img * pn[None, None, :], 0, 255) / 255.0
        img = T.normalize_image(img)

        keypoints = T.j2d_processing(self.keypoints[index].copy(), center,
                                     sc * scale, img_res, rot, bool(flip))

        if self.has_smpl[index] or self.has_pgt_smpl[index]:
            pose = np.asarray(self.data['pose'][index], np.float32)
            betas = np.asarray(self.data['betas'][index], np.float32)
            if 'gender' in self.data:
                gender = 0 if str(self.data['gender'][index]) == 'm' else 1
            else:
                gender = -1
        else:
            pose = np.zeros(72, np.float32)
            betas = np.zeros(10, np.float32)
            gender = -1

        if self.has_disc_contact[index]:
            key = 'contact_vec_mirror_pc' if flip else 'contact_vec_pc'
            contact_vec = np.asarray(self.data[key][index], np.float32)
        else:
            contact_vec = np.zeros(self.num_classes, np.float32)

        if self.has_pose_3d[index]:
            S = np.asarray(self.data['S'][index], np.float32).copy()
            pose_3d = T.j3d_processing(
                S, rot, bool(flip),
                apply_rotation=bool(getattr(self.options,
                                            'rotate_pose_3d', False)))
        else:
            pose_3d = np.zeros((24, 4), np.float32)

        return {
            'img': img.astype(np.float32),
            'keypoints': keypoints,
            'pose': T.pose_processing(pose, rot, bool(flip)),
            'betas': betas,
            'contact_vec': contact_vec,
            'pose_3d': pose_3d,
            'has_smpl': np.float32(self.has_smpl[index]),
            'has_pgt_smpl': np.float32(self.has_pgt_smpl[index]),
            'has_disc_contact': np.float32(self.has_disc_contact[index]),
            'has_gt_kpts': np.float32(self.has_gt_kpts[index]),
            'has_pose_3d': np.float32(self.has_pose_3d[index]),
            'scale': np.float32(sc * scale),
            'center': center.astype(np.float32),
            'is_flipped': np.float32(flip),
            'rot_angle': np.float32(rot),
            'gender': np.int32(gender),
            'sample_index': np.int32(index),
            'dataset_id': np.int32(self.dataset_id),
            'orig_shape': orig_shape,
        }


def project_db_keypoints(db: dict, smpl, focal_length: float = 5000.0,
                         noise_px: float = 2.0, seed: int = 0) -> dict:
    """A synthetic db with its random 2D keypoints replaced by projections
    of its own GT SMPL joints plus pixel noise.

    smpl: this package's SMPL module (its device is used). Each body is
    placed at tz = 1.7 f / (200 scale), so it spans the SPIN crop box, and
    projected around its own bbox centre.
    """
    import torch

    from tuch_tpu_torch.models.smpl import smpl_forward
    if 'pose' not in db or 'betas' not in db:
        raise ValueError('project_db_keypoints needs a with_smpl db')
    rng = np.random.RandomState(seed + 1)  # decorrelated from db content
    dev = smpl.v_template.device
    pose = torch.as_tensor(np.asarray(db['pose'], np.float32), device=dev)
    with torch.no_grad():
        out = smpl_forward(smpl, torch.as_tensor(
            np.asarray(db['betas'], np.float32), device=dev),
            pose[:, 3:], pose[:, :3])
    joints = out.joints.cpu().numpy()                    # (n, 49, 3)
    scale = np.asarray(db['scale'], np.float32)
    center = np.asarray(db['center'], np.float32)
    tz = 1.7 * focal_length / (200.0 * scale)
    z = joints[..., 2] + tz[:, None]
    px = focal_length * joints[..., :2] / z[..., None] \
        + center[:, None, :]
    px += rng.randn(*px.shape).astype(np.float32) * noise_px
    db = dict(db)
    op = np.array(db['openpose'], np.float32)
    gt = np.array(db['part'], np.float32)
    op[..., :2] = px[:, :25]
    gt[..., :2] = px[:, 25:49]
    db['openpose'], db['part'] = op, gt
    return db


def synthetic_db(num_samples: int, num_contact_classes: int = 12,
                 img_size: int = 256, seed: int = 0,
                 with_smpl: bool = True, with_contact: bool = True,
                 with_pose_3d: bool = False, img_dir: Optional[str] = None
                 ) -> dict:
    """A synthetic preprocessed-dataset dict of the joblib schema, drawn
    from the same numpy stream as the JAX package's (bitwise equal). With
    img_dir, random PNG images are written there."""
    rng = np.random.RandomState(seed)
    db = {
        'imgname': np.array([f'img_{i:05d}.png' for i in range(num_samples)]),
        'scale': rng.uniform(0.8, 1.5, num_samples).astype(np.float32),
        'center': rng.uniform(img_size * 0.4, img_size * 0.6,
                              (num_samples, 2)).astype(np.float32),
        'openpose': np.concatenate([
            rng.uniform(0, img_size, (num_samples, 25, 2)),
            rng.uniform(0.5, 1.0, (num_samples, 25, 1))],
            axis=-1).astype(np.float32),
        'part': np.concatenate([
            rng.uniform(0, img_size, (num_samples, 24, 2)),
            np.ones((num_samples, 24, 1))], axis=-1).astype(np.float32),
    }
    if with_smpl:
        db['pose'] = (rng.randn(num_samples, 72) * 0.2).astype(np.float32)
        db['betas'] = (rng.randn(num_samples, 10) * 0.5).astype(np.float32)
    if with_contact:
        cv = (rng.rand(num_samples, num_contact_classes) > 0.7)
        db['contact_vec_pc'] = cv.astype(np.float32)
        db['contact_vec_mirror_pc'] = cv[:, ::-1].astype(np.float32)
    if with_pose_3d:
        S = np.concatenate([rng.randn(num_samples, 24, 3) * 0.3,
                            np.ones((num_samples, 24, 1))], axis=-1)
        db['S'] = S.astype(np.float32)
    if img_dir is not None:
        from PIL import Image
        os.makedirs(img_dir, exist_ok=True)
        for i in range(num_samples):
            arr = rng.randint(0, 255, (img_size, img_size, 3), np.uint8)
            Image.fromarray(arr).save(os.path.join(img_dir,
                                                   db['imgname'][i]))
    return db
