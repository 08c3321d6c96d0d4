"""Offline extraction of the 3DPW test/train sets.

Reference: tuch/datasets/preprocess/pw3d.py (SPIN-style). Reads the 3DPW
sequence pickles, keeps camera-pose-valid frames, folds the camera
extrinsics into the SMPL global orientation, and derives bboxes from the
2D poses. cv2.Rodrigues is replaced by numpy rotation helpers.
Counterpart of tuch_tpu/data/preprocess/pw3d.py; writes each database
as a plain pickle (data/preprocess.write_db) where it writes joblib.
"""

import os
import os.path as osp
import pickle

import numpy as np

from tuch_tpu_torch import config, constants
from tuch_tpu_torch.data.preprocess import write_db


# shared numpy Rodrigues helpers (with the near-pi-safe inverse --
# 3DPW camera extrinsics routinely produce large rotations)
from tuch_tpu_torch.data.transforms import aa_to_rotmat_np as _aa_to_R
from tuch_tpu_torch.data.transforms import rotmat_to_aa_np as _R_to_aa


def pw3d_extract(dataset_path=None, out_path=None, split='test',
                 scale_factor=1.2):
    dataset_path = dataset_path or config.IMAGE_FOLDERS['3dpw']
    out_path = out_path or config.DBS_PATH
    os.makedirs(out_path, exist_ok=True)

    db = {k: [] for k in ('imgname', 'center', 'scale', 'pose', 'betas',
                          'gender')}
    if split == 'train':
        db['openpose'] = []

    seq_dir = osp.join(dataset_path, 'sequenceFiles', split)
    for fname in sorted(os.listdir(seq_dir)):
        if not fname.endswith('.pkl'):
            continue
        with open(osp.join(seq_dir, fname), 'rb') as f:
            data = pickle.load(f, encoding='latin1')
        smpl_pose = data['poses']
        smpl_betas = data['betas']
        poses2d = data['poses2d']
        global_poses = data['cam_poses']
        genders = data['genders']
        valid = np.asarray(data['campose_valid']).astype(bool)
        num_frames = len(smpl_pose[0])
        seq = str(data['sequence'])
        img_names = np.array([f'imageFiles/{seq}/image_{i:05d}.jpg'
                              for i in range(num_frames)])
        for i in range(len(smpl_pose)):
            v = valid[i]
            vp = smpl_pose[i][v]
            vb = np.tile(smpl_betas[i][:10][None], (num_frames, 1))[v]
            vk = poses2d[i][v]
            vn = img_names[v]
            vg = global_poses[v]
            for j in range(vp.shape[0]):
                part = vk[j].T
                part = part[part[:, 2] > 0]
                if part.shape[0] < 2:
                    continue
                bbox = [part[:, 0].min(), part[:, 1].min(),
                        part[:, 0].max(), part[:, 1].max()]
                center = [(bbox[2] + bbox[0]) / 2, (bbox[3] + bbox[1]) / 2]
                scale = scale_factor * max(bbox[2] - bbox[0],
                                           bbox[3] - bbox[1]) / 200
                pose = vp[j].copy()
                # world -> camera global orientation
                pose[:3] = _R_to_aa(vg[j][:3, :3] @ _aa_to_R(pose[:3]))
                db['imgname'].append(vn[j])
                db['center'].append(center)
                db['scale'].append(scale)
                db['pose'].append(pose.astype(np.float32))
                db['betas'].append(vb[j].astype(np.float32))
                db['gender'].append(genders[i])
                if split == 'train':
                    keypoints = np.zeros((25, 3))
                    keypoints[constants.COCO18_TO_BODY25] = vk[j].T
                    db['openpose'].append(keypoints)

    out_file = osp.join(out_path, f'3dpw_{split}.pt')
    write_db(db, out_file)
    print(f'{len(db["imgname"])} 3DPW {split} samples -> {out_file}')
    return out_file
