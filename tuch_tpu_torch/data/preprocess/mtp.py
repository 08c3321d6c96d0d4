"""Offline extraction of the MTP (mimic-the-pose) train/val sets.

Builds mtp_{train,val}.pt from MTP images + SMPLify-XMC fits -- reference:
tuch/datasets/preprocess/mtp.py. Person selection picks the detection
nearest the image center; the SMPLify-XMC camera rotation is folded into
the SMPL global orientation (the training camera is identity). Pure numpy.
Counterpart of tuch_tpu/data/preprocess/mtp.py; writes each database
as a plain pickle (data/preprocess.write_db) where it writes joblib.
"""

import glob
import json
import os
import os.path as osp
import pickle

import numpy as np

from tuch_tpu_torch import config, constants
from tuch_tpu_torch.data.preprocess import write_db
from tuch_tpu_torch.data.preprocess.dsc import OP_MAJOR_JOINTS, OP_TO_12



def select_center_person(openpose_json: dict, imgshape):
    """Pick the detection nearest the image center, weighted by confidence
    (mtp.py:34-61). Returns (keypoints (25, 3), person_idx)."""
    h, w = imgshape
    img_center = np.array([w, h]) / 2
    people = openpose_json.get('people', [])
    if not people:
        return np.zeros((25, 3)), -1
    score = np.full(len(people), np.inf)
    for i, person in enumerate(people):
        kp = np.reshape(person['pose_keypoints_2d'], (25, 3))
        kp12 = kp[OP_TO_12, :2]
        conf12 = kp[OP_TO_12, 2]
        dist = np.linalg.norm(kp12 - img_center, axis=1)
        score[i] = np.dot(dist, 1.0 - conf12)
    sel = int(np.argmin(score))
    return np.reshape(people[sel]['pose_keypoints_2d'], (25, 3)), sel


def bbox_from_keypoints(keypoints, rescale=1.2, detection_thresh=0.2):
    """Center/scale + major-joint visibility flag (mtp.py:64-89)."""
    valid = keypoints[:, -1] > detection_thresh
    vk = keypoints[valid][:, :-1]
    center = vk.mean(axis=0)
    scale = (vk.max(axis=0) - vk.min(axis=0)).max() / 200.0 * rescale
    ids = [constants.JOINT_IDS[j] for j in OP_MAJOR_JOINTS]
    visible = np.sum(keypoints[ids, 2] > 0) >= len(ids)
    return center, scale, visible


def fold_camera_rotation(global_orient_aa: np.ndarray,
                         camera_rot: np.ndarray) -> np.ndarray:
    """Apply the fit's camera ROTATION MATRIX to the global orientation
    (mtp.py:197-206: RC = smplx_params['camera_rotation'][0] is a 3x3
    matrix, R = RC @ rodrigues(global_orient)). Accepts the matrix in
    (3, 3) or batched (1, 3, 3) form; a 3-vector is treated as
    axis-angle for backward compatibility with synthetic fixtures."""
    from tuch_tpu_torch.data.transforms import (aa_to_rotmat_np,
                                                rotmat_to_aa_np)

    camera_rot = np.asarray(camera_rot, np.float64)
    if camera_rot.size == 9:
        RC = camera_rot.reshape(3, 3)
    elif camera_rot.size == 3:
        RC = aa_to_rotmat_np(camera_rot.reshape(3))
    else:
        raise ValueError(
            f'camera_rotation must be a (3, 3)/(1, 3, 3) matrix or a '
            f'3-vector axis-angle, got shape {camera_rot.shape}')
    R = RC @ aa_to_rotmat_np(np.asarray(global_orient_aa).reshape(-1)[:3])
    return rotmat_to_aa_np(R)


def mtp_extract(ds_dir=None, out_path=None, mode='train'):
    """Full MTP extraction (mtp.py:144-234)."""
    from PIL import Image
    ds_dir = ds_dir or osp.dirname(config.IMAGE_FOLDERS['mtp'])
    out_path = out_path or config.DBS_PATH
    os.makedirs(out_path, exist_ok=True)

    with open(osp.join(ds_dir, 'subject_meta.json')) as f:
        meta = json.load(f)
    with open(osp.join(ds_dir, 'train_val_split.json')) as f:
        mode_ids = json.load(f)[mode]
    img_dir = osp.join(ds_dir, 'images')
    images = [x for x in glob.glob(osp.join(img_dir, '**'), recursive=True)
              if osp.splitext(osp.basename(x))[0] in mode_ids]

    db = {k: [] for k in ('imgname', 'scale', 'center', 'openpose',
                          'gender', 'betas', 'pose')}
    for img_path in sorted(images):
        img_fn = osp.splitext(osp.basename(img_path))[0]
        rel = osp.dirname(img_path).replace(img_dir, '').strip('/')
        op_path = osp.join(ds_dir, 'keypoints/openpose', rel,
                           img_fn + '.json')
        smpl_path = osp.join(ds_dir, 'smplify-xmc/smpl/params', rel,
                             img_fn + '.pkl')
        smplx_path = osp.join(ds_dir, 'smplify-xmc/smplx/params', rel,
                              img_fn + '.pkl')
        if not (osp.isfile(op_path) and osp.isfile(smpl_path)):
            continue
        with Image.open(img_path) as im:
            shape = (im.height, im.width)
        with open(op_path) as f:
            opjson = json.load(f)
        keyp, sel = select_center_person(opjson, shape)
        if sel < 0:
            continue
        center, scale, _ = bbox_from_keypoints(keyp)

        with open(smpl_path, 'rb') as f:
            smpl_params = pickle.load(f)
        pose = np.asarray(smpl_params['pose'], np.float32).reshape(-1)
        betas = np.asarray(smpl_params['betas'], np.float32).reshape(-1)[:10]
        pose = pose.copy()
        if osp.isfile(smplx_path):
            with open(smplx_path, 'rb') as f:
                sx = pickle.load(f)
            cam_rot = np.asarray(sx.get('camera_rotation', np.eye(3)))
            # the reference composes with the SMPLX fit's global orient
            # (mtp.py:199-206), falling back to the smpl pose when the
            # smplx params lack one
            go = np.asarray(sx.get('global_orient',
                                   pose[:3])).reshape(-1)[:3]
            pose[:3] = fold_camera_rotation(go, cam_rot)

        db['imgname'].append(osp.relpath(img_path, img_dir))
        db['scale'].append(scale)
        db['center'].append(center)
        db['openpose'].append(keyp)
        db['gender'].append(
            'm' if meta.get(img_fn, {}).get('SubjectGender') == 'male'
            else 'f')
        db['betas'].append(betas)
        db['pose'].append(pose)

    out_file = osp.join(out_path, f'mtp_{mode}.pt')
    write_db(db, out_file)
    print(f'{len(db["imgname"])} MTP {mode} samples -> {out_file}')
    return out_file
