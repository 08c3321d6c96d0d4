"""Offline extraction of the DSC (discrete self-contact) training sets.

Builds dsc_{df,lspet,lsp}_train.pt from the TUCH DSC annotation release
(per-image json with 'contact_annot' body-part pairs + 'openpose'
keypoints) -- reference: tuch/datasets/preprocess/dsc.py. Pure
numpy/PIL/scipy; no torch/cv2.
Counterpart of tuch_tpu/data/preprocess/dsc.py; writes each database
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

OP_MAJOR_JOINTS = ('OP RAnkle', 'OP LAnkle', 'OP RHip', 'OP LHip',
                   'OP RShoulder', 'OP LShoulder', 'OP RKnee', 'OP LKnee')
# arms/legs subset of BODY25 matching GT joints 0..11
OP_TO_12 = [11, 10, 9, 12, 13, 14, 4, 3, 2, 5, 6, 7]


def mirror_label(bp: str) -> str:
    """Left<->right mirror of a body-part name (dsc.py:57-68)."""
    if 'left' in bp:
        return bp.replace('left', 'right')
    if 'right' in bp:
        return bp.replace('right', 'left')
    return bp


def contact_vector(annotations, classes) -> tuple:
    """Annotation pair list -> (binary vector, mirrored vector).

    classes: (P, 2) array/list of sorted body-part-name pairs
    (dsc.py:33-55).
    """
    classes = np.asarray(classes)
    vec = np.zeros(len(classes), np.float32)
    vec_flip = np.zeros(len(classes), np.float32)
    for annot in annotations:
        bp1, bp2 = annot.split('_')
        pair = sorted([bp1, bp2])
        hit = np.where(np.all(classes == pair, axis=1))[0]
        if len(hit):
            vec[hit] = 1
        pairf = sorted([mirror_label(bp1), mirror_label(bp2)])
        hitf = np.where(np.all(classes == pairf, axis=1))[0]
        if len(hitf):
            vec_flip[hitf] = 1
    return vec, vec_flip


def bbox_from_openpose(keypoints, rescale=1.2, detection_thresh=0.2):
    """Center/scale from OpenPose keypoints; requires the 8 major lower
    body joints to be confident (dsc.py:71-92)."""
    ids = [constants.JOINT_IDS[j] for j in OP_MAJOR_JOINTS]
    if np.sum(keypoints[ids, 2] > detection_thresh) < len(ids):
        return None, None, False
    valid = keypoints[:, -1] > detection_thresh
    vk = keypoints[valid][:, :-1]
    center = vk.mean(axis=0)
    scale = (vk.max(axis=0) - vk.min(axis=0)).max() / 200.0 * rescale
    return center, scale, True


def match_op_gt_keypoints(openpose, gt_part, dataset: str) -> bool:
    """Confidence-weighted distance test that the OpenPose person is the
    annotated person (dsc.py:94-122)."""
    vis = gt_part[:, -1] == 1
    kp12 = openpose[OP_TO_12, :2]
    conf12 = openpose[OP_TO_12, 2:3]
    diff = (kp12 - gt_part[:12, :2])[vis[:12]]
    if conf12[vis[:12]].size == 0 or conf12[vis[:12]].max() <= 0:
        return False
    dist = np.mean(np.sqrt(np.sum(conf12[vis[:12]] * diff ** 2, axis=1)))
    thresh = {'mpii': 30, 'coco': 10, 'lsp': 10}[dataset]
    return dist <= thresh


def read_df_subset(dsc_dir, df_dir, out_path):
    """DeepFashion subset: bbox from OpenPose (dsc.py:125-181)."""
    classes = pickle.load(
        open(osp.join(dsc_dir, 'tuch_bodypart_pairs.pkl'), 'rb'))
    db = {k: [] for k in ('imgname', 'scale', 'center', 'openpose',
                          'contact_vec_pc', 'contact_vec_mirror_pc')}
    for annopath in sorted(glob.glob(osp.join(dsc_dir, 'df', '*.json'))):
        with open(annopath) as f:
            anno = json.load(f)
        cvec, cvec_m = contact_vector(anno['contact_annot'], classes)
        openpose = np.asarray(anno['openpose'])
        if openpose.size == 0:
            continue
        openpose = openpose.reshape(25, 3)
        center, scale, ok = bbox_from_openpose(openpose)
        if not ok:
            continue
        db['imgname'].append(osp.basename(anno['img']))
        db['scale'].append(scale)
        db['center'].append(center)
        db['openpose'].append(openpose)
        db['contact_vec_pc'].append(cvec)
        db['contact_vec_mirror_pc'].append(cvec_m)
    out_file = osp.join(out_path, 'dsc_df_train.pt')
    write_db(db, out_file)
    print(f'{len(db["imgname"])} DeepFashion samples -> {out_file}')
    return out_file


def read_lsp_subset(dsc_dir, img_dir, subset, out_path, scale_factor=1.2):
    """LSP/LSPET subsets: GT joints.mat, bbox from GT, OP-vs-GT match
    check; mismatches keep keypoints but drop contact (dsc.py:184-278)."""
    import scipy.io as sio
    classes = pickle.load(
        open(osp.join(dsc_dir, 'tuch_bodypart_pairs.pkl'), 'rb'))
    joints_mat = sio.loadmat(osp.join(img_dir, 'joints.mat'))['joints']
    db = {k: [] for k in ('imgname', 'scale', 'center', 'part', 'openpose',
                          'contact_vec_pc', 'contact_vec_mirror_pc',
                          'has_contact_pc')}
    for annopath in sorted(glob.glob(osp.join(dsc_dir, subset, '*.json'))):
        with open(annopath) as f:
            anno = json.load(f)
        imgname = osp.basename(anno['img'])
        cvec, cvec_m = contact_vector(anno['contact_annot'], classes)
        idx = int(osp.splitext(imgname)[0].replace('im', '')) - 1
        if subset == 'lspet':
            gt_kp = joints_mat[:, :2, idx]
            gt_vis = joints_mat[:, 2, idx]
        else:  # lsp: visibility not annotated reliably -> all visible
            gt_kp = joints_mat[:2, :, idx].T
            gt_vis = np.ones(14)
        visible = gt_kp[gt_vis == 1]
        bbox = [visible[:, 0].min(), visible[:, 1].min(),
                visible[:, 0].max(), visible[:, 1].max()]
        center = [(bbox[2] + bbox[0]) / 2, (bbox[3] + bbox[1]) / 2]
        scale = scale_factor * max(bbox[2] - bbox[0],
                                   bbox[3] - bbox[1]) / 200
        part = np.zeros((24, 3))
        part[:14] = np.hstack([gt_kp, gt_vis.reshape(-1, 1)])

        openpose = np.asarray(anno['openpose'])
        if openpose.size == 0:
            continue
        openpose = openpose.reshape(25, 3)
        has_contact = match_op_gt_keypoints(openpose, part, 'lsp')
        if not has_contact:
            cvec[:], cvec_m[:] = 0, 0
            openpose = np.zeros((25, 3))
        db['imgname'].append(imgname)
        db['scale'].append(scale)
        db['center'].append(center)
        db['openpose'].append(openpose)
        db['part'].append(part)
        db['contact_vec_pc'].append(cvec)
        db['contact_vec_mirror_pc'].append(cvec_m)
        db['has_contact_pc'].append(has_contact)
    out_file = osp.join(out_path, f'dsc_{subset}_train.pt')
    write_db(db, out_file)
    print(f'{len(db["imgname"])} LSP({subset}) samples '
          f'({int(np.sum(db["has_contact_pc"]))} with contact) '
          f'-> {out_file}')
    return out_file


def dsc_extract(subset: str, out_path=None):
    out_path = out_path or config.DBS_PATH
    os.makedirs(out_path, exist_ok=True)
    if subset == 'df':
        return read_df_subset(config.DSC_ROOT,
                              config.IMAGE_FOLDERS['dsc_df'], out_path)
    if subset in ('lsp', 'lspet'):
        return read_lsp_subset(config.DSC_ROOT,
                               osp.dirname(
                                   config.IMAGE_FOLDERS[f'dsc_{subset}']),
                               subset, out_path)
    raise ValueError(f'unknown DSC subset {subset}')
