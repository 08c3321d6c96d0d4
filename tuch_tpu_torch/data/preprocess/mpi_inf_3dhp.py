"""Offline extraction of MPI-INF-3DHP train/test sets.

Reference: tuch/datasets/preprocess/mpi_inf_3dhp.py (SPIN-style). Reads the
annot.mat files, maps the 28-joint skeleton to 17 joints, builds bboxes
from 2D joints, subsamples every 10th training frame, and (optionally)
extracts video frames (needs cv2 if requested).
Counterpart of tuch_tpu/data/preprocess/mpi_inf_3dhp.py; writes each database
as a plain pickle (data/preprocess.write_db) where it writes joblib.
"""

import glob
import os
import os.path as osp

import numpy as np

from tuch_tpu_torch import config
from tuch_tpu_torch.data.preprocess import write_db

# 24-joint GT convention slots filled by the 17 H36M-style joints.
JOINTS_IDX = [14, 3, 4, 5, 2, 1, 0, 16, 12, 17, 18, 9, 10, 11, 8, 7, 6]
TRAIN_J17 = [4, 18, 19, 20, 23, 24, 25, 3, 5, 6, 7, 9, 10, 11, 14, 15, 16]
TEST_J17 = [14, 11, 12, 13, 8, 9, 10, 15, 1, 16, 0, 5, 6, 7, 2, 3, 4]


def read_calibration(calib_file, vid_list):
    """Per-video camera intrinsics/extrinsics from `camera.calibration`.

    Port of the reference parser (tuch/datasets/preprocess/
    mpi_inf_3dhp.py:29-43): each camera occupies 7 lines; the `intrinsic`
    line is vid*7+5 and the `extrinsic` line vid*7+6, both holding a
    whitespace-separated 4x4 after an 11-char field prefix. Returns
    (Ks (4,4), Rs (3,3), Ts (3,) in meters) lists aligned with vid_list.
    """
    Ks, Rs, Ts = [], [], []
    with open(calib_file) as f:
        content = f.readlines()
    for vid_i in vid_list:
        K = np.array([float(s)
                      for s in content[vid_i * 7 + 5][11:-2].split()])
        RT = np.array([float(s)
                       for s in content[vid_i * 7 + 6][11:-2].split()])
        K, RT = K.reshape(4, 4), RT.reshape(4, 4)
        Ks.append(K)
        Rs.append(RT[:3, :3])
        Ts.append(RT[:3, 3] / 1000)
    return Ks, Rs, Ts


def camera_axis_angle(R: np.ndarray) -> np.ndarray:
    """cv2.Rodrigues(R)[0].T[0] equivalent (reference :109), pure numpy."""
    from tuch_tpu_torch.data.transforms import rotmat_to_aa_np
    return rotmat_to_aa_np(np.asarray(R, np.float64))


def extract_frames(seq_path: str, vid_i: int):
    """Optional video -> jpg extraction (needs cv2, and raises without
    it: the frames are asked for)."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError('3DHP frame extraction (--extract_img) needs cv2 '
                          '(opencv-python), which is not installed') from e
    imgs_path = osp.join(seq_path, 'imageFrames', f'video_{vid_i}')
    os.makedirs(imgs_path, exist_ok=True)
    vid_file = osp.join(seq_path, 'imageSequence', f'video_{vid_i}.avi')
    cap = cv2.VideoCapture(vid_file)
    frame = 0
    while True:
        ok, image = cap.read()
        if not ok:
            break
        frame += 1
        cv2.imwrite(osp.join(imgs_path, f'frame_{frame:06d}.jpg'), image)


def train_data(dataset_path, out_path, scale_factor=1.2,
               extract_img=False, subsample=10, fits_3d=None,
               fold_camera=False):
    """Train-set extraction (reference train_data, mpi_inf_3dhp.py:45-183).

    fits_3d: optional path to a SPIN/mview static-fits npz with
    pose/shape[/has_smpl] arrays aligned with the retained samples; merged
    into the output like the reference (:160-176).

    fold_camera: rotate the fits' global orients into each video's camera
    frame using the per-sequence calibration (cam_aa). The reference
    computes cam_aa (:109) but never applies it -- its SPIN fits are
    already camera-frame -- so False is reference semantics; True is the
    correct setting for WORLD-frame fits (e.g. the commented-out mview
    fits path, :261-262).
    """
    import scipy.io as sio
    h = w = 2048
    db = {k: [] for k in ('imgname', 'center', 'scale', 'part', 'S',
                          'openpose')}
    cam_aas = []
    counter = 0
    for user_i in range(1, 9):
        for seq_i in range(1, 3):
            seq_path = osp.join(dataset_path, f'S{user_i}', f'Seq{seq_i}')
            annot = sio.loadmat(osp.join(seq_path, 'annot.mat'))
            annot2, annot3 = annot['annot2'], annot['annot3']
            vid_list = list(range(3)) + list(range(4, 9))
            calib_file = osp.join(seq_path, 'camera.calibration')
            if osp.isfile(calib_file):
                _, Rs, _ = read_calibration(calib_file, vid_list)
                seq_cam_aa = [camera_axis_angle(R) for R in Rs]
            elif fold_camera:
                raise FileNotFoundError(
                    f'fold_camera=True requires {calib_file}')
            else:
                seq_cam_aa = [np.zeros(3)] * len(vid_list)
            for j, vid_i in enumerate(vid_list):
                if extract_img:
                    extract_frames(seq_path, vid_i)
                cam_aa = seq_cam_aa[j]
                imgs_path = osp.join(seq_path, 'imageFrames',
                                     f'video_{vid_i}')
                for i, img_i in enumerate(sorted(glob.glob(
                        osp.join(imgs_path, '*.jpg')))):
                    joints = np.reshape(annot2[vid_i][0][i],
                                        (28, 2))[TRAIN_J17]
                    S17 = np.reshape(annot3[vid_i][0][i], (28, 3)) / 1000
                    S17 = S17[TRAIN_J17] - S17[4]  # root-center (joint 4)
                    bbox = [joints[:, 0].min(), joints[:, 1].min(),
                            joints[:, 0].max(), joints[:, 1].max()]
                    center = [(bbox[2] + bbox[0]) / 2,
                              (bbox[3] + bbox[1]) / 2]
                    scale = scale_factor * max(bbox[2] - bbox[0],
                                               bbox[3] - bbox[1]) / 200
                    inside = ((joints[:, 0] >= 0) & (joints[:, 0] < w)
                              & (joints[:, 1] >= 0) & (joints[:, 1] < h))
                    if inside.sum() < len(JOINTS_IDX):
                        continue
                    counter += 1
                    if subsample > 1 and counter % subsample != 1:
                        continue
                    part = np.zeros((24, 3))
                    part[JOINTS_IDX] = np.hstack([joints, np.ones((17, 1))])
                    S = np.zeros((24, 4))
                    S[JOINTS_IDX] = np.hstack([S17, np.ones((17, 1))])
                    db['imgname'].append(osp.join(
                        f'S{user_i}', f'Seq{seq_i}', 'imageFrames',
                        f'video_{vid_i}', osp.basename(img_i)))
                    db['center'].append(center)
                    db['scale'].append(scale)
                    db['part'].append(part)
                    db['S'].append(S)
                    db['openpose'].append(np.zeros((25, 3)))
                    cam_aas.append(cam_aa)
    if fits_3d is not None:
        # Merge static fits aligned with the retained samples
        # (reference :160-176).
        fits = np.load(fits_3d)
        pose = np.asarray(fits['pose'], np.float64).copy()
        if len(pose) != len(db['imgname']):
            raise ValueError(
                f'static fits have {len(pose)} rows but extraction kept '
                f'{len(db["imgname"])} samples -- the fits must come from '
                f'the same extraction pass')
        if fold_camera:
            from tuch_tpu_torch.data.preprocess.mtp import \
                fold_camera_rotation
            for n in range(len(pose)):
                pose[n, :3] = fold_camera_rotation(pose[n, :3], cam_aas[n])
        db['pose'] = pose
        # the repo's dataset schema calls this 'betas'
        # (data/dataset.py reads data['betas']); the reference npz key
        # is 'shape' (mpi_inf_3dhp.py:173)
        db['betas'] = np.asarray(fits['shape'])
        db['has_smpl'] = (np.asarray(fits['has_smpl'])
                          if 'has_smpl' in getattr(fits, 'files', fits)
                          else np.ones(len(db['imgname'])))
    else:
        db['has_smpl'] = np.zeros(len(db['imgname']))
    out_file = osp.join(out_path, 'mpi_inf_3dhp_train.pt')
    write_db(db, out_file)
    print(f'{len(db["imgname"])} 3DHP train samples -> {out_file}')
    return out_file


def test_data(dataset_path, out_path, scale_factor=1.2):
    import h5py
    db = {k: [] for k in ('imgname', 'center', 'scale', 'part', 'S')}
    for user_i in range(1, 7):
        seq_path = osp.join(dataset_path, 'mpi_inf_3dhp_test_set',
                            f'TS{user_i}')
        with h5py.File(osp.join(seq_path, 'annot_data.mat'), 'r') as m:
            annot2 = np.asarray(m['annot2'])
            # the reference evaluates against the UNIVERSAL (height-
            # normalized) 3D joints (mpi_inf_3dhp.py:203)
            annot3 = np.asarray(m['univ_annot3'])
            valid = np.asarray(m['valid_frame']).reshape(-1)
        for frame_i, valid_i in enumerate(valid):
            if not valid_i:
                continue
            joints = annot2[frame_i, 0, TEST_J17, :]
            S17 = annot3[frame_i, 0, TEST_J17, :] / 1000
            S17 = S17 - S17[0]
            # all-joints-visible filter (reference :223-230); image size
            # read per frame, falling back to the dataset's 2048x2048
            # when frames aren't extracted alongside the annotations
            img_file = osp.join(dataset_path, 'mpi_inf_3dhp_test_set',
                                f'TS{user_i}', 'imageSequence',
                                f'img_{frame_i + 1:06d}.jpg')
            if osp.isfile(img_file):
                from PIL import Image
                with Image.open(img_file) as im:
                    w_img, h_img = im.width, im.height
            elif user_i >= 5:
                # TS5/TS6 are 1920x1080 outdoor sequences; TS1-4 are
                # 2048x2048 (official 3DHP test-set resolutions)
                w_img, h_img = 1920, 1080
            else:
                h_img = w_img = 2048
            inside = ((joints[:, 0] >= 0) & (joints[:, 0] < w_img)
                      & (joints[:, 1] >= 0) & (joints[:, 1] < h_img))
            if inside.sum() < len(JOINTS_IDX):
                continue
            bbox = [joints[:, 0].min(), joints[:, 1].min(),
                    joints[:, 0].max(), joints[:, 1].max()]
            center = [(bbox[2] + bbox[0]) / 2, (bbox[3] + bbox[1]) / 2]
            scale = scale_factor * max(bbox[2] - bbox[0],
                                       bbox[3] - bbox[1]) / 200
            part = np.zeros((24, 3))
            part[JOINTS_IDX] = np.hstack([joints, np.ones((17, 1))])
            S = np.zeros((24, 4))
            S[JOINTS_IDX] = np.hstack([S17, np.ones((17, 1))])
            db['imgname'].append(osp.join(
                f'mpi_inf_3dhp_test_set/TS{user_i}/imageSequence',
                f'img_{frame_i + 1:06d}.jpg'))
            db['center'].append(center)
            db['scale'].append(scale)
            db['part'].append(part)
            db['S'].append(S)
    out_file = osp.join(out_path, 'mpi_inf_3dhp_test.pt')
    write_db(db, out_file)
    print(f'{len(db["imgname"])} 3DHP test samples -> {out_file}')
    return out_file


def mpi_inf_3dhp_extract(dataset_path=None, out_path=None, mode='train',
                         extract_img=False, static_fits=None,
                         fold_camera=False):
    """Entry (reference mpi_inf_3dhp_extract, mpi_inf_3dhp.py:255-272).

    static_fits: directory holding `mpi_inf_3dhp_spin_fits.npz`
    (reference :264) or a direct path to a fits npz. fold_camera: see
    train_data (False == reference semantics).
    """
    dataset_path = dataset_path or config.IMAGE_FOLDERS['mpi-inf-3dhp']
    out_path = out_path or config.DBS_PATH
    os.makedirs(out_path, exist_ok=True)
    fits_3d = None
    if static_fits is not None:
        fits_3d = (static_fits if osp.isfile(static_fits)
                   else osp.join(static_fits, 'mpi_inf_3dhp_spin_fits.npz'))
    if mode == 'train':
        return train_data(dataset_path, out_path, extract_img=extract_img,
                          fits_3d=fits_3d, fold_camera=fold_camera)
    return test_data(dataset_path, out_path)
