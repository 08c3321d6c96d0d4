"""Synthetic RAW dataset trees for hermetic preprocess runs.

Writes miniature on-disk datasets in the exact layouts the extractors
read (reference layouts: tuch/datasets/preprocess/{dsc,mtp,pw3d,
mpi_inf_3dhp}.py), so `python -m tuch_tpu_torch.cli.preprocess
--synthetic` and the end-to-end extractor tests run without any downloads.
Counterpart of tuch_tpu/data/preprocess/synthetic_raw.py, writing the same
files byte for byte from the same seeds:

- DSC: per-image annotation jsons (contact_annot pairs + flat openpose)
  + tuch_bodypart_pairs.pkl + LSP/LSPET joints.mat
- MTP: images + center-person openpose jsons + SMPLify-XMC smpl/smplx
  parameter pkls + subject_meta / train_val_split
- 3DPW: sequenceFiles/<split>/*.pkl with world-frame poses + cam_poses
- MPI-INF-3DHP: S*/Seq*/annot.mat cell arrays + imageFrames stubs;
  test TS*/annot_data.mat in the v7.3 (hdf5) layout
"""

import json
import os
import os.path as osp
import pickle

import numpy as np

BODY_PARTS = ('leftHand', 'rightHand', 'leftForeArm', 'rightForeArm',
              'leftLeg', 'rightLeg', 'head', 'hips')


def _bodypart_classes():
    """Sorted body-part pair table in the tuch_bodypart_pairs.pkl schema."""
    pairs = [sorted([a, b]) for i, a in enumerate(BODY_PARTS)
             for b in BODY_PARTS[i + 1:]]
    return np.asarray(pairs)


def _openpose_person(rng, center=(120.0, 160.0), spread=55.0, conf=0.9):
    """(25, 3) BODY25 keypoints, all confident (major-joint gate passes)."""
    kp = np.zeros((25, 3))
    kp[:, :2] = np.asarray(center) + rng.uniform(-spread, spread, (25, 2))
    kp[:, 2] = conf
    return kp


def write_dsc_raw(root, n_df=4, n_lsp=3, n_lspet=3, seed=0):
    """DSC annotation release + LSP image dirs. Returns the dir map.

    Sample 0 of each LSP subset has OpenPose far from GT, exercising the
    keep-keypoints / drop-contact mismatch path (dsc.py:148-151).
    """
    rng = np.random.RandomState(seed)
    import scipy.io as sio

    dsc_dir = osp.join(root, 'dsc')
    os.makedirs(dsc_dir, exist_ok=True)
    classes = _bodypart_classes()
    with open(osp.join(dsc_dir, 'tuch_bodypart_pairs.pkl'), 'wb') as f:
        pickle.dump(classes, f)

    annot_pool = [f'{a}_{b}' for a, b in
                  [('leftHand', 'rightHand'), ('leftForeArm', 'head'),
                   ('rightLeg', 'hips')]]

    os.makedirs(osp.join(dsc_dir, 'df'), exist_ok=True)
    for i in range(n_df):
        kp = _openpose_person(rng)
        anno = {'img': f'df_img_{i:03d}.jpg',
                'contact_annot': [annot_pool[i % len(annot_pool)]],
                'openpose': kp.reshape(-1).tolist()}
        with open(osp.join(dsc_dir, 'df', f'{i:03d}.json'), 'w') as f:
            json.dump(anno, f)

    img_root = osp.join(root, 'images')
    from tuch_tpu_torch.data.preprocess.dsc import OP_TO_12
    for subset, n in (('lsp', n_lsp), ('lspet', n_lspet)):
        os.makedirs(osp.join(dsc_dir, subset), exist_ok=True)
        sub_img_dir = osp.join(img_root, subset)
        os.makedirs(sub_img_dir, exist_ok=True)
        gt = rng.uniform(40, 260, (n, 14, 2))
        vis = np.ones((n, 14))
        if subset == 'lspet':  # (14, 3, N)
            joints = np.concatenate([gt.transpose(1, 2, 0),
                                     vis.T[:, None, :]], axis=1)
        else:  # lsp: (3, 14, N)
            joints = np.concatenate([gt.transpose(2, 1, 0),
                                     vis.T[None]], axis=0)
        sio.savemat(osp.join(sub_img_dir, 'joints.mat'), {'joints': joints})
        for i in range(n):
            kp = _openpose_person(rng)
            # align the 12 matched joints with GT => the OP-vs-GT
            # confidence-weighted distance test passes ...
            kp[OP_TO_12, :2] = gt[i, :12]
            if i == 0:  # ... except sample 0: deliberate mismatch
                kp[OP_TO_12, :2] += 120.0
            anno = {'img': f'im{i + 1:04d}.jpg',
                    'contact_annot': [annot_pool[i % len(annot_pool)]],
                    'openpose': kp.reshape(-1).tolist()}
            with open(osp.join(dsc_dir, subset, f'{i:03d}.json'),
                      'w') as f:
                json.dump(anno, f)
    return {'dsc_dir': dsc_dir, 'df_img_dir': osp.join(img_root, 'df'),
            'lsp_img_dir': osp.join(img_root, 'lsp'),
            'lspet_img_dir': osp.join(img_root, 'lspet')}


def write_mtp_raw(root, n=4, seed=0):
    """MTP tree: images/, keypoints/openpose/, smplify-xmc params."""
    rng = np.random.RandomState(seed)
    from PIL import Image

    ds_dir = osp.join(root, 'mtp')
    names = [f'mtp_{i:03d}' for i in range(n)]
    split = {'train': names[:max(1, n - 1)], 'val': names[max(1, n - 1):]}
    meta = {nm: {'SubjectGender': 'male' if i % 2 else 'female'}
            for i, nm in enumerate(names)}
    os.makedirs(ds_dir, exist_ok=True)
    with open(osp.join(ds_dir, 'subject_meta.json'), 'w') as f:
        json.dump(meta, f)
    with open(osp.join(ds_dir, 'train_val_split.json'), 'w') as f:
        json.dump(split, f)

    for sub in ('images', 'keypoints/openpose', 'smplify-xmc/smpl/params',
                'smplify-xmc/smplx/params'):
        os.makedirs(osp.join(ds_dir, sub), exist_ok=True)
    for i, nm in enumerate(names):
        img = (rng.rand(32, 24, 3) * 255).astype(np.uint8)
        Image.fromarray(img).save(osp.join(ds_dir, 'images', nm + '.png'))
        # two people; the first is nearer the image center -> selected
        people = [{'pose_keypoints_2d':
                   _openpose_person(rng, center=(12, 16), spread=6)
                   .reshape(-1).tolist()},
                  {'pose_keypoints_2d':
                   _openpose_person(rng, center=(400, 400), spread=6)
                   .reshape(-1).tolist()}]
        with open(osp.join(ds_dir, 'keypoints/openpose', nm + '.json'),
                  'w') as f:
            json.dump({'people': people}, f)
        pose = (rng.randn(72) * 0.1).astype(np.float32)
        betas = (rng.randn(10) * 0.5).astype(np.float32)
        with open(osp.join(ds_dir, 'smplify-xmc/smpl/params',
                           nm + '.pkl'), 'wb') as f:
            pickle.dump({'pose': pose, 'betas': betas}, f)
        # real SMPLify-XMC schema: camera_rotation is a (1, 3, 3)
        # rotation MATRIX and the smplx global_orient rides along
        th = np.pi / 8 * (i % 3)
        RC = np.array([[np.cos(th), -np.sin(th), 0],
                       [np.sin(th), np.cos(th), 0],
                       [0, 0, 1]], np.float32)[None]
        with open(osp.join(ds_dir, 'smplify-xmc/smplx/params',
                           nm + '.pkl'), 'wb') as f:
            pickle.dump({'camera_rotation': RC,
                         'global_orient': pose[None, :3]}, f)
    return {'ds_dir': ds_dir, 'names': names, 'split': split}


def write_pw3d_raw(root, n_frames=6, split='test', seed=0):
    """One 3DPW sequence pickle with 2 actors in the official schema."""
    rng = np.random.RandomState(seed)
    ds_dir = osp.join(root, '3dpw')
    seq_dir = osp.join(ds_dir, 'sequenceFiles', split)
    os.makedirs(seq_dir, exist_ok=True)
    F = n_frames
    n_actors = 2
    poses2d = []
    for _ in range(n_actors):
        # official 3DPW poses2d carry 18 OpenPose-COCO joints
        kp = np.zeros((F, 3, 18))
        kp[:, :2] = rng.uniform(100, 500, (F, 2, 18))
        kp[:, 2] = 0.9
        poses2d.append(kp)
    cam = np.tile(np.eye(4)[None], (F, 1, 1))
    # small camera rotation about z on later frames
    th = 0.3
    cam[F // 2:, :3, :3] = np.array([[np.cos(th), -np.sin(th), 0],
                                     [np.sin(th), np.cos(th), 0],
                                     [0, 0, 1]])
    valid = np.ones((n_actors, F))
    valid[1, 0] = 0  # actor 1 frame 0 camera-invalid -> dropped
    data = {
        'sequence': 'synthseq_00',
        'poses': [rng.randn(F, 72) * 0.1 for _ in range(n_actors)],
        'betas': [rng.randn(12) for _ in range(n_actors)],
        'poses2d': poses2d,
        'cam_poses': cam,
        'genders': ['m', 'f'],
        'campose_valid': [valid[i] for i in range(n_actors)],
    }
    with open(osp.join(seq_dir, 'synthseq_00.pkl'), 'wb') as f:
        pickle.dump(data, f)
    return {'ds_dir': ds_dir, 'n_expected': n_actors * F - 1}


def synthetic_3dhp_camera_R(vid: int) -> np.ndarray:
    """Deterministic per-video extrinsic rotation (y-axis, 15*(vid+1) deg
    -- nontrivial even for video_0, the only video with frames in the
    synthetic tree)."""
    a = np.deg2rad(15.0 * (vid + 1))
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _write_3dhp_calibration(path: str, n_vids: int):
    """camera.calibration in the layout the reference parser expects
    (tuch/datasets/preprocess/mpi_inf_3dhp.py:29-43): 7 lines per camera,
    `intrinsic` at offset 5 and `extrinsic` at offset 6, each an 11-char
    field name prefix followed by a flattened 4x4."""
    def line(key, vals=None):
        body = '' if vals is None else ' '.join(f'{v:.6f}' for v in vals)
        return f'{key:<10} {body} \n'

    with open(path, 'w') as f:
        for vid in range(n_vids):
            K = np.eye(4)
            K[0, 0] = K[1, 1] = 1500.0
            K[0, 3] = K[1, 3] = 1024.0  # (fx, fy, cx, cy in a 4x4)
            RT = np.eye(4)
            RT[:3, :3] = synthetic_3dhp_camera_R(vid)
            RT[:3, 3] = np.array([100.0 * vid, -50.0, 3000.0])  # mm
            f.write(line('camera', [float(vid)]))
            f.write(line('name', [float(vid)]))
            f.write(line('sensor', [10.0, 10.0]))
            f.write(line('size', [2048.0, 2048.0]))
            f.write(line('animated', [0.0]))
            f.write(line('intrinsic', K.reshape(-1)))
            f.write(line('extrinsic', RT.reshape(-1)))


def write_3dhp_raw(root, n_frames=12, seed=0, with_test=True):
    """MPI-INF-3DHP train tree (S1..S8 x Seq1..2 annot.mat; frames only
    under S1/Seq1/video_0) and, with_test, test tree (TS1..TS6
    annot_data.mat, HDF5: it needs h5py)."""
    rng = np.random.RandomState(seed)
    import scipy.io as sio

    ds_dir = osp.join(root, 'mpi_inf_3dhp')
    n_vids = 9
    for user_i in range(1, 9):
        for seq_i in range(1, 3):
            seq_path = osp.join(ds_dir, f'S{user_i}', f'Seq{seq_i}')
            os.makedirs(seq_path, exist_ok=True)
            annot2 = np.empty((n_vids, 1), dtype=object)
            annot3 = np.empty((n_vids, 1), dtype=object)
            for v in range(n_vids):
                j2 = rng.uniform(200, 1800, (n_frames, 28, 2))
                annot2[v, 0] = j2.reshape(n_frames, 56)
                j3 = rng.uniform(-800, 800, (n_frames, 28, 3))
                annot3[v, 0] = j3.reshape(n_frames, 84)
            sio.savemat(osp.join(seq_path, 'annot.mat'),
                        {'annot2': annot2, 'annot3': annot3})
            _write_3dhp_calibration(
                osp.join(seq_path, 'camera.calibration'), n_vids)
            if user_i == 1 and seq_i == 1:
                frames_dir = osp.join(seq_path, 'imageFrames', 'video_0')
                os.makedirs(frames_dir, exist_ok=True)
                for i in range(n_frames):
                    open(osp.join(frames_dir,
                                  f'frame_{i + 1:06d}.jpg'), 'wb').close()

    if not with_test:
        return {'ds_dir': ds_dir, 'n_train_vids_with_frames': 1,
                'n_test_expected': 0}
    import h5py
    F = 4
    for ts in range(1, 7):
        ts_dir = osp.join(ds_dir, 'mpi_inf_3dhp_test_set', f'TS{ts}')
        os.makedirs(ts_dir, exist_ok=True)
        with h5py.File(osp.join(ts_dir, 'annot_data.mat'), 'w') as m:
            # keep joints inside even the 1920x1080 TS5/TS6 frames
            j2 = rng.uniform(100, 1000, (F, 1, 17, 2))
            j2[0, 0, 0, 0] = 2400.0  # frame 0: joint out of view -> drop
            m['annot2'] = j2
            m['annot3'] = rng.uniform(-900, 900, (F, 1, 17, 3))
            # the extractor must use the UNIVERSAL annotations
            m['univ_annot3'] = rng.uniform(-900, 900, (F, 1, 17, 3))
            valid = np.ones((F, 1))
            valid[-1] = 0  # last frame invalid -> dropped
            m['valid_frame'] = valid
    return {'ds_dir': ds_dir, 'n_train_vids_with_frames': 1,
            'n_test_expected': 6 * (F - 2)}  # -1 invalid, -1 out-of-view
