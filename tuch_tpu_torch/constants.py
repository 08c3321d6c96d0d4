"""Constants of the ported paths (counterpart of tuch_tpu/constants.py).

Data-format constants of the SPIN/TUCH conventions: camera, input
normalisation, SMPL sizes, the 21 surface-vertex joints, the map of the
49-joint convention into the 54-joint SMPL output, and the flip
permutations of the data pipeline.
"""

import numpy as np

FOCAL_LENGTH = 5000.0
IMG_RES = 224

# Mean and standard deviation for normalizing the input image (ImageNet).
IMG_NORM_MEAN = [0.485, 0.456, 0.406]
IMG_NORM_STD = [0.229, 0.224, 0.225]

# The 49-joint convention: 25 OpenPose BODY25 joints, then 24 "ground truth"
# joints aggregated over datasets.
JOINT_NAMES = [
    'OP Nose', 'OP Neck', 'OP RShoulder',
    'OP RElbow', 'OP RWrist', 'OP LShoulder',
    'OP LElbow', 'OP LWrist', 'OP MidHip',
    'OP RHip', 'OP RKnee', 'OP RAnkle',
    'OP LHip', 'OP LKnee', 'OP LAnkle',
    'OP REye', 'OP LEye', 'OP REar',
    'OP LEar', 'OP LBigToe', 'OP LSmallToe',
    'OP LHeel', 'OP RBigToe', 'OP RSmallToe', 'OP RHeel',
    'Right Ankle', 'Right Knee', 'Right Hip',
    'Left Hip', 'Left Knee', 'Left Ankle',
    'Right Wrist', 'Right Elbow', 'Right Shoulder',
    'Left Shoulder', 'Left Elbow', 'Left Wrist',
    'Neck (LSP)', 'Top of Head (LSP)',
    'Pelvis (MPII)', 'Thorax (MPII)',
    'Spine (H36M)', 'Jaw (H36M)',
    'Head (H36M)', 'Nose', 'Left Eye',
    'Right Eye', 'Left Ear', 'Right Ear',
]

# Joints of the 49-convention -> indices in the 54-joint SMPL output
# (24 skeleton joints + 21 selected surface vertices + 9 extra regressed).
JOINT_MAP = {
    'OP Nose': 24, 'OP Neck': 12, 'OP RShoulder': 17,
    'OP RElbow': 19, 'OP RWrist': 21, 'OP LShoulder': 16,
    'OP LElbow': 18, 'OP LWrist': 20, 'OP MidHip': 0,
    'OP RHip': 2, 'OP RKnee': 5, 'OP RAnkle': 8,
    'OP LHip': 1, 'OP LKnee': 4, 'OP LAnkle': 7,
    'OP REye': 25, 'OP LEye': 26, 'OP REar': 27,
    'OP LEar': 28, 'OP LBigToe': 29, 'OP LSmallToe': 30,
    'OP LHeel': 31, 'OP RBigToe': 32, 'OP RSmallToe': 33, 'OP RHeel': 34,
    'Right Ankle': 8, 'Right Knee': 5, 'Right Hip': 45,
    'Left Hip': 46, 'Left Knee': 4, 'Left Ankle': 7,
    'Right Wrist': 21, 'Right Elbow': 19, 'Right Shoulder': 17,
    'Left Shoulder': 16, 'Left Elbow': 18, 'Left Wrist': 20,
    'Neck (LSP)': 47, 'Top of Head (LSP)': 48,
    'Pelvis (MPII)': 49, 'Thorax (MPII)': 50,
    'Spine (H36M)': 51, 'Jaw (H36M)': 52,
    'Head (H36M)': 53, 'Nose': 24, 'Left Eye': 26,
    'Right Eye': 25, 'Left Ear': 28, 'Right Ear': 27,
}

JOINT_MAP_49 = np.array([JOINT_MAP[name] for name in JOINT_NAMES],
                        dtype=np.int32)
JOINT_IDS = {name: i for i, name in enumerate(JOINT_NAMES)}

# Joint selectors of evaluation: the H36M regressor's 17 joints, and the
# 24 ground-truth joints, to the 17- and 14-joint subsets.
H36M_TO_J17 = [6, 5, 4, 1, 2, 3, 16, 15, 14, 11, 12, 13, 8, 10, 0, 7, 9]
H36M_TO_J14 = H36M_TO_J17[:14]
J24_TO_J17 = [14, 3, 4, 5, 2, 1, 0, 16, 12, 17, 18, 9, 10, 11, 8, 7, 6]
J24_TO_J14 = J24_TO_J17[:14]

# Permutations under a horizontal flip: SMPL joints (and their 72 pose
# entries), the 24 ground-truth joints and the full 49.
SMPL_JOINTS_FLIP_PERM = [0, 2, 1, 3, 5, 4, 6, 8, 7, 9, 11, 10, 12, 14, 13,
                         15, 17, 16, 19, 18, 21, 20, 23, 22]
SMPL_POSE_FLIP_PERM = [3 * i + k for i in SMPL_JOINTS_FLIP_PERM
                       for k in range(3)]
J24_FLIP_PERM = [5, 4, 3, 2, 1, 0, 11, 10, 9, 8, 7, 6, 12, 13, 14, 15, 16,
                 17, 18, 19, 21, 20, 23, 22]
J49_FLIP_PERM = [0, 1, 5, 6, 7, 2, 3, 4, 8, 12, 13, 14, 9, 10, 11, 16, 15,
                 18, 17, 22, 23, 24, 19, 20, 21] \
    + [25 + i for i in J24_FLIP_PERM]

# COCO 17-keypoint ordering -> OpenPose BODY25 slots (used by preprocessing).
COCO_TO_BODY25 = [0, 16, 15, 18, 17, 5, 2, 6, 3, 7, 4, 12, 9, 13, 10, 14, 11]
# OpenPose COCO-18 ordering (nose, neck, rsho..lwri, rhip..lank, eyes,
# ears) -> BODY25 slots. 3DPW's poses2d ships 18 joints in this order
# (data/preprocess/pw3d.py).
COCO18_TO_BODY25 = [0, 1, 2, 3, 4, 5, 6, 7, 9, 10, 11, 12, 13, 14, 15,
                    16, 17, 18]

# SMPL surface vertex ids used as extra "joints" (the smplh vertex-id table),
# appended after the 24 skeleton joints as joints 24..44 in this order.
VERTEX_JOINT_IDS = {
    'nose': 332, 'reye': 6260, 'leye': 2800, 'rear': 4071, 'lear': 583,
    'LBigToe': 3216, 'LSmallToe': 3226, 'LHeel': 3387,
    'RBigToe': 6617, 'RSmallToe': 6624, 'RHeel': 6787,
    'lthumb': 2746, 'lindex': 2319, 'lmiddle': 2445, 'lring': 2556,
    'lpinky': 2673,
    'rthumb': 6191, 'rindex': 5782, 'rmiddle': 5905, 'rring': 6016,
    'rpinky': 6133,
}
VERTEX_JOINT_ORDER = [
    'nose', 'reye', 'leye', 'rear', 'lear',
    'LBigToe', 'LSmallToe', 'LHeel', 'RBigToe', 'RSmallToe', 'RHeel',
    'lthumb', 'lindex', 'lmiddle', 'lring', 'lpinky',
    'rthumb', 'rindex', 'rmiddle', 'rring', 'rpinky',
]

# SMPL topology sizes.
SMPL_NUM_VERTS = 6890
SMPL_NUM_FACES = 13776
SMPL_NUM_JOINTS = 24
SMPL_NUM_BETAS = 10
SMPL_POSE_DIM = 72  # 24 * 3 axis-angle
