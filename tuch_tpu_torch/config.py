"""Asset paths the serving path reads (counterpart of tuch_tpu/config.py).

Same layout under ``data/`` as the JAX package and the reference; the root
is overridable with TUCH_DATA_DIR.
"""

import os

DATA_DIR = os.environ.get('TUCH_DATA_DIR', 'data')

SMPL_MODEL_DIR = os.path.join(DATA_DIR, 'models/smpl')
SMPL_MEAN_PARAMS = os.path.join(
    DATA_DIR, 'essentials/spin/smpl_mean_params.npz')
JOINT_REGRESSOR_TRAIN_EXTRA = os.path.join(
    DATA_DIR, 'essentials/spin/J_regressor_extra.npy')
