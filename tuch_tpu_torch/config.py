"""Asset paths, contact thresholds, run configurations and the flag parser
of the CLIs.

Counterpart of tuch_tpu/config.py: the same layout under ``data/`` as the
JAX package and the reference (root overridable with TUCH_DATA_DIR, image
datasets under TUCH_DS_DIR), and a copy of its dataclass flag parser,
which keeps the reference's flag names and ``--from_json`` overrides.
"""

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import List, Optional

DS_DIR = os.environ.get('TUCH_DS_DIR', '')
DATA_DIR = os.environ.get('TUCH_DATA_DIR', 'data')

DBS_PATH = os.path.join(DATA_DIR, 'dbs')
DATASET_FILES = {
    'train': {
        'dsc_df': os.path.join(DBS_PATH, 'dsc_df_train.pt'),
        'dsc_lspet': os.path.join(DBS_PATH, 'dsc_lspet_train.pt'),
        'dsc_lsp': os.path.join(DBS_PATH, 'dsc_lsp_train.pt'),
        'mtp': os.path.join(DBS_PATH, 'mtp_train.pt'),
    },
}
IMAGE_FOLDERS = {
    'mtp': os.path.join(DS_DIR, 'mtp/images'),
    'dsc_df': os.path.join(DS_DIR, 'dsc/images/df/images'),
    'dsc_lspet': os.path.join(DS_DIR, 'dsc/images/lspet/images'),
    'dsc_lsp': os.path.join(DS_DIR, 'dsc/images/lsp/images'),
}

SMPL_MODEL_DIR = os.path.join(DATA_DIR, 'models/smpl')
SMPL_MEAN_PARAMS = os.path.join(
    DATA_DIR, 'essentials/spin/smpl_mean_params.npz')
JOINT_REGRESSOR_TRAIN_EXTRA = os.path.join(
    DATA_DIR, 'essentials/spin/J_regressor_extra.npy')
PRIOR_FOLDER = os.path.join(DATA_DIR, 'essentials/spin')
GEODESICS_SMPL = os.path.join(
    DATA_DIR, 'essentials/geodesics/smpl/smpl_neutral_geodesic_dist.npy')
SEGMENT_DIR = os.path.join(DATA_DIR, 'essentials/segments/smpl')
DSC_ROOT = os.path.join(DS_DIR, 'dsc/release')
HD_MODEL_DIR = os.path.join(DATA_DIR, 'essentials/hd_model/smpl')

# Contact thresholds: vertex pairs geodesically closer than geothres are
# never contact partners; euclthres is the in-contact distance of training.
geothres = 0.3
euclthres = 0.02


@dataclass
class SMPLifyDemoConfig:
    """Flags of demo_smplify_dc: the subset of the JAX package's
    SMPLifyDemoConfig that the demo and its dataset read, plus --device.
    The port's demo writes no files, so it has no log or output dir."""
    checkpoint: Optional[str] = None
    from_json: Optional[str] = None
    img_res: int = 224
    ds_names: List[str] = field(
        default_factory=lambda: ['dsc_df', 'dsc_lspet', 'dsc_lsp'])
    rot_factor: float = 30.0
    noise_factor: float = 0.4
    scale_factor: float = 0.25
    ignore_3d: bool = False
    rotate_pose_3d: bool = False
    seed: int = 0
    num_smplify_iters: int = 10
    use_contact_in_the_loop: bool = True
    contact_in_the_loop_loss_weight: float = 2000.0
    synthetic: bool = False
    synthetic_num_verts: int = 0
    backbone: str = 'resnet50'
    num_images: int = 4
    # torch device; None = CUDA (raises without a card)
    device: Optional[str] = None


@dataclass
class TrainConfig:
    """The flags the training step reads (train/module.py), with the JAX
    package's TrainConfig names and defaults; what only the trainer reads
    (data, logging, checkpoints, schedule) comes with the trainer."""
    lr: float = 1e-5
    batch_size: int = 64
    img_res: int = 224
    backbone: str = 'resnet50'

    shape_loss_weight: float = 0.0
    keypoint_loss_weight: float = 5.0
    pose_loss_weight: float = 1.0
    beta_loss_weight: float = 0.01
    contact_loss_weight: float = 1e-5
    openpose_train_weight: float = 1.0
    gt_train_weight: float = 1.0

    run_smplify: bool = False
    smplify_threshold: float = 100.0
    num_smplify_iters: int = 10
    use_contact_in_the_loop: bool = True
    contact_in_the_loop_loss_weight: float = 2000.0
    # refresh the in-loop winding test every K iterations (1: every one)
    smplify_exterior_refresh: int = 1
    # winding test only at K candidate vertices, in the in-loop fit and the
    # regressor contact loss (0: all V)
    contact_candidate_k: int = 0
    # run the in-loop contact quadratics for at most this many
    # contact-active samples (0: the whole batch)
    smplify_contact_capacity: int = 0
    # the same compaction for the regressor contact loss over valid fits
    regressor_contact_capacity: int = 0
    # dense-surface contact in the regressor loss, on hd_k HD points
    use_hd: bool = True
    hd_k: int = 1024


def _add_dataclass_args(parser: argparse.ArgumentParser, cls):
    for f in dataclasses.fields(cls):
        default = f.default if f.default is not dataclasses.MISSING else (
            f.default_factory() if f.default_factory is not dataclasses.MISSING
            else None)
        arg = '--' + f.name
        if isinstance(default, bool):
            parser.add_argument(arg, type=lambda x: str(x).lower() in
                                ('true', '1', 'yes'), nargs='?', const=True,
                                default=default)
            parser.add_argument('--no_' + f.name, dest=f.name,
                                action='store_false')
        elif isinstance(default, list):
            elem_t = float if default and isinstance(default[0], float) \
                else str
            parser.add_argument(arg, nargs='+', type=elem_t, default=default)
        elif isinstance(default, float):
            parser.add_argument(arg, type=float, default=default)
        elif isinstance(default, int):
            parser.add_argument(arg, type=int, default=default)
        else:
            parser.add_argument(arg, type=str, default=default)


def parse_config(cls=SMPLifyDemoConfig, argv=None):
    """Build a config from CLI flags; --from_json overrides them."""
    parser = argparse.ArgumentParser()
    _add_dataclass_args(parser, cls)
    args = parser.parse_args(argv)
    known = {f.name for f in dataclasses.fields(cls)}
    cfg = cls(**{k: v for k, v in vars(args).items() if k in known})
    if cfg.from_json:
        with open(cfg.from_json) as f:
            for k, v in json.load(f).items():
                if k in known:
                    setattr(cfg, k, v)
    return cfg
