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
        'mpi-inf-3dhp': os.path.join(DBS_PATH, 'mpi_inf_3dhp_train.pt'),
        'dsc_df': os.path.join(DBS_PATH, 'dsc_df_train.pt'),
        'dsc_lspet': os.path.join(DBS_PATH, 'dsc_lspet_train.pt'),
        'dsc_lsp': os.path.join(DBS_PATH, 'dsc_lsp_train.pt'),
        'mtp': os.path.join(DBS_PATH, 'mtp_train.pt'),
        '3dpw': os.path.join(DBS_PATH, '3dpw_train.pt'),
        'dsc_df_eft': os.path.join(DBS_PATH, 'dsc_df_eft_train.pt'),
        'dsc_lspet_eft': os.path.join(DBS_PATH, 'dsc_lspet_eft_train.pt'),
        'dsc_lsp_eft': os.path.join(DBS_PATH, 'dsc_lsp_eft_train.pt'),
    },
    'val': {'mtp': os.path.join(DBS_PATH, 'mtp_val.pt')},
    'test': {
        'mpi-inf-3dhp': os.path.join(DBS_PATH, 'mpi_inf_3dhp_test.pt'),
        '3dpw': os.path.join(DBS_PATH, '3dpw_test.pt'),
    },
}
IMAGE_FOLDERS = {
    'mpi-inf-3dhp': os.path.join(DS_DIR, 'mpi_inf_3dhp'),
    '3dpw': os.path.join(DS_DIR, '3DPW'),
    'mtp': os.path.join(DS_DIR, 'mtp/images'),
    'dsc_df': os.path.join(DS_DIR, 'dsc/images/df/images'),
    'dsc_lspet': os.path.join(DS_DIR, 'dsc/images/lspet/images'),
    'dsc_lsp': os.path.join(DS_DIR, 'dsc/images/lsp/images'),
    'dsc_df_eft': os.path.join(DS_DIR, 'dsc/images/df/images'),
    'dsc_lspet_eft': os.path.join(DS_DIR, 'dsc/images/lspet/images'),
    'dsc_lsp_eft': os.path.join(DS_DIR, 'dsc/images/lsp/images'),
}

SMPL_MODEL_DIR = os.path.join(DATA_DIR, 'models/smpl')
SMPL_MEAN_PARAMS = os.path.join(
    DATA_DIR, 'essentials/spin/smpl_mean_params.npz')
JOINT_REGRESSOR_TRAIN_EXTRA = os.path.join(
    DATA_DIR, 'essentials/spin/J_regressor_extra.npy')
JOINT_REGRESSOR_H36M = os.path.join(
    DATA_DIR, 'essentials/spin/J_regressor_h36m.npy')
STATIC_FITS_DIR = os.path.join(DATA_DIR, 'static_fits')
THREEDPW_CIG = os.path.join(DATA_DIR, 'essentials/3dpw_test_csig_pc.npy')
PRIOR_FOLDER = os.path.join(DATA_DIR, 'essentials/spin')
SPIN_MODEL_CHECKPOINT = os.path.join(DATA_DIR, 'spin_model_checkpoint.pt')
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
    The renders go to out_dir, or with out_dir '' to log_dir/name."""
    name: str = 'tuch'
    log_dir: str = 'logs'
    out_dir: str = ''
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
    # resnet50, a models/vit.py config (vit_s16, ...) or hmr2_vith16 (HMR
    # 2.0, 4D-Humans; built for img_res crops; seeded weights until its
    # released checkpoint is in the repository)
    backbone: str = 'resnet50'
    num_images: int = 4
    # torch device; None = CUDA (raises without a card)
    device: Optional[str] = None


@dataclass
class TrainConfig:
    """The flags of cli/train, with the JAX package's TrainConfig names and
    defaults (the reference's TrainOptions), plus --device.

    mesh_dp and mesh_cp are the JAX package's device mesh: one process per
    rank (torchrun --nproc_per_node dp*cp), parallel/mesh.py."""
    name: str = 'tuch'
    time_to_run: float = float('inf')
    resume: bool = False
    num_workers: int = 8
    pin_memory: bool = True
    log_dir: str = 'logs'
    checkpoint: Optional[str] = None
    from_json: Optional[str] = None
    pretrained_checkpoint: Optional[str] = None

    num_epochs: int = 6
    lr: float = 1e-5
    batch_size: int = 64
    summary_freq: float = 0.5
    val_and_checkpoint_freq: float = 0.5
    img_res: int = 224

    ds_names: List[str] = field(default_factory=lambda: ['dsc', 'mtp'])
    ds_composition: List[float] = field(default_factory=lambda: [0.5, 0.5])
    shuffle_train: bool = True

    rot_factor: float = 30.0
    noise_factor: float = 0.4
    scale_factor: float = 0.25
    ignore_3d: bool = False

    shape_loss_weight: float = 0.0
    keypoint_loss_weight: float = 5.0
    pose_loss_weight: float = 1.0
    beta_loss_weight: float = 0.01
    contact_loss_weight: float = 1e-5
    openpose_train_weight: float = 1.0
    gt_train_weight: float = 1.0

    run_smplify: bool = False
    # directory of {ds}_fits.npy warm-start fits; '' = STATIC_FITS_DIR when
    # it exists, 'none' = no seeding (checkpoint fits take priority)
    static_fits_dir: str = ''
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
    # fill the four knobs above with the JAX package's speed profile,
    # each only where the user left it alone (finalize)
    fast_profile: bool = False

    # rotate the 3D keypoints with the image (False: the reference's dead
    # rotation branch, 3D keypoints not rotated)
    rotate_pose_3d: bool = False
    # --synthetic body size (0: the full 6890-vertex topology)
    synthetic_num_verts: int = 0
    grad_clip: float = 0.0           # global-norm gradient clip (0: off)
    synthetic: bool = False          # synthetic assets and data
    # --synthetic only: 2D keypoints projected from the db's own SMPL joints
    synthetic_projected_kpts: bool = False
    # dense-surface contact in the regressor loss, on hd_k HD points
    use_hd: bool = True
    hd_k: int = 1024
    mesh_dp: int = 0                 # data-parallel devices (0: all)
    mesh_cp: int = 1                 # contact-parallel devices
    compute_dtype: str = 'float32'   # or 'bfloat16' for the backbone
    # the JAX package's space-to-depth stem, a TPU layout of the same
    # function: accepted, and the plain 7x7 stem here (models/hmr)
    stem_s2d: bool = False
    # resnet50, a models/vit.py config (vit_s16, ...) or hmr2_vith16 (HMR
    # 2.0, 4D-Humans; built for img_res crops; seeded weights until its
    # released checkpoint is in the repository)
    backbone: str = 'resnet50'
    seed: int = 0
    # torch device ('cuda' raises without a card; 'cpu' to run there)
    device: str = 'cuda'

    # derived (finalize)
    summary_dir: str = ''
    checkpoint_dir: str = ''
    _finalized: bool = False
    # the flags the user set (CLI tokens, --from_json keys): parse_config
    # records them so that fast_profile leaves them alone
    _explicit: tuple = ()

    def _untouched(self, name, default):
        """Whether fast_profile may fill `name`: not set by the user (by
        the parse_config record, else by comparison with the default)."""
        if self._explicit:
            return name not in self._explicit
        return getattr(self, name) == default

    def finalize(self):
        """Apply fast_profile, resolve log_dir/name, make the summary and
        checkpoint directories and write config.json."""
        if self.fast_profile:
            if self._untouched('smplify_exterior_refresh', 1):
                self.smplify_exterior_refresh = 4
            if self._untouched('contact_candidate_k', 0):
                self.contact_candidate_k = 984
            if self._untouched('smplify_contact_capacity', 0):
                self.smplify_contact_capacity = (5 * self.batch_size) // 8
            if self._untouched('regressor_contact_capacity', 0):
                self.regressor_contact_capacity = (5 * self.batch_size) // 8
        if not self._finalized:
            self.log_dir = os.path.join(os.path.abspath(self.log_dir),
                                        self.name)
        self._finalized = True
        self.summary_dir = os.path.join(self.log_dir, 'tensorboard')
        self.checkpoint_dir = os.path.join(self.log_dir, 'checkpoints')
        os.makedirs(self.summary_dir, exist_ok=True)
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        # the ranks of a mesh all write it: each whole, by rename
        path = os.path.join(self.log_dir, 'config.json')
        tmp = f'{path}.{os.getpid()}.tmp'
        with open(tmp, 'w') as f:
            json.dump(dataclasses.asdict(self), f, indent=4, default=str)
        os.replace(tmp, path)
        return self


def mesh_wanted(options) -> bool:
    """Whether a run builds a (dp, cp) mesh: --mesh_dp or --mesh_cp above
    1 (the JAX package's rule), or a world of several ranks."""
    from tuch_tpu_torch.parallel.multihost import world
    return (getattr(options, 'mesh_cp', 1) > 1
            or getattr(options, 'mesh_dp', 0) > 1 or world()[1] > 1)


def check_mesh(options):
    """Raise unless the mesh that --mesh_dp and --mesh_cp ask for fits the
    world size (one process per rank, e.g. torchrun --nproc_per_node
    dp*cp); call it after parallel/multihost.maybe_initialize_distributed."""
    if mesh_wanted(options):
        from tuch_tpu_torch.parallel.mesh import mesh_dims
        from tuch_tpu_torch.parallel.multihost import world
        mesh_dims(getattr(options, 'mesh_dp', 0),
                  getattr(options, 'mesh_cp', 1), world()[1])


def _add_dataclass_args(parser: argparse.ArgumentParser, cls):
    for f in dataclasses.fields(cls):
        if f.name in ('summary_dir', 'checkpoint_dir') \
                or f.name.startswith('_'):
            continue
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


def parse_config(cls=SMPLifyDemoConfig, argv=None, finalize=True):
    """Build a config from CLI flags; --from_json overrides them. The flags
    the user set are recorded in _explicit where the class has it, and a
    class with finalize() is finalized unless finalize=False."""
    import sys
    parser = argparse.ArgumentParser()
    _add_dataclass_args(parser, cls)
    args = parser.parse_args(argv)
    known = {f.name for f in dataclasses.fields(cls)}
    cfg = cls(**{k: v for k, v in vars(args).items() if k in known})
    tokens = list(sys.argv[1:] if argv is None else argv)
    explicit = {n for n in known
                if any(t == f'--{n}' or t.startswith(f'--{n}=')
                       or t == f'--no_{n}' for t in tokens)}
    if cfg.from_json:
        with open(cfg.from_json) as f:
            for k, v in json.load(f).items():
                if k in known and not k.startswith('_'):
                    setattr(cfg, k, v)
                    explicit.add(k)
    if '_explicit' in known:
        cfg._explicit = tuple(sorted(explicit))
    if finalize and hasattr(cfg, 'finalize'):
        cfg.finalize()
    return cfg
