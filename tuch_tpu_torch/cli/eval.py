"""eval: MPJPE and PA-MPJPE of an HMR checkpoint on 3DPW or MPI-INF-3DHP.

Counterpart of tuch_tpu/cli/eval.py (the reference's eval.py) with the same
flags plus --device:

  python -m tuch_tpu_torch.cli.eval --checkpoint ckpt.pt --dataset 3dpw
  python -m tuch_tpu_torch.cli.eval --synthetic --bn_fold

--synthetic evaluates on the synthetic body and a synthetic test set
(alternating genders; 17 rows of the body's joint regressor stand in for
the H36M regressor), whose images are written under out/synthetic_eval.
--mesh_dp N runs on N ranks, one process each, launched by torchrun
(torchrun --nproc_per_node N -m tuch_tpu_torch.cli.eval --mesh_dp N ...):
each full batch is split over them, a ragged last batch runs whole on
every rank, and rank 0 prints and writes the result file.
"""

import argparse
import os

import numpy as np

# (MPJPE, PA-MPJPE) in mm as the JAX package's cli/eval records them from
# memory of the SPIN and TUCH papers, never verified against them: printed
# only with --paper_context, as advice, never a gate
PAPER_TARGETS_MODEL_MEMORY = {
    '3dpw': {'SPIN': (96.9, 59.2), 'TUCH': (85.0, 55.5)},
    'mpi-inf-3dhp': {'SPIN': (105.2, 67.5), 'TUCH': (100.0, 65.0)},
}


def _gendered_smpl(neutral, device):
    """The male and female SMPL modules when their files exist (each with
    the neutral model's extra joint regressor), else None."""
    from tuch_tpu_torch import assets as assets_mod
    from tuch_tpu_torch import config as cfg
    from tuch_tpu_torch.models.smpl import SMPL
    out = []
    for gender in ('MALE', 'FEMALE'):
        path = os.path.join(cfg.SMPL_MODEL_DIR, f'SMPL_{gender}.pkl')
        m = None
        if os.path.isfile(path):
            m = assets_mod.load_smpl_pkl(path)._replace(
                J_regressor_extra=neutral.J_regressor_extra.cpu().numpy())
            m = SMPL(m).to(device)
        out.append(m)
    return out


def run(args):
    """Evaluate as main does; returns the report dict."""
    from tuch_tpu_torch import config as cfg
    from tuch_tpu_torch import resolve_device
    from tuch_tpu_torch import runtime as rt
    from tuch_tpu_torch.data.dataset import TuchDataset, synthetic_db
    from tuch_tpu_torch.eval.evaluate import run_evaluation
    from tuch_tpu_torch.parallel import mesh as pmesh
    from tuch_tpu_torch.parallel.multihost import \
        maybe_initialize_distributed

    maybe_initialize_distributed(args.device)
    mesh = None
    if cfg.mesh_wanted(args):
        mesh = pmesh.make_mesh(dp=args.mesh_dp, cp=1, device=args.device)
    device = resolve_device(args.device)
    runtime = rt.build_runtime(
        device=device, synthetic=args.synthetic or None,
        num_verts=args.synthetic_num_verts or None, backbone=args.backbone,
        checkpoint=args.checkpoint, bn_fold=args.bn_fold)
    cnc = None
    if args.synthetic:
        img_dir = os.path.join('out', 'synthetic_eval')
        db = synthetic_db(args.synthetic_samples, img_dir=img_dir, seed=0,
                          with_pose_3d=(args.dataset == 'mpi-inf-3dhp'))
        ns = len(db['imgname'])
        db['gender'] = np.array(['m', 'f'] * ((ns + 1) // 2))[:ns]
        dataset = TuchDataset(None, args.dataset, data=db, img_dir=img_dir,
                              use_augmentation=False, split='test')
        # both joint mappers index rows up to 16: keep 17 rows
        j_reg = runtime.smpl.J_regressor[:17].cpu().numpy()
        smpl_m = smpl_f = None
    else:
        dataset = TuchDataset(None, args.dataset, split='test',
                              use_augmentation=False)
        j_reg = np.load(cfg.JOINT_REGRESSOR_H36M)
        if args.dataset == '3dpw':
            cnc = np.load(cfg.THREEDPW_CIG).min(1).min(1)
        smpl_m, smpl_f = _gendered_smpl(runtime.smpl, device)
    return run_evaluation(
        runtime.hmr, dataset, args.dataset, runtime.smpl, smpl_m, smpl_f,
        j_reg, batch_size=args.batch_size, cnc_arr=cnc,
        result_file=args.result_file, log_freq=args.log_freq,
        num_workers=args.num_workers, shuffle=args.shuffle, mesh=mesh)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--checkpoint', default=None,
                   help='HMR checkpoint: a reference .pt, the JAX '
                        "package's .npz tree or a checkpoint of cli/train")
    p.add_argument('--dataset', default='mpi-inf-3dhp',
                   choices=['3dpw', 'mpi-inf-3dhp'])
    p.add_argument('--log_freq', default=50, type=int)
    p.add_argument('--batch_size', default=32, type=int)
    p.add_argument('--shuffle', default=False, action='store_true')
    p.add_argument('--num_workers', default=8, type=int)
    p.add_argument('--result_file', default=None)
    p.add_argument('--idx', default=None,
                   help='accepted for reference compatibility; unused by '
                        'the reference too (eval.py:56)')
    p.add_argument('--mesh_dp', type=int, default=1,
                   help='data-parallel ranks, one process each (torchrun '
                        '--nproc_per_node N)')
    p.add_argument('--synthetic', action='store_true')
    p.add_argument('--synthetic_num_verts', type=int, default=0,
                   help='--synthetic body size override (0 = full)')
    p.add_argument('--synthetic_samples', type=int, default=16)
    p.add_argument('--bn_fold', action='store_true',
                   help='fold eval-mode BatchNorm into the ResNet-50 conv '
                        'weights (the same function to float32 rounding)')
    p.add_argument('--backbone', default='resnet50',
                   help='regressor backbone: resnet50 (reference) or a '
                        'models/vit.py config name (vit_s16, ...)')
    p.add_argument('--paper_context', action='store_true',
                   help='print UNVERIFIED model-memory paper numbers as '
                        'context (advisory only, never a gate)')
    p.add_argument('--device', default='cuda',
                   help="torch device (default cuda; 'cpu' to run there)")
    args = p.parse_args(argv)
    result = run(args)
    from tuch_tpu_torch.parallel.multihost import world
    if world()[0]:
        return result
    print('*** Final Results ***')
    for k, v in result.items():
        print(f'  {k}: {v:.3f}' if isinstance(v, float) else f'  {k}: {v}')
    if args.paper_context and not args.synthetic:
        print('--- paper context [from memory of the papers, UNVERIFIED; '
              'advisory only] ---')
        for method, (mp, pa) in PAPER_TARGETS_MODEL_MEMORY[
                args.dataset].items():
            print(f'  {method} ({args.dataset}): MPJPE ~{mp:.1f}mm, '
                  f'PA-MPJPE ~{pa:.1f}mm')
    return result


if __name__ == '__main__':
    main()
