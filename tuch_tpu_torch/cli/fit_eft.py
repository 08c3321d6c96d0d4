"""fit_eft: per-image exemplar fine-tuning on the GPU.

Counterpart of tuch_tpu/cli/fit_eft.py with its flags and aliases plus
--device: one EFT fit per image of each dataset's shard (--sidx/--cbs),
written as <out_dir>/<ds>_eft_train[_<sidx>].npz, or with --merge the
shards joined into <out_dir>/<ds>_eft_train.pt. --synthetic fits a 4-sample
synthetic database on the synthetic body.

  python -m tuch_tpu_torch.cli.fit_eft --name eftrun --ds_names dsc_df \\
      --sidx 0 --cbs 1000
  python -m tuch_tpu_torch.cli.fit_eft --synthetic --device cpu \\
      --synthetic_num_verts 170 --img_res 64 --cbs 2 --max_steps 3

--auto_shard derives --sidx and --cbs from the process's rank and the
world size (the shard of rank r is images [r * cbs, (r + 1) * cbs), cbs
= ceil(len / world)); the processes come from torchrun and need no
collective, so they may share a card:

  torchrun --nproc_per_node 4 -m tuch_tpu_torch.cli.fit_eft --auto_shard
  python -m tuch_tpu_torch.cli.fit_eft --merge out/eft/dsc_df_eft_train_*.npz
"""

import argparse
import os
import tempfile


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--name', default='eft')
    # --dsname is the reference's spelling
    p.add_argument('--ds_names', '--dsname', nargs='+', default=['dsc_df'])
    p.add_argument('--pretrained_checkpoint', default=None)
    p.add_argument('--sidx', type=int, default=0)
    p.add_argument('--cbs', type=int, default=None)
    p.add_argument('--max_steps', type=int, default=50)
    p.add_argument('--lr', type=float, default=1e-5)
    p.add_argument('--keypoint_loss_weight', '--kp_loss_weight', type=float,
                   default=1.0)
    p.add_argument('--beta_loss_weight', '--shape_prior_weight', type=float,
                   default=1.0)
    p.add_argument('--contact_loss_weight', type=float, default=10.0)
    p.add_argument('--batch_size', type=int, default=1)
    p.add_argument('--num_workers', type=int, default=8)
    p.add_argument('--pin_memory', dest='pin_memory', action='store_true',
                   default=True)
    p.add_argument('--no_pin_memory', dest='pin_memory',
                   action='store_false')
    p.add_argument('--img_res', type=int, default=224)
    p.add_argument('--out_dir', default='out/eft')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--synthetic', action='store_true')
    p.add_argument('--synthetic_num_verts', type=int, default=0,
                   help='--synthetic body size override (0 = full)')
    p.add_argument('--merge', nargs='*', default=None,
                   help='merge shard files instead of fitting')
    p.add_argument('--auto_shard', action='store_true',
                   help='derive --sidx/--cbs from the rank and world size '
                        'of a torchrun launch (one shard a process)')
    p.add_argument('--device', default=None,
                   help="torch device (default CUDA; 'cpu' to run there)")
    return p.parse_args(argv)


def main(argv=None):
    """Fit (or merge) every dataset of --ds_names; returns the files
    written."""
    args = parse_args(argv)
    import torch.distributed as dist
    from tuch_tpu_torch.parallel import multihost
    if args.auto_shard:
        multihost.maybe_initialize_distributed(args.device)
    try:
        return _run(args)
    finally:
        if args.auto_shard and dist.is_initialized():
            dist.destroy_process_group()


def _run(args):
    from tuch_tpu_torch import resolve_device
    from tuch_tpu_torch import runtime as rt
    from tuch_tpu_torch.data.dataset import TuchDataset, synthetic_db
    from tuch_tpu_torch.fitting.eft import EFTFitter, merge_shards
    from tuch_tpu_torch.parallel import multihost

    dev = resolve_device(args.device)
    rt.deterministic(dev)
    runtime = rt.build_runtime(
        device=dev, synthetic=args.synthetic or None,
        num_verts=args.synthetic_num_verts or None, with_contact=True)
    if args.pretrained_checkpoint:
        from tuch_tpu_torch.train.checkpoint import load_variables
        load_variables(args.pretrained_checkpoint, runtime.hmr)
    P = len(runtime.contact_classes)
    written = []
    for dsname in args.ds_names:
        with tempfile.TemporaryDirectory() as d:
            if args.synthetic:
                db = synthetic_db(4, img_dir=d, seed=args.seed,
                                  num_contact_classes=P)
                ds = TuchDataset(args, dsname, data=db, img_dir=d,
                                 use_augmentation=False,
                                 num_contact_classes=P)
            else:
                ds = TuchDataset(args, dsname, use_augmentation=False,
                                 num_contact_classes=P)
            if args.merge is not None:
                os.makedirs(args.out_dir, exist_ok=True)
                written.append(merge_shards(
                    args.merge, ds.data,
                    os.path.join(args.out_dir, f'{dsname}_eft_train.pt')))
                continue
            if args.auto_shard:
                # process_shard's split, as the reference's (sidx, cbs)
                args.sidx = multihost.world()[0]
                args.cbs = multihost.shard_size(len(ds))
            fitter = EFTFitter(args, dsname, ds, runtime.hmr, runtime.smpl,
                               runtime.contact, out_dir=args.out_dir)
            written.append(fitter.fit())
    return written


if __name__ == '__main__':
    main()
