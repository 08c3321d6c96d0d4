"""train: the TUCH training entry point on the GPU.

Counterpart of tuch_tpu/cli/train.py with the same flags (config.TrainConfig,
the reference's TrainOptions) plus --device: datasets and their mix, HMR
with its runtime (--compute_dtype, --stem_s2d, --pretrained_checkpoint),
SMPL, SMPLify-DC and the regressor loss, and the Trainer with the renderer
of its image summaries. --synthetic runs on the synthetic body and a
synthetic database of max(4 * batch_size, 8) samples, seen as 'dsc_lsp' and
'mtp', whose images are written under the run's log directory.

  python -m tuch_tpu_torch.cli.train --name tuch_run --ds_names dsc mtp \\
      --ds_composition 0.5 0.5 --run_smplify
  python -m tuch_tpu_torch.cli.train --synthetic --device cpu \\
      --synthetic_num_verts 170 --img_res 64 --batch_size 2 \\
      --num_epochs 1 --run_smplify

--mesh_dp and --mesh_cp run one process per rank of the mesh, launched by
torchrun (the process group comes from its environment; NCCL when each
rank has a card of its own, gloo when ranks share a card or run on the
CPU):

  torchrun --nproc_per_node 4 -m tuch_tpu_torch.cli.train --mesh_dp 2 \\
      --mesh_cp 2 --run_smplify ...
"""

import os

import numpy as np


def build(options, runtime=None):
    """The Trainer for finalized options (config.parse_config), on
    options.device; runtime: a runtime.Runtime built with contact (and HD
    when options.use_hd) to use instead of building one."""
    from tuch_tpu_torch import config as cfg
    from tuch_tpu_torch import resolve_device
    from tuch_tpu_torch import runtime as rt
    from tuch_tpu_torch.data.dataset import (TuchDataset,
                                             project_db_keypoints,
                                             synthetic_db)
    from tuch_tpu_torch.data.mixed import MixedDataset
    from tuch_tpu_torch.parallel.multihost import \
        maybe_initialize_distributed
    from tuch_tpu_torch.train.module import TuchAssets
    from tuch_tpu_torch.train.trainer import Trainer
    from tuch_tpu_torch.viz.renderer import Renderer

    maybe_initialize_distributed(options.device)
    cfg.check_mesh(options)
    device = resolve_device(options.device)
    rt.deterministic(device)
    if runtime is None:
        runtime = rt.build_runtime(
            device=device, synthetic=options.synthetic or None,
            num_verts=options.synthetic_num_verts or None,
            backbone=options.backbone,
            checkpoint=options.pretrained_checkpoint, with_contact=True,
            with_hd=options.use_hd, dtype=options.compute_dtype,
            stem_s2d=options.stem_s2d)
    P = len(runtime.contact_classes)
    if options.synthetic:
        img_dir = os.path.join(options.log_dir, 'synthetic_images')
        n = max(4 * options.batch_size, 8)
        db = synthetic_db(n, img_dir=img_dir, seed=options.seed,
                          num_contact_classes=P)
        if options.synthetic_projected_kpts:
            db = project_db_keypoints(db, runtime.smpl, seed=options.seed)
        names = ['dsc_lsp', 'mtp']
        datasets = [TuchDataset(options, nm, data=db, img_dir=img_dir,
                                dataset_id=i, num_contact_classes=P)
                    for i, nm in enumerate(names)]
        train_ds = MixedDataset(options, 'train', datasets=datasets)
        val_ds = TuchDataset(options, 'mtp', data=db, img_dir=img_dir,
                             use_augmentation=False, split='val',
                             num_contact_classes=P)
    else:
        train_ds = MixedDataset(options, 'train', num_contact_classes=P)
        val_ds = MixedDataset(options, 'val',
                              num_contact_classes=P).datasets[0]
    j_reg = np.load(cfg.JOINT_REGRESSOR_H36M) \
        if os.path.isfile(cfg.JOINT_REGRESSOR_H36M) else None
    assets = TuchAssets(runtime.smpl, runtime.prior, runtime.contact,
                        runtime.hd if options.use_hd else None)
    renderer = Renderer(img_res=options.img_res,
                        faces=runtime.smpl.faces.cpu().numpy(),
                        contact_classes=runtime.contact_classes,
                        contact_csig=runtime.contact_csig)
    return Trainer(options, runtime.hmr, assets, train_ds, val_ds,
                   j_regressor_h36m=j_reg, device=device, renderer=renderer)


def run(options, runtime=None):
    """Build the Trainer (build) and fit it; returns the Trainer."""
    trainer = build(options, runtime)
    trainer.fit()
    return trainer


def main(argv=None):
    import torch.distributed as dist
    from tuch_tpu_torch import config as cfg
    trainer = run(cfg.parse_config(cfg.TrainConfig, argv))
    trainer.close()
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == '__main__':
    main()
