"""demo_smplify_dc: SMPLify-DC fitting demo on the GPU.

Counterpart of tuch_tpu/cli/demo_smplify_dc.py: crop the dataset images,
initialise with an HMR forward (SPIN), refine the whole batch at once with
the two-stage SMPLify-DC fit with contact, and print the per-image
reprojection loss.

  python -m tuch_tpu_torch.cli.demo_smplify_dc --synthetic --num_images 4 \
      --num_smplify_iters 100
  python -m tuch_tpu_torch.cli.demo_smplify_dc --synthetic --device cpu \
      --synthetic_num_verts 170 --img_res 64 --num_images 2

The renders of the JAX demo (init and fit, front and rotated) need the
renderer, which is not ported yet; the demo says so and writes no files.
"""

import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

from tuch_tpu_torch import config as cfgmod
from tuch_tpu_torch import constants, resolve_device
from tuch_tpu_torch import runtime as rt
from tuch_tpu_torch.data.dataset import TuchDataset, synthetic_db
from tuch_tpu_torch.fitting import smplify_dc as S
from tuch_tpu_torch.utils.projection import weak_perspective_to_translation
from tuch_tpu_torch.utils.rotations import rotmat_to_aa


class DemoOutput(NamedTuple):
    result: S.SMPLifyResult
    init_pose: torch.Tensor           # (B, 72) axis-angle from HMR
    init_betas: torch.Tensor          # (B, 10)
    init_cam_t: torch.Tensor          # (B, 3)
    init_reprojection_loss: torch.Tensor  # (B, 49), as result's
    batch: dict                       # the dataset samples, numpy
    seconds: float                    # HMR init + fit, host wall clock


def load_batch(args, num_classes: int) -> dict:
    """The first num_images samples of the dataset, stacked (numpy)."""
    if args.synthetic:
        with tempfile.TemporaryDirectory() as d:
            db = synthetic_db(args.num_images, img_dir=d, seed=0,
                              num_contact_classes=num_classes)
            ds = TuchDataset(args, args.ds_names[0], data=db, img_dir=d,
                             use_augmentation=False)
            samples = [ds.get(i) for i in range(min(args.num_images,
                                                    len(ds)))]
    else:
        ds = TuchDataset(args, args.ds_names[0], use_augmentation=False)
        samples = [ds.get(i) for i in range(min(args.num_images, len(ds)))]
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def run(args, runtime=None) -> DemoOutput:
    """The demo's computation on args.device (CUDA by default): returns
    the fit, its HMR init and the batch. A built runtime may be passed in
    (it must hold the contact assets)."""
    dev = resolve_device(args.device)
    if runtime is None:
        runtime = rt.build_runtime(
            device=dev, synthetic=args.synthetic or None,
            num_verts=args.synthetic_num_verts or None,
            backbone=args.backbone, checkpoint=args.checkpoint,
            with_contact=True)
    batch = load_batch(args, len(runtime.contact_classes))
    B = batch['img'].shape[0]

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        rotmat, init_betas, cam = runtime.hmr(t(batch['img']))
        init_cam_t = weak_perspective_to_translation(
            cam, constants.FOCAL_LENGTH, args.img_res)
        init_pose = torch.nan_to_num(rotmat_to_aa(rotmat)).reshape(B, 72)

    kp_px = batch['keypoints'].copy()
    kp_px[..., :2] = 0.5 * args.img_res * (kp_px[..., :2] + 1.0)
    cam_center = t(np.full((B, 2), args.img_res / 2.0, np.float32))
    has_gt_kpts = t(batch['has_gt_kpts'], torch.bool)

    config = S.SMPLifyConfig(
        num_iters=args.num_smplify_iters,
        use_contact=args.use_contact_in_the_loop,
        # the reference demo runs SMPLifyDC at its default euclthres 0.0;
        # training is what passes 0.02
        euclthres=0.0,
        contact_loss_weight=args.contact_in_the_loop_loss_weight,
        collect_trajectory=True)
    res = S.smplify_dc(
        runtime.smpl, runtime.prior, runtime.contact, init_pose, init_betas,
        init_cam_t, cam_center, t(kp_px), t(batch['contact_vec']),
        torch.zeros(B, dtype=torch.bool, device=dev),
        t(batch['has_disc_contact'], torch.bool), has_gt_kpts,
        config=config)
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    init_reproj = S.get_fitting_loss(
        runtime.smpl, runtime.prior, init_pose, init_betas, init_cam_t,
        cam_center, t(kp_px), has_gt_keypoints=has_gt_kpts)
    return DemoOutput(result=res, init_pose=init_pose,
                      init_betas=init_betas, init_cam_t=init_cam_t,
                      init_reprojection_loss=init_reproj, batch=batch,
                      seconds=seconds)


def main(argv=None):
    args = cfgmod.parse_config(cfgmod.SMPLifyDemoConfig, argv)
    out = run(args)
    print('reprojection loss:',
          out.result.reprojection_loss.mean(dim=-1).cpu().numpy())
    print('renders are not ported yet (viz/renderer.py); no images '
          'written')


if __name__ == '__main__':
    main()
