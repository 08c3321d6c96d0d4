"""demo_smplify_dc: SMPLify-DC fitting demo on the GPU.

Counterpart of tuch_tpu/cli/demo_smplify_dc.py: crop the dataset images,
initialise with an HMR forward (SPIN), refine the whole batch at once with
the two-stage SMPLify-DC fit with contact, print the per-image
reprojection loss and render each image: <i>_fit.png (the init, the fit,
the fit turned 90 degrees, coloured by its contact labels) and <i>_opti.png
(the fit's trajectory), into --out_dir or else log_dir/name.

  python -m tuch_tpu_torch.cli.demo_smplify_dc --synthetic --num_images 4 \
      --num_smplify_iters 100
  python -m tuch_tpu_torch.cli.demo_smplify_dc --synthetic --device cpu \
      --synthetic_num_verts 170 --img_res 64 --num_images 2
"""

import os
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
from tuch_tpu_torch.models.smpl import smpl_forward
from tuch_tpu_torch.utils.projection import weak_perspective_to_translation
from tuch_tpu_torch.utils.rotations import rotmat_to_aa
from tuch_tpu_torch.viz.renderer import Renderer, save_png


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


def build(args) -> rt.Runtime:
    """The demo's runtime on args.device (CUDA by default), with the
    contact assets."""
    return rt.build_runtime(
        device=resolve_device(args.device), synthetic=args.synthetic or None,
        num_verts=args.synthetic_num_verts or None, backbone=args.backbone,
        checkpoint=args.checkpoint, with_contact=True)


def run(args, runtime: rt.Runtime) -> DemoOutput:
    """The demo's computation on args.device with a runtime that holds the
    contact assets (build): returns the fit, its HMR init and the batch."""
    dev = resolve_device(args.device)
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


def render(args, runtime, out: DemoOutput) -> str:
    """Write <i>_fit.png and <i>_opti.png for each image into
    args.out_dir, or else log_dir/name (the reference's directory);
    returns the directory."""
    out_dir = args.out_dir or os.path.join(os.path.abspath(args.log_dir),
                                           args.name)
    os.makedirs(out_dir, exist_ok=True)
    renderer = Renderer(img_res=args.img_res,
                        faces=runtime.smpl.faces.cpu().numpy(),
                        contact_classes=runtime.contact_classes,
                        contact_csig=runtime.contact_csig)
    mean = np.asarray(constants.IMG_NORM_MEAN, np.float32)
    std = np.asarray(constants.IMG_NORM_STD, np.float32)
    with torch.no_grad():
        init_verts = smpl_forward(
            runtime.smpl, out.init_betas, out.init_pose[:, 3:],
            out.init_pose[:, :3]).vertices.cpu().numpy()
    init_cam_t = out.init_cam_t.cpu().numpy()
    res = out.result
    verts = res.vertices.cpu().numpy()
    traj = res.trajectory.cpu().numpy()
    cam_t = res.camera_translation.cpu().numpy()
    batch = out.batch
    B = verts.shape[0]
    for i in range(B):
        img01 = np.clip(batch['img'][i] * std + mean, 0, 1)
        cv = batch['contact_vec'][i]
        tiles = [
            renderer.render_over(init_verts[i], init_cam_t[i], img01),
            renderer.render_over(verts[i], cam_t[i], img01, contact_vec=cv),
            renderer.render_rotated(verts[i], cam_t[i], 90.0,
                                    contact_vec=cv),
        ]
        save_png(os.path.join(out_dir, f'{i:04d}_fit.png'),
                 np.concatenate(tiles, axis=1))
        save_png(os.path.join(out_dir, f'{i:04d}_opti.png'),
                 renderer.visu_smplifycontactopti(traj, cam_t, [img01] * B,
                                                  sample=i))
    return out_dir


def main(argv=None):
    args = cfgmod.parse_config(cfgmod.SMPLifyDemoConfig, argv)
    runtime = build(args)
    out = run(args, runtime)
    print('reprojection loss:',
          out.result.reprojection_loss.mean(dim=-1).cpu().numpy())
    print('saved fits to', render(args, runtime, out))


if __name__ == '__main__':
    main()
