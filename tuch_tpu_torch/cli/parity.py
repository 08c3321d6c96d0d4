"""parity: one-command numerical parity gate against the PyTorch reference.

Counterpart of tuch_tpu/cli/parity.py, for this package's HMR. Three
check levels, picked from the files that exist where it runs:

  1. --ref_dump parity.npz (made by tools/parity_dump.py dump where the
     reference runs): full-pipeline diff -- rotmats, betas, camera, and
     SMPL VERTICES of the checkpoint through this package's runtime (real
     SMPL assets) against the dumped reference outputs. The authoritative
     <= 1e-3 vertex gate.
  2. --checkpoint x.pt: the checkpoint's own state dict is executed with
     the reference's functional graph (models/torch_ref.py) on the CPU and
     diffed against this package's HMR with the same weights on --device,
     on the same inputs; when real SMPL assets exist, both parameter sets
     also run through one SMPL for a vertex delta (isolating the network).
  3. Neither available: prints the commands to run when assets exist and
     exits 0 (recorded skip).

Comparisons run in full fp32: TF32 is turned off for cuDNN and cuBLAS, so
the gate measures the model's fidelity, not the card's reduced precision.

Usage:
  python -m tuch_tpu_torch.cli.parity --checkpoint \\
      data/spin_model_checkpoint.pt [--img img1.jpg ...] \\
      [--ref_dump parity.npz] [--device cpu]
"""

import argparse
import os
import sys

import numpy as np

VERT_TOL = 1e-3
PARAM_TOL = 5e-4


def _load_images(img_paths, img_res=224):
    from tuch_tpu_torch.cli.demo_tuch import process_image
    norms = [process_image(p, None, None, input_res=img_res)[1]
             for p in img_paths]
    return np.concatenate(norms, axis=0)


def check_against_dump(args, device) -> int:
    import torch

    from tuch_tpu_torch import runtime as rt
    from tuch_tpu_torch.models.smpl import smpl_forward
    from tuch_tpu_torch.train.checkpoint import load_variables

    runtime = rt.build_runtime(device=device, synthetic=False,
                               with_segments=False)
    load_variables(args.checkpoint, runtime.hmr)
    data = np.load(args.ref_dump)
    n = int(data['n'])
    worst = {}
    for i in range(n):
        norm = torch.as_tensor(data[f'img{i}_norm'][None], device=device)
        with torch.no_grad():
            rotmat, betas, cam = runtime.hmr(norm)
            out = smpl_forward(runtime.smpl, betas, rotmat[:, 1:],
                               rotmat[:, :1], pose2rot=False)
        for name, ours, ref in (
                ('rotmat', rotmat, data[f'img{i}_rotmat']),
                ('betas', betas, data[f'img{i}_betas']),
                ('cam', cam, data[f'img{i}_cam']),
                ('vertices', out.vertices, data[f'img{i}_vertices'])):
            err = float(np.abs(ours.cpu().numpy() - ref).max())
            worst[name] = max(worst.get(name, 0.0), err)
    ok = True
    for name, err in worst.items():
        tol = VERT_TOL if name == 'vertices' else 1e-2
        status = 'OK' if err < tol else 'FAIL'
        ok &= err < tol
        print(f'[full-pipeline] {name}: max |delta| = {err:.2e}  [{status}]')
    return 0 if ok else 1


def check_network_vs_torch(args, device) -> int:
    import torch

    from tuch_tpu_torch import config as cfg
    from tuch_tpu_torch.models import hmr as hmr_mod
    from tuch_tpu_torch.models.convert import load_checkpoint
    from tuch_tpu_torch.models.torch_ref import torch_hmr_forward
    from tuch_tpu_torch.runtime import load_hmr_weights
    from tuch_tpu_torch.utils.rotations import rot6d_to_rotmat

    sd = load_checkpoint(args.checkpoint)
    sd_np = {k: v.numpy() for k, v in sd.items()}

    # mean params: from checkpoint buffers, else the asset file
    if 'init_pose' in sd_np:
        mean_pose = sd_np['init_pose'].reshape(-1)
        mean_shape = sd_np['init_shape'].reshape(-1)
        mean_cam = sd_np['init_cam'].reshape(-1)
    elif os.path.isfile(cfg.SMPL_MEAN_PARAMS):
        from tuch_tpu_torch.assets import load_mean_params
        mean_pose, mean_shape, mean_cam = load_mean_params(
            cfg.SMPL_MEAN_PARAMS)
    else:
        print('SKIP network check: checkpoint has no init_pose buffers and '
              f'{cfg.SMPL_MEAN_PARAMS} is absent')
        return 0

    model = hmr_mod.create_hmr(mean_pose, mean_shape, mean_cam)
    load_hmr_weights(model, sd)
    model = model.to(device).eval()

    if args.img:
        x = _load_images(args.img)
    else:
        rng = np.random.RandomState(0)
        x = (rng.randn(2, 224, 224, 3) * 0.5).astype(np.float32)
        print('(no --img given: using fixed random inputs)')

    pose6d_t, betas_t, cam_t = torch_hmr_forward(sd_np, x, mean_pose,
                                                 mean_shape, mean_cam)
    with torch.no_grad():
        rotmat_p, betas_p, cam_p = (
            t.cpu() for t in model(torch.as_tensor(x, device=device)))
    rotmat_t = rot6d_to_rotmat(torch.as_tensor(pose6d_t)).reshape(
        -1, 24, 3, 3)

    worst = {
        'rotmat': float((rotmat_p - rotmat_t).abs().max()),
        'betas': float(np.abs(betas_p.numpy() - betas_t).max()),
        'cam': float(np.abs(cam_p.numpy() - cam_t).max()),
    }

    # vertex delta through a shared SMPL (isolates the network)
    smpl_pkl = os.path.join(cfg.SMPL_MODEL_DIR, 'SMPL_NEUTRAL.pkl')
    if os.path.isfile(smpl_pkl):
        from tuch_tpu_torch.assets import load_smpl_pkl
        from tuch_tpu_torch.models.smpl import SMPL, smpl_forward
        smpl = SMPL(load_smpl_pkl(smpl_pkl))
        with torch.no_grad():
            v_p = smpl_forward(smpl, betas_p, rotmat_p[:, 1:],
                               rotmat_p[:, :1], pose2rot=False).vertices
            v_t = smpl_forward(smpl, torch.as_tensor(betas_t),
                               rotmat_t[:, 1:], rotmat_t[:, :1],
                               pose2rot=False).vertices
        worst['vertices(shared-SMPL)'] = float((v_p - v_t).abs().max())
    else:
        print(f'(SMPL assets absent at {smpl_pkl}: vertex delta skipped; '
              'network-output parity only)')

    ok = True
    for name, err in worst.items():
        tol = VERT_TOL if name.startswith('vertices') else PARAM_TOL
        status = 'OK' if err < tol else 'FAIL'
        ok &= err < tol
        print(f'[network-vs-torch] {name}: max |delta| = {err:.2e}  '
              f'[{status}]')
    return 0 if ok else 1


def _pin_parity_precision():
    """Full fp32 for the comparison: cuDNN's convolutions default to TF32
    on the card (about three decimal digits), which would measure the
    card's reduced precision against the 5e-4 bar instead of the model."""
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument('--checkpoint', default=None,
                   help='reference .pt checkpoint (or converted .npz)')
    p.add_argument('--img', nargs='*', default=None)
    p.add_argument('--ref_dump', default=None,
                   help='parity.npz from tools/parity_dump.py dump')
    p.add_argument('--device', default=None,
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    from tuch_tpu_torch import config as cfg
    from tuch_tpu_torch import resolve_device

    device = resolve_device(args.device)
    _pin_parity_precision()
    if args.ref_dump and not os.path.isfile(args.ref_dump):
        # an explicitly requested gate must not silently degrade to the
        # weaker checks on a mistyped path
        print(f'ERROR: --ref_dump {args.ref_dump} does not exist')
        return 2
    if args.ref_dump:
        if not args.checkpoint:
            print('--ref_dump needs --checkpoint')
            return 2
        if not os.path.isfile(args.checkpoint):
            print(f'ERROR: --checkpoint {args.checkpoint} does not exist')
            return 2
        return check_against_dump(args, device)

    if args.checkpoint and not os.path.isfile(args.checkpoint):
        # same explicit-path contract as --ref_dump above
        print(f'ERROR: --checkpoint {args.checkpoint} does not exist')
        return 2
    ckpt = args.checkpoint or cfg.SPIN_MODEL_CHECKPOINT
    if ckpt and os.path.isfile(ckpt):
        args.checkpoint = ckpt
        return check_network_vs_torch(args, device)

    print('SKIP: no reference checkpoint found '
          f'(looked for {ckpt or cfg.SPIN_MODEL_CHECKPOINT}).\n'
          'When the reference assets exist (scripts/fetch_data.sh of the '
          'reference), run:\n'
          '  python -m tuch_tpu_torch.cli.parity '
          '--checkpoint data/spin_model_checkpoint.pt --img <imgs>\n'
          'or the authoritative full-pipeline gate:\n'
          '  python tools/parity_dump.py dump --checkpoint '
          'data/tuch_model_checkpoint.pt --images <imgs> --out parity.npz\n'
          '  python -m tuch_tpu_torch.cli.parity --checkpoint '
          'data/tuch_model_checkpoint.pt --ref_dump parity.npz')
    return 0


if __name__ == '__main__':
    sys.exit(main())
