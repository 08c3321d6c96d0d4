"""smplx_to_smpl: offline SMPL-X -> SMPL parameter conversion.

Counterpart of tuch_tpu/cli/smplx_to_smpl.py (the reference's
tuch/utils/smplxtosmpl_mtp.py): reads a folder of SMPLify-XMC smplx
parameter pkls (each with 'vertices', 'body_pose', 'global_orient'), maps
the vertices onto the SMPL topology through the smplx_to_smpl.pkl
correspondence matrix, fits SMPL pose + betas (+ translation) by the
reference's mean per-vertex L2 norm with the global orientation held fixed
(fitting/smplx_to_smpl), the whole shard as one batch, and writes float64
{'pose', 'betas'} pkls into the mirrored .../smpl/... path. Shard-and-merge
for cluster jobs is the same --sidx/--cbs index slicing. Runs on CUDA
unless --device cpu.

Usage:
  python -m tuch_tpu_torch.cli.smplx_to_smpl \\
      --folder mtp/smplify-xmc/smplx/params \\
      --matrix models_utils/smplx_to_smpl.pkl [--sidx 0 --cbs 100]
  python -m tuch_tpu_torch.cli.smplx_to_smpl --synthetic [--device cpu]
"""

import argparse
import glob
import os
import os.path as osp
import pickle

import numpy as np
import torch


def _load_matrix(path):
    with open(path, 'rb') as f:
        d = pickle.load(f, encoding='latin1')
    return np.asarray(d['matrix'] if isinstance(d, dict) else d,
                      dtype=np.float32)


def _init_pose_from_smplx(body_pose, global_orient):
    """smplx 63-dof body pose + orient -> SMPL 72 pose (the two missing
    hand joints are zeros, as in the reference)."""
    body_pose = np.asarray(body_pose, np.float32).reshape(-1)[:63]
    global_orient = np.asarray(global_orient, np.float32).reshape(-1)[:3]
    return np.concatenate([global_orient, body_pose,
                           np.zeros(6, np.float32)])


def convert_folder(folder, matrix, model, num_steps=5000, sidx=None,
                   cbs=None, out_replace=('/smplx/', '/smpl/')):
    """Fit every smplx pkl in `folder` (or the [sidx*cbs, sidx*cbs+cbs)
    shard) with the SMPL module `model` on its device and write the SMPL
    param pkls. Returns the output paths."""
    from tuch_tpu_torch.fitting.smplx_to_smpl import fit_smpl_to_vertices

    files = sorted(f for f in glob.glob(osp.join(folder, '**', '*.pkl'),
                                        recursive=True)
                   if not f.endswith('_smpl.pkl'))  # skip own outputs
    if sidx is not None:
        lo = int(sidx) * int(cbs)
        files = files[lo:lo + int(cbs)]
    if not files:
        print('no input pkls found in', folder)
        return []

    targets, inits = [], []
    for path in files:
        with open(path, 'rb') as f:
            d = pickle.load(f, encoding='latin1')
        sx_verts = np.asarray(d['vertices'], np.float32)
        # gather SMPL-topology vertices from the smplx mesh
        targets.append(matrix @ sx_verts if matrix is not None else sx_verts)
        inits.append(_init_pose_from_smplx(d['body_pose'],
                                           d['global_orient']))

    dev = model.v_template.device
    res = fit_smpl_to_vertices(
        model, torch.as_tensor(np.stack(targets), device=dev),
        init_pose=torch.as_tensor(np.stack(inits), device=dev),
        num_steps=num_steps, fit_translation=True)
    pose, betas, loss = (t.cpu().numpy() for t in res)

    outs = []
    for i, path in enumerate(files):
        out_path = path.replace(*out_replace)
        if out_path == path:
            out_path = osp.splitext(path)[0] + '_smpl.pkl'
        os.makedirs(osp.dirname(out_path), exist_ok=True)
        with open(out_path, 'wb') as f:
            pickle.dump({'pose': np.asarray(pose[i], np.float64),
                         'betas': np.asarray(betas[i], np.float64)}, f)
        outs.append(out_path)
        print(f'{path} -> {out_path} '
              f'(mean vertex err {float(loss[i]):.2e})')
    return outs


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--folder', default=None,
                   help='folder of smplx parameter pkls (searched '
                        'recursively)')
    p.add_argument('--matrix', default=None,
                   help='smplx_to_smpl.pkl correspondence matrix; omit if '
                        'vertices are already SMPL topology')
    p.add_argument('--idx', '--sidx', dest='sidx', default=None,
                   help='shard index for cluster jobs')
    p.add_argument('--cbs', default=None, help='shard size (with --sidx)')
    p.add_argument('--steps', type=int, default=5000)
    p.add_argument('--synthetic', action='store_true',
                   help='hermetic run on generated bodies (no assets)')
    p.add_argument('--device', default=None,
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    if (args.sidx is None) != (args.cbs is None):
        p.error('--idx/--sidx and --cbs must be given together')

    from tuch_tpu_torch import assets, resolve_device
    from tuch_tpu_torch.models.smpl import SMPL

    dev = resolve_device(args.device)
    if args.synthetic:
        import tempfile

        from tuch_tpu_torch.models.smpl import smpl_forward_pose72
        model = SMPL(assets.synthetic_smpl(num_verts=170, seed=0)[0]).to(dev)
        rng = np.random.RandomState(0)
        folder = osp.join(args.folder or tempfile.mkdtemp(), 'smplx',
                          'params')
        os.makedirs(folder, exist_ok=True)
        for i in range(2):
            pose = (rng.randn(72) * 0.1).astype(np.float32)
            betas = (rng.randn(10) * 0.3).astype(np.float32)
            with torch.no_grad():
                out = smpl_forward_pose72(
                    model, torch.as_tensor(betas, device=dev)[None],
                    torch.as_tensor(pose, device=dev)[None])
            with open(osp.join(folder, f'{i:03d}.pkl'), 'wb') as f:
                pickle.dump({'vertices': out.vertices[0].cpu().numpy(),
                             'body_pose': pose[3:66],
                             'global_orient': pose[:3]}, f)
        outs = convert_folder(folder, None, model, num_steps=args.steps)
        if not outs:
            raise RuntimeError('synthetic conversion produced no outputs')
        print('synthetic smplx->smpl conversion complete')
        return outs

    if not args.folder:
        p.error('--folder is required unless --synthetic is set')
    from tuch_tpu_torch import config as cfg
    model = SMPL(assets.load_smpl_pkl(
        osp.join(cfg.SMPL_MODEL_DIR, 'SMPL_NEUTRAL.pkl'))).to(dev)
    matrix = _load_matrix(args.matrix) if args.matrix else None
    return convert_folder(args.folder, matrix, model, num_steps=args.steps,
                          sidx=args.sidx, cbs=args.cbs)


if __name__ == '__main__':
    main()
