"""export_torch: write a trained checkpoint as a reference-loadable .pt.

Counterpart of tuch_tpu/cli/export_torch.py. Takes a checkpoint of this
package (train/checkpoint.py: its 'model' entry and step) or an .npz tree
in the JAX package's format (models/convert.load_checkpoint reads both)
and saves a `{'model': state_dict}` torch pickle with the reference's key
names, the init_pose/init_shape/init_cam buffers and the reference's
bookkeeping entries (epoch, batch_idx, batch_size, dataset_perm,
total_step_count), so a model trained here loads into the reference's
demo, eval and train --resume. Host only: nothing runs on a device.

Usage:
  python -m tuch_tpu_torch.cli.export_torch \\
      --checkpoint logs/tuch/checkpoints/<stamp>_step<N>_<err> \\
      --out tuch_model.pt [--mean_params smpl_mean_params.npz]
"""

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--checkpoint', required=True,
                   help='checkpoint of this package (train output) or '
                        '.npz tree')
    p.add_argument('--out', required=True, help='output .pt path')
    p.add_argument('--mean_params', default=None,
                   help='smpl_mean_params.npz to embed as the '
                        'init_pose/shape/cam buffers (default: '
                        'config.SMPL_MEAN_PARAMS if present)')
    args = p.parse_args(argv)

    import torch

    from tuch_tpu_torch import config as cfg
    from tuch_tpu_torch.models.convert import (load_checkpoint,
                                               save_torch_checkpoint)

    state_dict = load_checkpoint(args.checkpoint)
    step = 0
    if not args.checkpoint.endswith('.npz'):
        ckpt = torch.load(args.checkpoint, map_location='cpu',
                          weights_only=True)
        if isinstance(ckpt, dict):
            step = int(ckpt.get('step', 0))

    mean_path = args.mean_params or (
        cfg.SMPL_MEAN_PARAMS if os.path.isfile(cfg.SMPL_MEAN_PARAMS)
        else None)
    means = None
    if mean_path:
        from tuch_tpu_torch.assets import load_mean_params
        means = load_mean_params(mean_path)
    else:
        print('WARNING: no smpl_mean_params.npz found/given -- the '
              'init_pose/init_shape/init_cam buffers are absent, so the '
              "reference's STRICT state-dict load (train --resume) will "
              'fail; demo/eval (strict=False) still work. Pass '
              '--mean_params to embed them.')

    # the reference's load_checkpoint reads every one of these keys
    save_torch_checkpoint(state_dict, args.out, mean_params=means,
                          epoch=0, batch_idx=0, batch_size=None,
                          dataset_perm=None, total_step_count=step)
    print(f'wrote reference-format checkpoint: {args.out} '
          f'(step {step}, mean params: '
          f'{"embedded" if means else "absent"})')


if __name__ == '__main__':
    main()
