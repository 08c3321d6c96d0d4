"""preprocess: offline dataset extraction CLI (host only, numpy).

Counterpart of tuch_tpu/cli/preprocess.py, with the same flags:
  python -m tuch_tpu_torch.cli.preprocess --train_files_tuch  # dsc + mtp
  python -m tuch_tpu_torch.cli.preprocess --val_files_tuch    # mtp val
  python -m tuch_tpu_torch.cli.preprocess --test_files_tuch   # 3dpw, 3dhp
  python -m tuch_tpu_torch.cli.preprocess --synthetic [--out DIR]
Each database is a plain pickle of the JAX extractors' dict
(data/preprocess.write_db). Where h5py is not installed, --synthetic
leaves out the MPI-INF-3DHP test set (its raw files are HDF5) and says so.
"""

import argparse


def _synthetic_run(args):
    """Extract synthetic RAW trees end to end (no real datasets)."""
    import os
    import os.path as osp
    from tuch_tpu_torch.data.preprocess import synthetic_raw as sr
    from tuch_tpu_torch.data.preprocess.dsc import (read_df_subset,
                                                    read_lsp_subset)
    from tuch_tpu_torch.data.preprocess.mpi_inf_3dhp import \
        mpi_inf_3dhp_extract
    from tuch_tpu_torch.data.preprocess.mtp import mtp_extract
    from tuch_tpu_torch.data.preprocess.pw3d import pw3d_extract

    out = args.out or osp.join('out', 'preprocess_synthetic')
    raw = osp.join(out, 'raw')
    os.makedirs(out, exist_ok=True)

    try:
        import h5py  # noqa: F401
        with_3dhp_test = True
    except ImportError:
        with_3dhp_test = False
        print('=== MPI-INF-3DHP test set skipped: its annot_data.mat files '
              'are HDF5 (MATLAB v7.3) and h5py is not installed ===')
    print('=== writing synthetic RAW trees ===')
    dsc = sr.write_dsc_raw(raw)
    mtp = sr.write_mtp_raw(raw)
    pw3d = sr.write_pw3d_raw(raw)
    dhp = sr.write_3dhp_raw(raw, with_test=with_3dhp_test)

    print('=== extracting ===')
    read_df_subset(dsc['dsc_dir'], dsc['df_img_dir'], out)
    for subset in ('lsp', 'lspet'):
        read_lsp_subset(dsc['dsc_dir'], dsc[f'{subset}_img_dir'],
                        subset, out)
    mtp_extract(ds_dir=mtp['ds_dir'], out_path=out, mode='train')
    mtp_extract(ds_dir=mtp['ds_dir'], out_path=out, mode='val')
    pw3d_extract(dataset_path=pw3d['ds_dir'], out_path=out, split='test')
    mpi_inf_3dhp_extract(dataset_path=dhp['ds_dir'], out_path=out,
                         mode='train')
    if with_3dhp_test:
        mpi_inf_3dhp_extract(dataset_path=dhp['ds_dir'], out_path=out,
                             mode='test')
    print('synthetic preprocess complete ->', out)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--train_files_tuch', action='store_true',
                   help='extract DSC (df/lsp/lspet) + MTP train sets')
    p.add_argument('--val_files_tuch', action='store_true',
                   help='extract MTP val set')
    p.add_argument('--test_files_tuch', action='store_true',
                   help='extract 3DPW + MPI-INF-3DHP test sets')
    p.add_argument('--datasets', nargs='+', default=None,
                   help='explicit subset: dsc_df dsc_lsp dsc_lspet mtp '
                        '3dpw mpi-inf-3dhp')
    p.add_argument('--extract_img', action='store_true',
                   help='also extract 3DHP video frames (needs cv2)')
    p.add_argument('--static_fits', default=None,
                   help='3DHP train: dir holding mpi_inf_3dhp_spin_fits.npz'
                        ' (or a direct npz path) to merge into the output '
                        '(reference mpi_inf_3dhp.py:260-266)')
    p.add_argument('--fold_camera', action='store_true',
                   help='3DHP train: rotate world-frame static-fit global '
                        'orients into each video\'s camera frame '
                        '(reference default leaves them untouched)')
    p.add_argument('--synthetic', action='store_true',
                   help='hermetic run: write tiny synthetic RAW trees and '
                        'extract those (no downloads)')
    p.add_argument('--out', default=None,
                   help='output dir for the .pt databases '
                        '(default: config.DBS_PATH, or '
                        'out/preprocess_synthetic with --synthetic)')
    args = p.parse_args(argv)

    from tuch_tpu_torch.data.preprocess.dsc import dsc_extract
    from tuch_tpu_torch.data.preprocess.mpi_inf_3dhp import \
        mpi_inf_3dhp_extract
    from tuch_tpu_torch.data.preprocess.mtp import mtp_extract
    from tuch_tpu_torch.data.preprocess.pw3d import pw3d_extract

    if args.synthetic:
        return _synthetic_run(args)

    todo = set(args.datasets or [])
    if args.train_files_tuch:
        todo |= {'dsc_df', 'dsc_lsp', 'dsc_lspet', 'mtp'}
    if args.val_files_tuch:
        todo |= {'mtp_val'}
    if args.test_files_tuch:
        todo |= {'3dpw_test', 'mpi-inf-3dhp_test'}

    out = args.out  # None -> each extractor defaults to config.DBS_PATH
    for name in sorted(todo):
        print(f'=== extracting {name} ===')
        if name.startswith('dsc_'):
            dsc_extract(name.split('_', 1)[1], out_path=out)
        elif name == 'mtp':
            mtp_extract(mode='train', out_path=out)
        elif name == 'mtp_val':
            mtp_extract(mode='val', out_path=out)
        elif name.startswith('3dpw'):
            pw3d_extract(split=name.split('_')[-1]
                         if '_' in name else 'test', out_path=out)
        elif name.startswith('mpi-inf-3dhp'):
            mode = 'test' if name.endswith('test') else 'train'
            mpi_inf_3dhp_extract(mode=mode, extract_img=args.extract_img,
                                 out_path=out,
                                 static_fits=args.static_fits,
                                 fold_camera=args.fold_camera)
        else:
            print('unknown dataset', name)


if __name__ == '__main__':
    main()
