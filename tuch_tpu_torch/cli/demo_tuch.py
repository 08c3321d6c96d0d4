"""demo_tuch: TUCH on one image (or a directory of images) on the GPU.

Counterpart of tuch_tpu/cli/demo_tuch.py with its flags plus --device: the
person box from an OpenPose json, a bbox json or the whole frame, the crop,
one eval forward (HMR -> SMPL -> weak-perspective translation) on the
device, then on the host the three OBJ meshes (front, _r60, _r300, flipped
180 degrees about x), the camera pickle, the input crop and the
front-and-side strip rendered by viz/renderer. --synthetic runs on the
synthetic body and random weights and, without --img, writes and reads a
deterministic test image.

  python -m tuch_tpu_torch.cli.demo_tuch --checkpoint ckpt.pt \\
      --img in.jpg --openpose in_keypoints.json --outdir out/
  python -m tuch_tpu_torch.cli.demo_tuch --synthetic --device cpu
"""

import argparse
import glob
import json
import os
import os.path as osp
import time

import numpy as np
import torch

from tuch_tpu_torch import constants
from tuch_tpu_torch.data import transforms as T
from tuch_tpu_torch.viz.renderer import (Renderer, rotation_about,
                                         save_camera_pkl, save_obj, save_png)

# the parts of one image's time, in order (main's records)
PARTS = ('crop', 'forward', 'render', 'write')


def bbox_from_openpose(openpose_file, rescale=1.2, detection_thresh=0.2):
    """Center and scale from the first person's OpenPose keypoints."""
    with open(openpose_file) as f:
        keypoints = json.load(f)['people'][0]['pose_keypoints_2d']
    keypoints = np.reshape(np.array(keypoints), (-1, 3))
    valid = keypoints[:, -1] > detection_thresh
    valid_keypoints = keypoints[valid][:, :-1]
    center = valid_keypoints.mean(axis=0)
    bbox_size = (valid_keypoints.max(axis=0)
                 - valid_keypoints.min(axis=0)).max()
    return center, bbox_size / 200.0 * rescale


def bbox_from_json(bbox_file):
    """Center and scale from a {"bbox": [x, y, w, h]} json."""
    with open(bbox_file) as f:
        bbox = np.array(json.load(f)['bbox'], np.float32)
    return T.bbox_center_scale(bbox)


def process_image(img_file, bbox_file, openpose_file, input_res=224):
    """Read, crop and normalise one image: (crop in [0, 1] (H, W, 3),
    normalised (1, H, W, 3))."""
    from tuch_tpu_torch.data.dataset import _read_image
    img = _read_image(img_file)
    if bbox_file is None and openpose_file is None:
        center, scale = T.full_image_center_scale(*img.shape[:2])
    elif bbox_file is not None:
        center, scale = bbox_from_json(bbox_file)
    else:
        center, scale = bbox_from_openpose(openpose_file)
    crop = T.crop_image(img, center, scale, (input_res, input_res)) / 255.0
    norm = T.normalize_image(crop)[None]
    return crop.astype(np.float32), norm


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--checkpoint', default=None,
                   help='HMR checkpoint (a reference .pt, the JAX '
                        "package's .npz or this package's)")
    p.add_argument('--img', type=str, default=None,
                   help='input image or directory (optional with '
                        '--synthetic: a deterministic test image is used)')
    p.add_argument('--bbox', type=str, default=None)
    p.add_argument('--openpose', type=str, default=None)
    p.add_argument('--outfile', type=str, default=None)
    p.add_argument('--outdir', type=str, default='out')
    p.add_argument('--spin_img_dir', type=str,
                   default='data/images_spin_fit',
                   help='with --stack: dir of rendered SPIN fits')
    p.add_argument('--eft_img_dir', type=str,
                   default='data/images_eft_fit',
                   help='with --stack: dir of rendered EFT fits')
    p.add_argument('--stack', type=lambda x: x in ('true', 'True'),
                   default=False,
                   help='append the SPIN and EFT fit renders of the same '
                        'image to the output strip')
    p.add_argument('--synthetic', action='store_true',
                   help='synthetic body and weights (no assets required)')
    p.add_argument('--device', default=None,
                   help="torch device (default CUDA; 'cpu' to run there)")
    args = p.parse_args(argv)
    if args.img is None and not args.synthetic:
        p.error('--img is required unless --synthetic is set')
    return args


def write_synthetic_input(outdir: str) -> str:
    """The deterministic 224x224 test image of --synthetic, as a PNG."""
    from PIL import Image
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:224, 0:224].astype(np.float32) / 223.0
    img = np.stack([yy, xx, 0.5 * (yy + xx)], axis=-1)
    img = (255 * np.clip(img + 0.05 * rng.randn(224, 224, 3), 0, 1)
           ).astype(np.uint8)
    os.makedirs(outdir, exist_ok=True)
    path = osp.join(outdir, 'synthetic_input.png')
    Image.fromarray(img).save(path)
    return path


def pair_openpose(imgs, openpose):
    """One OpenPose file per image: by image stem for a directory
    (<stem>_keypoints.json or <stem>.json; a missing one raises), else the
    one file (or None) for every image."""
    if not (openpose and osp.isdir(openpose)):
        return [openpose] * len(imgs)
    ops = []
    for img_path in imgs:
        stem = osp.splitext(osp.basename(img_path))[0]
        cands = (osp.join(openpose, stem + '_keypoints.json'),
                 osp.join(openpose, stem + '.json'))
        found = next((c for c in cands if osp.isfile(c)), None)
        if found is None:
            raise FileNotFoundError(
                f'no openpose json for {img_path} (looked for {cands[0]} '
                f'and {cands[1]})')
        ops.append(found)
    return ops


def stack_tiles(strip, stem, dirs):
    """The strip with the same image's renders from `dirs` appended,
    resized to its height; a missing one is skipped with a line."""
    from PIL import Image
    tiles = [strip]
    for d in dirs:
        fp = osp.join(d, stem + '.png')
        if not osp.isfile(fp):
            print('stack: missing', fp)
            continue
        with Image.open(fp) as im:
            t = np.asarray(im.convert('RGB'), np.float32) / 255.0
        if t.shape[0] != strip.shape[0]:
            ratio = strip.shape[0] / t.shape[0]
            im2 = Image.fromarray((t * 255).astype(np.uint8)).resize(
                (int(t.shape[1] * ratio), strip.shape[0]))
            t = np.asarray(im2, np.float32) / 255.0
        tiles.append(t)
    return np.concatenate(tiles, axis=1)


def main(argv=None):
    """Run the demo; returns one record per image: (output stem path,
    vertices (V, 3), camera translation (3,), {part: host seconds} over
    PARTS)."""
    args = parse_args(argv)
    from tuch_tpu_torch import resolve_device
    from tuch_tpu_torch import runtime as rt
    from tuch_tpu_torch.models.smpl import smpl_forward
    from tuch_tpu_torch.utils.projection import \
        weak_perspective_to_translation

    dev = resolve_device(args.device)
    if args.img is None:
        args.img = write_synthetic_input(args.outdir)
    runtime = rt.build_runtime(device=dev, synthetic=args.synthetic or None)
    if args.checkpoint:
        from tuch_tpu_torch.train.checkpoint import load_variables
        load_variables(args.checkpoint, runtime.hmr)
    hmr, smpl = runtime.hmr.eval(), runtime.smpl

    @torch.no_grad()
    def forward(norm_img):
        rotmat, betas, cam = hmr(torch.as_tensor(norm_img, device=dev))
        out = smpl_forward(smpl, betas, rotmat[:, 1:], rotmat[:, :1],
                           pose2rot=False)
        cam_t = weak_perspective_to_translation(cam, constants.FOCAL_LENGTH,
                                                constants.IMG_RES)
        return (out.vertices[0].cpu().numpy(), cam.cpu().numpy(),
                cam_t[0].cpu().numpy())

    faces = smpl.faces.cpu().numpy()
    renderer = Renderer(faces=faces)
    imgs = sorted(glob.glob(osp.join(args.img, '*'))
                  if osp.isdir(args.img) else [args.img])
    ops = pair_openpose(imgs, args.openpose)
    os.makedirs(args.outdir, exist_ok=True)
    records = []
    for idx, (img_path, op_path) in enumerate(zip(imgs, ops)):
        print('processing', img_path, op_path or '')
        t0 = time.perf_counter()
        img01, norm = process_image(img_path, args.bbox, op_path)
        t1 = time.perf_counter()
        verts, cam, cam_t0 = forward(norm)
        t2 = time.perf_counter()
        front = renderer.render_over(verts, cam_t0, img01)
        side = renderer.render_rotated(verts, cam_t0, 90.0,
                                       image=np.ones_like(img01))
        t3 = time.perf_counter()

        if args.outfile is None:
            stem = osp.splitext(osp.basename(img_path))[0]
        elif len(imgs) > 1:
            # one suffix per image, so that the outputs do not overwrite
            stem = f'{args.outfile}_{idx:03d}'
        else:
            stem = args.outfile
        out = osp.join(args.outdir, stem)
        rot_x = rotation_about([1, 0, 0], 180)
        save_obj(out + '.obj', verts @ rot_x.T, faces)
        for deg, suffix in ((60, '_r60'), (300, '_r300')):
            rot_y = rotation_about([0, 1, 0], deg)
            save_obj(out + suffix + '.obj', (verts @ rot_x.T) @ rot_y.T,
                     faces)
        save_camera_pkl(out + '_camera.pkl', cam, cam_t0)
        save_png(out + '_img_in.png', img01)
        strip = np.concatenate([img01, front, side], axis=1)
        if args.stack:
            # the stacked strip takes <stem>.png, as in the reference
            strip = stack_tiles(strip, stem,
                                (args.eft_img_dir, args.spin_img_dir))
        save_png(out + '.png', strip)
        t4 = time.perf_counter()
        times = dict(zip(PARTS, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)))
        records.append((out, verts, cam_t0, times))
        print('saved results to', out)
    return records


if __name__ == '__main__':
    main()
