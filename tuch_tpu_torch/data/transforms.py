"""Host-side crop and normalisation for inference.

Counterpart of the serving subset of tuch_tpu/data/transforms.py: the crop
is one inverse-warp bilinear resample (crop + rotate + resize in a single
affine map), in numpy.
"""

from typing import Tuple

import numpy as np

from tuch_tpu_torch import constants


def get_transform(center, scale, res: Tuple[int, int], rot: float = 0.0
                  ) -> np.ndarray:
    """3x3 matrix mapping original-image coords -> crop coords.

    The crop covers a square of side h = 200 * scale around `center`,
    mapped to `res` pixels, then rotated by `rot` degrees about the crop
    center (the SPIN/TUCH convention).
    """
    h = 200.0 * float(scale)
    t = np.eye(3)
    t[0, 0] = res[1] / h
    t[1, 1] = res[0] / h
    t[0, 2] = res[1] * (-float(center[0]) / h + 0.5)
    t[1, 2] = res[0] * (-float(center[1]) / h + 0.5)
    if rot != 0:
        rad = -rot * np.pi / 180.0
        sn, cs = np.sin(rad), np.cos(rad)
        rot_mat = np.array([[cs, -sn, 0], [sn, cs, 0], [0, 0, 1]])
        t_to = np.eye(3)
        t_to[0, 2] = -res[1] / 2
        t_to[1, 2] = -res[0] / 2
        t_back = np.eye(3)
        t_back[0, 2] = res[1] / 2
        t_back[1, 2] = res[0] / 2
        t = t_back @ rot_mat @ t_to @ t
    return t


def bbox_center_scale(bbox) -> Tuple[np.ndarray, float]:
    """[x, y, w, h] -> (center (2,), scale) in the SPIN crop convention
    (crop square side = 200 * scale px)."""
    bbox = np.asarray(bbox, np.float32).reshape(4)
    center = bbox[:2] + 0.5 * bbox[2:]
    return center, float(max(bbox[2], bbox[3]) / 200.0)


def full_image_center_scale(height: int, width: int
                            ) -> Tuple[np.ndarray, float]:
    """Whole-frame crop box (the no-bbox fallback)."""
    return (np.array([width // 2, height // 2], np.float32),
            max(height, width) / 200.0)


def transform_points(pts: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Apply a 3x3 transform to (N, 2) points (continuous, no rounding)."""
    homog = np.concatenate([pts, np.ones((pts.shape[0], 1))], axis=1)
    return (homog @ t.T)[:, :2]


def crop_image(img: np.ndarray, center, scale, res: Tuple[int, int],
               rot: float = 0.0) -> np.ndarray:
    """Affine crop by one inverse-warp bilinear resample.

    img (H, W, C) float or uint8 -> (res[0], res[1], C) float32; samples
    outside the image are zero.
    """
    t = get_transform(center, scale, res, rot)
    t_inv = np.linalg.inv(t)

    # Slice the source to the crop quad's bounding box before the float32
    # conversion, so a large frame costs a crop-sized allocation.
    H, W = img.shape[:2]
    corners = np.array([[0.5, 0.5], [res[1] - 0.5, 0.5],
                        [0.5, res[0] - 0.5],
                        [res[1] - 0.5, res[0] - 0.5]])
    src_c = transform_points(corners, t_inv)
    x_lo = max(int(np.floor(src_c[:, 0].min() - 1.0)), 0)
    y_lo = max(int(np.floor(src_c[:, 1].min() - 1.0)), 0)
    x_hi = min(int(np.ceil(src_c[:, 0].max() + 1.0)) + 1, W)
    y_hi = min(int(np.ceil(src_c[:, 1].max() + 1.0)) + 1, H)
    if x_hi <= x_lo or y_hi <= y_lo:
        C = img.shape[2] if img.ndim == 3 else 1
        return np.zeros((res[0], res[1], C), np.float32)
    if (x_hi - x_lo) * (y_hi - y_lo) < H * W:
        img = img[y_lo:y_hi, x_lo:x_hi]
        shift = np.eye(3)
        shift[0, 2] = -x_lo
        shift[1, 2] = -y_lo
        t_inv = shift @ t_inv

    ys, xs = np.meshgrid(np.arange(res[0]), np.arange(res[1]),
                         indexing='ij')
    # +0.5 pixel-center convention for the warp sample positions.
    dst = np.stack([xs.ravel() + 0.5, ys.ravel() + 0.5], axis=1)
    src = transform_points(dst, t_inv) - 0.5
    sx, sy = src[:, 0], src[:, 1]

    H, W = img.shape[:2]
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    fx = (sx - x0).astype(np.float32)[:, None]
    fy = (sy - y0).astype(np.float32)[:, None]

    def sample(yy, xx):
        inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        vals = img[np.clip(yy, 0, H - 1), np.clip(xx, 0, W - 1)].astype(
            np.float32)
        vals[~inside] = 0.0
        return vals

    out = (sample(y0, x0) * (1 - fx) * (1 - fy)
           + sample(y0, x0 + 1) * fx * (1 - fy)
           + sample(y0 + 1, x0) * (1 - fx) * fy
           + sample(y0 + 1, x0 + 1) * fx * fy)
    return out.reshape(res[0], res[1], -1)


def normalize_image(img01: np.ndarray) -> np.ndarray:
    """ImageNet-normalise an (H, W, 3) image in [0, 1]."""
    mean = np.asarray(constants.IMG_NORM_MEAN, np.float32)
    std = np.asarray(constants.IMG_NORM_STD, np.float32)
    return ((img01 - mean) / std).astype(np.float32)
