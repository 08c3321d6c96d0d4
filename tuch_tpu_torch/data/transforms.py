"""Host-side crop, flips and keypoint/pose transforms, in numpy.

Counterpart of tuch_tpu/data/transforms.py: the crop is one inverse-warp
bilinear resample (crop + rotate + resize in a single affine map), by the
native C++ warp (viz/native) wherever g++ builds it, as in the JAX package,
else by its plain numpy version (affine_warp_numpy); the keypoint and pose
transforms are what TuchDataset.get needs.
"""

from typing import Tuple

import numpy as np

from tuch_tpu_torch import constants
from tuch_tpu_torch.viz import native


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
    outside the image are zero. The native warp when the library is built
    (its source coordinates in float32), else the numpy warp (float64):
    the JAX package's choice, on the same sliced source and t_inv.
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
    if native.get_lib() is not None:
        return native.affine_warp(np.asarray(img, np.float32), t_inv,
                                  res[0], res[1])
    return affine_warp_numpy(img, t_inv, res)


def affine_warp_numpy(img: np.ndarray, t_inv: np.ndarray,
                      res: Tuple[int, int]) -> np.ndarray:
    """The plain warp: output pixel centres mapped by t_inv (float64) to
    source coordinates, bilinear, zero outside the image."""
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


def flip_img(img: np.ndarray) -> np.ndarray:
    """Horizontal flip, channels-last."""
    return np.ascontiguousarray(img[:, ::-1])


def flip_kp(kp: np.ndarray) -> np.ndarray:
    """Flip keypoints of the 24- or 49-joint convention."""
    if len(kp) == 24:
        perm = constants.J24_FLIP_PERM
    elif len(kp) == 49:
        perm = constants.J49_FLIP_PERM
    else:
        raise ValueError(f'unsupported keypoint count {len(kp)}')
    kp = kp[perm].copy()
    kp[:, 0] = -kp[:, 0]
    return kp


def flip_pose_np(pose: np.ndarray) -> np.ndarray:
    """Flip a 72-dim SMPL pose."""
    pose = pose[constants.SMPL_POSE_FLIP_PERM].copy()
    pose[1::3] = -pose[1::3]
    pose[2::3] = -pose[2::3]
    return pose


def aa_to_rotmat_np(aa: np.ndarray) -> np.ndarray:
    """Axis-angle (3,) -> rotation matrix (Rodrigues)."""
    angle = np.linalg.norm(aa)
    if angle < 1e-8:
        return np.eye(3)
    axis = aa / angle
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def rotmat_to_aa_np(M: np.ndarray) -> np.ndarray:
    """Rotation matrix -> axis-angle, with the near-pi branch (where the
    antisymmetric part vanishes and the axis comes from (M + I) / 2)."""
    cos_a = np.clip((np.trace(M) - 1) / 2, -1, 1)
    a = np.arccos(cos_a)
    if a < 1e-8:
        return np.zeros(3, np.float32)
    if np.pi - a < 1e-6:
        A = (M + np.eye(3)) / 2
        k = int(np.argmax(np.diag(A)))
        axis = A[k] / max(np.sqrt(max(A[k, k], 1e-12)), 1e-12)
        axis /= max(np.linalg.norm(axis), 1e-12)
        return (axis * a).astype(np.float32)
    axis = np.array([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0],
                     M[1, 0] - M[0, 1]]) / (2 * np.sin(a))
    return (axis * a).astype(np.float32)


def rot_aa_np(aa: np.ndarray, rot: float) -> np.ndarray:
    """Rotate a global orientation by `rot` image degrees."""
    if rot == 0:
        return aa.astype(np.float32)
    rad = np.deg2rad(-rot)
    R = np.array([[np.cos(rad), -np.sin(rad), 0],
                  [np.sin(rad), np.cos(rad), 0], [0, 0, 1]])
    return rotmat_to_aa_np(R @ aa_to_rotmat_np(aa))


def j2d_processing(kp: np.ndarray, center, scale, res: int, rot: float,
                   flip: bool) -> np.ndarray:
    """2D keypoints into normalised crop coordinates in [-1, 1]."""
    t = get_transform(center, scale, (res, res), rot)
    kp = kp.copy()
    kp[:, :2] = transform_points(kp[:, :2], t)
    kp[:, :-1] = 2.0 * kp[:, :-1] / res - 1.0
    if flip:
        kp = flip_kp(kp)
    return kp.astype(np.float32)


def j3d_processing(S: np.ndarray, rot: float, flip: bool,
                   apply_rotation: bool = False) -> np.ndarray:
    """Flip (and, with apply_rotation, rotate) 3D keypoints.

    apply_rotation=False is the reference's behaviour: its rotation branch
    is unreachable, so 3D keypoints are never rotated with the image.
    """
    S = S.copy()
    if apply_rotation and rot != 0:
        rad = -rot * np.pi / 180
        sn, cs = np.sin(rad), np.cos(rad)
        R = np.eye(3)
        R[0, :2] = [cs, -sn]
        R[1, :2] = [sn, cs]
        S[:, :3] = S[:, :3] @ R.T
    if flip:
        S = flip_kp(S)
    return S.astype(np.float32)


def pose_processing(pose: np.ndarray, rot: float, flip: bool) -> np.ndarray:
    """Rotate the global orientation and optionally flip a SMPL pose."""
    pose = pose.copy()
    pose[:3] = rot_aa_np(pose[:3], rot)
    if flip:
        pose = flip_pose_np(pose)
    return pose.astype(np.float32)
