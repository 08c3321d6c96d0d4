"""Mesh visualisation: overlays, contact colouring, summary strips and
exports.

Counterpart of tuch_tpu/viz/renderer.py for numpy arrays: the host C++
rasterizer of viz/native (its numpy version without g++) in place of the
reference's pyrender/EGL renderer, with the same capabilities: a mesh under
a full-perspective camera, contact-region vertex colours, alpha composite
over the input image, the summary strips (visualize_tbm, visualize_eft,
visu_smplifycontactopti) and the OBJ, PNG and camera exports.
"""

import os
import pickle
from typing import Optional, Sequence

import numpy as np

from tuch_tpu_torch import constants
from tuch_tpu_torch.viz import native

BASE_COLOR = np.array([0.65, 0.74, 0.86], np.float32)
CONTACT_COLOR = np.array([0.9, 0.3, 0.3], np.float32)
NEUTRAL_BG = 1.0


class Renderer:
    """Offscreen renderer for SMPL-family meshes.

    contact_csig: optional dict region-name -> vertex ids and
    contact_classes: list of region-name pairs (for coloring annotated
    contact, reference renderer.py:200-224).
    """

    def __init__(self, focal_length: float = constants.FOCAL_LENGTH,
                 img_res: int = constants.IMG_RES,
                 faces: Optional[np.ndarray] = None,
                 contact_classes: Optional[list] = None,
                 contact_csig: Optional[dict] = None):
        self.focal_length = float(focal_length)
        self.img_res = int(img_res)
        self.faces = None if faces is None else np.asarray(faces, np.int32)
        self.contact_classes = contact_classes or []
        self.contact_csig = contact_csig or {}

    # ------------------------------------------------------------------
    def vertex_colors(self, num_verts: int,
                      contact_vec: Optional[np.ndarray] = None
                      ) -> np.ndarray:
        colors = np.tile(BASE_COLOR, (num_verts, 1))
        if contact_vec is not None and len(self.contact_classes):
            for p, (na, nb) in enumerate(self.contact_classes):
                if p < len(contact_vec) and contact_vec[p] > 0:
                    for name in (na, nb):
                        ids = np.asarray(self.contact_csig.get(name, []))
                        if ids.size:
                            colors[ids] = CONTACT_COLOR
        return colors.astype(np.float32)

    def render_over(self, vertices: np.ndarray, cam_t: np.ndarray,
                    image: Optional[np.ndarray] = None,
                    contact_vec: Optional[np.ndarray] = None,
                    faces: Optional[np.ndarray] = None) -> np.ndarray:
        """Render mesh over an (H, W, 3) [0,1] image (or white bg).

        vertices: (V, 3) body-space; cam_t: (3,) translation into camera
        space. Projection is py = f*Y/Z + cy -- the same convention as
        the training/keypoint projection, equivalent to the reference's
        net pyrender setup (renderer.py:236-245).
        """
        faces = self.faces if faces is None else np.asarray(faces, np.int32)
        H = W = self.img_res
        if image is None:
            image = np.full((H, W, 3), NEUTRAL_BG, np.float32)
        else:
            image = np.asarray(image, np.float32)
            H, W = image.shape[:2]
        verts_cam = np.asarray(vertices, np.float32) + \
            np.asarray(cam_t, np.float32)[None, :]
        # NO y flip here: the rasterizer projects py = f*Y/Z + cy, the
        # exact convention of the training/keypoint projection
        # (utils/projection.perspective_projection), so the overlay
        # lands where the keypoints/loss say it is. (The reference's
        # pyrender Rx(180) mesh flip + GL y-up camera also nets out to
        # this, renderer.py:236-245.) Behind-camera vertices are clipped
        # by the rasterizer's Z guard, not mirrored.
        colors = self.vertex_colors(verts_cam.shape[0], contact_vec)
        rgb, mask = native.rasterize(verts_cam, faces, colors, H, W,
                                     self.focal_length, W / 2.0, H / 2.0)
        out = image * (1 - mask[..., None]) + rgb * mask[..., None]
        return np.clip(out, 0, 1)

    def render_rotated(self, vertices: np.ndarray, cam_t: np.ndarray,
                       deg: float, **kw) -> np.ndarray:
        """Side view: rotate the body about +y before rendering.

        Matches the reference's row-vector convention
        `np.dot(v - center, Rodrigues([0, rad, 0])) + center`
        (demo_tuch.py:178-180) -- i.e. v @ R applies R^T, so deg=90
        shows the SAME profile the reference shows for 90.
        """
        v = np.asarray(vertices, np.float32)
        center = v.mean(axis=0)
        rad = np.deg2rad(deg)
        R = np.array([[np.cos(rad), 0, np.sin(rad)],
                      [0, 1, 0],
                      [-np.sin(rad), 0, np.cos(rad)]], np.float32)
        return self.render_over((v - center) @ R + center, cam_t, **kw)

    # ------------------------------------------------------------------
    # Grid builders (reference renderer.py:52-180)
    def visualize_tbm(self, vertices_b, cam_t_b, images_b,
                      contact_vecs=None, max_items: int = 6) -> np.ndarray:
        """Batch grid: each column one sample, mesh over its image."""
        n = min(len(vertices_b), max_items)
        tiles = []
        for i in range(n):
            cv = None if contact_vecs is None else np.asarray(
                contact_vecs[i])
            tiles.append(self.render_over(
                np.asarray(vertices_b[i]), np.asarray(cam_t_b[i]),
                np.asarray(images_b[i]), contact_vec=cv))
        return np.concatenate(tiles, axis=1)

    def visualize_eft(self, vertices_b, cam_t_b, images_b,
                      contact_vecs=None) -> np.ndarray:
        return self.visualize_tbm(vertices_b, cam_t_b, images_b,
                                  contact_vecs)

    def visu_smplifycontactopti(self, traj, cam_t_b, images_b,
                                contact_vecs=None, num_steps: int = 4,
                                sample: int = 0) -> np.ndarray:
        """Optimization trajectory strip: one sample across fit iterations.

        traj: (T, B, V, 3) vertex trajectory from SMPLifyResult.trajectory.
        """
        traj = np.asarray(traj)
        T = traj.shape[0]
        steps = np.linspace(0, T - 1, num_steps).astype(int)
        cv = None if contact_vecs is None else np.asarray(
            contact_vecs[sample])
        tiles = [self.render_over(traj[t, sample],
                                  np.asarray(cam_t_b[sample]),
                                  np.asarray(images_b[sample]),
                                  contact_vec=cv) for t in steps]
        return np.concatenate(tiles, axis=1)


# ---------------------------------------------------------------------------
# Exports (replacing trimesh mesh.export at demo_tuch.py:148-163)
# ---------------------------------------------------------------------------

def save_obj(path: str, vertices: np.ndarray, faces: np.ndarray):
    """Minimal OBJ writer (1-indexed faces)."""
    v = np.asarray(vertices)
    f = np.asarray(faces) + 1
    with open(path, 'w') as fh:
        for x, y, z in v:
            fh.write(f'v {x:.6f} {y:.6f} {z:.6f}\n')
        for a, b, c in f:
            fh.write(f'f {a} {b} {c}\n')


def rotation_about(axis: Sequence[float], deg: float) -> np.ndarray:
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    a = np.deg2rad(deg)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return (np.eye(3) + np.sin(a) * K
            + (1 - np.cos(a)) * K @ K).astype(np.float32)


def save_png(path: str, image01: np.ndarray):
    from PIL import Image
    arr = np.clip(np.asarray(image01) * 255, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def save_camera_pkl(path: str, pred_camera: np.ndarray,
                    cam_transform: np.ndarray):
    """Camera dump with the reference demo's schema (demo_tuch.py:196-204)."""
    cam1 = np.asarray(cam_transform).copy()
    cam1[0] *= -1
    with open(path, 'wb') as f:
        pickle.dump({'spin_output': np.asarray(pred_camera),
                     'cam_transform': np.asarray(cam_transform),
                     'cam_transform_1': cam1}, f)
