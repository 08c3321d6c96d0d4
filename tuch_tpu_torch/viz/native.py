"""The host library of the renderer and the crop: a mesh rasterizer and a
bilinear affine warp in C++, bound with ctypes.

Counterpart of tuch_tpu/viz/native.py. viz/native.cpp is the JAX package's
source, copied byte for byte, and builds at first use with the JAX
package's flags, g++ -O3 -shared -fPIC, into
build/tuch_tpu_torch/libtuchviz-<hash>.so, the hash over the source and the
flags (as ops/_build keys the CUDA builds). No -march=native: it would let
g++ contract a*b+c into FMA, and the warp and the rasterizer would no longer
round as the JAX package's do.

Without g++ the numpy versions run and one line says so: what the JAX
package computes on such a host. With g++ present a failed build or load
raises; it never changes every crop quietly. `calls` counts the native
library's calls, by function.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from tuch_tpu_torch.ops._build import BUILD_DIR

SRC = Path(__file__).resolve().parent / 'native.cpp'
GXX_FLAGS = ('-O3', '-shared', '-fPIC')

_lock = threading.Lock()
_lib = None
_without_gxx = False
# native calls made by this process, by function
calls = {'rasterize_mesh': 0, 'affine_warp_f32': 0}


def library_path() -> Path:
    digest = hashlib.sha256(' '.join(GXX_FLAGS).encode())
    digest.update(SRC.read_bytes())
    return BUILD_DIR / f'libtuchviz-{digest.hexdigest()[:16]}.so'


def _build(gxx: str, out: Path):
    """g++ into a temporary name, then a rename: a concurrent loader sees
    the whole library or none. Raises with the compiler's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SRC), '-o', str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'g++ failed to build {SRC} (exit '
                           f'{proc.returncode}):\n{proc.stderr}')
    os.replace(tmp, out)


def get_lib():
    """The loaded library, built first if needed; None when it is not
    built and g++ is missing. Raises when g++ is present and the build or
    the load fails."""
    global _lib, _without_gxx
    if _lib is not None or _without_gxx:
        return _lib
    with _lock:
        if _lib is not None or _without_gxx:
            return _lib
        path = library_path()
        if not path.exists():
            gxx = shutil.which('g++')
            if gxx is None:
                _without_gxx = True
                print('[tuch_tpu_torch.viz.native] g++ not found: the crop '
                      'warp and the rasterizer run their numpy versions',
                      flush=True)
                return None
            _build(gxx, path)
        lib = ctypes.CDLL(str(path))
        f32p = np.ctypeslib.ndpointer(np.float32, flags='C_CONTIGUOUS')
        i32p = np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS')
        lib.rasterize_mesh.argtypes = [
            f32p, ctypes.c_int, i32p, ctypes.c_int, f32p, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, f32p, f32p]
        lib.rasterize_mesh.restype = None
        lib.affine_warp_f32.argtypes = [
            f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p,
            ctypes.c_int, ctypes.c_int, f32p]
        lib.affine_warp_f32.restype = None
        _lib = lib
        return lib


def rasterize(verts: np.ndarray, faces: np.ndarray, colors: np.ndarray,
              height: int, width: int, focal: float, cx: float, cy: float,
              ambient: float = 0.4):
    """Rasterize a camera-space mesh: (rgb (H, W, 3), mask (H, W)), the
    pinhole camera at the origin looking down +z, py = f Y / Z + cy."""
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    colors = np.ascontiguousarray(colors, np.float32)
    rgb = np.zeros((height, width, 3), np.float32)
    mask = np.zeros((height, width), np.float32)
    lib = get_lib()
    if lib is None:
        return rasterize_numpy(verts, faces, colors, height, width, focal,
                               cx, cy, ambient, rgb, mask)
    lib.rasterize_mesh(verts, verts.shape[0], faces, faces.shape[0], colors,
                       height, width, focal, cx, cy, ambient, rgb, mask)
    calls['rasterize_mesh'] += 1
    return rgb, mask


def rasterize_numpy(verts, faces, colors, H, W, f, cx, cy, ambient, rgb,
                    mask):
    """The plain version without a compiler (flat shading, a loop over
    faces far to near); copy of the JAX package's fallback."""
    z = verts[:, 2]
    ok = z > 1e-6
    px = np.where(ok, f * verts[:, 0] / np.maximum(z, 1e-6) + cx, -1e9)
    py = np.where(ok, f * verts[:, 1] / np.maximum(z, 1e-6) + cy, -1e9)
    zbuf = np.full((H, W), np.inf, np.float32)
    order = np.argsort(-verts[faces].mean(axis=1)[:, 2])
    for t in order:
        i0, i1, i2 = faces[t]
        if not (ok[i0] and ok[i1] and ok[i2]):
            continue
        xs = np.array([px[i0], px[i1], px[i2]])
        ys = np.array([py[i0], py[i1], py[i2]])
        ix0, ix1 = int(max(0, xs.min())), int(min(W - 1, xs.max()) + 1)
        iy0, iy1 = int(max(0, ys.min())), int(min(H - 1, ys.max()) + 1)
        if ix0 >= ix1 or iy0 >= iy1:
            continue
        yy, xx = np.mgrid[iy0:iy1, ix0:ix1]
        denom = ((ys[1] - ys[2]) * (xs[0] - xs[2])
                 + (xs[2] - xs[1]) * (ys[0] - ys[2]))
        if abs(denom) < 1e-12:
            continue
        l0 = ((ys[1] - ys[2]) * (xx - xs[2])
              + (xs[2] - xs[1]) * (yy - ys[2])) / denom
        l1 = ((ys[2] - ys[0]) * (xx - xs[2])
              + (xs[0] - xs[2]) * (yy - ys[2])) / denom
        l2 = 1 - l0 - l1
        inside = (l0 >= 0) & (l1 >= 0) & (l2 >= 0)
        if not inside.any():
            continue
        zp = l0 * z[i0] + l1 * z[i1] + l2 * z[i2]
        n = np.cross(verts[i1] - verts[i0], verts[i2] - verts[i0])
        shade = ambient + (1 - ambient) * abs(
            n[2] / (np.linalg.norm(n) + 1e-12))
        col = shade * (colors[i0] + colors[i1] + colors[i2]) / 3
        zb = zbuf[iy0:iy1, ix0:ix1]
        upd = inside & (zp < zb)
        zb[upd] = zp[upd]
        rgb[iy0:iy1, ix0:ix1][upd] = col
        mask[iy0:iy1, ix0:ix1][upd] = 1.0
    return rgb, mask


def affine_warp(img: np.ndarray, inv_t: np.ndarray, out_h: int,
                out_w: int) -> np.ndarray:
    """The native bilinear warp of an (H, W[, C]) image: output pixel
    centres mapped by the 3x3 inv_t (in float32) to source coordinates;
    samples outside the image are zero. data/transforms.crop_image takes it
    when get_lib() is not None."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError('the native warp is not built (no g++)')
    img = np.ascontiguousarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    out = np.zeros((out_h, out_w, img.shape[2]), np.float32)
    lib.affine_warp_f32(img, img.shape[0], img.shape[1], img.shape[2],
                        np.ascontiguousarray(inv_t, np.float32).reshape(9),
                        out_h, out_w, out)
    calls['affine_warp_f32'] += 1
    return out
