"""tuch_tpu_torch's crop and its host library against tuch_tpu, on the CPU.

Both packages crop with the native C++ warp of viz/native.cpp wherever g++
builds it, else with their numpy warp. The port's default crop equals the
JAX package's default crop bit for bit, and each numpy warp the other's;
the port's library is built from its own copy of the source, with the JAX
package's flags, and a failed build with g++ present raises.
"""

import hashlib
import os
import shutil

import numpy as np
import pytest

from tuch_tpu.data import transforms as JT
from tuch_tpu.viz import native as jax_native
from tuch_tpu_torch.data import transforms as PT
from tuch_tpu_torch.ops import _build
from tuch_tpu_torch.viz import native

RES = (64, 64)


def crops(n=24, seed=0):
    """(image, center, scale, rot): uint8 and float images, rotations up
    to 40 degrees, boxes inside, partly outside and wholly outside."""
    rng = np.random.RandomState(seed)
    imgs = [(rng.rand(120, 160, 3) * 255).astype(np.uint8),
            rng.rand(90, 70, 3).astype(np.float32) * 255,
            (rng.rand(100, 100) * 255).astype(np.uint8)]
    out = []
    for i in range(n):
        img = imgs[i % 3]
        H, W = img.shape[:2]
        kind = i % 4
        if kind == 3:          # wholly outside
            center = (W + 200.0 + 50 * rng.rand(), -150.0)
        elif kind == 2:        # partly outside
            center = (rng.uniform(-10, 10), rng.uniform(H - 10, H + 10))
        else:
            center = (rng.uniform(0.3, 0.7) * W, rng.uniform(0.3, 0.7) * H)
        out.append((img, center, rng.uniform(0.2, 0.9),
                    0.0 if kind == 0 else rng.uniform(-40, 40)))
    return out


def test_default_crop_bit_for_bit_with_jax_default():
    """24 seeded crops through each package's default crop_image: the
    same float32 bits (both take the native warp here)."""
    assert jax_native.get_lib() is not None and native.get_lib() is not None
    calls = native.calls['affine_warp_f32']
    for img, center, scale, rot in crops():
        want = JT.crop_image(img, center, scale, RES, rot=rot)
        got = PT.crop_image(img, center, scale, RES, rot=rot)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=f'{center} {rot}')
    # the wholly-outside boxes never reach the warp
    assert native.calls['affine_warp_f32'] - calls == 18


def test_numpy_warps_bit_for_bit(monkeypatch):
    """With no native library in either package, the numpy warps agree bit
    for bit, and differ from the native warp (float64 against float32
    source coordinates) somewhere."""
    native_out = [PT.crop_image(*c[:3], RES, rot=c[3]) for c in crops()]
    monkeypatch.setattr(jax_native, 'get_lib', lambda: None)
    monkeypatch.setattr(native, 'get_lib', lambda: None)
    differs = 0
    for (img, center, scale, rot), nat in zip(crops(), native_out):
        want = JT.crop_image(img, center, scale, RES, rot=rot)
        got = PT.crop_image(img, center, scale, RES, rot=rot)
        np.testing.assert_array_equal(got, want, err_msg=f'{center} {rot}')
        differs += int((got != nat).any())
    assert differs > 0


def test_library_built_from_the_ports_own_copy():
    """The port's native.cpp is the JAX package's byte for byte; its
    library lies under build/tuch_tpu_torch, named by the hash of that
    copy and the JAX package's flags (no -march=native)."""
    src = os.path.join(os.path.dirname(jax_native.__file__), 'native.cpp')
    with open(src, 'rb') as f:
        assert f.read() == native.SRC.read_bytes()
    assert native.GXX_FLAGS == ('-O3', '-shared', '-fPIC')
    path = native.library_path()
    digest = hashlib.sha256(b'-O3 -shared -fPIC')
    digest.update(native.SRC.read_bytes())
    name = f'libtuchviz-{digest.hexdigest()[:16]}.so'
    assert path == _build.BUILD_DIR / name
    assert native.get_lib()._name == str(path)
    assert os.path.realpath(path) != os.path.realpath(jax_native._SO)


@pytest.fixture
def fresh_native(monkeypatch, tmp_path):
    """The module as before its first call, building into tmp_path."""
    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, '_without_gxx', False)
    monkeypatch.setattr(native, 'BUILD_DIR', tmp_path)
    monkeypatch.setattr(native, 'library_path',
                        lambda: tmp_path / 'libtuchviz-test.so')
    return tmp_path


def test_failed_build_with_gxx_raises(fresh_native, monkeypatch):
    broken = fresh_native / 'native.cpp'
    broken.write_text('extern "C" { this is not C++ }\n')
    monkeypatch.setattr(native, 'SRC', broken)
    with pytest.raises(RuntimeError, match='g\\+\\+ failed'):
        native.get_lib()
    img = np.zeros((32, 32, 3), np.uint8)
    with pytest.raises(RuntimeError):
        PT.crop_image(img, (16, 16), 0.1, (8, 8))


def test_without_gxx_numpy_versions_and_one_line(fresh_native, monkeypatch,
                                                 capsys):
    monkeypatch.setattr(shutil, 'which', lambda name: None)
    assert native.get_lib() is None
    assert native.get_lib() is None
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if 'g++ not found' in ln]
    assert len(lines) == 1
    img = (np.random.RandomState(1).rand(50, 60, 3) * 255).astype(np.uint8)
    monkeypatch.setattr(jax_native, 'get_lib', lambda: None)
    np.testing.assert_array_equal(
        PT.crop_image(img, (30, 25), 0.2, RES, rot=12.0),
        JT.crop_image(img, (30, 25), 0.2, RES, rot=12.0))
