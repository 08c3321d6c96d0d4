"""The attention kernel's wrapper, build and launch count (torch only).

This file imports no JAX, so it also runs on a machine with a card and no
JAX: ``python -m pytest --noconftest tests/test_torch_port_kernels.py``.
The tests marked `cuda` launch the CUDA kernel and skip without a card; the
others check, on any host, that the wrapper never computes a CUDA call on
the CPU and that the modules import without nvcc.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tuch_tpu_torch.ops import attention as A

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (B, N, C, heads): vit_s16 at 224 (unaligned N), an aligned toy shape, an
# odd N whose last query and key tiles are ragged, and vit_t8 at 64
SHAPES = [(2, 196, 384, 6), (3, 128, 64, 2), (2, 197, 384, 6),
          (4, 64, 64, 2)]


def _qkv(B, N, C, dtype=torch.float32, device='cpu'):
    x = np.random.RandomState(0).randn(B, N, 3 * C).astype(np.float32)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def test_fused_mha_on_cpu_uses_plain_version_without_launching():
    x = _qkv(2, 10, 64)
    before = A.mha_cuda.launches
    out = A.fused_mha(x, 2)
    assert A.mha_cuda.launches == before
    torch.testing.assert_close(out, A.mha_reference(x, 2), rtol=0, atol=0)


def test_mha_cuda_refuses_a_cpu_tensor():
    # no fallback: the kernel wrapper never computes on the CPU
    with pytest.raises(ValueError, match='CUDA tensor'):
        A.mha_cuda(_qkv(1, 4, 64), 2)


def test_mha_reference_matches_explicit_per_head_math():
    B, N, C, H = 2, 10, 96, 3
    x = _qkv(B, N, C)
    q, k, v = x.numpy().reshape(B, N, 3, H, C // H).transpose(2, 0, 3, 1, 4)
    logits = q @ k.transpose(0, 1, 3, 2) / np.sqrt(C // H)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    want = (e / e.sum(-1, keepdims=True)) @ v          # (B, H, N, hd)
    want = want.transpose(0, 2, 1, 3).reshape(B, N, C)
    np.testing.assert_allclose(A.mha_reference(x, H).numpy(), want,
                               atol=1e-5)


def test_kernel_modules_import_without_nvcc(tmp_path):
    env = dict(os.environ, PATH=str(tmp_path), PYTHONPATH=REPO)
    code = ('import shutil; import tuch_tpu_torch.ops.attention, '
            'tuch_tpu_torch.ops._build as b; '
            'assert shutil.which("nvcc") is None; print(b.sources())')
    out = subprocess.run([sys.executable, '-c', code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert 'mha' in out.stdout


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (the kernel has no CPU mode)')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize('shape', SHAPES)
def test_mha_kernel_matches_plain_version_on_card(cuda_device, shape, dtype,
                                                  tol):
    B, N, C, heads = shape
    x = _qkv(B, N, C, dtype, cuda_device)
    before = A.mha_cuda.launches
    got = A.fused_mha(x, heads)
    torch.cuda.synchronize()
    assert A.mha_cuda.launches == before + 1
    want = A.mha_reference(x, heads)
    assert got.dtype == dtype and got.shape == (B, N, C)
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_mha_cuda_rejects_unsupported_head_dim_on_card(cuda_device):
    with pytest.raises(ValueError, match='head dims'):
        A.mha_cuda(_qkv(1, 8, 48, device=cuda_device), 1)
