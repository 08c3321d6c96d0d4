"""The kernels' wrappers, builds and launch counts (torch only).

Attention (kernel 1), winding numbers (2), the masked nearest vertex (4),
row gather (5) and row scatter-add (6). This file imports no JAX, so it
also runs on a machine with a card and no JAX:
``python -m pytest --noconftest tests/test_torch_port_kernels.py``.
The tests marked `cuda` launch the CUDA kernels and skip without a card;
the others check, on any host, that the wrappers never compute a CUDA call
on the CPU, that dispatch on the CPU takes the plain version without
counting a launch, and that the modules import without nvcc.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tuch_tpu_torch.ops import attention as A
from tuch_tpu_torch.ops import contact as PC
from tuch_tpu_torch.ops import contact_kernels as CK
from tuch_tpu_torch.ops import gather as G

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
            'tuch_tpu_torch.ops.contact_kernels, tuch_tpu_torch.ops.gather, '
            'tuch_tpu_torch.ops.segments, tuch_tpu_torch.ops._build as b; '
            'assert shutil.which("nvcc") is None; print(b.sources())')
    out = subprocess.run([sys.executable, '-c', code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for name in ('mha', 'winding', 'masked_min', 'gather'):
        assert repr(name) in out.stdout


# ---------------------------------------------------------------------------
# kernels 2, 4, 5, 6: wrappers on any host
# ---------------------------------------------------------------------------

def _body(B=2, V=150, F=296, seed=0, device='cpu'):
    """A closed random-ish mesh: jittered sphere points and random faces
    are enough for the wrappers' contracts (shapes, padding, ranges)."""
    rng = np.random.RandomState(seed)
    verts = rng.randn(B, V, 3).astype(np.float32)
    faces = rng.randint(0, V, (F, 3)).astype(np.int64)
    return (torch.from_numpy(verts).to(device),
            torch.from_numpy(faces).to(device))


def _launches():
    return (CK.winding_numbers_tris_cuda.launches,
            CK.masked_min_dist_cuda.launches,
            G.gather_rows_cuda.launches, G.scatter_add_rows_cuda.launches)


def test_contact_wrappers_refuse_cpu_tensors():
    verts, faces = _body()
    idx = torch.zeros((2, 5), dtype=torch.int32)
    mask = torch.ones((150, 150), dtype=torch.uint8)
    calls = [
        lambda: CK.winding_numbers_tris_cuda(verts, verts[:, faces]),
        lambda: CK.masked_min_dist_cuda(verts, mask),
        lambda: G.gather_rows_cuda(verts, idx),
        lambda: G.scatter_add_rows_cuda(verts[:, :5].contiguous(), idx, 150),
    ]
    for call in calls:
        with pytest.raises(ValueError, match='CUDA'):
            call()


def test_contact_dispatch_on_cpu_uses_plain_versions_without_launching():
    verts, faces = _body()
    rng = np.random.RandomState(1)
    mask = torch.from_numpy((rng.rand(150, 150) > 0.4).astype(np.uint8))
    idx = torch.from_numpy(rng.randint(-1, 151, (2, 40)).astype(np.int32))
    before = _launches()
    wn = CK.winding_numbers_faces(verts, verts, faces)
    torch.testing.assert_close(
        wn, PC.winding_numbers_same_tris(verts, verts, faces),
        rtol=0, atol=0)
    torch.testing.assert_close(
        CK.winding_numbers_tris(verts, verts[:, faces]),
        PC.winding_numbers(verts, verts[:, faces], block_f=296),
        rtol=0, atol=0)
    d2, arg = CK.masked_min_dist(verts, mask)
    want_d2, want_arg = PC.masked_min_dist(verts, mask.bool())
    assert torch.equal(d2, want_d2) and torch.equal(arg, want_arg)
    v = verts.clone().requires_grad_(True)
    out = G.gather_rows(v, idx)
    assert torch.equal(out, G.gather_rows_ref(verts, idx))
    out.sum().backward()
    torch.testing.assert_close(
        v.grad, G.scatter_add_rows_ref(torch.ones_like(out), idx, 150),
        rtol=0, atol=0)
    assert _launches() == before


def test_split_covers_the_axis_in_whole_tiles():
    for base, n, tile in [(1, 13776, 128), (54, 13776, 128),
                          (3456, 13776, 128), (18, 492, 128),
                          (54, 6890, 256), (1, 100, 256)]:
        chunk, splits = CK._split(base, n, tile)
        assert chunk % tile == 0 and splits >= 1
        assert chunk * splits >= n > chunk * (splits - 1)
        assert base * splits <= max(base, CK.TARGET_BLOCKS + base)


def test_plain_gather_and_scatter_handle_out_of_range_indices():
    vals = torch.arange(2 * 4 * 3, dtype=torch.float32).reshape(2, 4, 3)
    idx = torch.tensor([[0, -1, 3, 4], [2, 2, 1, -5]], dtype=torch.int32)
    got = G.gather_rows_ref(vals, idx)
    assert torch.equal(got[0, 1], torch.zeros(3))
    assert torch.equal(got[0, 3], torch.zeros(3))
    assert torch.equal(got[1, 0], vals[1, 2])
    sc = G.scatter_add_rows_ref(torch.ones(2, 4, 3), idx, 4)
    assert sc[0].sum() == 6 and sc[1, 2].tolist() == [2.0, 2.0, 2.0]


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


# ---------------------------------------------------------------------------
# kernels 2, 4, 5, 6 on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize('B,Q,F', [(1, 130, 300), (3, 7, 1000),
                                   (2, 600, 129)])
def test_winding_kernel_matches_plain_version_on_card(cuda_device, B, Q, F):
    """Ragged query and triangle tiles, one and several splits; atol 2e-5
    (float32 summation order); self-winding exact at triangle corners."""
    verts, faces = _body(B=B, V=max(Q, 8), F=F, device=cuda_device)
    pts = verts[:, :Q].contiguous()
    tris = verts[:, faces]
    before = CK.winding_numbers_tris_cuda.launches
    got = CK.winding_numbers_tris(pts, tris)
    torch.cuda.synchronize()
    assert CK.winding_numbers_tris_cuda.launches == before + 1
    want = PC.winding_numbers(pts, tris)
    assert got.shape == (B, Q)
    assert (got - want).abs().max().item() <= 2e-5
    # padding triangles with three equal corners add exactly 0
    far = torch.full((B, 5, 3, 3), 1e7, device=cuda_device)
    padded = CK.winding_numbers_tris(pts, torch.cat([tris, far], 1))
    assert (padded - got).abs().max().item() <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize('B,V', [(1, 300), (3, 1000)])
def test_masked_min_kernel_matches_plain_version_on_card(cuda_device, B, V):
    """d2 at rtol 1e-6; another argmin only at a tie of the plain d2
    within 1e-6 relative; inf and 0 for a row with no allowed pair."""
    verts, _ = _body(B=B, V=V, F=3, device=cuda_device)
    rng = np.random.RandomState(2)
    allowed = rng.rand(V, V) > 0.3
    allowed[5] = False
    mask_t = torch.from_numpy(np.ascontiguousarray(
        allowed.T.astype(np.uint8))).to(cuda_device)
    mask = mask_t.t()                   # the stored layout: no copy
    before = CK.masked_min_dist_cuda.launches
    d2, arg = CK.masked_min_dist(verts, mask)
    torch.cuda.synchronize()
    assert CK.masked_min_dist_cuda.launches == before + 1
    want_d2, want_arg = PC.masked_min_dist(verts, mask.bool())
    assert arg.dtype == torch.int32
    fin = torch.isfinite(want_d2)
    assert torch.equal(fin, torch.isfinite(d2))
    assert ((d2[fin] - want_d2[fin]).abs()
            <= 1e-6 * want_d2[fin].abs() + 1e-30).all()
    assert (d2[:, 5] == float('inf')).all() and (arg[:, 5] == 0).all()
    full = ((verts[:, :, None] - verts[:, None]) ** 2).sum(-1)
    pick = full.gather(2, arg.long()[..., None])[..., 0]
    ref = full.gather(2, want_arg.long()[..., None])[..., 0]
    differ = (arg != want_arg) & fin
    assert ((pick - ref).abs()[differ] <= 1e-6 * ref[differ]).all()
    # a contiguous mask is transposed inside the wrapper: same answer
    d2c, argc = CK.masked_min_dist(verts, mask.contiguous())
    assert torch.equal(d2c, d2) and torch.equal(argc, arg)


@pytest.mark.cuda
def test_gather_and_scatter_kernels_match_plain_versions_on_card(
        cuda_device):
    """Gather bitwise (with -1 and V indices: zero rows); scatter at rtol
    1e-5 against index_add_ (atomics add in varying order)."""
    rng = np.random.RandomState(3)
    B, V, Q = 3, 300, 1029
    vals = torch.from_numpy(rng.randn(B, V, 3).astype(np.float32)).to(
        cuda_device)
    idx = rng.randint(0, 40, (B, Q)).astype(np.int32)
    idx[0, :3] = -1
    idx[1, :2] = V
    idx = torch.from_numpy(idx).to(cuda_device)
    before = _launches()
    got = G.gather(vals, idx)
    contrib = torch.from_numpy(rng.randn(B, Q, 3).astype(np.float32)).to(
        cuda_device)
    sc = G.scatter_add(contrib, idx, V)
    torch.cuda.synchronize()
    assert _launches()[2:] == (before[2] + 1, before[3] + 1)
    assert torch.equal(got, G.gather_rows_ref(vals, idx))
    want = G.scatter_add_rows_ref(contrib, idx, V)
    assert ((sc - want).abs() <= 1e-5 * want.abs() + 1e-6).all()
    assert (sc[:, 40:] == 0).all()
    v = vals.clone().requires_grad_(True)
    G.gather_rows(v, idx).backward(contrib)
    assert ((v.grad - want).abs() <= 1e-5 * want.abs() + 1e-6).all()
