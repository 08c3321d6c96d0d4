"""The kernels' wrappers, builds and launch counts (torch only).

Attention (kernel 1), winding numbers (2), the masked nearest vertex (4),
row gather (5) and row scatter-add (6), and the experimental winding
routes: affine-form winding (3) and the hierarchical near field (7). This
file imports no JAX, so it
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
from tuch_tpu_torch.ops import winding_hier as PH

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (B, N, C, heads): vit_s16 at 224 (unaligned N), an aligned toy shape, an
# odd N whose last query and key tiles are ragged, and vit_t8 at 64; then
# N on both sides of the kernel's tile edges (16 query rows per warp, 64
# per block, key tiles of 32 or 64) at head dims 64 and 32
EDGE_N = (1, 15, 16, 17, 64, 196, 197, 300)
SHAPES = [(2, 196, 384, 6), (3, 128, 64, 2), (2, 197, 384, 6),
          (4, 64, 64, 2)] + [(2, n, c, 2) for n in EDGE_N for c in (128, 64)]


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
            'tuch_tpu_torch.ops.segments, tuch_tpu_torch.ops.winding_hier, '
            'tuch_tpu_torch.ops._build as b; '
            'assert shutil.which("nvcc") is None; print(b.sources())')
    out = subprocess.run([sys.executable, '-c', code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for name in ('mha', 'winding', 'masked_min', 'gather', 'winding_affine',
                 'winding_near'):
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


def test_winding_route_wrappers_refuse_cpu_tensors():
    sel = torch.zeros((2, 1, 1), dtype=torch.int32)
    calls = [
        lambda: CK.winding_numbers_affine_cuda(torch.zeros(2, 4, 10),
                                               torch.zeros(2, 28, 7)),
        lambda: PH.near_field_cuda(sel, torch.zeros(2, 3, 8),
                                   torch.zeros(2, 1, 9, 4)),
    ]
    for call in calls:
        with pytest.raises(ValueError, match='CUDA'):
            call()


def test_split_covers_the_axis_in_whole_tiles():
    for base, n, tile in [(1, 13776, 128), (54, 13776, 128),
                          (3456, 13776, 128), (18, 492, 128),
                          (54, 6890, 256), (1, 100, 256)]:
        chunk, splits = CK._split(base, n, tile)
        assert chunk % tile == 0 and splits >= 1
        assert chunk * splits >= n > chunk * (splits - 1)
        assert base * splits <= max(base, CK.TARGET_BLOCKS + base)


@pytest.mark.parametrize('V,Q', [(6890, 6890), (2049, 1029), (300, 3000),
                                 (5, 37), (1, 1)])
@pytest.mark.parametrize('B', [1, 4, 64, 200])
def test_scatter_plan_covers_the_rows_in_whole_slices_and_fills_the_sms(
        B, V, Q):
    """Kernel 6's plan: C blocks per batch item cover [0, V) in slices of S
    rows and [0, Q) in runs of P contributions, no block past the last; as
    many blocks as fill the SMs once, as far as clusters of at most 8 go."""
    C, S, P = G.scatter_plan(B, V, Q)
    assert 1 <= C <= G.MAX_CLUSTER
    assert S * C >= V > S * (C - 1) and P * C >= Q
    assert B * C <= max(B, G.SCATTER_BLOCKS)       # one wave
    assert B * C >= min(G.SCATTER_BLOCKS // 2, B * G.MAX_CLUSTER, B * V)
    if B <= 4 and V >= G.MAX_CLUSTER:
        assert C == G.MAX_CLUSTER     # small batches: the largest cluster


@pytest.mark.parametrize('B,Q,V,ok', [
    (64, 6890, 6890, True),
    (1, (2 ** 31 - 1) // 3, 1, True),
    (1, (2 ** 31 - 1) // 3 + 1, 1, False),      # 3 B Q reaches 2^31
    (2 ** 16 - 1, 2 ** 15, 7, False),
    (2, 3, 2 ** 30, False),                     # 3 B V reaches 2^31
    (2 ** 16, 1, 1, False),                     # the batch is blockIdx.y
])
def test_scatter_size_check_refuses_what_32_bit_indexing_cannot_address(
        B, Q, V, ok):
    if ok:
        G.check_sizes(B, Q, V, 'scatter')
    else:
        with pytest.raises(ValueError, match='too large'):
            G.check_sizes(B, Q, V, 'scatter')


class _NoLock:
    def __enter__(self):
        raise AssertionError('the lock was taken')

    def __exit__(self, *exc):
        return False


def test_build_load_returns_a_loaded_library_without_the_lock(monkeypatch):
    from tuch_tpu_torch.ops import _build
    lib = object()
    monkeypatch.setattr(_build, '_libs', {'gather': lib})
    monkeypatch.setattr(_build, '_lock', _NoLock())
    assert _build.load('gather') is lib


def test_build_entry_resolves_a_symbol_once(monkeypatch):
    import ctypes
    from types import SimpleNamespace
    from tuch_tpu_torch.ops import _build
    fn = SimpleNamespace(argtypes=None, restype=None)
    lib = SimpleNamespace(tuch_gather_rows=fn)
    monkeypatch.setattr(_build, '_libs', {'gather': lib})
    monkeypatch.setattr(_build, '_entries', {})
    monkeypatch.setattr(_build, '_lock', _NoLock())
    args = [ctypes.c_void_p, ctypes.c_int]
    assert _build.entry('gather', 'tuch_gather_rows', args) == (lib, fn)
    assert fn.argtypes == args and fn.restype is ctypes.c_int

    def no_load(name):
        raise AssertionError('resolved twice')
    monkeypatch.setattr(_build, 'load', no_load)
    assert _build.entry('gather', 'tuch_gather_rows', args) == (lib, fn)


def _atan_coefficients():
    """P's coefficients in csrc/winding.cu, from the highest term down."""
    import re
    src = open(os.path.join(REPO, 'tuch_tpu_torch', 'csrc',
                            'winding.cu')).read()
    body = src[src.index('float atan2_poly'):src.index('float r = p * t;')]
    first = re.search(r'float p = ([-+0-9.e]+)f;', body).group(1)
    rest = re.findall(r'p = fmaf\(p, s, ([-+0-9.e]+)f\);', body)
    return np.array([first] + rest, np.float64).astype(np.float32)


def _atan2_poly(y, x):
    """csrc/winding.cu atan2_poly in float32 (exact reciprocal; FMA in
    float64, rounded once)."""
    y, x = np.float32(y), np.float32(x)
    ax, ay = np.abs(x), np.abs(y)
    t = np.float32(np.minimum(ax, ay) / np.maximum(np.maximum(ax, ay),
                                                   np.float32(1e-30)))
    s = np.float32(t * t)
    coef = _atan_coefficients()
    p = coef[0]
    for c in coef[1:]:
        p = np.float32(np.float64(p) * np.float64(s) + np.float64(c))
    r = np.float32(p * t)
    r = np.where(ay > ax, np.float32(np.pi / 2) - r, r)
    r = np.where(np.signbit(x), np.float32(np.pi) - r, r)
    return np.copysign(r, y).astype(np.float32)


def test_winding_atan_polynomial_is_minimax_to_1_5e_7_relative():
    coef = _atan_coefficients()
    assert len(coef) == 9 and coef[-1] == 1.0     # P(0) = 1: no bias at 0
    t = np.linspace(0, 1, 200001)[1:].astype(np.float32)
    got = _atan2_poly(t, np.ones_like(t))
    want = np.arctan(t.astype(np.float64))
    assert (np.abs(got - want) / want).max() <= 1.5e-7


def test_winding_atan2_polynomial_keeps_ieee_signs_and_zeros():
    """The cases that decide a face's contribution at a corner or a
    degenerate face are IEEE's exactly; elsewhere within 4e-7 of atan2."""
    for y in (0.0, -0.0):
        for x in (0.0, -0.0, 2.5, -2.5):
            got, want = _atan2_poly(y, x), np.arctan2(np.float32(y),
                                                      np.float32(x))
            assert got == want and np.signbit(got) == np.signbit(want)
    rng = np.random.RandomState(5)
    y = (rng.randn(20000) * 10.0 ** rng.uniform(-6, 3, 20000)).astype(
        np.float32)
    x = (rng.randn(20000) * 10.0 ** rng.uniform(-6, 3, 20000)).astype(
        np.float32)
    err = np.abs(_atan2_poly(y, x) - np.arctan2(y.astype(np.float64),
                                                x.astype(np.float64)))
    assert err.max() <= 4e-7


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


@pytest.mark.cuda
def test_mha_cuda_rejects_a_misaligned_tensor_on_card(cuda_device):
    flat = _qkv(1, 9, 64, device=cuda_device).reshape(-1)
    with pytest.raises(ValueError, match='16-byte aligned'):
        A.mha_cuda(flat[1:1 + 8 * 192].view(1, 8, 192), 2)


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


def _row_case(kind, B, V, Q, rng):
    if kind == 'out_of_range':
        return rng.choice(np.array([-1, V, -7, V + 3, 2 ** 31 - 1, -2 ** 31],
                                   np.int64), (B, Q)).astype(np.int32)
    if kind == 'one_row':
        return np.full((B, Q), V // 2, np.int32)
    idx = rng.randint(-2, V + 2, (B, Q)).astype(np.int32)
    idx[:, :2] = [0, V - 1]     # the rows whose 16-byte word another item's
    return idx                  # rows share: the narrow reductions


@pytest.mark.cuda
@pytest.mark.parametrize('kind,B,V,Q', [
    ('q_not_a_multiple_of_4', 3, 300, 1029),
    ('batch_of_one', 1, 6890, 6890),
    ('v_below_one_slice', 2, 5, 37),                 # one row a block
    ('v_not_a_multiple_of_the_slice', 4, 1001, 900),
    ('q_below_the_cluster', 3, 40, 5),               # blocks with no q
    ('large_batch_one_block_per_item', 200, 64, 100),
    ('out_of_range', 2, 50, 70),
    ('one_row', 2, 300, 3000),
    ('tile_across_a_batch_boundary', 5, 257, 258),
])
def test_gather_and_scatter_kernels_edge_cases_on_card(cuda_device, kind, B,
                                                       V, Q):
    """Gather bitwise equal to the plain version, scatter at rtol 1e-5
    (+1e-6) against index_add_, one launch each, at the shapes where the
    kernels' tiles, slices and 16-byte stores have edges: spans that start
    or end off a 16-byte boundary, a ragged last tile or slice, every index
    out of range, every index on one row."""
    rng = np.random.RandomState(B * 100003 + V * 7 + Q)
    idx = torch.from_numpy(_row_case(kind, B, V, Q, rng)).to(cuda_device)
    vals = torch.from_numpy(rng.randn(B, V, 3).astype(np.float32)).to(
        cuda_device)
    # multiples of 2^-10 below 2 in magnitude: every row's sum (at most
    # 6890 terms) is exact in fp32 in any order of the additions, so the
    # atomics' order cannot decide the comparison
    contrib = torch.from_numpy((rng.randint(-2047, 2048, (B, Q, 3))
                                / 1024.0).astype(np.float32)).to(cuda_device)
    before = _launches()
    got = G.gather_rows_cuda(vals, idx)
    sc = G.scatter_add_rows_cuda(contrib, idx, V)
    torch.cuda.synchronize()
    assert _launches()[2:] == (before[2] + 1, before[3] + 1)
    assert torch.equal(got, G.gather_rows_ref(vals, idx))
    want = G.scatter_add_rows_ref(contrib, idx, V)
    assert sc.shape == (B, V, 3)
    assert ((sc - want).abs() <= 1e-5 * want.abs() + 1e-6).all()


@pytest.mark.cuda
def test_scatter_kernel_is_one_kernel_and_no_memset_on_card(cuda_device):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.RandomState(4)
    idx = torch.from_numpy(rng.randint(0, 6890, (64, 6890)).astype(
        np.int32)).to(cuda_device)
    contrib = torch.randn(64, 6890, 3, device=cuda_device)
    G.scatter_add_rows_cuda(contrib, idx, 6890)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        G.scatter_add_rows_cuda(contrib, idx, 6890)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    assert len(names) == 1 and 'scatter_add_rows' in names[0], names


# ---------------------------------------------------------------------------
# kernels 3 and 7 (the experimental winding routes) on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize('B,Q,F', [(1, 130, 300), (3, 7, 1000),
                                   (3, 600, 129)])
def test_affine_kernel_matches_plain_version_on_card(cuda_device, B, Q, F):
    """Ragged query and triangle tiles, one and several splits, queries on
    triangle corners (the first Q vertices): atol 2e-5 (float32 summation
    order; la2, lb2, lc2 and so the corner mask are the same bits on both),
    equal in/out decisions."""
    verts, faces = _body(B=B, V=max(Q, 8), F=F, device=cuda_device)
    pts = verts[:, :Q].contiguous()
    before = CK.winding_numbers_affine_cuda.launches
    got = CK.winding_numbers_affine(pts, verts, faces)
    torch.cuda.synchronize()
    assert CK.winding_numbers_affine_cuda.launches == before + 1
    want = CK.winding_numbers_affine_ref(
        CK.affine_points(pts), CK.affine_triangle_constants(verts[:, faces]))
    assert got.shape == (B, Q)
    assert (got - want).abs().max().item() <= 2e-5
    assert torch.equal(got <= 0.99, want <= 0.99)


def _near_problem(B, TQ, C, device, T=3, K=5, M=7):
    """Small triangles (corners 0.1 around unit-normal centres), sel with
    repeated and out-of-order clusters (M > K), points on the corners of
    cluster 0's first triangles, and cluster K-1 made of
    degenerate faces only (one vertex three times, as the padding of
    build_winding_clusters), which tile 1 of item 0 selects alone and whose
    first point sits on one of those vertices."""
    rng = np.random.RandomState(6)
    pts = rng.randn(B, 3, T * TQ).astype(np.float32)
    tris = (np.tile(rng.randn(B, K, 3, C), (1, 1, 3, 1))
            + 0.1 * rng.randn(B, K, 9, C)).astype(np.float32)
    pts[:, :, :10] = tris[:, 0, 0:3, :10]
    tris[:, K - 1] = np.tile(tris[:, K - 1, 0:3], (1, 3, 1))
    pts[:, :, TQ] = tris[:, K - 1, 0:3, 0]
    sel = rng.randint(0, K, (B, T, M)).astype(np.int32)
    sel[0, 0] = [4, 4, 0, 2, 4, 1, 0]
    sel[0, 1] = K - 1
    return [torch.from_numpy(x).to(device) for x in (sel, pts, tris)]


@pytest.mark.cuda
@pytest.mark.parametrize('B,TQ,C', [(1, 512, 256), (3, 200, 300)])
def test_near_kernel_matches_plain_version_on_card(cuda_device, B, TQ, C):
    """Kernel 7 against near_field_ref: a ragged point block (TQ = 200), a
    ragged triangle stage (C = 300), the m axis split over the grid; atol
    2e-5 in winding-number units (the sum over 4 pi), as kernel 2; the
    degenerate faces add exactly 0."""
    sel, pts, tris = _near_problem(B, TQ, C, cuda_device)
    before = PH.near_field_cuda.launches
    got = PH.near_field(sel, pts, tris)
    torch.cuda.synchronize()
    assert PH.near_field_cuda.launches == before + 1
    want = PH.near_field_ref(sel, pts, tris)
    assert got.shape == (B, pts.shape[2])
    assert (got - want).abs().max().item() * PC.INV_4PI <= 2e-5
    assert (got[0, TQ:2 * TQ] == 0).all()


@pytest.mark.cuda
def test_hier_route_on_card_matches_cpu(cuda_device):
    """The whole hierarchical route, card against CPU, on the 994-vertex
    synthetic body with M = 4 < K = 31: atol 1e-4."""
    from tuch_tpu_torch import assets
    model, _ = assets.synthetic_smpl(num_verts=1000)
    rng = np.random.RandomState(0)
    v0 = model.v_template
    verts = torch.from_numpy((v0[None] * np.array([1.0, 0.6, 1.0])
                              + 0.02 * rng.randn(2, *v0.shape))
                             .astype(np.float32))
    cl = {dev: PH.build_winding_clusters(v0, model.faces, cluster_size=64,
                                         tile_q=128, device=dev)
          for dev in ('cpu', cuda_device)}
    before = PH.near_field_cuda.launches
    got = PH.winding_numbers_hier(verts.to(cuda_device), cl[cuda_device], 4)
    torch.cuda.synchronize()
    assert PH.near_field_cuda.launches == before + 1
    want = PH.winding_numbers_hier(verts, cl['cpu'], 4)
    assert (got.cpu() - want).abs().max().item() <= 1e-4
