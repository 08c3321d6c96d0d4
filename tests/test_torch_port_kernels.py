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
# per block, key tiles of 32 or 64) at head dims 64 and 32; then head dim
# 80 at ViTPose-H's width (16 heads of 80; HMR 2.0's N is 192)
EDGE_N = (1, 15, 16, 17, 64, 196, 197, 300)
SHAPES = [(2, 196, 384, 6), (3, 128, 64, 2), (2, 197, 384, 6),
          (4, 64, 64, 2)] + [(2, n, c, 2) for n in EDGE_N for c in (128, 64)]
SHAPES += [(B, n, 1280, 16) for B in (1, 4) for n in (1, 63, 192, 197)]


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
                                               torch.zeros(2, 7, 28)),
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


@pytest.mark.parametrize('B,V,Q,split', [
    (64, 6890, 6890, 2),         # the training batch: 128 CTAs, one an SM
    (200, 6890, 6890, 1),        # more items than SMs
    (8, 6890, 6890, 16),
    (4, 6890, 6890, 32),         # the demo's fit: MAX_SPLIT CTAs an item
    (1, 6890, 6890, 32),         # an EFT step
    (64, 10475, 10475, 4),       # SMPL-X's mesh: shared memory sets 4
    (3, 300, 1029, 32),
    (2, 5, 37, 5),               # no more CTAs than rows
    (1, 1, 1, 1),
    (70000, 1, 1, 1),
])
def test_scatter_plan_fills_the_card_within_shared_memory(B, V, Q, split):
    """Kernel 6 runs `split` CTAs per batch item, one an SM: as many as
    fill the 132 SMs, more where a CTA's shared memory (20 Q + 8 rows + 132
    bytes, rows = ceil(V / split)) needs them, at most MAX_SPLIT and V;
    fewer would not fit."""
    assert G.scatter_plan(B, V, Q) == split
    rows = -(-V // split)
    assert G.scatter_shared_bytes(V, Q, split) == 20 * Q + 8 * rows + 132
    assert G.scatter_shared_bytes(V, Q, split) <= G.MAX_SHARED
    if split > max(1, G.H100_SMS // B):
        assert G.scatter_shared_bytes(V, Q, split - 1) > G.MAX_SHARED
    assert split <= min(G.MAX_SPLIT, V)


@pytest.mark.parametrize('B,V,Q,most', [
    (1, 1, 11615, None), (1, 1, 11616, 11615),
    (64, 6890, 11529, None), (64, 6890, 11530, 11529),
])
def test_scatter_plan_refuses_what_shared_memory_cannot_hold(B, V, Q, most):
    """Every CTA holds its item's whole index row and room for all of its
    contributions, so Q is bounded at any split; the refusal names the
    largest Q the plan holds at that V."""
    if most is None:
        G.scatter_plan(B, V, Q)
    else:
        with pytest.raises(ValueError, match=f'shared memory.*Q <= {most}'):
            G.scatter_plan(B, V, Q)


def test_scatter_plan_constants_are_the_kernels():
    assert _constexpr('gather.cu', 'MAX_SPLIT') == G.MAX_SPLIT
    assert _constexpr('gather.cu', 'MAX_SHARED') == G.MAX_SHARED


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


def _constexpr(source, name):
    """The value of `constexpr int name = value;` in csrc/<source>."""
    import re
    return int(re.search(rf'constexpr int {name} = (\d+);',
                         _csrc(source)).group(1))


@pytest.mark.parametrize('B', [1, 4, 8, 64, 200])
@pytest.mark.parametrize('Q,F', [(6890, 13776), (1, 300), (511, 1000),
                                 (513, 129), (7168, 128)])
def test_affine_plan_covers_the_triangles_in_whole_tiles(B, Q, F):
    """Kernel 3's split, planned from the shape csrc/winding_affine.cu
    reports (threads, queries per thread, triangles per tile): whole tiles
    that cover the axis, no empty split, no more blocks than the target
    asks once the query blocks alone fall short of it."""
    shape = (_constexpr('winding_affine.cu', 'TQ'),
             _constexpr('winding_affine.cu', 'QPT'),
             _constexpr('winding_affine.cu', 'TF'))
    chunk, splits = CK.affine_plan(B, Q, F, shape)
    base = B * -(-Q // (shape[0] * shape[1]))
    assert chunk % shape[2] == 0 and splits >= 1
    assert chunk * splits >= F > chunk * (splits - 1)
    assert base * splits <= max(base, CK.TARGET_BLOCKS + base)
    if base >= CK.TARGET_BLOCKS:
        assert splits == 1


@pytest.mark.parametrize('B', [1, 4, 64])
@pytest.mark.parametrize('T,TQ,M', [(14, 512, 16), (3, 200, 7), (2, 513, 5),
                                    (1, 1, 1)])
def test_near_plan_covers_the_clusters(B, T, TQ, M):
    """Kernel 7's split of the selected clusters, planned from the shape
    csrc/winding_near.cu reports: every m in exactly one split, and a whole
    tile of TQ = 512 points in one block."""
    shape = (_constexpr('winding_near.cu', 'NT'),
             _constexpr('winding_near.cu', 'QPT'),
             _constexpr('winding_near.cu', 'CT'))
    assert shape[0] * shape[1] == 512
    mchunk, splits = PH.near_plan(B, T, TQ, M, shape)
    assert mchunk >= 1 and mchunk * splits >= M > mchunk * (splits - 1)
    base = B * T * -(-TQ // (shape[0] * shape[1]))
    assert base * splits <= max(base, CK.TARGET_BLOCKS + base)


def test_route_wrappers_read_their_shape_from_the_library(monkeypatch):
    """affine_shape and near_shape ask the built library
    (tuch_<name>_shape), so the plans follow the kernels' constants."""
    from tuch_tpu_torch.ops import _build

    def fake(values):
        def fn(out):
            for i, v in enumerate(values):
                out[i] = v
            return 0
        return fn
    monkeypatch.setattr(_build, '_entries', {
        ('winding_affine', 'tuch_winding_affine_shape'):
            (None, fake((64, 8, 32))),
        ('winding_near', 'tuch_winding_near_shape'):
            (None, fake((96, 2, 128)))})
    assert CK.affine_shape() == (64, 8, 32)
    assert PH.near_shape() == (96, 2, 128)
    assert CK.affine_plan(1, 6890, 13776, CK.affine_shape())[0] % 32 == 0


def test_affine_constant_rows_are_the_plain_layout_transposed():
    verts, faces = _body()
    tris = verts[:, faces]
    rows = CK.affine_constant_rows(tris)
    assert rows.shape == (2, 296, 28) and rows.is_contiguous()
    assert torch.equal(rows.transpose(1, 2),
                       CK.affine_triangle_constants(tris))


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


def _csrc(name):
    with open(os.path.join(REPO, 'tuch_tpu_torch', 'csrc', name)) as f:
        return f.read()


def _atan_coefficients():
    """P's coefficients in csrc/solid_angle.cuh, from the highest term
    down."""
    import re
    src = _csrc('solid_angle.cuh')
    body = src[src.index('float atan2_poly'):src.index('float r = p * t;')]
    first = re.search(r'float p = ([-+0-9.e]+)f;', body).group(1)
    rest = re.findall(r'p = fmaf\(p, s, ([-+0-9.e]+)f\);', body)
    return np.array([first] + rest, np.float64).astype(np.float32)


def _atan2_poly(y, x):
    """csrc/solid_angle.cuh atan2_poly in float32 (exact reciprocal; FMA in
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


@pytest.mark.parametrize('source', ['winding.cu', 'winding_affine.cu',
                                    'winding_near.cu'])
def test_winding_sources_define_no_atan2_of_their_own(source):
    """One copy of the polynomial atan2 and of the pair: the three winding
    kernels take them from solid_angle.cuh and call no IEEE atan2f."""
    import re
    src = _csrc(source)
    assert '#include "solid_angle.cuh"' in src
    assert not re.search(r'float\s+(atan2\w*|half_angle|solid_angle)\s*\(',
                         src)
    assert 'atan2f(' not in src
    assert ('tuch::half_angle(' in src) != ('tuch::atan2_poly(' in src)


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


def _unpack_bits(words, V):
    """pack_mask_bits inverted: (Q, W) int32 -> (Q, 32 W) bool, all bits."""
    byts = words.contiguous().view(torch.uint8)           # (Q, 4 W)
    shifts = torch.arange(8, dtype=torch.uint8)
    return ((byts[..., None] >> shifts) & 1).reshape(words.shape[0], -1) \
        .bool()


@pytest.mark.parametrize('V', [1, 31, 33, 170, 6890])
def test_mask_bits_round_trip_and_ban_the_padding(V):
    rng = np.random.RandomState(V)
    allowed = rng.rand(V, V) > 0.4
    stored = torch.from_numpy(allowed.astype(np.uint8))   # the assets'
    words = CK.pack_mask_bits(stored)
    W = -(-V // 32)
    assert words.dtype == torch.int32 and words.shape == (V, W)
    assert words.is_contiguous()
    bits = _unpack_bits(words, V)
    assert torch.equal(bits[:, :V], torch.from_numpy(allowed))
    assert not bits[:, V:].any()                  # padding bits: banned
    # a bool mask and a transposed view pack to the same words
    assert torch.equal(CK.pack_mask_bits(torch.from_numpy(allowed)), words)
    transposed = torch.from_numpy(np.ascontiguousarray(
        allowed.T.astype(np.uint8))).t()
    assert torch.equal(CK.pack_mask_bits(transposed), words)


def test_contact_assets_carry_the_packed_mask():
    from tuch_tpu_torch.models.convert import contact_assets_from_numpy
    rng = np.random.RandomState(9)
    V = 70
    geo = rng.rand(V, V) > 0.5
    z = np.zeros((1, 2), np.int64)
    ca = contact_assets_from_numpy({
        'geomask': geo, 'faces': np.zeros((3, 3), np.int64),
        'region_idx_a': z, 'region_idx_b': z, 'region_mask_a': z > 0,
        'region_mask_b': z > 0})
    assert torch.equal(ca.geomask_bits, CK.pack_mask_bits(ca.geomask))
    assert torch.equal(_unpack_bits(ca.geomask_bits, V)[:, :V],
                       torch.from_numpy(geo))
    moved = ca.to('cpu')
    assert torch.equal(moved.geomask_bits, ca.geomask_bits)
    assert moved.geomask.dtype == torch.uint8
    # on the CPU the dispatcher reads the mask (plain version), no launch
    verts, _ = _body(B=2, V=V)
    before = _launches()
    d2, arg = CK.masked_min_dist(verts, ca.geomask, ca.geomask_bits)
    want_d2, want_arg = PC.masked_min_dist(verts, ca.geomask.bool())
    assert torch.equal(d2, want_d2) and torch.equal(arg, want_arg)
    assert _launches() == before


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
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize('shape', [(2, 196, 384, 6), (3, 17, 64, 2),
                                   (1, 192, 1280, 16)])
def test_mha_gradient_through_the_kernel_on_card(cuda_device, shape, dtype,
                                                 tol):
    """fused_mha with a gradient: kernel 1 forward (one launch), the
    backward mha_reference's gradient recomputed on the saved qkv, so equal
    to it up to the library's own rounding (rtol 1e-5 fp32, one bf16 step
    in bf16)."""
    B, N, C, heads = shape
    x = _qkv(B, N, C, dtype, cuda_device).requires_grad_(True)
    g = torch.from_numpy(np.random.RandomState(1).randn(B, N, C).astype(
        np.float32)).to(cuda_device, dtype)
    before = A.mha_cuda.launches
    out = A.fused_mha(x, heads)
    assert A.mha_cuda.launches == before + 1 and out.grad_fn is not None
    out.backward(g)
    ref_x = x.detach().clone().requires_grad_(True)
    ref = A.mha_reference(ref_x, heads)
    ref.backward(g)
    torch.cuda.synchronize()
    assert A.mha_cuda.launches == before + 1      # no kernel in the backward
    assert (out.float() - ref.float()).abs().max().item() <= tol
    scale = ref_x.grad.float().abs().max().item()
    rtol = 1e-5 if dtype == torch.float32 else 2 ** -7
    assert x.grad.dtype == dtype
    assert (x.grad.float() - ref_x.grad.float()).abs().max().item() \
        <= rtol * scale


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
    mask = mask_t.t()                   # a transposed view
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
    # a contiguous mask packs to the same bits: same answer
    d2c, argc = CK.masked_min_dist(verts, mask.contiguous())
    assert torch.equal(d2c, d2) and torch.equal(argc, arg)


def test_masked_min_keys_cpu_dispatch_and_refusal():
    """The range entry's dispatch takes the plain keys on the CPU without
    counting a launch; its wrapper refuses a CPU tensor and a range that
    does not start and end on mask words."""
    verts, _ = _body(B=2, V=100, F=3)
    mask = (torch.rand(100, 100, generator=torch.Generator().manual_seed(0))
            > 0.3).to(torch.uint8)
    before = CK.masked_min_keys_cuda.launches
    keys = CK.masked_min_keys(verts, mask, None, 32, 100)
    assert CK.masked_min_keys_cuda.launches == before
    assert torch.equal(keys, CK.masked_min_keys_ref(verts, mask, 32, 100))
    bits = CK.pack_mask_bits(mask)
    with pytest.raises(ValueError, match='CUDA'):
        CK.masked_min_keys_cuda(verts, mask, bits, 0, 100)


@pytest.mark.cuda
@pytest.mark.parametrize('B,V,cuts', [
    (1, 300, (0, 128, 300)), (3, 1000, (0, 256, 512, 768, 1000)),
    (2, 6890, (0, 3456, 6890)), (2, 6890, (0, 1728, 3456, 5184, 6890))])
def test_masked_min_range_entry_matches_plain_keys_on_card(cuda_device, B,
                                                           V, cuts):
    """Kernel 4's range entry over ranges that cover the axis: one launch
    each; the MIN of their keys decodes to the whole-axis kernel's answer
    bit for bit (the same arithmetic), and to the plain version at kernel
    4's bars (_hold_masked_min); an empty range is all EMPTY_KEY."""
    verts, _ = _body(B=B, V=V, F=3, device=cuda_device)
    rng = np.random.RandomState(3)
    allowed = rng.rand(V, V) > 0.3
    allowed[5] = False
    mask = torch.from_numpy(allowed.astype(np.uint8)).to(cuda_device)
    bits = CK.pack_mask_bits(mask)
    before = CK.masked_min_keys_cuda.launches
    keys = [CK.masked_min_keys(verts, mask, bits, a, b)
            for a, b in zip(cuts, cuts[1:])]
    torch.cuda.synchronize()
    assert CK.masked_min_keys_cuda.launches == before + len(keys)
    d2, arg = CK.decode_keys(torch.stack(keys).amin(0))
    whole = CK.masked_min_dist(verts, mask, bits)
    assert torch.equal(d2, whole[0]) and torch.equal(arg, whole[1])
    _hold_masked_min(verts, mask, d2, arg)
    empty = CK.masked_min_keys(verts, mask, bits, V, V)
    assert (empty == CK.EMPTY_KEY).all()


def _hold_masked_min(verts, mask, d2, arg):
    """Kernel 4's bars against the plain version (chip_smoke.py phase 7):
    d2 at rtol 1e-6, another argmin only at a tie of the plain d2 within
    1e-6 relative, every pick allowed, inf and 0 where all are banned."""
    want_d2, want_arg = PC.masked_min_dist(verts, mask.bool())
    assert d2.shape == arg.shape == want_d2.shape and arg.dtype == torch.int32
    fin = torch.isfinite(want_d2)
    assert torch.equal(fin, torch.isfinite(d2))
    assert (d2[~fin] == float('inf')).all() and (arg[~fin] == 0).all()
    assert ((d2 - want_d2).abs()[fin] <= 1e-6 * want_d2[fin]).all()
    diff = verts - torch.gather(verts, 1,
                                arg.long()[..., None].expand(-1, -1, 3))
    pick = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] \
        + diff[..., 2] * diff[..., 2]
    differ = (arg != want_arg) & fin
    assert ((pick - want_d2).abs()[differ] <= 1e-6 * want_d2[differ]).all()
    rows = torch.arange(verts.shape[1], device=verts.device)
    assert (mask[rows[None].expand_as(arg), arg.long()] > 0)[fin].all()


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['asymmetric_with_a_banned_row',
                                  'all_allowed'])
@pytest.mark.parametrize('V', [31, 33, 170, 6890])
@pytest.mark.parametrize('B', [1, 3, 8])
def test_masked_min_bits_kernel_matches_plain_version_on_card(
        cuda_device, B, V, kind):
    """B not a multiple of the bodies per block, V around a mask word and
    at the body's size; the mask as stored bits and packed by the call:
    the same answer, one launch each."""
    verts, _ = _body(B=B, V=V, F=3, seed=B * 7 + V, device=cuda_device)
    rng = np.random.RandomState(V)
    allowed = np.ones((V, V), bool)
    if kind != 'all_allowed':
        allowed = rng.rand(V, V) > 0.3
        allowed[V // 2] = False
        assert (allowed != allowed.T).any()
    mask = torch.from_numpy(allowed.astype(np.uint8)).to(cuda_device)
    bits = CK.pack_mask_bits(mask)
    before = CK.masked_min_dist_cuda.launches
    d2, arg = CK.masked_min_dist(verts, mask, bits)
    torch.cuda.synchronize()
    assert CK.masked_min_dist_cuda.launches == before + 1
    _hold_masked_min(verts, mask, d2, arg)
    if kind != 'all_allowed':
        assert (d2[:, V // 2] == float('inf')).all()
    d2p, argp = CK.masked_min_dist_cuda(verts, mask)     # packs first
    torch.cuda.synchronize()
    assert CK.masked_min_dist_cuda.launches == before + 2
    assert torch.equal(d2p, d2) and torch.equal(argp, arg)


@pytest.mark.cuda
def test_masked_min_wrapper_refuses_a_bad_packing_on_card(cuda_device):
    verts, _ = _body(B=2, V=70, F=3, device=cuda_device)
    mask = torch.ones((70, 70), dtype=torch.uint8, device=cuda_device)
    bits = CK.pack_mask_bits(mask)
    for bad in (bits.long(), bits[:, :2], bits.t().contiguous()[:70, :3],
                bits.cpu(), torch.cat([bits, bits], 1)[:, ::2]):
        with pytest.raises(ValueError, match='bits'):
            CK.masked_min_dist_cuda(verts, mask, bad)


@pytest.mark.cuda
def test_gather_and_scatter_kernels_match_plain_versions_on_card(
        cuda_device):
    """Gather bitwise (with -1 and V indices: zero rows); scatter bit for
    bit against the plain version on the CPU (both add each row's
    contributions in ascending q), and against itself on a second launch."""
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
    want = G.scatter_add_rows_ref(contrib.cpu(), idx.cpu(), V)
    assert torch.equal(sc.cpu(), want)
    assert torch.equal(G.scatter_add(contrib, idx, V), sc)
    assert (sc[:, 40:] == 0).all()
    v = vals.clone().requires_grad_(True)
    G.gather_rows(v, idx).backward(contrib)
    assert torch.equal(v.grad.cpu(), want)


def _row_case(kind, B, V, Q, rng):
    if kind == 'out_of_range':
        return rng.choice(np.array([-1, V, -7, V + 3, 2 ** 31 - 1, -2 ** 31],
                                   np.int64), (B, Q)).astype(np.int32)
    if kind in ('one_row', 'every_q_in_one_row'):
        return np.full((B, Q), V // 2, np.int32)
    if kind == 'half_the_rows_empty':
        return (2 * rng.randint(0, V // 2, (B, Q))).astype(np.int32)
    if kind.startswith('nearest_vertices'):
        # skewed as masked-min argmins are: many vertices share one
        return (rng.zipf(1.3, (B, Q)) % V).astype(np.int32)
    if kind.startswith('rows_at_cta_edges'):
        # the rows on both sides of each CTA's row range, from all of q:
        # long rows that end and start a CTA's range
        rows = -(-V // G.scatter_plan(B, V, Q))
        edges = np.array(sorted({r for k in range(1, -(-V // rows))
                                 for r in (k * rows - 1, k * rows)}))
        return rng.choice(edges, (B, Q)).astype(np.int32)
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
    ('every_q_in_one_row', 1, 6890, 6890),
    ('half_the_rows_empty', 3, 1001, 2000),
    ('v_not_a_multiple_of_32', 2, 6889, 6890),
    ('candidate_gather_q_below_v', 4, 6890, 984),
    ('nearest_vertices_b1', 1, 6890, 6890),
    ('nearest_vertices_b4', 4, 6890, 6890),
    ('nearest_vertices_b64', 64, 6890, 6890),
    ('rows_at_cta_edges_b1', 1, 6890, 6890),
    ('rows_at_cta_edges_b64', 64, 6890, 6890),
])
def test_gather_and_scatter_kernels_edge_cases_on_card(cuda_device, kind, B,
                                                       V, Q):
    """Gather bitwise equal to the plain version, scatter bit for bit equal
    to the plain version on the CPU (randn contributions: both sum each row
    in ascending q) and to itself on a second launch, one launch each, at
    the shapes where the kernels' tiles, the CTAs' row ranges and the
    rows' slot lists have edges: a ragged last tile, rows with no
    contribution, every index out of range, every index on one row (one
    long chain), skewed rows as nearest vertices give, Q below V (the
    candidate gather), the training, demo and EFT batches."""
    rng = np.random.RandomState(B * 100003 + V * 7 + Q)
    idx = torch.from_numpy(_row_case(kind, B, V, Q, rng)).to(cuda_device)
    vals = torch.from_numpy(rng.randn(B, V, 3).astype(np.float32)).to(
        cuda_device)
    contrib = torch.from_numpy(rng.randn(B, Q, 3).astype(np.float32)).to(
        cuda_device)
    before = _launches()
    got = G.gather_rows_cuda(vals, idx)
    sc = G.scatter_add_rows_cuda(contrib, idx, V)
    torch.cuda.synchronize()
    assert _launches()[2:] == (before[2] + 1, before[3] + 1)
    assert torch.equal(got, G.gather_rows_ref(vals, idx))
    want = G.scatter_add_rows_ref(contrib.cpu(), idx.cpu(), V)
    assert sc.shape == (B, V, 3)
    assert torch.equal(sc.cpu(), want)
    assert torch.equal(G.scatter_add_rows_cuda(contrib, idx, V), sc)


@pytest.mark.cuda
@pytest.mark.parametrize('split', [1, 2, 3, 7, 32])
def test_scatter_kernel_is_the_same_at_every_split_on_card(cuda_device,
                                                           split):
    """Kernel 6 launched directly at other CTAs per item than the plan's:
    bit for bit the plain version on the CPU whatever the split."""
    from tuch_tpu_torch.ops import _build
    rng = np.random.RandomState(split)
    B, V, Q = 3, 2000, 3001
    idx = torch.from_numpy(_row_case('nearest_vertices', B, V, Q, rng)).to(
        cuda_device)
    contrib = torch.from_numpy(rng.randn(B, Q, 3).astype(np.float32)).to(
        cuda_device)
    out = torch.empty(B, V, 3, device=cuda_device)
    lib, fn = _build.entry('gather', 'tuch_scatter_add_rows',
                           G._SCATTER_ARGS)
    _build.check(lib, fn(contrib.data_ptr(), idx.data_ptr(), out.data_ptr(),
                         B, V, Q, split,
                         torch.cuda.current_stream().cuda_stream), 'split')
    torch.cuda.synchronize()
    want = G.scatter_add_rows_ref(contrib.cpu(), idx.cpu(), V)
    assert torch.equal(out.cpu(), want)


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
    # A capture now and then holds the runtime's launch call but loses the
    # kernel's record (chip_smoke.one_call_work, the same rule): it is taken
    # again, up to 10 times in all; one without a launch call stands.
    for _ in range(10):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            G.scatter_add_rows_cuda(contrib, idx, 6890)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        launched = [e.name for e in prof.events()
                    if e.device_type != DeviceType.CUDA
                    and e.name.startswith(('cudaLaunch', 'cuLaunch'))]
        if names or not launched:
            break
    assert len(names) == 1 and 'scatter_add_rows' in names[0], names


# ---------------------------------------------------------------------------
# kernels 3 and 7 (the experimental winding routes) on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize('B,Q,F', [(1, 130, 300), (3, 7, 1000),
                                   (3, 600, 129), (1, 1, 300),
                                   (2, 511, 700), (2, 513, 700),
                                   (1, 6890, 1000), (64, 600, 1000)])
def test_affine_kernel_matches_plain_version_on_card(cuda_device, B, Q, F):
    """Ragged query and triangle tiles around the 512-query block, one and
    several splits (B = 1 splits the triangles, B = 64 barely), queries on
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


@pytest.mark.cuda
def test_affine_wrapper_refuses_a_misaligned_layout_on_card(cuda_device):
    verts, faces = _body(B=2, V=40, F=30, device=cuda_device)
    p4 = CK.affine_points(verts)
    rows = CK.affine_constant_rows(verts[:, faces])
    flat = torch.cat([rows.new_zeros(1), rows.reshape(-1)])
    with pytest.raises(ValueError, match='16-byte'):
        CK.winding_numbers_affine_cuda(p4, flat[1:].view(rows.shape))
    with pytest.raises(ValueError, match=r'\(B, F, 28\)'):
        CK.winding_numbers_affine_cuda(p4, rows.transpose(1, 2).contiguous())


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
    n = min(10, TQ)
    pts[:, :, :n] = tris[:, 0, 0:3, :n]
    tris[:, K - 1] = np.tile(tris[:, K - 1, 0:3], (1, 3, 1))
    pts[:, :, TQ] = tris[:, K - 1, 0:3, 0]
    sel = rng.randint(0, K, (B, T, M)).astype(np.int32)
    sel[0, 0] = [4, 4, 0, 2, 4, 1, 0]
    sel[0, 1] = K - 1
    return [torch.from_numpy(x).to(device) for x in (sel, pts, tris)]


@pytest.mark.cuda
@pytest.mark.parametrize('B,TQ,C', [(1, 512, 256), (3, 200, 300),
                                    (64, 512, 256), (2, 513, 100),
                                    (2, 1, 256)])
def test_near_kernel_matches_plain_version_on_card(cuda_device, B, TQ, C):
    """Kernel 7 against near_field_ref: a whole tile in one block (TQ =
    512), a ragged point block (TQ = 200, 513, 1), a ragged triangle stage
    (C = 300, 100), the m axis split over the grid (B = 1) or not (B = 64),
    points on triangle corners; atol 2e-5 in winding-number units (the sum
    over 4 pi), as kernel 2; the degenerate faces add exactly 0."""
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


# ---------------------------------------------------------------------------
# The training step (kernels 2, 4, 5 and 6 on a new path)
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def train_runtime():
    """The full synthetic body with every contact asset and the HD
    surface, on the card."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (the kernels have no CPU mode)')
    from tuch_tpu_torch import runtime as rt
    return rt.build_runtime(device='cuda', synthetic=True, with_contact=True,
                            with_hd=True)


def _plain_on_card(monkeypatch):
    """The contact losses with the plain versions of kernels 2, 4, 5 and 6
    called directly on CUDA tensors (for a reference only)."""
    from tuch_tpu_torch.losses import smplify as L
    from tuch_tpu_torch.ops import segments as S

    class _Gather(torch.autograd.Function):
        @staticmethod
        def forward(ctx, values, idx):
            ctx.save_for_backward(idx)
            ctx.num_rows = values.shape[1]
            return G.gather_rows_ref(values, idx)

        @staticmethod
        def backward(ctx, ct):
            idx, = ctx.saved_tensors
            return G.scatter_add_rows_ref(ct, idx, ctx.num_rows), None

    def tris(points, tris):
        return PC.winding_numbers(points, tris,
                                  block_f=min(1024, tris.shape[1]))

    monkeypatch.setattr(CK, 'winding_numbers_faces',
                        PC.winding_numbers_same_tris)
    monkeypatch.setattr(S, 'winding_numbers_tris', tris)
    monkeypatch.setattr(CK, 'masked_min_dist',
                        lambda v, m, bits=None: PC.masked_min_dist(v, m))
    monkeypatch.setattr(L, 'gather_rows', _Gather.apply)


@pytest.mark.cuda
@pytest.mark.parametrize('hd', [True, False], ids=['hd', 'no_hd'])
def test_regressor_contact_loss_on_card_matches_plain_versions(
        train_runtime, monkeypatch, hd):
    """The contact loss at B=4 on the full posed body through kernels 2
    (all vertices, the segments and with HD the 1024 offset points), 4 and
    5, and without HD 6 (with HD the gradient reaches the vertices through
    the HD points, not the re-gather), against the same loss with their
    plain versions called on the card: the value at rtol 1e-5, the
    gradient with respect to the vertices at rtol 1e-4 + atol 1e-5 of its
    largest entry (kernel 6 sums in another order)."""
    from tuch_tpu_torch.losses import regressor as R
    from tuch_tpu_torch.models.smpl import smpl_forward
    rt = train_runtime
    rng = np.random.RandomState(5)
    pose = torch.from_numpy((rng.randn(4, 72) * 0.6).astype(np.float32))
    with torch.no_grad():
        verts = smpl_forward(rt.smpl, torch.zeros(4, 10, device='cuda'),
                             pose[:, 3:].cuda(), pose[:, :3].cuda()).vertices
    valid = torch.tensor([True, True, False, True], device='cuda')

    def loss_and_grad():
        v = verts.clone().requires_grad_(True)
        loss, aux = R.contact_loss(v, rt.contact, valid, 0.02,
                                   hd=rt.hd if hd else None)
        grad, = torch.autograd.grad(loss, v)
        return loss.item(), grad, aux

    counters = [CK.winding_numbers_tris_cuda, CK.masked_min_dist_cuda,
                G.gather_rows_cuda, G.scatter_add_rows_cuda]
    before = [c.launches for c in counters]
    got, g_got, aux = loss_and_grad()
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == (
        [3, 1, 1, 0] if hd else [2, 1, 1, 1])
    assert got > 0 and 0.0 <= float(aux['hd_truncated_frac']) < 1.0
    with monkeypatch.context() as m:
        _plain_on_card(m)
        before = [c.launches for c in counters]
        want, g_want, _ = loss_and_grad()
        assert [c.launches for c in counters] == before
    assert abs(got - want) <= 1e-5 * abs(want)
    tol = 1e-4 * g_want.abs() + 1e-5 * g_want.abs().max()
    assert bool(((g_got - g_want).abs() <= tol).all())


@pytest.mark.cuda
def test_resnet50_train_step_launch_counts_on_card(cuda_device):
    """One ResNet-50 step at B=2 (170-vertex body, 64 px, 2 SMPLify
    iterations, contact and HD on): kernel 2 twice per fit iteration (all
    vertices, the segments) and three times in the loss (plus the HD
    points), kernels 4 and 5 once per iteration and once in the loss,
    kernel 6 once per iteration (the HD loss's gradient does not pass
    through the re-gather)."""
    from tuch_tpu_torch import config as cfg
    from tuch_tpu_torch import runtime as rt
    from tuch_tpu_torch.train import module as M
    r = rt.build_runtime(device=cuda_device, synthetic=True, num_verts=170,
                         with_contact=True, with_hd=True)
    assets = M.TuchAssets(r.smpl, r.prior, r.contact, r.hd)
    opts = cfg.TrainConfig(img_res=64, batch_size=2, run_smplify=True,
                           num_smplify_iters=2, smplify_threshold=1e9)
    rng = np.random.RandomState(0)
    P = len(r.contact_classes)
    batch = {
        'img': rng.randn(2, 64, 64, 3).astype(np.float32) * 0.1,
        'keypoints': np.concatenate([rng.uniform(-0.8, 0.8, (2, 49, 2)),
                                     np.ones((2, 49, 1))], -1).astype(
            np.float32),
        'pose': (rng.randn(2, 72) * 0.1).astype(np.float32),
        'betas': np.zeros((2, 10), np.float32),
        'contact_vec': (rng.rand(2, P) > 0.6).astype(np.float32),
        'pose_3d': np.zeros((2, 24, 4), np.float32),
        'has_smpl': np.array([1.0, 0.0], np.float32),
        'has_pgt_smpl': np.zeros(2, np.float32),
        'has_disc_contact': np.array([0.0, 1.0], np.float32),
        'has_gt_kpts': np.ones(2, np.float32),
        'has_pose_3d': np.zeros(2, np.float32),
        'is_flipped': np.array([0.0, 1.0], np.float32),
        'rot_angle': np.array([10.0, -5.0], np.float32),
        'fits_index': np.array([3, 1], np.int32)}
    state = M.init_train_state(r.hmr, torch.zeros(8, 82, device=cuda_device),
                               opts.lr)
    counters = [CK.winding_numbers_tris_cuda, CK.masked_min_dist_cuda,
                G.gather_rows_cuda, G.scatter_add_rows_cuda]
    before = [c.launches for c in counters]
    state, metrics, outputs = M.make_train_step(assets, opts)(state, batch)
    torch.cuda.synchronize()
    n = opts.num_smplify_iters
    assert [c.launches - b for c, b in zip(counters, before)] == \
        [2 * n + 3, n + 1, n + 1, n]
    assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
    assert state.step == 1 and state.fits.device.type == 'cuda'
    acc = outputs['fit_accepted']
    assert bool(acc.any())
    written = (state.fits[[3, 1]] != 0).any(dim=1)
    assert torch.equal(written, acc)


@pytest.mark.cuda
def test_dropout_masks_from_one_seed_match_on_card(cuda_device):
    from tuch_tpu_torch.models import hmr as H
    a = H.draw_dropout_masks(
        8, torch.Generator(device=cuda_device).manual_seed(4), cuda_device)
    b = H.draw_dropout_masks(
        8, torch.Generator(device=cuda_device).manual_seed(4), cuda_device)
    flat_a = [m for pair in a for m in pair]
    flat_b = [m for pair in b for m in pair]
    assert all(x.device.type == 'cuda' and x.shape == (8, H.HEAD_WIDTH)
               for x in flat_a)
    assert all(torch.equal(x, y) for x, y in zip(flat_a, flat_b))
    assert 0.4 < torch.stack(flat_a).float().mean().item() < 0.6
