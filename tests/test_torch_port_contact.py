"""tuch_tpu_torch's contact geometry against tuch_tpu, on the CPU.

The plain versions of the four kernels of the SMPLify-DC slice (winding
numbers, masked nearest vertex, row gather, row scatter-add) against the
JAX package's streamed versions and its Pallas kernels in interpret mode;
the region-pair distances, the segment tests and the synthetic contact
assets. Inputs come from numpy seeds on the 170-vertex synthetic body.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tuch_tpu import assets as jax_assets
from tuch_tpu.losses.prior import create_gmm_prior as jax_create_prior
from tuch_tpu.ops import contact as JC
from tuch_tpu.ops import contact_pallas as cpk
from tuch_tpu.ops import gather_pallas as gpk
from tuch_tpu.ops import segments as JS
from tuch_tpu_torch import assets as pt_assets
from tuch_tpu_torch.losses.prior import create_gmm_prior
from tuch_tpu_torch.ops import contact as PC
from tuch_tpu_torch.ops import contact_kernels as CK
from tuch_tpu_torch.ops import gather as PG
from tuch_tpu_torch.ops import segments as PS


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _bodies(model, kind):
    """(B, V, 3) vertices of the tiny body: at rest, jittered, or squashed
    flat so that opposite sides nearly touch and fold through."""
    v0 = np.asarray(model.v_template)
    rng = np.random.RandomState(0)
    if kind == 'rest':
        return v0[None].astype(np.float32)
    if kind == 'posed':
        return (v0[None] + 0.02 * rng.randn(2, *v0.shape)).astype(np.float32)
    squashed = v0 * np.array([1.0, 0.02, 1.0], np.float32)
    return (squashed[None] + 0.004 * rng.randn(2, *v0.shape)
            ).astype(np.float32)


BODIES = ['rest', 'posed', 'squashed']


# ---------------------------------------------------------------------------
# synthetic assets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('num_verts', [170, 6890])
def test_synthetic_contact_extras_bitwise_equal_jax(num_verts):
    with_geo = num_verts == 170   # the full (V, V) matrix is ~190 MB
    _, ex = jax_assets.synthetic_smpl(num_verts=num_verts,
                                      with_contact=with_geo)
    got = pt_assets.synthetic_contact(num_verts, with_geodists=with_geo)
    if with_geo:
        assert got.geodists.dtype == ex.geodists.dtype
        assert np.array_equal(got.geodists, ex.geodists)
    else:
        assert got.geodists is None
    assert got.contact_classes == ex.contact_classes
    assert got.contact_csig.keys() == ex.contact_csig.keys()
    for k, v in ex.contact_csig.items():
        assert np.array_equal(got.contact_csig[k], v)
    assert got.segments.keys() == ex.segments.keys()
    for k, seg in ex.segments.items():
        assert np.array_equal(got.segments[k]['vidx'], seg['vidx'])
        assert got.segments[k]['bands_verts'] == seg['bands_verts']


def test_gmm_prior_bitwise_equal_jax():
    want_gmm = jax_assets.synthetic_gmm_prior()
    got_gmm = pt_assets.synthetic_gmm_prior()
    for k in want_gmm:
        assert np.array_equal(got_gmm[k], want_gmm[k]), k
    want = jax_create_prior(want_gmm)
    got = create_gmm_prior(got_gmm)
    for name in ('means', 'precisions', 'nll_weights'):
        assert np.array_equal(getattr(got, name).numpy(),
                              np.asarray(getattr(want, name))), name


# ---------------------------------------------------------------------------
# kernel 2: winding numbers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('kind', BODIES)
def test_winding_plain_matches_jax_streamed(tiny_smpl, kind):
    """Self-winding (every query a corner of its own faces) and free
    points; atol 2e-5 (float32 summation order and atan2 rounding), and no
    in/out flip at 0.99."""
    model, _ = tiny_smpl
    faces = np.asarray(model.faces)
    verts = _bodies(model, kind)
    rng = np.random.RandomState(1)
    free = (rng.randn(verts.shape[0], 40, 3) * 0.4).astype(np.float32)
    for pts in (verts, free):
        want = np.asarray(JC.winding_numbers_same_tris(
            jnp.asarray(pts), jnp.asarray(verts), jnp.asarray(faces),
            block_f=64))
        got = PC.winding_numbers_same_tris(_t(pts), _t(verts), _t(faces),
                                           block_f=64).numpy()
        np.testing.assert_allclose(got, want, atol=2e-5)
        np.testing.assert_array_equal(got <= 0.99, want <= 0.99)
        tris = verts[:, faces]
        got_t = PC.winding_numbers(_t(pts), _t(tris), block_f=100).numpy()
        np.testing.assert_allclose(got_t, want, atol=2e-5)


@pytest.mark.parametrize('kind', BODIES)
def test_winding_plain_matches_pallas_interpret(tiny_smpl, kind):
    """The Pallas kernel in interpret mode (exact divide, polynomial atan2)
    at tq=128, tf=256: atol 2e-5, no in/out flip."""
    model, _ = tiny_smpl
    faces = np.asarray(model.faces)
    verts = _bodies(model, kind)
    want = np.asarray(cpk.winding_numbers_pallas(
        jnp.asarray(verts), jnp.asarray(verts), jnp.asarray(faces),
        tq=128, tf=256, interpret=True))
    got = CK.winding_numbers_faces(_t(verts), _t(verts), _t(faces)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_array_equal(got <= 0.99, want <= 0.99)


def test_winding_rest_body_inside_outside(tiny_smpl):
    """The rest ellipsoid: its centre is inside (1), far points outside
    (0), to 1e-5; the direct solid-angle sum agrees with the streamed one."""
    model, _ = tiny_smpl
    faces = _t(np.asarray(model.faces))
    verts = _t(_bodies(model, 'rest'))
    pts = _t(np.array([[[0, 0, 0], [3, 0, 0], [0, -5, 1]]], np.float32))
    wn = PC.winding_numbers_same_tris(pts, verts, faces).numpy()
    np.testing.assert_allclose(wn[0], [1.0, 0.0, 0.0], atol=1e-5)
    direct = PC.solid_angles(pts, verts[:, faces.long()]).sum(-1) \
        * PC.INV_4PI
    np.testing.assert_allclose(direct.numpy(), wn, atol=1e-5)


# ---------------------------------------------------------------------------
# kernel 4: masked nearest vertex
# ---------------------------------------------------------------------------

def _mask(V, seed):
    rng = np.random.RandomState(seed)
    geo = rng.rand(V, V) > 0.3
    np.fill_diagonal(geo, False)
    geo[3] = False                      # a vertex with no allowed partner
    return geo


def _hold_masked_min(d2, arg, verts, geo, want_d2, want_arg):
    """d2 at rtol 1e-6; a different argmin only where the two indices'
    plain distances agree within 1e-6 relative; never a banned index."""
    np.testing.assert_allclose(d2, want_d2, rtol=1e-6)
    B, V = d2.shape
    full = ((verts[:, :, None] - verts[:, None]) ** 2).sum(-1)
    rows = np.arange(V)[None].repeat(B, 0)
    bidx = np.arange(B)[:, None]
    differ = arg != want_arg
    np.testing.assert_allclose(full[bidx, rows, arg][differ],
                               full[bidx, rows, want_arg][differ],
                               rtol=1e-6)
    finite = np.isfinite(want_d2)
    assert geo[rows, arg][finite].all()


@pytest.mark.parametrize('kind', ['random', 'squashed'])
def test_masked_min_plain_matches_jax_streamed(tiny_smpl, kind):
    """The exact first minimum on both sides: equal indices, d2 at rtol
    1e-6; all-banned rows give inf and index 0."""
    if kind == 'random':
        verts = np.random.RandomState(2).randn(2, 192, 3).astype(np.float32)
    else:
        verts = _bodies(tiny_smpl[0], 'squashed')
    V = verts.shape[1]
    geo = _mask(V, 3)
    want_d2, want_arg = (np.asarray(x) for x in JC.masked_min_dist(
        jnp.asarray(verts), jnp.asarray(geo), block_m=64))
    d2, arg = PC.masked_min_dist(_t(verts), _t(geo), block_m=64)
    d2, arg = d2.numpy(), arg.numpy()
    assert arg.dtype == np.int32
    _hold_masked_min(d2, arg, verts, geo, want_d2, want_arg)
    assert (d2[:, 3] == np.inf).all() and (arg[:, 3] == 0).all()
    assert (want_d2[:, 3] == np.inf).all()


def test_masked_min_plain_matches_pallas_interpret():
    """The Pallas kernel orders by 10 mantissa bits of d2 (its documented
    contract): its pick is within 2^-10 of the exact minimum."""
    rng = np.random.RandomState(4)
    verts = rng.randn(2, 192, 3).astype(np.float32)
    geo = _mask(192, 5)
    geo[3, 0] = True   # the kernel reports a finite pick on every row
    k_d2, k_arg = (np.asarray(x) for x in cpk.masked_min_dist_pallas(
        jnp.asarray(verts), jnp.asarray(geo.astype(np.uint8)),
        tn=128, tm=128, interpret=True))
    d2, arg = CK.masked_min_dist(_t(verts), _t(geo.astype(np.uint8)))
    np.testing.assert_allclose(k_d2, d2.numpy(), rtol=2 ** -10, atol=1e-7)
    assert geo[np.arange(192)[None].repeat(2, 0), arg.numpy()].all()


# ---------------------------------------------------------------------------
# kernels 5 and 6: row gather and scatter-add
# ---------------------------------------------------------------------------

def _gather_case(seed, B=3, V=300, Q=200):
    rng = np.random.RandomState(seed)
    vals = rng.randn(B, V, 3).astype(np.float32)
    idx = rng.randint(0, V, (B, Q)).astype(np.int32)
    idx[0, 5] = -1                      # out of range: a zero row
    idx[1, 7] = V
    return vals, idx


def test_gather_plain_bitwise_equals_jax_and_pallas_interpret():
    vals, idx = _gather_case(0)
    got = PG.gather_rows_ref(_t(vals), _t(idx)).numpy()
    ok = (idx >= 0) & (idx < vals.shape[1])
    want = np.asarray(gpk.gather_rows_ref(jnp.asarray(vals),
                                          jnp.asarray(np.where(ok, idx, 0))))
    assert (got[ok] == want[ok]).all()
    assert (got[~ok] == 0).all() and not np.signbit(got[~ok]).any()
    kern = np.asarray(gpk.gather_rows_pallas(
        jnp.asarray(vals), jnp.asarray(idx), tq=128, tm=128,
        interpret=True))
    assert (got == kern).all()


def test_scatter_plain_matches_jax_and_pallas_interpret():
    """rtol 1e-5 / atol 1e-6: float32 summation order differs."""
    rng = np.random.RandomState(1)
    B, V, Q = 3, 300, 260
    contrib = rng.randn(B, Q, 3).astype(np.float32)
    idx = rng.randint(0, 40, (B, Q)).astype(np.int32)  # heavy collisions
    idx[2, :5] = -1                                    # dropped
    got = PG.scatter_add_rows_ref(_t(contrib), _t(idx), V).numpy()
    keep = idx >= 0
    want = np.asarray(gpk.scatter_add_rows_ref(
        jnp.asarray(np.where(keep[..., None], contrib, 0)),
        jnp.asarray(np.where(keep, idx, 0)), V))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    kern = np.asarray(gpk.scatter_add_rows_pallas(
        jnp.asarray(contrib), jnp.asarray(idx), V, tn=128, tm=128,
        interpret=True))
    np.testing.assert_allclose(got, kern, rtol=1e-5, atol=1e-6)
    assert (got[:, 40:] == 0).all()


def test_gather_rows_backward_matches_jax_vjp():
    rng = np.random.RandomState(2)
    B, V, Q = 2, 50, 80                 # Q > V: repeated indices
    vals = rng.randn(B, V, 3).astype(np.float32)
    idx = rng.randint(0, V, (B, Q)).astype(np.int32)
    ct = rng.randn(B, Q, 3).astype(np.float32)
    out, vjp = jax.vjp(lambda v: gpk.gather_rows(v, jnp.asarray(idx)),
                       jnp.asarray(vals))
    want, = vjp(jnp.asarray(ct))
    v = _t(vals).requires_grad_(True)
    got_out = PG.gather_rows(v, _t(idx))
    got_out.backward(_t(ct))
    assert (got_out.detach().numpy() == np.asarray(out)).all()
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# region pairs, normals, segments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('with_geomask', [False, True])
def test_region_pair_min_dists_and_grad_match_jax(tiny_smpl, with_geomask):
    """Values and gradients at rtol 1e-4; the two select the closest pair
    with different exact forms, so near-ties could differ (none here)."""
    model, extras = tiny_smpl
    ia, ib, ma, mb = JC.build_region_pairs(extras.contact_classes,
                                           extras.contact_csig)
    p_tabs = PC.build_region_pairs(extras.contact_classes,
                                   extras.contact_csig)
    for a, b in zip((ia, ib, ma, mb), p_tabs):
        assert np.array_equal(a, b)
    geo = extras.geodists > 0.3
    verts = _bodies(model, 'posed')
    w = np.random.RandomState(3).rand(2, len(extras.contact_classes))
    w = w.astype(np.float32)

    def jax_loss(v):
        d = JC.region_pair_min_dists(v, ia, ib, ma, mb,
                                     geomask=jnp.asarray(geo)
                                     if with_geomask else None)
        return (d * w).sum(), d

    (_, want), gwant = jax.value_and_grad(jax_loss, has_aux=True)(
        jnp.asarray(verts))
    v = _t(verts).requires_grad_(True)
    tabs = [torch.as_tensor(x) for x in p_tabs]
    got = PC.region_pair_min_dists(v, *tabs, geomask=_t(geo)
                                   if with_geomask else None)
    (got * _t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4)
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(gwant), rtol=1e-4,
                               atol=1e-6)


def test_batch_face_normals_match_jax(tiny_smpl):
    model, _ = tiny_smpl
    tris = _bodies(model, 'posed')[:, np.asarray(model.faces)]
    tris[0, 0, 1] = tris[0, 0, 0]       # a zero-area face: zero normal
    tris[0, 0, 2] = tris[0, 0, 0]
    want = np.asarray(JC.batch_face_normals(jnp.asarray(tris)))
    got = PC.batch_face_normals(_t(tris)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert (got[0, 0] == 0).all()


@pytest.fixture(scope='module')
def seg_problem():
    model, extras = jax_assets.synthetic_smpl(num_verts=170, seed=0)
    faces = np.asarray(model.faces)
    V = model.v_template.shape[0]
    want = JS.build_segment_tables(extras.segments, faces, V)
    got = PS.build_segment_tables(extras.segments, faces, V)
    rng = np.random.RandomState(7)
    v0 = np.asarray(model.v_template)
    verts = np.concatenate([
        v0[None] + 0.01 * rng.randn(2, *v0.shape),
        # crumpled: a segment patch folds through itself
        v0[None] + 0.05 * np.random.RandomState(0).randn(1, *v0.shape)
    ]).astype(np.float32)
    return want, got, verts


def test_segment_tables_equal_jax(seg_problem):
    want, got, _ = seg_problem
    assert got.names == want.names and got.num_verts == want.num_verts
    for name in ('fused_vidx', 'fused_vmask', 'fused_faces', 'ring_idx',
                 'ring_w'):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for a, b in zip(got.faces, want.faces):
        assert np.array_equal(a, b)


@pytest.mark.parametrize('on_device_tables', [False, True])
def test_segment_exterior_fused_matches_jax(seg_problem, on_device_tables):
    """Fused test vs the JAX package's fused test (streamed and Pallas
    interpret) and vs the port's per-segment test: equal flags."""
    want_t, got_t, verts = seg_problem
    if on_device_tables:
        got_t = PS.to_device(got_t, 'cpu')
    want = np.asarray(JS.segment_exterior_fused(want_t, jnp.asarray(verts)))
    want_k = np.asarray(JS.segment_exterior_fused(
        want_t, jnp.asarray(verts), interpret=True))
    got = PS.segment_exterior_fused(got_t, _t(verts)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, want_k)
    assert not got.all()                 # some vertex is segment-interior
    for si, ext in enumerate(PS.segment_exterior_per_segment(got_t,
                                                             _t(verts))):
        np.testing.assert_array_equal(got[:, si, :ext.shape[1]],
                                      ext.numpy())


def test_forgive_segment_interiors_matches_jax(seg_problem):
    want_t, got_t, verts = seg_problem
    rng = np.random.RandomState(3)
    exterior = rng.rand(*verts.shape[:2]) > 0.5
    want = np.asarray(JS.forgive_segment_interiors(
        want_t, jnp.asarray(verts), jnp.asarray(exterior)))
    got = PS.forgive_segment_interiors(got_t, _t(verts),
                                       _t(exterior)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got & ~exterior).any()       # something was forgiven
