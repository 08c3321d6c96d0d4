"""tuch_tpu_torch's experimental winding routes against tuch_tpu, on the CPU.

The hierarchical route (kernel 7's plain version with the dense near
selection and dipole far field) and the affine route (kernel 3's plain
version) against the JAX package's winding_numbers_hier and
winding_numbers_pallas_affine in interpret mode, with both packages fed the
same cluster tables and numpy-seeded vertices. The JAX kernels use a
polynomial atan2 (~2e-7 per call) and the port IEEE atan2, so values are
held at an absolute tolerance that covers that error summed over the
triangles of a route, and in/out decisions at 0.99 must agree outside a
band of that width.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tuch_tpu import assets as jax_assets
from tuch_tpu.ops import contact as JC
from tuch_tpu.ops import contact_pallas as cpk
from tuch_tpu.ops import winding_hier as JH
from tuch_tpu_torch.models.convert import winding_clusters_from_numpy
from tuch_tpu_torch.ops import contact as PC
from tuch_tpu_torch.ops import contact_kernels as CK
from tuch_tpu_torch.ops import winding_hier as PH

TABLES = ('face_perm', 'faces_sorted', 'vert_perm', 'vert_inv')
SIZES = ('num_clusters', 'cluster_size', 'tile_q', 'num_real_verts',
         'num_real_faces')
HIER_ATOL = 1e-4     # polynomial atan2 error summed over M * C triangles
AFFINE_ATOL = 1e-3   # the affine form's ~1e-7 cancellation noise near
                     # corners, amplified: a different rounding of the same
                     # dots moves angles of pairs just outside the 1 mm mask


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _body(num_verts):
    model, _ = jax_assets.synthetic_smpl(num_verts=num_verts, seed=0)
    return np.asarray(model.v_template), np.asarray(model.faces)


def _squeezed(v0, batch=2):
    """The JAX test's bodies: squeezed in y and jittered, so that opposite
    sides fold through and some vertices lie inside."""
    rng = np.random.RandomState(0)
    return (v0[None] * np.array([1.0, 0.6, 1.0], np.float32)
            + 0.02 * rng.randn(batch, *v0.shape).astype(np.float32)
            ).astype(np.float32)


def _decisions_agree(got, want, band):
    outside = np.abs(want - 0.99) >= band
    return np.array_equal((got <= 0.99)[outside], (want <= 0.99)[outside])


# ---------------------------------------------------------------------------
# cluster tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('num_verts,cluster_size,tile_q', [
    (170, 128, 128), (1000, 64, 128), (6890, 256, 512)])
def test_cluster_tables_equal_jax(num_verts, cluster_size, tile_q):
    """158-, 994- and 6890-vertex bodies: every table equal, and the JAX
    tables carried across by winding_clusters_from_numpy equal too."""
    v0, faces = _body(num_verts)
    want = JH.build_winding_clusters(v0, faces, cluster_size=cluster_size,
                                     tile_q=tile_q)
    got = PH.build_winding_clusters(v0, faces, cluster_size=cluster_size,
                                    tile_q=tile_q, device='cpu')
    carried = winding_clusters_from_numpy(
        {k: np.asarray(v) for k, v in want._asdict().items()})
    for k in TABLES:
        assert np.array_equal(getattr(got, k).numpy(),
                              np.asarray(getattr(want, k))), k
        assert torch.equal(getattr(carried, k), getattr(got, k)), k
    for k in SIZES:
        assert getattr(got, k) == getattr(want, k) == getattr(carried, k)
    if num_verts == 6890:   # the body's own shapes: K = 54, Qp = 7168
        assert got.num_clusters == 54 and got.vert_perm.shape == (7168,)


def test_build_winding_clusters_defaults_to_cuda(monkeypatch):
    v0, faces = _body(170)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PH.build_winding_clusters(v0, faces, cluster_size=128, tile_q=128)


# ---------------------------------------------------------------------------
# hierarchical route (kernel 7)
# ---------------------------------------------------------------------------

HIER_CASES = {
    # the JAX test's case: K = 3 = M, every cluster is near
    'all_near': (170, 128, 128, 4),
    # M = 4 < K = 31: the far field carries most clusters
    'far_field': (1000, 64, 128, 4),
}


@pytest.mark.parametrize('case', sorted(HIER_CASES))
def test_hier_plain_matches_jax_interpret(case):
    """Values at atol 1e-4, decisions equal outside |wn - 0.99| < 1e-4."""
    num_verts, cs, tq, num_near = HIER_CASES[case]
    v0, faces = _body(num_verts)
    verts = _squeezed(v0)
    jcl = JH.build_winding_clusters(v0, faces, cluster_size=cs, tile_q=tq)
    pcl = winding_clusters_from_numpy(jcl._asdict())
    want = np.asarray(JH.winding_numbers_hier(jnp.asarray(verts), jcl,
                                              num_near=num_near,
                                              interpret=True))
    got = PH.winding_numbers_hier(_t(verts), pcl, num_near=num_near).numpy()
    assert got.shape == verts.shape[:2]
    np.testing.assert_allclose(got, want, atol=HIER_ATOL)
    assert _decisions_agree(got, want, HIER_ATOL)
    prob = PH.hier_problem(_t(verts), pcl, num_near)
    far = prob.far.abs().max().item()
    if case == 'far_field':
        assert pcl.num_clusters == 31 and prob.sel.shape == (2, 8, 4)
        assert far > 1e-2        # the far field is really summed
        assert (want > 0.99).any() and (want <= 0.99).any()
    else:
        assert prob.sel.shape[2] == pcl.num_clusters == 3
        assert far < 1e-4        # all selected: far_all - far_sel ~ 0


def test_hier_meets_the_jax_tests_bar():
    """tests/test_pallas_interpret.py's bar for the JAX route, on the port:
    in/out flips against exact winding under 2% (K = M case)."""
    num_verts, cs, tq, num_near = HIER_CASES['all_near']
    v0, faces = _body(num_verts)
    verts = _t(_squeezed(v0))
    pcl = PH.build_winding_clusters(v0, faces, cluster_size=cs, tile_q=tq,
                                    device='cpu')
    wn_h = PH.winding_numbers_hier(verts, pcl, num_near=num_near).numpy()
    wn_e = PC.winding_numbers_same_tris(verts, verts, _t(faces),
                                        block_f=64).numpy()
    assert np.mean((wn_h <= 0.99) != (wn_e <= 0.99)) < 0.02


def test_nearest_breaks_ties_as_jax_top_k():
    """Lower index first among equal distances, and -0 before +0, as
    jax.lax.top_k(-d); negative distances (a tile inside a cluster's
    radius) order as floats."""
    rng = np.random.RandomState(5)
    d = rng.randint(-3, 4, (3, 6, 20)).astype(np.float32)  # many ties
    d[1] += rng.randn(6, 20).astype(np.float32)            # no ties
    d[0, 0] = 0.0
    d[0, 0, 7] = -0.0
    _, want = jax.lax.top_k(-jnp.asarray(d), 9)
    got = PH.nearest(_t(d), 9)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_near_field_ref_sums_the_selected_clusters():
    """near_field_ref's layouts: each tile's sum equals exact winding of
    its points against the union of its selected clusters' triangles
    (sel with repeats and out of order), times 4 pi."""
    rng = np.random.RandomState(2)
    B, T, TQ, K, C, M = 2, 3, 5, 4, 7, 5
    pts = rng.randn(B, 3, T * TQ).astype(np.float32)
    tris = rng.randn(B, K, 9, C).astype(np.float32)
    sel = rng.randint(0, K, (B, T, M)).astype(np.int32)
    sel[0, 0] = [3, 3, 0, 2, 3]
    got = PH.near_field_ref(_t(sel), _t(pts), _t(tris)).numpy()
    for b in range(B):
        for t in range(T):
            tri = tris[b][sel[b, t]]                     # (M, 9, C)
            tri = tri.transpose(0, 2, 1).reshape(1, M * C, 3, 3)
            p = pts[b, :, t * TQ:(t + 1) * TQ].T[None]
            want = PC.winding_numbers(_t(p), _t(tri)).numpy()[0] * 4 * np.pi
            np.testing.assert_allclose(got[b, t * TQ:(t + 1) * TQ], want,
                                       atol=1e-5)


def test_near_field_padding_faces_add_exactly_zero():
    """A cluster padded with degenerate faces (one vertex three times, as
    build_winding_clusters pads) gives the same sum as without them, and
    the faces alone give exactly 0, also at their own vertex."""
    rng = np.random.RandomState(3)
    pts = rng.randn(1, 3, 8).astype(np.float32)
    real = rng.randn(1, 1, 9, 6).astype(np.float32)
    # corner rows [a b c] = [v v v]: a vertex of the cluster, and a point
    degen = np.stack([np.tile(real[0, 0, :3, 0], 3),
                      np.tile(pts[0, :, 2], 3)], axis=1)[None, None]
    sel = np.zeros((1, 1, 1), np.int32)
    only = PH.near_field_ref(_t(sel), _t(pts), _t(degen))
    assert torch.equal(only, torch.zeros_like(only))
    both = PH.near_field_ref(_t(sel), _t(pts),
                             _t(np.concatenate([real, degen], 3)))
    alone = PH.near_field_ref(_t(sel), _t(pts), _t(real))
    torch.testing.assert_close(both, alone, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# affine route (kernel 3)
# ---------------------------------------------------------------------------

def _affine_bodies(kind):
    """tests/test_pallas_interpret.py's affine bodies (170-vertex sphere)."""
    model, _ = jax_assets.synthetic_smpl(num_verts=170, seed=0)
    v0 = np.asarray(model.v_template)
    rng = np.random.RandomState(0)
    if kind == 'posed':
        verts = v0[None] + 0.02 * rng.randn(2, *v0.shape).astype(np.float32)
    else:
        verts = (v0 * np.array([1, 0.02, 1], np.float32))[None]
    return verts.astype(np.float32), np.asarray(model.faces)


def test_affine_constants_match_jax():
    verts, faces = _affine_bodies('posed')
    want = np.asarray(cpk._affine_triangle_constants(
        jnp.asarray(verts)[:, jnp.asarray(faces)]))
    got = CK.affine_triangle_constants(_t(verts)[:, _t(faces).long()])
    assert got.shape == (2, 28, faces.shape[0]) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize('kind', ['posed', 'squashed'])
def test_affine_plain_matches_jax_interpret(kind):
    """Self-winding, every query a corner of its faces. Against the JAX
    kernel at atol 1e-3 with equal decisions; against the subtraction form
    at the JAX test's own bar (atol 0.02, equal decisions)."""
    verts, faces = _affine_bodies(kind)
    bv = jnp.asarray(verts)
    want = np.asarray(cpk.winding_numbers_pallas_affine(
        bv, bv, jnp.asarray(faces), tq=128, tf=256, interpret=True))
    exact = np.asarray(JC.winding_numbers_same_tris(
        bv, bv, jnp.asarray(faces), block_f=64))
    tv = _t(verts)
    got = CK.winding_numbers_affine(tv, tv, _t(faces)).numpy()
    np.testing.assert_allclose(got, want, atol=AFFINE_ATOL)
    np.testing.assert_array_equal(got <= 0.99, want <= 0.99)
    np.testing.assert_allclose(got, exact, atol=0.02)
    np.testing.assert_array_equal(got <= 0.99, exact <= 0.99)


def test_affine_ragged_queries_and_faces_add_no_padding():
    """Q = 37 free points and F = 301 faces, multiples of no tile: the port
    streams without padding, JAX pads to tq=128, tf=256 with zero
    constants; both agree. Zero-constant triangles appended on the port's
    side add nothing."""
    verts, faces = _affine_bodies('posed')
    faces = faces[:301]
    rng = np.random.RandomState(4)
    pts = (rng.randn(2, 37, 3) * 0.4).astype(np.float32)
    want = np.asarray(cpk.winding_numbers_pallas_affine(
        jnp.asarray(pts), jnp.asarray(verts), jnp.asarray(faces), tq=128,
        tf=256, interpret=True))
    got = CK.winding_numbers_affine(_t(pts), _t(verts), _t(faces))
    np.testing.assert_allclose(got.numpy(), want, atol=AFFINE_ATOL)
    p4 = CK.affine_points(_t(pts))
    tc = CK.affine_triangle_constants(_t(verts)[:, _t(faces).long()])
    padded = torch.cat([tc, torch.zeros(2, 28, 211)], dim=2)
    torch.testing.assert_close(CK.winding_numbers_affine_ref(p4, padded),
                               got, rtol=0, atol=1e-6)
    torch.testing.assert_close(
        CK.winding_numbers_affine_ref(p4, tc, block_f=100), got, rtol=0,
        atol=1e-6)


# ---------------------------------------------------------------------------
# dispatch on the CPU
# ---------------------------------------------------------------------------

def test_routes_on_cpu_use_plain_versions_without_launching():
    verts, faces = _affine_bodies('posed')
    tv = _t(verts)
    before = (CK.winding_numbers_affine_cuda.launches,
              PH.near_field_cuda.launches)
    got = CK.winding_numbers_affine(tv, tv, _t(faces))
    want = CK.winding_numbers_affine_ref(
        CK.affine_points(tv),
        CK.affine_triangle_constants(tv[:, _t(faces).long()]))
    assert torch.equal(got, want)
    v0 = np.asarray(jax_assets.synthetic_smpl(num_verts=170)[0].v_template)
    cl = PH.build_winding_clusters(v0, faces, cluster_size=128, tile_q=128,
                                   device='cpu')
    prob = PH.hier_problem(tv, cl, 4)
    near = PH.near_field(prob.sel, prob.pts, prob.tris)
    assert torch.equal(near, PH.near_field_ref(prob.sel, prob.pts,
                                               prob.tris))
    assert torch.equal(PH.winding_numbers_hier(tv, cl, 4),
                       PH.combine(near, prob.far, cl))
    assert (CK.winding_numbers_affine_cuda.launches,
            PH.near_field_cuda.launches) == before
