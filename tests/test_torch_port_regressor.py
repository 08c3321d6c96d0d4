"""tuch_tpu_torch's regressor losses against tuch_tpu's, on the CPU.

Each SPIN term, the self-contact loss with and without the HD surface
(with candidate_k and with the capacity compaction) and the Gram-form
masked distances, value and gradient against jax.value_and_grad on the
same numpy inputs. The 170-vertex synthetic body, folded through itself
so vertices are interior and in contact; the HD surface is one point per
face. Values at rtol 1e-4, gradients at rtol 1e-4 + atol 1e-6 of their
largest entry (the SMPLify slice's loss bar), with the HD surface atol
1e-4 (see the contact test); the capacity and HD truncation fractions to
1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tuch_tpu import assets as jax_assets
from tuch_tpu.losses import regressor as JR
from tuch_tpu.losses import smplify as JL
from tuch_tpu.models.smpl import smpl_forward as jax_smpl_forward
from tuch_tpu.ops import contact as JC
from tuch_tpu.ops.segments import build_segment_tables as jax_build_tables
from tuch_tpu_torch.losses import regressor as PR
from tuch_tpu_torch.models.convert import contact_assets_from_numpy
from tuch_tpu_torch.ops import contact as PCo

B = 3
EUCL = 0.02


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


@pytest.fixture(scope='module')
def body():
    model, extras = jax_assets.synthetic_smpl(num_verts=170, seed=0)
    ia, ib, ma, mb = JC.build_region_pairs(extras.contact_classes,
                                           extras.contact_csig)
    V = model.v_template.shape[0]
    tables = jax_build_tables(extras.segments, np.asarray(model.faces), V)
    jca = JL.ContactAssets(
        geomask=jnp.asarray(extras.geodists > 0.3),
        faces=jnp.asarray(model.faces), region_idx_a=jnp.asarray(ia),
        region_idx_b=jnp.asarray(ib), region_mask_a=jnp.asarray(ma),
        region_mask_b=jnp.asarray(mb), segment_tables=tables)
    fields = {k: np.asarray(v) for k, v in jca._asdict().items()
              if k != 'segment_tables'}
    pca = contact_assets_from_numpy(fields, tables._asdict())
    hd_np = (extras.hd_vert_ids, extras.hd_bary, extras.hd_geovec,
             np.asarray(model.faces))
    pose = (np.random.RandomState(2).randn(B, 72) * 1.5).astype(np.float32)
    verts = np.asarray(jax_smpl_forward(
        model, jnp.zeros((B, 10)), jnp.asarray(pose[:, 3:]),
        jnp.asarray(pose[:, :3])).vertices)
    return dict(jca=jca, pca=pca, jhd=JR.make_hd_assets_compact(*hd_np),
                phd=PR.make_hd_assets_compact(*hd_np), verts=verts)


def _hold_value_and_grad(jax_fn, torch_fn, *arrays, rtol=1e-4, atol=1e-6):
    """jax.value_and_grad against torch.autograd on the same arrays."""
    want, gwant = jax.value_and_grad(jax_fn, argnums=tuple(
        range(len(arrays))))(*(jnp.asarray(a) for a in arrays))
    leaves = [_t(a).requires_grad_(True) for a in arrays]
    got = torch_fn(*leaves)
    ggot = torch.autograd.grad(got, leaves, allow_unused=True,
                               materialize_grads=True)
    got = float(got.detach())
    np.testing.assert_allclose(got, float(want), rtol=rtol)
    for g, w in zip(ggot, gwant):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=rtol,
                                   atol=atol * max(1.0, np.abs(w).max()))
    return got


def _spin_inputs(seed=0):
    rng = np.random.RandomState(seed)
    kp = np.concatenate([rng.uniform(-1, 1, (B, 49, 2)),
                         rng.uniform(0, 1, (B, 49, 1))], -1)
    j3d = np.concatenate([rng.randn(B, 24, 3) * 0.3,
                          rng.uniform(0, 1, (B, 24, 1))], -1)
    return dict(
        pred_kp=rng.uniform(-1, 1, (B, 49, 2)), kp=kp,
        pred_j=rng.randn(B, 49, 3) * 0.3, j3d=j3d,
        pred_v=rng.randn(B, 20, 3) * 0.3, v=rng.randn(B, 20, 3) * 0.3,
        pred_rotmat=rng.randn(B, 24, 3, 3) * 0.5,
        pred_betas=rng.randn(B, 10), opt_pose=rng.randn(B, 72) * 0.3,
        opt_betas=rng.randn(B, 10), cam=rng.randn(B, 3) * 0.3,
        valid=np.array([True, False, True]),
        none=np.zeros(B, bool))


@pytest.mark.parametrize('mask', ['valid', 'none'])
def test_spin_terms_match_jax(mask):
    """The 2D keypoint (both confidence weights), 3D keypoint, shape,
    SMPL-parameter and camera terms; an empty mask gives 0 and a zero
    gradient in both."""
    a = {k: np.asarray(v, np.float32) if v.dtype != bool else v
         for k, v in _spin_inputs().items()}
    m = a[mask]
    _hold_value_and_grad(
        lambda p: JR.keypoint_loss(p, jnp.asarray(a['kp']), 0.5, 2.0,
                                   jnp.asarray(m)),
        lambda p: PR.keypoint_loss(p, _t(a['kp']), 0.5, 2.0, _t(m)),
        a['pred_kp'])
    _hold_value_and_grad(
        lambda p: JR.keypoint_3d_loss(p, jnp.asarray(a['j3d']),
                                      jnp.asarray(m)),
        lambda p: PR.keypoint_3d_loss(p, _t(a['j3d']), _t(m)), a['pred_j'])
    _hold_value_and_grad(
        lambda p: JR.shape_loss(p, jnp.asarray(a['v']), jnp.asarray(m)),
        lambda p: PR.shape_loss(p, _t(a['v']), _t(m)), a['pred_v'])
    for i in range(2):
        _hold_value_and_grad(
            lambda r, b: JR.smpl_param_loss(
                r, b, jnp.asarray(a['opt_pose']), jnp.asarray(a['opt_betas']),
                jnp.asarray(m), jnp.asarray(a['valid']))[i],
            lambda r, b: PR.smpl_param_loss(
                r, b, _t(a['opt_pose']), _t(a['opt_betas']), _t(m),
                _t(a['valid']))[i],
            a['pred_rotmat'], a['pred_betas'])
    _hold_value_and_grad(JR.camera_depth_loss, PR.camera_depth_loss,
                         a['cam'])


def test_regressor_loss_total_and_terms_match_jax(body):
    """The weighted total and every entry of its dict, with the contact
    term on the folded bodies (HD on)."""
    a = {k: np.asarray(v, np.float32) if v.dtype != bool else v
         for k, v in _spin_inputs(1).items()}
    verts = body['verts']
    opt_v = verts + 0.01
    w = dict(shape=0.5, contact=1e-3)
    args = (a['pred_rotmat'], a['pred_betas'], a['opt_pose'], a['opt_betas'],
            a['pred_kp'], a['kp'], a['pred_j'], a['j3d'])
    want_total, want = JR.regressor_loss(
        JR.LossWeights(**w), *map(jnp.asarray, args),
        jnp.asarray(a['valid']), jnp.asarray(verts), jnp.asarray(opt_v),
        jnp.asarray(a['cam']), jnp.asarray(a['valid']),
        jnp.asarray(a['valid']), contact_assets=body['jca'],
        euclthres=EUCL, hd=body['jhd'])
    got_total, got = PR.regressor_loss(
        PR.LossWeights(**w), *map(_t, args), _t(a['valid']), _t(verts),
        _t(opt_v), _t(a['cam']), _t(a['valid']), _t(a['valid']),
        contact_assets=body['pca'], euclthres=EUCL, hd=body['phd'])
    assert set(got) == set(want)
    assert float(got['loss_contact']) > 0
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   atol=1e-9, err_msg=k)
    np.testing.assert_allclose(float(got_total), float(want_total),
                               rtol=1e-4)


CONTACT_CASES = {
    'no_hd': dict(hd=False),
    'hd': dict(hd=True),
    'hd_truncated': dict(hd=True, hd_k=96),
    'hd_candidate_k': dict(hd=True, candidate_k=60),
    'capacity': dict(hd=True, capacity=2),
    'no_hd_capacity_candidate_k': dict(hd=False, capacity=1,
                                       candidate_k=60),
}


@pytest.mark.parametrize('case', sorted(CONTACT_CASES))
def test_contact_loss_value_and_grad_match_jax(body, case):
    """contact_loss against jax.value_and_grad with respect to the
    vertices; hd_truncated_frac and contact_valid_truncated_frac equal."""
    kw = dict(CONTACT_CASES[case])
    hd = kw.pop('hd')
    valid = np.array([True, False, True])
    aux = {}

    def jax_fn(v):
        loss, aux['jax'] = JR.contact_loss(
            v, body['jca'], jnp.asarray(valid), EUCL,
            hd=body['jhd'] if hd else None, **kw)
        return loss

    def pt_fn(v):
        loss, aux['port'] = PR.contact_loss(
            v, body['pca'], _t(valid), EUCL,
            hd=body['phd'] if hd else None, **kw)
        return loss

    # HD points are barycentric sums, rounded in another order by each
    # package (~1e-7 m); the pull's slope 2 / 0.005 per metre near contact
    # turns that into ~4e-5 of gradient: HD cases at atol 1e-4
    value = _hold_value_and_grad(jax_fn, pt_fn, body['verts'],
                                 atol=1e-4 if hd else 1e-6)
    assert value > 0
    assert set(aux['port']) == set(aux['jax'])
    for k, v in aux['jax'].items():
        assert float(aux['port'][k]) == pytest.approx(float(v), abs=1e-7), k
    if case == 'hd_truncated':
        assert float(aux['port']['hd_truncated_frac']) > 0
    if 'capacity' in kw:
        assert ('contact_valid_truncated_frac' in aux['port'])


def test_masked_sq_dists_highest_matches_jax_and_keeps_the_flag():
    """The Gram form in full fp32 (JAX: Precision.HIGHEST), banned pairs
    at +inf; the global TF32 flag is as it was after the call."""
    rng = np.random.RandomState(3)
    a = rng.randn(40, 3).astype(np.float32)
    b = a[rng.permutation(40)] + 1e-3 * rng.randn(40, 3).astype(np.float32)
    allowed = rng.rand(40, 40) > 0.3
    want = np.asarray(JC.masked_sq_dists_highest(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(allowed)))
    before = torch.backends.cuda.matmul.allow_tf32
    got = PCo.masked_sq_dists_highest(_t(a), _t(b), _t(allowed)).numpy()
    assert torch.backends.cuda.matmul.allow_tf32 == before
    assert np.array_equal(np.isinf(got), ~allowed)
    assert np.isposinf(got[~allowed]).all()
    np.testing.assert_allclose(got[allowed], want[allowed], rtol=1e-5,
                               atol=1e-6)
    batched = PCo.masked_sq_dists_highest(
        _t(np.stack([a, b])), _t(np.stack([b, a])),
        _t(np.stack([allowed, allowed.T])))
    np.testing.assert_array_equal(batched[0].numpy(), got)


def test_hd_assets_from_a_dense_regressor_match_jax():
    """make_hd_assets compacts an (H, V) matrix to its k largest weights
    per row, as the JAX package's."""
    rng = np.random.RandomState(0)
    reg = rng.rand(30, 50) * (rng.rand(30, 50) > 0.8)
    faces = rng.randint(0, 50, (20, 3))
    geovec = rng.randint(0, 20, 30)
    want = JR.make_hd_assets(reg, geovec, faces)
    got = PR.make_hd_assets(reg, geovec, faces)
    for k in want._fields:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)
