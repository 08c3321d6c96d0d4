"""tuch_tpu_torch's SMPLify-DC slice against tuch_tpu, on the CPU.

Every loss of losses/smplify.py and its gradient against jax.grad, the
contact neighbour search, the two-stage fit from the same numpy init, and
the slice as a whole: synthetic dataset, crop, HMR (weights carried over
with from_jax_variables) and the fit, then the port's demo CLI. The
170-vertex synthetic body throughout; JAX runs its plain paths (there is
no TPU here), which are the reference semantics.
"""

import io
import os
import tempfile
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tuch_tpu import assets as jax_assets
from tuch_tpu.fitting import smplify_dc as JF
from tuch_tpu.losses import smplify as JL
from tuch_tpu.losses.prior import create_gmm_prior as jax_create_prior
from tuch_tpu.losses.prior import gmm_prior_nll as jax_gmm_nll
from tuch_tpu.models.smpl import smpl_forward as jax_smpl_forward
from tuch_tpu.ops import contact as JC
from tuch_tpu.ops.segments import build_segment_tables as jax_build_tables
from tuch_tpu.utils.projection import perspective_projection
from tuch_tpu_torch import assets as pt_assets
from tuch_tpu_torch.fitting import smplify_dc as PF
from tuch_tpu_torch.losses import smplify as PL
from tuch_tpu_torch.losses.prior import gmm_prior_nll
from tuch_tpu_torch.models.convert import (contact_assets_from_numpy,
                                           prior_from_numpy)
from tuch_tpu_torch.models.smpl import SMPL, smpl_forward
from tuch_tpu_torch.ops.adam import Adam

B = 2
EUCL = 0.02


def _t(x, dtype=None):
    out = torch.from_numpy(np.array(x, copy=True))
    return out if dtype is None else out.to(dtype)


@pytest.fixture(scope='module')
def problem():
    """Both packages' body, prior and contact assets (segments on), and a
    fitting problem: keypoints projected from a prior-mean pose, an init
    perturbed from it, and a random pose that folds the body."""
    model, extras = jax_assets.synthetic_smpl(num_verts=170, seed=0)
    jprior = jax_create_prior(jax_assets.synthetic_gmm_prior(dim=69))
    ia, ib, ma, mb = JC.build_region_pairs(extras.contact_classes,
                                           extras.contact_csig)
    V = model.v_template.shape[0]
    tables = jax_build_tables(extras.segments, np.asarray(model.faces), V)
    jca = JL.ContactAssets(
        geomask=jnp.asarray(extras.geodists > 0.3),
        faces=jnp.asarray(model.faces), region_idx_a=jnp.asarray(ia),
        region_idx_b=jnp.asarray(ib), region_mask_a=jnp.asarray(ma),
        region_mask_b=jnp.asarray(mb), segment_tables=tables)
    # the port's state, carried across from the JAX package's arrays
    fields = {k: np.asarray(v) for k, v in jca._asdict().items()
              if k != 'segment_tables'}
    pca = contact_assets_from_numpy(fields, tables._asdict())
    pprior = prior_from_numpy(*(np.asarray(x) for x in jprior))
    psmpl = SMPL(pt_assets.synthetic_smpl(num_verts=170)[0])

    rng = np.random.RandomState(0)
    gt_pose = np.zeros((B, 72), np.float32)
    gt_pose[:, 3:] = np.asarray(jprior.means)[0] * 0.5
    betas = np.zeros((B, 10), np.float32)
    out = jax_smpl_forward(model, jnp.asarray(betas),
                           jnp.asarray(gt_pose[:, 3:]),
                           jnp.asarray(gt_pose[:, :3]))
    t_gt = np.tile(np.array([[0.0, 0.0, 20.0]], np.float32), (B, 1))
    cc = np.full((B, 2), 112.0, np.float32)
    proj = perspective_projection(
        out.joints, jnp.tile(jnp.eye(3)[None], (B, 1, 1)),
        jnp.asarray(t_gt), 5000.0, jnp.asarray(cc))
    kp2d = np.concatenate([np.asarray(proj), np.ones((B, 49, 1))],
                          axis=-1).astype(np.float32)
    kp2d[:, ::3, 2] = 0.5
    init_pose = gt_pose + rng.randn(B, 72).astype(np.float32) * 0.1
    # folds the random-LBS body through itself: 10 and 14 vertices with a
    # winding number above 0.99, none within 7e-3 of it
    fold_pose = (np.random.RandomState(2).randn(B, 72) * 1.5).astype(
        np.float32)
    gt_contact = np.zeros((B, len(extras.contact_classes)), np.float32)
    gt_contact[:, 0] = 1.0
    gt_contact[1, 5] = 1.0
    return dict(model=model, jprior=jprior, jca=jca, pca=pca, pprior=pprior,
                psmpl=psmpl, gt_pose=gt_pose, betas=betas, t_gt=t_gt, cc=cc,
                kp2d=kp2d, init_pose=init_pose, fold_pose=fold_pose,
                gt_contact=gt_contact)


def _grad_pair(jax_fn, torch_fn, *arrays):
    """Values and gradients of a scalar function of numpy arrays in both
    packages."""
    want, gwant = jax.value_and_grad(jax_fn, argnums=tuple(
        range(len(arrays))))(*(jnp.asarray(a) for a in arrays))
    leaves = [_t(a).requires_grad_(True) for a in arrays]
    got = torch_fn(*leaves)
    ggot = torch.autograd.grad(got, leaves)
    return (float(got.detach()), [g.numpy() for g in ggot],
            float(want), [np.asarray(g) for g in gwant])


def _hold(got, ggot, want, gwant, rtol=1e-4, atol=1e-6):
    np.testing.assert_allclose(got, want, rtol=rtol)
    for a, b in zip(ggot, gwant):
        np.testing.assert_allclose(a, b, rtol=rtol,
                                   atol=atol * max(1.0, np.abs(b).max()))


# ---------------------------------------------------------------------------
# losses and gradients (rtol 1e-4; gradients atol 1e-6 of their largest)
# ---------------------------------------------------------------------------

def test_robust_error_and_pose_priors_match_jax(problem):
    x = np.linspace(-300, 300, 41, dtype=np.float32)
    np.testing.assert_allclose(PL.gmof(_t(x), 100.0).numpy(),
                               np.asarray(JL.gmof(jnp.asarray(x), 100.0)),
                               rtol=1e-6)
    pose = problem['fold_pose'][:, 3:]
    _hold(*_grad_pair(lambda p: JL.angle_prior(p).sum(),
                      lambda p: PL.angle_prior(p).sum(), pose))
    _hold(*_grad_pair(lambda p: jax_gmm_nll(problem['jprior'], p).sum(),
                      lambda p: gmm_prior_nll(problem['pprior'], p).sum(),
                      pose))


def _joints(problem, pose, betas, which):
    if which == 'jax':
        return jax_smpl_forward(problem['model'], betas, pose[:, 3:],
                                pose[:, :3])
    return smpl_forward(problem['psmpl'], betas, pose[:, 3:], pose[:, :3])


def test_camera_fitting_loss_and_grad_match_jax(problem):
    p = problem
    args = (p['init_pose'], p['betas'] + 0.1, p['t_gt'] + 0.3)

    def jax_fn(pose, betas, cam_t):
        out = _joints(p, pose, betas, 'jax')
        return JL.camera_fitting_loss(
            out.joints, betas, cam_t, jnp.asarray(p['t_gt']),
            jnp.asarray(p['cc']), jnp.asarray(p['kp2d'][..., :2]),
            jnp.asarray(p['kp2d'][..., 2]), shape_prior_weight=1.0)

    def pt_fn(pose, betas, cam_t):
        out = _joints(p, pose, betas, 'torch')
        return PL.camera_fitting_loss(
            out.joints, betas, cam_t, _t(p['t_gt']), _t(p['cc']),
            _t(p['kp2d'][..., :2]), _t(p['kp2d'][..., 2]),
            shape_prior_weight=1.0)

    _hold(*_grad_pair(jax_fn, pt_fn, *args))


@pytest.mark.parametrize('output', ['sum', 'reprojection'])
def test_body_fitting_loss_and_grad_match_jax(problem, output):
    p = problem

    def jax_fn(pose, betas):
        out = _joints(p, pose, betas, 'jax')
        return JL.body_fitting_loss(
            pose[:, 3:], betas, out.joints, jnp.asarray(p['t_gt']),
            jnp.asarray(p['cc']), jnp.asarray(p['kp2d'][..., :2]),
            jnp.asarray(p['kp2d'][..., 2]), p['jprior'],
            output=output).sum()

    def pt_fn(pose, betas):
        out = _joints(p, pose, betas, 'torch')
        return PL.body_fitting_loss(
            pose[:, 3:], betas, out.joints, _t(p['t_gt']), _t(p['cc']),
            _t(p['kp2d'][..., :2]), _t(p['kp2d'][..., 2]), p['pprior'],
            output=output).sum()

    _hold(*_grad_pair(jax_fn, pt_fn, p['init_pose'], p['betas'] + 0.1))


def _fold_verts(problem, which):
    p = problem
    pose = p['fold_pose']
    if which == 'jax':
        return _joints(p, jnp.asarray(pose), jnp.asarray(p['betas']),
                       'jax').vertices
    with torch.no_grad():
        return _joints(p, _t(pose), _t(p['betas']), 'torch').vertices


@pytest.mark.parametrize('candidate_k', [0, 40])
def test_contact_neighbors_match_jax(problem, candidate_k):
    """Equal exterior flags (the winding values agree to ~1e-6, far from
    the 0.99 bar here) and equal argmin (the exact first minimum on both
    sides); candidate_k with a sticky previous exterior."""
    jv, pv = _fold_verts(problem, 'jax'), _fold_verts(problem, 'torch')
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), atol=1e-5)
    prev = None
    if candidate_k:
        prev = np.asarray(JL.contact_neighbors(jv, problem['jca'])[0])
    jext, jarg = JL.contact_neighbors(
        jv, problem['jca'], candidate_k=candidate_k,
        prev_exterior=None if prev is None else jnp.asarray(prev))
    pext, parg = PL.contact_neighbors(
        pv, problem['pca'], candidate_k=candidate_k,
        prev_exterior=None if prev is None else _t(prev))
    np.testing.assert_array_equal(pext.numpy(), np.asarray(jext))
    np.testing.assert_array_equal(parg.numpy(), np.asarray(jarg))
    assert (~pext.numpy()).any() and pext.numpy().any()


@pytest.mark.parametrize('euclthres,capacity', [(EUCL, 0), (0.0, 0),
                                                (EUCL, 1)])
def test_contact_fitting_loss_and_grad_match_jax(problem, euclthres,
                                                 capacity):
    """The stage-2 loss with contact at the folded pose (push and pull
    both active), its gradient in pose, and the compacted sub-batch."""
    p = problem
    ignore = np.array([False, capacity > 0])
    has_dc = np.array([True, True])
    jidx = pidx = None
    if capacity:
        jidx = JL.compact_take(jnp.asarray(~ignore), capacity)
        pidx = PL.compact_take(_t(~ignore), capacity)
        np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))

    def jax_fn(pose):
        out = _joints(p, pose, jnp.asarray(p['betas']), 'jax')
        return JL.contact_fitting_loss(
            pose[:, 3:], pose[:, :3], jnp.asarray(p['betas']), out.joints,
            out.vertices, jnp.asarray(p['t_gt']), jnp.asarray(p['cc']),
            jnp.asarray(p['kp2d'][..., :2]), jnp.asarray(p['kp2d'][..., 2]),
            p['jprior'], p['jca'], jnp.asarray(p['gt_contact']),
            jnp.asarray(ignore), jnp.asarray(has_dc), euclthres,
            contact_loss_weight=2000.0, compact_idx=jidx)

    def pt_fn(pose):
        out = _joints(p, pose, _t(p['betas']), 'torch')
        return PL.contact_fitting_loss(
            pose[:, 3:], pose[:, :3], _t(p['betas']), out.joints,
            out.vertices, _t(p['t_gt']), _t(p['cc']),
            _t(p['kp2d'][..., :2]), _t(p['kp2d'][..., 2]), p['pprior'],
            p['pca'], _t(p['gt_contact']), _t(ignore), _t(has_dc),
            euclthres, contact_loss_weight=2000.0, compact_idx=pidx)

    _hold(*_grad_pair(jax_fn, pt_fn, p['fold_pose']))


def test_push_pull_and_zero_safe_norm_match_jax():
    rng = np.random.RandomState(5)
    diff = rng.randn(B, 30, 3).astype(np.float32) * 0.02
    diff[0, :4] = 0.0                   # coincident pairs: zero gradient
    ext = rng.rand(B, 30) > 0.3
    inc = rng.rand(B, 30) > 0.5

    def jax_fn(d):
        return JL.push_pull_terms(jnp.asarray(ext), JL.zero_safe_norm(d),
                                  jnp.asarray(inc)).sum()

    def pt_fn(d):
        return PL.push_pull_terms(_t(ext), PL.zero_safe_norm(d),
                                  _t(inc)).sum()

    got, (g,), want, gwant = _grad_pair(jax_fn, pt_fn, diff)
    _hold(got, [g], want, gwant)
    assert np.isfinite(g).all() and (g[0, :4] == 0).all()


def test_compact_take_and_overflow_match_jax():
    active = np.array([False, True, True, False, True, True])
    for cap in (1, 3, 6):
        np.testing.assert_array_equal(
            PL.compact_take(_t(active), cap).numpy(),
            np.asarray(JL.compact_take(jnp.asarray(active), cap)))
        assert float(PL.compact_overflow_frac(_t(active), cap)) == float(
            JL.compact_overflow_frac(jnp.asarray(active), cap))


def test_adam_matches_optax():
    rng = np.random.RandomState(6)
    params = {'a': rng.randn(3, 4).astype(np.float32),
              'b': rng.randn(5).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(4)]
    opt = optax.adam(1e-2, b1=0.9, b2=0.999)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jp)
    pp = {k: _t(v) for k, v in params.items()}
    adam = Adam(pp, 1e-2)
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                state)
        jp = optax.apply_updates(jp, upd)
        adam.step(pp, {k: _t(v) for k, v in g.items()})
    for k in params:
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the fit
# ---------------------------------------------------------------------------

FIT_CASES = {
    'reference': dict(),
    'candidate_k': dict(contact_candidate_k=40),
    'capacity': dict(contact_capacity=1),
    'no_contact': dict(use_contact=False),
}


@pytest.mark.parametrize('case', list(FIT_CASES))
def test_smplify_dc_matches_jax(problem, case):
    """Both fits from the same numpy init, 3 iterations per stage, contact
    refreshed every step: vertices at atol 1e-3 (the vertex bar), the
    rest at the same bar."""
    p = problem
    kw = dict(num_iters=3, euclthres=EUCL, contact_loss_weight=2000.0,
              exterior_refresh_every=1, collect_trajectory=True)
    kw.update(FIT_CASES[case])
    ignore = np.array([False, case == 'capacity'])
    has_dc = np.array([True, False])
    has_kp = np.array([False, True])
    init = (p['fold_pose'] * 0.5, p['betas'], p['t_gt'] + 0.5, p['cc'],
            p['kp2d'], p['gt_contact'], ignore, has_dc, has_kp)
    want = JF.smplify_dc(p['model'], p['jprior'], p['jca'],
                         *(jnp.asarray(a) for a in init),
                         config=JF.SMPLifyConfig(**kw))
    got = PF.smplify_dc(p['psmpl'], p['pprior'], p['pca'],
                        *(_t(a) for a in init),
                        config=PF.SMPLifyConfig(**kw))
    for name in ('vertices', 'joints', 'pose', 'betas',
                 'camera_translation', 'trajectory'):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-3, err_msg=name)
    np.testing.assert_allclose(got.reprojection_loss.numpy(),
                               np.asarray(want.reprojection_loss),
                               rtol=1e-3, atol=1e-3)
    if case == 'capacity':
        assert float(got.contact_truncated_frac) == float(
            want.contact_truncated_frac)
    jl = JF.get_fitting_loss(p['model'], p['jprior'], want.pose,
                             want.betas, want.camera_translation,
                             jnp.asarray(p['cc']), jnp.asarray(p['kp2d']),
                             jnp.asarray(has_kp))
    pl_ = PF.get_fitting_loss(p['psmpl'], p['pprior'], got.pose, got.betas,
                              got.camera_translation, _t(p['cc']),
                              _t(p['kp2d']), _t(has_kp))
    np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize('use_contact', [True, False],
                         ids=['contact', 'no_contact'])
def test_smplify_dc_leaves_its_start_unchanged(problem, use_contact):
    """Adam steps in place on the fit's own clones: the caller's start (a
    non-contiguous init_pose view, init_betas, init_cam_t) is read and
    never written, and the fit from it is the fit from contiguous copies
    bit for bit."""
    p = problem
    config = PF.SMPLifyConfig(num_iters=2, euclthres=EUCL,
                              contact_loss_weight=2000.0,
                              use_contact=use_contact)
    wide = _t(np.concatenate([p['fold_pose'] * 0.5,
                              np.ones((B, 5), np.float32)], axis=1))
    init_pose = wide[:, :72]
    assert not init_pose.is_contiguous()
    init_betas, init_cam_t = _t(p['betas'] + 0.1), _t(p['t_gt'] + 0.5)
    rest = (_t(p['cc']), _t(p['kp2d']), _t(p['gt_contact']),
            _t(np.zeros(B, bool)), _t(np.array([True, False])),
            _t(np.array([False, True])))
    start = (wide, init_betas, init_cam_t)
    before = [t.clone() for t in start]
    got = PF.smplify_dc(p['psmpl'], p['pprior'], p['pca'], init_pose,
                        init_betas, init_cam_t, *rest, config=config)
    for t, b in zip(start, before):
        assert torch.equal(t, b)
    want = PF.smplify_dc(p['psmpl'], p['pprior'], p['pca'],
                         before[0][:, :72].contiguous(), before[1].clone(),
                         before[2].clone(), *rest, config=config)
    for name in ('vertices', 'pose', 'betas', 'camera_translation',
                 'reprojection_loss'):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert not torch.equal(got.camera_translation, init_cam_t)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

def test_runtime_contact_state_matches_jax_runtime():
    """build_runtime(with_contact=True) holds the JAX runtime's contact
    assets and prior, value for value."""
    from tuch_tpu import runtime as jrt
    from tuch_tpu_torch import runtime as prt
    want = jrt.build_runtime(synthetic=True, num_verts=170, img_res=64,
                             with_hd=False)
    got = prt.build_runtime(device='cpu', synthetic=True, num_verts=170,
                            with_contact=True)
    wc, gc = want.assets.contact, got.contact
    assert gc.geomask.dtype == torch.uint8 and gc.geomask.is_contiguous()
    np.testing.assert_array_equal(gc.geomask.numpy().astype(bool),
                                  np.asarray(wc.geomask))
    for name in ('faces', 'region_idx_a', 'region_idx_b', 'region_mask_a',
                 'region_mask_b'):
        np.testing.assert_array_equal(getattr(gc, name).numpy(),
                                      np.asarray(getattr(wc, name)))
    for name in ('fused_vidx', 'fused_faces', 'fused_vmask', 'ring_w'):
        np.testing.assert_array_equal(
            getattr(gc.segment_tables, name).numpy(),
            getattr(wc.segment_tables, name))
    for a, b in zip(got.prior, want.assets.prior):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert list(got.contact_classes) == list(want.contact_classes)
    plain = prt.build_runtime(device='cpu', synthetic=True, num_verts=170)
    assert plain.contact is None and plain.prior is None


def test_demo_pipeline_matches_jax():
    """synthetic_db -> TuchDataset.get -> HMR (ResNet-50, the JAX weights
    carried over) -> smplify_dc, at img_res 64 for 2 iterations: the crops
    at atol 5e-4, the HMR init at 1e-4, the fit's vertices at 1e-3."""
    from tuch_tpu import config as jcfg
    from tuch_tpu import constants as jconst
    from tuch_tpu import runtime as jrt
    from tuch_tpu.data.dataset import TuchDataset as JDataset
    from tuch_tpu.data.dataset import synthetic_db as jax_db
    from tuch_tpu.utils.projection import weak_perspective_to_translation
    from tuch_tpu.utils.rotations import rotmat_to_aa
    from tuch_tpu_torch import config as pcfg
    from tuch_tpu_torch import runtime as prt
    from tuch_tpu_torch.cli import demo_smplify_dc as demo
    from tuch_tpu_torch.models.convert import from_jax_variables
    from tuch_tpu_torch.runtime import load_hmr_weights

    argv = ['--synthetic', '--synthetic_num_verts', '170', '--img_res', '64',
            '--num_images', '2', '--num_smplify_iters', '2']
    jargs = jcfg.parse_config(jcfg.SMPLifyDemoConfig, argv, finalize=False)
    pargs = pcfg.parse_config(pcfg.SMPLifyDemoConfig, argv + ['--device',
                                                              'cpu'])
    # the JAX demo's computation, without its renders
    jrun = jrt.build_runtime(synthetic=True, num_verts=170, img_res=64,
                             with_hd=False)
    P = len(jrun.contact_classes)
    with tempfile.TemporaryDirectory() as d:
        db = jax_db(2, img_dir=d, seed=0, num_contact_classes=P)
        ds = JDataset(jargs, jargs.ds_names[0], data=db, img_dir=d,
                      use_augmentation=False)
        samples = [ds.get(i) for i in range(2)]
    batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    rotmat, jbetas, cam = jrun.hmr.apply(jrun.variables,
                                         jnp.asarray(batch['img']),
                                         train=False)
    jcam_t = weak_perspective_to_translation(cam, jconst.FOCAL_LENGTH, 64)
    jpose = jnp.nan_to_num(rotmat_to_aa(rotmat)).reshape(-1, 72)
    kp_px = batch['keypoints'].copy()
    kp_px[..., :2] = 0.5 * 64 * (kp_px[..., :2] + 1.0)
    cfg = JF.SMPLifyConfig(num_iters=2, use_contact=True, euclthres=0.0,
                           contact_loss_weight=2000.0,
                           collect_trajectory=True)
    want = JF.smplify_dc(
        jrun.smpl, jrun.assets.prior, jrun.assets.contact, jpose, jbetas,
        jcam_t, jnp.full((2, 2), 32.0), jnp.asarray(kp_px),
        jnp.asarray(batch['contact_vec']), jnp.zeros(2, bool),
        jnp.asarray(batch['has_disc_contact']).astype(bool),
        jnp.asarray(batch['has_gt_kpts']).astype(bool), config=cfg)

    prun = prt.build_runtime(device='cpu', synthetic=True, num_verts=170,
                             with_contact=True)
    load_hmr_weights(prun.hmr, from_jax_variables(jrun.variables))
    got = demo.run(pargs, runtime=prun)
    # the JAX package crops with its C++ warp where it builds, the port
    # with numpy: they round differently (5e-4 of a normalised pixel)
    np.testing.assert_allclose(got.batch['img'], batch['img'], atol=5e-4)
    for k in ('keypoints', 'contact_vec', 'has_disc_contact'):
        np.testing.assert_allclose(got.batch[k], batch[k], atol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(got.init_pose.numpy(), np.asarray(jpose),
                               atol=1e-4)
    np.testing.assert_allclose(got.init_cam_t.numpy(), np.asarray(jcam_t),
                               rtol=1e-4)
    np.testing.assert_allclose(got.result.vertices.numpy(),
                               np.asarray(want.vertices), atol=1e-3)
    V = got.result.vertices.shape[1]
    assert got.result.trajectory.shape == (2, 2, V, 3)


def test_demo_cli_runs_on_cpu(tmp_path, monkeypatch):
    from tuch_tpu_torch.cli import demo_smplify_dc as demo
    monkeypatch.chdir(tmp_path)
    buf = io.StringIO()
    with redirect_stdout(buf):
        demo.main(['--synthetic', '--device', 'cpu', '--synthetic_num_verts',
                   '170', '--img_res', '64', '--num_images', '2',
                   '--num_smplify_iters', '2'])
    lines = buf.getvalue().splitlines()
    loss = [ln for ln in lines if ln.startswith('reprojection loss:')]
    assert len(loss) == 1 and 'nan' not in loss[0]
    # the renders, into log_dir/name as the JAX demo writes them
    out = tmp_path / 'logs' / 'tuch'
    assert f'saved fits to {out}' in lines
    assert sorted(os.listdir(out)) == [
        f'{i:04d}_{k}.png' for i in range(2) for k in ('fit', 'opti')]


def test_demo_without_device_raises_when_cuda_is_absent(monkeypatch):
    from tuch_tpu_torch.cli import demo_smplify_dc as demo
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        demo.main(['--synthetic', '--synthetic_num_verts', '170'])


# ---------------------------------------------------------------------------
# data pipeline and real-asset contact state
# ---------------------------------------------------------------------------

def _options(**kw):
    from types import SimpleNamespace
    base = dict(img_res=64, seed=3, noise_factor=0.4, rot_factor=30.0,
                scale_factor=0.25, ignore_3d=False, rotate_pose_3d=True)
    base.update(kw)
    return SimpleNamespace(**base)


def test_dataset_get_with_augmentation_matches_jax(tmp_path):
    """Augmented samples (crc32-keyed flips, rotations, scales, channel
    noise) of both packages' TuchDataset: the same draws, keypoints, pose,
    3D joints and contact labels at atol 1e-4 and crops at 5e-4 (the JAX
    package's C++ warp against the port's numpy one)."""
    from tuch_tpu.data import dataset as JD
    from tuch_tpu_torch.data import dataset as PD
    want_db = JD.synthetic_db(6, img_dir=str(tmp_path), seed=4,
                              with_pose_3d=True)
    got_db = PD.synthetic_db(6, seed=4, with_pose_3d=True)
    for k, v in want_db.items():
        assert np.array_equal(got_db[k], v), k
    want_db['has_smpl'] = np.array([1, 0, 1, 1, 0, 1], np.float32)
    opts = _options()
    jds = JD.TuchDataset(opts, 'mpi-inf-3dhp', data=want_db,
                         img_dir=str(tmp_path))
    pds = PD.TuchDataset(opts, 'mpi-inf-3dhp', data=want_db,
                         img_dir=str(tmp_path))
    draws = [jds.augm_params(i, 2) for i in range(6)]
    assert any(d[0] for d in draws) and any(d[2] for d in draws)
    for i in range(6):
        for a, b in zip(pds.augm_params(i, 2), draws[i]):
            np.testing.assert_array_equal(a, b)
        want, got = jds.get(i, epoch=2), pds.get(i, epoch=2)
        assert want.keys() == got.keys()
        np.testing.assert_allclose(got['img'], want['img'], atol=5e-4)
        for k in want:
            if k != 'img':
                np.testing.assert_allclose(got[k], want[k], atol=1e-4,
                                           err_msg=k)
    # and the discrete-contact layout (mirrored labels under a flip)
    dsc = PD.TuchDataset(opts, 'dsc_lsp', data=want_db,
                         img_dir=str(tmp_path))
    jdsc = JD.TuchDataset(opts, 'dsc_lsp', data=want_db,
                          img_dir=str(tmp_path))
    for i in range(6):
        np.testing.assert_array_equal(dsc.get(i, 1)['contact_vec'],
                                      jdsc.get(i, 1)['contact_vec'])


def test_pose_and_rotation_transforms_match_jax():
    from tuch_tpu.data import transforms as JT
    from tuch_tpu_torch.data import transforms as PT
    rng = np.random.RandomState(8)
    for trial in range(6):
        pose = (rng.randn(72) * 0.5).astype(np.float32)
        if trial == 0:
            pose[:3] = np.array([np.pi - 1e-7, 0, 0], np.float32)
        rot = float(rng.uniform(-60, 60))
        for flip in (False, True):
            np.testing.assert_allclose(PT.pose_processing(pose, rot, flip),
                                       JT.pose_processing(pose, rot, flip),
                                       atol=1e-5)
            S = rng.randn(24, 4).astype(np.float32)
            np.testing.assert_allclose(
                PT.j3d_processing(S, rot, flip, apply_rotation=True),
                JT.j3d_processing(S, rot, flip, apply_rotation=True),
                atol=1e-6)


def test_project_db_keypoints_and_load_db_match_jax(tmp_path):
    from tuch_tpu.data import dataset as JD
    from tuch_tpu_torch.data import dataset as PD
    model, _ = jax_assets.synthetic_smpl(num_verts=170, seed=0)
    db = PD.synthetic_db(3, seed=2)
    want = JD.project_db_keypoints(db, model, seed=5)
    got = PD.project_db_keypoints(
        db, SMPL(pt_assets.synthetic_smpl(num_verts=170)[0]), seed=5)
    for k in ('openpose', 'part'):
        np.testing.assert_allclose(got[k], want[k], atol=1e-3)
    path = str(tmp_path / 'db.npz')
    np.savez(path, **db)
    back = PD.load_db(path)
    for k, v in JD.load_db(path).items():
        np.testing.assert_array_equal(back[k], v)


def test_runtime_real_contact_assets_match_jax(tmp_path, monkeypatch):
    """Real-asset mode with contact: the GMM pickle, the geodesic matrix
    and the region tables on disk give both runtimes the same state."""
    import pickle

    from tests.test_torch_port_ops import _write_real_assets
    from tuch_tpu import config as jcfg
    from tuch_tpu import runtime as jrt
    from tuch_tpu_torch import config as pcfg
    from tuch_tpu_torch import runtime as prt
    model, extras = jax_assets.synthetic_smpl(num_verts=170, seed=0)
    smpl_dir, spin = _write_real_assets(tmp_path, model)
    gmm = jax_assets.synthetic_gmm_prior()
    with open(spin / 'gmm_08.pkl', 'wb') as f:
        pickle.dump({'means': gmm['means'], 'covars': gmm['covs'],
                     'weights': gmm['weights']}, f)
    geo = tmp_path / 'geodesics.npy'
    np.save(geo, extras.geodists)
    dsc = tmp_path / 'dsc_release'
    dsc.mkdir()
    with open(dsc / 'classes.pkl', 'wb') as f:
        pickle.dump(extras.contact_classes, f)
    with open(dsc / 'ContactSigSMPL.pkl', 'wb') as f:
        pickle.dump(extras.contact_csig, f)
    paths = dict(SMPL_MODEL_DIR=str(smpl_dir), PRIOR_FOLDER=str(spin),
                 JOINT_REGRESSOR_TRAIN_EXTRA=str(spin / 'J_regressor_extra'
                                                 '.npy'),
                 SMPL_MEAN_PARAMS=str(spin / 'smpl_mean_params.npz'),
                 GEODESICS_SMPL=str(geo), DSC_ROOT=str(dsc))
    for mod in (jcfg, pcfg):
        for k, v in paths.items():
            monkeypatch.setattr(mod, k, v)
    want = jrt.build_runtime(synthetic=False, img_res=64, with_hd=False,
                             with_segments=False)
    got = prt.build_runtime(device='cpu', synthetic=False,
                            backbone='vit_t8', with_contact=True)
    wc, gc = want.assets.contact, got.contact
    assert gc.segment_tables is None and wc.segment_tables is None
    for name in ('geomask', 'faces', 'region_idx_a', 'region_idx_b',
                 'region_mask_a', 'region_mask_b'):
        np.testing.assert_array_equal(
            getattr(gc, name).numpy().astype(np.asarray(
                getattr(wc, name)).dtype), np.asarray(getattr(wc, name)))
    for a, b in zip(got.prior, want.assets.prior):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
