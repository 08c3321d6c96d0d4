"""tuch_tpu_torch against tuch_tpu: rotations, body model, attention.

The same numpy inputs from a seed go through the JAX function and its
counterpart in the port, on the CPU. The attention kernel's own tests are
in test_torch_port_kernels.py, which imports no JAX.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tuch_tpu import assets as jax_assets
from tuch_tpu.models import smpl as jax_smpl
from tuch_tpu.ops import attention_pallas as jax_attn
from tuch_tpu.utils import projection as jax_proj
from tuch_tpu.utils import rotations as jax_rot
from tuch_tpu_torch import assets as pt_assets
from tuch_tpu_torch.models import smpl as pt_smpl
from tuch_tpu_torch.ops import attention as pt_attn
from tuch_tpu_torch.utils import projection as pt_proj
from tuch_tpu_torch.utils import rotations as pt_rot

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _aa_batch(rng):
    """Axis-angle vectors spanning generic, near-identity and near-pi."""
    axes = rng.randn(24, 3)
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = np.concatenate([rng.uniform(0.1, 3.0, 12),
                             [0.0, 1e-7, 1e-5, 1e-3],
                             np.pi - np.array([1e-2, 1e-3, 5e-4, 1e-4]),
                             [np.pi - 2e-2, 2.5, 3.1, 3.13]])
    return (axes * angles[:, None]).astype(np.float32)


# ---------------------------------------------------------------------------
# rotations and projection
# ---------------------------------------------------------------------------

def test_batch_rodrigues_matches_jax():
    aa = _aa_batch(np.random.RandomState(0))
    want = np.asarray(jax_rot.batch_rodrigues(jnp.asarray(aa)))
    got = pt_rot.batch_rodrigues(_t(aa)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_rot6d_to_rotmat_matches_jax():
    x = np.random.RandomState(1).randn(5, 144).astype(np.float32)
    want = np.asarray(jax_rot.rot6d_to_rotmat(jnp.asarray(x)))
    got = pt_rot.rot6d_to_rotmat(_t(x)).numpy()
    assert got.shape == (5 * 24, 3, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_rotmat_to_aa_matches_jax_near_identity_and_pi():
    aa = _aa_batch(np.random.RandomState(2))
    R = np.asarray(jax_rot.batch_rodrigues(jnp.asarray(aa)))
    want = np.asarray(jax_rot.rotmat_to_aa(jnp.asarray(R)))
    got = pt_rot.rotmat_to_aa(_t(R)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5)
    # quaternions, including the sign canonicalisation, agree as well
    np.testing.assert_allclose(
        pt_rot.rotmat_to_quat(_t(R)).numpy(),
        np.asarray(jax_rot.rotmat_to_quat(jnp.asarray(R))), atol=1e-5)


def test_projection_matches_jax():
    rng = np.random.RandomState(3)
    cam = np.concatenate([rng.uniform(0.5, 1.5, (4, 1)),
                          rng.randn(4, 2) * 0.1], 1).astype(np.float32)
    np.testing.assert_allclose(
        pt_proj.weak_perspective_to_translation(_t(cam), 5000.0, 224).numpy(),
        np.asarray(jax_proj.weak_perspective_to_translation(
            jnp.asarray(cam), 5000.0, 224)), rtol=1e-6)
    pts = (rng.randn(4, 7, 3) * 0.3 + [0, 0, 5]).astype(np.float32)
    rot = np.asarray(jax_rot.batch_rodrigues(
        jnp.asarray(rng.randn(4, 3).astype(np.float32) * 0.2)))
    trans = rng.randn(4, 3).astype(np.float32) * 0.1
    center = rng.uniform(100, 120, (4, 2)).astype(np.float32)
    np.testing.assert_allclose(
        pt_proj.perspective_projection(_t(pts), _t(rot), _t(trans), 5000.0,
                                       _t(center)).numpy(),
        np.asarray(jax_proj.perspective_projection(
            jnp.asarray(pts), jnp.asarray(rot), jnp.asarray(trans), 5000.0,
            jnp.asarray(center))), rtol=1e-5, atol=1e-3)


# ---------------------------------------------------------------------------
# synthetic body and SMPL
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def bodies():
    jax_model, extras = jax_assets.synthetic_smpl(num_verts=170, seed=0)
    pt_model, means = pt_assets.synthetic_smpl(num_verts=170, seed=0)
    return jax_model, extras, pt_model, means


def test_synthetic_smpl_bitwise_equal(bodies):
    jax_model, extras, pt_model, means = bodies
    for name in pt_assets.SMPLModel._fields:
        a, b = np.asarray(getattr(jax_model, name)), getattr(pt_model, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name
    for name in means._fields:
        assert np.array_equal(getattr(extras, name), getattr(means, name))


def test_uv_sphere_full_topology_matches_jax():
    v_j, f_j = jax_assets.uv_sphere(82, 86)
    v_p, f_p = pt_assets.uv_sphere(82, 86)
    assert v_p.shape == (6890, 3) and f_p.shape == (13776, 3)
    assert np.array_equal(v_j, v_p) and np.array_equal(f_j, f_p)


def _write_real_assets(root, model):
    """A chumpy-format SMPL pkl, J_regressor_extra.npy and
    smpl_mean_params.npz in the reference's on-disk layout."""
    import pickle
    jax_assets._install_chumpy_stub()
    import chumpy  # the stub: pickles as chumpy.ch.Ch, like real SMPL pkls
    v_template = chumpy.ch.Ch()
    v_template.__dict__['x'] = np.asarray(model.v_template)
    V, _, P = model.posedirs.shape
    kintree = np.zeros((2, 24), np.int64)
    kintree[0] = np.concatenate([[2 ** 32 - 1], model.parents[1:]])
    smpl_dir = root / 'models' / 'smpl'
    spin = root / 'essentials' / 'spin'
    smpl_dir.mkdir(parents=True)
    spin.mkdir(parents=True)
    with open(smpl_dir / 'SMPL_NEUTRAL.pkl', 'wb') as f:
        pickle.dump({'v_template': v_template,
                     'shapedirs': np.asarray(model.shapedirs),
                     # the alternate (P, V*3) posedirs layout
                     'posedirs': np.asarray(model.posedirs).transpose(
                         2, 0, 1).reshape(P, V * 3),
                     'J_regressor': np.asarray(model.J_regressor),
                     'weights': np.asarray(model.lbs_weights),
                     'kintree_table': kintree,
                     'f': np.asarray(model.faces)}, f)
    np.save(spin / 'J_regressor_extra.npy',
            np.asarray(model.J_regressor_extra))
    rng = np.random.RandomState(6)
    np.savez(spin / 'smpl_mean_params.npz', pose=rng.randn(1, 144),
             shape=rng.randn(1, 10), cam=rng.randn(3))
    return smpl_dir, spin


def test_real_asset_loaders_match_jax(bodies, tmp_path, monkeypatch):
    from tuch_tpu_torch import config as pt_cfg
    from tuch_tpu_torch.runtime import build_runtime
    jax_model = bodies[0]
    smpl_dir, spin = _write_real_assets(tmp_path, jax_model)
    pkl, extra = str(smpl_dir / 'SMPL_NEUTRAL.pkl'), str(
        spin / 'J_regressor_extra.npy')
    want = jax_assets.load_extra_joint_regressor(
        jax_assets.load_smpl_pkl(pkl), extra)
    got = pt_assets.load_extra_joint_regressor(
        pt_assets.load_smpl_pkl(pkl), extra)
    for name in pt_assets.SMPLModel._fields:
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)), name)
    means = str(spin / 'smpl_mean_params.npz')
    for a, b in zip(pt_assets.load_mean_params(means),
                    jax_assets.load_mean_params(means)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)

    # the runtime finds them and picks the real assets on its own
    monkeypatch.setattr(pt_cfg, 'SMPL_MODEL_DIR', str(smpl_dir))
    monkeypatch.setattr(pt_cfg, 'JOINT_REGRESSOR_TRAIN_EXTRA', extra)
    monkeypatch.setattr(pt_cfg, 'SMPL_MEAN_PARAMS', means)
    rt = build_runtime(device='cpu', backbone='vit_t8')
    np.testing.assert_array_equal(rt.smpl.J_regressor_extra.numpy(),
                                  np.asarray(want.J_regressor_extra))
    np.testing.assert_array_equal(
        rt.hmr.init_pose.numpy().ravel(),
        jax_assets.load_mean_params(means)[0])


def test_load_smpl_pkl_without_chumpy_or_jax(bodies, tmp_path):
    # the port's own chumpy stub, in an interpreter with neither installed
    smpl_dir, _ = _write_real_assets(tmp_path, bodies[0])
    code = ('import sys; from tuch_tpu_torch import assets; '
            f'm = assets.load_smpl_pkl({str(smpl_dir / "SMPL_NEUTRAL.pkl")!r}); '
            "assert 'jax' not in sys.modules; "
            'print(float(abs(m.v_template).sum()))')
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert float(out.stdout) == pytest.approx(
        float(np.abs(bodies[0].v_template).sum()), rel=1e-6)


@pytest.mark.parametrize('pose2rot', [True, False])
def test_smpl_forward_matches_jax(bodies, pose2rot):
    jax_model, _, pt_model, _ = bodies
    rng = np.random.RandomState(4)
    B = 3
    betas = rng.randn(B, 10).astype(np.float32)
    aa = (rng.randn(B, 24, 3) * 0.4).astype(np.float32)
    if pose2rot:
        body, orient = aa[:, 1:].reshape(B, 69), aa[:, 0]
    else:
        R = np.asarray(jax_rot.batch_rodrigues(jnp.asarray(aa)))
        body, orient = R[:, 1:], R[:, :1]
    want = jax_smpl.smpl_forward(jax_model, jnp.asarray(betas),
                                 jnp.asarray(body), jnp.asarray(orient),
                                 pose2rot=pose2rot)
    smpl = pt_smpl.SMPL(pt_model)
    got = smpl(_t(betas), _t(body), _t(orient), pose2rot=pose2rot)
    for field in ('vertices', 'joints', 'joints_smpl'):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   atol=1e-5, err_msg=field)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

# (B, N, C, heads): the unaligned-N serving token count and an aligned one
ATTN_SHAPES = [(2, 196, 96, 6), (3, 128, 64, 2)]
ATTN_TOL = {'float32': 2e-6, 'bfloat16': 1e-2}


def _qkv(shape, dtype):
    B, N, C, _ = shape
    x = np.random.RandomState(5).randn(B, N, 3 * C).astype(np.float32)
    return (jnp.asarray(x).astype(dtype),
            _t(x).to(getattr(torch, dtype)))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape', ATTN_SHAPES)
@pytest.mark.parametrize('against', ['mha_reference', 'mha_pallas'])
def test_mha_reference_matches_jax(shape, dtype, against):
    if against == 'mha_pallas' and not jax_attn._HAS_PALLAS:
        pytest.skip('pallas unavailable')
    heads = shape[3]
    x_j, x_t = _qkv(shape, dtype)
    if against == 'mha_pallas':
        want = jax_attn.mha_pallas(x_j, heads=heads, interpret=True)
    else:
        want = jax_attn.mha_reference(x_j, heads)
    got = pt_attn.mha_reference(x_t, heads)
    assert got.dtype == x_t.dtype and got.shape == shape[:2] + (shape[2],)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=ATTN_TOL[dtype])
