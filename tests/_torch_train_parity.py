"""Set-up shared by the training-step parity tests (not a test module).

Both packages' runtimes on the 170-vertex synthetic body with every
contact asset and the HD surface; the port's HMR carries the Flax HMR's
weights and batch statistics (from_jax_variables). The JAX step runs as
tests/test_train.py runs it: jax.jit of make_train_step on the CPU, where
the contact ops take their jnp paths. The port runs its step on the same
numpy batch, fits and dropout masks: the masks are the JAX step's own,
read from a Flax apply with the step's dropout key (the drop1/drop2
outputs' non-zeros, three calls each).

Gradients are compared through Adam's first moment, which after one step
from zero is 0.1 x the gradient in both packages.

Also shared by the trainer and eval tests: `few_torch_threads`, and
`save_jax_npz`, the JAX package's variables as the flat .npz checkpoint
both packages read.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from tuch_tpu import config as jcfg
from tuch_tpu import runtime as jrt
from tuch_tpu.models import hmr as jax_hmr
from tuch_tpu.train import module as JM
from tuch_tpu_torch import config as pcfg
from tuch_tpu_torch import runtime as prt
from tuch_tpu_torch.models import convert as PC
from tuch_tpu_torch.runtime import load_hmr_weights
from tuch_tpu_torch.train import module as PM
from tuch_tpu_torch.utils.rotations import batch_rodrigues

B, IMG, NV, NFITS = 2, 64, 170, 8


@pytest.fixture(scope='module')
def few_torch_threads():
    """Two intra-op threads while a module runs, the previous count after:
    a training step at this size is thousands of small ops, and with every
    pytest-xdist worker holding a thread per core, their barriers wait on
    descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def save_jax_npz(variables, path):
    """A Flax variables tree as a flat .npz ('params/backbone/...')."""
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat['/'.join(prefix + (k,))] = np.asarray(v)
    walk(variables, ())
    np.savez(path, **flat)

# Bars. Gradients: the bar of tests/test_torch_port_attention_grad.py,
# rtol 1e-3 + atol 1e-5 of each tensor's largest entry. Fits rows and
# opt_vertices: the 1e-3 vertex bar.
# Losses: rtol 1e-4 + atol 1e-6 of max(1, |value|), the SMPLify slice's
# loss bar (tests/test_torch_port_smplify.py).
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-5
VERTEX_ATOL = 1e-3
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-6
# ResNet-50, where batch-statistics BatchNorm amplifies float32 rounding
# (tools/bn_train_chaos.py): the JAX package's float32 step may lie this
# far (relative L2) from the port's float64 step, by part. Measured on the
# CPU at this shape: gradients 5.86% (fit off) and 4.81% (fit on), near
# the chaos tool's 2.77% times 1.84 (5.1%), the factor by which this
# step's loss widens the port's own float32 gap (3.19% here, 1.73% there);
# BatchNorm
# statistics 1.15e-5; parameter updates, +-lr at step 1 whatever the
# gradient's size, 25.3% and 22.6% (sign flips of gradients at rounding
# level). The bars are 1.7, 8.7 and 1.6 times those readings.
JAX_GAP = {'mu': 0.1, 'buffers': 1e-4, 'params': 0.4}
# BatchNorm statistics element by element: rtol 1e-5 plus this much of
# each tensor's largest entry. The JAX package's own float32 statistics lie
# up to 2.68e-4 of the largest from the port's float64 step in layer4
# (amplified rounding; the port's float32 2.72e-4 from the JAX package's),
# so rtol 1e-5 alone fails in 32 of the 106 tensors.
BN_STAT_RTOL, BN_STAT_ATOL = 1e-5, 1e-3


def make_batch(num_classes, rng=None, B=B):
    """tests/test_train.py's batch, from a numpy seed."""
    rng = rng or np.random.RandomState(0)
    return {
        'img': rng.randn(B, IMG, IMG, 3).astype(np.float32) * 0.1,
        'keypoints': np.concatenate(
            [rng.uniform(-0.8, 0.8, (B, 49, 2)), np.ones((B, 49, 1))],
            -1).astype(np.float32),
        'pose': (rng.randn(B, 72) * 0.1).astype(np.float32),
        'betas': (rng.randn(B, 10) * 0.2).astype(np.float32),
        'contact_vec': (rng.rand(B, num_classes) > 0.6).astype(np.float32),
        'pose_3d': np.concatenate(
            [rng.randn(B, 24, 3) * 0.2, np.ones((B, 24, 1))],
            -1).astype(np.float32),
        'has_smpl': np.array([1.0] + [0.0] * (B - 1), np.float32),
        'has_pgt_smpl': np.zeros(B, np.float32),
        'has_disc_contact': np.array([0.0] + [1.0] * (B - 1), np.float32),
        'has_gt_kpts': np.ones(B, np.float32),
        'has_pose_3d': np.zeros(B, np.float32),
        'is_flipped': (rng.rand(B) > 0.5).astype(np.float32),
        'rot_angle': rng.uniform(-20, 20, B).astype(np.float32),
        'sample_index': np.arange(B, dtype=np.int32),
        'dataset_id': np.zeros(B, np.int32),
        'fits_index': np.arange(B, dtype=np.int32),
    }


def fold_pose6d(seed=2, scale=1.5):
    """A mean pose for the IEF head that folds the body through itself, so
    the predicted bodies have interior vertices and contact: the 144 6d
    numbers (row-interleaved [r11, r12, r21, r22, r31, r32]) of a random
    axis-angle pose."""
    aa = np.random.RandomState(seed).randn(24, 3).astype(np.float32) * scale
    rot = batch_rodrigues(torch.from_numpy(aa)).numpy()
    return np.ascontiguousarray(rot[:, :, :2]).reshape(-1)


def initial_fits(seed=5):
    """Small random fits rows: a written row differs from its old one."""
    return (np.random.RandomState(seed).randn(NFITS, 82) * 0.1).astype(
        np.float32)


class Pair:
    """One backbone in both packages, and the JAX step per option set."""

    def __init__(self, backbone):
        self.backbone = backbone
        jr = jrt.build_runtime(
            options=jcfg.TrainConfig(backbone=backbone, img_res=IMG),
            synthetic=True, num_verts=NV, img_res=IMG, with_hd=True)
        # both HMRs start their IEF loop from the folding pose
        ex = jr.extras
        self.jr = jr._replace(hmr=jax_hmr.create_hmr(
            fold_pose6d(), ex.mean_shape, ex.mean_cam, backbone=backbone))
        self.variables = jax.tree_util.tree_map(np.asarray,
                                                self.jr.variables)
        self.pr = prt.build_runtime(device='cpu', synthetic=True,
                                    num_verts=NV, backbone=backbone,
                                    with_contact=True, with_hd=True)
        self.pr.hmr.init_pose.copy_(torch.from_numpy(fold_pose6d())[None])
        self.assets = PM.TuchAssets(self.pr.smpl, self.pr.prior,
                                    self.pr.contact, self.pr.hd)
        self.num_classes = len(self.jr.contact_classes)
        self._steps = {}
        self._masks = jax.jit(self._masks_fn)

    def options(self, **kw):
        kw = dict(batch_size=B, img_res=IMG, **kw)
        return (jcfg.TrainConfig(backbone=self.backbone, **kw),
                pcfg.TrainConfig(backbone=self.backbone, **kw))

    def jax_step(self, **kw):
        key = tuple(sorted(kw.items()))
        if key not in self._steps:
            jopts, _ = self.options(**kw)
            self._steps[key] = jax.jit(JM.make_train_step(
                self.jr.hmr, self.jr.assets, jopts, optax.adam(jopts.lr),
                self.num_classes))
        return self._steps[key]

    def jax_state(self, fits):
        params = self.variables['params']
        return JM.TrainState(
            params=params, batch_stats=self.variables.get('batch_stats', {}),
            opt_state=optax.adam(1e-5).init(params),
            fits=jnp.asarray(fits), rng=jax.random.PRNGKey(0),
            step=jnp.asarray(0, jnp.int32))

    def port_state(self, fits, lr=1e-5):
        hmr = self.pr.hmr
        load_hmr_weights(hmr, PC.from_jax_variables(self.variables))
        return PM.init_train_state(hmr, torch.tensor(fits), lr)

    def _masks_fn(self, variables, rng):
        img = jnp.asarray(np.random.RandomState(9).randn(
            B, IMG, IMG, 3).astype(np.float32))
        _, state = self.jr.hmr.apply(
            variables, img, train=True, rngs={'dropout': rng},
            mutable=['batch_stats', 'intermediates'],
            capture_intermediates=lambda m, _: isinstance(m, nn.Dropout))
        inter = state['intermediates']
        return [[out != 0 for out in inter[name]['__call__']]
                for name in ('Dropout_0', 'Dropout_1')]

    def dropout_masks(self, jax_state):
        """The JAX step's keep-masks in draw_dropout_masks' layout."""
        drop_rng = jax.random.split(jax_state.rng)[1]
        d1, d2 = self._masks(self.variables, drop_rng)
        return [(torch.from_numpy(np.array(a)), torch.from_numpy(np.array(b)))
                for a, b in zip(d1, d2)]


def snapshot(ps):
    """The port state's tensors after a step, copied (the state's HMR and
    Adam are updated in place by the next step)."""
    return dict(mu={k: v.clone() for k, v in ps.opt.mu.items()},
                params={k: p.detach().clone()
                        for k, p in ps.hmr.named_parameters()},
                buffers={k: b.clone() for k, b in ps.hmr.named_buffers()},
                fits=ps.fits.clone(), step=ps.step)


def run_both(pair, batch, fits, n_steps=1, **kw):
    """n steps of each package from the same start; returns per step
    (jax state, metrics, outputs, port snapshot, metrics, outputs)."""
    jstep = pair.jax_step(**kw)
    _, popts = pair.options(**kw)
    pstep = PM.make_train_step(pair.assets, popts)
    js, ps = pair.jax_state(fits), pair.port_state(fits, popts.lr)
    out = []
    for _ in range(n_steps):
        masks = pair.dropout_masks(js)
        js, jm, jo = jstep(js, batch)
        ps, pm, po = pstep(ps, batch, dropout=masks)
        out.append((js, jm, jo, snapshot(ps), pm, po))
    return out


def port_step64(pair, batch, fits, masks, **kw):
    """One port step in float64 from the same start (the HMR, body, prior
    and HD weights as float64 copies): the stand-in for the exact answer
    where float32 rounding is amplified (ResNet-50's batch-statistics
    BatchNorm at random init)."""
    import copy
    ps = pair.port_state(fits)
    hmr = copy.deepcopy(ps.hmr).double()
    hmr.dtype = torch.float64
    pr = pair.pr

    def f64(tup):
        return type(tup)(*(t.double() if torch.is_tensor(t)
                           and t.is_floating_point() else t for t in tup))

    contact = pr.contact._replace(segment_tables=f64(
        pr.contact.segment_tables))
    assets = PM.TuchAssets(copy.deepcopy(pr.smpl).double(), f64(pr.prior),
                           contact, f64(pr.hd))
    b64 = {k: v.astype(np.float64) if v.dtype == np.float32 else v
           for k, v in batch.items()}
    state = PM.init_train_state(hmr, torch.tensor(fits, dtype=torch.float64),
                                1e-5)
    state, _, _ = PM.make_train_step(assets, pair.options(**kw)[1])(
        state, b64, dropout=masks)
    return snapshot(state)


def assert_losses_close(jm, pm):
    assert set(pm) == set(jm), (sorted(pm), sorted(jm))
    for k, v in jm.items():
        want = float(np.asarray(v))
        got = float(pm[k])
        assert abs(got - want) <= LOSS_RTOL * abs(want) + LOSS_ATOL * max(
            1.0, abs(want)), (k, got, want)


def jax_tensors(js):
    """The JAX state's gradients (Adam's mu / 0.1 after step 1: compared
    as mu), parameters and batch statistics under the port's names."""
    tree = jax.tree_util.tree_map(np.asarray, js)
    return dict(mu=PC.params_from_jax(tree.opt_state[0].mu),
                params=PC.params_from_jax(tree.params),
                buffers=PC.batch_stats_from_jax(tree.batch_stats)
                if tree.batch_stats else {})


def assert_grads_close(want, got):
    """Adam's first moment name by name at the gradient bar."""
    assert set(got['mu']) == set(want['mu'])
    for k, g in got['mu'].items():
        ref = want['mu'][k].numpy()
        np.testing.assert_allclose(
            g.numpy(), ref, rtol=GRAD_RTOL,
            atol=GRAD_ATOL * np.abs(ref).max() + 1e-12, err_msg=k)


def grad_bar(g):
    """The gradient bar of each entry: rtol |g| + atol max |g|."""
    g = np.asarray(g, np.float64)
    return GRAD_RTOL * np.abs(g) + GRAD_ATOL * np.abs(g).max()


def moment_bars(mus):
    """Per step, the bar of Adam's first moment m_t = 0.9 m_(t-1) + 0.1 g_t
    carried from the bars of the JAX package's gradients g_t (read back
    from its moments), by name."""
    out, prev = [], None
    for mu in mus:
        bars = {}
        for k, m in mu.items():
            m = m.numpy().astype(np.float64)
            m0 = 0.0 if prev is None else prev[0][k].numpy()
            g = (m - 0.9 * m0) / 0.1
            bars[k] = 0.1 * grad_bar(g) + (
                0.0 if prev is None else 0.9 * prev[1][k])
        out.append(bars)
        prev = (mu, bars)
    return out


def assert_params_close(want, got, tol_m, prev_lim=None, lr=1e-5):
    """The parameters after Adam, at the moment's bar tol_m carried
    through Adam's step: its size is lr |m^ / (sqrt(v^) + eps)| <= lr, and
    m known to tol_m moves it by up to ~3 lr tol_m / |m| (m and,
    half-weighted, v), never more than 2 lr; plus two float32 ulps and the
    bar of the step before (prev_lim). Returns this step's bar by name."""
    lims = {}
    for k, p in got['params'].items():
        m = np.abs(want['mu'][k].numpy().astype(np.float64))
        ref = want['params'][k].numpy()
        lim = lr * np.minimum(2.0, 3 * tol_m[k] / np.maximum(m, 1e-30))
        lim = lim + 2.4e-7 * np.abs(ref) + (
            0.0 if prev_lim is None else prev_lim[k])
        err = np.abs(p.numpy().astype(np.float64) - ref)
        assert (err <= lim).all(), (k, float((err / lim).max()))
        lims[k] = lim
    return lims


def _flat(tensors, keys, base=None):
    return np.concatenate([
        np.asarray(tensors[k], np.float64).ravel()
        - (0 if base is None else np.asarray(base[k], np.float64).ravel())
        for k in keys])


def assert_no_noisier(want, got, exact, part, base=None, rtol=GRAD_RTOL):
    """Over all tensors of `part` at once (minus `base`, for parameter
    updates): ||port - exact|| <= 2 ||JAX - exact|| + rtol ||JAX||, the
    port's float32 no further from the exact (float64) answer than twice
    the JAX package's float32 is; and the exact answer itself near the
    JAX package's, ||JAX - exact|| <= JAX_GAP[part] ||JAX||, so that a
    fault of the port's step in both dtypes cannot widen the first bar.
    Returns the three norms."""
    keys = sorted(want[part])
    w = _flat(want[part], keys, base)
    g = _flat(got[part], keys, base)
    e = _flat(exact[part], keys, base)
    d_port, d_jax = np.linalg.norm(g - e), np.linalg.norm(w - e)
    norm = np.linalg.norm(w)
    assert d_jax <= JAX_GAP[part] * norm, (part, d_jax / norm)
    assert d_port <= 2 * d_jax + rtol * norm, (part, d_port, d_jax, norm)
    return d_port, d_jax, norm


def assert_bn_stats_close(want, got):
    """Every BatchNorm statistic against the JAX package's, element by
    element, at BN_STAT_RTOL + BN_STAT_ATOL of each tensor's largest."""
    assert set(got['buffers']) >= set(want['buffers'])
    for k, ref in want['buffers'].items():
        ref = np.asarray(ref)
        np.testing.assert_allclose(
            got['buffers'][k].numpy(), ref, rtol=BN_STAT_RTOL,
            atol=BN_STAT_ATOL * np.abs(ref).max(), err_msg=k)


def accepted(fits0, fits1):
    return np.abs(np.asarray(fits1) - fits0).max(axis=1) > 0


def assert_fits_and_vertices_close(js, jo, ps, po, fits0):
    """The accept mask (read from the rows written), the fits rows and
    opt_vertices."""
    jfits = np.asarray(js.fits)
    np.testing.assert_array_equal(accepted(fits0, ps['fits'].numpy()),
                                  accepted(fits0, jfits))
    np.testing.assert_array_equal(
        po['fit_accepted'].numpy(),
        accepted(fits0, jfits)[:po['fit_accepted'].shape[0]])
    np.testing.assert_allclose(ps['fits'].numpy(), jfits, rtol=0,
                               atol=VERTEX_ATOL)
    np.testing.assert_allclose(po['opt_vertices'].numpy(),
                               np.asarray(jo['opt_vertices']), rtol=0,
                               atol=VERTEX_ATOL)
