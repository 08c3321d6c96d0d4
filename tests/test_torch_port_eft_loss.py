"""tuch_tpu_torch's EFT loss against tuch_tpu's, on the CPU.

The full 6890-vertex synthetic body with every contact asset (segments
on), posed from a numpy seed: the total and every entry at the loss bar
(rtol 1e-4, atol 1e-6 of max(1, |value|)), and the gradients with respect
to the vertices, joints, betas and camera translation at the gradient bar
(rtol 1e-3 plus 1e-5 of each tensor's largest entry), both for the
reference's winding over every vertex and for K candidate vertices. A
batch whose labels reach a region pair with every vertex pair banned gives
inf, and with a label of 0 NaN, in both packages (ROADMAP fault 3, kept
quirk for quirk).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_train_parity import (  # noqa: F401
    GRAD_ATOL, GRAD_RTOL, LOSS_ATOL, LOSS_RTOL, few_torch_threads)
from tuch_tpu import runtime as jrt
from tuch_tpu.losses import eft as JE
from tuch_tpu.models.smpl import smpl_forward as jax_smpl_forward
from tuch_tpu_torch import runtime as prt
from tuch_tpu_torch.losses import eft as PE
from tuch_tpu_torch.models.convert import contact_assets_from_numpy

pytestmark = pytest.mark.usefixtures('few_torch_threads')

B = 2


@pytest.fixture(scope='module')
def body():
    """Both packages' full synthetic body and contact assets, a posed batch
    (vertices, joints), cameras, keypoints and labels."""
    jr = jrt.build_runtime(synthetic=True, with_hd=False)
    pr = prt.build_runtime(device='cpu', synthetic=True, with_contact=True)
    rng = np.random.RandomState(0)
    pose = (rng.randn(B, 72) * 0.8).astype(np.float32)
    betas = (rng.randn(B, 10) * 0.5).astype(np.float32)
    out = jax_smpl_forward(jr.smpl, jnp.asarray(betas),
                           jnp.asarray(pose[:, 3:]), jnp.asarray(pose[:, :3]))
    P = len(jr.contact_classes)
    return dict(
        jr=jr, pr=pr, P=P,
        inputs=dict(
            vertices=np.asarray(out.vertices), joints=np.asarray(out.joints),
            betas=betas,
            cam_t=np.array([[0.1, 0.2, 50.0], [-0.1, 0.05, 40.0]],
                           np.float32)),
        kp=np.concatenate([rng.uniform(-0.8, 0.8, (B, 49, 2)),
                           rng.uniform(0, 1, (B, 49, 1))], -1
                          ).astype(np.float32),
        contact=(rng.rand(B, P) > 0.5).astype(np.float32))


def jax_loss(ca, kp, gt, candidate_k):
    def total(vertices, joints, betas, cam_t):
        t, d = JE.eft_loss(joints, betas, vertices, cam_t, jnp.asarray(kp),
                           jnp.asarray(gt), ca, JE.EFTWeights(),
                           candidate_k=candidate_k)
        return t, d
    return jax.jit(jax.value_and_grad(total, argnums=(0, 1, 2, 3),
                                      has_aux=True))


def port_loss(ca, kp, gt, inputs, candidate_k):
    leaves = {k: torch.tensor(v, requires_grad=True)
              for k, v in inputs.items()}
    tot, d = PE.eft_loss(leaves['joints'], leaves['betas'],
                         leaves['vertices'], leaves['cam_t'],
                         torch.tensor(kp), torch.tensor(gt), ca,
                         PE.EFTWeights(), candidate_k=candidate_k)
    grads = torch.autograd.grad(tot, list(leaves.values()))
    return (float(tot.detach()), {k: float(v.detach()) for k, v in d.items()},
            dict(zip(leaves, (g.numpy() for g in grads))))


def assert_loss_close(got, want, what):
    if not np.isfinite(want):
        assert (np.isnan(got) and np.isnan(want)) or got == want, (
            what, got, want)
        return
    assert abs(got - want) <= LOSS_RTOL * abs(want) + LOSS_ATOL * max(
        1.0, abs(want)), (what, got, want)


def compare(body, jca, pca, gt, candidate_k=0, rows=slice(None)):
    inputs = {k: v[rows] for k, v in body['inputs'].items()}
    kp = body['kp'][rows]
    (jt, jd), jg = jax_loss(jca, kp, gt, candidate_k)(
        *(jnp.asarray(inputs[k]) for k in ('vertices', 'joints', 'betas',
                                           'cam_t')))
    pt, pd, pg = port_loss(pca, kp, gt, inputs, candidate_k)
    assert_loss_close(pt, float(jt), 'total')
    assert set(pd) == set(jd)
    for k, v in jd.items():
        assert_loss_close(pd[k], float(v), k)
    for k, g in zip(('vertices', 'joints', 'betas', 'cam_t'), jg):
        g = np.asarray(g)
        finite = np.abs(g[np.isfinite(g)])
        top = finite.max() if finite.size else 0.0
        np.testing.assert_allclose(pg[k], g, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * top + 1e-12, err_msg=k)
    return pt, pd


@pytest.mark.parametrize('candidate_k', [0, 984])
def test_eft_loss_and_gradient_match_jax(body, candidate_k):
    total, d = compare(body, body['jr'].assets.contact, body['pr'].contact,
                       body['contact'], candidate_k)
    assert np.isfinite(total) and d['loss_contact'] > 0
    assert d['loss_keypoints'] > 0 and d['loss_shape'] > 0


def test_all_banned_region_pair_nan_matches_jax(body):
    """Every vertex pair of region pair 0 banned (geomask cleared between
    its two regions, both ways): its least distance is inf, inf x a label
    of 1 is inf and x a label of 0 NaN, so the total is NaN in both (one
    sample a call: the plain winding of the full body is the slow part)."""
    jca = body['jr'].assets.contact
    mask = np.array(jca.geomask)
    ia = np.asarray(jca.region_idx_a[0])[np.asarray(jca.region_mask_a[0])]
    ib = np.asarray(jca.region_idx_b[0])[np.asarray(jca.region_mask_b[0])]
    mask[np.ix_(ia, ib)] = False
    mask[np.ix_(ib, ia)] = False
    jca = jca._replace(geomask=jnp.asarray(mask))
    fields = {k: np.asarray(getattr(jca, k)) for k in (
        'geomask', 'faces', 'region_idx_a', 'region_idx_b', 'region_mask_a',
        'region_mask_b')}
    pca = contact_assets_from_numpy(fields,
                                    body['pr'].contact.segment_tables)
    gt = body['contact'][:1].copy()
    gt[0, 0] = 0.0
    total, d = compare(body, jca, pca, gt, rows=slice(0, 1))
    assert np.isnan(total) and np.isnan(d['loss_contact'])
    # labelled only where the pair is banned: inf, not NaN
    gt1 = np.zeros_like(gt)
    gt1[0, 0] = 1.0
    total, d = compare(body, jca, pca, gt1, rows=slice(1, 2))
    assert np.isinf(total) and np.isinf(d['loss_contact'])
