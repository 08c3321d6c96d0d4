"""HMR's CUDA graphs in the EFT fit (models/hmr.HMRGraphs, fitting/eft.py).

On the CPU: the engagement rule (graph_engages: a CUDA device, train mode,
no BatchNorm2d with a sync_group) and HMRGraphs.bind's None off the card;
a 3-step make_eft_fit_fn fit on the 170-vertex body at 64 px (ResNet-50)
opens no 'eft_step.forward.hmr.graph' span, and its pose, betas, steps and
loss are bit for bit those of the eager step written out here (the fit's
loop as it was before the graphs).

On the card (marked cuda; skipped without one): ResNet-50 at 224 px, two
images of 3 steps each, the graph path against the same fit with
graph_engages off, float32 with TF32 off and deterministic algorithms: each
step's loss, parameter gradients and updated parameters, the pose and
betas, and the running statistics after each fit, bit for bit; image 1's
result unchanged after image 2 is fitted; one 'eft_step.forward.hmr.graph'
span a step; no warning of a gradient accumulator on another stream (the
capture's side streams); EFTFitter.fit() leaves the start's parameters and
statistics; and one ViT-S/16 fit, graph against eager. HMR 2.0
(models/hmr2) at toy size and at its published widths (ViT-H/16 at 256
px), two images of 3 steps on its drop-path masks, graph against eager bit
for bit; its kernel-1 launches counted at each replay (ops/attention
.mha_cuda.launches) equal the trace's kernel-1 operations.
"""

import types
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tuch_tpu_torch import constants
from tuch_tpu_torch import runtime as rt
from tuch_tpu_torch.fitting import eft as PEF
from tuch_tpu_torch.fitting.smplify_dc import Adam
from tuch_tpu_torch.losses.eft import EFTWeights, eft_loss
from tuch_tpu_torch.models import hmr as H
from tuch_tpu_torch.models.smpl import smpl_forward
from tuch_tpu_torch.utils.projection import weak_perspective_to_translation
from tuch_tpu_torch.utils.rotations import rotmat_to_aa

STEPS = 3
LR = 1e-5
GRAPH_SPAN = 'eft_step.forward.hmr.graph'


@pytest.fixture(scope='module', autouse=True)
def few_torch_threads():
    """Two intra-op threads while the module runs (a fit at this size is
    thousands of small ops, and pytest-xdist's workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def fit_inputs(num_classes, img_res, device, seed):
    g = torch.Generator().manual_seed(seed)
    img = torch.randn(1, img_res, img_res, 3, generator=g)
    kp = torch.cat([torch.rand(1, 49, 2, generator=g) * 1.6 - 0.8,
                    (torch.rand(1, 49, 1, generator=g) > 0.2).float()], -1)
    contact = (torch.rand(1, num_classes, generator=g) > 0.7).float()
    return [x.to(device) for x in (img, kp, contact)]


def drawn_masks(device, seed, steps=STEPS, draw=H.draw_dropout_masks):
    g = torch.Generator(device=device).manual_seed(seed)
    return [draw(1, g, device) for _ in range(steps)]


def eager_fit(r, start, img, kp, contact, masks, img_res):
    """The EFT fit of STEPS steps as make_eft_fit_fn ran it before the
    graphs (no early stop this short): eager HMR, SMPL, the loss, the
    gradient and Adam; (pose, betas, steps, loss)."""
    hmr = r.hmr
    hmr.load_state_dict(start)
    hmr.train()
    names, params = zip(*hmr.named_parameters())
    opt = Adam({k: p.detach() for k, p in zip(names, params)}, LR)
    for step in range(STEPS):
        rotmat, betas, cam = hmr(img, dropout=masks[step])
        out = smpl_forward(r.smpl, betas, rotmat[:, 1:], rotmat[:, :1],
                           pose2rot=False)
        cam_t = weak_perspective_to_translation(cam, constants.FOCAL_LENGTH,
                                                img_res)
        total, _ = eft_loss(out.joints, betas, out.vertices, cam_t, kp,
                            contact, r.contact, EFTWeights(),
                            img_res=img_res)
        grads = torch.autograd.grad(total, params, allow_unused=True,
                                    materialize_grads=True)
        with torch.no_grad():
            new = opt.step(dict(zip(names, params)), dict(zip(names, grads)))
            for k, p in zip(names, params):
                p.copy_(new[k])
    pose = torch.nan_to_num(rotmat_to_aa(rotmat.detach())).reshape(1, 72)
    return dict(pose=pose, betas=betas.detach(), steps=STEPS,
                loss=float(total.detach()))


def graph_spans(prof):
    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.name() == GRAPH_SPAN)


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def resnet():
    return H.create_hmr(np.zeros(144), np.zeros(10), np.zeros(3))


@pytest.mark.parametrize('device, train, synced, engages', [
    ('cpu', True, False, False),
    ('cpu', False, False, False),
    ('cuda', True, False, True),
    ('cuda', False, False, False),
    ('cuda', True, True, False),
    ('cuda:0', True, False, True),
])
def test_graph_engages_only_for_a_cuda_image_in_train_mode(
        resnet, device, train, synced, engages):
    resnet.train(train)
    H.sync_batchnorm(resnet, object() if synced else None)
    try:
        assert H.graph_engages(resnet, torch.device(device)) is engages
    finally:
        H.sync_batchnorm(resnet, None)
        resnet.eval()


def test_one_synced_batchnorm_keeps_the_eager_path(resnet):
    resnet.train()
    resnet.layer4[2].bn3.sync_group = object()
    try:
        assert not H.graph_engages(resnet, 'cuda')
    finally:
        resnet.layer4[2].bn3.sync_group = None
        resnet.eval()


def test_bind_is_none_off_the_card(resnet):
    resnet.train()
    try:
        graphs = H.HMRGraphs(resnet)
        assert graphs.bind(torch.zeros(1, 64, 64, 3)) is None
        assert graphs._steps == {}
    finally:
        resnet.eval()


@pytest.fixture(scope='module')
def cpu_fits():
    torch.manual_seed(0)
    r = rt.build_runtime(device='cpu', synthetic=True, num_verts=170,
                         backbone='resnet50', with_contact=True,
                         dtype='float32')
    start = {k: v.detach().clone() for k, v in r.hmr.state_dict().items()}
    ins = fit_inputs(len(r.contact_classes), 64, 'cpu', 3)
    masks = drawn_masks('cpu', 5)
    fit = PEF.make_eft_fit_fn(r.hmr, r.smpl, r.contact, EFTWeights(),
                              max_steps=STEPS, lr=LR, img_res=64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = fit(start, *ins, dropout=lambda i: masks[i])
    plain = fit(start, *ins, dropout=lambda i: masks[i])
    want = eager_fit(r, start, *ins, masks, 64)
    return dict(plain=plain, traced=traced, want=want, prof=prof)


def test_cpu_fit_opens_no_graph_span(cpu_fits):
    names = [e.name() for e in cpu_fits['prof'].profiler.kineto_results
             .events()]
    assert names.count('eft_step.forward.hmr') == STEPS
    assert graph_spans(cpu_fits['prof']) == 0


@pytest.mark.parametrize('which', ['plain', 'traced'])
@pytest.mark.parametrize('field', ['pose', 'betas', 'steps', 'loss'])
def test_cpu_fit_is_the_eager_step_bit_for_bit(cpu_fits, which, field):
    got, want = getattr(cpu_fits[which], field), cpu_fits['want'][field]
    if isinstance(want, torch.Tensor):
        assert torch.equal(got, want)
    else:
        assert got == want


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (CUDA graphs have no CPU mode)')
    rt.deterministic('cuda')
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device('cuda')
    torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32 = old


def bits_digest(t):
    """A position-weighted sum of t's 32-bit patterns (int64, wrapping): a
    stand-in for a copy where copies of every step would not fit the card
    (ViT-H's 670M floats); equal bits give equal digests."""
    v = t.detach().reshape(-1).view(torch.int32).to(torch.int64)
    w = torch.arange(1, v.numel() + 1, dtype=torch.int64, device=v.device)
    return (v * (w * 2654435761 + 97)).sum()


class Recorder:
    """Each step's loss, gradients and updated parameters of the fits run
    while it is installed, by wrapping fitting/eft's eft_loss and Adam;
    copies, taken when they are made (with digest, bits_digest of each
    instead)."""

    def __init__(self, mp, digest=False):
        self.steps = []
        rec, loss_fn, base = self, PEF.eft_loss, PEF.Adam
        keep = bits_digest if digest else torch.clone

        def recorded_loss(*args, **kwargs):
            total, parts = loss_fn(*args, **kwargs)
            rec.steps.append(dict(loss=total.detach().clone()))
            return total, parts

        class RecordedAdam(base):
            def step(self, params, grads):
                out = super().step(params, grads)
                rec.steps[-1].update(
                    grads={k: keep(g) for k, g in grads.items()},
                    params={k: keep(v) for k, v in out.items()})
                return out

        mp.setattr(PEF, 'eft_loss', recorded_loss)
        mp.setattr(PEF, 'Adam', RecordedAdam)


def card_fits(r, dev, img_res, images, graph, digest=False):
    """Fit `images` (seeds) one after another from r.hmr's start with the
    graphs on or off: results, copies of each result as it left its fit,
    the buffers after each fit, every step's record (Recorder's, digests
    with digest), the graph spans and the warnings raised."""
    start = {k: v.detach().clone() for k, v in r.hmr.state_dict().items()}
    out = dict(results=[], copies=[], buffers=[], spans=0)
    with pytest.MonkeyPatch.context() as mp, \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        if not graph:
            mp.setattr(H, 'graph_engages', lambda model, device: False)
        rec = Recorder(mp, digest)
        fit = PEF.make_eft_fit_fn(r.hmr, r.smpl, r.contact, EFTWeights(),
                                  max_steps=STEPS, lr=LR, img_res=img_res)
        for seed in images:
            ins = fit_inputs(len(r.contact_classes), img_res, dev, seed)
            masks = drawn_masks(dev, 100 + seed, draw=getattr(
                r.hmr, 'draw_masks', H.draw_dropout_masks))
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                res = fit(start, *ins, dropout=lambda i: masks[i])
            torch.cuda.synchronize()
            out['spans'] += graph_spans(prof)
            out['results'].append(res)
            out['copies'].append((res.pose.clone(), res.betas.clone()))
            out['buffers'].append({k: b.clone()
                                   for k, b in r.hmr.named_buffers()})
    r.hmr.load_state_dict(start)
    out['steps'] = rec.steps
    out['warnings'] = [str(w.message) for w in caught]
    return out


def all_equal(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.fixture(scope='module')
def resnet_card(card):
    torch.manual_seed(0)
    r = rt.build_runtime(device=card, synthetic=True, num_verts=170,
                         backbone='resnet50', with_contact=True,
                         dtype='float32')
    eager = card_fits(r, card, 224, (1, 2), graph=False)
    graph = card_fits(r, card, 224, (1, 2), graph=True)
    return dict(r=r, eager=eager, graph=graph)


@pytest.mark.cuda
@pytest.mark.parametrize('part', ['loss', 'grads', 'params'])
def test_graph_step_matches_eager_on_card(resnet_card, part):
    e, g = resnet_card['eager']['steps'], resnet_card['graph']['steps']
    assert len(e) == len(g) == 2 * STEPS
    for i, (a, b) in enumerate(zip(e, g)):
        if part == 'loss':
            assert torch.equal(a[part], b[part]), (i, a[part], b[part])
        else:
            assert all_equal(a[part], b[part]), (part, i)


@pytest.mark.cuda
def test_graph_fit_results_match_eager_on_card(resnet_card):
    for a, b in zip(resnet_card['eager']['results'],
                    resnet_card['graph']['results']):
        assert (a.steps, a.loss) == (b.steps, b.loss) == (STEPS, a.loss)
        assert torch.equal(a.pose, b.pose) and torch.equal(a.betas, b.betas)


@pytest.mark.cuda
def test_running_statistics_match_eager_on_card(resnet_card):
    """Each fit starts from the given statistics: capture moves none."""
    for a, b in zip(resnet_card['eager']['buffers'],
                    resnet_card['graph']['buffers']):
        assert all_equal(a, b)


@pytest.mark.cuda
def test_first_result_unchanged_by_the_second_fit_on_card(resnet_card):
    g = resnet_card['graph']
    (pose, betas), res = g['copies'][0], g['results'][0]
    assert torch.equal(res.pose, pose) and torch.equal(res.betas, betas)
    assert not torch.equal(res.betas, g['results'][1].betas)


@pytest.mark.cuda
def test_no_gradient_stream_mismatch_on_card(resnet_card):
    """The replays' gradient accumulators are made on the replaying
    stream, not kept from the capture's side streams."""
    for side in ('eager', 'graph'):
        assert not [w for w in resnet_card[side]['warnings']
                    if 'AccumulateGrad' in w], side


@pytest.mark.cuda
def test_one_graph_span_a_step_on_card(resnet_card):
    assert resnet_card['graph']['spans'] == 2 * STEPS
    assert resnet_card['eager']['spans'] == 0


class Images:
    """A dataset of seeded exemplars in EFTFitter's get(idx) form."""

    def __init__(self, n, num_classes, img_res):
        self.items = [fit_inputs(num_classes, img_res, 'cpu', 10 + i)
                      for i in range(n)]

    def __len__(self):
        return len(self.items)

    def get(self, idx):
        img, kp, contact = self.items[idx]
        return dict(img=img[0].numpy(), keypoints=kp[0].numpy(),
                    contact_vec=contact[0].numpy())


@pytest.mark.cuda
def test_fitter_restores_the_start_on_card(resnet_card, tmp_path):
    r = resnet_card['r']
    start = {k: v.detach().clone() for k, v in r.hmr.state_dict().items()}
    opts = types.SimpleNamespace(max_steps=STEPS, img_res=224, seed=0)
    fitter = PEF.EFTFitter(opts, 'dsc_df', Images(2, len(r.contact_classes),
                                                  224),
                           r.hmr, r.smpl, r.contact, out_dir=str(tmp_path))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        path = fitter.fit()
    assert graph_spans(prof) == 2 * STEPS
    assert all_equal(start, r.hmr.state_dict())
    with np.load(path) as d:
        assert np.isfinite(d['pose']).all() and np.isfinite(d['betas']).all()


@pytest.mark.cuda
def test_vit_graph_fit_matches_eager_on_card(card):
    torch.manual_seed(0)
    r = rt.build_runtime(device=card, synthetic=True, num_verts=170,
                         backbone='vit_s16', with_contact=True,
                         dtype='float32')
    eager = card_fits(r, card, 224, (3,), graph=False)
    graph = card_fits(r, card, 224, (3,), graph=True)
    assert graph['spans'] == STEPS and eager['spans'] == 0
    for a, b in zip(eager['steps'], graph['steps']):
        assert torch.equal(a['loss'], b['loss'])
        assert all_equal(a['grads'], b['grads'])
        assert all_equal(a['params'], b['params'])
    a, b = eager['results'][0], graph['results'][0]
    assert torch.equal(a.pose, b.pose) and torch.equal(a.betas, b.betas)


HMR2_RES = {'hmr2_toy': 64, 'hmr2_vith16': 256}


@pytest.mark.cuda
@pytest.mark.parametrize('backbone', sorted(HMR2_RES))
def test_hmr2_graph_fit_matches_eager_on_card(card, backbone):
    torch.manual_seed(0)
    res = HMR2_RES[backbone]
    r = rt.build_runtime(device=card, synthetic=True, num_verts=170,
                         backbone=backbone, with_contact=True,
                         dtype='float32', img_res=res)
    digest = backbone == 'hmr2_vith16'
    eager = card_fits(r, card, res, (1, 2), graph=False, digest=digest)
    graph = card_fits(r, card, res, (1, 2), graph=True, digest=digest)
    assert graph['spans'] == 2 * STEPS and eager['spans'] == 0
    assert len(eager['steps']) == len(graph['steps']) == 2 * STEPS
    for a, b in zip(eager['steps'], graph['steps']):
        assert torch.equal(a['loss'], b['loss'])
        assert all_equal(a['grads'], b['grads'])
        assert all_equal(a['params'], b['params'])
    for a, b in zip(eager['results'], graph['results']):
        assert torch.equal(a.pose, b.pose) and torch.equal(a.betas, b.betas)
    assert not [w for w in graph['warnings'] if 'AccumulateGrad' in w]


@pytest.mark.cuda
def test_kernel1_launches_count_each_replay_on_card(card):
    """The capture's kernel-1 launches count once a replay, not at capture:
    the first fit counts its eager warm-up passes and its replays, the
    second its replays only, as many as the trace's kernel-1 operations."""
    from tuch_tpu_torch.ops import attention as A
    torch.manual_seed(0)
    r = rt.build_runtime(device=card, synthetic=True, num_verts=170,
                         backbone='hmr2_toy', with_contact=True,
                         dtype='float32', img_res=64)
    depth = r.hmr.depth
    start = {k: v.detach().clone() for k, v in r.hmr.state_dict().items()}
    ins = fit_inputs(len(r.contact_classes), 64, card, 4)
    masks = drawn_masks(card, 9, draw=r.hmr.draw_masks)
    fit = PEF.make_eft_fit_fn(r.hmr, r.smpl, r.contact, EFTWeights(),
                              max_steps=STEPS, lr=LR, img_res=64)
    ran, captured = A.mha_cuda.launches, A.mha_cuda.captured
    fit(start, *ins, dropout=lambda i: masks[i])
    torch.cuda.synchronize()
    assert A.mha_cuda.captured - captured == depth
    assert A.mha_cuda.launches - ran == \
        (H._GraphedStep.WARMUP + STEPS) * depth
    ran = A.mha_cuda.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fit(start, *ins, dropout=lambda i: masks[i])
        torch.cuda.synchronize()
    traced = sum(1 for e in prof.profiler.kineto_results.events()
                 if 'mha_fwd_kernel' in e.name()
                 and e.device_type() == torch.autograd.DeviceType.CUDA)
    assert A.mha_cuda.launches - ran == traced == STEPS * depth
