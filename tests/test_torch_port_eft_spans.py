"""The EFT step's layer spans (fitting/eft.py, losses/eft.py) on the CPU.

A 3-step make_eft_fit_fn fit on the 170-vertex body at 64 px (ResNet-50),
once untraced and once under torch.profiler (CPU activity): each of the
eight layer spans appears once a step, the forward ones inside their
step's 'eft_step.forward' (the loss's parts inside 'eft_step.forward.loss'),
the backward ones inside 'eft_step.backward' in the order loss, smpl, hmr
without overlap; the fit's pose, betas, steps and loss are bit for bit
those of the untraced fit; and the graph holds the three layer boundaries
a step only while the profiler records.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tests import _torch_train_parity as T
from tuch_tpu_torch import runtime as rt
from tuch_tpu_torch.fitting import eft as PEF

pytestmark = pytest.mark.usefixtures('few_torch_threads')
few_torch_threads = T.few_torch_threads

STEPS = 3
FORWARD = ('eft_step.forward.hmr', 'eft_step.forward.smpl',
           'eft_step.forward.loss')
LOSS_PARTS = ('eft_step.forward.loss.neighbors',
              'eft_step.forward.loss.region_pairs')
BACKWARD = ('eft_step.backward.loss', 'eft_step.backward.smpl',
            'eft_step.backward.hmr')


def boundaries_in_graph(t):
    """The _LayerBoundary nodes of t's autograd graph."""
    seen, todo, n = set(), [t.grad_fn], 0
    while todo:
        f = todo.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        n += f.name() == '_LayerBoundaryBackward'
        todo.extend(g for g, _ in f.next_functions)
    return n


@pytest.fixture(scope='module')
def fits():
    torch.manual_seed(0)
    r = rt.build_runtime(device='cpu', synthetic=True, num_verts=170,
                         backbone='resnet50', with_contact=True,
                         dtype='float32')
    start = {k: v.detach().clone() for k, v in r.hmr.state_dict().items()}
    fit = PEF.make_eft_fit_fn(r.hmr, r.smpl, r.contact, PEF.EFTWeights(),
                              max_steps=STEPS, img_res=64)
    g = torch.Generator().manual_seed(3)
    img = torch.randn(1, 64, 64, 3, generator=g)
    kp = torch.cat([torch.rand(1, 49, 2, generator=g) * 1.6 - 0.8,
                    (torch.rand(1, 49, 1, generator=g) > 0.2).float()], -1)
    contact = (torch.rand(1, len(r.contact_classes), generator=g)
               > 0.7).float()
    grad, graphs = torch.autograd.grad, []

    def counting_grad(outputs, *args, **kwargs):
        graphs.append(boundaries_in_graph(outputs))
        return grad(outputs, *args, **kwargs)

    def run():
        graphs.clear()
        res = fit(start, img, kp, contact,
                  generator=torch.Generator().manual_seed(5))
        return res, list(graphs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.autograd, 'grad', counting_grad)
        plain, plain_graphs = run()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            traced, traced_graphs = run()
    spans = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith('eft_step.'):
            spans.setdefault(e.name(), []).append((e.start_ns(),
                                                   e.end_ns()))
    for v in spans.values():
        v.sort()
    return dict(plain=plain, traced=traced, spans=spans,
                graphs=(plain_graphs, traced_graphs))


def inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.mark.parametrize('name', FORWARD + LOSS_PARTS + BACKWARD)
def test_each_layer_span_once_a_step(fits, name):
    assert len(fits['spans'].get(name, [])) == STEPS
    assert fits['traced'].steps == STEPS


def test_forward_spans_nest_in_their_step(fits):
    sp = fits['spans']
    for i, step in enumerate(sp['eft_step.forward']):
        for name in FORWARD:
            assert inside(sp[name][i], step), (name, i)
        for name in LOSS_PARTS:
            assert inside(sp[name][i], sp['eft_step.forward.loss'][i]), \
                (name, i)
        hmr, smpl, loss = (sp[name][i] for name in FORWARD)
        assert hmr[1] <= smpl[0] and smpl[1] <= loss[0]


def test_backward_spans_nest_in_order(fits):
    sp = fits['spans']
    for i, step in enumerate(sp['eft_step.backward']):
        parts = [sp[name][i] for name in BACKWARD]
        for name, part in zip(BACKWARD, parts):
            assert inside(part, step), (name, i)
        for a, b in zip(parts, parts[1:]):
            assert a[1] <= b[0], i


def test_profiler_changes_no_number(fits):
    a, b = fits['plain'], fits['traced']
    assert torch.equal(a.pose, b.pose) and torch.equal(a.betas, b.betas)
    assert (a.steps, a.loss) == (b.steps, b.loss) == (STEPS, a.loss)


def test_boundaries_only_while_profiling(fits):
    plain, traced = fits['graphs']
    assert plain == [0] * STEPS
    assert traced == [3] * STEPS
