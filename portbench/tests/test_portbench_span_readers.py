"""The per-layer readers of the EFT step's layer spans against hand sums:
hmr_host_ms.fit, smpl_host_ms.fit, loss_host_ms.fit, contact_host_ms.fit
and device_ops_per_step.fit, on a hand-made trace of two steps, on one
without the layer spans (a program that opens none), without a trace, and
on a toy-size CPU window of the fit cell traced by torch.profiler."""

from types import SimpleNamespace

import pytest

from portbench import run
from portbench.tests import toy

READERS = ('hmr_host_ms.fit', 'smpl_host_ms.fit', 'loss_host_ms.fit',
           'contact_host_ms.fit', 'device_ops_per_step.fit')


def step_spans(t, hmr, smpl, loss, nb, rp, bloss, bsmpl, bhmr):
    """One step's spans from t (us), each part's length given."""
    f = [('eft_step.forward.hmr', t + 1, t + 1 + hmr)]
    f.append(('eft_step.forward.smpl', f[-1][2], f[-1][2] + smpl))
    lo = f[-1][2]
    f.append(('eft_step.forward.loss', lo, lo + loss))
    f.append(('eft_step.forward.loss.neighbors', lo + 1, lo + 1 + nb))
    f.append(('eft_step.forward.loss.region_pairs', lo + 2 + nb,
              lo + 2 + nb + rp))
    fwd = ('eft_step.forward', t, lo + loss + 1)
    b0 = fwd[2] + 3
    b = [('eft_step.backward.loss', b0, b0 + bloss)]
    b.append(('eft_step.backward.smpl', b[-1][2], b[-1][2] + bsmpl))
    b.append(('eft_step.backward.hmr', b[-1][2], b[-1][2] + bhmr))
    bwd = ('eft_step.backward', fwd[2] + 1, b[-1][2] + 2)
    adam = ('eft_step.adam', bwd[2], bwd[2] + 40_000)
    return [fwd, *f, bwd, *b, adam]


def hand_trace(layers=True):
    spans = step_spans(1_000, 40_000, 10_000, 30_000, 12_000, 15_000,
                       5_000, 20_000, 66_000)
    spans += step_spans(400_000, 44_000, 11_000, 34_000, 13_000, 17_000,
                         6_000, 21_000, 70_000)
    if not layers:
        spans = [s for s in spans if s[0].count('.') == 1]
    k = [('conv', 2_000, 2_100, 'eft_step.forward.hmr'),
         ('gemm', 3_000, 3_100, 'eft_step.forward.hmr'),
         ('winding', 60_000, 60_500, 'eft_step.forward.loss.neighbors'),
         ('add', 70_000, 70_010, 'eft_step.backward.smpl'),
         ('adam', 200_000, 200_010, 'eft_step.adam'),
         ('copy', 300_000, 300_010, 'portbench.fit_one'),
         ('fill', 300_100, 300_110, ''),
         ('conv', 410_000, 410_100, 'eft_step.forward'),
         ('late', 900_000, 900_010, 'eft_step.adam')]
    return SimpleNamespace(spans=sorted(spans, key=lambda s: s[1]),
                           kernels=k, t0_us=0.0, t1_us=800_000.0)


def read(name, trace, steps=(1, 1)):
    return run.load_reader(name)({'trace': trace,
                                  'result': {'steps': list(steps)}})


@pytest.mark.parametrize('name, expected', [
    ('hmr_host_ms.fit', (40 + 66 + 44 + 70) / 2),
    ('smpl_host_ms.fit', (10 + 20 + 11 + 21) / 2),
    # the loss's nested neighbors and region_pairs are not added again
    ('loss_host_ms.fit', (30 + 5 + 34 + 6) / 2),
    ('contact_host_ms.fit', (12 + 15 + 13 + 17) / 2),
    # eft_step.* launches in the window: not fit_one's, no span's, nor the
    # one after the window
    ('device_ops_per_step.fit', 6 / 2),
])
def test_readers_against_hand_sums(name, expected):
    assert read(name, hand_trace()) == pytest.approx(expected, rel=1e-12)


@pytest.mark.parametrize('name', READERS)
def test_no_trace_reads_none(name):
    assert read(name, None) is None
    assert read(name, hand_trace(), steps=()) is None


@pytest.mark.parametrize('name', READERS[:4])
def test_no_layer_spans_reads_none(name):
    assert read(name, hand_trace(layers=False)) is None


def test_a_traced_toy_window_reads_every_layer(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    from portbench.common import Trace
    from portbench.drivers import fit as drv
    ctx = toy.fit_ctx(tmp=tmp_path)
    cell = drv.Cell(ctx)
    try:
        cell.setup()
        prof = profile(activities=[ProfilerActivity.CPU])
        res = cell.window(0.5, prof)
    finally:
        cell.release()
    trace = Trace(prof, drv.SPANS)
    names = [s[0] for s in trace.spans]
    steps = sum(res['steps'])
    for part in ('hmr', 'smpl', 'loss', 'loss.neighbors',
                 'loss.region_pairs'):
        assert names.count(f'eft_step.forward.{part}') == steps, part
    for part in ('loss', 'smpl', 'hmr'):
        assert names.count(f'eft_step.backward.{part}') == steps, part
    ctx.update(trace=trace, result=res)
    got = {n: run.load_reader(n)(ctx) for n in READERS}
    assert all(got[n] > 0 for n in READERS[:4]), got
    assert got['contact_host_ms.fit'] < got['loss_host_ms.fit']
    # a CPU trace holds no device operation
    assert got['device_ops_per_step.fit'] is None
