"""The reader of smpl_graph_share.fit (the share of the window's EFT steps
whose SMPL forward was a CUDA graph replay) against hand counts: every
step, a third of them, none (the eager path, as on the CPU or at a parent
without the graphs), no trace, no steps; HMR's graph spans are not
counted; and a traced toy-size CPU window of the fit cell, whose eager
SMPL opens no graph span."""

from types import SimpleNamespace

import pytest

from portbench import run
from portbench.tests import toy

NAME = 'smpl_graph_share.fit'
SPAN = 'eft_step.forward.smpl.graph'
CELLS = ('fit.hmr_r50.eft_b1', 'fit.hmr2_vith16.eft_b1')


def trace_of(steps, graphed):
    """Spans of `steps` steps, HMR's forward replayed in every one, SMPL's
    in the first `graphed` of them."""
    spans = []
    for i in range(steps):
        t = 1_000 + 100_000 * i
        spans += [('eft_step.forward', t, t + 50_000),
                  ('eft_step.forward.hmr', t + 10, t + 2_000),
                  ('eft_step.forward.hmr.graph', t + 20, t + 1_900),
                  ('eft_step.forward.smpl', t + 2_010, t + 3_000)]
        if i < graphed:
            spans.append((SPAN, t + 2_020, t + 2_900))
        spans.append(('eft_step.backward.smpl', t + 60_000, t + 61_000))
    return SimpleNamespace(spans=spans, kernels=[], t0_us=0.0,
                           t1_us=100_000.0 * steps + 2_000)


def read(trace, steps):
    return run.load_reader(NAME)({'trace': trace,
                                  'result': {'steps': list(steps)}})


@pytest.mark.parametrize('graphed, expected', [(6, 100.0), (2, 100 / 3)])
def test_share_against_hand_counts(graphed, expected):
    # two images of 3 steps
    assert read(trace_of(6, graphed), (3, 3)) == pytest.approx(expected,
                                                                rel=1e-12)


@pytest.mark.parametrize('trace, steps', [
    (trace_of(4, 0), (4,)),        # the eager path opens no graph span
    (None, (4,)),                  # no trace
    (trace_of(4, 4), ()),          # no step
])
def test_reads_none_without_graph_spans_trace_or_steps(trace, steps):
    assert read(trace, steps) is None


@pytest.mark.parametrize('cell', CELLS)
def test_registered_in_both_fit_cells(cell):
    _, _, _, _, per_layer = run.load_cell(cell)
    m = {m['name']: m for m in per_layer}[NAME]
    assert (m['layer'], m['source'], m['moves'], m['better'], m['unit']) == \
        ('models/smpl', 'program_span', 'fit_images_per_s', 'higher', '%')


def test_a_traced_toy_window_on_the_cpu_reads_none(tmp_path):
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
    assert names.count('eft_step.forward.smpl') == sum(res['steps']) > 0
    ctx.update(trace=trace, result=res)
    assert run.load_reader(NAME)(ctx) is None
