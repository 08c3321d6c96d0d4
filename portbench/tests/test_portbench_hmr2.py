"""HMR 2.0's fit cell (fit.hmr2_vith16.eft_b1): its three readers against
hand sums on a hand-made trace, the registry finding its configuration,
traffic, driver and readers, the plain reference's imports, and the driver
at toy size on the CPU against the reference, with faults underneath that
the comparison must catch."""

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest

from portbench import hmr2_counts, run
from portbench.tests import toy

CELL = 'fit.hmr2_vith16.eft_b1'
NEW = ('mfu.fit_hmr2', 'hmr_device_ms.fit_hmr2', 'mha_roofline.fit_hmr2')


def config():
    return toy.load('configs', 'hmr2_vith16')


def hand_trace(mha_us=(3.0, 3.0, 3.0)):
    """Two steps: HMR's forward replay and backward, one kernel-1 operation
    a step in the forward and one at a time outside the window; SMPL and
    Adam operations that no HMR reader counts."""
    k = [('gemm', 1_000, 1_500, 'eft_step.forward.hmr.graph'),
         ('void mha_fwd_kernel<float, 80>', 1_600, 1_600 + mha_us[0],
          'eft_step.forward.hmr.graph'),
         ('smpl', 2_000, 2_100, 'eft_step.forward.smpl'),
         ('gemm_bwd', 3_000, 4_000, 'eft_step.backward.hmr'),
         ('adam', 5_000, 5_500, 'eft_step.adam'),
         ('conv', 6_000, 6_250, 'hmr.backbone'),
         ('void mha_fwd_kernel<float, 80>', 6_300, 6_300 + mha_us[1],
          'hmr.backbone'),
         ('head', 6_400, 6_450, 'hmr.head'),
         ('gemm_bwd', 7_000, 7_500, 'eft_step.backward.hmr'),
         ('void mha_fwd_kernel<float, 80>', 99_000, 99_000 + mha_us[2],
          'eft_step.forward.hmr.graph')]
    return SimpleNamespace(spans=[], kernels=k, t0_us=0.0, t1_us=50_000.0)


def read(name, trace, **result):
    result.setdefault('steps', [1, 1])
    return run.load_reader(name)({'trace': trace, 'result': result,
                                  'config': config()})


def test_hmr_device_ms_against_hand_sums():
    # forward replay 0.5 + 0.003, backward 1.0 + 0.5, eager spans 0.25 +
    # 0.003 + 0.05, over 2 steps; the operation past the window is out
    want = (0.5 + 0.003 + 1.0 + 0.25 + 0.003 + 0.05 + 0.5) / 2
    assert read('hmr_device_ms.fit_hmr2', hand_trace()) == \
        pytest.approx(want, rel=1e-12)


def test_mha_roofline_against_hand_sums():
    bound = hmr2_counts.mha_bound_s(1, 192, 16, 80)
    got = read('mha_roofline.fit_hmr2', hand_trace(), mha_launches=2)
    assert got == pytest.approx(100 * bound * 2 / 6e-6, rel=1e-12)


def test_mha_roofline_needs_the_counter_and_trace_to_agree():
    assert read('mha_roofline.fit_hmr2', hand_trace(), mha_launches=3) \
        is None
    assert read('mha_roofline.fit_hmr2', hand_trace()) is None


def test_kernel1_bound_at_the_cell_s_shape():
    """B=1, N=192, H=16, hd 80, float32: 3.93 MB over 3.35 TB/s (1.17 us)
    against 3 x 0.189 GFLOP at 495 TFLOP/s (1.14 us): bytes bound it."""
    nbytes = 4 * 1280 * 192 * 4
    assert hmr2_counts.mha_bound_s(1, 192, 16, 80) == \
        pytest.approx(nbytes / 3.35e12, rel=1e-12)
    ops = 3 * 4 * 16 * 192 ** 2 * 80
    assert ops / 495e12 < nbytes / 3.35e12


def test_mfu_against_hand_sums():
    cfg = config()
    assert hmr2_counts.grid(cfg) == (16, 12)
    conv, blocks = hmr2_counts.backbone_fwd_flops(cfg)
    assert conv == 2 * 3 * 256 * 1280 * 192
    assert blocks == 32 * (24 * 192 * 1280 ** 2 + 4 * 192 ** 2 * 1280)
    step = hmr2_counts.step_flops(cfg)
    assert 0.74e12 < step < 0.76e12
    counts = {'winding': [(1, 6890, 13776)], 'masked_min': [(1, 6890, 100)]}
    got = read('mfu.fit_hmr2', None, steps=[50, 30], window_s=20.0,
               counts=counts)
    contact = 67 * 6890 * 13776 + 6890 ** 2 + 9 * 100
    assert got == pytest.approx(100 * (80 * step + contact) / 67e12 / 20,
                                rel=1e-12)


@pytest.mark.parametrize('name', NEW)
def test_no_steps_reads_none(name):
    assert read(name, hand_trace(), steps=[], window_s=1.0) is None


@pytest.mark.parametrize('name', NEW[1:])
def test_no_trace_reads_none(name):
    assert read(name, None, mha_launches=2) is None


def test_the_registry_finds_the_cell():
    cell, cfg, traffic, e2e, per_layer = run.load_cell(CELL)
    assert cell['chips'] == 1 and cfg['backbone'] == 'hmr2_vith16'
    assert traffic['driver'] == 'fit_hmr2'
    assert [m['name'] for m in e2e] == ['fit_images_per_s', 'setup_s']
    names = [m['name'] for m in per_layer]
    assert set(NEW) <= set(names) and 'mfu.fit' not in names
    for m in per_layer:
        assert callable(run.load_reader(m['name']))
    bench = json.loads((toy.ROOT / 'BENCHMARK.json').read_text())
    entry = next(c for c in bench['configs'] if c['name'] == 'hmr2_vith16')
    assert entry['reduced'] == []
    from portbench.drivers import fit_hmr2
    assert set(fit_hmr2.Cell.span_prefixes) == {'eft_step.', 'portbench.',
                                                'hmr.'}


def test_the_reference_imports_nothing_of_the_program():
    code = '''
import sys
from portbench.reference import hmr2_ref
m = hmr2_ref.HMR2([0.0] * 144, [0.0] * 10, [0.9, 0, 0], name='hmr2_toy')
print(sorted({m.split('.')[0] for m in sys.modules} &
             {'tuch_tpu_torch', 'tuch_tpu', 'jax', 'jaxlib', 'flax'}))
'''
    out = subprocess.run([sys.executable, '-c', code], cwd=toy.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == '[]'


# ---------------------------------------------------------------------------
# the driver at toy size on the CPU
# ---------------------------------------------------------------------------

def fit_ctx(tmp):
    cfg = config()
    cfg.update(backbone='hmr2_toy', img_res=64, num_verts=170,
               num_hidden_layers=2)
    traffic = toy.load('workloads', 'eft_b1_hmr2')
    traffic.update(max_steps=4, min_steps=1)
    return toy._ctx(cfg, traffic, 2 ** 31 + 9, tmp)


def test_reference_agrees_with_the_port(tmp_path):
    from portbench.drivers import fit_hmr2
    res, checks = toy.run_cell(fit_hmr2, fit_ctx(tmp_path))
    assert res['images'] >= 1 and res['steps'][0] == 4
    assert res['mha_launches'] == 0          # the CPU runs no kernel
    assert [c['name'] for c in checks] == ['loss_gap', 'grad_gap',
                                           'update_gap', 'steps_gap',
                                           'output_gap']
    assert toy.correct(checks), checks


def test_output_gap_against_hand_values():
    import torch

    from portbench.drivers import fit_hmr2
    ref = (torch.tensor([[1.0, -4.0]]), torch.tensor([2.0]),
           torch.tensor([0.5, 0.25]))
    body = (torch.tensor([[1.0, -4.002]]), torch.tensor([2.0]),
            torch.tensor([0.5, 0.2505]))
    # vertices 0.002 / 4, betas 0.0005 / 0.5: the larger
    assert fit_hmr2.output_gap(body, ref) == pytest.approx(1e-3, rel=1e-4)
    assert fit_hmr2.output_gap(ref, ref) == 0.0
    nan = (ref[0] * float('nan'),) + ref[1:]
    assert fit_hmr2.output_gap(nan, ref) == float('inf')


def test_loss_altered_is_caught(tmp_path, monkeypatch):
    from portbench.drivers import fit_hmr2
    from tuch_tpu_torch.fitting import eft
    loss = eft.eft_loss

    def altered(*args, **kwargs):
        total, parts = loss(*args, **kwargs)
        return total * 1.01, parts
    monkeypatch.setattr(eft, 'eft_loss', altered)
    _, checks = toy.run_cell(fit_hmr2, fit_ctx(tmp_path))
    assert not toy.correct(checks), checks


def test_drop_path_ignored_is_caught(tmp_path, monkeypatch):
    """A program that keeps every branch (no drop path) differs from the
    reference fed the same masks."""
    from portbench.drivers import fit_hmr2
    from tuch_tpu_torch.models import vit
    monkeypatch.setattr(vit, 'drop_path', lambda x, keep, prob: x)
    _, checks = toy.run_cell(fit_hmr2, fit_ctx(tmp_path))
    assert not toy.correct(checks), checks


def test_a_traced_toy_window_reads_the_host_metrics(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    from portbench.common import Trace
    from portbench.drivers import fit_hmr2
    ctx = fit_ctx(tmp_path)
    cell = fit_hmr2.Cell(ctx)
    try:
        cell.setup()
        prof = profile(activities=[ProfilerActivity.CPU])
        res = cell.window(0.5, prof)
    finally:
        cell.release()
    trace = Trace(prof, fit_hmr2.SPANS)
    ctx.update(trace=trace, result=res)
    names = [s[0] for s in trace.spans]
    assert names.count('hmr.backbone') == sum(res['steps'])
    assert run.load_reader('hmr_host_ms.fit')(ctx) > 0
    assert run.load_reader('mfu.fit_hmr2')(ctx) > 0
    # a CPU trace holds no device operation and the CPU launches no kernel
    assert run.load_reader('hmr_device_ms.fit_hmr2')(ctx) is None
    assert run.load_reader('mha_roofline.fit_hmr2')(ctx) is None
