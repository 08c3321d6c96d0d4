"""Toy-size cells for the CPU tests: the configurations and traffic mixes
of BENCHMARK.json with the body, the image size and the step counts cut so
that a test run holds them (widths are the configuration's own)."""

import json
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / 'portbench'


def load(kind, name):
    return json.loads((PB / kind / f'{name}.json').read_text())


def fit_ctx(seed=2 ** 31 + 9, tmp=None):
    cfg = load('configs', 'hmr_r50')
    cfg.update(num_verts=170, img_res=64)
    traffic = load('workloads', 'eft_b1')
    traffic.update(max_steps=4, min_steps=1)
    return _ctx(cfg, traffic, seed, tmp)


def _ctx(cfg, traffic, seed, tmp):
    tmp = Path(tmp) if tmp is not None else Path(tempfile.mkdtemp())
    tmp.mkdir(parents=True, exist_ok=True)
    return dict(root=ROOT, cell={}, config=cfg, traffic=traffic, seed=seed,
                seconds=1.0, control=False, tmp=tmp, device='cpu')


def run_cell(driver, ctx):
    """setup, a window of ctx['seconds'], release, check: (window result,
    checks)."""
    cell = driver.Cell(ctx)
    try:
        cell.setup()
        res = cell.window(ctx['seconds'])
    finally:
        cell.release()
    return res, cell.check()


def correct(checks):
    return all(c['value'] <= c['limit'] for c in checks)
