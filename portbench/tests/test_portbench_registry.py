"""Driven by data: a configuration, a traffic mix, a driver and a per-layer
metric reader dropped into their folders are found by the names in
BENCHMARK.json, with no file that is already there edited."""

import hashlib
import json
import shutil
import subprocess
import sys

from portbench.tests.toy import ROOT


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / 'portbench').rglob('*')
            if p.is_file() and '__pycache__' not in p.parts}


def test_new_files_are_picked_up(tmp_path):
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(ROOT / 'portbench', tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    before = _digests(tmp_path)
    pb = tmp_path / 'portbench'
    (pb / 'configs' / 'toy_new.json').write_text(json.dumps(
        {'name': 'toy_new', 'width': 7}))
    (pb / 'workloads' / 'toy_mix.json').write_text(json.dumps(
        {'driver': 'toy_driver', 'rate': 3}))
    (pb / 'drivers' / 'toy_driver.py').write_text(
        'class Cell:\n'
        '    span_prefixes = ()\n'
        '    def __init__(self, ctx):\n'
        '        self.ctx = ctx\n')
    (pb / 'metrics' / 'toy_metric.new.py').write_text(
        'def read(ctx):\n'
        "    return ctx['config']['width'] * ctx['traffic']['rate']\n")
    bench = json.loads((tmp_path / 'BENCHMARK.json').read_text())
    bench['configs'].append({'name': 'toy_new', 'source': 'x',
                             'file': 'portbench/configs/toy_new.json',
                             'reduced': [], 'why': 'x'})
    bench['workloads'].append({'name': 'toy.cell', 'config': 'toy_new',
                               'traffic': 'toy_mix', 'chips': 1,
                               'why': 'x'})
    bench['per_layer'].append({'name': 'toy_metric.new', 'unit': 'x',
                               'better': 'higher', 'source': 'host_clock',
                               'layer': 'x', 'moves': 'setup_s'})
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(bench))
    code = '''
import importlib, sys
sys.path.insert(0, '.')
from portbench import run
cell, cfg, traffic, e2e, per_layer = run.load_cell('toy.cell')
driver = importlib.import_module('portbench.drivers.' + traffic['driver'])
c = driver.Cell({'config': cfg})
read = run.load_reader('toy_metric.new')
print(cfg['width'], traffic['rate'], [m['name'] for m in e2e],
      'toy_metric.new' in [m['name'] for m in per_layer],
      read({'config': cfg, 'traffic': traffic}))
'''
    out = subprocess.run([sys.executable, '-c', code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ['7', '3', "['setup_s']", 'True', '21']
    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
