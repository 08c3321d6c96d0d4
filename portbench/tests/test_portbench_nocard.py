"""A run without a card fails and never falls back to the CPU; so does a
run in a directory that holds only BENCHMARK.json and the benchmark's
files."""

import json
import os
import shutil
import subprocess
import sys

from portbench.tests.toy import ROOT

CELLS = [w['name'] for w in json.loads(
    (ROOT / 'BENCHMARK.json').read_text())['workloads']]


def _run(cwd, cell, env=None):
    return subprocess.run(
        [sys.executable, 'portbench/run.py', '--workload', cell, '--seed',
         str(2 ** 31 + 3), '--seconds', '1', '--trace', '0'], cwd=cwd,
        capture_output=True, text=True, timeout=300, env=env)


def _no_result(out):
    assert out.returncode != 0
    assert not any(line.startswith('{') for line in out.stdout.splitlines())


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    for cell in CELLS:
        out = _run(ROOT, cell, env)
        _no_result(out)
        assert 'CUDA' in out.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(ROOT / 'portbench', tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    _no_result(_run(tmp_path, CELLS[0]))
