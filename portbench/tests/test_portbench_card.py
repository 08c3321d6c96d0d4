"""On the card: each cell's control (the nearest lower precision, TF32 on,
in the program's place) comes out not correct on three seeds, and the
program as the configuration states comes out correct. A short window:
the readings need none longer.

  python3 -m pytest -m cuda portbench/tests/test_portbench_card.py
"""

import json
import subprocess
import sys

import pytest

from portbench.tests.toy import ROOT

CELLS = [w['name'] for w in json.loads(
    (ROOT / 'BENCHMARK.json').read_text())['workloads']]
SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


def _result(cell, seed, *flags):
    out = subprocess.run(
        [sys.executable, 'portbench/run.py', '--workload', cell, '--seed',
         str(seed), '--seconds', '2', '--trace', '0', *flags], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')


@pytest.mark.cuda
@pytest.mark.parametrize('cell', CELLS)
def test_control_is_not_correct(cell):
    _card()
    for seed in SEEDS:
        line = _result(cell, seed, '--control')
        assert line['correct'] is False, line['checks']


@pytest.mark.cuda
@pytest.mark.parametrize('cell', CELLS)
def test_the_program_is_correct(cell):
    _card()
    line = _result(cell, SEEDS[0])
    assert line['correct'] is True, line['checks']
