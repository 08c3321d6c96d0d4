"""The import guard: nothing a run imports has the top-level name jax,
jaxlib, flax or tuch_tpu (tuch_tpu_torch, the program, is allowed on the
program's side), and the plain reference imports nothing of the program.
Each check runs in a fresh interpreter."""

import subprocess
import sys

from portbench import run
from portbench.tests.toy import ROOT


def _fresh(code):
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_names_are_compared_whole(monkeypatch):
    for name in ('tuch_tpu_torch', 'tuch_tpu_torch.ops', 'jaxtyping',
                 'flaxen'):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not set(run.forbidden_modules()) & {
        'tuch_tpu_torch', 'tuch_tpu_torch.ops', 'jaxtyping', 'flaxen'}
    monkeypatch.setitem(sys.modules, 'tuch_tpu.models', sys)
    monkeypatch.setitem(sys.modules, 'jax.numpy', sys)
    assert {'tuch_tpu.models', 'jax.numpy'} <= set(run.forbidden_modules())


def test_a_toy_run_of_the_driver_imports_nothing_forbidden():
    code = '''
import sys, torch
torch.set_num_threads(2)
from portbench import run
from portbench.drivers import fit
from portbench.tests import toy
toy.run_cell(fit, toy.fit_ctx())
print(run.forbidden_modules())
'''
    assert _fresh(code) == '[]'


def test_the_reference_imports_nothing_of_the_program():
    code = '''
import sys, pkgutil, importlib
import portbench.reference as R
from portbench.reference import fit_ref
import portbench.reference.tuchref as T
for m in pkgutil.walk_packages(T.__path__, T.__name__ + '.'):
    importlib.import_module(m.name)
print(sorted({m.split('.')[0] for m in sys.modules} &
             {'tuch_tpu_torch', 'tuch_tpu', 'jax', 'jaxlib', 'flax'}))
'''
    assert _fresh(code) == '[]'
