"""tuch_tpu_torch's cli/eval against tuch_tpu's, on the CPU.

cli/eval --synthetic --device cpu on the JAX package's weights (its .npz
tree as --checkpoint): the report against the JAX package's cli/eval at
rtol 1e-4 (the run_evaluation bar of tests/test_torch_port_eval.py), and
with --bn_fold within 0.01 mm of it (chip_smoke.py phase 14's bar);
--mesh_dp 2 and a run without --device cpu raise. Both packages crop with
their default warp, as in tests/test_torch_port_loader.py.
"""

import re

import jax
import numpy as np
import pytest

from tests._torch_train_parity import (  # noqa: F401
    few_torch_threads, save_jax_npz)
from tuch_tpu import runtime as jrt
from tuch_tpu.cli import eval as jeval_cli
from tuch_tpu_torch.cli import eval as peval_cli

RTOL = 1e-4
BN_FOLD_MM = 0.01


pytestmark = pytest.mark.usefixtures('few_torch_threads')


def _jax_report(capsys, argv):
    jeval_cli.main(argv)
    out = capsys.readouterr().out
    return {k: float(v) for k, v in re.findall(r'  (\w+): ([-\d.]+)', out)}


def test_eval_cli_matches_jax_and_bn_fold(tmp_path, monkeypatch, capsys):
    jr = jrt.build_runtime(synthetic=True, num_verts=170, img_res=64,
                           with_contact=False, with_hd=False)
    variables = jax.tree_util.tree_map(np.asarray, jr.variables)
    monkeypatch.chdir(tmp_path)
    save_jax_npz(variables, tmp_path / 'w.npz')
    argv = ['--synthetic', '--synthetic_num_verts', '170',
            '--synthetic_samples', '6', '--batch_size', '4',
            '--num_workers', '0', '--dataset', '3dpw',
            '--checkpoint', str(tmp_path / 'w.npz')]
    want = _jax_report(capsys, argv)
    got = peval_cli.main(argv + ['--device', 'cpu'])
    folded = peval_cli.main(argv + ['--device', 'cpu', '--bn_fold'])
    assert set(got) == set(want) == {'mpjpe', 'pa_mpjpe'}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
        assert abs(folded[k] - got[k]) <= BN_FOLD_MM, k
    # one process cannot hold a 2-rank mesh (the working one:
    # tests/test_torch_port_parallel_eval.py)
    with pytest.raises(ValueError, match='torchrun --nproc_per_node 2'):
        peval_cli.main(argv + ['--device', 'cpu', '--mesh_dp', '2'])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        peval_cli.main(argv)
    (tmp_path / 'w.npz').unlink()
