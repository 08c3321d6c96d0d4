"""The real-format paths of cli/train and cli/eval through a full SMPL
forward, against the JAX package on the CPU (ROADMAP fault 7).

On the tree tests/_torch_real_smpl.py writes (a real-format SMPL pickle of
the synthetic full-topology body, 6890 vertices, and the databases of the
port's own cli/preprocess --synthetic), with vit_t8 at 64 px:
- cli/train --run_smplify without --synthetic: the port's trainer (built
  by its cli/train) and the JAX package's hand their steps the same
  batches bit for bit; then one step of each on the first batch, from the
  same weights and fits with the JAX step's dropout masks, is held at the
  training step's bars (tests/_torch_train_parity.py: every loss at rtol
  1e-4, the gradients element by element, the accept mask, the fits rows
  and opt_vertices at 1e-3);
- cli/eval on the 3DPW test database, on the JAX package's weights: the
  report at rtol 1e-4, the bar of tests/test_torch_port_eval_cli.py.
"""

import re

import jax
import numpy as np
import pytest

from tests._torch_real_smpl import (asset_tree, full_body,  # noqa: F401
                                    full_body_tree, real_dbs)
from tests._torch_train_parity import (assert_fits_and_vertices_close,
                                       assert_grads_close,
                                       assert_losses_close,
                                       few_torch_threads,  # noqa: F401
                                       jax_dropout_masks, jax_tensors,
                                       save_jax_npz, snapshot)
from tuch_tpu import config as jcfg
from tuch_tpu import runtime as jrt
from tuch_tpu.cli import eval as jeval_cli
from tuch_tpu.data.mixed import MixedDataset as JMixed
from tuch_tpu.train import trainer as JT
from tuch_tpu_torch import config as pcfg
from tuch_tpu_torch.cli import eval as peval_cli
from tuch_tpu_torch.cli import train as ptrain
from tuch_tpu_torch.models.convert import from_jax_variables
from tuch_tpu_torch.runtime import load_hmr_weights

pytestmark = pytest.mark.usefixtures('few_torch_threads')

# one body a step and one fit iteration: the plain winding numbers of the
# full body (6890 points x 13776 faces, five calls a step) take most of
# the port's CPU step
FLAGS = ['--ds_names', 'dsc', 'mtp', '--ds_composition', '0.6', '0.4',
         '--img_res', '64', '--batch_size', '1', '--num_epochs', '1',
         '--num_workers', '0', '--val_and_checkpoint_freq', '0',
         '--backbone', 'vit_t8', '--run_smplify', '--num_smplify_iters', '1']
EVAL_RTOL = 1e-4


def _first_batch(trainer):
    """The first batch the trainer's loop hands its step (the loop stops
    there)."""
    seen = []

    def step(state, batch, *a, **kw):
        seen.append(batch)
        trainer.endtime = 0.0        # the time-budget exit after this step
        return state, {}, {}
    trainer.step_fn, step_fn = step, trainer.step_fn
    trainer.renderer = None
    trainer.fit()
    trainer.step_fn = step_fn
    return seen[0]


def test_train_real_format_step_on_the_full_body(real_dbs, tmp_path):
    argv = FLAGS + ['--log_dir', str(tmp_path / 'logs')]
    pt = ptrain.build(pcfg.parse_config(
        pcfg.TrainConfig, argv + ['--name', 'p', '--device', 'cpu']))
    jopts = jcfg.parse_config(jcfg.TrainConfig, argv + ['--name', 'j'])
    jr = jrt.build_runtime(jopts, img_res=64)
    P = len(jr.contact_classes)
    assert P == len(pt.assets.contact.region_idx_a) == 28
    assert pt.assets.smpl.v_template.shape[0] == 6890
    jt = JT.Trainer(jopts, jr.hmr, jr.variables, jr.assets,
                    JMixed(jopts, 'train', num_contact_classes=P),
                    JMixed(jopts, 'val', num_contact_classes=P).datasets[0])
    assert pt.train_ds.dataset_list == jt.train_ds.dataset_list
    js0 = jt.state
    got, want = _first_batch(pt), _first_batch(jt)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    variables = jax.tree_util.tree_map(np.asarray, jr.variables)
    load_hmr_weights(pt.state.hmr, from_jax_variables(variables))
    fits0 = np.asarray(js0.fits)
    np.testing.assert_array_equal(pt.state.fits.numpy(), fits0)
    masks = jax_dropout_masks(jr.hmr, variables, js0, batch_size=1)
    js, jm, jo = jt.step_fn(js0, want)
    ps, pm, po = pt.step_fn(pt.state, got, dropout=masks)
    assert_losses_close(jm, pm)
    assert_grads_close(jax_tensors(js), snapshot(ps))
    assert_fits_and_vertices_close(js, jo, snapshot(ps), po, fits0,
                                   rows=want['fits_index'])
    assert po['opt_vertices'].shape[1] == 6890


def _jax_report(capsys, argv):
    jeval_cli.main(argv)
    out = capsys.readouterr().out
    return {k: float(v) for k, v in re.findall(r'  (\w+): ([-\d.]+)', out)}


def test_eval_real_format_3dpw_on_the_full_body(real_dbs, tmp_path,
                                                capsys):
    jr = jrt.build_runtime(synthetic=False, img_res=64, with_contact=False,
                           with_hd=False)
    save_jax_npz(jax.tree_util.tree_map(np.asarray, jr.variables),
                 tmp_path / 'w.npz')
    argv = ['--dataset', '3dpw', '--batch_size', '4', '--num_workers', '0',
            '--checkpoint', str(tmp_path / 'w.npz')]
    want = _jax_report(capsys, argv)
    got = peval_cli.main(argv + ['--device', 'cpu'])
    assert set(got) == set(want) and want
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=EVAL_RTOL,
                                   err_msg=k)
