"""tuch_tpu_torch's training step on a device mesh against tuch_tpu's
single-device step, on gloo CPU ranks (tests/_torch_dist.py).

The JAX package's mesh is one program: its step over a dp-sharded batch
computes the single-device step. The port runs one process per rank and
reduces by hand (train/module.py), so each rank's share is held against
the JAX package's jitted single-device step on the global batch, element
by element at the slice-4 bars of tests/_torch_train_parity.py: the
vit_t8 --run_smplify step (2 fit iterations, the HD contact loss) on dp=2,
cp=2 and dp=2 x cp=2 over two steps carrying the state; a batch whose
compactions overflow unevenly across the ranks and that names one fits
row on two ranks; the cp ranks' parameters bit for bit equal after two
steps; ResNet-50's BatchNorm over 2 dp ranks against one process on the
whole batch (outputs, running statistics and gradients, in float64: its
float32 rounding is amplified, ROADMAP's trap); and cli/train --mesh_dp 2
for 2 steps against one process.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from tests import _torch_dist as D
from tests import _torch_train_parity as T
from tests._torch_train_parity import few_torch_threads  # noqa: F401
from tuch_tpu_torch import config as pcfg
from tuch_tpu_torch.cli import train as ptrain
from tuch_tpu_torch.models import convert as PC
from tuch_tpu_torch.models.hmr import HMR, draw_dropout_masks

BG = 4                    # the global batch
ON = dict(run_smplify=True, num_smplify_iters=2, smplify_threshold=1e9)
# compactions of 2 (a multiple of dp): SMPLify-DC's active samples 0-2 of
# which 0 and 1 run, both on rank 0 of dp=2, rank 1 none
COUPLED = dict(ON, smplify_contact_capacity=2, regressor_contact_capacity=2)
MESHES = [(2, 1), (1, 2), (2, 2)]
# float64 BatchNorm over ranks against one process: the sums run in
# another order (and the variance as E[x^2] - E[x]^2), amplified through
# 16 bottlenecks at random init
BN64_RTOL, BN64_ATOL = 1e-9, 1e-12


@pytest.fixture(scope='module')
def pair():
    return T.Pair('vit_t8')


def _batch(pair, seed, coupled=False):
    b = T.make_batch(pair.num_classes, np.random.RandomState(seed), B=BG)
    if coupled:
        b['has_smpl'] = np.array([0, 0, 0, 1], np.float32)
        b['has_disc_contact'] = np.ones(BG, np.float32)
        b['fits_index'] = np.array([3, 1, 2, 3], np.int32)
    return b


def _jax_run(pair, batches, fits, kw):
    """The JAX package's single-device steps, their dropout masks and
    results."""
    jstep = pair.jax_step(**kw)
    js = pair.jax_state(fits)
    runs, masks = [], []
    for batch in batches:
        masks.append(T.jax_dropout_masks(pair.jr.hmr, pair.variables, js,
                                         batch_size=BG))
        js, jm, jo = jstep(js, batch)
        runs.append((js, jm, jo))
    return runs, masks


def _payload(pair, batches, masks, fits, kw, dp, cp):
    return dict(
        dp=dp, cp=cp, num_verts=T.NV, backbone='vit_t8',
        init_pose=T.fold_pose6d(),
        weights=PC.from_jax_variables(pair.variables), fits=fits,
        options=dict(backbone='vit_t8', batch_size=BG, img_res=T.IMG, **kw),
        batches=batches, masks=masks)


def _global(out, step, key):
    """A step's per-rank outputs as the global batch (cp rank 0 of each dp
    row, in dp order)."""
    mine = sorted((r for r in out if r['cp_rank'] == 0),
                  key=lambda r: r['dp_rank'])
    return torch.cat([r['steps'][step]['outputs'][key] for r in mine])


@pytest.fixture(scope='module', params=MESHES,
                ids=[f'dp{d}xcp{c}' for d, c in MESHES])
def two_steps(request, pair, tmp_path_factory):
    dp, cp = request.param
    batches = [_batch(pair, 1), _batch(pair, 2)]
    fits = T.initial_fits(6)
    runs, masks = _jax_run(pair, batches, fits, ON)
    out = D.spawn('train_step', dp * cp, tmp_path_factory.mktemp('train'),
                  _payload(pair, batches, masks, fits, ON, dp, cp))
    return dp, cp, runs, out, fits


def test_vit_t8_step_on_a_mesh_matches_jax(two_steps):
    """Two steps carrying the state: the loss and every loss_dict entry,
    every gradient (Adam's first moment), the parameters, the fits rows
    and opt_vertices, on every rank."""
    dp, cp, runs, out, fits = two_steps
    wants = [T.jax_tensors(r[0]) for r in runs]
    bars = T.moment_bars([w['mu'] for w in wants])
    for r in out:
        lim = None
        for i, ((js, jm, jo), want, bar) in enumerate(zip(runs, wants,
                                                          bars)):
            ps = r['steps'][i]
            T.assert_losses_close(jm, ps['metrics'])
            T.assert_grads_close(want, ps)
            lim = T.assert_params_close(want, ps, bar, lim)
            po = {k: _global(out, i, k) for k in ('opt_vertices',
                                                  'fit_accepted')}
            T.assert_fits_and_vertices_close(js, jo, ps, po, fits)
        assert r['steps'][1]['step'] == 2


def test_cp_ranks_parameters_bit_for_bit(two_steps):
    """The ranks of a cp group run the same step on the same slice: after
    two steps their parameters, Adam's moments and fits are equal bit for
    bit; and the step went through the cp contact route on cp > 1."""
    dp, cp, runs, out, _ = two_steps
    for r in out:
        peer = out[r['dp_rank'] * cp]
        last, plast = r['steps'][-1], peer['steps'][-1]
        for part in ('params', 'mu'):
            for k, v in last[part].items():
                assert torch.equal(v, plast[part][k]), (part, k)
        assert torch.equal(last['fits'], plast['fits'])
        # every rank holds the same fits store
        assert torch.equal(last['fits'], out[0]['steps'][-1]['fits'])
        if cp > 1:
            assert r['cp_calls']['contact_neighbors_cp'] > 0
        else:
            assert sum(r['cp_calls'].values()) == 0


@pytest.fixture(scope='module')
def coupled(pair, tmp_path_factory):
    batches = [_batch(pair, 3, coupled=True)]
    fits = T.initial_fits(7)
    runs, masks = _jax_run(pair, batches, fits, COUPLED)
    out = D.spawn('train_step', 2, tmp_path_factory.mktemp('coupled'),
                  _payload(pair, batches, masks, fits, COUPLED, 2, 1))
    return runs, out, fits, batches[0]


def test_uneven_compaction_picks_jax_samples(coupled):
    """SMPLify-DC's compaction of 2 over the global batch takes samples 0
    and 1, both rank 0's; the regressor's takes 0 and 1 too. Rank 1 runs
    no contact quadratics, and the step equals the JAX package's:
    losses (the overflow fractions among them), gradients, parameters."""
    (js, jm, jo), = coupled[0]
    out = coupled[1]
    want = T.jax_tensors(js)
    bar = T.moment_bars([want['mu']])[0]
    assert float(jm['smplify_contact_truncated_frac']) > 0
    assert float(jm['contact_valid_truncated_frac']) > 0
    for r in out:
        ps = r['steps'][0]
        T.assert_losses_close(jm, ps['metrics'])
        T.assert_grads_close(want, ps)
        T.assert_params_close(want, ps, bar)
    np.testing.assert_allclose(_global(out, 0, 'opt_vertices').numpy(),
                               np.asarray(jo['opt_vertices']), rtol=0,
                               atol=T.VERTEX_ATOL)


def test_repeated_fits_row_last_occurrence_wins(coupled, pair):
    """Fits row 3 is named by sample 0 (rank 0) and sample 3 (rank 1):
    every rank writes the global batch's last occurrence, as the port's
    single process does, and the store equals the JAX package's."""
    (js, _, _), = coupled[0]
    out, fits, batch = coupled[1], coupled[2], coupled[3]
    stores = [r['steps'][0]['fits'] for r in out]
    assert all(torch.equal(s, stores[0]) for s in stores)
    _, popts = pair.options(**COUPLED)
    ps = pair.port_state(fits, popts.lr)
    step = T.PM.make_train_step(pair.assets, pcfg.TrainConfig(
        backbone='vit_t8', batch_size=BG, img_res=T.IMG, **COUPLED))
    masks = T.jax_dropout_masks(pair.jr.hmr, pair.variables,
                                pair.jax_state(fits), batch_size=BG)
    single, _, _ = step(ps, batch, dropout=masks)
    np.testing.assert_allclose(stores[0].numpy(), single.fits.numpy(),
                               rtol=0, atol=T.VERTEX_ATOL)
    np.testing.assert_allclose(stores[0].numpy(), np.asarray(js.fits),
                               rtol=0, atol=T.VERTEX_ATOL)
    assert not np.array_equal(stores[0][3].numpy(), fits[3])


def test_batchnorm_over_dp_equals_whole_batch(tmp_path, few_torch_threads):
    """ResNet-50's train-mode BatchNorm over 2 dp ranks, each with half of
    the batch, against one process on the whole batch, in float64:
    outputs, running statistics and the gradients (summed over dp)."""
    rng = np.random.RandomState(0)
    mean = (T.fold_pose6d(), np.zeros(10, np.float32),
            np.array([0.9, 0, 0], np.float32))
    torch.manual_seed(0)
    hmr = HMR(*mean, backbone='resnet50')
    weights = {k: v.clone() for k, v in hmr.state_dict().items()}
    img = (rng.randn(BG, T.IMG, T.IMG, 3) * 0.5).astype(np.float32)
    masks = draw_dropout_masks(BG, torch.Generator().manual_seed(1))
    w = [rng.randn(BG, n).astype(np.float64) for n in (24 * 9, 10, 3)]
    out = D.spawn('batchnorm', 2, tmp_path, dict(
        dp=2, mean=mean, weights=weights, img=img, masks=masks, w=w))
    ref = hmr.double().train()
    ref.dtype = torch.float64
    outs = ref(torch.from_numpy(img).double(), dropout=masks)
    loss = sum((o.reshape(BG, -1) * torch.from_numpy(x)).sum()
               for o, x in zip(outs, w))
    names, params = zip(*ref.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, params)))

    def close(got, want, what):
        np.testing.assert_allclose(
            got.numpy(), want.detach().numpy(), rtol=BN64_RTOL,
            atol=BN64_ATOL * max(1.0, float(want.detach().abs().max())),
            err_msg=what)

    for r in out:
        lo = r['dp_rank'] * BG // 2
        for o, o_ref in zip(r['outputs'], outs):
            close(o, o_ref[lo:lo + BG // 2], 'outputs')
        for k, v in ref.named_buffers():
            close(r['buffers'][k], v, k)
        for k, g in grads.items():
            close(r['grads'][k], g, k)


def _train_argv(tmp_path, name):
    return ['--synthetic', '--synthetic_num_verts', str(T.NV), '--img_res',
            str(T.IMG), '--batch_size', '4', '--num_epochs', '1',
            '--num_workers', '0', '--backbone', 'vit_t8', '--run_smplify',
            '--num_smplify_iters', '2', '--val_and_checkpoint_freq', '0.5',
            '--device', 'cpu', '--log_dir', str(tmp_path), '--name', name]


def _checkpoint_path(tmp_path, name, step):
    path, = [p for p in glob.glob(os.path.join(
        str(tmp_path), name, 'checkpoints', f'*_step{step}_*'))
        if not p.endswith('.meta.json')]
    assert os.path.isfile(path + '.meta.json')
    return path


def _checkpoint(tmp_path, name, step):
    return torch.load(_checkpoint_path(tmp_path, name, step),
                      map_location='cpu', weights_only=True)


@pytest.fixture(scope='module')
def cli_runs(tmp_path_factory, few_torch_threads):
    """cli/train for an epoch of 16 synthetic samples (4 steps of 4,
    checkpoints after steps 2 and 4): in one process; with --mesh_dp 2 on
    2 ranks; and on 2 ranks resumed from the mesh run's step-2
    checkpoint into a new log directory."""
    d = tmp_path_factory.mktemp('cli_train')
    ptrain.main(_train_argv(d, 'one'))
    D.spawn('train_cli', 2, d, dict(
        argv=_train_argv(d, 'mesh') + ['--mesh_dp', '2']))
    D.spawn('train_cli', 2, d, dict(
        argv=_train_argv(d, 'resumed') + [
            '--mesh_dp', '2', '--resume', '--checkpoint',
            _checkpoint_path(d, 'mesh', 2)]))
    return d


def test_train_cli_mesh_dp2_matches_one_process(cli_runs):
    """cli/train --mesh_dp 2 against the same command in one process: rank
    0 alone writes the checkpoints and metrics; the parameters, Adam's
    moments and fits of the step-2 checkpoint at the slice-4 bars
    (gradients rtol 1e-3; fits 1e-3), every logged loss at rtol 1e-4."""
    one, mesh = (_checkpoint(cli_runs, n, 2) for n in ('one', 'mesh'))
    for k, v in one['model'].items():
        np.testing.assert_allclose(mesh['model'][k].numpy(), v.numpy(),
                                   rtol=1e-4, atol=2e-5, err_msg=k)
    for k, v in one['mu'].items():
        np.testing.assert_allclose(
            mesh['mu'][k].numpy(), v.numpy(), rtol=T.GRAD_RTOL,
            atol=T.GRAD_ATOL * float(v.abs().max()) + 1e-12, err_msg=k)
    np.testing.assert_allclose(mesh['fits'].numpy(), one['fits'].numpy(),
                               rtol=0, atol=T.VERTEX_ATOL)
    logs = {}
    for name in ('one', 'mesh'):
        path = os.path.join(str(cli_runs), name, 'tensorboard',
                            'metrics.jsonl')
        with open(path) as f:
            logs[name] = [json.loads(line) for line in f
                          if '"train/loss"' in line]
    assert len(logs['one']) == len(logs['mesh']) == 4
    for a, b in zip(logs['one'], logs['mesh']):
        np.testing.assert_allclose(b['train/loss'], a['train/loss'],
                                   rtol=1e-4)


def test_train_cli_mesh_resume_equals_straight_run(cli_runs):
    """A mesh run resumed from its step-2 checkpoint (rank 0 restores and
    broadcasts the state and the loader's position) ends where the
    straight mesh run ends, bit for bit."""
    straight, resumed = (_checkpoint(cli_runs, n, 4)
                         for n in ('mesh', 'resumed'))
    assert resumed['step'] == straight['step'] == 4
    assert resumed['count'] == straight['count']
    for part in ('model', 'mu', 'nu'):
        for k, v in straight[part].items():
            assert torch.equal(resumed[part][k], v), (part, k)
    assert torch.equal(resumed['fits'], straight['fits'])
    assert torch.equal(resumed['generator'], straight['generator'])
