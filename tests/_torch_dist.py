"""Ranks of the port's device mesh as gloo processes on the CPU, for the
parallel tests (not a test module).

spawn(case, world, tmp) starts `world` processes with the spawn method,
each a rank of a process group initialised through a file under tmp (no
TCP port, so that pytest-xdist's workers cannot collide), runs CASES[case]
on the payload the test saved, and returns every rank's result in rank
order. Every rank waits at most COLLECTIVE_TIMEOUT_S in a collective and
the test at most JOIN_TIMEOUT_S for all of them, so a hang fails its test.
This module and what its children import never import JAX.
"""

import os
import time
import uuid
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

COLLECTIVE_TIMEOUT_S = 120.0
JOIN_TIMEOUT_S = 300.0
THREADS = 2       # intra-op threads a rank (the suite runs 6 workers)


def spawn(case: str, world: int, tmp, payload=None,
          timeout: float = JOIN_TIMEOUT_S):
    tmp = Path(tmp) / f'{case}_{world}_{uuid.uuid4().hex[:8]}'
    tmp.mkdir(parents=True)
    torch.save(payload, tmp / 'in.pt')
    ctx = mp.start_processes(
        _entry, args=(world, str(tmp), case), nprocs=world, join=False,
        start_method='spawn')
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f'{case} on {world} ranks: no end within '
                                   f'{timeout} s')
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [torch.load(tmp / f'{r}.pt', weights_only=False)
            for r in range(world)]


def _entry(rank, world, tmp, case):
    torch.set_num_threads(THREADS)
    from tuch_tpu_torch.parallel import multihost
    tmp = Path(tmp)
    multihost.maybe_initialize_distributed(
        'cpu', init_method=f'file://{tmp / "init"}', world_size=world,
        rank=rank, timeout_s=COLLECTIVE_TIMEOUT_S)
    done = False
    try:
        payload = torch.load(tmp / 'in.pt', weights_only=False)
        out = CASES[case](payload)
        torch.save(out, tmp / f'{rank}.pt.tmp')
        os.replace(tmp / f'{rank}.pt.tmp', tmp / f'{rank}.pt')
        done = True
    finally:
        # a case may end the group itself (cli/train's main does); a rank
        # that failed leaves at once, and the test kills its peers
        if dist.is_initialized():
            if done:
                dist.barrier()
            dist.destroy_process_group()


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# Contact on a cp mesh (tests/test_torch_port_parallel.py)
# ---------------------------------------------------------------------------

def _contact(p):
    """On a (dp, cp) mesh: winding on the unit cube, contact_neighbors
    exact and with candidate_k, masked_min_cp, the contact fitting loss
    full and compacted, each rank on its dp rows."""
    from tuch_tpu_torch.losses import smplify as SL
    from tuch_tpu_torch.models.convert import (contact_assets_from_numpy,
                                               prior_from_numpy)
    from tuch_tpu_torch.parallel import contact_parallel as CPAR
    from tuch_tpu_torch.parallel import mesh as PM
    mesh = PM.make_mesh(dp=p['dp'], cp=p['cp'], device='cpu')
    out = {'dp_rank': mesh.dp_rank, 'cp_rank': mesh.cp_rank}

    cube_pts, cube_v = (PM.shard_rows(_t(p[k]), mesh)
                        for k in ('cube_pts', 'cube_verts'))
    out['winding'] = CPAR.winding_numbers_cp(
        cube_pts, cube_v, _t(p['cube_faces']), mesh)

    ca = contact_assets_from_numpy(p['assets'])
    verts = PM.shard_rows(_t(p['verts']), mesh)
    n0 = dict(CPAR.CP_CALLS)
    out['exterior'], out['argmin'] = SL.contact_neighbors(verts, ca,
                                                          mesh=mesh)
    out['cp_calls'] = {k: CPAR.CP_CALLS[k] - n0[k] for k in n0}
    out['exterior_k'], out['argmin_k'] = SL.contact_neighbors(
        verts, ca, mesh=mesh, candidate_k=p['K'])
    out['min_d2'], out['argmin_mm'] = CPAR.masked_min_cp(
        verts, ca.geomask, ca.geomask_bits, mesh)

    prior = prior_from_numpy(*p['prior'])
    for name, loss in p['losses'].items():
        rows = {k: PM.shard_rows(_t(v), mesh) for k, v in loss.items()
                if k not in ('compact',)}
        idx = None
        if loss.get('compact') is not None:
            idx = PM.local_compact(_t(loss['compact']), mesh,
                                   rows['verts'].shape[0])
        out[f'loss_{name}'] = SL.contact_fitting_loss(
            rows['pose'][:, 3:], rows['pose'][:, :3], rows['betas'],
            rows['joints'], rows['verts'], rows['cam_t'], rows['cc'],
            rows['kp2d'], rows['conf'], prior, ca, rows['gt_contact'],
            rows['ignore'], rows['has_disc'], euclthres=0.02, mesh=mesh,
            compact_idx=idx)

    batch = {'x': _t(p['batch_x'])}
    local = PM.shard_batch(batch, mesh)
    out['batch_local'] = local['x']
    out['batch_back'] = PM.dp_gather(local['x'], mesh)
    from tuch_tpu_torch.parallel.multihost import process_shard, shard_size
    out['process_shard'] = process_shard(p['shard_n'])
    out['shard_size'] = shard_size(p['shard_n'])
    return out


CASES = {'contact': _contact}


# ---------------------------------------------------------------------------
# The training step on a mesh (tests/test_torch_port_parallel_train.py)
# ---------------------------------------------------------------------------

def _port_pair(p, device='cpu'):
    """The port's runtime of tests/_torch_train_parity.Pair, built without
    JAX: the HMR gets the JAX package's weights as a state dict."""
    from tuch_tpu_torch import runtime as prt
    from tuch_tpu_torch.train import module as TM
    pr = prt.build_runtime(device=device, synthetic=True,
                           num_verts=p['num_verts'], backbone=p['backbone'],
                           with_contact=True, with_hd=True)
    pr.hmr.init_pose.copy_(_t(p['init_pose'])[None])
    prt.load_hmr_weights(pr.hmr, p['weights'])
    return pr, TM.TuchAssets(pr.smpl, pr.prior, pr.contact, pr.hd)


def _snapshot(state, metrics, outputs):
    return dict(
        mu={k: v.clone() for k, v in state.opt.mu.items()},
        params={k: v.detach().clone()
                for k, v in state.hmr.named_parameters()},
        buffers={k: v.clone() for k, v in state.hmr.named_buffers()},
        fits=state.fits.clone(), step=state.step,
        metrics={k: float(v) for k, v in metrics.items()},
        outputs={k: outputs[k].clone()
                 for k in ('opt_vertices', 'fit_accepted')})


def _train_step(p):
    """n steps of the port's train step on a (dp, cp) mesh from the JAX
    package's weights, each on the global batch's dp slice and the global
    dropout masks."""
    from tuch_tpu_torch import config as pcfg
    from tuch_tpu_torch.parallel import contact_parallel as CPAR
    from tuch_tpu_torch.parallel import mesh as PM
    from tuch_tpu_torch.train import module as TM
    mesh = PM.make_mesh(dp=p['dp'], cp=p['cp'], device='cpu')
    pr, assets = _port_pair(p)
    opts = pcfg.TrainConfig(**p['options'])
    state = TM.init_train_state(pr.hmr, _t(p['fits']).clone(), opts.lr)
    step = TM.make_train_step(assets, opts, mesh=mesh)
    out = {'dp_rank': mesh.dp_rank, 'cp_rank': mesh.cp_rank, 'steps': []}
    n0 = dict(CPAR.CP_CALLS)
    for batch, masks in zip(p['batches'], p['masks']):
        state, metrics, outputs = step(state, PM.shard_batch(batch, mesh),
                                       dropout=masks)
        out['steps'].append(_snapshot(state, metrics, outputs))
    out['cp_calls'] = {k: CPAR.CP_CALLS[k] - n0[k] for k in n0}
    return out


def _batchnorm(p):
    """The ResNet-50 HMR's train-mode forward and backward in float64 on
    this rank's dp slice, BatchNorm over the dp group: outputs, running
    statistics and the dp-summed gradients of sum(w * outputs)."""
    from tuch_tpu_torch.models.hmr import HMR, sync_batchnorm
    from tuch_tpu_torch.parallel import mesh as PM
    mesh = PM.make_mesh(dp=p['dp'], cp=1, device='cpu')
    hmr = HMR(*p['mean'], backbone='resnet50')
    hmr.load_state_dict(p['weights'])
    hmr = hmr.double().train()
    hmr.dtype = torch.float64
    sync_batchnorm(hmr, mesh.dp_group)
    rows = slice(*PM.local_rows(mesh, p['img'].shape[0] // mesh.dp))
    masks = [(a[rows], b[rows]) for a, b in p['masks']]
    outs = hmr(_t(p['img'])[rows].double(), dropout=masks)
    loss = sum((o.reshape(o.shape[0], -1) * _t(w)[rows]).sum()
               for o, w in zip(outs, p['w']))
    names, params = zip(*hmr.named_parameters())
    grads = PM.all_reduce_grads(torch.autograd.grad(loss, params), mesh)
    return dict(dp_rank=mesh.dp_rank,
                outputs=[o.detach() for o in outs],
                buffers={k: v.clone() for k, v in hmr.named_buffers()},
                grads=dict(zip(names, grads)))


CASES.update(train_step=_train_step, batchnorm=_batchnorm)


def _train_cli(p):
    """python -m tuch_tpu_torch.cli.train with p['argv'] on this rank."""
    from tuch_tpu_torch.cli import train
    train.main(p['argv'])
    return {}


CASES.update(train_cli=_train_cli)


# ---------------------------------------------------------------------------
# Eval and EFT (tests/test_torch_port_parallel_eval.py)
# ---------------------------------------------------------------------------

def _eval(p):
    """The eval step on this rank's dp slice of a batch, gathered; then
    run_evaluation on a dataset whose last batch is ragged, rank 0
    writing the result file under this rank's directory."""
    from tuch_tpu_torch import runtime as prt
    from tuch_tpu_torch.data.dataset import TuchDataset
    from tuch_tpu_torch.eval import evaluate as PE
    from tuch_tpu_torch.parallel import mesh as PM
    mesh = PM.make_mesh(dp=p['dp'], cp=1, device='cpu')
    pr = prt.build_runtime(device='cpu', synthetic=True,
                           num_verts=p['num_verts'])
    prt.load_hmr_weights(pr.hmr, p['weights'])
    step = PE.make_eval_step(pr.hmr, pr.smpl, None, None, p['j_reg'],
                             'mpi-inf-3dhp')
    m, pa, *_ = (PM.dp_gather(t, mesh) for t in step(
        PM.shard_batch(p['batch'], mesh)))
    ds = TuchDataset(None, 'mpi-inf-3dhp', data=p['db'],
                     img_dir=p['img_dir'], use_augmentation=False,
                     split='test')
    os.chdir(p['cwd'][mesh.rank])
    report = PE.run_evaluation(pr.hmr, ds, 'mpi-inf-3dhp', pr.smpl, None,
                               None, p['j_reg'], batch_size=8,
                               num_workers=0, result_file='r.npz',
                               mesh=mesh)
    return dict(mpjpe=m, pa=pa, report=report)


def _main_of(module, p):
    import importlib
    os.chdir(p['cwd'])
    return importlib.import_module(module).main(p['argv'])


CASES.update(
    eval=_eval,
    eval_cli=lambda p: _main_of('tuch_tpu_torch.cli.eval', p),
    fit_eft=lambda p: _main_of('tuch_tpu_torch.cli.fit_eft', p))
