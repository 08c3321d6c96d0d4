"""Training engine: the epoch loop, validation, metrics, checkpoint and
resume.

Counterpart of tuch_tpu/train/trainer.py. The loop feeds the loader's numpy
batches to the eager step of train/module.py and logs; validation (v2v and
MPJPE on the validation set, the reference's trainer.py:172-267) is the
HMR's eval-mode forward under no_grad, which neither moves the BatchNorm
statistics nor draws from the dropout generator, so a run that validates
and checkpoints resumes bit for bit on the CPU.

With a renderer (viz/renderer.Renderer, as cli/train builds it) the
trainer draws the predicted and the fitted body over the first image of the
batch every summary_freq of an epoch (train/pred_shape, train/opt_shape,
contact regions coloured where the sample has labels) and the predicted
body after each validation (val/pred_shape).

On a device mesh (--mesh_dp / --mesh_cp, one process per rank under
torchrun) every rank runs the same loader with the same seed and takes its
dp slice of each global batch (parallel/mesh.shard_batch), so the batches
equal the single-process run's bit for bit; the step reduces over the
mesh (train/module.py). Side effects happen on rank 0 only: metrics,
prints, image summaries, validation and checkpoints. A resume restores on
rank 0 and broadcasts the state; the ranks agree on each step whether the
time budget or a SIGTERM ends the run.
"""

import json
import os
import signal
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from tuch_tpu_torch import config as cfg
from tuch_tpu_torch import constants, resolve_device
from tuch_tpu_torch.data.loader import (CheckpointLoader, LoaderState,
                                        add_fits_indices)
from tuch_tpu_torch.models.smpl import smpl_forward, smpl_forward_pose72
from tuch_tpu_torch.parallel import mesh as pmesh
from tuch_tpu_torch.train import fits_store
from tuch_tpu_torch.train.checkpoint import CheckpointManager
from tuch_tpu_torch.train.module import (TuchAssets, init_train_state,
                                         make_train_step)
from tuch_tpu_torch.utils.projection import weak_perspective_to_translation


def freq_to_step(freq: float, total_steps: int) -> int:
    """Fraction-of-epoch frequency -> step interval (the reference's
    saver.py:34-40); <= 0 never fires."""
    if freq <= 0:
        return max(1, total_steps + 1)
    return max(1, int(total_steps * freq))


class MetricsLogger:
    """Scalars as JSON lines in summary_dir/metrics.jsonl, and to
    TensorBoard when torch.utils.tensorboard imports; images to TensorBoard,
    or without it as summary_dir/images/<tag>_<step>.png."""

    def __init__(self, summary_dir: str):
        os.makedirs(summary_dir, exist_ok=True)
        self.summary_dir = summary_dir
        self.path = os.path.join(summary_dir, 'metrics.jsonl')
        self.tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self.tb = SummaryWriter(summary_dir)
        except ImportError:
            pass

    def scalars(self, tag_prefix: str, metrics: Dict[str, Any], step: int):
        values = {f'{tag_prefix}/{k}': float(v) for k, v in metrics.items()}
        with open(self.path, 'a') as f:
            f.write(json.dumps({'step': step, **values}) + '\n')
        if self.tb is not None:
            for k, v in values.items():
                self.tb.add_scalar(k, v, step)

    def image(self, tag: str, img_hwc: np.ndarray, step: int):
        """An (H, W, 3) image in [0, 1]."""
        if self.tb is not None:
            self.tb.add_image(tag, img_hwc, step, dataformats='HWC')
            return
        from tuch_tpu_torch.viz.renderer import save_png
        out = os.path.join(self.summary_dir, 'images')
        os.makedirs(out, exist_ok=True)
        save_png(os.path.join(out, f'{tag.replace("/", "_")}_{step}.png'),
                 img_hwc)

    def close(self):
        if self.tb is not None:
            self.tb.close()
            self.tb = None


class Trainer:
    """The training loop around one HMR (its parameters and statistics are
    the state's, updated in place) on `device` (CUDA unless 'cpu'); image
    summaries when a renderer is given."""

    def __init__(self, options, hmr, assets: TuchAssets, train_ds, val_ds,
                 j_regressor_h36m: Optional[np.ndarray] = None,
                 device=None, renderer=None):
        self.options = options
        self.device = resolve_device(device)
        # the (dp, cp) mesh when one is asked for or the world has ranks
        self.mesh = None
        if cfg.mesh_wanted(options):
            self.mesh = pmesh.make_mesh(dp=options.mesh_dp,
                                        cp=options.mesh_cp,
                                        device=self.device)
            if options.batch_size % self.mesh.dp:
                raise ValueError(
                    f'batch_size {options.batch_size} must divide over the '
                    f'dp mesh axis ({self.mesh.shape})')
        self.is_main = self.mesh is None or self.mesh.rank == 0
        self.model = hmr
        self.assets = assets
        self.train_ds = train_ds
        self.val_ds = val_ds
        self.joint_mapper_h36m = np.asarray(constants.H36M_TO_J14)
        self.j_regressor_h36m = j_regressor_h36m
        self.renderer = renderer if self.is_main else None
        self.logger = MetricsLogger(options.summary_dir) \
            if self.is_main else None
        self.ckpt = CheckpointManager(options.checkpoint_dir)
        self.endtime = time.time() + options.time_to_run

        # fits seeding: checkpoint fits, then static ones, then zeros
        static_dir = options.static_fits_dir
        if static_dir == '':
            static_dir = cfg.STATIC_FITS_DIR \
                if os.path.isdir(cfg.STATIC_FITS_DIR) else None
        elif str(static_dir).lower() == 'none':
            static_dir = None
        store = fits_store.create_fits_store(
            train_ds.dataset_sizes(), static_fits_dir=static_dir,
            checkpoint_dir=options.checkpoint_dir, device=self.device)
        self.fits_layout = store
        self.offsets_table = np.asarray(
            [store.offsets[n] for n in train_ds.dataset_list], np.int32)

        self.step_fn = make_train_step(assets, options, mesh=self.mesh)
        self.state = init_train_state(hmr, store.params, options.lr,
                                      seed=options.seed)
        pmesh.replicated(hmr, self.mesh)
        self.loader = CheckpointLoader(
            train_ds, batch_size=options.batch_size,
            shuffle=options.shuffle_train,
            num_workers=options.num_workers, seed=options.seed)
        self.loader_state = LoaderState(epoch=0, batch_idx=0,
                                        perm_seed=options.seed)

        # an explicit --checkpoint resumes from that file, wherever it is;
        # on a mesh rank 0 decides, restores and broadcasts
        resume = bool(options.resume and (options.checkpoint is not None
                                          or self.ckpt.exists()))
        if self._any_rank(resume, 0):
            ls = {}
            if self.is_main:
                self.state, ls = self.ckpt.restore(self.state,
                                                   options.checkpoint)
            pos = self._broadcast_state([
                ls.get('epoch', 0), ls.get('batch_idx', 0),
                ls.get('perm_seed', options.seed)])
            self.loader_state = LoaderState(*pos)
            if self.is_main:
                print(f'Resumed at step {self.state.step}, epoch '
                      f'{self.loader_state.epoch}, batch '
                      f'{self.loader_state.batch_idx}', flush=True)
        # the step last persisted: fit()'s final save skips if nothing ran
        self._last_saved_step = self.state.step

    def _any_rank(self, flag: bool, src=None) -> bool:
        """flag on a mesh: rank src's (src 0), or any rank's (None)."""
        if self.mesh is None or self.mesh.dp * self.mesh.cp == 1:
            return bool(flag)
        t = torch.tensor([int(bool(flag))], device=self.device)
        if src is None:
            pmesh.all_reduce_(t, torch.distributed.group.WORLD,
                              torch.distributed.ReduceOp.MAX)
        else:
            pmesh.broadcast_([t], self.mesh, src)
        return bool(t.item())

    def _broadcast_state(self, position):
        """Rank 0's state (HMR, Adam, fits, generator, step) and loader
        position on every rank; returns the position (three ints)."""
        st = self.state
        opt = st.opt
        ints = torch.tensor([st.step, opt.count, *position],
                            dtype=torch.int64)
        gen = st.generator.get_state()
        pmesh.broadcast_([*st.hmr.parameters(), *st.hmr.buffers(),
                          *(opt.mu[k] for k in sorted(opt.mu)),
                          *(opt.nu[k] for k in sorted(opt.nu)),
                          st.fits, ints, gen], self.mesh)
        st.generator.set_state(gen)
        opt.count = int(ints[1])
        self.state = st._replace(step=int(ints[0]))
        return [int(x) for x in ints[2:]]

    def _print(self, msg: str):
        if self.is_main:
            print(msg, flush=True)

    def _out_of_time(self) -> bool:
        """The time budget is spent or a SIGTERM came, on any rank."""
        return self._any_rank(time.time() > self.endtime)

    # ------------------------------------------------------------------
    def fit(self):
        """Train to num_epochs, or until the time budget or a SIGTERM: then
        the step in flight finishes, the exact position is checkpointed and
        fit returns (the handler is installed while fit runs, from the main
        thread only)."""
        def _on_term(signum, frame):
            print('SIGTERM: finishing current step, checkpointing, '
                  'exiting', flush=True)
            self.endtime = 0.0

        prev_handler = None
        try:
            prev_handler = signal.signal(signal.SIGTERM, _on_term)
        except ValueError:   # not the main thread
            pass
        try:
            for epoch in range(self.loader_state.epoch,
                               self.options.num_epochs):
                if not self.train_one_epoch(epoch):
                    break    # mid-epoch exit, position already saved
                self.loader_state = LoaderState(
                    epoch=epoch + 1, batch_idx=0,
                    perm_seed=self.loader_state.perm_seed)
                self._print(f'================ EPOCH {epoch} DONE '
                            f'================')
                if self._out_of_time():
                    self._print('time budget reached; stopping')
                    break
            if self.state.step != self._last_saved_step:
                self._save_checkpoint(self.loader_state.epoch,
                                      self.loader_state.batch_idx, None)
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)

    def close(self):
        if self.logger is not None:
            self.logger.close()

    def train_one_epoch(self, epoch: int) -> bool:
        """One epoch from the loader's position; False after a mid-epoch
        exit (time budget or SIGTERM), which checkpoints the next batch."""
        nb = self.loader.num_batches()
        checkpoint_steps = freq_to_step(
            self.options.val_and_checkpoint_freq, nb)
        summary_steps = freq_to_step(self.options.summary_freq, nb)
        start = self.loader_state.batch_idx \
            if self.loader_state.epoch == epoch else 0
        state_iter = LoaderState(epoch=epoch, batch_idx=start,
                                 perm_seed=self.loader_state.perm_seed)
        # TUCH_PROFILE_STEPS=lo:hi: a torch.profiler trace of batches
        # [lo, hi) into <summary_dir>/profile
        prof_range = os.environ.get('TUCH_PROFILE_STEPS')
        prof_lo, prof_hi = (-1, -1)
        if prof_range:
            prof_lo, prof_hi = (int(x) for x in prof_range.split(':'))
        prof = None
        t_last = time.time()
        # metrics are logged one step behind: float() of a device tensor
        # waits for the step, so step N is read after N + 1 is issued
        step = self.state.step
        pending = None
        try:
            for bi, batch in enumerate(self.loader.epoch_iter(state_iter),
                                       start=start):
                if bi == prof_lo:
                    prof = _start_profile(self.options.summary_dir)
                if bi == prof_hi and prof is not None:
                    prof.stop()
                    prof = None
                batch = pmesh.shard_batch(
                    add_fits_indices(batch, self.offsets_table), self.mesh)
                self.state, metrics, outputs = self.step_fn(self.state,
                                                            batch)
                step += 1
                if pending is not None:
                    self._log_train_metrics(*pending)
                now = time.time()
                metrics = dict(metrics)
                metrics['steps_per_sec'] = 1.0 / max(now - t_last, 1e-9)
                t_last = now
                pending = (metrics, step, epoch, bi)
                if self.renderer is not None and step % summary_steps == 0:
                    self._image_summaries(batch, outputs, step)

                saved_this_step = step % checkpoint_steps == 0
                if saved_this_step:
                    val_error = self.validate(step)
                    self._save_checkpoint(epoch, bi + 1, val_error)
                if self._out_of_time():
                    if not saved_this_step:
                        self._save_checkpoint(epoch, bi + 1, None)
                    self.loader_state = LoaderState(
                        epoch=epoch, batch_idx=bi + 1,
                        perm_seed=self.loader_state.perm_seed)
                    return False
            return True
        finally:
            if pending is not None:
                self._log_train_metrics(*pending)
            if prof is not None:
                prof.stop()

    def _save_checkpoint(self, epoch: int, next_batch_idx: int, val_error):
        """Persist the state, the fits and the position a resume continues
        from, with the loader's permutation seed (not --seed: a resume
        under another seed keeps the original stream); rank 0 only."""
        if not self.is_main:
            return
        self.ckpt.save(self.state, {
            'epoch': epoch, 'batch_idx': next_batch_idx,
            'perm_seed': self.loader_state.perm_seed}, val_error)
        fits_store.save_fits(
            self.fits_layout._replace(params=self.state.fits),
            self.options.checkpoint_dir)
        self._last_saved_step = self.state.step

    def _log_train_metrics(self, metrics, step, epoch, bi):
        if not self.is_main:
            return
        self.logger.scalars('train', metrics, step)
        if step % 25 == 0:
            msg = ', '.join(f'{k}: {float(v):.4f}'
                            for k, v in metrics.items())
            print(f'[{epoch}:{bi}/{self.loader.num_batches()}] {msg}',
                  flush=True)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _val_forward(self, batch):
        """(predicted vertices, ground-truth vertices, predicted camera
        translation) of a batch as numpy, from the HMR's eval-mode
        forward."""
        smpl = self.assets.smpl
        dev = self.state.fits.device
        was_training = self.model.training
        self.model.eval()
        try:
            rotmat, betas, cam = self.model(torch.as_tensor(batch['img'],
                                                            device=dev))
        finally:
            self.model.train(was_training)
        pred = smpl_forward(smpl, betas, rotmat[:, 1:], rotmat[:, :1],
                            pose2rot=False)
        gt = smpl_forward_pose72(
            smpl, torch.as_tensor(batch['betas'], device=dev),
            torch.as_tensor(batch['pose'], device=dev))
        cam_t = weak_perspective_to_translation(
            cam, constants.FOCAL_LENGTH, self.options.img_res)
        return (pred.vertices.cpu().numpy(), gt.vertices.cpu().numpy(),
                cam_t.cpu().numpy())

    def validate(self, step: int) -> float:
        """v2v and MPJPE on the validation set, in mm (trainer.py:172-267):
        without the H36M joint regressor the joint error is a vertex
        subsample, logged as mpjpe_v2v_proxy. Returns the joint error; rank
        0 only (nan on the others)."""
        if self.val_ds is None or not self.is_main:
            return float('nan')
        loader = CheckpointLoader(self.val_ds,
                                  batch_size=self.options.batch_size,
                                  shuffle=False, num_workers=2)
        have_regressor = self.j_regressor_h36m is not None
        joint_metric = 'mpjpe' if have_regressor else 'mpjpe_v2v_proxy'
        mpjpe_all, v2v_all = [], []
        first = None
        for batch in loader.epoch_iter(LoaderState(0, 0, 0)):
            pred_v, gt_v, cam_t = self._val_forward(batch)
            if first is None:
                first = (batch['img'][0], pred_v[0], cam_t[0])
            if have_regressor:
                J = self.j_regressor_h36m
                pred_j = np.einsum('jv,bvd->bjd', J, pred_v)
                gt_j = np.einsum('jv,bvd->bjd', J, gt_v)
                pred_j = (pred_j - pred_j[:, :1])[:, self.joint_mapper_h36m]
                gt_j = (gt_j - gt_j[:, :1])[:, self.joint_mapper_h36m]
            else:
                pred_j, gt_j = pred_v[:, ::97], gt_v[:, ::97]
            mpjpe_all.append(np.sqrt(((pred_j - gt_j) ** 2).sum(-1))
                             .mean(-1))
            v2v_all.append(np.sqrt(((pred_v - gt_v) ** 2).sum(-1)).mean(-1))
        if not mpjpe_all:
            return float('nan')
        mpjpe = float(np.concatenate(mpjpe_all).mean() * 1000)
        v2v = float(np.concatenate(v2v_all).mean() * 1000)
        self.logger.scalars('val', {joint_metric: mpjpe, 'v2v': v2v}, step)
        print(f'[val] {joint_metric} {mpjpe:.2f}mm v2v {v2v:.2f}mm',
              flush=True)
        if self.renderer is not None:
            img, verts, cam_t = first
            self.logger.image('val/pred_shape', self.renderer.render_over(
                verts, cam_t, _denorm(img)), step)
        return mpjpe

    def _image_summaries(self, batch, outputs, step: int):
        """The predicted and the fitted body over the batch's first image,
        contact regions coloured where it has labels."""
        first = {k: outputs[k][0].cpu().numpy() for k in (
            'pred_vertices', 'opt_vertices', 'pred_cam_t', 'opt_cam_t',
            'gt_contact_l3', 'has_contact')}
        img = _denorm(np.asarray(batch['img'][0]))
        cv = first['gt_contact_l3'] if first['has_contact'] else None
        for tag, verts, cam_t in (
                ('pred', first['pred_vertices'], first['pred_cam_t']),
                ('opt', first['opt_vertices'], first['opt_cam_t'])):
            self.logger.image(f'train/{tag}_shape', self.renderer.render_over(
                verts, cam_t, img, contact_vec=cv), step)


def _denorm(img: np.ndarray) -> np.ndarray:
    """A normalised (H, W, 3) image back in [0, 1]."""
    mean = np.asarray(constants.IMG_NORM_MEAN, np.float32)
    std = np.asarray(constants.IMG_NORM_STD, np.float32)
    return np.clip(img * std + mean, 0, 1)


def _start_profile(summary_dir: str):
    """A running torch.profiler that writes a Chrome trace into
    summary_dir/profile when stopped (with the card's kernels if one is
    in use)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts, on_trace_ready=tensorboard_trace_handler(
        os.path.join(summary_dir, 'profile')))
    prof.start()
    return prof
