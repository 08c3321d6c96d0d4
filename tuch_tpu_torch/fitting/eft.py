"""EFT: exemplar fine-tuning of the whole HMR network, one image at a time.

Counterpart of tuch_tpu/fitting/eft.py. Per image the fit starts from the
given parameters and BatchNorm statistics and runs a fresh Adam (optax's,
float32 bias corrections) on the HMR in train mode (batch statistics at
B=1, the IEF head's dropout) through SMPL and the EFT loss, with the JAX
package's early stop: the loop goes on while

    step < max_steps and (loss >= early_stop_loss or step <= min_steps + 1)

decided on the pre-update loss of the last step (+inf before the first).
The JAX package runs that loop on the device (lax.while_loop); here the
host decides, and reads the loss only where the decision needs it: one
synchronisation a step after the first min_steps + 2, none before. The
pose and betas returned are the last step's forward's, from the parameters
before its update; the pose is nan_to_num(rotmat_to_aa(rotmat)); with no
step they are identity rotations and zero betas. The running BatchNorm
statistics move during a fit and are never returned: the next fit starts
again from the given ones.

On a CUDA image HMR's forward and backward replay as two CUDA graphs
(models/hmr.HMRGraphs, captured in the first fit of each image shape and
precision; models/hmr.graph_engages says where), elsewhere they run
eagerly; the numbers are the same. The returned pose and betas are
copies, so a later fit does not change them.

Each part of a step runs under a torch.profiler record_function span:
'eft_step.stop_check', 'eft_step.forward', 'eft_step.backward' and
'eft_step.adam'. Inside them, one span a layer:

  eft_step.forward.hmr        ResNet-50 and the IEF head (models/hmr),
                              which opens
    .hmr.graph                the replay of its CUDA graph, where
                              HMRGraphs engages (a CUDA image); the
                              eager forward opens none
  eft_step.forward.smpl       models/smpl
  eft_step.forward.loss       the EFT loss (losses/eft), which opens
    .loss.neighbors           the contact search without gradient
    .loss.region_pairs        and the region-pair loop
  eft_step.backward.loss      from the start of the backward pass until the
                              gradients of SMPL's outputs are complete
  eft_step.backward.smpl      until those of HMR's outputs are complete
  eft_step.backward.hmr       until the parameters' gradients are complete

The forward spans open on the calling thread, always. The backward spans
open on the autograd engine's thread (the calling thread for CPU tensors)
as the gradient crosses each layer boundary: an identity _LayerBoundary
on HMR's outputs, on SMPL's and on the loss, whose backward closes the
span before it and opens the next; the last closes when the gradient call
returns. The boundaries are put in the graph only while the profiler
records, so an untraced step's graph has none. All spans are
record_function ranges on the profiler's clock.

EFTFitter keeps the reference's shards (--sidx/--cbs index ranges, one
<out_dir>/<ds>_eft_train[_<sidx>].npz each); merge_shards joins them into
one training db.
"""

import os
import pickle
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import record_function

from tuch_tpu_torch import constants
from tuch_tpu_torch.fitting.smplify_dc import Adam
from tuch_tpu_torch.losses.eft import EFTWeights, eft_loss
from tuch_tpu_torch.losses.smplify import ContactAssets
from tuch_tpu_torch.models.hmr import HMR, HMRGraphs, draw_dropout_masks
from tuch_tpu_torch.models.smpl import SMPL, smpl_forward
from tuch_tpu_torch.utils.projection import weak_perspective_to_translation
from tuch_tpu_torch.utils.rotations import rotmat_to_aa


class _BackwardSpans:
    """The backward pass's one open layer span, as a profiler handle."""

    def __init__(self):
        self.handle = None

    def open(self, name: str):
        """Close the open span, if any, and open `name`."""
        self.close()
        self.handle = torch.ops.profiler._record_function_enter_new(name,
                                                                    None)

    def close(self):
        if self.handle is not None:
            torch.ops.profiler._record_function_exit._RecordFunction(
                self.handle)
            self.handle = None


class _LayerBoundary(torch.autograd.Function):
    """Identity on a layer's outputs. Its backward runs once the gradients
    of all of them are complete, and opens the span of the layer below
    (closing the one before it); the gradients pass as they are."""

    @staticmethod
    def forward(ctx, spans, name, *tensors):
        ctx.spans, ctx.span = spans, name
        ctx.set_materialize_grads(False)
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        ctx.spans.open(ctx.span)
        return (None, None) + grads


def _boundary(spans: Optional[_BackwardSpans], name: str, *tensors):
    """tensors behind a _LayerBoundary that opens `name` in the backward
    pass, or as they are where spans is None (the profiler is off)."""
    if spans is None:
        return tensors
    return _LayerBoundary.apply(spans, name, *tensors)


class EFTFitResult(NamedTuple):
    pose: torch.Tensor    # (1, 72) axis-angle
    betas: torch.Tensor   # (1, 10)
    steps: int
    loss: float           # the last step's pre-update loss (+inf: none)


def make_eft_fit_fn(hmr: HMR, smpl: SMPL, assets: ContactAssets,
                    weights: EFTWeights, max_steps: int = 50,
                    early_stop_loss: float = 200.0, min_steps: int = 20,
                    lr: float = 1e-5, img_res: int = 224,
                    candidate_k: int = 0):
    """The single-image fit on hmr (its parameters are overwritten):

      fit_one(variables, img, kp, contact, generator=None, dropout=None)
        -> EFTFitResult

    variables: the start, a state dict of hmr (parameters and BatchNorm
    statistics); img (1, H, W, 3) normalised, kp (1, 49, 3) in [-1, 1]
    with confidences, contact (1, P) region-pair labels, tensors on hmr's
    device. dropout: a function step -> the model's keep-masks
    (models/hmr.draw_dropout_masks' layout; HMR 2.0's drop-path masks);
    None draws them from generator (a torch.Generator on hmr's device),
    by hmr.draw_masks where the model has one (HMR 2.0), else
    draw_dropout_masks.
    """

    graphs = HMRGraphs(hmr)
    draw_masks = getattr(hmr, 'draw_masks', None)

    def loss_at(img, kp, contact, masks, spans, graphed):
        with record_function('eft_step.forward.hmr'):
            if graphed is None:
                out = hmr(img, dropout=masks)
            else:
                with record_function('eft_step.forward.hmr.graph'):
                    out = graphed(masks)
            rotmat, betas, cam = _boundary(spans, 'eft_step.backward.hmr',
                                           *out)
        with record_function('eft_step.forward.smpl'):
            out = smpl_forward(smpl, betas, rotmat[:, 1:], rotmat[:, :1],
                               pose2rot=False)
            joints, vertices = _boundary(spans, 'eft_step.backward.smpl',
                                         out.joints, out.vertices)
        cam_t = weak_perspective_to_translation(cam, constants.FOCAL_LENGTH,
                                                img_res)
        with record_function('eft_step.forward.loss'):
            total, _ = eft_loss(joints, betas, vertices, cam_t, kp,
                                contact, assets, weights, img_res=img_res,
                                candidate_k=candidate_k)
        total, = _boundary(spans, 'eft_step.backward.loss', total)
        return total, rotmat.detach(), betas.detach()

    def fit_one(variables, img, kp, contact,
                generator: Optional[torch.Generator] = None,
                dropout: Optional[Callable] = None) -> EFTFitResult:
        hmr.load_state_dict(variables)
        hmr.train()
        graphed = graphs.bind(img)
        names, params = zip(*hmr.named_parameters())
        opt = Adam({k: p.detach() for k, p in zip(names, params)}, lr)
        dev = img.device
        rotmat = torch.eye(3, dtype=img.dtype, device=dev).expand(
            1, 24, 3, 3)
        betas = img.new_zeros(1, 10)
        step, last = 0, None

        def loss():
            return float('inf') if last is None else float(last)

        while step < max_steps:
            if step > min_steps + 1:
                with record_function('eft_step.stop_check'):
                    if not loss() >= early_stop_loss:
                        break
            spans = (_BackwardSpans()
                     if autograd_profiler._is_profiler_enabled else None)
            with record_function('eft_step.forward'):
                masks = ((draw_masks or draw_dropout_masks)(1, generator,
                                                            dev)
                         if dropout is None else dropout(step))
                total, rotmat, betas = loss_at(img, kp, contact, masks,
                                               spans, graphed)
            with record_function('eft_step.backward'):
                try:
                    # on the graph path the gradients are the backward
                    # graph's static buffers, overwritten by the next
                    # step's replay: Adam reads them at once
                    grads = torch.autograd.grad(total, params,
                                                allow_unused=True,
                                                materialize_grads=True)
                finally:
                    if spans is not None:
                        spans.close()
            with record_function('eft_step.adam'), torch.no_grad():
                new = opt.step(dict(zip(names, params)),
                               dict(zip(names, grads)))
                torch._foreach_copy_(list(params),
                                     [new[k] for k in names])
            last = total.detach()
            step += 1
        # rotmat and betas may be the forward graph's static outputs, which
        # the next fit overwrites: pose is computed anew, betas copied
        pose = torch.nan_to_num(rotmat_to_aa(rotmat)).reshape(1, 72)
        return EFTFitResult(pose=pose, betas=betas.clone(), steps=step,
                            loss=loss())

    return fit_one


class EFTFitter:
    """Fits every image of a dataset shard and writes the shard's npz.

    The output has the schema of the JAX package's: pose (N, 72) and betas
    (N, 10) over the whole dataset (zeros outside the shard) and the shard's
    indices. hmr holds the start weights, and holds them again after fit().
    """

    def __init__(self, options, dsname: str, dataset, hmr: HMR, smpl: SMPL,
                 assets: ContactAssets, out_dir: str = 'out/eft'):
        self.options = options
        self.dsname = dsname
        self.dataset = dataset
        self.hmr = hmr
        self.device = next(hmr.parameters()).device
        weights = EFTWeights(
            keypoints=getattr(options, 'keypoint_loss_weight',
                              getattr(options, 'kp_loss_weight', 1.0)),
            shape=getattr(options, 'beta_loss_weight',
                          getattr(options, 'shape_prior_weight', 1.0)),
            contact=getattr(options, 'contact_loss_weight', 10.0))
        self.fit_one = make_eft_fit_fn(
            hmr, smpl, assets, weights,
            max_steps=getattr(options, 'max_steps', 50),
            lr=getattr(options, 'lr', 1e-5),
            img_res=getattr(options, 'img_res', 224),
            candidate_k=getattr(options, 'contact_candidate_k', 0))
        self.generator = torch.Generator(device=self.device).manual_seed(
            getattr(options, 'seed', 0))

        sidx = getattr(options, 'sidx', 0)
        cbs = getattr(options, 'cbs', None) or len(dataset)
        lo = sidx * cbs
        self.process_idx = [i for i in range(lo, lo + cbs)
                            if i < len(dataset)]
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        shard_tag = f'_{sidx}' if getattr(options, 'cbs', None) else ''
        self.outputfn = os.path.join(
            out_dir, f'{dsname}_eft_train{shard_tag}.npz')
        # (index, steps, loss, host seconds) per fitted image
        self.records = []

    def fit(self) -> str:
        n = len(self.dataset)
        poses = np.zeros((n, 72), np.float32)
        betas = np.zeros((n, 10), np.float32)
        start = {k: v.detach().clone()
                 for k, v in self.hmr.state_dict().items()}

        def t(x):
            return torch.as_tensor(np.asarray(x)[None], dtype=torch.float32,
                                   device=self.device)

        try:
            for idx in self.process_idx:
                s = self.dataset.get(idx)
                t0 = time.perf_counter()
                res = self.fit_one(start, t(s['img']), t(s['keypoints']),
                                   t(s['contact_vec']),
                                   generator=self.generator)
                poses[idx] = res.pose[0].cpu().numpy()
                betas[idx] = res.betas[0].cpu().numpy()
                self.records.append((idx, res.steps, res.loss,
                                     time.perf_counter() - t0))
                print(f'[eft {self.dsname}] {idx}: steps={res.steps} '
                      f'loss={res.loss:.2f}', flush=True)
        finally:
            self.hmr.load_state_dict(start)
        np.savez(self.outputfn, pose=poses, betas=betas,
                 indices=np.asarray(self.process_idx, np.int64))
        print('dumped', self.outputfn, flush=True)
        return self.outputfn


def merge_shards(shard_files, base_db: dict, out_path: str) -> str:
    """Merge shard outputs into one training db (the reference's
    merge_temp_files.py): base_db with pose and betas replaced, each
    shard's rows at its indices; a missing shard is skipped with a line.
    Written with joblib where it imports (as the JAX package), else with
    pickle; both packages' load_db read either."""
    db = dict(base_db)
    n = len(db['imgname'])
    pose = np.zeros((n, 72), np.float32)
    betas = np.zeros((n, 10), np.float32)
    for path in shard_files:
        if not os.path.exists(path):
            print('missing shard (skipped):', path, flush=True)
            continue
        with np.load(path) as d:
            idx = d['indices']
            pose[idx] = d['pose'][idx]
            betas[idx] = d['betas'][idx]
    db['pose'] = pose
    db['betas'] = betas
    try:
        import joblib
    except ImportError:
        joblib = None
    if joblib is not None:
        joblib.dump(db, out_path)
    else:
        with open(out_path, 'wb') as f:
            pickle.dump(db, f)
    return out_path
