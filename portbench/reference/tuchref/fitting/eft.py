"""EFT: exemplar fine-tuning of the whole HMR network, one image at a time.

A frozen copy of tuch_tpu_torch/fitting/eft.py's single-image fit, with
the Adam it runs (SMPLify-DC's, optax's update). Per image the fit starts
from the given parameters and BatchNorm statistics and runs a fresh Adam
(float32 bias corrections) on the HMR in train mode (batch statistics at
B=1, the IEF head's dropout) through SMPL and the EFT loss, with the JAX
package's early stop: the loop goes on while

    step < max_steps and (loss >= early_stop_loss or step <= min_steps + 1)

decided on the pre-update loss of the last step (+inf before the first).
The pose and betas returned are the last step's forward's, from the
parameters before its update; the pose is nan_to_num(rotmat_to_aa(rotmat));
with no step they are identity rotations and zero betas. The running
BatchNorm statistics move during a fit and are never returned.

Each part of a step runs under a torch.profiler record_function span:
'eft_step.stop_check', 'eft_step.forward', 'eft_step.backward' and
'eft_step.adam'.
"""

from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from portbench.reference.tuchref import constants
from portbench.reference.tuchref.losses.eft import EFTWeights, eft_loss
from portbench.reference.tuchref.losses.smplify import ContactAssets
from portbench.reference.tuchref.models.hmr import HMR, draw_dropout_masks
from portbench.reference.tuchref.models.smpl import SMPL, smpl_forward
from portbench.reference.tuchref.utils.projection import weak_perspective_to_translation
from portbench.reference.tuchref.utils.rotations import rotmat_to_aa


class Adam:
    """optax.adam(lr, b1, b2, eps) on a dict of tensors."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params, grads):
        self.count += 1
        # the bias corrections in float32, as optax computes them
        n = np.float32(self.count)
        c1 = float(1 - np.float32(self.b1) ** n)
        c2 = float(1 - np.float32(self.b2) ** n)
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.mu[k] = (1 - self.b1) * g + self.b1 * self.mu[k]
            self.nu[k] = (1 - self.b2) * (g * g) + self.b2 * self.nu[k]
            upd = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2)
                                       + self.eps)
            out[k] = p + (-self.lr) * upd
        return out


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
    device. dropout: a function step -> the head's keep-masks
    (models/hmr.draw_dropout_masks' layout); None draws them from
    generator (a torch.Generator on hmr's device).
    """

    def loss_at(img, kp, contact, masks):
        rotmat, betas, cam = hmr(img, dropout=masks)
        out = smpl_forward(smpl, betas, rotmat[:, 1:], rotmat[:, :1],
                           pose2rot=False)
        cam_t = weak_perspective_to_translation(cam, constants.FOCAL_LENGTH,
                                                img_res)
        total, _ = eft_loss(out.joints, betas, out.vertices, cam_t, kp,
                            contact, assets, weights, img_res=img_res,
                            candidate_k=candidate_k)
        return total, rotmat.detach(), betas.detach()

    def fit_one(variables, img, kp, contact,
                generator: Optional[torch.Generator] = None,
                dropout: Optional[Callable] = None) -> EFTFitResult:
        hmr.load_state_dict(variables)
        hmr.train()
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
            with record_function('eft_step.forward'):
                masks = (draw_dropout_masks(1, generator, dev)
                         if dropout is None else dropout(step))
                total, rotmat, betas = loss_at(img, kp, contact, masks)
            with record_function('eft_step.backward'):
                grads = torch.autograd.grad(total, params, allow_unused=True,
                                            materialize_grads=True)
            with record_function('eft_step.adam'), torch.no_grad():
                new = opt.step(dict(zip(names, params)),
                               dict(zip(names, grads)))
                for k, p in zip(names, params):
                    p.copy_(new[k])
            last = total.detach()
            step += 1
        pose = torch.nan_to_num(rotmat_to_aa(rotmat)).reshape(1, 72)
        return EFTFitResult(pose=pose, betas=betas, steps=step, loss=loss())

    return fit_one
