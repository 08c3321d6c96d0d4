"""EFT (exemplar fine-tuning) loss.

Counterpart of tuch_tpu/losses/eft.py with the same terms: the keypoint term
in pixels, the shape term, the TUCH pull and push as per-sample means over
exterior and interior vertices, and the geodesically masked region-to-region
term, x100, x weights.contact and x60. The contact half runs on
losses/smplify's contact_neighbors (kernels 4 and 2, without gradient)
and contact_distances (the re-gather through gather_rows: kernel 5
forward, kernel 6 backward), then ops/contact.region_pair_min_dists.

eft_loss opens two torch.profiler record_function spans, inside the EFT
step's 'eft_step.forward.loss' (fitting/eft.py):
'eft_step.forward.loss.neighbors' around contact_neighbors and
'eft_step.forward.loss.region_pairs' around region_pair_min_dists.

A region pair whose vertex pairs are all banned gives inf, and inf times a
label of 0 is NaN: the JAX package's quirk, kept (ROADMAP fault 3).
"""

from typing import NamedTuple

import torch
from torch.profiler import record_function

from tuch_tpu_torch.losses.smplify import (ContactAssets, contact_distances,
                                           contact_neighbors)
from tuch_tpu_torch.ops import contact as contact_ops
from tuch_tpu_torch.utils.projection import perspective_projection


class EFTWeights(NamedTuple):
    """The reference's EFT defaults (keypoints 1, shape 1, contact 10)."""
    keypoints: float = 1.0
    shape: float = 1.0
    contact: float = 10.0


def eft_loss(joints: torch.Tensor, betas: torch.Tensor,
             vertices: torch.Tensor, camera_t: torch.Tensor,
             gt_keypoints: torch.Tensor, gt_contact: torch.Tensor,
             assets: ContactAssets, weights: EFTWeights,
             focal_length: float = 5000.0, img_res: int = 224,
             euclthres: float = 0.02, candidate_k: int = 0):
    """Per-exemplar loss: (total, {'loss_keypoints', 'loss_shape',
    'loss_contact'}), scalars.

    gt_keypoints (B, 49, 3): [-1, 1] crop coordinates and a confidence,
    taken to pixels as the reference does; gt_contact (B, P) region-pair
    labels. candidate_k > 0 tests only K winding candidates
    (losses/smplify.contact_neighbors).
    """
    B = joints.shape[0]
    cam_center = joints.new_full((B, 2), img_res / 2.0)
    rot = torch.eye(3, dtype=joints.dtype, device=joints.device).expand(
        B, 3, 3)
    pred_px = perspective_projection(joints, rot, camera_t, focal_length,
                                     cam_center)
    gt_px = 0.5 * img_res * (gt_keypoints[..., :2] + 1.0)
    conf = gt_keypoints[..., 2:3]
    loss_kp = (conf * (pred_px - gt_px) ** 2).mean() * weights.keypoints

    loss_shape = torch.mean(betas ** 2) * weights.shape

    loss_contact = joints.new_zeros(())
    if weights.contact > 0:
        with record_function('eft_step.forward.loss.neighbors'):
            exterior, argmin = contact_neighbors(vertices, assets,
                                                 candidate_k=candidate_k)
        v2v_min = contact_distances(vertices, argmin)
        extf = exterior.to(v2v_min.dtype)
        n_ext = extf.sum(-1).clamp(min=1.0)
        n_int = (1 - extf).sum(-1).clamp(min=1.0)
        pull = (0.005 * torch.tanh(v2v_min / 0.005) ** 2 * extf
                ).sum(-1) / n_ext
        push = (1.0 * torch.tanh(v2v_min / 0.04) ** 2 * (1 - extf)
                ).sum(-1) / n_int
        with record_function('eft_step.forward.loss.region_pairs'):
            pair_min = contact_ops.region_pair_min_dists(
                vertices, assets.region_idx_a, assets.region_idx_b,
                assets.region_mask_a, assets.region_mask_b,
                geomask=assets.geomask)
        r2r = (pair_min * gt_contact).sum(-1)
        loss_contact = (100.0 * (pull + push + 0.5 * r2r)).sum() \
            * weights.contact

    total = 60.0 * (loss_kp + loss_shape + loss_contact)
    return total, {'loss_keypoints': loss_kp, 'loss_shape': loss_shape,
                   'loss_contact': loss_contact}
