"""The TUCH training step: HMR forward and backward with SMPLify-DC in the
loop and the regressor loss, one Adam step.

Counterpart of tuch_tpu/train/module.py. The JAX package jit-compiles the
step into one program over a functional state; here the step is eager
PyTorch over a state whose HMR module holds the parameters and the
BatchNorm statistics and is updated in place, and whose fits tensor is
replaced. The order of the work is the JAX step's:
ground-truth SMPL, fits lookup, camera estimation, HMR forward, in-the-loop
SMPLify-DC on detached inputs, accept/reject and fits writeback, the loss,
its gradient, optax's clip_by_global_norm when options.grad_clip > 0, and
an Adam step with optax's float32 bias corrections.

The HMR's compute dtype (options.compute_dtype, set when the runtime builds
it) needs nothing here: a bfloat16 HMR casts its float32 weights per call,
its BatchNorm computes in float32 from float32 statistics, and its outputs,
parameters and gradients are float32, so Adam's moments are too.

On a (dp, cp) mesh (parallel/mesh.Mesh) each rank runs the step on its dp
slice of the global batch, and the step computes what the JAX package's
jit computes over the dp-sharded global batch, by reducing by hand where
the global semantics couple the batch:
  1. BatchNorm's statistics are the global batch's (models/hmr
     sync_batchnorm over the dp group);
  2. masked means and metrics divide by global counts (losses/regressor);
  3. the contact compactions pick from the global batch (SMPLify-DC's
     and the regressor loss's);
  4. the fits store takes the global batch's rows, the last occurrence of
     a row winning, on every rank;
  5. the gradients are summed over dp once, as one flat all_reduce, and
     clipped after it;
  6. the head's dropout masks are the global batch's, sliced.
The cp ranks of a dp row compute the same step on the same slice (the
contact quadratics split among them), so their parameters stay equal bit
for bit.
"""

from typing import Dict, NamedTuple, Optional

import torch
from torch.profiler import record_function

from tuch_tpu_torch import config as cfg
from tuch_tpu_torch import constants
from tuch_tpu_torch.fitting import smplify_dc as smplify_mod
from tuch_tpu_torch.fitting.smplify_dc import Adam
from tuch_tpu_torch.losses import regressor as RL
from tuch_tpu_torch.losses.prior import GMMPrior
from tuch_tpu_torch.losses.smplify import ContactAssets
from tuch_tpu_torch.models.hmr import HMR, draw_dropout_masks, sync_batchnorm
from tuch_tpu_torch.models.smpl import SMPL, smpl_forward, smpl_forward_pose72
from tuch_tpu_torch.ops import contact as contact_ops
from tuch_tpu_torch.parallel import mesh as PM
from tuch_tpu_torch.train import fits_store
from tuch_tpu_torch.utils.projection import (estimate_translation,
                                             perspective_projection,
                                             weak_perspective_to_translation)
from tuch_tpu_torch.utils.rotations import rotmat_to_aa


# the step's parts in order, each a record_function span 'train_step.<part>'
STEP_PARTS = ('targets', 'hmr_forward', 'smplify', 'loss', 'backward',
              'adam')


class TuchAssets(NamedTuple):
    """The static model data of a training step, on its device."""
    smpl: SMPL
    prior: GMMPrior
    contact: ContactAssets
    hd: Optional[RL.HDAssets]


class TrainState(NamedTuple):
    hmr: HMR                     # parameters and BatchNorm statistics
    opt: Adam                    # over hmr.named_parameters()
    fits: torch.Tensor           # (N_total, 82) best-fit store
    generator: torch.Generator   # the head's dropout, on the step's device
    step: int


def init_train_state(hmr: HMR, fits: torch.Tensor, lr: float,
                     seed: int = 0) -> TrainState:
    """A state at step 0: Adam's moments at zero and a dropout generator
    seeded on the fits tensor's device."""
    gen = torch.Generator(device=fits.device).manual_seed(seed)
    params = {k: p.detach() for k, p in hmr.named_parameters()}
    return TrainState(hmr=hmr, opt=Adam(params, lr), fits=fits,
                      generator=gen, step=0)


def clip_by_global_norm(grads, max_norm: float):
    """optax.clip_by_global_norm(max_norm) on a sequence of tensors: the
    norm over all of them in float32 (summed in the sequence's order), and
    each g kept where norm < max_norm, else (g / norm) * max_norm. No host
    synchronisation."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm) * max_norm) for g in grads]


def region_contact_signature(verts: torch.Tensor,
                             assets: ContactAssets) -> torch.Tensor:
    """Least squared distance per annotated region pair, (B, P)."""
    return contact_ops.region_pair_min_dists(
        verts, assets.region_idx_a, assets.region_idx_b,
        assets.region_mask_a, assets.region_mask_b)


def _round_capacity(cap: int, mesh) -> int:
    """A compaction capacity rounded up to a multiple of mesh dp, as the
    JAX package rounds it (its shard_map needs the compacted batch to
    divide over dp); 0 stays 0 (compaction off)."""
    cap = int(cap)
    if cap > 0 and mesh is not None:
        cap = -(-cap // mesh.dp) * mesh.dp
    return cap


def _global_mean(x: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of x over the global batch (x: this rank's rows)."""
    if mesh is None or mesh.dp == 1:
        return x.mean()
    return PM.dp_sum(x.sum(), mesh) / (x.numel() * mesh.dp)


def make_train_step(assets: TuchAssets, options: cfg.TrainConfig,
                    mesh=None):
    """The step: step_fn(state, batch, dropout=None) -> (state, metrics,
    outputs), with metrics and outputs dicts of tensors.

    batch: the loader's arrays or tensors (img (B, H, W, 3) normalised,
    keypoints (B, 49, 3) in [-1, 1], pose, betas, pose_3d, contact_vec,
    the has_* flags, is_flipped, rot_angle, fits_index). dropout: the
    head's keep-masks (models/hmr.draw_dropout_masks' layout; HMR 2.0's
    drop-path masks, models/hmr2); None draws them from state.generator. Each part of the step runs under a
    torch.profiler record_function span 'train_step.<part>', part one of
    STEP_PARTS, so that a profile splits the step's time.

    mesh: a parallel/mesh.Mesh; batch is then this rank's dp slice
    (mesh.shard_batch), dropout the global batch's masks, metrics global
    values and outputs this rank's rows.
    """
    weights = RL.LossWeights(
        shape=options.shape_loss_weight,
        keypoint=options.keypoint_loss_weight,
        pose=options.pose_loss_weight,
        beta=options.beta_loss_weight,
        contact=options.contact_loss_weight,
        openpose_train_weight=options.openpose_train_weight,
        gt_train_weight=options.gt_train_weight)
    focal_length = constants.FOCAL_LENGTH
    img_res = options.img_res
    run_smplify = bool(options.run_smplify)
    use_contact_itl = bool(options.use_contact_in_the_loop)
    smplify_cfg = smplify_mod.SMPLifyConfig(
        num_iters=options.num_smplify_iters,
        use_contact=use_contact_itl,
        focal_length=focal_length,
        # training passes the config threshold; the demo uses 0.0
        euclthres=cfg.euclthres,
        contact_loss_weight=options.contact_in_the_loop_loss_weight,
        exterior_refresh_every=options.smplify_exterior_refresh,
        contact_candidate_k=options.contact_candidate_k,
        contact_capacity=_round_capacity(options.smplify_contact_capacity,
                                         mesh),
        mesh=mesh)
    dp = 1 if mesh is None else mesh.dp

    def step_fn(state: TrainState, batch: Dict, dropout=None):
        hmr, smpl = state.hmr, assets.smpl
        sync_batchnorm(hmr, None if mesh is None else mesh.dp_group)
        dev = state.fits.device
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        B = b['img'].shape[0]
        rows = slice(*PM.local_rows(mesh, B))
        has_pose_3d = b['has_pose_3d'].bool()
        has_disc_contact = b['has_disc_contact'].bool()
        has_gt_kpts = b['has_gt_kpts'].bool()
        has_smpl_ = b['has_smpl'].bool() | b['has_pgt_smpl'].bool()
        gt_keypoints_2d = b['keypoints']
        gt_pose, gt_betas = b['pose'], b['betas']
        gt_disc_contact = b['contact_vec']
        gidx = b['fits_index'].long()
        rot_deg = b['rot_angle']
        is_flipped = b['is_flipped'].bool()

        with record_function('train_step.targets'), torch.no_grad():
            gt_out = smpl_forward_pose72(smpl, gt_betas, gt_pose)
            kp_px = gt_keypoints_2d.clone()
            kp_px[..., :2] = 0.5 * img_res * (gt_keypoints_2d[..., :2] + 1.0)
            opt_pose, opt_betas = fits_store.lookup_fits(
                state.fits, gidx, rot_deg, is_flipped)
            opt_out = smpl_forward_pose72(smpl, opt_betas, opt_pose)
            opt_contact = region_contact_signature(opt_out.vertices,
                                                   assets.contact)
            gt_cam_t = estimate_translation(gt_out.joints, kp_px,
                                            focal_length, img_res,
                                            has_gt_kpts)
            opt_cam_t = estimate_translation(opt_out.joints, kp_px,
                                             focal_length, img_res,
                                             has_gt_kpts)
            cam_center = kp_px.new_full((B, 2), 0.5 * img_res)
            opt_joint_loss = smplify_mod.get_fitting_loss(
                smpl, assets.prior, opt_pose, opt_betas, opt_cam_t,
                cam_center, kp_px, has_gt_kpts,
                focal_length=focal_length).mean(-1)

        # ------------------- regressor forward -------------------------
        with record_function('train_step.hmr_forward'):
            hmr.train()
            if dropout is None:
                # HMR 2.0 draws its drop-path masks, (2 depth, B) bool
                draw = getattr(hmr, 'draw_masks', draw_dropout_masks)
                dropout = draw(B * dp, state.generator, dev)
            if isinstance(dropout, torch.Tensor):
                dropout = dropout[:, rows]
            else:
                dropout = [(d1[rows], d2[rows]) for d1, d2 in dropout]
            pred_rotmat, pred_betas, pred_camera = hmr(b['img'],
                                                       dropout=dropout)
            pred_out = smpl_forward(smpl, pred_betas, pred_rotmat[:, 1:],
                                    pred_rotmat[:, :1], pose2rot=False)
            pred_cam_t = weak_perspective_to_translation(
                pred_camera, focal_length, img_res)
            eye = torch.eye(3, dtype=pred_camera.dtype, device=dev)
            pred_kp2d = perspective_projection(
                pred_out.joints, eye.expand(B, 3, 3), pred_cam_t,
                focal_length, pred_camera.new_zeros(B, 2)) / (img_res / 2.0)

        # ------------------- in-the-loop optimization ------------------
        # SMPLify-DC runs its own autograd on detached inputs; nothing of
        # it reaches the regressor's gradient. Accept/reject is masking.
        with record_function('train_step.smplify'):
            o_pose, o_betas = opt_pose, opt_betas
            o_verts, o_joints = opt_out.vertices, opt_out.joints
            o_cam_t, o_jloss = opt_cam_t, opt_joint_loss
            new_fits = state.fits
            update = torch.zeros(B, dtype=torch.bool, device=dev)
            smplify_metrics = {}
            if run_smplify:
                pred_pose_aa = torch.nan_to_num(
                    rotmat_to_aa(pred_rotmat.detach())).reshape(B, 72)
                res = smplify_mod.smplify_dc(
                    smpl, assets.prior, assets.contact, pred_pose_aa,
                    pred_betas.detach(), pred_cam_t.detach(), cam_center,
                    kp_px, gt_disc_contact, ignore_idxs=has_smpl_,
                    has_discrete_contact=has_disc_contact,
                    has_gt_keypoints=has_gt_kpts, config=smplify_cfg)
                with torch.no_grad():
                    if res.contact_truncated_frac is not None:
                        smplify_metrics[
                            'smplify_contact_truncated_frac'] = \
                            res.contact_truncated_frac
                    new_jloss = res.reprojection_loss.mean(-1)
                    update = new_jloss <= o_jloss  # a NaN fit is rejected
                    new_contact = region_contact_signature(
                        res.vertices, assets.contact)
                    # "at least one region pair not worsened", quirk for
                    # quirk with the reference: unannotated pairs compare
                    # 0 <= 0, so this holds for P > 0. Not .all().
                    update_contact = ((gt_disc_contact * new_contact)
                                      <= (gt_disc_contact * opt_contact)
                                      ).sum(1) > 0
                    if use_contact_itl:
                        update = torch.where(
                            has_disc_contact, update & update_contact, update)
                    smplify_metrics['smplify_accept_rate'] = _global_mean(
                        update.float(), mesh)
                    smplify_metrics['opt_joint_loss_mean'] = _global_mean(
                        o_jloss, mesh)
                    sel = update[:, None]
                    o_jloss = torch.where(update, new_jloss, o_jloss)
                    o_pose = torch.where(sel, res.pose, o_pose)
                    o_betas = torch.where(sel, res.betas, o_betas)
                    o_cam_t = torch.where(sel, res.camera_translation,
                                          o_cam_t)
                    o_verts = torch.where(sel[..., None], res.vertices,
                                          o_verts)
                    o_joints = torch.where(sel[..., None], res.joints,
                                           o_joints)
                    # the global batch's rows on every rank
                    new_fits = fits_store.update_fits(state.fits, *(
                        PM.dp_gather(t, mesh) for t in (
                            gidx, o_pose, o_betas, rot_deg, is_flipped,
                            update)))

        with record_function('train_step.loss'):
            # ground-truth override
            selg = has_smpl_[:, None]
            o_cam_t = torch.where(selg, gt_cam_t, o_cam_t)
            o_pose = torch.where(selg, gt_pose, o_pose)
            o_betas = torch.where(selg, gt_betas, o_betas)
            o_joints = torch.where(selg[..., None], gt_out.joints, o_joints)
            o_verts = torch.where(selg[..., None], gt_out.vertices, o_verts)
            valid_fit = (o_jloss < options.smplify_threshold) | has_smpl_

            total, loss_dict = RL.regressor_loss(
                weights, pred_rotmat, pred_betas, o_pose, o_betas,
                pred_kp2d, gt_keypoints_2d, pred_out.joints, b['pose_3d'],
                has_pose_3d, pred_out.vertices, o_verts, pred_camera,
                valid_fit, valid_fit, contact_assets=assets.contact,
                euclthres=cfg.euclthres,
                hd=assets.hd if options.use_hd else None,
                hd_k=options.hd_k,
                candidate_k=options.contact_candidate_k,
                contact_capacity=_round_capacity(
                    options.regressor_contact_capacity, mesh),
                mesh=mesh)

        with record_function('train_step.backward'):
            names, params = zip(*hmr.named_parameters())
            grads = torch.autograd.grad(total, params, allow_unused=True,
                                        materialize_grads=True)
            grads = PM.all_reduce_grads(grads, mesh)
            if options.grad_clip > 0:
                grads = clip_by_global_norm(grads, options.grad_clip)
        with record_function('train_step.adam'), torch.no_grad():
            new = state.opt.step(dict(zip(names, params)),
                                 dict(zip(names, grads)))
            for k, p in zip(names, params):
                p.copy_(new[k])

        metrics = {'loss': PM.dp_sum(total.detach(), mesh),
                   **{k: v.detach() for k, v in loss_dict.items()},
                   **smplify_metrics}
        outputs = dict(
            pred_vertices=pred_out.vertices.detach(),
            opt_vertices=o_verts,
            pred_cam_t=pred_cam_t.detach(),
            opt_cam_t=o_cam_t,
            pred_camera=pred_camera.detach(),
            gt_contact_l3=gt_disc_contact,
            has_contact=has_disc_contact,
            valid_kpts_anno=valid_fit | has_smpl_,
            gt_keypoints=kp_px,
            opt_joint_loss=o_jloss,
            fit_accepted=update)
        return (state._replace(fits=new_fits, step=state.step + 1),
                metrics, outputs)

    return step_fn


@torch.no_grad()
def spin_reference_forward(hmr: HMR, images: torch.Tensor, smpl: SMPL,
                           focal_length: float, img_res: int):
    """The model's eval-mode forward for visualisation: (vertices,
    camera translation). Leaves hmr in the mode it found it in."""
    was_training = hmr.training
    hmr.eval()
    try:
        rotmat, betas, cam = hmr(images)
    finally:
        hmr.train(was_training)
    out = smpl_forward(smpl, betas, rotmat[:, 1:], rotmat[:, :1],
                       pose2rot=False)
    return out.vertices, weak_perspective_to_translation(cam, focal_length,
                                                         img_res)
