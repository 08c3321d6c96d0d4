"""SMPLify-DC: in-the-loop body fitting with discrete self-contact.

Counterpart of tuch_tpu/fitting/smplify_dc.py. Two stages of Adam steps
over the whole batch at once: the camera (and betas when contact is on),
then the body pose with the contact terms. Each stage is a Python loop of
eager steps; only the stage's live parameters take gradients.

With a mesh (SMPLifyConfig.mesh, parallel/mesh.Mesh) the batch is this
rank's dp slice. Every parameter of the fit belongs to one sample and the
loss is a sum over samples, so a rank fits its slice alone; only the
contact compaction couples the batch: it takes the first `capacity`
active samples of the global batch, and each rank runs those in its
slice. With cp > 1 the contact quadratics split over the cp ranks.

Each stage steps optax's Adam (ops/adam.Adam) in place on contiguous
clones of its start, made when the stage starts: the caller's tensors and
those a loss reads as constants stay as they are.
"""

from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from tuch_tpu_torch import constants
from tuch_tpu_torch.losses import smplify as L
from tuch_tpu_torch.losses.prior import GMMPrior
from tuch_tpu_torch.losses.smplify import ContactAssets
from tuch_tpu_torch.models.smpl import SMPL, smpl_forward
from tuch_tpu_torch.ops.adam import Adam, contiguous_clones
from tuch_tpu_torch.parallel import mesh as PM

# Joints ignored during fitting (reference smplifydc.py:46-47).
IGN_JOINT_NAMES = ('OP Neck', 'OP RHip', 'OP LHip', 'Right Hip', 'Left Hip')
IGN_JOINT_IDS = np.array([constants.JOINT_IDS[n] for n in IGN_JOINT_NAMES])


class SMPLifyConfig(NamedTuple):
    step_size: float = 1e-2
    num_iters: int = 100
    focal_length: float = 5000.0
    euclthres: float = 0.0
    use_contact: bool = True
    contact_loss_weight: float = 1.0
    collect_trajectory: bool = False
    # refresh the winding test and nearest-neighbour cache every K steps
    # (1 = the reference: every step)
    exterior_refresh_every: int = 1
    # test in/out only at K candidate vertices (0 = all V, the reference)
    contact_candidate_k: int = 0
    # run the contact quadratics for at most this many contact-active
    # samples (0 = the full batch); overflow is reported in
    # SMPLifyResult.contact_truncated_frac
    contact_capacity: int = 0
    # the (dp, cp) mesh of ranks (parallel/mesh.Mesh): dp slices the batch
    # (the compaction stays global), cp > 1 splits the contact quadratics
    mesh: Optional[object] = None


class SMPLifyResult(NamedTuple):
    vertices: torch.Tensor            # (B, V, 3)
    joints: torch.Tensor              # (B, 49, 3)
    pose: torch.Tensor                # (B, 72) axis-angle
    betas: torch.Tensor               # (B, 10)
    camera_translation: torch.Tensor  # (B, 3)
    reprojection_loss: torch.Tensor   # (B, 49) final per-joint reproj term
    trajectory: Optional[torch.Tensor] = None  # (T, B, V, 3) if collected
    contact_truncated_frac: Optional[torch.Tensor] = None


def value_and_grad(loss_fn: Callable, params: Dict[str, torch.Tensor]):
    """(loss, grads) of loss_fn(params) with respect to every entry."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(leaves)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def _run_adam(loss_fn, params, num_iters, lr, collect=None):
    """num_iters Adam steps in place on params, which the fit owns;
    collect(params) runs on the params BEFORE each step (frame 0 is the
    init), as the reference's trajectory does, and returns new tensors."""
    opt = Adam(params, lr)
    traj = []
    for _ in range(num_iters):
        if collect is not None:
            traj.append(collect(params))
        _, grads = value_and_grad(loss_fn, params)
        opt.step(params, grads)
    return params, traj


class ContactStage(NamedTuple):
    """Stage 2 with contact: loss(params, neighbors) -> scalar, and
    neighbors(params, prev_exterior=None, candidate_k=0) -> (exterior,
    argmin), the refresh without gradient. One body step is a refresh,
    value_and_grad of the loss and an Adam step."""
    loss: Callable
    neighbors: Callable


def contact_stage(smpl: SMPL, prior: GMMPrior, assets: ContactAssets,
                  betas, cam_t, camera_center, joints_2d, joints_conf,
                  gt_contact, ignore_idxs, has_discrete_contact,
                  config: SMPLifyConfig, compact_idx=None) -> ContactStage:
    """The stage-2 loss and neighbour refresh over params {'body_pose',
    'global_orient'}, with betas and the camera fixed; compact_idx runs
    the contact quadratics on that sub-batch only."""
    def loss(p, neighbors):
        out = smpl_forward(smpl, betas, p['body_pose'], p['global_orient'])
        return L.contact_fitting_loss(
            p['body_pose'], p['global_orient'], betas, out.joints,
            out.vertices, cam_t, camera_center, joints_2d, joints_conf,
            prior, assets, gt_contact, ignore_idxs, has_discrete_contact,
            config.euclthres, focal_length=config.focal_length,
            contact_loss_weight=config.contact_loss_weight,
            cached_neighbors=neighbors, compact_idx=compact_idx,
            mesh=config.mesh)

    @torch.no_grad()
    def neighbors(p, prev_exterior=None, candidate_k=0):
        verts = smpl_forward(smpl, betas, p['body_pose'],
                             p['global_orient']).vertices
        if compact_idx is not None:
            verts = verts[compact_idx]
        return L.contact_neighbors(verts, assets, candidate_k=candidate_k,
                                   prev_exterior=prev_exterior,
                                   mesh=config.mesh)

    return ContactStage(loss, neighbors)


def smplify_dc(smpl: SMPL, prior: GMMPrior, assets: ContactAssets,
               init_pose: torch.Tensor,       # (B, 72) axis-angle
               init_betas: torch.Tensor,      # (B, 10)
               init_cam_t: torch.Tensor,      # (B, 3)
               camera_center: torch.Tensor,   # (B, 2)
               keypoints_2d: torch.Tensor,    # (B, 49, 3) px + conf
               gt_contact: torch.Tensor,      # (B, P)
               ignore_idxs: torch.Tensor,     # (B,) bool: skip contact
               has_discrete_contact: torch.Tensor,  # (B,) bool
               has_gt_keypoints: torch.Tensor,      # (B,) bool
               config: SMPLifyConfig) -> SMPLifyResult:
    """Two-stage batched fitting (reference SMPLifyDC.__call__)."""
    joints_2d = keypoints_2d[..., :2]
    joints_conf = keypoints_2d[..., 2]
    body_pose0 = init_pose[:, 3:]
    global_orient0 = init_pose[:, :3]
    betas0 = init_betas
    ignore_idxs = ignore_idxs.bool()
    has_discrete_contact = has_discrete_contact.bool()

    # ---------------- Stage 1: camera (+ betas when contact) -------------
    spw = 1.0 if config.use_contact else 0.0

    def camera_loss(p):
        go = p.get('global_orient', global_orient0)
        bt = p.get('betas', betas0)
        out = smpl_forward(smpl, bt, body_pose0, go)
        return L.camera_fitting_loss(
            out.joints, bt, p['cam_t'], init_cam_t, camera_center,
            joints_2d, joints_conf, focal_length=config.focal_length,
            shape_prior_weight=spw)

    # stepped on clones: init_cam_t stays the camera prior's target
    if config.use_contact:
        cam_params = {'betas': betas0, 'cam_t': init_cam_t}
    else:
        cam_params = {'global_orient': global_orient0, 'cam_t': init_cam_t}
    cam_params, _ = _run_adam(camera_loss, contiguous_clones(cam_params),
                              config.num_iters, config.step_size)
    cam_t = cam_params['cam_t']
    betas1 = cam_params.get('betas', betas0)
    global_orient1 = cam_params.get('global_orient', global_orient0)

    # ---------------- Stage 2: body pose ---------------------------------
    conf2 = joints_conf.clone()
    conf2[:, IGN_JOINT_IDS] = 0.0

    collect = None
    if config.collect_trajectory:
        @torch.no_grad()
        def collect(p):
            return smpl_forward(smpl, p.get('betas', betas1),
                                p['body_pose'], p['global_orient']).vertices

    trunc_frac = None
    if config.use_contact:
        K = max(1, config.exterior_refresh_every)
        B = body_pose0.shape[0]
        mesh = config.mesh
        Bg = B * (1 if mesh is None else mesh.dp)       # the global batch
        cap = int(config.contact_capacity)
        compact_idx = None
        if 0 < cap < Bg:
            active = PM.dp_gather(~ignore_idxs, mesh)
            compact_idx = PM.local_compact(L.compact_take(active, cap),
                                           mesh, B)
            trunc_frac = L.compact_overflow_frac(active, cap)

        stage = contact_stage(smpl, prior, assets, betas1, cam_t,
                              camera_center, joints_2d, conf2, gt_contact,
                              ignore_idxs, has_discrete_contact, config,
                              compact_idx)
        Kc = max(0, int(config.contact_candidate_k))
        p = contiguous_clones({'body_pose': body_pose0,
                               'global_orient': global_orient1})
        opt = Adam(p, config.step_size)
        # Candidate mode seeds with one EXACT pass (distance-ranked
        # candidates cannot see interiors of geodesically local folds);
        # refreshes then retest known interiors first.
        neighbors = stage.neighbors(p) if Kc else None
        traj = []
        for it in range(config.num_iters):
            if collect is not None:
                traj.append(collect(p))
            if Kc:
                if it % K == 0 and it > 0:
                    neighbors = stage.neighbors(p, neighbors[0], Kc)
            elif it % K == 0:
                neighbors = stage.neighbors(p)
            _, grads = value_and_grad(lambda q: stage.loss(q, neighbors), p)
            opt.step(p, grads)
        body_params = p
        betas2 = betas1
    else:
        def body_loss(p):
            out = smpl_forward(smpl, p['betas'], p['body_pose'],
                               p['global_orient'])
            return L.body_fitting_loss(
                p['body_pose'], p['betas'], out.joints, cam_t,
                camera_center, joints_2d, conf2, prior,
                focal_length=config.focal_length)

        body_params = contiguous_clones({'body_pose': body_pose0,
                                         'global_orient': global_orient1,
                                         'betas': betas1})
        body_params, traj = _run_adam(body_loss, body_params,
                                      config.num_iters, config.step_size,
                                      collect=collect)
        betas2 = body_params['betas']

    body_pose2 = body_params['body_pose']
    global_orient2 = body_params['global_orient']

    # ---------------- Final evaluation ------------------------------------
    with torch.no_grad():
        out = smpl_forward(smpl, betas2, body_pose2, global_orient2)
        first25 = torch.arange(49, device=conf2.device)[None, :] < 25
        conf_final = torch.where(has_gt_keypoints.bool()[:, None] & first25,
                                 torch.zeros_like(conf2), conf2)
        reproj = L.body_fitting_loss(
            body_pose2, betas2, out.joints, cam_t, camera_center, joints_2d,
            conf_final, prior, focal_length=config.focal_length,
            output='reprojection')
    return SMPLifyResult(
        vertices=out.vertices, joints=out.joints,
        pose=torch.cat([global_orient2, body_pose2], dim=-1).detach(),
        betas=betas2.detach(), camera_translation=cam_t.detach(),
        reprojection_loss=reproj,
        trajectory=torch.stack(traj) if config.collect_trajectory else None,
        contact_truncated_frac=trunc_frac)


@torch.no_grad()
def get_fitting_loss(smpl: SMPL, prior: GMMPrior, pose: torch.Tensor,
                     betas: torch.Tensor, cam_t: torch.Tensor,
                     camera_center: torch.Tensor,
                     keypoints_2d: torch.Tensor,
                     has_gt_keypoints: Optional[torch.Tensor] = None,
                     focal_length: float = 5000.0) -> torch.Tensor:
    """Per-joint reprojection loss of given parameters, (B, 49)."""
    joints_2d = keypoints_2d[..., :2]
    conf = keypoints_2d[..., 2].clone()
    conf[:, IGN_JOINT_IDS] = 0.0
    if has_gt_keypoints is not None:
        first25 = torch.arange(49, device=conf.device)[None, :] < 25
        conf = torch.where(has_gt_keypoints.bool()[:, None] & first25,
                           torch.zeros_like(conf), conf)
    out = smpl_forward(smpl, betas, pose[:, 3:], pose[:, :3])
    return L.body_fitting_loss(
        pose[:, 3:], betas, out.joints, cam_t, camera_center, joints_2d,
        conf, prior, focal_length=focal_length, output='reprojection')
