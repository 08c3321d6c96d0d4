"""SMPL body model: an nn.Module holding the model arrays as buffers.

Counterpart of tuch_tpu/models/smpl.py: shape blendshapes, pose-corrective
blendshapes, the joint regressor, the kinematic chain unrolled over the 24
joints, linear blend skinning, the 21 surface-vertex joints, the 9 extra
regressed joints and the remap to the 49-joint convention.
"""

import functools
from typing import NamedTuple

import torch
from torch import nn

from tuch_tpu_torch.assets import SMPLModel
from tuch_tpu_torch.utils.rotations import batch_rodrigues


class SMPLOutput(NamedTuple):
    vertices: torch.Tensor     # (B, V, 3)
    joints: torch.Tensor       # (B, 49, 3)
    joints_smpl: torch.Tensor  # (B, 24, 3) posed skeleton joints


class SMPL(nn.Module):
    """The SMPLModel arrays as buffers; forward is smpl_forward."""

    def __init__(self, model: SMPLModel):
        super().__init__()
        for name in ('v_template', 'shapedirs', 'posedirs', 'J_regressor',
                     'lbs_weights', 'J_regressor_extra'):
            self.register_buffer(
                name, torch.as_tensor(getattr(model, name),
                                      dtype=torch.float32))
        for name in ('faces', 'vertex_joint_ids', 'joint_map'):
            self.register_buffer(
                name, torch.as_tensor(getattr(model, name),
                                      dtype=torch.long))
        # the kinematic tree drives a Python loop: keep it on the host
        self.parents = [int(p) for p in model.parents]

    def forward(self, betas, body_pose, global_orient, pose2rot=True):
        return smpl_forward(self, betas, body_pose, global_orient, pose2rot)


def _transform_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> homogeneous (..., 4, 4)."""
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=R.dtype,
                         device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


@functools.lru_cache(maxsize=None)
def _index_on(index: tuple, device) -> torch.Tensor:
    """index as a long tensor on device, made once: indexing with a host
    list copies it to the device each call, which waits for the device.
    Made outside inference mode, so that autograd may save it later."""
    with torch.inference_mode(False):
        return torch.tensor(index, dtype=torch.long, device=device)


def rigid_transform(rot_mats: torch.Tensor, joints: torch.Tensor, parents):
    """Forward kinematics along the kinematic tree.

    rot_mats (B, J, 3, 3); joints (B, J, 3); parents a host int sequence.
    Returns posed joints (B, J, 3) and per-joint skinning transforms
    (B, J, 4, 4) relative to the rest pose.
    """
    B, J = joints.shape[:2]
    up = _index_on(tuple(int(p) for p in parents[1:]), joints.device)
    rel = torch.cat([joints[:, :1], joints[:, 1:] - joints[:, up]], dim=1)
    mats = _transform_mat(rot_mats, rel)  # (B, J, 4, 4)

    chains = [mats[:, 0]]
    for j in range(1, J):
        chains.append(chains[parents[j]] @ mats[:, j])
    A_global = torch.stack(chains, dim=1)  # (B, J, 4, 4)

    posed_joints = A_global[:, :, :3, 3]
    # Subtract the rest-pose joint contribution: A_rel = A_global - [0 | A j].
    joints_h = torch.cat([joints, joints.new_zeros(B, J, 1)], dim=-1)
    correction = torch.einsum('bjik,bjk->bji', A_global, joints_h)
    A_rel = A_global.clone()
    A_rel[:, :, :3, 3] -= correction[..., :3]
    return posed_joints, A_rel


def smpl_forward(model: SMPL, betas: torch.Tensor, body_pose: torch.Tensor,
                 global_orient: torch.Tensor,
                 pose2rot: bool = True) -> SMPLOutput:
    """SMPL forward pass.

    betas (B, 10). If pose2rot: body_pose (B, 69) and global_orient (B, 3)
    axis-angle; else body_pose (B, 23, 3, 3) and global_orient (B, 1, 3, 3)
    rotation matrices.
    """
    B = betas.shape[0]
    J = model.J_regressor.shape[0]

    if pose2rot:
        full_aa = torch.cat([global_orient.reshape(B, 1, 3),
                             body_pose.reshape(B, J - 1, 3)], dim=1)
        rot_mats = batch_rodrigues(full_aa)  # (B, J, 3, 3)
    else:
        rot_mats = torch.cat([global_orient.reshape(B, 1, 3, 3),
                              body_pose.reshape(B, J - 1, 3, 3)], dim=1)

    # Shape blendshapes.
    v_shaped = model.v_template[None] + torch.einsum(
        'vds,bs->bvd', model.shapedirs, betas)
    joints_rest = torch.einsum('jv,bvd->bjd', model.J_regressor, v_shaped)

    # Pose-corrective blendshapes (identity-subtracted rotations, joints 1:).
    eye = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
    pose_feature = (rot_mats[:, 1:] - eye).reshape(B, -1)  # (B, 207)
    v_posed = v_shaped + torch.einsum('vdp,bp->bvd', model.posedirs,
                                      pose_feature)

    posed_joints, A = rigid_transform(rot_mats, joints_rest, model.parents)

    # Linear blend skinning.
    T = torch.einsum('vj,bjik->bvik', model.lbs_weights, A)  # (B, V, 4, 4)
    verts = torch.einsum('bvik,bvk->bvi', T[..., :3, :3], v_posed) \
        + T[..., :3, 3]

    # 54-joint output: 24 skeleton + 21 surface verts + 9 extra regressed.
    vertex_joints = verts[:, model.vertex_joint_ids, :]
    extra_joints = torch.einsum('jv,bvd->bjd', model.J_regressor_extra, verts)
    joints54 = torch.cat([posed_joints, vertex_joints, extra_joints], dim=1)
    joints49 = joints54[:, model.joint_map, :]

    return SMPLOutput(vertices=verts, joints=joints49,
                      joints_smpl=posed_joints)



def smpl_forward_pose72(model: SMPL, betas: torch.Tensor,
                        pose: torch.Tensor) -> SMPLOutput:
    """smpl_forward on 72-dim axis-angle poses (B, 72): global orient
    first."""
    return smpl_forward(model, betas, pose[:, 3:], pose[:, :3])
