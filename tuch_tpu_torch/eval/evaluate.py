"""Benchmark evaluation: MPJPE and PA-MPJPE with the contact-subset report.

Counterpart of tuch_tpu/eval/evaluate.py (the reference's eval.py): per
batch the HMR's eval-mode forward, SMPL, the H36M regressor's joints
aligned at the pelvis against the ground truth (gendered SMPL for 3DPW,
the dataset's 3D joints for MPI-INF-3DHP), MPJPE and a batched Procrustes
PA-MPJPE (utils/procrustes.py), all on the device.

On a dp mesh (parallel/mesh.Mesh) every rank reads the same batches; a
batch that divides over dp is split, each rank evaluates its slice and the
per-image results are gathered onto every rank; a ragged batch runs whole
on every rank (the JAX package runs it unsharded). Rank 0 prints and
writes the result file.
"""

import os
from typing import Dict, Optional

import numpy as np
import torch

from tuch_tpu_torch import constants
from tuch_tpu_torch.data.loader import CheckpointLoader, LoaderState
from tuch_tpu_torch.models.smpl import smpl_forward, smpl_forward_pose72
from tuch_tpu_torch.parallel import mesh as pmesh
from tuch_tpu_torch.utils.procrustes import mpjpe as mpjpe_fn
from tuch_tpu_torch.utils.procrustes import reconstruction_error
from tuch_tpu_torch.utils.rotations import rotmat_to_aa


def make_eval_step(hmr, smpl_neutral, smpl_male, smpl_female,
                   j_regressor_h36m: np.ndarray, dataset_name: str):
    """The per-batch evaluation (eval.py:142-195): step(batch) -> (mpjpe
    (B,), pa_mpjpe (B,), rotmat, betas, camera, H36M joints), tensors on
    the body models' device. smpl_male / smpl_female None take the neutral
    body."""
    dev = smpl_neutral.v_template.device
    three_dhp = dataset_name == 'mpi-inf-3dhp'
    mapper = torch.as_tensor(constants.H36M_TO_J17 if three_dhp
                             else constants.H36M_TO_J14, device=dev)
    mapper_gt = torch.as_tensor(constants.J24_TO_J17 if three_dhp
                                else constants.J24_TO_J14, device=dev)
    J = torch.as_tensor(np.asarray(j_regressor_h36m), dtype=torch.float32,
                        device=dev)

    @torch.no_grad()
    def step(batch):
        b = {k: torch.as_tensor(batch[k], device=dev)
             for k in ('img', 'pose', 'betas', 'gender', 'pose_3d')
             if k in batch}
        hmr.eval()
        rotmat, betas, camera = hmr(b['img'])
        pred = smpl_forward(smpl_neutral, betas, rotmat[:, 1:],
                            rotmat[:, :1], pose2rot=False)
        pred_j = torch.einsum('jv,bvd->bjd', J, pred.vertices)
        pred_j14 = pred_j[:, mapper] - pred_j[:, :1]
        if three_dhp:
            gt_j14 = b['pose_3d'][:, mapper_gt, :3]
        else:
            # gendered ground-truth vertices (eval.py:173-175)
            gt_m = smpl_forward_pose72(smpl_male or smpl_neutral,
                                       b['betas'], b['pose'])
            gt_f = smpl_forward_pose72(smpl_female or smpl_neutral,
                                       b['betas'], b['pose'])
            female = (b['gender'] == 1)[:, None, None]
            gt_verts = torch.where(female, gt_f.vertices, gt_m.vertices)
            gt_j = torch.einsum('jv,bvd->bjd', J, gt_verts)
            gt_j14 = gt_j[:, mapper] - gt_j[:, :1]
        err = mpjpe_fn(pred_j14, gt_j14)
        pa = reconstruction_error(pred_j14, gt_j14, reduction=None)
        return err, pa, rotmat, betas, camera, pred_j

    return step


def report_with_contact_subsets(mpjpe: np.ndarray, recon: np.ndarray,
                                cnc_arr: Optional[np.ndarray],
                                euclthres_lower: float = 0.01
                                ) -> Dict[str, float]:
    """The final report in mm, with the contact, no-contact and unclear
    subsets when cnc_arr (each sample's least contact distance from the
    3DPW contact signature; inf: no contact) is given (eval.py:63-88)."""
    out = {'mpjpe': 1000 * float(mpjpe.mean()),
           'pa_mpjpe': 1000 * float(recon.mean())}
    if cnc_arr is not None:
        cnc = cnc_arr[:len(mpjpe)]
        contact = cnc < euclthres_lower
        no_contact = np.isinf(cnc)
        unclear = ~(contact | no_contact)
        for name, mask in (('contact', contact), ('no_contact', no_contact),
                           ('unclear', unclear)):
            if mask.any():
                out[f'mpjpe_{name}'] = 1000 * float(mpjpe[mask].mean())
                out[f'pa_mpjpe_{name}'] = 1000 * float(recon[mask].mean())
            out[f'n_{name}'] = int(mask.sum())
    return out


def run_evaluation(hmr, dataset, dataset_name: str, smpl_neutral,
                   smpl_male, smpl_female, j_regressor_h36m,
                   batch_size: int = 32,
                   cnc_arr: Optional[np.ndarray] = None,
                   result_file: Optional[str] = None, log_freq: int = 50,
                   num_workers: int = 2, shuffle: bool = False, mesh=None
                   ) -> Dict[str, float]:
    """The whole dataset (eval.py:90-215); the report of
    report_with_contact_subsets. result_file: out/<result_file>.npz in
    the reference's schema (pred_joints, pose as (N, 72) axis-angle,
    betas, camera, mpjpe, recon_err), in dataset order (no shuffle).
    mesh: a dp mesh of ranks that share the batches (module note)."""
    main = mesh is None or mesh.rank == 0
    dp = 1 if mesh is None else mesh.dp
    step = make_eval_step(hmr, smpl_neutral, smpl_male, smpl_female,
                          j_regressor_h36m, dataset_name)
    loader = CheckpointLoader(dataset, batch_size=batch_size,
                              shuffle=shuffle and result_file is None,
                              num_workers=num_workers, drop_last=False)
    n = len(dataset)
    mpjpe = np.zeros(n)
    recon = np.zeros(n)
    save = result_file is not None
    if save:
        poses = np.zeros((n, 72))
        betas_all = np.zeros((n, 10))
        cams = np.zeros((n, 3))
        joints = np.zeros((n, np.asarray(j_regressor_h36m).shape[0], 3))
    seen = 0
    for bi, batch in enumerate(loader.epoch_iter(LoaderState(0, 0, 0))):
        if batch['img'].shape[0] % dp == 0:
            out = step(pmesh.shard_batch(batch, mesh))
            m, p, rotmat, betas, cam, pred_j = (pmesh.dp_gather(t, mesh)
                                                for t in out)
        else:
            m, p, rotmat, betas, cam, pred_j = step(batch)
        bsz = min(batch['img'].shape[0], n - seen)
        mpjpe[seen:seen + bsz] = m.cpu().numpy()[:bsz]
        recon[seen:seen + bsz] = p.cpu().numpy()[:bsz]
        if save:
            aa = torch.nan_to_num(rotmat_to_aa(rotmat)).reshape(-1, 72)
            poses[seen:seen + bsz] = aa.cpu().numpy()[:bsz]
            betas_all[seen:seen + bsz] = betas.cpu().numpy()[:bsz]
            cams[seen:seen + bsz] = cam.cpu().numpy()[:bsz]
            joints[seen:seen + bsz] = pred_j.cpu().numpy()[:bsz]
        seen += bsz
        if bi % log_freq == log_freq - 1 and main:
            interim = report_with_contact_subsets(
                mpjpe[:seen], recon[:seen],
                cnc_arr[:seen] if cnc_arr is not None else None)
            print(f'[{seen}/{n}] ' + ' '.join(
                f'{k}={v:.2f}' for k, v in interim.items()
                if isinstance(v, float)), flush=True)
    result = report_with_contact_subsets(mpjpe[:seen], recon[:seen],
                                         cnc_arr)
    if save and main:
        os.makedirs('out', exist_ok=True)
        np.savez(os.path.join('out', result_file), pred_joints=joints,
                 pose=poses, betas=betas_all, camera=cams, mpjpe=mpjpe,
                 recon_err=recon)
    return result
