"""The plain reference of a fitting cell, and the comparison that decides
`correct`.

The frozen copy builds its own runtime (synthetic body, contact tables and
geodesic mask), takes the weights and folding pose the benchmark made from
the seed, and fits the window's first image with its own EFT fit (plain
kernels, float32 with TF32 off) from the same crop, keypoints, contact
labels and dropout masks, with the same stop rule, recording its first
steps as the program's are recorded (drivers/fit.FirstFit).
"""

import statistics

import numpy as np
import torch

from portbench.drivers import fit as F

# leaves whose reference gradient is below this share of the median leaf's
# are nought to rounding (a bias under a normalisation): left out
NOUGHT = 1e-3


def follow(config, traffic, seed, device):
    """The first image's readings: losses of its first steps, first
    gradient and change per leaf, and its step count."""
    from portbench.reference.tuchref import runtime as rrt
    from portbench.reference.tuchref.fitting import eft
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        runtime = rrt.build_runtime(
            device=device, num_verts=config['num_verts'],
            backbone=config['backbone'], with_contact=True, dtype='float32')
        start = F.seed_model(runtime.hmr, config, traffic, seed, device)
        first = F.FirstFit(eft)
        fit_one = F.fit_function(eft, runtime, traffic, config['img_res'])
        first.arm()
        r = F.fit_image(fit_one, start, seed, 0,
                        len(runtime.contact_classes), config['img_res'],
                        device)
        return dict(first.readings(), steps=r.steps)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = prev


def worst_leaf_gap(got, want, keep):
    """max over kept leaves of |got - want| / max(want, the median kept
    leaf's want): the gap between the two norms, not the norm of the
    difference."""
    med = statistics.median(want[k] for k in keep)
    return max(abs(got[k] - want[k]) / max(want[k], med) for k in keep)


def compare(program, ref, limits):
    """The numbers compared, each beside its limit: the first image's first
    steps as a training run's (the losses' largest relative gap, the first
    gradient's and the change's worst leaf), and the difference in its step
    count (exact: limit 0). Its fitted pose and betas after up to 50 steps
    are not compared: a contact decision that flips on rounding sends the
    fit elsewhere (PERF.md)."""
    med = statistics.median(ref['grad'].values())
    keep = [k for k, v in ref['grad'].items() if v >= NOUGHT * med]
    values = {
        'loss_gap': max(abs(a - b) / abs(b) for a, b in
                        zip(program['losses'], ref['losses'])),
        'grad_gap': worst_leaf_gap(program['grad'], ref['grad'], keep),
        'update_gap': worst_leaf_gap(program['change'], ref['change'],
                                     keep),
        'steps_gap': abs(program['steps'] - ref['steps']),
    }
    return [dict(name=k, value=float(v) if np.isfinite(v) else float('inf'),
                 limit=float(limits[k])) for k, v in values.items()]
