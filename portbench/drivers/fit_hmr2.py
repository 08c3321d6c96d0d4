"""Fitting cells of HMR 2.0 (the program's models/hmr2): drivers/fit's cell
with the backbone's drop-path keep-masks in place of the IEF head's dropout
masks.

Set-up, window and the first image's readings are drivers/fit's: the
program's runtime with the configuration's backbone built for its crop
size, weights and the folding start made from the seed, the traffic's stop
rule and Adam, a warm-up image (which captures the CUDA graphs), then
images 0, 1, ... until --seconds have passed. Image i's crop, keypoints
and contact labels come from the generator seeded by (seed, i), and the
drop-path masks of each of its steps from that generator after them, one
(2 depth, 1) draw a step. The window also counts kernel 1's launches
(ops/attention.mha_cuda.launches, which counts a CUDA graph's launches at
each replay) for mha_roofline.fit_hmr2.

The check follows the window's first image with tuchref's SMPL, loss and
EFT fit around reference/hmr2_ref.py, the plain HMR 2.0, in float32 with
TF32 off, and compares as reference/fit_ref.compare does, and besides the
first step's body as the loss received it (output_gap: its vertices,
camera translation and betas). The first step's losses and gradient go
through the EFT loss's contact decisions, which a rounding can flip at
B=1 (PERF.md); the body before the loss is a smooth function of HMR 2.0's
outputs, where the TF32 control shows.
"""

import functools
import math
import time

import torch
from torch.profiler import record_function

from portbench.drivers import fit as F

SPANS = F.SPANS + ('hmr.',)


def draw_masks(config, gen, device):
    """One step's drop-path keep-masks, (2 depth, 1) bool: block i's two
    branches each kept with probability 1 - linspace(0, rate, depth)[i]
    (timm's and ViTPose's rates, in float32 on the CPU, then Python
    floats)."""
    depth = config['num_hidden_layers']
    keep = keep_probs(depth, config['drop_path_rate'], device)
    u = torch.rand(2 * depth, 1, generator=gen, device=device)
    return u < keep[:, None]


@functools.lru_cache(maxsize=None)
def keep_probs(depth, rate, device):
    """(2 depth,) each branch's keep probability on `device`, made once (a
    copy from the host waits for the device, which a draw every step must
    not), outside inference mode."""
    rates = torch.linspace(0, rate, depth, device='cpu').tolist()
    with torch.inference_mode(False):
        return torch.tensor([1.0 - r for r in rates],
                            device=device).repeat_interleave(2)


def fit_image(fit_one, start, seed, i, P, config, device):
    img, kp, contact, gen = F.image_inputs(seed, i, P, config['img_res'],
                                           device)
    return fit_one(start, img, kp, contact,
                   dropout=lambda step: draw_masks(config, gen, device))


class FirstFit(F.FirstFit):
    """drivers/fit.FirstFit, and the first step's (vertices, camera
    translation, betas) as eft_mod's eft_loss receives them."""

    def __init__(self, eft_mod):
        super().__init__(eft_mod)
        self.body = None
        rec, loss_fn = self, eft_mod.eft_loss

        def eft_loss(joints, betas, vertices, cam_t, *args, **kwargs):
            if rec.active and rec.body is None:
                rec.body = tuple(t.detach().clone()
                                 for t in (vertices, cam_t, betas))
            return loss_fn(joints, betas, vertices, cam_t, *args, **kwargs)

        eft_mod.eft_loss = eft_loss

    def arm(self):
        super().arm()
        self.body = None

    def readings(self):
        return dict(super().readings(), body=self.body)


def output_gap(body, ref_body):
    """max over the first step's vertices, camera translation and betas of
    max |program - reference| / max |reference| (inf where not finite, as
    reference/fit_ref.compare reports)."""
    gap = max(float((a - b).abs().max() / b.abs().max())
              for a, b in zip(body, ref_body))
    return gap if math.isfinite(gap) else float('inf')


def compare(program, ref, limits):
    """reference/fit_ref.compare's checks and output_gap."""
    from portbench.reference import fit_ref
    checks = fit_ref.compare(program, ref, limits)
    return checks + [dict(name='output_gap',
                          value=output_gap(program['body'], ref['body']),
                          limit=float(limits['output_gap']))]


def mha_launches():
    """The program's kernel-1 launch count so far."""
    from tuch_tpu_torch.ops import attention
    return attention.mha_cuda.launches


def follow(config, traffic, seed, device):
    """The reference's readings of image 0 (reference/fit_ref.follow with
    reference/hmr2_ref.py in tuchref's HMR's place)."""
    from portbench.reference import hmr2_ref
    from portbench.reference.tuchref import runtime as rrt
    from portbench.reference.tuchref.fitting import eft
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        runtime = rrt.build_runtime(
            device=device, num_verts=config['num_verts'],
            backbone='resnet50', with_contact=True, dtype='float32')
        means = [b.cpu().numpy() for b in (runtime.hmr.init_pose,
                                           runtime.hmr.init_shape,
                                           runtime.hmr.init_cam)]
        with torch.device(device):
            hmr = hmr2_ref.HMR2(*means, name=config['backbone'],
                                img_res=config['img_res'])
        runtime = runtime._replace(hmr=hmr.to(device).eval())
        start = F.seed_model(hmr, config, traffic, seed, device)
        first = FirstFit(eft)
        fit_one = F.fit_function(eft, runtime, traffic, config['img_res'])
        first.arm()
        r = fit_image(fit_one, start, seed, 0, len(runtime.contact_classes),
                      config, device)
        return dict(first.readings(), steps=r.steps)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = prev


class Cell(F.Cell):
    span_prefixes = SPANS

    def setup(self):
        from tuch_tpu_torch import runtime as rt
        from tuch_tpu_torch.fitting import eft
        c, t, dev = self.config, self.traffic, self.device
        rt.deterministic(dev)
        F.set_precision(c, self.ctx['control'])
        self.runtime = rt.build_runtime(
            device=dev, synthetic=True, num_verts=c['num_verts'],
            backbone=c['backbone'], with_contact=True, dtype=c['dtype'],
            img_res=c['img_res'])
        self.start = F.seed_model(self.runtime.hmr, c, t, self.seed, dev)
        self.P = len(self.runtime.contact_classes)
        self.first = FirstFit(eft)
        self.fit_one = F.fit_function(eft, self.runtime, t, c['img_res'])
        res = fit_image(self.fit_one, self.start, self.seed, -1, self.P, c,
                        dev)        # the warm-up image
        float(res.betas.sum())
        self.counts = F.contact_counters()
        F.sync(dev)

    def window(self, seconds, prof=None):
        self.fits = []
        for v in self.counts.values():
            v.clear()
        self.first.arm()
        if prof is not None:
            prof.start()
        with record_function('portbench.window'):
            t0 = time.perf_counter()
            n0 = mha_launches()
            while True:
                with record_function('portbench.fit_one'):
                    r = fit_image(self.fit_one, self.start, self.seed,
                                  len(self.fits), self.P, self.config,
                                  self.device)
                self.fits.append(r)
                if time.perf_counter() - t0 >= seconds:
                    break
            pose = torch.cat([r.pose for r in self.fits]).cpu()
            betas = torch.cat([r.betas for r in self.fits]).cpu()
            launches = mha_launches() - n0
            t1 = time.perf_counter()
        if prof is not None:
            prof.stop()
        window_s = t1 - t0
        n = len(self.fits)
        finite = torch.isfinite(pose).all(1) & torch.isfinite(betas).all(1)
        self.checked = dict(self.first.readings(), steps=self.fits[0].steps)
        steps = [r.steps for r in self.fits]
        return dict(e2e={'fit_images_per_s': n / window_s},
                    window_s=window_s, images=n, attempted=n,
                    failed=int((~finite).sum()), steps=steps,
                    counts={k: list(v) for k, v in self.counts.items()},
                    mha_launches=launches,
                    note=f'{n} images in {window_s:.3f} s, steps {steps}, '
                         f'{launches} kernel-1 launches')

    def check(self):
        ref = follow(self.config, self.traffic, self.seed, self.device)
        return compare(self.checked, ref, self.traffic['limits'])
