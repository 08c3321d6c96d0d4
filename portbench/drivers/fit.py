"""Fitting cells: fitting/eft.make_eft_fit_fn's fit_one, image after image
at B=1 with the reference's stop rule, each image from the same weights.

Set-up builds the program's runtime (the synthetic full-topology body and
its contact assets), loads weights made from the seed (and the folding
pose the IEF loop starts from), takes the start state, builds the fit
function with the traffic's stop rule and Adam, and fits one warm-up image.
Image i's crop, keypoints and contact labels, and the head's dropout masks
of each of its steps, come from a generator seeded by (seed, i). The
window fits images 0, 1, ... until --seconds have passed, closing at the
end of the image in flight. Each fit is a short training run, so its first
image is held to the plain reference as a training step is: the losses of
its first three steps, its first gradient (Adam's first moment after one
step) and each leaf's change after three steps, recorded as the window's
own call makes them (FirstFit wraps the fit's loss and its Adam), and its
step count.
"""

import time

import torch
from torch.profiler import record_function

from portbench import common

SPANS = ('eft_step.', 'portbench.')
SALT_POSE, SALT_IMAGE = 14, 31


def sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def set_precision(config, control):
    """The configuration's float32 (TF32 off for convolutions and
    matmuls); the control turns TF32 on, the nearest lower precision."""
    tf32 = bool(config['tf32']) or control
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32


def contact_counters():
    """Shape-recording wrappers around the program's kernel 2 and kernel 4
    launches: {'winding': [(B, Q, F)], 'masked_min': [(B, V, allowed)]}.
    The program's dispatchers resolve the *_cuda names at call time, so
    the wrappers see every launch."""
    from tuch_tpu_torch.ops import contact_kernels as CK
    rec = {'winding': [], 'masked_min': []}
    wind, mmin = CK.winding_numbers_tris_cuda, CK.masked_min_dist_cuda
    allowed = {}

    def winding(points, tris):
        rec['winding'].append((points.shape[0], points.shape[1],
                               tris.shape[1]))
        return wind(points, tris)

    def masked(verts, mask, bits=None):
        key = (mask.data_ptr(), tuple(mask.shape))
        if key not in allowed:
            allowed[key] = int(mask.sum())
        rec['masked_min'].append((verts.shape[0], verts.shape[1],
                                  allowed[key]))
        return mmin(verts, mask, bits)

    winding.launches = masked.launches = 0
    CK.winding_numbers_tris_cuda, CK.masked_min_dist_cuda = winding, masked
    return rec


def draw_masks(B, gen, device):
    """The IEF head's dropout keep-masks (3 pairs of (B, 1024) bool, kept
    with probability 0.5), in models/hmr.draw_dropout_masks' layout."""
    keep = torch.rand(3, 2, B, common.HMR_HEAD_WIDTH, generator=gen,
                      device=device) < 0.5
    return [(keep[i, 0], keep[i, 1]) for i in range(3)]


def image_inputs(seed, i, num_classes, img_res, device):
    """Image i of the seed: (img (1, res, res, 3) normalised, keypoints
    (1, 49, 3) in [-1, 1] with confidences, contact labels (1, P)), and
    the generator its dropout masks are then drawn from, step by step."""
    gen = common.seeded_generator(seed, SALT_IMAGE * 100003 + i, device)
    low = torch.rand(1, 3, 7, 7, generator=gen, device=device)
    img = torch.nn.functional.interpolate(low, size=(img_res, img_res),
                                          mode='bilinear',
                                          align_corners=False)
    img = img + 0.08 * torch.randn(img.shape, generator=gen, device=device)
    mean = torch.tensor([0.485, 0.456, 0.406], device=device)
    std = torch.tensor([0.229, 0.224, 0.225], device=device)
    img = ((img.clamp(0, 1).permute(0, 2, 3, 1) - mean) / std).contiguous()
    xy = torch.rand(1, 49, 2, generator=gen, device=device) * 1.6 - 0.8
    conf = (torch.rand(1, 49, 1, generator=gen, device=device) > 0.2).float()
    kp = torch.cat([xy, conf], -1)
    contact = (torch.rand(1, num_classes, generator=gen,
                          device=device) > 0.7).float()
    return img, kp, contact, gen


class FirstFit:
    """Records the next fit's first three losses, its first gradient per
    leaf (Adam's first moment after one step over 1 - b1) and each leaf's
    change after three steps, on the device without a synchronisation, by
    wrapping eft_mod's eft_loss and Adam (the program's module, or the
    frozen copy's)."""

    STEPS = 3

    def __init__(self, eft_mod):
        self.active, self.losses, self.grad, self.change = False, [], None, \
            None
        self.opt = self.start = None
        rec, loss_fn, base = self, eft_mod.eft_loss, eft_mod.Adam

        def eft_loss(*args, **kwargs):
            total, parts = loss_fn(*args, **kwargs)
            if rec.active and len(rec.losses) < rec.STEPS:
                rec.losses.append(total.detach().clone())
            return total, parts

        class Adam(base):
            def __init__(self, params, lr, *args, **kwargs):
                super().__init__(params, lr, *args, **kwargs)
                if rec.active and rec.opt is None:
                    rec.opt, rec.steps = self, 0
                    rec.start = {k: v.clone() for k, v in params.items()}

            def step(self, params, grads):
                out = super().step(params, grads)
                if rec.opt is self:
                    rec.steps += 1
                    if rec.steps == 1:
                        rec.grad = {k: m / (1 - self.b1)
                                    for k, m in self.mu.items()}
                    if rec.steps == rec.STEPS:
                        rec.change = {k: out[k] - rec.start[k]
                                      for k in out}
                        rec.active, rec.opt, rec.start = False, None, None
                return out

        eft_mod.eft_loss, eft_mod.Adam = eft_loss, Adam

    def arm(self):
        self.active, self.losses, self.grad, self.change = True, [], None, \
            None
        self.opt = self.start = None

    def readings(self):
        """{'losses': [float], 'grad': {leaf: norm}, 'change': {...}}."""
        return dict(losses=[float(x) for x in self.losses],
                    grad=common.leaf_norms(self.grad),
                    change=common.leaf_norms(self.change))


def fit_function(eft_mod, runtime, traffic, img_res):
    w = traffic['weights']
    return eft_mod.make_eft_fit_fn(
        runtime.hmr, runtime.smpl, runtime.contact,
        eft_mod.EFTWeights(keypoints=w['keypoints'], shape=w['shape'],
                           contact=w['contact']),
        max_steps=traffic['max_steps'],
        early_stop_loss=traffic['early_stop_loss'],
        min_steps=traffic['min_steps'], lr=traffic['lr'], img_res=img_res)


def seed_model(hmr, config, traffic, seed, device):
    """The seed's weights and folding pose into hmr; its start state."""
    shapes = {k: tuple(p.shape) for k, p in hmr.named_parameters()}
    w = common.seeded_weights(shapes, seed, device)
    pose0 = common.fold_pose6d(common.seeded_generator(seed, SALT_POSE,
                                                       device),
                               traffic['fold_scale'], device)
    with torch.no_grad():
        for k, p in hmr.named_parameters():
            p.copy_(w[k])
        hmr.init_pose.copy_(pose0)
    return {k: v.detach().clone() for k, v in hmr.state_dict().items()}


def fit_image(fit_one, start, seed, i, P, img_res, device):
    img, kp, contact, gen = image_inputs(seed, i, P, img_res, device)
    return fit_one(start, img, kp, contact,
                   dropout=lambda step: draw_masks(1, gen, device))


class Cell:
    span_prefixes = SPANS

    def __init__(self, ctx):
        self.ctx = ctx
        self.config, self.traffic = ctx['config'], ctx['traffic']
        self.device, self.seed = ctx['device'], ctx['seed']

    def setup(self):
        from tuch_tpu_torch import runtime as rt
        from tuch_tpu_torch.fitting import eft
        c, t, dev = self.config, self.traffic, self.device
        rt.deterministic(dev)
        set_precision(c, self.ctx['control'])
        self.runtime = rt.build_runtime(
            device=dev, synthetic=True, num_verts=c['num_verts'],
            backbone=c['backbone'], with_contact=True, dtype=c['dtype'])
        self.start = seed_model(self.runtime.hmr, c, t, self.seed, dev)
        self.P = len(self.runtime.contact_classes)
        self.first = FirstFit(eft)
        self.fit_one = fit_function(eft, self.runtime, t, c['img_res'])
        res = fit_image(self.fit_one, self.start, self.seed, -1, self.P,
                        c['img_res'], dev)        # the warm-up image
        float(res.betas.sum())
        self.counts = contact_counters()
        sync(dev)

    def window(self, seconds, prof=None):
        res_px = self.config['img_res']
        self.fits = []
        for v in self.counts.values():
            v.clear()
        self.first.arm()
        if prof is not None:
            prof.start()
        with record_function('portbench.window'):
            t0 = time.perf_counter()
            while True:
                with record_function('portbench.fit_one'):
                    r = fit_image(self.fit_one, self.start, self.seed,
                                  len(self.fits), self.P, res_px,
                                  self.device)
                self.fits.append(r)
                if time.perf_counter() - t0 >= seconds:
                    break
            pose = torch.cat([r.pose for r in self.fits]).cpu()
            betas = torch.cat([r.betas for r in self.fits]).cpu()
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
                    note=f'{n} images in {window_s:.3f} s, steps {steps}')

    def release(self):
        if getattr(self, 'runtime', None) is None:
            return
        self.runtime = self.fit_one = self.start = None
        sync(self.device)
        if torch.device(self.device).type == 'cuda':
            torch.cuda.empty_cache()

    def check(self):
        from portbench.reference import fit_ref
        ref = fit_ref.follow(self.config, self.traffic, self.seed,
                             self.device)
        return fit_ref.compare(self.checked, ref, self.traffic['limits'])
