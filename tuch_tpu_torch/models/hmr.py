"""HMR: a ResNet-50 or ViT backbone plus the iterative SMPL regressor.

Counterpart of tuch_tpu/models/hmr.py. With the ResNet-50 backbone the
state-dict keys are the reference's (SPIN/TUCH: conv1.weight,
layer1.0.conv1.weight, bn1.running_mean, fc1.weight, decpose.weight, ...),
so a reference .pt checkpoint loads directly; the graph follows
tuch_tpu/models/torch_ref.py: stride on the 3x3 conv, BatchNorm eps 1e-5
with running statistics, global mean pooling, and the 3-iteration IEF head
with no activation. A ViT backbone lives under ``backbone.*``.

train() is the JAX package's HMR(train=True): BatchNorm on the batch's
statistics with Flax's update of the running ones (BatchNorm2d), and the
head's two dropouts at rate 0.5 in every IEF iteration, on keep-masks the
caller passes (draw_dropout_masks draws them from a torch.Generator).
eval() is the serving graph.

Images come in NHWC, as in the JAX package; the ResNet permutes to NCHW.

Compute dtype (``dtype``, float32 or bfloat16), as the JAX package's HMR:
the image is cast to it, and the backbone runs in it (ResNet-50: the
convolutions, BatchNorm, ReLU, max pool, residual adds and the mean pool;
ViT: models/vit.py); its features are cast to float32 and the IEF head runs
in float32. Parameters and BatchNorm statistics stay float32, so loading is
the same for both dtypes: a convolution casts its weights to the input's
dtype at each call (store_compute_weights casts them once instead, for
serving), and BatchNorm takes a bfloat16 input with its float32
statistics, computes in float32 and rounds its output once, as Flax's
BatchNorm(dtype=bfloat16) does.

Two ResNet-50 options of the JAX package: ``stem_s2d`` and ``bn_fold``.
The JAX package's ``stem_s2d`` computes the 7x7 stride-2 stem as a 4x4
convolution on a 2x2 space-to-depth input, a layout for the TPU's matrix
unit, over the same weight and to the same result. cuDNN's 7x7 stem is
faster on CUDA cards, so here the flag is accepted and recorded, and the
stem stays the plain convolution: checkpoints and outputs are those of the
stock model. ``bn_fold`` is the inference-only folded form, biased
convolutions and no BatchNorm, whose weights fold_batchnorm makes from a
stock state dict (``folded`` does both for a model).

HMRGraphs replays the train-mode forward (image and keep-masks to rotmat,
betas, cam) and its backward (the outputs' gradients to the parameters')
as two CUDA graphs inside one autograd node, for callers that run the same
image shape step after step (EFT). It engages only where graph_engages
holds: a CUDA image, the model in train(), and no BatchNorm2d with a
sync_group (its all_reduce is not captured); everywhere else the caller
runs the eager forward. The math is the same on both paths: the graphs
replay the eager launches. See HMRGraphs for the contract. It takes HMR
and models/hmr2.HMR2 alike, each with its own masks (mask_buffer,
masks_in, load_masks).

create_hmr builds HMR for resnet50 and the models/vit.py configurations,
and HMR 2.0 (models/hmr2.py) for the names of HMR2_CONFIGS.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tuch_tpu_torch.models import hmr2 as hmr2_mod
from tuch_tpu_torch.models import vit as vit_mod
from tuch_tpu_torch.ops import attention
from tuch_tpu_torch.parallel.mesh import all_reduce_
from tuch_tpu_torch.utils.rotations import rot6d_to_rotmat

NPOSE = 24 * 6
N_ITER = 3  # IEF refinement steps
RESNET50_STAGES = (3, 4, 6, 3)
HEAD_WIDTH = 1024
DROPOUT_RATE = 0.5
# Flax's BatchNorm(momentum=0.9): ra = 0.9 ra + 0.1 batch statistic
BN_MOMENTUM = 0.9
# learned position embeddings outside any Linear (HMR 2.0's)
POSITION_PARAMS = ('pos_embed', 'pos_embedding')


class Conv2d(nn.Conv2d):
    """nn.Conv2d in the input's dtype, on float32 weights (and bias, in the
    folded form) cast per call (a no-op for a float32 input)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class _SyncBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm on (N, C, H, W) over the process group `group`,
    in float32 at least: the global batch's mean and biased variance in
    two passes, mean((x - mean)²), each per-channel sum accumulated in
    float64 and all-reduced over the group; y = x̂ w + b with x̂ = (x -
    mean) rsqrt(var + eps). The backward is BatchNorm's, dx = (g - mean(g)
    - x̂ mean(g x̂)) rsqrt(var + eps) w, with the two means over the
    group's batch (their sums in float64, one all_reduce); dw and db are
    this rank's sums, which the step's gradient all_reduce adds. Returns y
    and the global batch's mean and variance."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        n = xf.numel() // xf.shape[1] * torch.distributed.get_world_size(
            group)
        mean = all_reduce_(xf.sum((0, 2, 3), dtype=torch.float64), group) / n
        d = xf - mean.to(xf.dtype)[:, None, None]
        var = all_reduce_((d * d).sum((0, 2, 3), dtype=torch.float64),
                          group) / n
        invstd = torch.rsqrt(var + eps).to(xf.dtype)
        xhat = d * invstd[:, None, None]
        ctx.save_for_backward(xhat, invstd, weight)
        ctx.group, ctx.n, ctx.in_dtype = group, n, x.dtype
        y = xhat * weight[:, None, None] + bias[:, None, None]
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        xhat, invstd, weight = ctx.saved_tensors
        g = gy.to(xhat.dtype)
        sums = torch.stack([g.sum((0, 2, 3), dtype=torch.float64),
                            (g * xhat).sum((0, 2, 3), dtype=torch.float64)])
        dbias, dweight = sums.to(weight.dtype)
        means = (all_reduce_(sums.clone(), ctx.group) / ctx.n).to(g.dtype)
        dx = (g - means[0][:, None, None] - xhat * means[1][:, None, None]) \
            * (invstd * weight)[:, None, None]
        return dx.to(ctx.in_dtype), dweight, dbias, None, None


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d (eps 1e-5) whose train() mode is Flax's BatchNorm.

    eval() is nn.BatchNorm2d on the running statistics. train() normalises
    with the batch's statistics and updates the running ones as Flax does:
    with the biased batch variance E[x²] - E[x]² (floored at 0), where
    nn.BatchNorm2d takes the unbiased one, and ra = 0.9 ra + 0.1 stat.

    With a sync_group (sync_batchnorm: the dp ranks of a mesh, each with a
    slice of the batch) the statistics are those of the global batch, as
    the JAX package's jit over a dp-sharded batch computes them
    (_SyncBatchNorm, SyncBatchNorm's scheme in Flax's biased form). One
    process keeps torch's own kernel (F.batch_norm), unchanged: a hand
    formula there moved EFT's float32 three-step loss, which is chaotic at
    B=1, by up to 3.7e-4 between the card and the CPU, past the 1e-4 at which
    chip_smoke.py holds the two. In float64 the two paths agree to
    rounding (tests/test_torch_port_parallel_train.py, bn_control).
    """

    sync_group = None

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5)

    def _update_running(self, mean, var):
        with torch.no_grad():
            for buf, stat in ((self.running_mean, mean),
                              (self.running_var, var)):
                buf.copy_(BN_MOMENTUM * buf + (1.0 - BN_MOMENTUM) * stat)

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if self.sync_group is not None:
            y, mean, var = _SyncBatchNorm.apply(
                x, self.weight, self.bias, self.eps, self.sync_group)
            self._update_running(mean, var)
            return y
        with torch.no_grad():
            # in float32 at least (a bfloat16 input), as Flax's BatchNorm
            xf = x.detach().to(torch.promote_types(x.dtype, torch.float32))
            mean = xf.mean(dim=(0, 2, 3))
            var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp(min=0)
        self._update_running(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias,
                            training=True, eps=self.eps)


def sync_batchnorm(model: nn.Module, group) -> nn.Module:
    """Let every BatchNorm2d of model take its train-mode statistics over
    the process group `group` (None: its own batch)."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.sync_group = group
    return model


def draw_dropout_masks(B: int, generator=None, device=None):
    """The IEF head's dropout keep-masks for one forward: N_ITER pairs (after
    fc1, after fc2) of (B, HEAD_WIDTH) bool, each kept with probability
    1 - DROPOUT_RATE, drawn from `generator` (a torch.Generator on
    `device`; None takes the default one)."""
    keep = 1.0 - DROPOUT_RATE
    return [tuple(torch.empty(B, HEAD_WIDTH, device=device).bernoulli_(
        keep, generator=generator).bool() for _ in range(2))
        for _ in range(N_ITER)]


def _dropout(x, keep):
    """Flax's Dropout on a keep-mask: kept values x / (1 - rate), exact at
    rate 0.5."""
    return torch.where(keep, x / (1.0 - DROPOUT_RATE), torch.zeros_like(x))


def _norm(planes: int, bn_fold: bool) -> nn.Module:
    """BatchNorm, or nothing in the folded form (its affine is in the conv
    before it)."""
    return nn.Identity() if bn_fold else BatchNorm2d(planes)


class Bottleneck(nn.Module):
    """ResNet v1.5 bottleneck (1x1 -> 3x3 with the stride -> 1x1, x4).
    bn_fold: the folded form, biased convs and no BatchNorm."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, bn_fold: bool = False):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, bias=bn_fold)
        self.bn1 = _norm(planes, bn_fold)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1,
                            bias=bn_fold)
        self.bn2 = _norm(planes, bn_fold)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=bn_fold)
        self.bn3 = _norm(planes * 4, bn_fold)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = nn.Sequential(
            Conv2d(inplanes, planes * 4, 1, stride=stride, bias=bn_fold),
            _norm(planes * 4, bn_fold)) if downsample else None

    def forward(self, x):
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return self.relu(out + identity)


def _resnet_layer(inplanes: int, planes: int, blocks: int, stride: int,
                  bn_fold: bool):
    layers = [Bottleneck(inplanes, planes, stride, downsample=True,
                         bn_fold=bn_fold)]
    layers += [Bottleneck(planes * 4, planes, bn_fold=bn_fold)
               for _ in range(blocks - 1)]
    return nn.Sequential(*layers)


class HMR(nn.Module):
    """Iterative SMPL regressor.

    forward(images (B, H, W, 3)) -> (rotmat (B, 24, 3, 3), betas (B, 10),
    cam (B, 3)), all float32 whatever the compute dtype. The IEF loop
    starts from the mean parameters.
    """

    def __init__(self, mean_pose6d, mean_shape, mean_cam,
                 backbone: str = 'resnet50',
                 dtype: torch.dtype = torch.float32,
                 stem_s2d: bool = False, bn_fold: bool = False):
        super().__init__()
        self.backbone_name = backbone
        self.dtype = dtype
        self.stem_s2d, self.bn_fold = stem_s2d, bn_fold
        if backbone == 'resnet50':
            # the reference's top-level module names, so its keys load as-is
            self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3,
                                bias=bn_fold)
            self.bn1 = _norm(64, bn_fold)
            self.relu = nn.ReLU(inplace=True)
            self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
            inplanes = 64
            for i, (blocks, planes) in enumerate(
                    zip(RESNET50_STAGES, (64, 128, 256, 512)), start=1):
                setattr(self, f'layer{i}', _resnet_layer(
                    inplanes, planes, blocks, 1 if i == 1 else 2, bn_fold))
                inplanes = planes * 4
            nfeat = inplanes
        elif backbone in vit_mod.VIT_CONFIGS:
            if stem_s2d or bn_fold:
                raise ValueError(
                    'stem_s2d and bn_fold are ResNet-50 transforms '
                    f'(backbone {backbone!r} has no 7x7 stem and no '
                    'BatchNorm)')
            self.backbone = vit_mod.create_vit(backbone, dtype=dtype)
            nfeat = self.backbone.width
        else:
            raise ValueError(
                f'unknown backbone {backbone!r}; have resnet50, '
                f'{sorted(vit_mod.VIT_CONFIGS)}, '
                f'{sorted(hmr2_mod.HMR2_CONFIGS)}')
        self.fc1 = nn.Linear(nfeat + NPOSE + 13, HEAD_WIDTH)
        self.fc2 = nn.Linear(HEAD_WIDTH, HEAD_WIDTH)
        self.decpose = nn.Linear(HEAD_WIDTH, NPOSE)
        self.decshape = nn.Linear(HEAD_WIDTH, 10)
        self.deccam = nn.Linear(HEAD_WIDTH, 3)
        for name, value in (('init_pose', mean_pose6d),
                            ('init_shape', mean_shape),
                            ('init_cam', mean_cam)):
            self.register_buffer(name, torch.as_tensor(
                np.asarray(value, np.float32).reshape(1, -1)),
                persistent=False)

    def features(self, images):
        """Pooled backbone features (B, width), float32."""
        images = images.to(self.dtype)
        if self.backbone_name != 'resnet50':
            return self.backbone(images)
        x = images.permute(0, 3, 1, 2)
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for i in range(1, 5):
            x = getattr(self, f'layer{i}')(x)
        return x.mean(dim=(2, 3)).float()  # == AvgPool2d(7) at 224

    def forward(self, images, dropout=None):
        """dropout, read in train() only: the head's keep-masks
        (draw_dropout_masks' layout; None draws them from torch's default
        generator). eval() has no dropout."""
        if self.bn_fold and self.training:
            raise ValueError('bn_fold is an inference-only transform: a '
                             'folded model has no BatchNorm statistics to '
                             'update; call eval()')
        xf = self.features(images)
        B = xf.shape[0]
        masks = None
        if self.training:
            masks = (draw_dropout_masks(B, device=xf.device)
                     if dropout is None else dropout)
        pose = self.init_pose.expand(B, -1)
        shape = self.init_shape.expand(B, -1)
        cam = self.init_cam.expand(B, -1)
        for i in range(N_ITER):
            # linear -> dropout -> linear -> dropout, no activation, as in
            # the reference regressor head
            xc = self.fc1(torch.cat([xf, pose, shape, cam], dim=1))
            if masks is not None:
                xc = _dropout(xc, masks[i][0])
            xc = self.fc2(xc)
            if masks is not None:
                xc = _dropout(xc, masks[i][1])
            pose = self.decpose(xc) + pose
            shape = self.decshape(xc) + shape
            cam = self.deccam(xc) + cam
        return rot6d_to_rotmat(pose).reshape(B, 24, 3, 3), shape, cam

    def mask_buffer(self, B: int, device):
        """A static buffer of one train-mode forward's keep-masks for B
        images, all kept (HMRGraphs)."""
        return torch.ones(2 * N_ITER, B, HEAD_WIDTH, dtype=torch.bool,
                          device=device)

    @staticmethod
    def masks_in(buf):
        """The forward's `dropout` argument read from mask_buffer's
        buffer."""
        return [(buf[2 * i], buf[2 * i + 1]) for i in range(N_ITER)]

    @staticmethod
    def load_masks(buf, masks):
        """Copy draw_dropout_masks' masks into mask_buffer's buffer."""
        torch.stack([m for pair in masks for m in pair], out=buf)


def graph_engages(model: HMR, device) -> bool:
    """Whether HMRGraphs replays model's step as CUDA graphs for an image
    on `device`: a CUDA device, model in train(), and no BatchNorm2d of it
    with a sync_group."""
    return (torch.device(device).type == 'cuda' and model.training
            and not any(isinstance(m, BatchNorm2d)
                        and m.sync_group is not None
                        for m in model.modules()))


class _Replay(torch.autograd.Function):
    """One forward replay of a _GraphedStep, as an autograd node on the
    parameters whose backward is one backward replay."""

    @staticmethod
    def forward(ctx, step, *params):
        ctx.step = step
        step.fwd.replay()
        attention.count_replay(step.mha[0])
        return tuple(o.detach() for o in step.outs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        step = ctx.step
        for buf, g in zip(step.grad_outs, grads):
            buf.copy_(g)
        step.bwd.replay()
        attention.count_replay(step.mha[1])
        return (None,) + tuple(g.detach() for g in step.grads)


class _GraphedStep:
    """The forward and backward graphs of one image shape and precision,
    over static buffers: the image, the keep-masks (in the model's layout),
    the outputs, their gradients and the parameters' gradients. mha: the
    kernel-1 launches each graph's capture recorded, counted again at each
    replay."""

    WARMUP = 3

    def __init__(self, model, images):
        self.images = images.clone()
        self.keep = model.mask_buffer(images.shape[0], images.device)
        self.load_masks = model.load_masks
        self.params = tuple(model.parameters())
        with torch.cuda.device(images.device):
            self._capture(model)

    def _capture(self, model):
        masks = model.masks_in(self.keep)
        # the warm-up and capture passes run the train-mode forward, which
        # moves the running statistics: they are put back afterwards
        stats = [(b, b.clone()) for b in model.buffers()]
        # warm-up on a side stream, so that lazy set-up (workspaces, kernel
        # builds) happens before the capture
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(self.WARMUP):
                outs = model(self.images, dropout=masks)
                torch.autograd.grad(outs, self.params,
                                    [torch.zeros_like(o) for o in outs])
        # the warm-up's graph goes before the capture, so that the
        # capture's gradient accumulators are made on its own stream
        del outs
        torch.cuda.current_stream().wait_stream(side)
        self.fwd, self.bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        c0 = attention.mha_cuda.captured
        with torch.cuda.graph(self.fwd):
            outs = model(self.images, dropout=masks)
        c1 = attention.mha_cuda.captured
        self.grad_outs = tuple(torch.zeros_like(o) for o in outs)
        with torch.cuda.graph(self.bwd, pool=self.fwd.pool()):
            self.grads = torch.autograd.grad(outs, self.params,
                                             self.grad_outs)
        self.mha = (c1 - c0, attention.mha_cuda.captured - c1)
        # kept detached: the capture's autograd graph goes, and with it its
        # gradient accumulators, so that the replays' are made on the
        # stream that replays
        self.outs = tuple(o.detach() for o in outs)
        with torch.no_grad():
            for b, saved in stats:
                b.copy_(saved)

    def __call__(self, masks):
        self.load_masks(self.keep, masks)
        with torch.cuda.device(self.images.device):
            return _Replay.apply(self, *self.params)


class HMRGraphs:
    """HMR's train-mode step as CUDA graphs, one forward and one backward
    graph per image shape, dtype, device and TF32 setting (cuDNN's and
    the matmuls'), captured on first use.

    bind(images) -> None where graph_engages(model, images.device) is
    False: the caller runs model(images, dropout=masks) as ever. Else it
    copies images into the static image buffer of their graphs (capturing
    them first if new) and returns step(masks) -> (rotmat, betas, cam),
    the forward of model(images, dropout=masks) for the model's masks
    (HMR: draw_dropout_masks'; HMR2: its drop-path masks): a copy of the
    masks into their static buffer and one replay.
    The backward of those outputs is one replay too, and gives the
    gradients of model's parameters (torch.autograd.grad(loss,
    parameters) as eagerly). Each forward must be followed by its
    backward before the next forward.

    The outputs and the parameters' gradients are static buffers that the
    next replay overwrites: a caller keeps what it needs past that by
    copying it. The graphs read model's parameters and BatchNorm
    statistics where they are, so those may be changed in place only
    (load_state_dict, copy_); a step moves the running statistics as the
    eager one does. Capture runs the forward and backward a few times and
    leaves the statistics as it found them. Nothing inside draws random
    numbers: the masks come from the caller. Each replay adds the kernel-1
    launches its capture recorded to ops/attention.mha_cuda.launches.
    """

    def __init__(self, model):
        self.model = model
        self._steps = {}

    def bind(self, images):
        if not graph_engages(self.model, images.device):
            return None
        key = (tuple(images.shape), images.dtype, images.device,
               torch.backends.cudnn.allow_tf32,
               torch.backends.cuda.matmul.allow_tf32)
        step = self._steps.get(key)
        if step is None:
            step = self._steps[key] = _GraphedStep(self.model, images)
        else:
            step.images.copy_(images)
        return step


@torch.no_grad()
def store_compute_weights(model: HMR) -> HMR:
    """Store the backbone's Linear and convolution weights in the model's
    compute dtype, in place, so that no call casts them again: the serving
    predictor's bf16 copy, built once after its weights are loaded. The
    outputs are the same bits as casting per call. BatchNorm and LayerNorm
    parameters, BatchNorm statistics and the IEF head stay float32; a
    float32 model is left as it is."""
    if model.dtype != torch.float32:
        for mod in model.modules():
            if isinstance(mod, (Conv2d, vit_mod.Linear)):
                mod.to(model.dtype)
    return model


def create_hmr(mean_pose6d, mean_shape, mean_cam,
               backbone: str = 'resnet50',
               dtype: torch.dtype = torch.float32, stem_s2d: bool = False,
               bn_fold: bool = False, img_res=None):
    """HMR, or HMR 2.0 for a name of hmr2.HMR2_CONFIGS (built for
    img_res crops, None its published 256; stem_s2d and bn_fold are
    ResNet-50's and raise there). HMR takes any image size and ignores
    img_res."""
    if backbone in hmr2_mod.HMR2_CONFIGS:
        if stem_s2d or bn_fold:
            raise ValueError('stem_s2d and bn_fold are ResNet-50 '
                             f'transforms; {backbone!r} has neither a 7x7 '
                             'stem nor BatchNorm')
        return hmr2_mod.HMR2(mean_pose6d, mean_shape, mean_cam,
                             backbone=backbone, dtype=dtype,
                             img_res=img_res)
    return HMR(mean_pose6d, mean_shape, mean_cam, backbone=backbone,
               dtype=dtype, stem_s2d=stem_s2d, bn_fold=bn_fold)


def _conv_bn_pairs(state_dict):
    """(conv, the BatchNorm after it) module names of a ResNet-50 HMR."""
    pairs = [('conv1', 'bn1')]
    for key in state_dict:
        head, _, leaf = key.rpartition('.')
        if head.startswith('layer') and leaf == 'running_var':
            parent, _, bn = head.rpartition('.')
            conv = f'{parent}.0' if bn == '1' and parent.endswith(
                'downsample') else f'{parent}.conv{bn[2:]}'
            pairs.append((conv, head))
    return pairs


@torch.no_grad()
def fold_batchnorm(state_dict, eps: float = 1e-5):
    """A ResNet-50 HMR's state dict with its eval-mode BatchNorm folded
    into the convolution before each one, for HMR(bn_fold=True): as
    tuch_tpu/models/hmr.py fold_batchnorm, in float32,

        weight' = weight * g / sqrt(var + eps)
        bias'   = beta - mean * g / sqrt(var + eps)

    and no BatchNorm entry remains. The running variance is Flax's biased
    one (BatchNorm2d), folded as it is. Raises for a state dict without
    BatchNorm statistics (a ViT)."""
    if 'bn1.running_var' not in state_dict:
        raise ValueError('fold_batchnorm needs the BatchNorm statistics of '
                         'a ResNet-50 HMR; this state dict has none (a ViT '
                         'backbone?): --bn_fold is a ResNet-50 transform')
    out = dict(state_dict)
    for conv, bn in _conv_bn_pairs(state_dict):
        # sqrt in float64, then rounded: the correctly rounded float32 root
        # (torch's float32 sqrt on the CPU is not always, and the bias's
        # cancellation magnifies an ulp)
        root = torch.sqrt(
            (out.pop(f'{bn}.running_var') + eps).double()).float()
        s = out.pop(f'{bn}.weight') / root
        mean = out.pop(f'{bn}.running_mean')
        out.pop(f'{bn}.num_batches_tracked', None)
        out[f'{conv}.weight'] = out[f'{conv}.weight'] * s[:, None, None,
                                                          None]
        out[f'{conv}.bias'] = out.pop(f'{bn}.bias') - mean * s
    return out


def folded(model: HMR) -> HMR:
    """A new eval-mode HMR(bn_fold=True) holding model's weights with its
    BatchNorm folded (fold_batchnorm), on model's device, with its dtype,
    stem and IEF start."""
    state = fold_batchnorm(model.state_dict())
    new = HMR(*(b.cpu() for b in (model.init_pose, model.init_shape,
                                  model.init_cam)),
              backbone=model.backbone_name, dtype=model.dtype,
              stem_s2d=model.stem_s2d, bn_fold=True)
    new.load_state_dict(state)
    return new.to(model.init_pose.device).eval()


@torch.no_grad()
def init_weights(model, seed: int = 0):
    """Random weights from a seeded torch.Generator, drawn on the CPU so a
    seed gives the same model on every device.

    The JAX package's initialisers: LeCun normal for convs and Linears,
    Xavier uniform with gain 0.01 for the dec* Linears, zero biases, unit
    BatchNorm and LayerNorm scales, BatchNorm statistics (0, 1). HMR 2.0's
    learned position embeddings (POSITION_PARAMS) are normal with std
    0.02, as ViTPose's.
    """
    gen = torch.Generator().manual_seed(seed)
    for name, mod in model.named_modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            w = mod.weight
            fan_out, fan_in = w.shape[0], w[0].numel()
            if name.rpartition('.')[2].startswith('dec'):
                bound = 0.01 * math.sqrt(6.0 / (fan_in + fan_out))
                new = (torch.rand(w.shape, generator=gen) * 2 - 1) * bound
            else:
                new = torch.randn(w.shape, generator=gen) / math.sqrt(fan_in)
            w.copy_(new)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.BatchNorm2d, nn.LayerNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            if isinstance(mod, nn.BatchNorm2d):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
    for name, p in model.named_parameters():
        if name.rpartition('.')[2] in POSITION_PARAMS:
            p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    return model
