"""HMR: a ResNet-50 backbone plus the iterative SMPL regressor.

A frozen copy of tuch_tpu_torch/models/hmr.py, cut to the ResNet-50 path
the fitting cell runs (no ViT, no folded BatchNorm, no cross-rank
statistics). The state-dict keys are the reference's (SPIN/TUCH:
conv1.weight, layer1.0.conv1.weight, bn1.running_mean, fc1.weight,
decpose.weight, ...); the graph follows torch_ref.py: stride on the 3x3
conv, BatchNorm eps 1e-5 with running statistics, global mean pooling, and
the 3-iteration IEF head with no activation.

train() is the JAX package's HMR(train=True): BatchNorm on the batch's
statistics with Flax's update of the running ones (BatchNorm2d), and the
head's two dropouts at rate 0.5 in every IEF iteration, on keep-masks the
caller passes (draw_dropout_masks draws them from a torch.Generator).

Images come in NHWC; the ResNet permutes to NCHW. Compute dtype
(``dtype``, float32 or bfloat16): the image is cast to it, and the backbone
runs in it; its features are cast to float32 and the IEF head runs in
float32. Parameters and BatchNorm statistics stay float32.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.tuchref.utils.rotations import rot6d_to_rotmat

NPOSE = 24 * 6
N_ITER = 3  # IEF refinement steps
RESNET50_STAGES = (3, 4, 6, 3)
HEAD_WIDTH = 1024
DROPOUT_RATE = 0.5
# Flax's BatchNorm(momentum=0.9): ra = 0.9 ra + 0.1 batch statistic
BN_MOMENTUM = 0.9


class Conv2d(nn.Conv2d):
    """nn.Conv2d in the input's dtype, on float32 weights cast per call (a
    no-op for a float32 input)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d (eps 1e-5) whose train() mode is Flax's BatchNorm.

    eval() is nn.BatchNorm2d on the running statistics. train() normalises
    with the batch's statistics and updates the running ones as Flax does:
    with the biased batch variance E[x²] - E[x]² (floored at 0), where
    nn.BatchNorm2d takes the unbiased one, and ra = 0.9 ra + 0.1 stat.
    The normalisation itself is torch's own kernel (F.batch_norm).
    """

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
        with torch.no_grad():
            # in float32 at least (a bfloat16 input), as Flax's BatchNorm
            xf = x.detach().to(torch.promote_types(x.dtype, torch.float32))
            mean = xf.mean(dim=(0, 2, 3))
            var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp(min=0)
        self._update_running(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias,
                            training=True, eps=self.eps)


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


class Bottleneck(nn.Module):
    """ResNet v1.5 bottleneck (1x1 -> 3x3 with the stride -> 1x1, x4)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1,
                            bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = nn.Sequential(
            Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
            BatchNorm2d(planes * 4)) if downsample else None

    def forward(self, x):
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return self.relu(out + identity)


def _resnet_layer(inplanes: int, planes: int, blocks: int, stride: int):
    layers = [Bottleneck(inplanes, planes, stride, downsample=True)]
    layers += [Bottleneck(planes * 4, planes) for _ in range(blocks - 1)]
    return nn.Sequential(*layers)


class HMR(nn.Module):
    """Iterative SMPL regressor.

    forward(images (B, H, W, 3)) -> (rotmat (B, 24, 3, 3), betas (B, 10),
    cam (B, 3)), all float32 whatever the compute dtype. The IEF loop
    starts from the mean parameters.
    """

    def __init__(self, mean_pose6d, mean_shape, mean_cam,
                 backbone: str = 'resnet50',
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if backbone != 'resnet50':
            raise ValueError(f'unknown backbone {backbone!r}; the plain '
                             f'reference has resnet50')
        self.dtype = dtype
        # the reference's top-level module names, so its keys load as-is
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes = 64
        for i, (blocks, planes) in enumerate(
                zip(RESNET50_STAGES, (64, 128, 256, 512)), start=1):
            setattr(self, f'layer{i}', _resnet_layer(
                inplanes, planes, blocks, 1 if i == 1 else 2))
            inplanes = planes * 4
        nfeat = inplanes
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
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for i in range(1, 5):
            x = getattr(self, f'layer{i}')(x)
        return x.mean(dim=(2, 3)).float()  # == AvgPool2d(7) at 224

    def forward(self, images, dropout=None):
        """dropout, read in train() only: the head's keep-masks
        (draw_dropout_masks' layout; None draws them from torch's default
        generator). eval() has no dropout."""
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


def create_hmr(mean_pose6d, mean_shape, mean_cam,
               backbone: str = 'resnet50',
               dtype: torch.dtype = torch.float32) -> HMR:
    return HMR(mean_pose6d, mean_shape, mean_cam, backbone=backbone,
               dtype=dtype)


@torch.no_grad()
def init_weights(model: HMR, seed: int = 0) -> HMR:
    """Random weights from a seeded torch.Generator, drawn on the CPU so a
    seed gives the same model on every device.

    The JAX package's initialisers: LeCun normal for convs and Linears,
    Xavier uniform with gain 0.01 for the dec* Linears, zero biases, unit
    BatchNorm scales, BatchNorm statistics (0, 1).
    """
    gen = torch.Generator().manual_seed(seed)
    for name, mod in model.named_modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            w = mod.weight
            fan_out, fan_in = w.shape[0], w[0].numel()
            if name.startswith('dec'):
                bound = 0.01 * math.sqrt(6.0 / (fan_in + fan_out))
                new = (torch.rand(w.shape, generator=gen) * 2 - 1) * bound
            else:
                new = torch.randn(w.shape, generator=gen) / math.sqrt(fan_in)
            w.copy_(new)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.BatchNorm2d):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
    return model
