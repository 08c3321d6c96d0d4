"""Reference HMR semantics executed with functional torch ops.

Counterpart of tuch_tpu/models/torch_ref.py (copied: it already is torch
and numpy). The reference network is the stock SPIN ResNet-50 + IEF head
(the reference's tuch/models/hmr.py, itself from nkolot/SPIN). This module
re-executes that exact graph with functional torch calls straight from a
state dict -- no torchvision / module classes needed -- so a checkpoint
can be parity-checked against this package's HMR (cli/parity.py).

Semantics covered: conv padding/stride layout, BatchNorm eps=1e-5 with
running stats, maxpool, global average pool, the 3-iteration IEF loop with
mean-param init.
"""

import numpy as np


def torch_backbone_forward(sd, x):
    """ResNet-50 forward with functional ops, NCHW. sd: torch state dict."""
    import torch.nn.functional as F

    def conv(x, w, stride=1, pad=0):
        return F.conv2d(x, w, stride=stride, padding=pad)

    def bn(x, p):
        return F.batch_norm(x, sd[p + '.running_mean'],
                            sd[p + '.running_var'], sd[p + '.weight'],
                            sd[p + '.bias'], training=False, eps=1e-5)

    x = F.relu(bn(conv(x, sd['conv1.weight'], 2, 3), 'bn1'))
    x = F.max_pool2d(x, 3, 2, 1)
    for li, blocks in enumerate([3, 4, 6, 3], start=1):
        for b in range(blocks):
            pre = f'layer{li}.{b}'
            identity = x
            stride = 2 if (li > 1 and b == 0) else 1
            out = F.relu(bn(conv(x, sd[pre + '.conv1.weight']),
                            pre + '.bn1'))
            out = F.relu(bn(conv(out, sd[pre + '.conv2.weight'], stride,
                                 1), pre + '.bn2'))
            out = bn(conv(out, sd[pre + '.conv3.weight']), pre + '.bn3')
            if pre + '.downsample.0.weight' in sd:
                identity = bn(conv(x, sd[pre + '.downsample.0.weight'],
                                   stride), pre + '.downsample.1')
            x = F.relu(out + identity)
    return x.mean(dim=(2, 3))  # == AvgPool2d(7) for 224 inputs


def torch_ief_head(sd, xf, mean_pose, mean_shape, mean_cam, n_iter=3):
    """SPIN IEF head (hmr.py:137-158): 3 refinement iterations."""
    import torch
    import torch.nn.functional as F
    B = xf.shape[0]
    pose = mean_pose.expand(B, -1)
    shape = mean_shape.expand(B, -1)
    cam = mean_cam.expand(B, -1)
    for _ in range(n_iter):
        xc = torch.cat([xf, pose, shape, cam], dim=1)
        xc = F.linear(xc, sd['fc1.weight'], sd['fc1.bias'])
        xc = F.linear(xc, sd['fc2.weight'], sd['fc2.bias'])
        pose = F.linear(xc, sd['decpose.weight'], sd['decpose.bias']) + pose
        shape = F.linear(xc, sd['decshape.weight'],
                         sd['decshape.bias']) + shape
        cam = F.linear(xc, sd['deccam.weight'], sd['deccam.bias']) + cam
    return pose, shape, cam


def torch_hmr_forward(sd_np, images_nhwc, mean_pose6d, mean_shape,
                      mean_cam):
    """Full reference forward from a numpy state dict.

    images_nhwc: (B, H, W, 3) normalized. Returns numpy
    (pose6d (B, 144), betas (B, 10), cam (B, 3)).
    """
    import torch
    # copy: read-only numpy views would be undefined behaviour for
    # torch.from_numpy if ever written
    sd = {k: torch.from_numpy(np.ascontiguousarray(v).copy())
          for k, v in sd_np.items()}
    with torch.no_grad():
        x = torch.from_numpy(
            np.ascontiguousarray(images_nhwc.transpose(0, 3, 1, 2)))
        xf = torch_backbone_forward(sd, x)
        pose, shape, cam = torch_ief_head(
            sd, xf,
            torch.from_numpy(np.asarray(mean_pose6d, np.float32)[None]),
            torch.from_numpy(np.asarray(mean_shape, np.float32)[None]),
            torch.from_numpy(np.asarray(mean_cam, np.float32)[None]))
    return pose.numpy(), shape.numpy(), cam.numpy()
