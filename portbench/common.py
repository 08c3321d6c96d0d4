"""The yardstick's arithmetic: peaks, operation counts, spreads, seeded
weights and the reduction of a torch.profiler trace.

Nothing here imports the program (tuch_tpu_torch): the counts are written
from the published shapes, and the weights are made here and handed to the
program and to the plain reference alike.
"""

import math
import statistics
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Published dense peaks of one NVIDIA H100 SXM (data sheet, 700 W).
PEAK_FLOPS = {'float32': 67e12, 'tf32': 495e12, 'bfloat16': 989e12}

# operations a pair, as counted in the kernels' sources
WINDING_OPS_PER_PAIR = 67        # kernel 2: csrc/solid_angle.cuh
MASKED_OPS_ALLOWED = 9           # kernel 4: + 1 mask test per pair

RESNET50_STAGES = (3, 4, 6, 3)
RESNET50_PLANES = (64, 128, 256, 512)
HMR_HEAD_WIDTH = 1024
HMR_NPOSE = 24 * 6
HMR_IEF_ITERS = 3


def conv_flops(cin: int, cout: int, k: int, hout: int, wout: int) -> int:
    """Multiply-adds x2 of a dense convolution."""
    return 2 * cin * cout * k * k * hout * wout


def resnet50_fwd_flops(img_res: int = 224) -> int:
    """Forward FLOPs of one image through ResNet-50 v1.5 (convolutions only;
    BatchNorm, ReLU and pooling are vector work and left out): the 7x7/2
    stem, a 3x3/2 max pool, then the four stages of bottlenecks with the
    stride on the 3x3 convolution and a 1x1 projection in each stage's
    first block."""
    h = (img_res + 2 * 3 - 7) // 2 + 1            # stem
    total = conv_flops(3, 64, 7, h, h)
    h = (h + 2 - 3) // 2 + 1                        # max pool
    cin = 64
    for i, (blocks, planes) in enumerate(zip(RESNET50_STAGES,
                                             RESNET50_PLANES)):
        for b in range(blocks):
            stride = 2 if (i > 0 and b == 0) else 1
            hout = (h - 1) // stride + 1
            total += conv_flops(cin, planes, 1, h, h)
            total += conv_flops(planes, planes, 3, hout, hout)
            total += conv_flops(planes, 4 * planes, 1, hout, hout)
            if b == 0:
                total += conv_flops(cin, 4 * planes, 1, hout, hout)
            cin, h = 4 * planes, hout
    return total


def resnet50_stem_flops(img_res: int = 224) -> int:
    h = (img_res + 2 * 3 - 7) // 2 + 1
    return conv_flops(3, 64, 7, h, h)


def hmr_head_flops(feat: int) -> int:
    """One image's IEF head: HMR_IEF_ITERS x (fc1, fc2, the three
    decoders)."""
    per = (feat + HMR_NPOSE + 13) * HMR_HEAD_WIDTH \
        + HMR_HEAD_WIDTH * HMR_HEAD_WIDTH \
        + HMR_HEAD_WIDTH * (HMR_NPOSE + 10 + 3)
    return 2 * HMR_IEF_ITERS * per


def winding_ops(B: int, Q: int, F: int) -> int:
    """Kernel 2: every (query, triangle) pair of every body."""
    return WINDING_OPS_PER_PAIR * B * Q * F


def masked_min_ops(B: int, V: int, allowed: int) -> int:
    """Kernel 4: a mask test a pair, and a distance and compare for each
    allowed pair."""
    return B * (V * V + MASKED_OPS_ALLOWED * allowed)


def quartile_spread(values: Sequence[float]) -> float:
    """(Q3 - Q1) / median, Python's statistics.quantiles(n=4)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def leaf_norms(tensors):
    """{leaf: float64 norm} of a dict of tensors, computed on their device
    with one synchronisation."""
    import torch
    names = list(tensors)
    norms = torch.stack([torch.linalg.vector_norm(tensors[k].double())
                         for k in names])
    return dict(zip(names, norms.tolist()))


# ---------------------------------------------------------------------------
# Seeded weights, made on the device in a few large calls
# ---------------------------------------------------------------------------

def _leaf_std(name: str, shape: Tuple[int, ...]) -> Optional[float]:
    """The init of one parameter: He normal for convolutions and Linears,
    1e-2 of Xavier for the IEF decoders (the reference's gain); None for
    norm scales (1) and biases (0)."""
    if name.endswith('bias'):
        return None
    if len(shape) == 1:
        return None
    fan_in = math.prod(shape[1:])
    if name.split('.')[-2].startswith('dec'):
        return 0.01 * math.sqrt(2.0 / (fan_in + shape[0]))
    return math.sqrt(2.0 / fan_in)


def seeded_weights(shapes: Dict[str, Tuple[int, ...]], seed: int, device):
    """{name: float32 tensor} for each parameter, all drawn from one
    standard normal buffer of a torch.Generator seeded by `seed` on
    `device`, each leaf scaled to its init (_leaf_std); norm scales are 1
    and biases 0."""
    import torch
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        std = _leaf_std(name, shape)
        if std is not None:
            out[name] = flat[off:off + n].view(shape).mul_(std)
        elif name.endswith('bias'):
            out[name] = flat[off:off + n].view(shape).zero_()
        else:
            out[name] = flat[off:off + n].view(shape).fill_(1.0)
        off += n
    return out


def seeded_generator(seed: int, salt: int, device):
    """A torch.Generator on `device` for one stream of the run's inputs."""
    import torch
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1000003 + salt) % 2 ** 63)


def fold_pose6d(gen, scale: float, device):
    """(1, 144) 6D rotations of 24 random axis-angles of size `scale`, the
    IEF loop's start: a folding pose, so that the contact terms of the fit
    and of the loss have contacts to work on."""
    import torch
    aa = torch.randn(24, 3, generator=gen, device=device) * scale
    angle = aa.norm(dim=1, keepdim=True).clamp_min(1e-8)
    k = aa / angle
    kx, ky, kz = k.unbind(1)
    zero = torch.zeros_like(kx)
    K = torch.stack([zero, -kz, ky, kz, zero, -kx, -ky, kx, zero],
                    1).view(24, 3, 3)
    s, c = torch.sin(angle)[..., None], torch.cos(angle)[..., None]
    R = torch.eye(3, device=device) + s * K + (1 - c) * (K @ K)
    return R[:, :, :2].reshape(1, -1)


# ---------------------------------------------------------------------------
# Trace reduction
# ---------------------------------------------------------------------------

class Trace:
    """A torch.profiler capture reduced to what the readers need, from the
    profiler's raw events (no event tree is built).

    kernels: (name, start_us, end_us, span) of each device operation, span
    the innermost host span (a record_function name starting with one of
    `span_prefixes`) open when its launch call started; spans: (name,
    start_us, end_us) of those host spans; t0_us, t1_us: the traced
    window, the host span WINDOW_SPAN that the cell's module in drivers/
    opens around it.
    """

    WINDOW_SPAN = 'portbench.window'

    def __init__(self, prof, span_prefixes: Iterable[str]):
        from torch.autograd import DeviceType
        prefixes = tuple(span_prefixes) + (self.WINDOW_SPAN,)
        events = prof.profiler.kineto_results.events()
        self.spans: List[Tuple[str, float, float]] = []
        runtime, ops, device = {}, {}, []
        for e in events:
            name = e.name()
            if e.device_type() == DeviceType.CPU:
                if name.startswith(prefixes):
                    self.spans.append((name, e.start_ns() / 1e3,
                                       e.end_ns() / 1e3))
                elif name.startswith('cu'):
                    runtime[e.correlation_id()] = e.start_ns() / 1e3
                else:
                    ops[e.correlation_id()] = e.start_ns() / 1e3
            elif e.device_type() == DeviceType.CUDA and \
                    not name.startswith(prefixes):
                device.append(e)
        window = [s for s in self.spans if s[0] == self.WINDOW_SPAN]
        if len(window) != 1:
            raise RuntimeError(f'the trace holds {len(window)} '
                               f'{self.WINDOW_SPAN} spans, not one')
        self.spans = [s for s in self.spans if s[0] != self.WINDOW_SPAN]
        self.spans.sort(key=lambda s: s[1])
        _, self.t0_us, self.t1_us = window[0]
        launched = [runtime.get(e.correlation_id(),
                                ops.get(e.linked_correlation_id(), -1.0))
                    for e in device]
        names = self.spans_at(launched)
        self.kernels: List[Tuple[str, float, float, str]] = sorted(
            ((e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3, sp)
             for e, sp in zip(device, names)), key=lambda k: k[1])

    def spans_at(self, times: Sequence[float]) -> List[str]:
        """The innermost span open at each time ('' for none), by one
        sweep over the spans' starts and ends."""
        marks = [(s0, 1, i) for i, (_, s0, _) in enumerate(self.spans)]
        marks += [(s1, 0, i) for i, (_, _, s1) in enumerate(self.spans)]
        marks += [(t, 2, j) for j, t in enumerate(times)]
        marks.sort()
        out, open_ = [''] * len(times), []
        for _, kind, i in marks:
            if kind == 1:
                open_.append(i)
            elif kind == 0:
                open_.remove(i)
            elif open_:
                out[i] = self.spans[open_[-1]][0]
        return out

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (the union)."""
        busy, end = 0.0, -math.inf
        for _, s, e, _ in self.kernels:
            if e <= end:
                continue
            busy += e - max(s, end)
            end = e
        return busy / 1e6

    def window_s(self) -> float:
        return (self.t1_us - self.t0_us) / 1e6

    def device_s(self, pred) -> float:
        """Summed device seconds of the operations pred(name, span) keeps."""
        return sum(e - s for n, s, e, sp in self.kernels if pred(n, sp)) / 1e6

    def top_ops(self, k: int = 10):
        by = {}
        for n, s, e, _ in self.kernels:
            by[n[:120]] = by.get(n[:120], 0.0) + (e - s) / 1e6
        return sorted(by.items(), key=lambda kv: -kv[1])[:k]

    def idle_gaps(self, k: int = 10):
        """Device idle seconds inside the window, summed by the innermost
        host span open at each gap's midpoint ('no span' outside them)."""
        gaps, end = [], self.t0_us
        for _, s, e, _ in self.kernels + [('', self.t1_us, self.t1_us, '')]:
            if s > end:
                gaps.append((end, min(s, self.t1_us)))
            end = max(end, e)
        by = {}
        for (g0, g1), name in zip(gaps, self.spans_at(
                [(g0 + g1) / 2 for g0, g1 in gaps])):
            by[name or 'no span'] = by.get(name or 'no span', 0.0) \
                + (g1 - g0) / 1e6
        return sorted(by.items(), key=lambda kv: -kv[1])[:k]
