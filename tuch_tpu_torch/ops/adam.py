"""Adam's update of many tensors at once: the optimizer, its plain
version and its kernel.

Adam is optax's adam(lr, b1, b2, eps) stepped in place, with optax's
float32 bias corrections c1 = 1 - b1^n and c2 = 1 - b2^n at step n.
adam_plain is the update in torch._foreach_* operations (15 passes over
the tensors), with the roundings of optax's expression written leaf by
leaf:

    m' = (1 - b1) g + b1 m,  v' = (1 - b2) (g g) + b2 v,
    p' = p + (-lr) ((m' / c1) / (sqrt(v' / c2) + eps)).

adam_cuda launches csrc/adam.cu (see its header for the design), which
reads p, g, m and v once and writes p', m' and v' once, in place, and
equals adam_plain on the card bit for bit. It takes every tensor of a
step in len(chunk_plan(...)) launches: each launch a run of up to
MAX_LEAVES tensors, cut into CHUNK-element chunks, one block each. It
counts .launches (the launches that ran) and .floats (the elements
updated).
"""

import array
import ctypes
import functools
from itertools import chain
from operator import attrgetter
from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch

from tuch_tpu_torch.ops import _build

CHUNK = 16384                 # csrc/adam.cu: elements a block
PARAM_BYTES = 4096            # a kernel's parameter space
SCALARS_BYTES = 64            # csrc/adam.cu: Scalars<double>
# tensors a launch takes (csrc/adam.cu LEAVES, which static_asserts it):
# four pointers, a length and a chunk start each, in the parameter space
# beside the scalars, one more start and the count
MAX_LEAVES = (PARAM_BYTES - SCALARS_BYTES - 8) // (4 * 8 + 12)
DTYPES = (torch.float32, torch.float64)

_ARGS = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_void_p]


class Launch(NamedTuple):
    leaves: tuple     # indices into the step's tensors, in order
    chunks: tuple     # CHUNK-element chunks of each: one block a chunk


def chunk_plan(sizes: Sequence[int]) -> List[Launch]:
    """The launches of one step over tensors of `sizes` elements: the
    tensors in order, empty ones left out, up to MAX_LEAVES a launch,
    each cut into ceil(n / CHUNK) chunks."""
    plan, leaves, chunks = [], [], []
    for i, n in enumerate(sizes):
        if n == 0:
            continue
        leaves.append(i)
        chunks.append(-(-n // CHUNK))
        if len(leaves) == MAX_LEAVES:
            plan.append(Launch(tuple(leaves), tuple(chunks)))
            leaves, chunks = [], []
    if leaves:
        plan.append(Launch(tuple(leaves), tuple(chunks)))
    return plan


def adam_scalars(dtype, lr, b1, b2, eps, c1, c2):
    """(1 - b1, b1, 1 - b2, b2, r1, r2, eps, -lr) in the tensors' type, as
    adam_plain's operations round them on the card: each Python number
    cast to float32 for float32 tensors, and r1, r2 the reciprocals of c1
    and c2 that _div_scalar multiplies by (float32, or float64 for float64
    tensors)."""
    if dtype == torch.float64:
        return (1 - b1, b1, 1 - b2, b2, 1.0 / float(c1), 1.0 / float(c2),
                eps, -lr)
    f = np.float32
    return tuple(float(x) for x in (f(1 - b1), f(b1), f(1 - b2), f(b2),
                                    f(1) / f(c1), f(1) / f(c2), f(eps),
                                    f(-lr)))


def _div_scalar(tensors, c):
    """[t / c for t in tensors] (c a float32 number) as eager division by
    a Python number rounds on the tensors' device: CUDA multiplies by the
    reciprocal in the tensors' compute precision (float32 but for
    float64), the CPU divides."""
    if tensors and tensors[0].is_cuda:
        inv = (1.0 / float(c) if tensors[0].dtype == torch.float64
               else float(np.float32(1) / c))
        return torch._foreach_mul(tensors, inv)
    return torch._foreach_div(tensors, float(c))


def adam_plain(params, grads, mu, nu, *, lr, b1, b2, eps, c1, c2):
    """Plain version: new lists (p', m', v') from lists of tensors, every
    leaf at once through torch._foreach_*."""
    m = torch._foreach_mul(grads, 1 - b1)
    torch._foreach_add_(m, torch._foreach_mul(mu, b1))
    v = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(v, 1 - b2)
    torch._foreach_add_(v, torch._foreach_mul(nu, b2))
    den = _div_scalar(v, c2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    upd = _div_scalar(m, c1)
    torch._foreach_div_(upd, den)
    del den
    torch._foreach_mul_(upd, -lr)
    return torch._foreach_add(params, upd), m, v


_dtype = attrgetter('dtype')


def _check(groups, what):
    """Refuse what the kernel does not take: every tensor float32 or
    float64 alike, contiguous, on one CUDA device, the lists of one length
    and each tensor of its parameter's size. Returns the sizes. Each
    property is read over a whole list by map: this runs every step, over
    every tensor, on the host's way to the launch."""
    first = groups[0][0]
    dtype, dev = first.dtype, first.get_device()
    if dtype not in DTYPES:
        raise ValueError(f'{what} takes float32 or float64 tensors, got '
                         f'{dtype}')
    if dev < 0:
        raise ValueError(f'{what} needs CUDA tensors, got {first.device}')
    sizes = list(map(torch.Tensor.numel, groups[0]))
    flat = [t for ts in groups for t in ts]
    same = all(list(map(torch.Tensor.numel, ts)) == sizes for ts in groups)
    if not same or set(map(_dtype, flat)) != {dtype} \
            or set(map(torch.Tensor.get_device, flat)) != {dev} \
            or not all(map(torch.Tensor.is_contiguous, flat)):
        bad = [f'{t.dtype} {tuple(t.shape)} on {t.device} (contiguous '
               f'{t.is_contiguous()})' for t in flat
               if t.dtype != dtype or t.get_device() != dev
               or not t.is_contiguous()]
        raise ValueError(f'{what} takes lists of {len(sizes)} contiguous '
                         f'{dtype} tensors on {first.device}, each of its '
                         f'parameter\'s size; got lists of '
                         f'{[len(ts) for ts in groups]} tensors (sizes '
                         f'{"" if same else "un"}equal), {bad[:3]}')
    return sizes


class _Plan(NamedTuple):
    launches: int
    floats: int       # elements a step
    counts: object    # ctypes int array: tensors a launch
    order: object     # the planned tensors' indices, launch after launch;
                      # None where that is every tensor in order
    n: object         # ctypes long long array: their elements
    chunks: object    # ctypes int array: their chunks


@functools.lru_cache(maxsize=None)
def _plan(sizes: tuple) -> _Plan:
    launches = chunk_plan(sizes)
    order = tuple(i for lc in launches for i in lc.leaves)
    chunks = [c for lc in launches for c in lc.chunks]
    return _Plan(len(launches), sum(sizes),
                 (ctypes.c_int * len(launches))(*(len(lc.leaves)
                                                  for lc in launches)),
                 None if len(order) == len(sizes) else order,
                 (ctypes.c_longlong * len(order))(*(sizes[i]
                                                    for i in order)),
                 (ctypes.c_int * len(order))(*chunks))


def adam_cuda(params, grads, mu, nu, *, lr, b1, b2, eps, c1, c2):
    """One Adam step over lists of CUDA tensors with the kernel, in place:
    p', m' and v' into params, mu and nu, whose autograd versions it then
    raises, as an in-place operation of PyTorch's would. Gradients that
    are not contiguous are copied first (each a copy kernel: 17 of
    ResNet-50's are channels-last). Returns (params, mu, nu). Raises on
    what the kernel does not take (_check); never falls back."""
    if not params:
        return params, mu, nu
    grads = [g if g.is_contiguous() else g.contiguous() for g in grads]
    groups = [params, grads, mu, nu]
    sizes = _check(groups, 'adam_cuda')
    plan = _plan(tuple(sizes))
    if plan.launches:
        rows = [list(map(torch.Tensor.data_ptr, ts)) for ts in groups]
        if plan.order is not None:
            rows = [[r[i] for i in plan.order] for r in rows]
        # each planned tensor's four pointers in a row
        ptrs = array.array('Q', chain.from_iterable(zip(*rows)))
        sc = (ctypes.c_double * 8)(*adam_scalars(
            params[0].dtype, lr, b1, b2, eps, c1, c2))
        lib, fn = _build.entry('adam', 'tuch_adam', _ARGS)
        dev = params[0].device
        with torch.cuda.device(dev):
            err = fn(params[0].element_size(), plan.launches, plan.counts,
                     ptrs.buffer_info()[0], plan.n, plan.chunks, sc,
                     torch._C._cuda_getCurrentRawStream(dev.index))
        _build.check(lib, err, 'adam kernel launch')
        torch.autograd.graph.increment_version([*params, *mu, *nu])
        adam_cuda.launches += plan.launches
        adam_cuda.floats += plan.floats
    return params, mu, nu


adam_cuda.launches = adam_cuda.floats = 0


def contiguous_clones(params: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """A start for Adam to step: each tensor cloned, contiguous (kernel 8
    takes no other), so that the steps write neither the caller's tensors
    nor any that a loss reads as a constant."""
    return {k: v.clone(memory_format=torch.contiguous_format)
            for k, v in params.items()}


class Adam:
    """optax.adam(lr, b1, b2, eps) on a dict of tensors, in place.

    step writes the new parameters into the given parameters' tensors and
    the new moments into the moments' tensors, and raises their autograd
    versions: the caller owns the parameters' storage (contiguous_clones
    gives a start of its own). Every leaf at once: on the card through one
    pass of kernel 8 (adam_cuda), on the CPU through adam_plain and a copy
    back, with the per-leaf expression's roundings, bit for bit, for
    float32 and float64 leaves (the parameters are float32: a bfloat16 HMR
    casts per call)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params, grads):
        """One step written into params' tensors; returns params."""
        self.count += 1
        # the bias corrections in float32, as optax computes them
        n = np.float32(self.count)
        hyper = dict(lr=self.lr, b1=self.b1, b2=self.b2, eps=self.eps,
                     c1=1 - np.float32(self.b1) ** n,
                     c2=1 - np.float32(self.b2) ** n)
        keys = list(params)
        p, g, m, v = [[d[k] for k in keys] for d in (params, grads, self.mu,
                                                      self.nu)]
        if keys and p[0].is_cuda:
            adam_cuda(p, g, m, v, **hyper)
        elif keys:
            for old, new in zip((p, m, v), adam_plain(p, g, m, v, **hyper)):
                torch._foreach_copy_(old, new)
        return params
