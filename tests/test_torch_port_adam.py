"""ops/adam: the in-place Adam, the plain foreach update, its kernel
(csrc/adam.cu) and the kernel's chunk plan.

On the CPU: the step against the per-leaf expression it replaced, bit for
bit (the parameters and both moments after each of four steps, in float32
and float64: the parameters' precisions, a bfloat16 HMR keeps float32
weights and casts them per call), written into the given parameters' and
its own moments' tensors, and the autograd versions it raises; the chunk
plan over HMR 2.0's and ResNet-50's leaves and edge sizes; the wrapper's
refusals. Marked cuda (skipped without a card): the kernel against the
plain foreach update on the card, bytes equal, at both models' leaves at
full size, on empty, odd and unaligned leaves, on gradients that a CUDA
graph rewrites in place, with its launch count. Eager division by a
Python number rounds differently on the two devices (the card multiplies
by the reciprocal), so both are held. This file imports no JAX:
``python -m pytest --noconftest tests/test_torch_port_adam.py`` on a card.
"""

import functools

import numpy as np
import pytest
import torch

from tuch_tpu_torch.ops import adam as OA
from tuch_tpu_torch.ops.adam import Adam

SHAPES = {'w': (64, 3, 7, 7), 'b': (64,), 'fc': (517, 129), 's': (3,),
          'empty': (0, 5)}
LR = 1e-5
HYPER = dict(lr=LR, b1=0.9, b2=0.999, eps=1e-8)
EDGE_SIZES = (0, 1, 3, 5, 4096, 16383, 16384, 16385, 0, 40007, 7)


def per_leaf_step(state, params, grads, lr, b1=0.9, b2=0.999, eps=1e-8):
    """The per-leaf step as written before the foreach one: a dozen eager
    operations for each leaf."""
    state['count'] += 1
    n = np.float32(state['count'])
    c1 = float(1 - np.float32(b1) ** n)
    c2 = float(1 - np.float32(b2) ** n)
    out = {}
    for k, p in params.items():
        g = grads[k]
        state['mu'][k] = (1 - b1) * g + b1 * state['mu'][k]
        state['nu'][k] = (1 - b2) * (g * g) + b2 * state['nu'][k]
        upd = (state['mu'][k] / c1) / (torch.sqrt(state['nu'][k] / c2) + eps)
        out[k] = p + (-lr) * upd
    return out


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.view(torch.uint8) if a.numel() else a,
                       b.view(torch.uint8) if b.numel() else b)


def _tree(shapes, gen, scale, device, dtype):
    """Leaves of magnitudes over many octaves, and exact zeros, so that the
    roundings of every operation are exercised; drawn on `gen`'s device."""
    out = {}
    for k, s in shapes.items():
        d = gen.device
        out[k] = (torch.randn(s, generator=gen, device=d)
                  * torch.exp2(torch.randint(-30, 4, s, generator=gen,
                                             device=d).float())
                  * (torch.rand(s, generator=gen, device=d) > 0.1) * scale
                  ).to(device=device, dtype=dtype)
    return out


@functools.lru_cache(maxsize=None)
def model_shapes(name):
    """{name: shape} of HMR 2.0's (ViTPose-H/16 and its decoder, 500
    tensors) or ResNet-50 and the IEF head's parameters, built on the meta
    device."""
    from tuch_tpu_torch.models import hmr as H
    from tuch_tpu_torch.models import hmr2 as H2
    means = (np.zeros(144), np.zeros(10), np.zeros(3))
    with torch.device('meta'):
        model = H2.HMR2(*means) if name == 'hmr2' else H.HMR(*means)
    return {k: tuple(p.shape) for k, p in model.named_parameters()}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


# ---------------------------------------------------------------------------
# The step on any host
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('device', [
    'cpu', pytest.param('cuda', marks=pytest.mark.cuda)])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_foreach_step_is_the_per_leaf_step_bit_for_bit(device, dtype):
    """The per-leaf expression, written in place: into the given
    parameters' tensors and the optimizer's own moments, the same tensors
    from step to step. On the card the step runs the kernel."""
    if device == 'cuda':
        _cuda()
    gen = torch.Generator().manual_seed(3)
    params = _tree(SHAPES, gen, 1.0, device, dtype)
    opt = Adam(params, LR)
    ref = dict(count=0, mu={k: torch.zeros_like(v) for k, v in params.items()},
               nu={k: torch.zeros_like(v) for k, v in params.items()})
    want = {k: v.clone() for k, v in params.items()}
    held, mu, nu = dict(params), dict(opt.mu), dict(opt.nu)
    for _ in range(4):
        grads = _tree(SHAPES, gen, 1e-2, device, dtype)
        out = opt.step(params, grads)
        want = per_leaf_step(ref, want, grads, LR)
        for k in SHAPES:
            assert out[k] is held[k] and params[k] is held[k]
            assert opt.mu[k] is mu[k] and opt.nu[k] is nu[k]
            _same(params[k], want[k])
            _same(opt.mu[k], ref['mu'][k])
            _same(opt.nu[k], ref['nu'][k])


@pytest.mark.parametrize('device', [
    'cpu', pytest.param('cuda', marks=pytest.mark.cuda)])
def test_step_in_place_raises_the_written_tensors_versions(device):
    """The step writes the parameters as an in-place operation does: a
    graph that saved them refuses its backward afterwards, rather than
    reading the new weights."""
    if device == 'cuda':
        _cuda()
    gen = torch.Generator().manual_seed(9)
    params = {k: v.requires_grad_(True) for k, v in
              _tree(SHAPES, gen, 1.0, device, torch.float32).items()}
    opt = Adam(params, LR)
    before = [t._version for d in (params, opt.mu, opt.nu)
              for t in d.values()]
    loss = (params['fc'] * params['fc']).sum()   # saves fc
    opt.step(params, _tree(SHAPES, gen, 1e-2, device, torch.float32))
    after = [t._version for d in (params, opt.mu, opt.nu)
             for t in d.values()]
    assert all(a > b for a, b in zip(after, before))
    with pytest.raises(RuntimeError, match='modified by an inplace'):
        loss.backward()


# ---------------------------------------------------------------------------
# The chunk plan and the wrapper's refusals on any host
# ---------------------------------------------------------------------------

def param_bytes(leaves):
    """A launch's parameter bytes: csrc/adam.cu's Leaves (four pointers,
    a length and a chunk start a tensor, one more start, the count; padded
    to 8) and Scalars<double>."""
    table = 8 * 4 * leaves + 8 * leaves + 4 * (leaves + 1) + 4
    return -(-table // 8) * 8 + OA.SCALARS_BYTES


def _block_ranges(launch, sizes):
    """(tensor, first element, end) of each block of a launch, each block
    finding its tensor by csrc/adam.cu's binary search."""
    starts = np.concatenate([[0], np.cumsum(launch.chunks)]).tolist()
    count = len(launch.leaves)
    for c in range(starts[-1]):
        j, hi = 0, count - 1
        while j < hi:
            mid = (j + hi + 1) >> 1
            if starts[mid] <= c:
                j = mid
            else:
                hi = mid - 1
        n = sizes[launch.leaves[j]]
        begin = (c - starts[j]) * OA.CHUNK
        yield launch.leaves[j], begin, min(begin + OA.CHUNK, n)


def _sizes(case):
    if case in ('hmr2', 'resnet50'):
        return [int(np.prod(s)) for s in model_shapes(case).values()]
    if case == 'edges':
        return list(EDGE_SIZES)
    if case == 'many':         # more tensors than a launch takes, odd sizes
        return [(i * 7919) % 50021 for i in range(300)]
    if case == 'full':         # a launch's worth, then one more
        return [3] * OA.MAX_LEAVES
    if case == 'full_and_one':
        return [3] * (OA.MAX_LEAVES + 1)
    if case == 'huge':         # past 2**31 elements in one tensor
        return [5, 2 ** 31 + 3]
    return [0, 0, 0]           # nothing to launch


@pytest.mark.parametrize('case', ['hmr2', 'resnet50', 'edges', 'many',
                                  'full', 'full_and_one', 'huge', 'empty'])
def test_chunk_plan_covers_every_element_once(case):
    sizes = _sizes(case)
    plan = OA.chunk_plan(sizes)
    most = OA.MAX_LEAVES
    nonempty = [i for i, n in enumerate(sizes) if n]
    assert [i for lc in plan for i in lc.leaves] == nonempty
    assert len(plan) == -(-len(nonempty) // most)
    covered = {i: 0 for i in nonempty}
    for lc in plan:
        assert 0 < len(lc.leaves) <= most
        assert param_bytes(len(lc.leaves)) <= OA.PARAM_BYTES
        for i, begin, end in _block_ranges(lc, sizes):
            assert begin == covered[i] and begin < end
            covered[i] = end
    assert covered == {i: sizes[i] for i in nonempty}


def test_launch_table_fills_the_parameter_space():
    """MAX_LEAVES rows fit the kernel's 4 KB of parameters and one more
    does not; the numbers are the ones csrc/adam.cu static_asserts."""
    most = OA.MAX_LEAVES
    assert param_bytes(most) <= OA.PARAM_BYTES < param_bytes(most + 1)
    assert (most, OA.CHUNK) == (91, 16384)
    assert OA.CHUNK % 4 == 0     # every chunk starts on a 16-byte vector


def test_model_leaf_counts():
    assert len(model_shapes('hmr2')) == 500
    assert sum(int(np.prod(s)) for s in model_shapes('hmr2').values()) \
        == 670459037
    assert len(model_shapes('resnet50')) == 169


def test_adam_scalars_are_the_plain_versions_numbers():
    """float32: every number a float32 (as the card's foreach operations
    cast a Python number), r1 and r2 the float32 reciprocals; float64 the
    Python numbers and double reciprocals."""
    c1, c2 = 1 - np.float32(0.9) ** 3, 1 - np.float32(0.999) ** 3
    got = OA.adam_scalars(torch.float32, c1=c1, c2=c2, **HYPER)
    want = [np.float32(x) for x in (0.1, 0.9, 1 - 0.999, 0.999)]
    want += [np.float32(1) / c1, np.float32(1) / c2, np.float32(1e-8),
             np.float32(-LR)]
    assert [np.float32(x) for x in got] == want
    assert all(float(np.float32(x)) == x for x in got)
    got = OA.adam_scalars(torch.float64, c1=c1, c2=c2, **HYPER)
    assert got == (1 - 0.9, 0.9, 1 - 0.999, 0.999, 1 / float(c1),
                   1 / float(c2), 1e-8, -LR)


@pytest.mark.parametrize('dtype,match', [
    (torch.bfloat16, 'float32 or float64'), (torch.float16,
                                             'float32 or float64'),
    (torch.float32, 'CUDA tensors')])
def test_adam_cuda_refuses_what_the_kernel_does_not_take(dtype, match):
    ts = [[torch.zeros(3, dtype=dtype)] for _ in range(4)]
    with pytest.raises(ValueError, match=match):
        OA.adam_cuda(*ts, c1=0.1, c2=0.001, **HYPER)


def test_adam_on_the_cpu_launches_nothing():
    before = (OA.adam_cuda.launches, OA.adam_cuda.floats)
    gen = torch.Generator().manual_seed(1)
    params = _tree(SHAPES, gen, 1.0, 'cpu', torch.float32)
    opt = Adam(params, LR)
    opt.step(params, _tree(SHAPES, gen, 1e-2, 'cpu', torch.float32))
    assert (OA.adam_cuda.launches, OA.adam_cuda.floats) == before


def test_roofline_reader_counts_the_kernels_bytes(monkeypatch):
    """portbench's adam_roofline.fit: 28 B a float of the counters' mean
    launch, times the kernel's launches in the window, at 3.35 TB/s over
    their device time; None without a trace or without a launch there."""
    from types import SimpleNamespace

    from portbench import run
    read = run.load_reader('adam_roofline.fit')
    monkeypatch.setattr(OA.adam_cuda, 'launches', 4)
    monkeypatch.setattr(OA.adam_cuda, 'floats', 2 * 670459037)
    name = 'void (anonymous namespace)::tuch_adam_kernel<float>(...)'
    kernels = [(name, 100.0, 3100.0, 'eft_step.adam'),     # 3 ms each
               (name, 4000.0, 7000.0, 'eft_step.adam'),
               ('multi_tensor_apply_kernel', 7000.0, 9000.0, ''),
               (name, 20000.0, 23000.0, 'eft_step.adam')]   # after the window
    trace = SimpleNamespace(kernels=kernels, t0_us=0.0, t1_us=10000.0)
    want = 100 * 28 * 670459037 / 2 * 2 / 3.35e12 / 6e-3
    assert read({'trace': trace}) == pytest.approx(want, rel=1e-12)
    assert read({}) is None
    assert read({'trace': SimpleNamespace(kernels=kernels[2:3], t0_us=0.0,
                                          t1_us=1e4)}) is None
    monkeypatch.setattr(OA.adam_cuda, 'launches', 0)
    assert read({'trace': trace}) is None


# ---------------------------------------------------------------------------
# The kernel on the card
# ---------------------------------------------------------------------------

def _hold_kernel(shapes, dtype, dev, steps=4, seed=11):
    """`steps` steps of the kernel, in place, against adam_plain from the
    same state, bytes equal; each step's launches are the chunk plan's."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = list(_tree(shapes, gen, 1.0, dev, dtype).values())
    m = [torch.zeros_like(t) for t in p]
    v = [torch.zeros_like(t) for t in p]
    sizes = [t.numel() for t in p]
    plan = OA.chunk_plan(sizes)
    for step in range(1, steps + 1):
        g = list(_tree(shapes, gen, 1e-2, dev, dtype).values())
        n = np.float32(step)
        hyper = dict(HYPER, c1=1 - np.float32(0.9) ** n,
                     c2=1 - np.float32(0.999) ** n)
        want = OA.adam_plain(p, g, m, v, **hyper)
        before = (OA.adam_cuda.launches, OA.adam_cuda.floats)
        got = OA.adam_cuda(p, g, m, v, **hyper)
        assert all(a is b for a, b in zip(got, (p, m, v)))
        assert (OA.adam_cuda.launches - before[0],
                OA.adam_cuda.floats - before[1]) == (len(plan), sum(sizes))
        torch.cuda.synchronize()
        for got, ref in zip((p, m, v), want):
            for a, b in zip(got, ref):
                _same(a, b)
        del want, g


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('model', ['hmr2', 'resnet50'])
def test_kernel_is_the_plain_update_at_the_models_leaves(model, dtype):
    dev = _cuda()
    try:
        _hold_kernel(model_shapes(model), dtype, dev)
    finally:
        torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_kernel_on_empty_odd_and_unaligned_leaves(dtype):
    """Empty and odd lengths across chunk edges, then each of p, g, m and
    v as a view at its own unaligned offset: the element-by-element path."""
    dev = _cuda()
    shapes = {f'e{i}': (n,) for i, n in enumerate(EDGE_SIZES)}
    _hold_kernel(shapes, dtype, dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    sizes = (16385, 33, 1, 0, 70001)

    def views(off, scale):
        return [(torch.randn(n + 4, generator=gen, device=dev, dtype=dtype)
                 * scale).abs()[off:off + n] for n in sizes]

    # v one element off 16 bytes in both types, g in float32
    p, g, m, v = views(0, 1.0), views(2, 1e-2), views(0, 1e-3), \
        views(1, 1e-6)
    assert all((a.data_ptr() | b.data_ptr() | c.data_ptr() | d.data_ptr())
               % 16 for a, b, c, d in zip(p, g, m, v) if a.numel())
    hyper = dict(HYPER, c1=1 - np.float32(0.9) ** 2,
                 c2=1 - np.float32(0.999) ** 2)
    want = OA.adam_plain(p, g, m, v, **hyper)
    got = OA.adam_cuda(p, g, m, v, **hyper)
    torch.cuda.synchronize()
    for a_list, b_list in zip(got, want):
        for a, b in zip(a_list, b_list):
            _same(a, b)


@pytest.mark.cuda
def test_kernel_reads_gradients_a_cuda_graph_rewrites():
    """On the EFT step's graph path the gradients are the backward graph's
    static buffers: the same tensors every step, rewritten by each replay.
    Each step must read the replay's values."""
    dev = _cuda()
    shapes = model_shapes('resnet50')
    gen = torch.Generator(device=dev).manual_seed(8)
    p = list(_tree(shapes, gen, 1.0, dev, torch.float32).values())
    m = [torch.zeros_like(t) for t in p]
    v = [torch.zeros_like(t) for t in p]
    x = [torch.randn(t.shape, generator=gen, device=dev) for t in p]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        g = [t * 1e-2 for t in x]
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g = [t * 1e-2 for t in x]
    opt = Adam(dict(enumerate(p)), LR)
    want = ([t.clone() for t in p], [t.clone() for t in m],
            [t.clone() for t in v])
    for step in range(1, 4):
        for t in x:
            t.copy_(torch.randn(t.shape, generator=gen, device=dev))
        graph.replay()
        opt.step(dict(enumerate(p)), dict(enumerate(g)))
        n = np.float32(step)
        want = OA.adam_plain(*want[:1], [t.clone() for t in g], *want[1:],
                             c1=1 - np.float32(0.9) ** n,
                             c2=1 - np.float32(0.999) ** n, **HYPER)
        torch.cuda.synchronize()
        for i in range(len(p)):
            _same(p[i], want[0][i])
            _same(opt.mu[i], want[1][i])
            _same(opt.nu[i], want[2][i])


@pytest.mark.cuda
def test_kernel_refuses_a_bfloat16_leaf_on_the_card():
    dev = _cuda()
    params = {'w': torch.zeros(8, device=dev),
              'h': torch.zeros(8, device=dev, dtype=torch.bfloat16)}
    opt = Adam(params, LR)
    before = OA.adam_cuda.launches
    with pytest.raises(ValueError, match='contiguous torch.float32'):
        opt.step(params, {k: torch.ones_like(t) for k, t in params.items()})
    with pytest.raises(ValueError, match='float32 or float64'):
        Adam({'h': params['h']}, LR).step(
            {'h': params['h']}, {'h': torch.ones_like(params['h'])})
    assert OA.adam_cuda.launches == before
