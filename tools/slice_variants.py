#!/usr/bin/env python3
"""Where kernels 2 (winding numbers) and 6 (row scatter-add) spend their
time, by building variants of them.

    python3 tools/slice_variants.py      # from the repository root, one card

Builds tuch_tpu_torch/csrc/winding.cu as it is and variants of it with
nvcc, one set of text substitutions per variant (every occurrence, in the
source and its copy of csrc/solid_angle.cuh, which holds kernel 2's pair);
kernel 6's earlier atomic form (tools/scatter_atomic.cu) and variants of
it, its earlier designs from tools/scatter_trials.cu, and csrc/gather.cu's
fixed-order kernel 6 as the package has it; and times them on the
SMPLify-DC slice's inputs:
the synthetic 6890-vertex body posed from a seed at B=64 (and B=4 for the
scatter), its 13776 faces, and the masked nearest vertex of every vertex as
the scatter's indices (as chip_smoke.py phase 7). Winding variants are held
against the plain version (max abs error, in/out flips at 0.99 outside
|wn - 0.99| < 1e-4); the scatter variants marked "wrong" compute a wrong
answer and only their time is read; the others must equal index_add_ (the
contributions are multiples of 2^-10, so every order of the additions gives
the same sums). Each variant of the atomic kernel runs at several
cluster sizes. Scatter times are the median of five CUDA-graph replays of
50 launches (device time), beside zero-fill + index_add_; winding times the
median of three runs of three launches (CUDA events). Prints the card's
name and power limit first, and the scatter kernel's atomic and barrier
instructions (cuobjdump).
"""

import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tuch_tpu_torch.ops import _build  # noqa: E402

sys.path.insert(0, str(ROOT / 'tools'))
from determinism_settings import ATOMIC_BLOCKS  # noqa: E402
from determinism_settings import plan as atomic_plan  # noqa: E402

CSRC = ROOT / 'tuch_tpu_torch' / 'csrc'
# kernel 2's pair is tuch::half_angle in csrc/solid_angle.cuh
SQRT_APPROX = [
    ('namespace tuch {\n', 'namespace tuch {\n__device__ __forceinline__ '
     'float sqrt_approx(float x) {\n  float r;\n  asm("sqrt.approx.f32 %0, '
     '%1;" : "=f"(r) : "f"(x));\n  return r;\n}\n'),
    ('sqrtf(sq_norm(', 'sqrt_approx(sq_norm(')]
FMA_TERMS = [('sq_norm(ax, ay, az)', 'fmaf(ax, ax, fmaf(ay, ay, az * az))'),
             ('sq_norm(bx, by, bz)', 'fmaf(bx, bx, fmaf(by, by, bz * bz))'),
             ('sq_norm(cx, cy, cz)', 'fmaf(cx, cx, fmaf(cy, cy, cz * cz))'),
             ('dot(ax, ay, az, bx, by, bz)',
              'fmaf(ax, bx, fmaf(ay, by, az * bz))'),
             ('dot(bx, by, bz, cx, cy, cz)',
              'fmaf(bx, cx, fmaf(by, cy, bz * cz))'),
             ('dot(ax, ay, az, cx, cy, cz)',
              'fmaf(ax, cx, fmaf(ay, cy, az * cz))')]
QPT = 'constexpr int QPT = 4;'
# name -> (substitutions, queries per block)
WINDING = {
    'kernel': ([], 512),
    'sqrt.approx': (SQRT_APPROX, 512),
    'FMA in the squared lengths and dot products': (FMA_TERMS, 512),
    'sqrt.approx and FMA': (SQRT_APPROX + FMA_TERMS, 512),
    'IEEE atan2f': ([('return atan2_poly(numer, denom);',
                      'return atan2f(numer, denom);')], 512),
    '2 queries per thread': ([(QPT, 'constexpr int QPT = 2;')], 256),
    '8 queries per thread': ([(QPT, 'constexpr int QPT = 8;')], 1024),
}
THREADS = 'constexpr int SCATTER_THREADS = 1024;'
UNROLL = 'constexpr int SCATTER_UNROLL = 4;'
# tools/scatter_atomic.cu's kernel: name -> substitutions
SCATTER = {
    'kernel': [],
    '512 threads': [(THREADS, 'constexpr int SCATTER_THREADS = 512;')],
    '8 floats in flight': [(UNROLL, 'constexpr int SCATTER_UNROLL = 8;')],
    'stores, no reductions (wrong)': [
        ('atomicAdd(out + at[u], v[u]);', 'out[at[u]] = v[u];')],
    'no zero fill, no barrier (wrong)': [
        ('if (r_lo < V) zero_span(', 'if (r_lo < 0) zero_span('),
        ('asm volatile("barrier.cluster.arrive.release;\\n" ::: "memory");',
         ''),
        ('asm volatile("barrier.cluster.wait.acquire;\\n" ::: "memory");',
         '')],
    'zero fill and barrier only (wrong)': [
        ('    pass.add(ob);\n', '')],
}
# tools/scatter_trials.cu: name -> -D flags
TRIALS = {
    'first design: memset, then a thread per float': [],
    'rows in shared memory, S=1723': ['-DTRIAL_SLICES'],
    'rows in shared memory, no atomics (wrong), S=1723': [
        '-DTRIAL_SLICES', '-DTRIAL_NO_ATOMICS'],
    'clusters, a thread per row, float4 reductions': ['-DTRIAL_ROW_VEC=4'],
    'clusters, a thread per row, float reductions': ['-DTRIAL_ROW_VEC=1'],
}

def card_line() -> str:
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()


def start(workdir: Path, source: Path, variants: dict, flags=None):
    """{variant: (library, nvcc process)}: `source` with each variant's
    substitutions or, with `flags`, each variant's nvcc flags; one nvcc
    process each, all started together. A substitution replaces every
    occurrence in the source and in its directory's copy of csrc/'s headers
    (solid_angle.cuh), which the source's #include "..." finds first."""
    texts = {p.name: p.read_text() for p in sorted(CSRC.glob('*.cuh'))}
    texts[source.name] = source.read_text()
    procs = {}
    for i, (variant, subs) in enumerate(variants.items()):
        files = dict(texts)
        for old, new in ([] if flags else subs):
            if not any(old in text for text in files.values()):
                raise RuntimeError(f'{source.name} and its headers changed: '
                                   f'{old[:50]!r}')
            files = {k: v.replace(old, new) for k, v in files.items()}
        vdir = workdir / f'{source.stem}{i}'
        vdir.mkdir(parents=True, exist_ok=True)
        for name, text in files.items():
            (vdir / name).write_text(text)
        path = vdir / source.name
        lib = vdir / f'lib{source.stem}{i}.so'
        cmd = ['nvcc', *_build.NVCC_FLAGS, *(subs if flags else []),
               f'-I{CSRC}', '-o', str(lib), str(path)]
        procs[variant] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def finish(name: str, procs: dict, symbol: str, argtypes, logs=None):
    """{variant: C function} of the builds that `start` began; with a dict
    `logs`, each build's nvcc output (ptxas lines) goes into it."""
    fns = {}
    for variant, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if logs is not None:
            logs[variant] = log
        if proc.returncode:     # reported, and the other variants still run
            print(f'[{name}] {variant}: nvcc failed:\n{log[-2000:]}',
                  flush=True)
            continue
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[variant] = fn
    return fns


def median_ms(fn, launches, repeats, graph):
    """Median over `repeats` of the device ms per call of fn, over
    `launches` calls: one CUDA-graph replay each (graph) or back-to-back
    launches between two events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(launches):
                fn()
        run = g.replay
    else:
        fn()

        def run():
            for _ in range(launches):
                fn()
    times = []
    for _ in range(repeats):
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return sorted(times)[repeats // 2]


def check(err, what):
    if err:
        raise RuntimeError(f'{what}: CUDA error {err}')


def slice_inputs(B, seed=99):
    from tuch_tpu_torch import runtime as rt
    from tuch_tpu_torch.models.smpl import smpl_forward
    from tuch_tpu_torch.ops import contact_kernels as CK
    run = rt.build_runtime(device='cuda', synthetic=True, with_contact=True)
    pose = torch.as_tensor((np.random.RandomState(seed).randn(B, 72) * 0.3)
                           .astype(np.float32), device='cuda')
    with torch.no_grad():
        verts = smpl_forward(run.smpl, torch.zeros(B, 10, device='cuda'),
                             pose[:, 3:], pose[:, :3]).vertices.contiguous()
    tris = verts[:, run.contact.faces].contiguous()
    _, idx = CK.masked_min_dist_cuda(verts, run.contact.geomask)
    return verts, tris, idx


def winding_variants(fns, verts, tris):
    from tuch_tpu_torch.ops import contact as PC
    from tuch_tpu_torch.ops import contact_kernels as CK
    B, Q, _ = verts.shape
    F = tris.shape[1]
    want = torch.cat([PC.winding_numbers(verts[i:i + 16], tris[i:i + 16])
                      for i in range(0, B, 16)])
    band = (want - 0.99).abs() < 1e-4
    out = torch.empty(B, Q, device='cuda')
    for variant, fn in fns.items():
        chunk, splits = CK._split(B * -(-Q // WINDING[variant][1]), F, 128)
        partial = torch.empty(B, splits, Q, device='cuda')

        def call(fn=fn, chunk=chunk, partial=partial):
            check(fn(verts.data_ptr(), tris.data_ptr(), out.data_ptr(),
                     partial.data_ptr(), B, Q, F, chunk, PC.INV_4PI,
                     torch.cuda.current_stream().cuda_stream), variant)
        ms = median_ms(call, 3, 3, graph=False)
        call()
        torch.cuda.synchronize()
        err = (out - want).abs().max().item()
        flips = (((out <= 0.99) != (want <= 0.99)) & ~band).sum().item()
        print(f'[winding B={B}] {variant}: {ms:.4f} ms, max abs err vs '
              f'plain {err:.3g}, in/out flips {flips} (splits {splits})',
              flush=True)


def scatter_variants(fns, trials, idx, V):
    from tuch_tpu_torch.ops import gather as G
    B, Q = idx.shape
    # multiples of 2^-10 below 2: every sum is exact in any order, so the
    # check below is exact whatever order the atomics take
    contrib = torch.randint(-2047, 2048, (B, Q, 3), device='cuda') / 1024.0
    want = G.scatter_add_rows_ref(contrib, idx, V)
    flat = (torch.arange(B, device='cuda')[:, None] * V
            + idx.long()).reshape(-1)
    src = contrib.reshape(-1, 3)
    buf = torch.empty(B * V, 3, device='cuda')

    def library():
        buf.zero_()
        buf.index_add_(0, flat, src)
    rows = idx.cpu().numpy()
    distinct = [len(np.unique(r[i:i + 32])) for r in rows
                for i in range(0, Q - 31, 32)]
    counts = torch.bincount(flat, minlength=B * V)
    print(f'[scatter B={B}] indices: {np.mean(distinct):.2f} distinct '
          f'targets per 32 consecutive q on average, {min(distinct)} at '
          f'least; most contributions to one row {counts.max().item()}; '
          f'rows hit {(counts > 0).sum().item()} of {B * V}', flush=True)
    print(f'[scatter B={B}] zero_ + index_add_: '
          f'{median_ms(library, 50, 5, graph=True):.4f} ms', flush=True)
    out = torch.empty(B, V, 3, device='cuda')

    def stream():   # the capturing stream inside a CUDA-graph capture
        return torch.cuda.current_stream().cuda_stream

    def report(variant, call):
        ms = median_ms(call, 50, 5, graph=True)
        out.fill_(float('nan'))
        call()
        torch.cuda.synchronize()
        err = (out - want).abs().max().item()
        print(f'[scatter B={B}] {variant}: {ms:.4f} ms, max abs err vs '
              f'index_add_ {err:.3g}{"" if err == 0 else " (WRONG)"}',
              flush=True)
    report('csrc/gather.cu (fixed order)',
           lambda: out.copy_(G.scatter_add_rows_cuda(contrib, idx, V)))
    clusters = sorted({c for c in (1, 2, 4, 8, atomic_plan(B, V, Q)[0])
                       if B * c <= 4 * ATOMIC_BLOCKS or c == 1})
    for variant, fn in fns.items():
        for C in clusters:
            plan = (C, -(-V // C), -(-Q // C))
            tag = ' (the plan)' if plan == atomic_plan(B, V, Q) else ''

            def call(fn=fn, plan=plan):
                check(fn(contrib.data_ptr(), idx.data_ptr(), out.data_ptr(),
                         B, V, Q, *plan, stream()), variant)
            report(f'{variant}, clusters of {C}{tag} ({B * C} blocks)', call)
    for variant, fn in trials.items():
        def call(fn=fn):
            check(fn(contrib.data_ptr(), idx.data_ptr(), out.data_ptr(), B,
                     V, Q, 1723 if B >= 64 else 209, stream()), variant)
        report(variant.replace('S=1723', f'S={1723 if B >= 64 else 209}'),
               call)


def sass_lines(lib: Path, kernel: str, ops=('RED', 'ATOM', 'BAR', 'UCGABAR',
                                            'MEMBAR', 'CCTL')):
    """The memory-ordering and atomic instructions of `kernel` in `lib`, as
    cuobjdump disassembles them."""
    tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    out = subprocess.run([tool, '-sass', str(lib)],
                         capture_output=True, text=True).stdout
    body = out[out.index(kernel):] if kernel in out else ''
    body = body[:body.find('Function :', 1)] if 'Function :' in body[1:] \
        else body
    return sorted({line.split(';')[0].split('*/')[-1].strip()
                   for line in body.splitlines()
                   if any(f' {op}' in line for op in ops)})


def main() -> int:
    if not torch.cuda.is_available():
        print('slice_variants: no CUDA device', file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    _build.build(['masked_min'])
    with tempfile.TemporaryDirectory() as tmp:
        wind = start(Path(tmp), CSRC / 'winding.cu',
                     {k: v[0] for k, v in WINDING.items()})
        scat_builds = start(Path(tmp), ROOT / 'tools' / 'scatter_atomic.cu',
                            SCATTER)
        trial = start(Path(tmp), ROOT / 'tools' / 'scatter_trials.cu', TRIALS,
                      flags=True)
        wind = finish('winding', wind, 'tuch_winding_numbers',
                      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                      + [ctypes.c_float, ctypes.c_void_p])
        scat = finish('scatter_atomic', scat_builds, 'tuch_scatter_add_rows',
                      [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                      + [ctypes.c_void_p])
        for variant, (lib, _) in scat_builds.items():
            print(f'[scatter] {variant}: SASS atomics and barriers '
                  f'{sass_lines(lib, "scatter_add_rows_kernel")}',
                  flush=True)
        trial = finish('trials', trial, 'trial_scatter',
                       [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        verts, tris, idx = slice_inputs(64)
        winding_variants(wind, verts, tris)
        del tris
        scatter_variants(scat, trial, idx, verts.shape[1])
        _, _, idx4 = slice_inputs(4)
        scatter_variants(scat, trial, idx4, verts.shape[1])
    return 0


if __name__ == '__main__':
    sys.exit(main())
