#!/usr/bin/env python3
"""Repeat the plain (CPU) winding numbers on one input and report whether
two identical calls ever differ, and where; and read each of torch's
intra-op threads' floating-point state as native code loads.

    python3 tools/cpu_winding_repeat.py [REPEATS]   # from the repo root
    python3 tools/cpu_winding_repeat.py --fp-state [REPEATS]

The input is tests/test_torch_port_kernels.py's _body() (B=2, 150 jittered
points, 296 random faces, the points as queries), whose dispatch test saw
two identical calls of ops/contact.winding_numbers_same_tris differ on a
card machine's CPU (ROADMAP fault 5: 38 of 300 values, one thread's share
at 8 threads). Runs REPEATS evaluations of the plain version's
operations, with torch's default threads and then one thread, and prints
which stage (numerator, denominator, atan2, the sum over faces) differs
from the first evaluation, and where, for up to three differing calls;
then REPEATS calls of the plain version itself, each against the first
and against the same sums in float64 (calls off by more than WRONG, and
which queries). Pin it to one core (`taskset -c N`) to test each core.

--fp-state reads, before and after each step that loads native code (numpy
finfo, the host library viz/native, the nvcc kernel libraries, CUDA with
cuBLAS, cuDNN), every intra-op thread's flush-to-zero, denormals-are-zero
and rounding mode, as that thread's own float32 arithmetic shows them
(fp_state: one elementwise op split across the threads, chunk i on thread
i), the main thread's MXCSR where g++ can build a reader, whether numpy
warns that float32's smallest subnormal is zero, and whether REPEATS calls
of the plain winding equal the first. A thread whose state differs from
the others' is the suspect: the x86 state is per thread, and a new thread
copies its creator's.

As a pytest plugin it checks the plain version after every test
(pytest_runtest_teardown), and prints the threads' floating-point state
wherever it changed.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tuch_tpu_torch.ops import contact as PC  # noqa: E402


# float32 sums of 296 solid angles lie ~1e-6 from float64 (any order);
# a call further off computed something else
WRONG = 1e-4


def cpu_model():
    try:
        with open('/proc/cpuinfo') as f:
            for line in f:
                if line.startswith('model name'):
                    return line.split(':', 1)[1].strip()
    except OSError:
        pass
    return 'CPU model unknown'


def body(B=2, V=150, F=296, seed=0):
    rng = np.random.RandomState(seed)
    verts = rng.randn(B, V, 3).astype(np.float32)
    faces = rng.randint(0, V, (F, 3)).astype(np.int64)
    return torch.from_numpy(verts), torch.from_numpy(faces)


def stages(points, tris):
    """ops/contact._solid_angle_sum's intermediates, the same operations
    in the same order: (numer, denom, 2 atan2, the sum over faces)."""
    q = points[:, :, None, :]
    a = tris[:, None, :, 0, :] - q
    b = tris[:, None, :, 1, :] - q
    c = tris[:, None, :, 2, :] - q
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    cx, cy, cz = c.unbind(-1)
    la = torch.sqrt(ax * ax + ay * ay + az * az)
    lb = torch.sqrt(bx * bx + by * by + bz * bz)
    lc = torch.sqrt(cx * cx + cy * cy + cz * cz)
    numer = (ax * (by * cz - bz * cy) + ay * (bz * cx - bx * cz)
             + az * (bx * cy - by * cx))
    dab = ax * bx + ay * by + az * bz
    dbc = bx * cx + by * cy + bz * cz
    dac = ax * cx + ay * cy + az * cz
    denom = la * lb * lc + dab * lc + dac * lb + dbc * la
    ang = 2.0 * torch.atan2(numer, denom)
    return numer, denom, ang, ang.sum(-1)


def wrong_calls(n):
    """n calls of the plain version on body(): (the calls off float64 by
    more than WRONG, the queries they were off at)."""
    verts, faces = body()
    want = stages(verts.double(), verts.double()[:, faces])[3] / (4 * np.pi)
    wrong, rows = 0, set()
    for _ in range(n):
        err = (PC.winding_numbers_same_tris(verts, verts, faces).double()
               - want).abs()
        if err.max().item() > WRONG:
            wrong += 1
            rows.update((err > WRONG).nonzero()[:, 1].tolist())
    return wrong, rows


ULP = 2.0 ** -23                  # float32's spacing at 1


def fp_state():
    """Per intra-op thread, what its float32 arithmetic shows: 'FTZ' (a
    subnormal product comes out zero), 'DAZ' (a subnormal input reads as
    zero), and the rounding mode ('near', 'up', 'down', 'zero'). One
    elementwise op over a tensor of threads x 65536 floats is split by
    at::parallel_for into one contiguous chunk a thread, chunk i on thread
    i (thread 0 is the caller); results are read as integers, so the
    reading itself does no float arithmetic."""
    n_threads = torch.get_num_threads()
    per = 65536                       # above the 32768-element grain
    n = n_threads * per

    def bits(x):
        return x.view(torch.int32).reshape(n_threads, per)
    full = torch.full
    ftz = bits(full((n,), 2.0 ** -70) * full((n,), 2.0 ** -70)) == 0
    tiny = full((n,), 1, dtype=torch.int32).view(torch.float32)  # 2^-149
    daz = bits(tiny * full((n,), 2.0 ** 30)) == 0
    one = torch.ones(n)
    up = bits(one + full((n,), ULP / 4)) != bits(one)
    down = bits(-one - full((n,), ULP / 4)) != bits(-one)
    near = bits(one + full((n,), 0.75 * ULP)) != bits(one)
    states = []
    for t in range(n_threads):
        mode = ('up' if up[t].all() else 'down' if down[t].all()
                else 'near' if near[t].all() else 'zero')
        flags = [f for f, m in (('FTZ', ftz), ('DAZ', daz)) if m[t].all()]
        mixed = any(bool(m[t].any()) != bool(m[t].all())
                    for m in (ftz, daz, up, down, near))
        states.append('+'.join(flags + [mode]) + ('?' if mixed else ''))
    return states


_MXCSR = []


def main_mxcsr():
    """The calling thread's MXCSR as hex, read by a function g++ builds
    into a temporary library on first use; None without g++ or off x86."""
    import ctypes
    import platform
    import shutil
    import subprocess
    import tempfile
    if not _MXCSR:
        gxx = shutil.which('g++')
        fn = None
        if gxx and platform.machine() in ('x86_64', 'AMD64'):
            with tempfile.TemporaryDirectory() as d:
                src = os.path.join(d, 'mxcsr.cpp')
                lib = os.path.join(d, 'mxcsr.so')
                with open(src, 'w') as f:
                    f.write('extern "C" unsigned tuch_mxcsr() '
                            '{ return __builtin_ia32_stmxcsr(); }\n')
                if subprocess.run([gxx, '-O2', '-shared', '-fPIC', '-o',
                                   lib, src],
                                  capture_output=True).returncode == 0:
                    fn = ctypes.CDLL(lib).tuch_mxcsr
                    fn.restype = ctypes.c_uint
        _MXCSR.append(fn)
    fn = _MXCSR[0]
    return None if fn is None else hex(fn())


def numpy_subnormal_warning():
    """What numpy says of float32's smallest subnormal, from a fresh
    finfo (its cache cleared): the warning text, or None."""
    import warnings
    getattr(np.finfo, '_finfo_cache', {}).clear()   # finfo warns when made
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        np.finfo(np.float32).smallest_subnormal
    return '; '.join(str(w.message) for w in caught) or None


def fp_report(step, repeats=20):
    """One line: the threads' states, the main thread's MXCSR, numpy's
    warning and whether `repeats` plain winding calls equal the first."""
    verts, faces = body()
    first = PC.winding_numbers_same_tris(verts, verts, faces)
    differ = sum(not torch.equal(PC.winding_numbers_same_tris(
        verts, verts, faces), first) for _ in range(repeats))
    wrong, _ = wrong_calls(repeats)
    print(f'[fp {step}] threads {fp_state()}; main MXCSR {main_mxcsr()}; '
          f'numpy on float32 subnormals: {numpy_subnormal_warning()}; '
          f'winding: {differ} of {repeats} calls differ from the first, '
          f'{wrong} off float64 by more than {WRONG:g}', flush=True)


def fp_steps(repeats) -> int:
    """fp_report before and after each step that loads native code."""
    fp_report('start', repeats)
    from tuch_tpu_torch.viz import native
    print(f'[fp] viz/native: {native.get_lib()}', flush=True)
    fp_report('after viz/native', repeats)
    from tuch_tpu_torch.ops import _build
    try:
        _build._nvcc()
    except RuntimeError:
        print('[fp] no nvcc: the kernel libraries are not loaded', flush=True)
    else:
        _build.build()
        for name in _build.sources():
            _build.load(name)
        fp_report('after the nvcc kernel libraries', repeats)
    if torch.cuda.is_available():
        a = torch.randn(256, 256, device='cuda')
        (a @ a).sum().item()
        fp_report('after CUDA and cuBLAS', repeats)
        x = torch.randn(2, 3, 32, 32, device='cuda')
        torch.nn.functional.conv2d(x, torch.randn(8, 3, 3, 3,
                                                  device='cuda')).sum().item()
        fp_report('after cuDNN', repeats)
    return 0


_CHECKED = []
_STATES = []


def pytest_runtest_teardown(item):
    """As a pytest plugin (`PYTHONPATH=tools python -m pytest -s -p
    cpu_winding_repeat ...`): 20 calls of the plain version after each
    test, against float64; prints the tests after which a call was off."""
    wrong, rows = wrong_calls(20)
    _CHECKED.append(bool(wrong))
    state = fp_state()
    if not _STATES or state != _STATES[-1]:
        print(f'\n[cpu_winding] threads\' floating-point state after '
              f'{item.nodeid}: {state}', flush=True)
        _STATES.append(state)
    if wrong:
        print(f'\n[cpu_winding] after {item.nodeid}: {wrong} of 20 calls '
              f'off by more than {WRONG:g} (queries {min(rows)}-'
              f'{max(rows)}, {len(rows)} of them)', flush=True)


def pytest_sessionfinish(session):
    print(f'\n[cpu_winding] checked after {len(_CHECKED)} tests, wrong '
          f'after {sum(_CHECKED)}; torch {torch.get_num_threads()} threads',
          flush=True)


def main(argv) -> int:
    if argv[:1] == ['--fp-state']:
        return fp_steps(int(argv[1]) if argv[1:] else 20)
    repeats = int(argv[0]) if argv else 200
    verts, faces = body()
    print(f'torch {torch.__version__}, {torch.get_num_threads()} threads, '
          f'{torch.backends.cpu.get_cpu_capability()}, CPUs '
          f'{sorted(os.sched_getaffinity(0))}, {cpu_model()}', flush=True)
    tris = verts[:, faces]
    want = stages(verts.double(), tris.double())[3] / (4 * np.pi)
    for threads in (torch.get_num_threads(), 1):
        torch.set_num_threads(threads)
        ref = stages(verts, tris)
        bad = 0
        for i in range(repeats):
            got = stages(verts, tris)
            diffs = [(g != r) & ~(g.isnan() & r.isnan())
                     for g, r in zip(got, ref)]
            if not any(bool(d.any()) for d in diffs):
                continue
            bad += 1
            if bad > 3:
                continue
            names = ('numer', 'denom', 'atan2', 'sum')
            print(f'[{threads} threads] call {i}: differing entries '
                  + ', '.join(f'{n} {int(d.sum())}'
                              for n, d in zip(names, diffs)), flush=True)
            for n, d, g, r in zip(names, diffs, got, ref):
                if n == 'sum' or not d.any():
                    continue
                idx = d.nonzero()[0].tolist()
                print(f'    first {n} at {idx}: {g[tuple(idx)].item()!r} '
                      f'vs {r[tuple(idx)].item()!r}; numer '
                      f'{got[0][tuple(idx)].item()!r}/'
                      f'{ref[0][tuple(idx)].item()!r}, denom '
                      f'{got[1][tuple(idx)].item()!r}/'
                      f'{ref[1][tuple(idx)].item()!r}', flush=True)
        print(f'[{threads} threads] {bad} of {repeats} calls differ from '
              f'the first somewhere', flush=True)
        first = PC.winding_numbers_same_tris(verts, verts, faces)
        bad, wrong, worst, rows = 0, 0, 0.0, set()
        for _ in range(repeats):
            got = PC.winding_numbers_same_tris(verts, verts, faces)
            bad += not torch.equal(got, first)
            err = (got.double() - want).abs()
            worst = max(worst, err.max().item())
            if err.max().item() > WRONG:
                wrong += 1
                rows.update((err > WRONG).nonzero()[:, 1].tolist())
        print(f'[{threads} threads] winding_numbers_same_tris: {bad} of '
              f'{repeats} calls differ from the first; against float64: '
              f'largest error {worst:.3g}, {wrong} calls off by more than '
              f'{WRONG:g}' + (f' (queries {min(rows)}-{max(rows)}, '
                              f'{len(rows)} of them)' if rows else ''),
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
