#!/usr/bin/env python3
"""Repeat the plain (CPU) winding numbers on one input and report whether
two identical calls ever differ, and where.

    python3 tools/cpu_winding_repeat.py [REPEATS]   # from the repo root

The input is tests/test_torch_port_kernels.py's _body() (B=2, 150 jittered
points, 296 random faces, the points as queries), whose dispatch test saw
two identical calls of ops/contact.winding_numbers_same_tris differ on a
card machine's CPU. Runs REPEATS evaluations of the plain version's
operations, with torch's default threads and then one thread, and prints
which stage (numerator, denominator, atan2, the sum over faces) differs
from the first evaluation, and where, for up to three differing calls;
then REPEATS calls of the plain version itself, each against the first
and against the same sums in float64 (calls off by more than WRONG, and
which queries). Pin it to one core (`taskset -c N`) to test each core.
As a pytest plugin it checks the plain version after every test
(pytest_runtest_teardown).
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


_CHECKED = []


def pytest_runtest_teardown(item):
    """As a pytest plugin (`PYTHONPATH=tools python -m pytest -s -p
    cpu_winding_repeat ...`): 20 calls of the plain version after each
    test, against float64; prints the tests after which a call was off."""
    wrong, rows = wrong_calls(20)
    _CHECKED.append(bool(wrong))
    if wrong:
        print(f'\n[cpu_winding] after {item.nodeid}: {wrong} of 20 calls '
              f'off by more than {WRONG:g} (queries {min(rows)}-'
              f'{max(rows)}, {len(rows)} of them)', flush=True)


def pytest_sessionfinish(session):
    print(f'\n[cpu_winding] checked after {len(_CHECKED)} tests, wrong '
          f'after {sum(_CHECKED)}; torch {torch.get_num_threads()} threads',
          flush=True)


def main(argv) -> int:
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
