#!/usr/bin/env python3
"""Repeat chip_smoke.py's one-call torch.profiler capture of kernels 5 and
6 (gather and scatter-add rows) and count the captures that record no
device work.

    python3 tools/profile_capture_repeat.py [SESSIONS] [PAD_MS]   # on the card

Each session profiles one call of the wrapper, as chip_smoke's
device_breakdown does, after the work chip_smoke does before it (the call
timed by CUDA-graph replay, then by the host clock), with PAD_MS of host
sleep inside the capture window before and after the call (0: none, as
chip_smoke had it). Prints, for each
kernel: the sessions, those whose capture held no device kernel (and in
those, whether the runtime's launch call was recorded), those with other
device work than the one kernel, and the kernel's start less its launch
call's start in µs (min, median, max) over the captures that hold both.
Run it in several fresh processes too: chip_smoke's captures are the first
of their process.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as S  # noqa: E402


def capture(fn, pad_s):
    """One profiled call: (device kernel names, launch-call start times µs,
    kernel start times µs)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if pad_s:
            time.sleep(pad_s)
        fn()
        torch.cuda.synchronize()
        if pad_s:
            time.sleep(pad_s)
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    launches = [e.time_range.start for e in events
                if e.device_type != DeviceType.CUDA
                and e.name.startswith(S.LAUNCH_CALLS)]
    return ([e.name for e in kernels], launches,
            [e.time_range.start for e in kernels])


def main(argv) -> int:
    sessions = int(argv[0]) if argv else 100
    pad_ms = float(argv[1]) if len(argv) > 1 else 0.0
    if not torch.cuda.is_available():
        print('profile_capture_repeat: no CUDA device', file=sys.stderr)
        return 1
    B, V = S.TRAIN_B, 6890
    rng = np.random.RandomState(0)
    verts = torch.from_numpy(rng.randn(B, V, 3).astype(np.float32)).cuda()
    idx = torch.from_numpy(rng.randint(0, V, (B, V)).astype(np.int32)).cuda()
    calls = {name: c[0] for name, c in S._row_calls(verts, idx).items()}
    stats = {name: dict(empty=0, empty_with_launch=0, other=0, offsets=[])
             for name in calls}
    for _ in range(sessions):
        for name, fn in calls.items():          # gather, then scatter_add
            S.graph_ms(fn, iters=5)
            S.host_us(fn, calls=100)
            names, launches, starts = capture(fn, pad_ms / 1e3)
            st = stats[name]
            if not names:
                st['empty'] += 1
                st['empty_with_launch'] += bool(launches)
            elif len(names) != 1 or f'{name}_rows' not in names[0]:
                st['other'] += 1
            if starts and launches:
                st['offsets'].append(starts[0] - launches[0])
    card = S.card_line()
    for name, st in stats.items():
        off = np.array(st['offsets']) if st['offsets'] else np.zeros(1)
        print(f'[capture pad {pad_ms} ms] {name}: {sessions} sessions, '
              f'{st["empty"]} with no device kernel ({st["empty_with_launch"]}'
              f' of them with the launch call recorded), {st["other"]} with '
              f'other device work; kernel start - launch call start µs: min '
              f'{off.min():.1f}, median {np.median(off):.1f}, max '
              f'{off.max():.1f}; torch {torch.__version__}; card: {card}',
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
