#!/usr/bin/env python3
"""The SMPLify-DC body iteration of two checkouts of this repository, timed
in turns on one card.

    python3 tools/fit_ab.py OTHER_CHECKOUT     # from the repository root

Runs a fresh process in each checkout's root, in the order this, other,
other, this; each builds that checkout's kernels and synthetic runtime
(6890 vertices, every contact asset) and times its chip_smoke.py body
iteration (phase 10's body_stepper: the neighbour refresh, the stage-2 loss
and gradient, one Adam step) at B=4 and B=64: host clock, mean of 10 after
2 warm-ups, then the device busy time and idle share of 3 iterations under
torch.profiler. Prints the card's name and power limit first, then one line
per run and batch.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CHILD = r'''
import json, time
import torch
import chip_smoke as C
from tuch_tpu_torch import runtime as rt
run = rt.build_runtime(device='cuda', synthetic=True, with_contact=True)
assets = (run.smpl, run.prior, run.contact)
P = run.contact.region_idx_a.shape[0]
out = {}
for B in (4, 64):
    step = C.body_stepper(assets, C.fit_inputs(B, P, 21, 'cuda'))
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        step()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / 10
    wall, busy, _ = C.device_breakdown(lambda: [step() for _ in range(3)])
    out[B] = [ms, busy / 3, 1 - busy / wall]
print(json.dumps(out))
'''


def main(argv) -> int:
    if len(argv) != 1 or not (Path(argv[0]) / 'chip_smoke.py').is_file():
        print('usage: python3 tools/fit_ab.py OTHER_CHECKOUT (a directory '
              'holding chip_smoke.py)', file=sys.stderr)
        return 2
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    trees = {'this': ROOT, 'other': Path(argv[0]).resolve()}
    for turn, name in enumerate(('this', 'other', 'other', 'this')):
        proc = subprocess.run([sys.executable, '-c', CHILD],
                              cwd=trees[name], capture_output=True, text=True,
                              timeout=900)
        if proc.returncode:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        for B, (ms, busy, idle) in json.loads(
                proc.stdout.strip().splitlines()[-1]).items():
            print(f'[fit_ab] turn {turn} {name} ({trees[name]}) B={B}: '
                  f'{ms:.3f} ms per body iteration (host clock, mean of 10); '
                  f'device busy {busy:.3f} ms per iteration, idle share '
                  f'{idle:.1%} (torch.profiler, 3 iterations)', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
