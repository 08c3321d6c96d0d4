#!/usr/bin/env python3
"""The serving forward of two checkouts of this repository, timed in
turns on one card.

    python3 tools/serve_ab.py OTHER_CHECKOUT [PAIRS]   # from the repo root

Runs PAIRS (default 2) pairs of fresh processes, one in each checkout's
root, the pair's order alternating (this, other; other, this; ...); each
builds that checkout's kernels and the fp32 server's
predictor for ViT-S/16 and ResNet-50 (synthetic body, random weights) and
times chip_smoke.py phase 6's two numbers: the B=1 forward with copies in
and out (host clock, median of 50 after 5 warm-ups) and the B=64 forward
with the input on the card (CUDA events, mean of 10). Prints the card's
name and power limit first, then one line per run and backbone, then per
backbone each number's median over the runs of each checkout and in how
many pairs this checkout was the faster.
"""

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CHILD = r'''
import json, time
from types import SimpleNamespace
import numpy as np, torch
import chip_smoke as C
from tuch_tpu_torch.cli.serve import build_server
out = {}
for backbone in ('vit_s16', 'resnet50'):
    httpd = build_server(SimpleNamespace(
        checkpoint=None, synthetic=True, img_res=224,
        synthetic_num_verts=None, max_batch=4, batch_wait_ms=500.0,
        backbone=backbone, device='cuda', dtype='float32',
        host='127.0.0.1', port=0))
    pred = httpd.predictor
    norm = np.random.RandomState(0).randn(1, 224, 224, 3).astype(np.float32)
    for _ in range(5):
        pred._run_forward(norm)
    lat = []
    for _ in range(50):
        t0 = time.perf_counter()
        pred._run_forward(norm)
        lat.append(1e3 * (time.perf_counter() - t0))
    x = torch.randn(64, 224, 224, 3, device='cuda')
    ms64 = C.cuda_ms(lambda: pred.forward(x), iters=10, warmup=2)
    out[backbone] = [float(np.median(lat)), ms64]
    pred.close()
    httpd.server_close()
print(json.dumps(out))
'''


def main(argv) -> int:
    if (len(argv) not in (1, 2)
            or not (Path(argv[0]) / 'chip_smoke.py').is_file()):
        print('usage: python3 tools/serve_ab.py OTHER_CHECKOUT [PAIRS] (a '
              'directory holding chip_smoke.py)', file=sys.stderr)
        return 2
    pairs = int(argv[1]) if len(argv) == 2 else 2
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    trees = {'this': ROOT, 'other': Path(argv[0]).resolve()}
    order = [n for i in range(pairs)
             for n in (('this', 'other') if i % 2 == 0 else
                       ('other', 'this'))]
    runs = {'this': [], 'other': []}
    for turn, name in enumerate(order):
        proc = subprocess.run([sys.executable, '-c', CHILD],
                              cwd=trees[name], capture_output=True, text=True,
                              timeout=900)
        if proc.returncode:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[name].append(got)
        for backbone, (b1, ms64) in got.items():
            print(f'[serve_ab] turn {turn} {name} ({trees[name]}) '
                  f'{backbone} fp32: B=1 {b1:.3f} ms (median of 50, host '
                  f'clock, copies in and out); B=64 {ms64:.3f} ms = '
                  f'{64e3 / ms64:.1f} images/s (CUDA events)', flush=True)
    for backbone in runs['this'][0]:
        for i, what in enumerate(('B=1', 'B=64')):
            mine, theirs = ([r[backbone][i] for r in runs[n]]
                            for n in ('this', 'other'))
            wins = sum(a < b for a, b in zip(mine, theirs))
            print(f'[serve_ab] {backbone} {what}: median this '
                  f'{statistics.median(mine):.3f} ms, other '
                  f'{statistics.median(theirs):.3f} ms over {pairs} runs '
                  f'each; this faster in {wins} of {pairs} pairs',
                  flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
