#!/usr/bin/env python3
"""Which settings make cli/train's runs on the card repeat bit for bit
(ROADMAP fault 4), and what they cost, on one CUDA card.

    python3 tools/determinism_settings.py [REPEATS] [--cost PAIRS]

Runs tools/resume_noise.py (chip_smoke.py phase 13's run A, then B, A
again, and C, A resumed from its step-2 checkpoint, REPEATS times each;
default 6) in a fresh process per setting, the settings in turns:

  a  the port as it was: kernel 6 in its atomic form
     (tools/scatter_atomic.cu in csrc/gather.cu's place), cuDNN free to
     choose and benchmark its algorithms, no deterministic flags;
  b  a, with torch.backends.cudnn.deterministic = True and
     torch.backends.cudnn.benchmark = False;
  c  b, with torch.use_deterministic_algorithms(True, warn_only=True) and
     CUBLAS_WORKSPACE_CONFIG=:4096:8 set before the first cuBLAS call; each
     op that has no deterministic form warns instead of raising, and the
     warnings are listed (torch.empty's memory is not filled first, as in
     runtime.deterministic);
  d  c, with kernel 6 as csrc/gather.cu has it (in a fixed order): the
     port as it is, runtime.deterministic.

Prints each run's line from resume_noise.py, then per setting the largest
distance of B and of C from A per part (max abs relative to each tensor's
largest) and how many runs were A's bits exactly. With --cost, PAIRS pairs
of processes in turns (a, d, then d, a): phase 12's bare training step
(ResNet-50, B=64, median of 5) and phase 13's run A (ms per trainer step,
median of steps 2-4). Every line names the card and its power limit.
"""

import ctypes
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SETTINGS = ('a', 'b', 'c', 'd')
ATOMIC_SOURCE = ROOT / 'tools' / 'scatter_atomic.cu'
ATOMIC_CLUSTER, ATOMIC_BLOCKS = 8, 132
PARTS = ('params', 'mu', 'nu', 'fits')


def plan(B: int, V: int, Q: int):
    """(C, S, P) of the atomic kernel: C blocks per batch item (one
    thread-block cluster, at most 8), S rows each block zeroes, P
    contributions each adds; as many blocks as fill the 132 SMs once."""
    C = max(1, min(ATOMIC_CLUSTER, ATOMIC_BLOCKS // B, V))
    return C, -(-V // C), -(-Q // C)


def atomic_scatter(build_dir: Path):
    """A wrapper with scatter_add_rows_cuda's contract that launches the
    atomic kernel 6 (built from tools/scatter_atomic.cu into build_dir) and
    counts its launches."""
    import torch

    from tuch_tpu_torch.ops import _build
    from tuch_tpu_torch.ops import gather as G
    lib_path = build_dir / 'libscatter_atomic.so'
    if not lib_path.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, '-o',
                        str(lib_path), str(ATOMIC_SOURCE)], check=True,
                       capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.tuch_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tuch_cuda_error_string.restype = ctypes.c_char_p
    fn = lib.tuch_scatter_add_rows
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def scatter_add_rows_atomic(contrib, idx, num_rows):
        G._check(contrib, idx, 'scatter_add_rows_atomic')
        B, Q, _ = contrib.shape
        if B * Q == 0 or num_rows == 0:
            return contrib.new_zeros((B, num_rows, 3))
        G.check_sizes(B, Q, num_rows, 'scatter_add_rows_atomic')
        out = torch.empty((B, num_rows, 3), dtype=contrib.dtype,
                          device=contrib.device)
        err = G._launch(fn, contrib.device, contrib.data_ptr(),
                        idx.data_ptr(), out.data_ptr(), B, num_rows, Q,
                        *plan(B, num_rows, Q))
        _build.check(lib, err, 'atomic scatter kernel launch')
        scatter_add_rows_atomic.launches += 1
        return out

    scatter_add_rows_atomic.launches = 0
    return scatter_add_rows_atomic


def apply(setting: str):
    """Put `setting` in place for this process: d is runtime.deterministic
    as the port has it; a-c set their flags now and in its place (cli/train's
    build calls it), with the atomic kernel 6 in ops/gather's place."""
    import torch

    from tuch_tpu_torch import runtime as rt
    from tuch_tpu_torch.ops import gather as G

    def flags(device=None):
        torch.backends.cudnn.deterministic = setting != 'a'
        torch.backends.cudnn.benchmark = False if setting != 'a' else \
            torch.backends.cudnn.benchmark
        if setting == 'c':
            torch.use_deterministic_algorithms(True, warn_only=True)
            torch.utils.deterministic.fill_uninitialized_memory = False
    if setting == 'd':
        rt.deterministic('cuda')
        return
    flags()
    rt.deterministic = flags
    G.scatter_add_rows_cuda = atomic_scatter(ROOT / 'build' /
                                             'determinism_settings')


def child(setting: str, mode: str, arg: int) -> int:
    import torch
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / 'tools'))
    import chip_smoke as CS
    warnings.simplefilter('always')
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        apply(setting)
        if mode == 'noise':
            import resume_noise
            sys.argv = ['resume_noise.py', str(arg)]
            rc = resume_noise.main()
        else:
            rc = cost(CS)
    seen = sorted({str(w.message).split('\n')[0][:300] for w in caught
                   if 'determinis' in str(w.message)})
    print(json.dumps({'setting': setting, 'nondeterministic_ops': seen,
                      'cudnn_deterministic':
                      torch.backends.cudnn.deterministic,
                      'deterministic_algorithms':
                      torch.are_deterministic_algorithms_enabled()}),
          flush=True)
    return rc


def cost(CS) -> int:
    """Phase 12's bare step and phase 13's run A under this process's
    setting; one JSON line."""
    import shutil

    import numpy as np
    import torch

    from tuch_tpu_torch import runtime as rt
    card = CS.card_line()
    fit_rt = rt.build_runtime(device=CS.DEV, synthetic=True,
                              with_contact=True, with_hd=True)
    bare = CS.phase_train_times(fit_rt, 'resnet50', card,
                                {'winding': {'max_abs_err': 0.0}})
    shutil.rmtree(CS.TRAIN_LOG_DIR, ignore_errors=True)
    hmr = rt.build_runtime(device=CS.DEV, synthetic=True).hmr
    _, rec, _ = CS.train_run('A', 'resnet50', fit_rt, hmr,
                             CS.train_counters())
    it = CS.iteration_ms(rec)
    shutil.rmtree(CS.TRAIN_LOG_DIR, ignore_errors=True)
    print(json.dumps({'cost': True, 'bare_step_ms': float(bare),
                      'trainer_step_ms': float(np.median(it[1:4])),
                      'trainer_steps_ms': [round(x, 3) for x in it],
                      'cudnn_tf32': torch.backends.cudnn.allow_tf32,
                      'card': card}), flush=True)
    return 0


def run_child(setting, mode, arg):
    """The child's JSON lines (its other output passed through)."""
    env = dict(os.environ)
    env.pop('CUBLAS_WORKSPACE_CONFIG', None)
    if setting in 'cd':
        env['CUBLAS_WORKSPACE_CONFIG'] = ':4096:8'
    proc = subprocess.run([sys.executable, __file__, '--child', setting,
                           mode, str(arg)], cwd=ROOT, env=env,
                          capture_output=True, text=True)
    sys.stderr.write(proc.stderr[-4000:])
    lines = []
    for line in proc.stdout.splitlines():
        print(f'[{setting} {mode}] {line}', flush=True)
        if line.startswith('{'):
            lines.append(json.loads(line))
    if proc.returncode:
        raise RuntimeError(f'setting {setting} ({mode}) exited '
                           f'{proc.returncode}')
    return lines


def main(argv) -> int:
    if argv[:1] == ['--child']:
        return child(argv[1], argv[2], int(argv[3]))
    import torch
    if not torch.cuda.is_available():
        print('determinism_settings: no CUDA device; nothing was run',
              file=sys.stderr)
        return 1
    pairs = 0
    if '--cost' in argv:
        at = argv.index('--cost')
        pairs = int(argv[at + 1])
        argv = argv[:at] + argv[at + 2:]
    repeats = int(argv[0]) if argv else 6
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    summary = {}
    for setting in (SETTINGS if repeats else ()):
        lines = run_child(setting, 'noise', repeats)
        runs = [x for x in lines if 'run' in x]
        ops = next(x for x in lines if 'setting' in x)
        summary[setting] = {
            tag: {'max': {p: max(r['distance'][p] for r in runs
                                 if r['run'][0] == tag) for p in PARTS},
                  'bit_for_bit': sum(r['bit_for_bit'] for r in runs
                                     if r['run'][0] == tag),
                  'runs': sum(r['run'][0] == tag for r in runs)}
            for tag in 'BC'}
        summary[setting]['nondeterministic_ops'] = \
            ops['nondeterministic_ops']
        print(json.dumps({'setting': setting, **summary[setting],
                          'card': card}), flush=True)
    costs = {'a': [], 'd': []}
    for i in range(pairs):
        for setting in (('a', 'd') if i % 2 == 0 else ('d', 'a')):
            got = [x for x in run_child(setting, 'cost', 0) if 'cost' in x]
            costs[setting].append(got[0])
    if pairs:
        import numpy as np
        print(json.dumps({
            'cost': {s: {'bare_step_ms': [c['bare_step_ms'] for c in v],
                         'trainer_step_ms': [c['trainer_step_ms']
                                             for c in v],
                         'median_bare': float(np.median(
                             [c['bare_step_ms'] for c in v])),
                         'median_trainer': float(np.median(
                             [c['trainer_step_ms'] for c in v]))}
                     for s, v in costs.items()}, 'card': card}),
            flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
