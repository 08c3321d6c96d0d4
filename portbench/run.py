"""The benchmark of tuch_tpu_torch on one NVIDIA H100.

  python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
      --trace <0|1>

runs one cell of BENCHMARK.json from the root of a checkout and prints, as
the last line of its standard output, one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics with --trace 0, its
per-layer metrics with --trace 1), device, breakdown (--trace 1) and, last,
checks (each number compared with the plain reference, beside its limit).
The same numbers end standard error.

Everything is found by name: the cell's configuration file (configs/), its
traffic mix (workloads/<traffic>.json, whose "driver" names a module of
drivers/), and each per-layer metric's reader (metrics/<name>.py). A run
without a CUDA card, or with fewer cards than the cell asks for, exits 2
and prints no result; so does one in which jax, jaxlib, flax or tuch_tpu
was imported. --control runs the cell's control (the nearest lower
precision, which the comparison must find not correct); the benchmark's
own runs never pass it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'tuch_tpu')


class NoResult(Exception):
    """A run that must exit non-zero and print no result line."""


def forbidden_modules():
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole: tuch_tpu_torch is not tuch_tpu."""
    return sorted({m for m in list(sys.modules)
                   if m.split('.')[0] in FORBIDDEN})


def set_environment():
    """Before numpy or torch load: every build and kernel cache inside the
    checkout, at fixed paths (the program's own nvcc libraries are
    content-hashed under build/tuch_tpu_torch/ at the checkout's root
    already), no library pulled in for JAX, and one thread for each
    math library's pool, so that no idle pool spins on the cores the
    host-bound paths launch from."""
    cache = ROOT / 'build' / 'portbench'
    os.environ['TORCH_EXTENSIONS_DIR'] = str(cache / 'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = str(cache / 'triton')
    os.environ['USE_FLAX'] = '0'
    os.environ['USE_JAX'] = '0'
    for var in ('OMP_NUM_THREADS', 'OPENBLAS_NUM_THREADS', 'MKL_NUM_THREADS'):
        os.environ[var] = '1'


def pin_threads():
    """Give the main thread, which launches the program's device work, a
    physical core of its own: the main thread on the first core the
    process may use, every other thread of the process (autograd's
    among them) on the cores that are not that core or its hyperthread
    sibling. Threads started later inherit their starter's cores."""
    cpus = sorted(os.sched_getaffinity(0))
    path = f'/sys/devices/system/cpu/cpu{cpus[0]}/topology/thread_siblings_list'
    try:
        with open(path) as f:
            spec = f.read().strip()
        siblings = set()
        for part in spec.split(','):
            lo, _, hi = part.partition('-')
            siblings.update(range(int(lo), int(hi or lo) + 1))
    except (OSError, ValueError):
        siblings = {cpus[0]}
    others = [c for c in cpus if c not in siblings]
    if len(others) < 2:
        return
    me = threading.get_native_id()
    for tid in os.listdir('/proc/self/task'):
        try:
            os.sched_setaffinity(int(tid), {cpus[0]} if int(tid) == me
                                 else set(others))
        except OSError:        # a thread that has ended meanwhile
            pass


def load_cell(name: str):
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    cells = {w['name']: w for w in bench['workloads']}
    if name not in cells:
        raise NoResult(f'no workload {name!r} in BENCHMARK.json; have '
                       f'{sorted(cells)}')
    cell = cells[name]
    config = next(c for c in bench['configs'] if c['name'] == cell['config'])
    cfg = json.loads((ROOT / config['file']).read_text())
    traffic = json.loads(
        (HERE / 'workloads' / f'{cell["traffic"]}.json').read_text())
    e2e = [m for m in bench['end_to_end']
           if name in m.get('workloads', [name])]
    per_layer = [m for m in bench['per_layer']
                 if name in m.get('workloads', [name])]
    return cell, cfg, traffic, e2e, per_layer


def load_reader(metric: str):
    """metrics/<metric>.py's read(ctx) -> float or None."""
    path = HERE / 'metrics' / f'{metric}.py'
    spec = importlib.util.spec_from_file_location(
        'portbench_metric_' + metric.replace('.', '_').replace('-', '_'),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def device_info(chips: int):
    import torch
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
            'count': chips,
            'memory_peak_bytes': max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}


def card_line() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return 'nvidia-smi unavailable'


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    p.add_argument('--control', action='store_true',
                   help="run the cell's control in the program's place")
    return p.parse_args(argv)


def run(args, stdout=sys.stdout, stderr=sys.stderr) -> int:
    cell, cfg, traffic, e2e, per_layer = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell['chips']:
        raise NoResult(f'{args.workload} needs {cell["chips"]} CUDA '
                       f'card(s); torch sees '
                       f'{torch.cuda.device_count()} (is_available '
                       f'{torch.cuda.is_available()})')
    tmp = Path(tempfile.mkdtemp(prefix='portbench-'))
    bench = None
    try:
        driver = importlib.import_module(
            f'portbench.drivers.{traffic["driver"]}')
        ctx = dict(root=ROOT, cell=cell, config=cfg, traffic=traffic,
                   seed=args.seed, seconds=args.seconds,
                   control=args.control, tmp=tmp, device='cuda')
        bench = driver.Cell(ctx)
        bench.setup()
        torch.cuda.synchronize()
        pin_threads()
        setup_s = time.perf_counter() - T_START
        prof = None
        if args.trace:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
        result = bench.window(args.seconds, prof)
        device = device_info(cell['chips'])
        values = {'setup_s': setup_s, **result['e2e']}
        ctx['result'] = result
        breakdown = None
        t_trace = time.perf_counter()
        if prof is not None:
            from portbench.common import Trace
            trace = Trace(prof, bench.span_prefixes)
            device['busy_s'] = trace.busy_s()
            device['window_s'] = trace.window_s()
            ctx['trace'] = trace
            breakdown = {'device_ops': [list(kv) for kv in trace.top_ops()],
                         'idle_gaps': [list(kv) for kv in trace.idle_gaps()]}
            del prof
        t_trace = time.perf_counter() - t_trace
        bench.release()
        t_check = time.perf_counter()
        checks = bench.check()
        t_check = time.perf_counter() - t_check
        correct = all(c['value'] <= c['limit'] for c in checks)
        if args.trace:
            metrics = {}
            for m in per_layer:
                v = load_reader(m['name'])(ctx)
                if v is not None:
                    metrics[m['name']] = {'value': v, 'unit': m['unit']}
        else:
            metrics = {m['name']: {'value': values[m['name']],
                                   'unit': m['unit']} for m in e2e}
        found = forbidden_modules()
        if found:
            raise NoResult(f'modules of {FORBIDDEN} were imported: {found}')
        line = {'correct': correct, 'attempted': result['attempted'],
                'failed': result['failed'], 'metrics': metrics,
                'device': device}
        if breakdown is not None:
            line['breakdown'] = breakdown
        line['checks'] = {c['name']: {'value': c['value'],
                                      'limit': c['limit']} for c in checks}
        print(f'[portbench] {args.workload} seed {args.seed}: card '
              f'{card_line()}; setup_s {setup_s}; {result.get("note", "")}; '
              f'trace reduced in {t_trace:.1f} s, reference and comparison '
              f'{t_check:.1f} s',
              file=stderr, flush=True)
        for c in checks:
            print(f'[check] {c["name"]} {c["value"]!r} limit '
                  f'{c["limit"]!r}', file=stderr, flush=True)
        print(json.dumps(line), file=stdout, flush=True)
        return 0
    finally:
        if bench is not None:
            bench.release()
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    set_environment()
    args = parse_args(argv)
    sys.path.insert(0, str(ROOT))
    try:
        return run(args)
    except NoResult as e:
        print(f'[portbench] no result: {e}', file=sys.stderr, flush=True)
        return 2


if __name__ == '__main__':
    sys.exit(main())
