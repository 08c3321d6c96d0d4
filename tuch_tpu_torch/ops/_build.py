"""Build the CUDA sources in tuch_tpu_torch/csrc/ and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with nvcc into
``build/tuch_tpu_torch/lib<name>-<hash>.so`` at the repository root, on first
use. The hash covers the sources and the flags, so an edited kernel is
rebuilt and a stale library is never loaded. Several sources build in
parallel, one nvcc process each. Nothing here runs at import time, so the
module imports on a host without nvcc.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'tuch_tpu_torch'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_lock = threading.Lock()
_libs = {}
# name -> nvcc output (ptxas: registers, shared memory, spills) of the build
# this process ran; empty for a library that was already on disk
BUILD_LOG = {}


def sources():
    """Names of the kernels in csrc/ (file stems of the .cu sources)."""
    return sorted(p.stem for p in CSRC.glob('*.cu'))


def _nvcc() -> str:
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.isfile(path):
        raise RuntimeError('nvcc not found (PATH or /usr/local/cuda/bin); '
                           'the CUDA kernels of tuch_tpu_torch need the CUDA '
                           'toolkit to build')
    return path


def library_path(name: str) -> Path:
    src = CSRC / f'{name}.cu'
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for p in [src] + sorted(CSRC.glob('*.cuh')):
        digest.update(p.read_bytes())
    return BUILD_DIR / f'lib{name}-{digest.hexdigest()[:16]}.so'


def build(names=None) -> float:
    """Compile every named source that is not built yet; returns seconds.

    All nvcc processes start together and each is waited for; the first
    failure raises with the compiler's output after the others finished.
    """
    t0 = time.perf_counter()
    names = sources() if names is None else list(names)
    todo = [(n, library_path(n)) for n in names
            if not library_path(n).exists()]
    if not todo:
        return time.perf_counter() - t0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, out in todo:
        tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
        cmd = [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode == 0:
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
        else:
            failed.append(f'nvcc failed for {name} '
                          f'(exit {proc.returncode}):\n{log}')
    if failed:
        raise RuntimeError('\n'.join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
            lib.tuch_cuda_error_string.argtypes = [ctypes.c_int]
            lib.tuch_cuda_error_string.restype = ctypes.c_char_p
        return lib


def check(lib: ctypes.CDLL, err: int, what: str):
    """Raise on a non-zero cudaError_t returned by a kernel's C entry."""
    if err:
        msg = lib.tuch_cuda_error_string(err).decode()
        raise RuntimeError(f'{what}: CUDA error {err} ({msg})')
