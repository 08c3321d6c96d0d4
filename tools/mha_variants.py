#!/usr/bin/env python3
"""Where the attention kernel's time goes, by compiling parts of it out.

    python3 tools/mha_variants.py      # from the repository root, one card

Builds tuch_tpu_torch/csrc/mha.cu as it is and four variants of it with nvcc,
each with one part of the key loop compiled out or swapped (the S = Q K^T
product, the online softmax, the P V product, or IEEE exp2f for the
special-function exponential), and times each at the ViT-S/16 serving shape
(B=64, N=196, C=384, H=6) in both dtypes: the median of five CUDA-graph
replays of 20 launches, device time only. A variant computes the wrong
answer; only its time is read. The difference to the kernel as it is bounds
what that part costs. Prints the card's name and power limit first.
"""

import ctypes
import math
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / 'tuch_tpu_torch' / 'csrc' / 'mha.cu'
SHAPE = dict(B=64, N=196, C=384, H=6)
# name -> the preprocessor symbols the variant defines
VARIANTS = {'kernel': [], 'no S product': ['SKIP_S'],
            'no softmax': ['SKIP_SOFTMAX'], 'no P V product': ['SKIP_PV'],
            'IEEE exp2f': ['IEEE_EXP']}
# (marker in mha.cu, text put before it): the guards the symbols switch
GUARDS = [
    ('      if constexpr (L::BF16) {\n#pragma unroll\n        for (int kk = 0;'
     ' kk < HD / 16; ++kk) {', '#ifndef SKIP_S\n'),
    ('      if (k0 + BK > N) {', '#endif\n'),
    ('      // online softmax', '#ifndef SKIP_SOFTMAX\n'),
    ('      // O += P V\n', '#endif\n#ifndef SKIP_PV\n'),
    ('    }\n    __syncthreads();   // the tile is consumed', '#endif\n'),
    ('__device__ __forceinline__ uint32_t pack_bf16',
     '#ifdef IEEE_EXP\n#define exp2_approx(x) exp2f(x)\n#endif\n'),
]


def guarded_source() -> str:
    src = SOURCE.read_text()
    for marker, before in GUARDS:
        if src.count(marker) != 1:
            raise RuntimeError(f'mha.cu changed: marker {marker[:40]!r}')
        src = src.replace(marker, before + marker)
    return src


def build(workdir: Path):
    src = workdir / 'mha_variants.cu'
    src.write_text(guarded_source())
    procs = {}
    for name, symbols in VARIANTS.items():
        lib = workdir / f'lib{len(procs)}.so'
        cmd = ['nvcc', '-gencode', 'arch=compute_90a,code=sm_90a',
               '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC',
               *(f'-D{s}' for s in symbols), '-o', str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f'nvcc failed for {name}:\n{log}')
        fn = ctypes.CDLL(str(lib)).tuch_mha_forward
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def graph_ms(fn, iters=20, repeats=5):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(repeats):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[repeats // 2]


def main() -> int:
    if not torch.cuda.is_available():
        print('mha_variants: no CUDA device', file=sys.stderr)
        return 1
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(Path(tmp))
        B, N, C, H = SHAPE['B'], SHAPE['N'], SHAPE['C'], SHAPE['H']
        gen = torch.Generator(device='cuda').manual_seed(0)
        for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            x = torch.randn(B, N, 3 * C, device='cuda', generator=gen)
            x = x.to(dtype)
            out = torch.empty(B, N, C, device='cuda', dtype=dtype)
            times = {}
            for name, fn in fns.items():
                def call(fn=fn):
                    err = fn(x.data_ptr(), out.data_ptr(), B, N, H, C // H,
                             code, 1.0 / math.sqrt(C // H),
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f'{name}: CUDA error {err}')
                times[name] = graph_ms(call)
            base = times['kernel']
            for name, ms in times.items():
                print(f'[mha {str(dtype)[6:]} B={B} N={N} C={C} H={H}] '
                      f'{name}: {ms:.4f} ms ({ms - base:+.4f} against the '
                      f'kernel)', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
