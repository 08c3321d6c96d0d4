#!/usr/bin/env python3
"""Where kernel 4 (the masked nearest vertex) spends its time, by building
variants of it.

    python3 tools/masked_min_variants.py      # from the repository root, one card

Builds tuch_tpu_torch/csrc/masked_min.cu as it is and variants of it with
nvcc, one set of text substitutions per variant (every occurrence): other
bodies per block (G), queries per thread (R) and searched vertices per
unrolled step (JU), the index kept pair by pair (a compare and two selects,
the first design) instead of found again in the step where the min last
fell, a prefetch of the next mask word, d² unfused (the plain version's
arithmetic), the mask as bytes (rows padded to 32 bytes, read 16 at a time)
instead of bits, and parts compiled out (the mask test, the step tracking,
the min, the shared loads);
and the first port's kernel from tools/masked_min_trials.cu. Times each on the
SMPLify-DC slice's inputs (the synthetic 6890-vertex body posed from seed 99
at B=64 and B=4, its geodesic mask, as chip_smoke.py phase 7): the median of
five CUDA-graph replays, device time. Variants marked "wrong" compute a
wrong answer and only their time is read; every other one is held to the
plain version with chip_smoke.py's bars (d² rtol 1e-6, another argmin only
at a tie within it, every pick allowed). Prints the card's name and power
limit first, each build's registers, the kernel's SASS instruction counts
by opcode, and the kernel as it is at several split targets.
"""

import ctypes
import re
import shutil
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / 'tools'))

from slice_variants import card_line, finish, median_ms, start  # noqa: E402
from tuch_tpu_torch.ops import contact_kernels as CK  # noqa: E402

CSRC = ROOT / 'tuch_tpu_torch' / 'csrc'
D2_RTOL = 1e-6
G4, R2 = 'constexpr int G = 4;', 'constexpr int R = 2;'
JU16 = 'constexpr int JU = 16;'
PEN = '            const float pen = (mw[k] >> j) & 1u ? 0.f : INF;'
UPDATE = '              best[g][k] = fminf(best[g][k], d2);'
STEP = 'if (best[g][k] < before[g][k]) step[g][k] = mb;'
# the redesign's first form: the index kept pair by pair (a compare, two
# selects)
PER_PAIR = [(UPDATE, '''              if (d2 < best[g][k]) {
                best[g][k] = d2;
                step[g][k] = mb + j;
              }'''), (STEP, ';'),
            ('const int a = first_at(', 'const int a = step[g][k]; '
             '(void)first_at(')]
UNFUSED = [('  return fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, pen)));',
            '  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), pen), '
            '__fmul_rn(dy, dy)),\n                   __fmul_rn(dz, dz));')]
# the next word loaded while this one is consumed
PREFETCH = [('''      uint32_t mw[R];
#pragma unroll
      for (int k = 0; k < R; ++k) mw[k] = mask_word(row[k], (m0 >> 5) + w);''',
             '''      uint32_t mw[R];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        mw[k] = next[k];
        if (w + 1 < nw) next[k] = mask_word(row[k], (m0 >> 5) + w + 1);
      }'''),
            ('''    const int nw = (n + 31) >> 5;\n''',
             '''    const int nw = (n + 31) >> 5;
    uint32_t next[R];
#pragma unroll
    for (int k = 0; k < R; ++k) next[k] = mask_word(row[k], m0 >> 5);
''')]
# the searched points as x, y and z quads (3 loads for 4 points, not 4)
QUADS = [('__shared__ float4 pts[G][TM];',
          '__shared__ float4 qsx[G][TM / 4], qsy[G][TM / 4], qsz[G][TM / 4];'),
         ('''      float4 p = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < n) {
        const float* v =
            verts + ((int64_t)min(b0 + g, B - 1) * V + m0 + j) * 3;
        p = make_float4(v[0], v[1], v[2], 0.f);
      }
      pts[g][j] = p;''', '''      float x = 0.f, y = 0.f, z = 0.f;
      if (j < n) {
        const float* v =
            verts + ((int64_t)min(b0 + g, B - 1) * V + m0 + j) * 3;
        x = v[0];
        y = v[1];
        z = v[2];
      }
      reinterpret_cast<float*>(qsx[g])[j] = x;
      reinterpret_cast<float*>(qsy[g])[j] = y;
      reinterpret_cast<float*>(qsz[g])[j] = z;'''),
         ('#pragma unroll\n        for (int j = 0; j < JU; ++j) {',
          'float4 X[G], Y[G], Z[G];\n#pragma unroll\n        for (int j = 0; '
          'j < JU; ++j) {'),
         ('          for (int g = 0; g < G; ++g) p[g] = pts[g][mb - m0 + j];',
          '''          for (int g = 0; g < G; ++g) {
            if ((j & 3) == 0) {
              const int e = (mb - m0 + j) >> 2;
              X[g] = qsx[g][e];
              Y[g] = qsy[g][e];
              Z[g] = qsz[g][e];
            }
            p[g] = make_float4(lane(X[g], j & 3), lane(Y[g], j & 3),
                               lane(Z[g], j & 3), 0.f);
          }'''),
         ('__global__ void __launch_bounds__(T)',
          '''__device__ __forceinline__ float lane(float4 v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(T)''')]
# rows of 32 W bytes (one byte per pair, 1 = allowed): 32 bytes per word,
# packed into the word's bits after two 16-byte loads
BYTES = [('  return row[w];', '''  const uint4* p = reinterpret_cast<const uint4*>(row) + 2 * w;
  const uint4 a = p[0], b = p[1];
  const uint32_t x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t r = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    r |= ((x[i] & 1u) | ((x[i] >> 7) & 2u) | ((x[i] >> 14) & 4u) |
          ((x[i] >> 21) & 8u)) << (4 * i);
  return r;'''),
         ('row[k] = bits + (int64_t)q * W;',
          'row[k] = bits + (int64_t)q * W * 8;')]


def shape(g, r):
    return [(G4, f'constexpr int G = {g};'), (R2, f'constexpr int R = {r};')]


# name -> (substitutions, mask: 'bits' or 'bytes', computes the full answer)
VARIANTS = {'kernel': ([], 'bits', True)}
VARIANTS.update({f'G={g} R={r}': (shape(g, r), 'bits', True)
                 for g, r in ((4, 1), (2, 2), (8, 2), (1, 4), (2, 4),
                              (4, 4), (1, 8), (2, 8))})
VARIANTS.update({f'JU={ju}': ([(JU16, f'constexpr int JU = {ju};')], 'bits',
                              True) for ju in (8, 32)})
VARIANTS.update({
    'index pair by pair (a compare, two selects)': (PER_PAIR, 'bits', True),
    'index pair by pair, G=4 R=1': (PER_PAIR + shape(4, 1), 'bits', True),
    'prefetch of the next word': (PREFETCH, 'bits', True),
    'points as quads': (QUADS, 'bits', True),
    'points as quads, G=2 R=4': (QUADS + shape(2, 4), 'bits', True),
    'points as quads, G=4 R=4': (QUADS + shape(4, 4), 'bits', True),
    'unfused d2 (the plain arithmetic)': (UNFUSED, 'bits', True),
    'byte mask': (BYTES, 'bytes', True),
    'byte mask, unfused d2': (BYTES + UNFUSED, 'bytes', True),
    'no mask test (wrong)': ([(PEN, '            const float pen = 0.f;')],
                             'bits', False),
    'no step tracking (wrong index)': ([(STEP, ';')], 'bits', False),
    'no min, a sum (wrong)': ([(UPDATE, '              best[g][k] += d2;')],
                              'bits', False),
    'no shared loads (wrong)': ([('p[g] = pts[g][mb - m0 + j];',
                                  'p[g] = make_float4(qy[g][0] * (float)j, '
                                  'qz[g][0], qx[g][0], 0.f);')], 'bits',
                                False),
})
TARGETS = (132 * 4, 132 * 8, 132 * 16, 132 * 32)   # blocks the plan aims at
ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
OLD_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def check(err, what):
    if err:
        raise RuntimeError(f'{what}: CUDA error {err}')


def registers(log: str):
    return [ln.split(':', 1)[1].strip() for ln in log.splitlines()
            if 'registers' in ln]


def sass_counts(lib: Path, kernel='masked_min_kernel'):
    """Opcode -> count over `kernel`'s SASS in `lib` (cuobjdump)."""
    tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    out = subprocess.run([tool, '-sass', str(lib)], capture_output=True,
                         text=True).stdout
    parts = out.split('Function : ')
    body = next((p for p in parts if p.split('\n', 1)[0].strip().endswith(
        kernel) or kernel in p.split('\n', 1)[0]), '')
    ops = Counter()
    for line in body.splitlines():
        m = re.search(r'\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)', line)
        if m:
            ops[m.group(2).split('.')[0]] += 1
    return ops


def inputs(B, seed=99):
    from tuch_tpu_torch import runtime as rt
    from tuch_tpu_torch.models.smpl import smpl_forward
    run = rt.build_runtime(device='cuda', synthetic=True, with_contact=True)
    pose = torch.as_tensor((np.random.RandomState(seed).randn(B, 72) * 0.3)
                           .astype(np.float32), device='cuda')
    with torch.no_grad():
        verts = smpl_forward(run.smpl, torch.zeros(B, 10, device='cuda'),
                             pose[:, 3:], pose[:, :3]).vertices.contiguous()
    return verts, run.contact


def held(verts, mask, want, d2, arg):
    """(max relative d² error, argmins that differ, within the bars)."""
    want_d2, want_arg = want
    fin = torch.isfinite(want_d2)
    if not torch.equal(fin, torch.isfinite(d2)):
        return float('inf'), -1, False
    rel = ((d2 - want_d2).abs()[fin] / want_d2[fin].clamp_min(1e-30))
    diff = verts - torch.gather(verts, 1, arg.long()[..., None].expand(
        -1, -1, 3))
    pick = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] \
        + diff[..., 2] * diff[..., 2]
    differ = (arg != want_arg) & fin
    ties = ((pick - want_d2).abs()[differ]
            <= D2_RTOL * want_d2[differ]).all().item()
    rows = torch.arange(verts.shape[1], device=verts.device)
    allowed = (mask[rows[None].expand_as(arg), arg.long()] > 0)[fin].all()
    ok = bool(((d2 - want_d2).abs()[fin] <= D2_RTOL * want_d2[fin]).all()
              and ties and allowed)
    return rel.max().item(), differ.sum().item(), ok


def run_batch(B, fns, old, shapes, verts, contact):
    from tuch_tpu_torch.ops import contact as PC
    mask, bits = contact.geomask, contact.geomask_bits
    V = verts.shape[1]
    W = -(-V // 32)
    byte_rows = torch.zeros((V, 32 * W), dtype=torch.uint8, device='cuda')
    byte_rows[:, :V] = mask != 0
    want = [torch.cat(t) for t in zip(*(
        PC.masked_min_dist(verts[i:i + 16], mask)
        for i in range(0, B, 16)))]
    d2 = torch.empty((B, V), device='cuda')
    arg = torch.empty((B, V), dtype=torch.int32, device='cuda')
    allowed = int(mask.sum().item())
    bound_ms = 1e3 * B * (V * V + 9 * allowed) / 67e12
    launches = 10 if B >= 16 else 50

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def report(name, call, full, extra=''):
        ms = median_ms(call, launches, 5, graph=True)
        d2.fill_(float('nan'))
        call()
        torch.cuda.synchronize()
        tail = ' (wrong: time only)'
        if full:
            rel, differ, ok = held(verts, mask, want, d2, arg)
            tail = (f', d2 rel err {rel:.3g}, argmin differs at {differ}'
                    f'{"" if ok else " -- FAILS THE BARS"}')
        print(f'[masked_min B={B}] {name}: {ms:.4f} ms, {bound_ms / ms:.1%} '
              f'of the {bound_ms:.4f} ms bound{extra}{tail}', flush=True)
        return ms

    chunk, splits = CK._split(B * -(-V // 128), V, 256)
    mask_t = mask.t().contiguous()      # the first kernel reads it transposed
    keys = torch.empty((B, splits, V), dtype=torch.int64, device='cuda')
    for name, fn in old.items():
        report(name, lambda fn=fn: check(fn(
            verts.data_ptr(), mask_t.data_ptr(), keys.data_ptr(),
            d2.data_ptr(), arg.data_ptr(), B, V, chunk, stream()), name),
            True, f' (splits {splits})')
    for name, fn in fns.items():
        subs, kind, full = VARIANTS[name]
        targets = TARGETS if name == 'kernel' else (CK.TARGET_BLOCKS,)
        for target in targets:
            T, R, G, TM = shapes[name]
            chunk, splits = CK._split(-(-B // G) * -(-V // (T * R)), V, TM,
                                      target)
            keys = torch.empty((B, splits, V), dtype=torch.int64,
                               device='cuda')
            src = (bits if kind == 'bits' else byte_rows).data_ptr()
            blocks = -(-B // G) * -(-V // (T * R)) * splits
            tag = '' if target == CK.TARGET_BLOCKS else \
                f', target {target} blocks'
            report(f'{name}{tag}', lambda fn=fn, chunk=chunk, keys=keys,
                   src=src: check(fn(
                       verts.data_ptr(), src, keys.data_ptr(), d2.data_ptr(),
                       arg.data_ptr(), B, V, W, chunk, stream()), name),
                   full, f' (splits {splits}, {blocks} blocks)')


def main() -> int:
    if not torch.cuda.is_available():
        print('masked_min_variants: no CUDA device', file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    logs = {}
    with tempfile.TemporaryDirectory() as tmp:
        builds = start(Path(tmp), CSRC / 'masked_min.cu',
                       {k: v[0] for k, v in VARIANTS.items()})
        trial = start(Path(tmp), ROOT / 'tools' / 'masked_min_trials.cu',
                      {'first port kernel (byte mask, 64-bit keys)': []},
                      flags=True)
        fns = finish('masked_min', builds, 'tuch_masked_min', ARGS, logs)
        old = finish('trials', trial, 'trial_masked_min_old', OLD_ARGS, logs)
        shapes = {}
        for name in fns:
            out = (ctypes.c_int * 4)()
            ctypes.CDLL(str(builds[name][0])).tuch_masked_min_shape(out)
            shapes[name] = tuple(out)
        for name, log in logs.items():
            print(f'[build] {name}: {registers(log)}', flush=True)
        for name in ('kernel', 'index pair by pair (a compare, two selects)',
                     'unfused d2 (the plain arithmetic)'):
            ops = sass_counts(builds[name][0])
            print(f'[sass] {name}: {sum(ops.values())} instructions; '
                  + ', '.join(f'{k} {v}' for k, v in ops.most_common(16)),
                  flush=True)
        for B in (64, 4):
            verts, contact = inputs(B)
            run_batch(B, fns, old, shapes, verts, contact)
            del verts, contact
            torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
