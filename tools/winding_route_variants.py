#!/usr/bin/env python3
"""Where kernels 3 (affine winding) and 7 (near field) spend their time, by
building variants of them.

    python3 tools/winding_route_variants.py      # from the repository root, one card

Builds tuch_tpu_torch/csrc/winding_affine.cu and csrc/winding_near.cu as
they are and variants of each with nvcc, one set of text substitutions per
variant (every occurrence, in the source and its copy of solid_angle.cuh):
2 or 8 queries per thread in place of 4, one shared-memory stage (no copy
in flight while the block computes) or three, IEEE atan2f in place of the
polynomial, sqrtf's guarded square roots in kernel 3 and the unguarded
tuch::sqrt_fast (with +0 kept) in kernel 7, and for kernel 3 FMA in the
four dots outside the corner mask (numer, dab, dbc, dac); and
tools/winding_route_trials.cu: the first port's
kernels 3 and 7 and kernel 3 with those four dots on the tensor cores
(3xTF32 mma.sync). One nvcc process each, all started together. Times each
on the posed synthetic 6890-vertex body from seed 99 (as chip_smoke.py
phase 11) at B=64 and B=4 by CUDA-graph replay, median of five (device
time), and holds every variant to the plain version with phase 11's bars:
kernel 3 max abs error <= 2e-5 and no in/out flip at 0.99, kernel 7 <=
2e-5 in winding units. A variant with the kernel's split plan is also
compared with the kernel bit for bit; and tuch::sqrt_fast with sqrtf on
every float from 2^-20 up.

Prints the card's name and power limit first, then each build's registers
and spills, and the SASS of each kernel's innermost loop that holds the
pairs (cuobjdump): instructions per pair by opcode, pairs counted by the
three square roots of a pair (MUFU.RSQ). Beside each time: the bound (the
operations at 67 TFLOP/s, as chip_smoke.py) and the issue ceiling, the
time the loop's instructions take at one instruction per lane per clock
on 132 SMs x 128 lanes, at the SM clock nvidia-smi reads while the B=64
kernels run.
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
from tuch_tpu_torch.ops import contact as PC  # noqa: E402
from tuch_tpu_torch.ops import contact_kernels as CK  # noqa: E402
from tuch_tpu_torch.ops import winding_hier as PH  # noqa: E402

CSRC = ROOT / 'tuch_tpu_torch' / 'csrc'
ATOL = 2e-5                 # chip_smoke.py AFFINE_ATOL and NEAR_ATOL
PEAK_FLOPS = 67e12          # fp32 outside the tensor cores, H100 SXM
SMS, LANES = 132, 128
AFFINE_OPS, NEAR_OPS = 69, 67     # per pair, counted in the sources
PLAIN_CHUNK = 16
NUM_NEAR = 16

QPT = 'constexpr int QPT = 4;'
STAGES = 'constexpr int STAGES = 2;'
COMMON = {
    'kernel': [],
    '2 per thread': [(QPT, 'constexpr int QPT = 2;')],
    '8 per thread': [(QPT, 'constexpr int QPT = 8;')],
    'one stage (no copy in flight)': [(STAGES, 'constexpr int STAGES = 1;')],
    'three stages': [(STAGES, 'constexpr int STAGES = 3;')],
}
DOT4_FMA = '''
// ((qx c.x + qy c.y) + qz c.z) + c.w in three FMA from c.w
__device__ __forceinline__ float dot4_fma(float qx, float qy, float qz,
                                          float4 c) {
  return fmaf(qz, c.z, fmaf(qy, c.y, fmaf(qx, c.x, c.w)));
}
'''
AFFINE = dict(COMMON, **{
    'guarded square roots (IEEE sqrtf)': [
        ('tuch::sqrt_fast(fmaxf(', 'sqrtf(fmaxf(')],
    'IEEE atan2f': [('const float ang = tuch::atan2_poly(numer, denom);',
                     'const float ang = atan2f(numer, denom);')],
    'FMA in numer, dab, dbc, dac': [
        ('// (1 mm)^2\n', '// (1 mm)^2\n' + DOT4_FMA)] + [
        (f'{name} = {pre}dot4(', f'{name} = {pre}dot4_fma(')
        for name, pre in (('numer', ''), ('dab', 'add('), ('dbc', 'add('),
                          ('dac', 'add('))],
})
NEAR = dict(COMMON, **{
    'IEEE atan2f': [('return atan2_poly(numer, denom);',
                     'return atan2f(numer, denom);')],
    # +0 at a corner as sqrtf gives; other bits below 2^-20 may differ
    'unguarded square roots, 0 kept (sqrt_fast)': [
        (f'sqrtf(sq_norm({v}))',
         f'(sq_norm({v}) > 0.f ? sqrt_fast(sq_norm({v})) : 0.f)')
        for v in ('ax, ay, az', 'bx, by, bz', 'cx, cy, cz')],
})
AFFINE_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
    + [ctypes.c_float, ctypes.c_void_p]
NEAR_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
OLD_AFFINE_SHAPE = (128, 1, 128)   # the first port's kernel 3
OLD_NEAR_SHAPE = (128, 1, 128)     # the first port's kernel 7


def check(err, what):
    if err:
        raise RuntimeError(f'{what}: CUDA error {err}')


def ptxas(log: str, kernel: str) -> str:
    lines = log.splitlines()
    at = next((i for i, ln in enumerate(lines)
               if 'Compiling entry function' in ln and kernel in ln), None)
    if at is None:
        return 'no ptxas line'
    tail = lines[at + 1:at + 5]
    spill = next((ln.strip() for ln in tail if 'spill' in ln), '')
    regs = next((ln.split(':', 1)[1].strip() for ln in tail
                 if 'registers' in ln), '')
    return f'{regs}; {spill}'


def sass(lib: Path, kernel: str):
    """(instructions of the innermost loop that holds the most pairs,
    pairs per iteration, opcode counts) of `kernel` in `lib`: the loops are
    the predicated backward branches; a pair takes three MUFU.RSQ."""
    tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    out = subprocess.run([tool, '-sass', str(lib)], capture_output=True,
                         text=True).stdout
    body = next((p for p in out.split('Function : ')[1:]
                 if kernel in p.split('\n', 1)[0]), '')
    code, labels = [], {}
    for line in body.splitlines():
        lab = re.match(r'\s*(\.L_x_\d+):', line)
        if lab:
            labels[lab.group(1)] = len(code)
        m = re.search(r'/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;', line)
        if m:
            code.append((int(m.group(1), 16), m.group(2)))
    at = {addr: i for i, (addr, _) in enumerate(code)}
    loops = []
    for i, (addr, text) in enumerate(code):
        m = re.match(r'@!?U?P\w+\s+BRA(?:\.\w+)*\s+(?:`\()?'
                     r'(0x[0-9a-f]+|\.L_x_\d+)', text)
        if not m:
            continue
        tgt = m.group(1)
        j = labels.get(tgt) if tgt.startswith('.L') else at.get(int(tgt, 16))
        if j is not None and j <= i:
            loops.append((j, i))
    inner = [lp for lp in loops if not any(
        o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]

    def opcode(text):
        op = re.sub(r'^@!?U?P\w+\s+', '', text).split()[0]
        return op if op.startswith('MUFU') else op.split('.')[0]

    best = None
    for lo, hi in inner:
        ops = Counter(opcode(t) for _, t in code[lo:hi + 1])
        ops.pop('NOP', None)
        rsq = sum(1 for _, t in code[lo:hi + 1] if 'MUFU.RSQ' in t)
        if rsq and (best is None or rsq > best[1]):
            best = (sum(ops.values()), rsq, ops)
    if best is None:
        return None
    n, rsq, ops = best
    return n, rsq / 3, ops


class ClockSampler:
    """nvidia-smi's clocks.sm every 100 ms while the block runs."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ['nvidia-smi', '--query-gpu=clocks.sm', '--format=csv,noheader,'
             'nounits', '-lms', '100'], stdout=subprocess.PIPE, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate()
        vals = sorted(float(v) for v in out.split() if v.strip().isdigit())
        self.mhz = vals[len(vals) // 2] if vals else None
        return False


def check_sqrt(lib):
    """Every float bit pattern in [2^-20, FLT_MAX], and in [smallest
    normal, 2^-20) for the record: where tuch::sqrt_fast differs from
    sqrtf."""
    fn = lib.trial_sqrt_mismatches
    fn.argtypes = [ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    edge = int(np.float32(2.0 ** -20).view(np.uint32))
    for lo, hi, what in ((edge, 0x7F7FFFFF, '[2^-20, FLT_MAX]'),
                         (0x00800000, edge - 1, '[2^-126, 2^-20)')):
        count = torch.tensor([0, -1], dtype=torch.int64, device='cuda')
        check(fn(lo, hi, count.data_ptr(),
                 torch.cuda.current_stream().cuda_stream), 'sqrt check')
        n, first = count.tolist()
        at = '' if n == 0 else \
            f', the least at {np.uint32(first).view(np.float32)!r}'
        print(f'[sqrt] sqrt_fast against sqrtf on every float in {what} '
              f'({hi - lo + 1} values): {n} differ{at}', flush=True)


def inputs(B, seed=99):
    from tuch_tpu_torch import runtime as rt
    from tuch_tpu_torch.models.smpl import smpl_forward
    run = rt.build_runtime(device='cuda', synthetic=True)
    smpl = run.smpl
    pose = torch.as_tensor((np.random.RandomState(seed).randn(B, 72) * 0.3)
                           .astype(np.float32), device='cuda')
    with torch.no_grad():
        verts = smpl_forward(smpl, torch.zeros(B, 10, device='cuda'),
                             pose[:, 3:], pose[:, :3]).vertices.contiguous()
    return verts, smpl


def chunked(fn, *tensors):
    B = tensors[0].shape[0]
    return torch.cat([fn(*(t[i:i + PLAIN_CHUNK] for t in tensors))
                      for i in range(0, B, PLAIN_CHUNK)])


def report(tag, name, ms, bound_ms, loop, pairs, mhz, err, ok, extra=''):
    issue = ''
    if loop and mhz:
        n, per, _ = loop
        ceil_ms = 1e3 * pairs * n / per / (SMS * LANES * mhz * 1e6)
        issue = (f', issue ceiling {ceil_ms:.4f} ms ({n / per:.1f} '
                 f'instructions a pair at {mhz:.0f} MHz)')
    print(f'[{tag}] {name}: {ms:.4f} ms, {bound_ms / ms:.1%} of the '
          f'{bound_ms:.4f} ms bound{issue}, max abs err vs plain {err:.3g}'
          f'{extra}{"" if ok else " -- FAILS THE BARS"}', flush=True)


def run_affine(B, verts, faces, fns, shapes, loops, mhz=None):
    """Times and bars of kernel 3's builds; without `mhz`, the SM clock is
    first sampled over twenty launches of the kernel as it is. Returns
    ({build: ms}, mhz)."""
    Q, F = verts.shape[1], faces.shape[0]
    p4 = CK.affine_points(verts)
    rows = CK.affine_constant_rows(verts[:, faces])
    tc = rows.transpose(1, 2).contiguous()
    want = chunked(CK.winding_numbers_affine_ref, p4, tc)
    pairs = B * Q * F
    bound_ms = 1e3 * AFFINE_OPS * pairs / PEAK_FLOPS
    out = torch.empty(B, Q, device='cuda')
    launches = 1 if B >= 16 else 5
    times, outs = {}, {}
    for name, fn in fns.items():
        chunk, splits = CK.affine_plan(B, Q, F, shapes[name])
        partial = torch.empty(B, splits, Q, device='cuda')
        src = tc if name == 'first port kernel 3' else rows

        def call(fn=fn, chunk=chunk, partial=partial, src=src):
            check(fn(p4.data_ptr(), src.data_ptr(), out.data_ptr(),
                     partial.data_ptr(), B, Q, F, chunk, PC.INV_4PI,
                     torch.cuda.current_stream().cuda_stream), name)
        if mhz is None:
            with ClockSampler() as clock:
                for _ in range(20):
                    call()
                torch.cuda.synchronize()
            mhz = clock.mhz
            print(f'[clock] SM clock over 20 launches of kernel 3 at B={B}: '
                  f'{mhz} MHz (median of nvidia-smi samples)', flush=True)
        ms = times[name] = median_ms(call, launches, 5, graph=True)
        out.fill_(float('nan'))
        call()
        torch.cuda.synchronize()
        err = (out - want).abs().max().item()
        flips = ((out <= 0.99) != (want <= 0.99)).sum().item()
        same = outs.setdefault(shapes[name], out.clone()) if name == 'kernel' \
            else outs.get(shapes[name])
        bits = '' if same is None or name == 'kernel' else \
            f', bit for bit the kernel\'s: {torch.equal(out, same)}'
        report(f'affine B={B}', name, ms, bound_ms, loops.get(name), pairs,
               mhz, err, err <= ATOL and flips == 0,
               f', in/out flips {flips} (splits {splits}){bits}')
    return times, mhz


def run_near(B, verts, clusters, fns, shapes, loops, mhz):
    prob = PH.hier_problem(verts, clusters, NUM_NEAR)
    sel, pts, tris = prob.sel, prob.pts, prob.tris
    _, T, M = sel.shape
    Qp = pts.shape[2]
    K, C = tris.shape[1], tris.shape[3]
    TQ = Qp // T
    want = chunked(PH.near_field_ref, sel, pts, tris)
    pairs = B * Qp * M * C
    bound_ms = 1e3 * NEAR_OPS * pairs / PEAK_FLOPS
    out = torch.empty(B, Qp, device='cuda')
    launches = 2 if B >= 16 else 10
    times, outs = {}, {}
    for name, fn in fns.items():
        mchunk, splits = PH.near_plan(B, T, TQ, M, shapes[name])
        partial = torch.empty(B, splits, Qp, device='cuda')

        def call(fn=fn, mchunk=mchunk, partial=partial):
            check(fn(sel.data_ptr(), pts.data_ptr(), tris.data_ptr(),
                     out.data_ptr(), partial.data_ptr(), B, T, TQ, M, K, C,
                     mchunk, torch.cuda.current_stream().cuda_stream), name)
        ms = times[name] = median_ms(call, launches, 5, graph=True)
        out.fill_(float('nan'))
        call()
        torch.cuda.synchronize()
        err = (out - want).abs().max().item() * PC.INV_4PI
        same = outs.setdefault(shapes[name], out.clone()) if name == 'kernel' \
            else outs.get(shapes[name])
        bits = '' if same is None or name == 'kernel' else \
            f', bit for bit the kernel\'s: {torch.equal(out, same)}'
        report(f'near B={B}', name, ms, bound_ms, loops.get(name), pairs,
               mhz, err, err <= ATOL,
               f' in winding units (splits {splits}){bits}')
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print('winding_route_variants: no CUDA device', file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    logs = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        aff = start(tmp / 'affine', CSRC / 'winding_affine.cu', AFFINE)
        near = start(tmp / 'near', CSRC / 'winding_near.cu', NEAR)
        trial = start(tmp / 'trials', ROOT / 'tools' / 'winding_route_trials.cu',
                      {'trials': []}, flags=True)
        aff_fns = finish('affine', aff, 'tuch_winding_affine', AFFINE_ARGS,
                         logs.setdefault('affine', {}))
        near_fns = finish('near', near, 'tuch_winding_near', NEAR_ARGS,
                          logs.setdefault('near', {}))
        trial_log = {}
        finish('trials', trial, 'trial_winding_near_old', NEAR_ARGS,
               trial_log)
        lib = ctypes.CDLL(str(trial['trials'][0]))
        shapes = {'affine': {}, 'near': {}}
        loops = {'affine': {}, 'near': {}}
        for kind, builds, fns, symbol, kernel in (
                ('affine', aff, aff_fns, 'tuch_winding_affine_shape',
                 'affine_kernel'),
                ('near', near, near_fns, 'tuch_winding_near_shape',
                 'near_kernel')):
            for name in fns:
                out = (ctypes.c_int * 3)()
                getattr(ctypes.CDLL(str(builds[name][0])), symbol)(out)
                shapes[kind][name] = tuple(out)
                loops[kind][name] = sass(builds[name][0], kernel)
                print(f'[build] {kind} {name}: shape {tuple(out)}; ptxas '
                      f'{ptxas(logs[kind][name], kernel)}', flush=True)
        for kind, name, symbol, kernel, shape in (
                ('affine', 'first port kernel 3', 'trial_winding_affine_old',
                 'old_affine', OLD_AFFINE_SHAPE),
                ('affine', 'tensor cores (3xTF32) for numer, dab, dbc, dac',
                 'trial_winding_affine_tc', 'affine_tc_kernel', None),
                ('near', 'first port kernel 7', 'trial_winding_near_old',
                 'old_near', OLD_NEAR_SHAPE)):
            fn = getattr(lib, symbol)
            fn.argtypes = AFFINE_ARGS if kind == 'affine' else NEAR_ARGS
            fn.restype = ctypes.c_int
            (aff_fns if kind == 'affine' else near_fns)[name] = fn
            if shape is None:
                out = (ctypes.c_int * 3)()
                lib.trial_winding_affine_tc_shape(out)
                shape = tuple(out)
            shapes[kind][name] = shape
            loops[kind][name] = sass(trial['trials'][0], kernel)
            print(f'[build] {kind} {name}: shape {shape}; ptxas '
                  f'{ptxas(trial_log["trials"], kernel)}', flush=True)
        for kind in ('affine', 'near'):
            for name, loop in loops[kind].items():
                if loop is None:
                    print(f'[sass] {kind} {name}: no loop with the pairs '
                          'found', flush=True)
                    continue
                n, per, ops = loop
                print(f'[sass] {kind} {name}: {n} instructions for {per:g} '
                      f'pairs, {n / per:.1f} a pair: ' + ', '.join(
                          f'{k} {v / per:.2f}' for k, v in
                          ops.most_common(14)), flush=True)

        check_sqrt(lib)
        from tuch_tpu_torch.ops.winding_hier import build_winding_clusters
        times = {}
        mhz = None
        for B in (64, 4):
            verts, smpl = inputs(B)
            faces = smpl.faces
            clusters = build_winding_clusters(
                smpl.v_template.cpu().numpy(), faces.cpu().numpy(),
                device='cuda')
            times[B, 'affine'], mhz = run_affine(
                B, verts, faces, aff_fns, shapes['affine'], loops['affine'],
                mhz)
            times[B, 'near'] = run_near(B, verts, clusters, near_fns,
                                        shapes['near'], loops['near'], mhz)
            del verts
            torch.cuda.empty_cache()
        for (B, kind), t in times.items():
            old = t[f'first port kernel {3 if kind == "affine" else 7}']
            print(f'[verdict] {kind} B={B}: kernel {t["kernel"]:.4f} ms '
                  f'against the first port\'s {old:.4f} ms '
                  f'(x{old / t["kernel"]:.2f})', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
