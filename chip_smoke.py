#!/usr/bin/env python3
"""Chip smoke of tuch_tpu_torch, the PyTorch + CUDA port, on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Drives the port's serving path end to end and fails loudly (a non-zero exit,
no result line) if any check fails:

  1. build   the CUDA kernels from tuch_tpu_torch/csrc/, one nvcc each, in
             parallel;
  2. kernel  each kernel against its plain PyTorch version on the card at the
             serving shapes, fp32 and bf16, and its time beside the plain
             version's, a library call's and the card's bound;
  3. serve   the HTTP server with the ViT-S/16 backbone at full width on the
             synthetic 6890-vertex body: a single /predict and a concurrent
             burst that fills a micro-batch bucket; the attention kernel must
             launch 12 times per device forward;
  4. serve   the same with the ResNet-50 backbone;
  5. parity  the card's vertices against the port's CPU path, same weights
             and image, for both backbones;
  6. times   B=1 forward latency and B=64 images/s for both backbones.

Weights are random from a fixed seed. The last two lines of standard output
are the kernel summary and {"ok": true, "device": {...}} as JSON; the line
before them is the card's name and power limit from nvidia-smi.
"""

import base64
import io
import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and the operation
# rate of each input type (fp32 outside the tensor cores, bf16 on them).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

VIT_S16 = dict(N=196, C=384, H=6)   # 224x224 / 16x16 patches
VIT_T8 = dict(N=64, C=64, H=2)      # 64x64 / 8x8 patches
ODD = dict(N=197, C=384, H=6)       # a ragged last tile of queries and keys
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
SERVE_BUCKET = 4
VIT_S16_DEPTH = 12


def check(ok, msg):
    if not ok:
        raise RuntimeError(f'check failed: {msg}')


def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() over iters launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def mha_bound(B, N, C, H, dtype):
    """Least time (ms) for the attention of one launch, and its bound."""
    hd = C // H
    nbytes = (3 * C + C) * N * B * torch.finfo(dtype).bits // 8
    flops = 4 * B * H * N * N * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                       else 'operations')


# ---------------------------------------------------------------------------
def phase_build():
    from tuch_tpu_torch.ops import _build
    secs = _build.build()
    for name in _build.sources():
        regs = [ln.split(':', 1)[1].strip()
                for ln in _build.BUILD_LOG.get(name, '').splitlines()
                if 'registers' in ln]
        print(f'[build] {name}: {regs}', flush=True)
    print(f'[build] {len(_build.sources())} kernel source(s) built in '
          f'{secs:.2f} s', flush=True)


def phase_kernels(results):
    import torch.nn.functional as F
    from tuch_tpu_torch.ops import attention as A
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in (VIT_S16, VIT_T8, ODD):
            for B in (1, 64):
                N, C, H = shape['N'], shape['C'], shape['H']
                x = torch.randn(B, N, 3 * C, device=dev, generator=gen)
                x = x.to(dtype)
                got = A.mha_cuda(x, H)
                want = A.mha_reference(x, H)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                print(f'[kernel] mha {str(dtype)[6:]} B={B} N={N} C={C} '
                      f'H={H}: max_abs_err {err:.3g} (tol {TOL[dtype]})',
                      flush=True)
                check(err <= TOL[dtype] and got.shape == want.shape,
                      f'mha {dtype} B={B} N={N}: err {err}')
                worst[dtype] = max(worst.get(dtype, 0.0), err)
    B, N, C, H = 64, VIT_S16['N'], VIT_S16['C'], VIT_S16['H']
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(B, N, 3 * C, device=dev, generator=gen).to(dtype)
        q, k, v = x.view(B, N, 3, H, C // H).permute(2, 0, 3, 1, 4)
        ms = cuda_ms(lambda: A.mha_cuda(x, H))
        plain_ms = cuda_ms(lambda: A.mha_reference(x, H))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        bound_ms, bound_by = mha_bound(B, N, C, H, dtype)
        print(f'[kernel] mha {str(dtype)[6:]} B={B} N={N} C={C} H={H}: '
              f'kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, '
              f'sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} ms '
              f'({bound_by}), {bound_ms / ms:.1%} of bound', flush=True)
        results[dtype] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=bound_ms, bound_by=bound_by,
                              max_abs_err=worst[dtype])


def _png_b64(seed, size=(240, 320)):
    from PIL import Image
    rng = np.random.RandomState(seed)
    img = Image.fromarray(rng.randint(0, 255, size + (3,), np.uint8))
    buf = io.BytesIO()
    img.save(buf, format='PNG')
    return base64.b64encode(buf.getvalue()).decode()


def _http(url, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={'Content-Type': 'application/json'})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _check_prediction(code, body, num_verts, what):
    check(code == 200, f'{what}: status {code} {body}')
    shapes = [np.shape(body[k]) for k in
              ('pose', 'betas', 'camera', 'cam_t', 'vertices')]
    check(shapes == [(72,), (10,), (3,), (3,), (num_verts, 3)],
          f'{what}: output shapes {shapes}')
    check(all(np.isfinite(body[k]).all() for k in
              ('pose', 'betas', 'camera', 'cam_t', 'vertices')),
          f'{what}: non-finite outputs')


def phase_serve(backbone, launches):
    """Serve a few requests; returns the warm predictor (batcher closed)."""
    from tuch_tpu_torch import constants
    from tuch_tpu_torch.cli.serve import build_server
    from tuch_tpu_torch.ops import attention as A
    t0 = time.perf_counter()
    httpd = build_server(SimpleNamespace(
        checkpoint=None, synthetic=True, img_res=224,
        synthetic_num_verts=None, max_batch=SERVE_BUCKET,
        batch_wait_ms=500.0, backbone=backbone, device='cuda',
        host='127.0.0.1', port=0))
    predictor = httpd.predictor
    check(predictor.num_verts == constants.SMPL_NUM_VERTS,
          f'body has {predictor.num_verts} vertices')
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f'http://127.0.0.1:{httpd.server_address[1]}'
    print(f'[serve {backbone}] built and warmed {predictor._buckets} in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    try:
        code, health = _http(url + '/healthz')
        check(code == 200 and health['backend'] == 'cuda' and health['warm'],
              f'healthz {code} {health}')
        images = [_png_b64(seed) for seed in range(SERVE_BUCKET + 1)]
        A.mha_cuda.launches = 0          # the main path starts here
        code, body = _http(url + '/predict', {'image_b64': images[0],
                                              'return_vertices': True})
        _check_prediction(code, body, predictor.num_verts, 'single request')
        replies = [None] * SERVE_BUCKET

        def hit(i):
            replies[i] = _http(url + '/predict', {
                'image_b64': images[i + 1], 'return_vertices': True})

        burst = [threading.Thread(target=hit, args=(i,))
                 for i in range(SERVE_BUCKET)]
        for t in burst:
            t.start()
        for t in burst:
            t.join(timeout=300)
        count = A.mha_cuda.launches      # ... and ends here
        for t in burst:
            check(not t.is_alive(), 'a burst request did not finish')
        for i, (code, body) in enumerate(replies):
            _check_prediction(code, body, predictor.num_verts, f'burst {i}')
        code, m = _http(url + '/metrics')
        check(code == 200 and m['requests_ok'] == SERVE_BUCKET + 1,
              f'metrics {m}')
        forwards = m['batched_forwards']
        check(m['batch_size_max'] == SERVE_BUCKET,
              f'the burst did not fill a bucket of {SERVE_BUCKET}: {m}')
        per_forward = VIT_S16_DEPTH if backbone == 'vit_s16' else 0
        print(f'[serve {backbone}] {SERVE_BUCKET + 1} requests answered 200 '
              f'in {forwards} device forwards (batch sizes up to '
              f'{m["batch_size_max"]}); mha launches {count}, expected '
              f'{per_forward} per forward; p50 latency '
              f'{m["forward_latency_ms_p50"]} ms', flush=True)
        check(count == per_forward * forwards,
              f'mha launched {count} times in {forwards} forwards')
        launches[backbone] = count
        code, body = _http(url + '/predict', {'image_b64': 'not base64!'})
        check(code == 400, f'bad payload answered {code}')
    finally:
        httpd.shutdown()
        predictor.close()
        httpd.server_close()
        thread.join(timeout=30)
    check(not thread.is_alive(), 'server thread did not stop')
    return predictor


def phase_parity(backbone, gpu_predictor):
    """The card's outputs against the port's CPU path on the same image."""
    from PIL import Image
    from tuch_tpu_torch.cli.serve import TuchPredictor
    cpu = TuchPredictor(synthetic=True, img_res=224, backbone=backbone,
                        device='cpu')
    with Image.open(io.BytesIO(base64.b64decode(_png_b64(7)))) as im:
        norm = cpu._crop(np.asarray(im.convert('RGB')), {})
    got = gpu_predictor._run_forward(norm)
    want = cpu._run_forward(norm)
    errs = [float(np.abs(g - w).max()) for g, w in zip(got, want)]
    print(f'[parity {backbone}] card vs CPU max abs diff: pose {errs[0]:.3g}'
          f', betas {errs[1]:.3g}, camera {errs[2]:.3g}, cam_t '
          f'{errs[3]:.3g}, vertices {errs[4]:.3g} (tol 1e-3)', flush=True)
    check(errs[4] <= 1e-3, f'{backbone} vertices differ by {errs[4]}')


def device_breakdown(fn, top=6):
    """One profiled call of fn: host wall ms, device busy ms and the
    kernels with the most device time as (name, ms, calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    rows = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    return wall, busy, [(e.key[:70], e.self_device_time_total / 1e3,
                         e.count) for e in rows]


def phase_times(backbone, predictor, card):
    norm = np.random.RandomState(0).randn(1, 224, 224, 3).astype(np.float32)
    for _ in range(3):
        predictor._run_forward(norm)
    lat = []
    for _ in range(20):
        t0 = time.perf_counter()
        predictor._run_forward(norm)     # copies in and out, synchronous
        lat.append(1e3 * (time.perf_counter() - t0))
    x = torch.randn(64, 224, 224, 3, device='cuda')
    ms64 = cuda_ms(lambda: predictor.forward(x), iters=10, warmup=2)
    print(f'[times {backbone}] B=1 forward {np.median(lat):.3f} ms median '
          f'of 20 (host clock, copies in and out); B=64 {ms64:.3f} ms = '
          f'{64e3 / ms64:.1f} images/s (CUDA events, input on the card); '
          f'TF32 cuDNN {torch.backends.cudnn.allow_tf32}; card: {card}',
          flush=True)
    for label, fn in (('B=1', lambda: predictor._run_forward(norm)),
                      ('B=64', lambda: predictor.forward(x))):
        wall, busy, rows = device_breakdown(fn)
        if busy <= 0:
            print(f'[profile {backbone} {label}] the profiler recorded no '
                  'device time', flush=True)
            continue
        print(f'[profile {backbone} {label}] host wall {wall:.3f} ms, device '
              f'busy {busy:.3f} ms, idle share {1 - busy / wall:.1%} '
              f'(torch.profiler, one forward)', flush=True)
        for name, ms, calls in rows:
            print(f'[profile {backbone} {label}]   {ms:8.3f} ms '
                  f'{ms / busy:6.1%} x{calls:<4d} {name}', flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing was run', file=sys.stderr)
        return 1
    import tuch_tpu_torch  # noqa: F401  (fails outside the repository)
    card = card_line()
    kinds = torch.cuda.get_device_name(0)
    print(f'[device] {kinds}; torch {torch.__version__}, CUDA '
          f'{torch.version.cuda}', flush=True)
    # Comparisons against plain versions and the CPU are made in full fp32:
    # cuDNN convolutions default to TF32 on this card, matmuls do not; both
    # are pinned off for phases 2-5 and restored to the defaults for the
    # serving times of phase 6.
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    kernels, launches = {}, {}
    phase_build()
    phase_kernels(kernels)
    predictors = {bb: phase_serve(bb, launches)
                  for bb in ('vit_s16', 'resnet50')}
    for bb, pred in predictors.items():
        phase_parity(bb, pred)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = tf32
    for bb, pred in predictors.items():
        phase_times(bb, pred, card)

    k = kernels[torch.float32]  # the serving path runs the fp32 kernel
    summary = {'kernels': [{
        'name': 'mha', 'route': 'cuda',
        'source': 'tuch_tpu_torch/csrc/mha.cu',
        'replaces': 'tuch_tpu/ops/attention_pallas.py:70',
        'launches': launches['vit_s16'],
        'max_abs_err': k['max_abs_err'], 'ms': k['ms'],
        'plain_ms': k['plain_ms'], 'bound_ms': k['bound_ms'],
        'bound_by': k['bound_by'], 'library_ms': k['library_ms']}]}
    print(card, flush=True)
    print(json.dumps(summary), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kinds,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
