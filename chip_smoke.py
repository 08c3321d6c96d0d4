#!/usr/bin/env python3
"""Chip smoke of tuch_tpu_torch, the PyTorch + CUDA port, on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Drives the port's ported paths end to end and fails loudly (a non-zero
exit, no result line) if any check fails:

  1. build   the CUDA kernels from tuch_tpu_torch/csrc/, one nvcc each, in
             parallel, with each kernel's ptxas line;
  2. kernel  the attention kernel against its plain PyTorch version on the
             card, fp32 and bf16, at the serving shapes and at N on both
             sides of its tile edges (1 to 300, head dims 32 and 64), and
             its time at B=64 beside the plain version's, a library call's
             and the card's bound (CUDA-graph replays: device time only);
  3. serve   the HTTP server with the ViT-S/16 backbone at full width on the
             synthetic 6890-vertex body: a single /predict and a concurrent
             burst that fills a micro-batch bucket; the attention kernel must
             launch 12 times per device forward; then the same with
             --dtype bfloat16 (the bf16 kernel, 12 launches per forward);
  4. serve   the same with the ResNet-50 backbone, fp32 and bf16;
  5. parity  the card's fp32 vertices against the port's CPU path, same
             weights and image, and the card's bf16 vertices against the
             card's fp32 ones (within BF16_VERTEX_ATOL), for both backbones;
  6. times   B=1 forward latency and B=64 images/s for both backbones in
             both dtypes, each with a torch.profiler breakdown.

and the SMPLify-DC slice, on the same body with every contact asset:

  7. kernel  winding numbers, the masked nearest vertex, row gather and row
             scatter-add against their plain versions on the card, at the
             slice's shapes (winding also on the posed B=64 body), and each
             one's time at B=64 beside its plain version's, its bound and a
             library call's (gather and scatter-add by CUDA-graph replay,
             each one device kernel per call, with the host µs per call of
             their wrappers and library calls at B=64 and 4);
  8. fit     the demo (demo_smplify_dc --synthetic, 4 images, 100 iterations,
             ResNet-50 SPIN init): finite outputs, a lower reprojection loss
             than the init's, and each kernel launched exactly its count per
             iteration;
  9. parity  the card against the port's CPU path at B=2: in/out flags,
             nearest vertices, the stage-2 loss and gradient, and the
             vertices after a few iterations;
 10. times   ms per fit iteration at B=4 and B=64, the demo's wall time, and
             a torch.profiler breakdown per B.

and the experimental winding routes, unwired as in the JAX package, on the
same body with the JAX defaults (clusters of 256 faces, tiles of 512
points, 16 near clusters):

 11. routes  the affine route (kernel 3) and the hierarchical route (dense
             PyTorch plus kernel 7) through their entry points at B=64, rest
             and posed, with their in/out flips at 0.99 against kernel 2 and
             exact launch counts; kernels 3 and 7 against their plain
             versions at B 1 and 8, rest and posed; times at B=4 and 64 of
             kernels 3, 7 and 2 and of the whole hierarchical route, each
             beside its plain version's and its bound, and a torch.profiler
             breakdown of the route.

Weights and bodies are random from fixed seeds. The last two lines of
standard output are the kernel summary and {"ok": true, "device": {...}} as
JSON; the line before them is the card's name and power limit from
nvidia-smi.
"""

import base64
import copy
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
TF32_FLOPS = 495e12              # the fp32 attention kernel runs 3xTF32

VIT_S16 = dict(N=196, C=384, H=6)   # 224x224 / 16x16 patches
VIT_T8 = dict(N=64, C=64, H=2)      # 64x64 / 8x8 patches
ODD = dict(N=197, C=384, H=6)       # a ragged last tile of queries and keys
# N on both sides of the kernel's tile edges (16 query rows per warp, 64 per
# block, key tiles of 32 (fp32) or 64 (bf16)), at head dims 64 and 32
EDGES = [dict(N=n, C=c, H=2) for n in (1, 15, 16, 17, 64, 196, 197, 300)
         for c in (128, 64)]
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# card bf16 vs card fp32 vertices, same weights and image: the bar of
# tests/test_torch_port_bf16.py (BF16_VERTEX_ATOL), metres
BF16_VERTEX_ATOL = 5e-3
SERVE_BUCKET = 4
VIT_S16_DEPTH = 12

# SMPLify-DC slice
FIT_IMAGES, FIT_ITERS = 4, 100   # the demo as chip_smoke drives it
TRAIN_B = 64                     # the training batch: kernel and fit times
PLAIN_CHUNK = 16                 # the plain versions run B=64 in 4 batches
PARITY_B, PARITY_ITERS = 2, 4    # card vs CPU; the CPU side stays ~1 minute
WN_ATOL, WN_BAND = 2e-5, 1e-4    # winding: values; in/out at 0.99 outside
D2_RTOL = 1e-6                   # masked min: d2, and argmin ties
SCATTER_RTOL = 1e-5              # scatter vs index_add_ (atomic order)
WINDING_OPS_PER_PAIR = 67        # counted in csrc/solid_angle.cuh
MASKED_OPS_ALLOWED = 9           # + 1 mask test per pair, csrc/masked_min.cu
DEV = 'cuda'                     # where the slice phases run

# winding routes (phase 11), bars stated before the first run on the card
ROUTE_NEAR = 16                  # num_near; cluster_size 256, tile_q 512
AFFINE_ATOL = 2e-5               # kernel 3 vs plain: same la2, lb2, lc2
NEAR_ATOL = 2e-5                 # kernel 7 vs plain, in winding units
REST_FLIPS = 0                   # flips of either route vs kernel 2, rest
AFFINE_OPS_PER_PAIR = 69         # counted in csrc/winding_affine.cu
FAR_OPS_PER_PAIR = 17            # (point, cluster) dipole, hier_problem


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


def graph_ms(fn, iters=20):
    """Device time of fn() (ms): iters calls captured in one CUDA graph and
    replayed, so the host's per-call cost does not enter."""
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
    ms = cuda_ms(graph.replay, iters=3, warmup=1) / iters
    del graph
    return ms


def mha_bound(B, N, C, H, dtype):
    """Least time (ms) for the attention of one launch on the route the
    kernel takes, the bound ('bytes' or 'operations') and the route: bf16
    on the tensor cores; fp32 in 3xTF32, three TF32 products per product."""
    hd = C // H
    nbytes = (3 * C + C) * N * B * torch.finfo(dtype).bits // 8
    flops = 4 * B * H * N * N * hd
    if dtype == torch.bfloat16:
        t_ops, route = flops / PEAK_FLOPS[dtype], 'bf16 tensor cores'
    else:
        t_ops, route = 3 * flops / TF32_FLOPS, '3xTF32 tensor cores'
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                       else 'operations'), route


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
    shapes = [(s, B) for s in (VIT_S16, VIT_T8, ODD) for B in (1, 64)]
    shapes += [(s, 3) for s in EDGES]
    for dtype in (torch.float32, torch.bfloat16):
        for shape, B in shapes:
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
        ms = graph_ms(lambda: A.mha_cuda(x, H))
        plain_ms = graph_ms(lambda: A.mha_reference(x, H))
        lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        bound_ms, bound_by, route = mha_bound(B, N, C, H, dtype)
        print(f'[kernel] mha {str(dtype)[6:]} B={B} N={N} C={C} H={H}: '
              f'kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, '
              f'sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} ms '
              f'({bound_by}, {route}), {bound_ms / ms:.1%} of bound '
              f'(CUDA-graph replay, device time)', flush=True)
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


def phase_serve(backbone, dtype, launches):
    """Serve a few requests; returns the warm predictor (batcher closed)."""
    from tuch_tpu_torch import constants
    from tuch_tpu_torch.cli.serve import build_server
    from tuch_tpu_torch.ops import attention as A
    tag = f'{backbone} {dtype}'
    t0 = time.perf_counter()
    httpd = build_server(SimpleNamespace(
        checkpoint=None, synthetic=True, img_res=224,
        synthetic_num_verts=None, max_batch=SERVE_BUCKET,
        batch_wait_ms=500.0, backbone=backbone, device='cuda', dtype=dtype,
        host='127.0.0.1', port=0))
    predictor = httpd.predictor
    check(predictor.num_verts == constants.SMPL_NUM_VERTS,
          f'body has {predictor.num_verts} vertices')
    check(predictor.hmr.dtype == getattr(torch, dtype),
          f'{tag}: HMR computes in {predictor.hmr.dtype}')
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f'http://127.0.0.1:{httpd.server_address[1]}'
    print(f'[serve {tag}] built and warmed {predictor._buckets} in '
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
        print(f'[serve {tag}] {SERVE_BUCKET + 1} requests answered 200 '
              f'in {forwards} device forwards (batch sizes up to '
              f'{m["batch_size_max"]}); mha launches {count}, expected '
              f'{per_forward} per forward; p50 latency '
              f'{m["forward_latency_ms_p50"]} ms', flush=True)
        check(count == per_forward * forwards,
              f'{tag}: mha launched {count} times in {forwards} forwards')
        launches[tag] = count
        code, body = _http(url + '/predict', {'image_b64': 'not base64!'})
        check(code == 400, f'bad payload answered {code}')
    finally:
        httpd.shutdown()
        predictor.close()
        httpd.server_close()
        thread.join(timeout=30)
    check(not thread.is_alive(), 'server thread did not stop')
    return predictor


def phase_parity(backbone, card_fp32, card_bf16):
    """The card's fp32 outputs against the port's CPU path on the same
    image (tol 1e-3), and the card's bf16 ones against the card's fp32 ones
    (tol BF16_VERTEX_ATOL)."""
    from PIL import Image
    from tuch_tpu_torch.cli.serve import TuchPredictor
    cpu = TuchPredictor(synthetic=True, img_res=224, backbone=backbone,
                        device='cpu')
    with Image.open(io.BytesIO(base64.b64decode(_png_b64(7)))) as im:
        norm = cpu._crop(np.asarray(im.convert('RGB')), {})
    got = card_fp32._run_forward(norm)
    names = ('pose', 'betas', 'camera', 'cam_t', 'vertices')
    for what, a, b, tol in (
            ('card fp32 vs CPU fp32', got, cpu._run_forward(norm), 1e-3),
            ('card bf16 vs card fp32', card_bf16._run_forward(norm), got,
             BF16_VERTEX_ATOL)):
        check(all(x.dtype == np.float32 for x in a), f'{what}: not float32')
        errs = [float(np.abs(x - y).max()) for x, y in zip(a, b)]
        print(f'[parity {backbone}] {what} max abs diff: ' + ', '.join(
            f'{n} {e:.3g}' for n, e in zip(names, errs))
            + f' (vertex tol {tol})', flush=True)
        check(errs[4] <= tol, f'{backbone} {what}: vertices differ by '
              f'{errs[4]}')


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


def phase_times(tag, predictor, card):
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
    print(f'[times {tag}] B=1 forward {np.median(lat):.3f} ms median '
          f'of 20 (host clock, copies in and out); B=64 {ms64:.3f} ms = '
          f'{64e3 / ms64:.1f} images/s (CUDA events, input on the card); '
          f'TF32 cuDNN {torch.backends.cudnn.allow_tf32}; card: {card}',
          flush=True)
    for label, fn in (('B=1', lambda: predictor._run_forward(norm)),
                      ('B=64', lambda: predictor.forward(x))):
        wall, busy, rows = device_breakdown(fn)
        if busy <= 0:
            print(f'[profile {tag} {label}] the profiler recorded no '
                  'device time', flush=True)
            continue
        print(f'[profile {tag} {label}] host wall {wall:.3f} ms, device '
              f'busy {busy:.3f} ms, idle share {1 - busy / wall:.1%} '
              f'(torch.profiler, one forward)', flush=True)
        for name, ms, calls in rows:
            print(f'[profile {tag} {label}]   {ms:8.3f} ms '
                  f'{ms / busy:6.1%} x{calls:<4d} {name}', flush=True)


# ---------------------------------------------------------------------------
# SMPLify-DC slice
# ---------------------------------------------------------------------------

def bound(ops, nbytes):
    """Least time (ms) for `ops` fp32 operations and `nbytes` bytes on the
    card, and which of the two bounds it."""
    t_ops, t_bytes = ops / PEAK_FLOPS[torch.float32], nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def slice_counters():
    from tuch_tpu_torch.ops import contact_kernels as CK
    from tuch_tpu_torch.ops import gather as G
    return {'winding': CK.winding_numbers_tris_cuda,
            'masked_min': CK.masked_min_dist_cuda,
            'gather': G.gather_rows_cuda,
            'scatter_add': G.scatter_add_rows_cuda}


def posed_verts(smpl, B, scale, seed):
    from tuch_tpu_torch.models.smpl import smpl_forward
    dev = smpl.v_template.device
    rng = np.random.RandomState(seed)
    pose = torch.as_tensor((rng.randn(B, 72) * scale).astype(np.float32),
                           device=dev)
    with torch.no_grad():
        return smpl_forward(smpl, torch.zeros(B, 10, device=dev),
                            pose[:, 3:], pose[:, :3]).vertices.contiguous()


def fit_inputs(B, num_classes, seed, dev):
    """A fitting problem at img_res 224 from numpy: init pose, betas and
    camera, keypoints in pixels with confidences, contact labels."""
    rng = np.random.RandomState(seed)
    init_pose = (rng.randn(B, 72) * 0.2).astype(np.float32)
    cam_t = np.tile(np.array([[0.0, 0.2, 40.0]], np.float32), (B, 1))
    kp = np.concatenate([rng.uniform(40, 184, (B, 49, 2)),
                         rng.uniform(0.5, 1.0, (B, 49, 1))], -1)
    contact = (rng.rand(B, num_classes) > 0.7).astype(np.float32)
    arrays = [init_pose, np.zeros((B, 10), np.float32), cam_t,
              np.full((B, 2), 112.0, np.float32), kp.astype(np.float32),
              contact]
    flags = [np.zeros(B, bool), np.ones(B, bool), rng.rand(B) > 0.5]
    return ([torch.as_tensor(a, device=dev) for a in arrays]
            + [torch.as_tensor(f, device=dev) for f in flags])


def _hold_winding(label, pts, tris):
    from tuch_tpu_torch.ops import contact as PC
    from tuch_tpu_torch.ops import contact_kernels as CK
    got = CK.winding_numbers_tris_cuda(pts, tris)
    want = torch.cat(_chunked(PC.winding_numbers, pts, tris))
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    band = (want - 0.99).abs() < WN_BAND
    flips = (((got <= 0.99) != (want <= 0.99)) & ~band).sum().item()
    print(f'[kernel] winding {label} {tuple(pts.shape)} x '
          f'{tuple(tris.shape[1:2])} tris: max_abs_err {err:.3g} (tol '
          f'{WN_ATOL}), in/out flips outside the band {flips}, values in '
          f'the band |wn - 0.99| < {WN_BAND}: {band.sum().item()}, '
          f'interior {(want > 0.99).sum().item()}', flush=True)
    check(got.shape == want.shape and err <= WN_ATOL and flips == 0,
          f'winding {label}: err {err}, flips {flips}')
    return err


def _hold_masked_min(label, verts, mask):
    from tuch_tpu_torch.ops import contact as PC
    from tuch_tpu_torch.ops import contact_kernels as CK
    d2, arg = CK.masked_min_dist_cuda(verts, mask)
    want_d2, want_arg = PC.masked_min_dist(verts, mask)
    torch.cuda.synchronize()
    fin = torch.isfinite(want_d2)
    check(torch.equal(fin, torch.isfinite(d2)), f'{label}: inf rows differ')
    err = (d2 - want_d2)[fin].abs().max().item()
    rel_ok = ((d2 - want_d2).abs()[fin]
              <= D2_RTOL * want_d2[fin]).all().item()
    # another argmin only at a tie of the plain d2 within D2_RTOL
    diff = verts - torch.gather(verts, 1, arg.long()[..., None].expand(
        -1, -1, 3))
    pick = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] \
        + diff[..., 2] * diff[..., 2]
    differ = (arg != want_arg) & fin
    ties_ok = ((pick - want_d2).abs()[differ]
               <= D2_RTOL * want_d2[differ]).all().item()
    rows = torch.arange(verts.shape[1], device=verts.device)
    allowed = (mask[rows[None].expand_as(arg), arg.long()] > 0)[fin]
    print(f'[kernel] masked_min {label} {tuple(verts.shape)}: d2 max_abs_err '
          f'{err:.3g} (rtol {D2_RTOL}), argmin differs at '
          f'{differ.sum().item()} (ties within rtol {D2_RTOL}), every pick '
          f'allowed {bool(allowed.all())}', flush=True)
    check(rel_ok and ties_ok and bool(allowed.all()),
          f'masked_min {label}: rel {rel_ok}, ties {ties_ok}')
    return err, arg


def _chunked(fn, *tensors):
    """The plain version over a B=64 input in batches of PLAIN_CHUNK (its
    intermediates at B=64 would need tens of GB)."""
    B = tensors[0].shape[0]
    return [fn(*(t[i:i + PLAIN_CHUNK] for t in tensors))
            for i in range(0, B, PLAIN_CHUNK)]


def phase_slice_kernels(runtime, results):
    """Kernels 2, 4, 5, 6 against their plain versions at the slice's
    shapes, then each one's time at B=64."""
    from tuch_tpu_torch.ops import contact as PC
    from tuch_tpu_torch.ops import contact_kernels as CK
    from tuch_tpu_torch.ops import gather as G
    from tuch_tpu_torch.ops.segments import fused_problem
    smpl, contact = runtime.smpl, runtime.contact
    faces, mask = contact.faces, contact.geomask
    V = smpl.v_template.shape[0]
    err = dict(winding=0.0, masked_min=0.0, gather=0.0, scatter_add=0.0)
    for B in (1, 8):
        bodies = {'rest': smpl.v_template[None].expand(B, -1, -1)
                  .contiguous(), 'posed': posed_verts(smpl, B, 0.3, B)}
        for name, verts in bodies.items():
            err['winding'] = max(err['winding'], _hold_winding(
                f'{name} B={B} self', verts, verts[:, faces]))
            err['winding'] = max(err['winding'], _hold_winding(
                f'{name} B={B} segments',
                *fused_problem(contact.segment_tables, verts)))
            e, arg = _hold_masked_min(f'{name} B={B}', verts, mask)
            err['masked_min'] = max(err['masked_min'], e)
        idx = arg.clone()
        idx[0, :5] = -1
        if B > 1:
            idx[1, :3] = V
        got = G.gather_rows_cuda(verts, idx)
        want = G.gather_rows_ref(verts, idx)
        # multiples of 2^-10 below 2 in magnitude: every row's sum is exact
        # in fp32 whatever the order of the kernel's atomic additions, so
        # the comparison cannot turn on that order
        contrib = torch.randint(-2047, 2048, (B, V, 3), device=verts.device,
                                generator=torch.Generator(verts.device)
                                .manual_seed(B)) / 1024.0
        sc = G.scatter_add_rows_cuda(contrib, idx, V)
        sc_want = G.scatter_add_rows_ref(contrib, idx, V)
        torch.cuda.synchronize()
        bitwise = torch.equal(got, want)
        e_sc = (sc - sc_want).abs().max().item()
        sc_ok = ((sc - sc_want).abs()
                 <= SCATTER_RTOL * sc_want.abs() + 1e-6).all().item()
        print(f'[kernel] gather B={B} V={V} Q={V} (with -1 and V indices): '
              f'bitwise equal {bitwise}; scatter_add: max_abs_err '
              f'{e_sc:.3g} (rtol {SCATTER_RTOL} vs index_add_)', flush=True)
        check(bitwise and sc_ok, f'gather {bitwise}, scatter {sc_ok}')
        err['scatter_add'] = max(err['scatter_add'], e_sc)

    # times at the training batch
    B = TRAIN_B
    verts = posed_verts(smpl, B, 0.3, 99)
    tris = verts[:, faces]
    allowed = int(mask.sum().item())
    _, idx = CK.masked_min_dist_cuda(verts, mask)
    err['winding'] = max(err['winding'], _hold_winding(
        f'posed B={B} self', verts, tris))
    plans = {
        'winding': (lambda: CK.winding_numbers_tris_cuda(verts, tris),
                    lambda: _chunked(PC.winding_numbers, verts, tris),
                    bound(WINDING_OPS_PER_PAIR * B * V * tris.shape[1],
                          4 * B * (3 * V + 9 * tris.shape[1] + V))),
        'masked_min': (lambda: CK.masked_min_dist_cuda(verts, mask),
                       lambda: _chunked(
                           lambda v: PC.masked_min_dist(v, mask), verts),
                       bound(B * (V * V + MASKED_OPS_ALLOWED * allowed),
                             V * V + 12 * B * V + 8 * B * V)),
    }
    for name, (kern, plain, (bound_ms, bound_by)) in plans.items():
        ms = cuda_ms(kern, iters=5, warmup=1)
        plain_ms = cuda_ms(plain, iters=2, warmup=1)
        print(f'[kernel] {name} B={B} V={V}: kernel {ms:.4f} ms, plain '
              f'{plain_ms:.4f} ms ({B // PLAIN_CHUNK} x B={PLAIN_CHUNK}), '
              f'no one-call library equivalent, bound {bound_ms:.4f} ms '
              f'({bound_by}), {bound_ms / ms:.1%} of bound', flush=True)
        results[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                             bound_ms=bound_ms, bound_by=bound_by,
                             max_abs_err=err[name])
    _time_rows(verts, idx, results, err)
    del verts, tris
    torch.cuda.empty_cache()


def host_us(fn, calls=1000):
    """Host µs per call of fn: the host clock over `calls` calls, then one
    synchronize. What a host-bound caller (the fit at B=4) feels."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / calls


def _row_calls(verts, idx):
    """{name: (kernel, plain, {library call: fn}, (bound ms, bound by))} of
    kernels 5 and 6 on these inputs. The scatter's library call zeroes its
    output, as kernel 6 does."""
    from tuch_tpu_torch.ops import gather as G
    B, V, _ = verts.shape
    flat = (torch.arange(B, device=verts.device)[:, None] * V
            + idx.long()).reshape(-1)
    idx_long = idx.long()[..., None].expand(-1, -1, 3)
    rows = verts.reshape(-1, 3)
    contrib = torch.randn(B, V, 3, device=verts.device)
    src = contrib.reshape(-1, 3)
    buf = torch.empty(B * V, 3, device=verts.device)

    def zero_index_add():
        buf.zero_()
        buf.index_add_(0, flat, src)

    nbytes = 4 * B * (3 * V + V + 3 * V)
    return {
        'gather': (lambda: G.gather_rows_cuda(verts, idx),
                   lambda: G.gather_rows_ref(verts, idx),
                   {'torch.gather': lambda: torch.gather(verts, 1, idx_long),
                    'index_select': lambda: torch.index_select(rows, 0,
                                                               flat)},
                   bound(0, nbytes)),
        'scatter_add': (lambda: G.scatter_add_rows_cuda(contrib, idx, V),
                        lambda: G.scatter_add_rows_ref(contrib, idx, V),
                        {'zero_ + index_add_': zero_index_add},
                        bound(3 * B * V, nbytes)),
    }


def _time_rows(verts, idx, results, err):
    """Kernels 5 and 6 at the training batch: the kernel, its plain version
    and its library calls timed by CUDA-graph replay (device time only; a
    kernel shorter than its wrapper's host time is otherwise timed by the
    host), each beside the bound; then the host µs per call of the wrapper
    and of each library call at B=64 and at the demo's B=4, where the
    device time per call is below the host's. The library yardstick is the
    faster call."""
    B, V, _ = verts.shape
    small = _row_calls(verts[:FIT_IMAGES].contiguous(),
                       idx[:FIT_IMAGES].contiguous())
    for name, (kern, plain, libs, (bound_ms, bound_by)) in \
            _row_calls(verts, idx).items():
        ms = graph_ms(kern, iters=50)
        plain_ms = graph_ms(plain, iters=20)
        lib_ms = {k: graph_ms(f, iters=50) for k, f in libs.items()}
        host = {}
        for tag, (k4, _, libs4, _) in ((f'B={B}', (kern, plain, libs, None)),
                                       (f'B={FIT_IMAGES}', small[name])):
            host[f'{tag} wrapper'] = host_us(k4)
            host.update({f'{tag} {k}': host_us(f) for k, f in libs4.items()})
        print(f'[kernel] {name} B={B} V={V} Q={V}: kernel {ms:.4f} ms, plain '
              f'{plain_ms:.4f} ms, ' + ', '.join(
                  f'{k} {t:.4f} ms' for k, t in lib_ms.items())
              + f', bound {bound_ms:.4f} ms ({bound_by}), '
              f'{bound_ms / ms:.1%} of bound (CUDA-graph replays, device '
              'time); host µs per call: ' + ', '.join(
                  f'{k} {t:.2f}' for k, t in host.items()), flush=True)
        results[name] = dict(ms=ms, plain_ms=plain_ms,
                             library_ms=min(lib_ms.values()),
                             bound_ms=bound_ms, bound_by=bound_by,
                             max_abs_err=err[name])
        # one kernel per call on the device: no memset pass, nothing else
        _, _, work = device_breakdown(kern)
        print(f'[kernel] {name}: device work of one call (torch.profiler): '
              f'{work}', flush=True)
        check(len(work) == 1 and work[0][2] == 1
              and f'{name}_rows' in work[0][0],
              f'{name}: device work of one call {work}')


def route_counters():
    from tuch_tpu_torch.ops import contact_kernels as CK
    from tuch_tpu_torch.ops import winding_hier as PH
    return {'winding_affine': CK.winding_numbers_affine_cuda,
            'winding_near': PH.near_field_cuda}


def _flips(got, want):
    return ((got <= 0.99) != (want <= 0.99)).sum().item()


def phase_routes(runtime, results, launches):
    """Phase 11: the affine and hierarchical winding routes."""
    from tuch_tpu_torch.ops import contact as PC
    from tuch_tpu_torch.ops import contact_kernels as CK
    from tuch_tpu_torch.ops import winding_hier as PH
    smpl, faces = runtime.smpl, runtime.contact.faces
    V = smpl.v_template.shape[0]
    clusters = PH.build_winding_clusters(smpl.v_template.cpu().numpy(),
                                         faces.cpu().numpy(), device=DEV)
    K, Qp = clusters.num_clusters, clusters.vert_perm.shape[0]
    M = min(ROUTE_NEAR, K)
    check((K, Qp) == (54, 7168), f'clusters K={K} Qp={Qp}')

    # the routes' entry points at B=64, against kernel 2
    B = TRAIN_B
    bodies = {'rest': smpl.v_template[None].expand(B, -1, -1).contiguous(),
              'posed': posed_verts(smpl, B, 0.3, 99)}
    counters = route_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0                   # the routes' run starts here
    outs = {name: (CK.winding_numbers_affine(v, v, faces),
                   PH.winding_numbers_hier(v, clusters, ROUTE_NEAR))
            for name, v in bodies.items()}
    counts = {k: c.launches for k, c in counters.items()}  # ... and ends
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    expected = {k: len(bodies) for k in counters}
    check(counts == expected, f'route launches {counts} != {expected}')
    launches.update(counts)
    for name, v in bodies.items():
        exact = CK.winding_numbers_tris_cuda(v, v[:, faces])
        aff, hier = outs[name]
        fa, fh = _flips(aff, exact), _flips(hier, exact)
        print(f'[routes] {name} B={B}: interior (kernel 2) '
              f'{(exact > 0.99).sum().item()} of {B * V}; in/out flips at '
              f'0.99 vs kernel 2: affine {fa}, hierarchical {fh} (M={M} of '
              f'K={K}); max |wn - kernel 2|: affine '
              f'{(aff - exact).abs().max().item():.4g}, hierarchical '
              f'{(hier - exact).abs().max().item():.4g}', flush=True)
        if name == 'rest':
            check(fa <= REST_FLIPS and fh <= REST_FLIPS,
                  f'rest flips: affine {fa}, hierarchical {fh}')
    print(f'[routes] peak device memory over both routes at B={B}: '
          f'{peak:.3f} GiB', flush=True)
    del outs

    # kernels 3 and 7 against their plain versions
    err = {'winding_affine': 0.0, 'winding_near': 0.0}
    for B in (1, 8):
        held = {'rest': smpl.v_template[None].expand(B, -1, -1)
                .contiguous(), 'posed': posed_verts(smpl, B, 0.3, B)}
        for name, v in held.items():
            p4 = CK.affine_points(v)
            tc = CK.affine_triangle_constants(v[:, faces])
            got = CK.winding_numbers_affine_cuda(p4, tc)
            want = CK.winding_numbers_affine_ref(p4, tc)
            prob = PH.hier_problem(v, clusters, ROUTE_NEAR)
            near = PH.near_field_cuda(prob.sel, prob.pts, prob.tris)
            near_want = PH.near_field_ref(prob.sel, prob.pts, prob.tris)
            torch.cuda.synchronize()
            ea = (got - want).abs().max().item()
            en = (near - near_want).abs().max().item() * PC.INV_4PI
            flips = _flips(got, want)
            print(f'[routes] kernels {name} B={B}: affine max_abs_err '
                  f'{ea:.3g} (tol {AFFINE_ATOL}), in/out flips {flips}; '
                  f'near field max_abs_err {en:.3g} in winding units (tol '
                  f'{NEAR_ATOL})', flush=True)
            check(got.shape == want.shape and ea <= AFFINE_ATOL
                  and flips == 0, f'affine {name} B={B}: {ea}, {flips}')
            check(near.shape == near_want.shape and en <= NEAR_ATOL,
                  f'near field {name} B={B}: {en}')
            err['winding_affine'] = max(err['winding_affine'], ea)
            err['winding_near'] = max(err['winding_near'], en)

    # times at the demo's batch and the training batch
    for B in (FIT_IMAGES, TRAIN_B):
        verts = bodies['posed'] if B == TRAIN_B else \
            posed_verts(smpl, B, 0.3, 99)
        _time_routes(B, verts, faces, clusters, results, err)
    del bodies
    torch.cuda.empty_cache()


def _time_routes(B, verts, faces, clusters, results, err):
    """Kernels 3, 7 and 2 and the whole hierarchical route on one posed
    batch: each one's time beside its plain version's and its bound, and a
    profile of the route; the training batch's go into results."""
    from tuch_tpu_torch.ops import contact as PC
    from tuch_tpu_torch.ops import contact_kernels as CK
    from tuch_tpu_torch.ops import winding_hier as PH
    V, F = verts.shape[1], faces.shape[0]
    K, C = clusters.num_clusters, clusters.cluster_size
    Qp = clusters.vert_perm.shape[0]
    tris = verts[:, faces]
    p4, tc = CK.affine_points(verts), CK.affine_triangle_constants(tris)
    prob = PH.hier_problem(verts, clusters, ROUTE_NEAR)
    T, M = prob.sel.shape[1:]
    near_pairs = B * Qp * M * C

    def hier_plain(v):
        pr = PH.hier_problem(v, clusters, ROUTE_NEAR)
        return PH.combine(PH.near_field_ref(pr.sel, pr.pts, pr.tris),
                          pr.far, clusters)

    def route():
        return PH.winding_numbers_hier(verts, clusters, ROUTE_NEAR)

    plans = {
        'winding_affine': (
            lambda: CK.winding_numbers_affine_cuda(p4, tc),
            lambda: _chunked(CK.winding_numbers_affine_ref, p4, tc),
            bound(AFFINE_OPS_PER_PAIR * B * V * F,
                  4 * B * (4 * V + 28 * F + V))),
        'winding_near': (
            lambda: PH.near_field_cuda(prob.sel, prob.pts, prob.tris),
            lambda: _chunked(PH.near_field_ref, prob.sel, prob.pts,
                             prob.tris),
            bound(WINDING_OPS_PER_PAIR * near_pairs,
                  4 * B * (3 * Qp + 9 * K * C + Qp + T * M))),
        'hier route': (
            route, lambda: _chunked(hier_plain, verts),
            bound(WINDING_OPS_PER_PAIR * near_pairs
                  + FAR_OPS_PER_PAIR * B * Qp * K, 4 * B * (3 * V + V))),
        'winding (kernel 2)': (
            lambda: CK.winding_numbers_tris_cuda(verts, tris),
            lambda: _chunked(PC.winding_numbers, verts, tris),
            bound(WINDING_OPS_PER_PAIR * B * V * F,
                  4 * B * (3 * V + 9 * F + V))),
    }
    chunks = f'{-(-B // PLAIN_CHUNK)} x B={min(B, PLAIN_CHUNK)}'
    for name, (kern, plain, (bound_ms, bound_by)) in plans.items():
        ms = cuda_ms(kern, iters=5, warmup=1)
        plain_ms = cuda_ms(plain, iters=2, warmup=1)
        print(f'[routes] {name} B={B} V={V}: {ms:.4f} ms, plain '
              f'{plain_ms:.4f} ms ({chunks}), no one-call library '
              f'equivalent, bound {bound_ms:.4f} ms ({bound_by}), '
              f'{bound_ms / ms:.1%} of bound', flush=True)
        if name in err and B == TRAIN_B:
            results[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                                 bound_ms=bound_ms, bound_by=bound_by,
                                 max_abs_err=err[name])
    wall, busy, rows = device_breakdown(route, top=5)
    if busy <= 0:
        print(f'[profile route B={B}] the profiler recorded no device time',
              flush=True)
        return
    print(f'[profile route B={B}] one hierarchical route: host wall '
          f'{wall:.3f} ms, device busy {busy:.3f} ms, idle share '
          f'{1 - busy / wall:.1%} (torch.profiler)', flush=True)
    for name, ms, calls in rows:
        print(f'[profile route B={B}]   {ms:8.3f} ms {ms / busy:6.1%} '
              f'x{calls:<4d} {name}', flush=True)


def phase_fit(runtime, launches):
    """The demo on the card; returns its output."""
    from tuch_tpu_torch import config as cfgmod
    from tuch_tpu_torch.cli import demo_smplify_dc as demo
    args = cfgmod.parse_config(cfgmod.SMPLifyDemoConfig, [
        '--synthetic', '--num_images', str(FIT_IMAGES),
        '--num_smplify_iters', str(FIT_ITERS), '--device', DEV])
    counters = slice_counters()
    t0 = time.perf_counter()
    for c in counters.values():
        c.launches = 0                   # the main path starts here
    out = demo.run(args, runtime=runtime)
    counts = {k: c.launches for k, c in counters.items()}  # ... and ends
    wall = time.perf_counter() - t0
    res = out.result
    for name in ('vertices', 'joints', 'pose', 'betas', 'camera_translation',
                 'reprojection_loss', 'trajectory'):
        t = getattr(res, name)
        check(bool(torch.isfinite(t).all()), f'fit: non-finite {name}')
    V = runtime.smpl.v_template.shape[0]
    check(res.vertices.shape == (FIT_IMAGES, V, 3),
          f'fit: vertices {tuple(res.vertices.shape)}')
    final = res.reprojection_loss.sum(-1).cpu().numpy()
    init = out.init_reprojection_loss.sum(-1).cpu().numpy()
    expected = {'winding': 2 * FIT_ITERS, 'masked_min': FIT_ITERS,
                'gather': FIT_ITERS, 'scatter_add': FIT_ITERS}
    print(f'[fit] demo_smplify_dc --synthetic, {FIT_IMAGES} images x '
          f'{FIT_ITERS} iterations behind the ResNet-50 init: reprojection '
          f'loss per image {np.round(init, 1).tolist()} -> '
          f'{np.round(final, 1).tolist()}; launches {counts}, expected '
          f'{expected}; HMR init + fit {out.seconds:.3f} s, whole run '
          f'{wall:.3f} s (host clock)', flush=True)
    check(bool((final < init).all()), 'fit: reprojection loss did not drop')
    check(counts == expected, f'fit launches {counts} != {expected}')
    launches.update(counts)
    return out


def phase_fit_parity(runtime):
    """The card against the port's CPU path at full width on B=2."""
    from tuch_tpu_torch.fitting import smplify_dc as PF
    from tuch_tpu_torch.losses import smplify as PL
    from tuch_tpu_torch.models.smpl import smpl_forward
    from tuch_tpu_torch.ops import contact_kernels as CK
    t0 = time.perf_counter()
    gpu = (runtime.smpl, runtime.prior, runtime.contact)
    cpu = (copy.deepcopy(runtime.smpl).cpu(), runtime.prior.to('cpu'),
           runtime.contact.to('cpu'))
    P = runtime.contact.region_idx_a.shape[0]
    ins = {'card': fit_inputs(PARITY_B, P, 11, DEV)}
    ins['cpu'] = [t.cpu() for t in ins['card']]
    pose = ins['card'][0] * 2.5          # fold the body: interior vertices
    with torch.no_grad():
        verts = smpl_forward(runtime.smpl, ins['card'][1], pose[:, 3:],
                             pose[:, :3]).vertices
    vc = verts.cpu()
    # the half without gradient, on the same vertices
    wn_c = CK.winding_numbers_faces(vc, vc, cpu[2].faces)
    band = (wn_c - 0.99).abs() < WN_BAND
    ext_g, arg_g = PL.contact_neighbors(verts, gpu[2])
    ext_c, arg_c = PL.contact_neighbors(vc, cpu[2])
    flips = ((ext_g.cpu() != ext_c) & ~band).sum().item()
    d2_g, _ = CK.masked_min_dist(verts, gpu[2].geomask)
    d2_c, _ = CK.masked_min_dist(vc, cpu[2].geomask)
    fin = torch.isfinite(d2_c)
    d2_ok = ((d2_g.cpu() - d2_c).abs()[fin] <= D2_RTOL * d2_c[fin]).all()
    differ = (arg_g.cpu() != arg_c) & fin
    print(f'[parity fit] B={PARITY_B} same vertices: interior (CPU) '
          f'{(~ext_c).sum().item()}, in/out flips outside the band {flips} '
          f'(in the band {band.sum().item()}); argmin differs at '
          f'{differ.sum().item()}, d2 within rtol {D2_RTOL} '
          f'{bool(d2_ok)}', flush=True)
    check(flips == 0 and bool(d2_ok), f'parity neighbours: flips {flips}')
    check(bool((((d2_g.cpu() - d2_c).abs() <= D2_RTOL * d2_c)
                 | ~differ).all()), 'parity: argmin differs beyond a tie')

    # the stage-2 loss and its gradient at the init pose, on the CPU's
    # neighbours (the half with gradient, from the parameters)
    def loss_and_grad(which):
        return body_stepper(gpu if which == 'card' else cpu, ins[which],
                            init_scale=2.5, neighbors=(ext_c, arg_c))()

    lg, gg = loss_and_grad('card')
    lc, gc = loss_and_grad('cpu')
    rel = abs(lg - lc) / abs(lc)
    # gradient: |card - CPU| <= 1e-4 |CPU| + 1e-6 max|CPU| per element, the
    # rule the CPU tests hold the port to against jax.grad; gerr is the
    # largest ratio of the two sides (<= 1 passes)
    gerr = max(((gg[k] - gc[k]).abs()
                / (1e-4 * gc[k].abs() + 1e-6 * gc[k].abs().max()))
               .max().item() for k in gg)
    print(f'[parity fit] stage-2 loss {lg:.6g} (card) vs {lc:.6g} (CPU), '
          f'rel {rel:.3g} (rtol 1e-4); gradient worst ratio to its bar '
          f'{gerr:.3g} (rtol 1e-4, atol 1e-6 of the largest)', flush=True)
    check(rel <= 1e-4 and gerr <= 1.0, f'parity loss {rel}, grad {gerr}')

    cfg = PF.SMPLifyConfig(num_iters=PARITY_ITERS, euclthres=0.02,
                           contact_loss_weight=2000.0)
    res = {w: PF.smplify_dc(*(gpu if w == 'card' else cpu), *ins[w],
                            config=cfg) for w in ('card', 'cpu')}
    verr = (res['card'].vertices.cpu() - res['cpu'].vertices).abs().max()
    print(f'[parity fit] vertices after {PARITY_ITERS} iterations of each '
          f'stage, card vs CPU: max abs diff {verr.item():.3g} (tol 1e-3); '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    check(verr.item() <= 1e-3, f'parity vertices {verr.item()}')


def body_stepper(assets, ins, init_scale=1.0, neighbors=None):
    """One body iteration of the fit at the reference's refresh every step:
    the neighbour refresh (or the given neighbours), the stage-2 loss's
    value and gradient, one Adam step. assets: (smpl, prior, contact).
    Each call returns (loss, gradients on the CPU)."""
    from tuch_tpu_torch.fitting import smplify_dc as PF
    init_pose, betas, cam_t, cc, kp, gt, ign, hdc, _ = ins
    stage = PF.contact_stage(*assets, betas, cam_t, cc, kp[..., :2],
                             kp[..., 2], gt, ign, hdc, PF.SMPLifyConfig(
                                 euclthres=0.02, contact_loss_weight=2000.0))
    pose = init_pose * init_scale
    state = {'body_pose': pose[:, 3:], 'global_orient': pose[:, :3]}
    opt = PF.Adam(state, 1e-2)
    dev = init_pose.device

    def step():
        nb = stage.neighbors(state) if neighbors is None else \
            tuple(t.to(dev) for t in neighbors)
        loss, grads = PF.value_and_grad(lambda q: stage.loss(q, nb), state)
        state.update(opt.step(state, grads))
        return float(loss), {k: g.cpu() for k, g in grads.items()}
    return step


def phase_fit_times(runtime, card, demo_out):
    P = runtime.contact.region_idx_a.shape[0]
    print(f'[times fit] demo (B={FIT_IMAGES}, {FIT_ITERS} iterations): HMR '
          f'init + fit {demo_out.seconds:.3f} s (host clock); card: {card}',
          flush=True)
    assets = (runtime.smpl, runtime.prior, runtime.contact)
    for B in (FIT_IMAGES, TRAIN_B):
        step = body_stepper(assets, fit_inputs(B, P, 21, DEV))
        for _ in range(2):
            step()
        n = 10
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        per_iter = 1e3 * (time.perf_counter() - t0) / n
        print(f'[times fit] B={B}: {per_iter:.3f} ms per body iteration '
              f'(neighbour refresh, loss and gradient, Adam step; host '
              f'clock, mean of {n})', flush=True)
        wall, busy, rows = device_breakdown(
            lambda: [step() for _ in range(3)], top=8)
        if busy <= 0:
            print(f'[profile fit B={B}] the profiler recorded no device time',
                  flush=True)
            continue
        print(f'[profile fit B={B}] 3 body iterations: host wall {wall:.3f} '
              f'ms, device busy {busy:.3f} ms, idle share '
              f'{1 - busy / wall:.1%} (torch.profiler)', flush=True)
        for name, ms, calls in rows:
            print(f'[profile fit B={B}]   {ms:8.3f} ms {ms / busy:6.1%} '
                  f'x{calls:<4d} {name}', flush=True)


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
    # are pinned off for phases 2-5 and 7-9 and restored to the defaults for
    # the times of phases 6 and 10 (phase 11 runs neither).
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    kernels, launches = {}, {}
    phase_build()
    phase_kernels(kernels)
    predictors = {f'{bb} {dt}': phase_serve(bb, dt, launches)
                  for bb in ('vit_s16', 'resnet50')
                  for dt in ('float32', 'bfloat16')}
    for bb in ('vit_s16', 'resnet50'):
        phase_parity(bb, predictors[f'{bb} float32'],
                     predictors[f'{bb} bfloat16'])

    from tuch_tpu_torch import runtime as rt
    t0 = time.perf_counter()
    fit_rt = rt.build_runtime(device=DEV, synthetic=True,
                              with_contact=True)
    print(f'[fit] runtime with contact assets built in '
          f'{time.perf_counter() - t0:.1f} s (geodesic mask '
          f'{tuple(fit_rt.contact.geomask.shape)} uint8, '
          f'{len(fit_rt.contact_classes)} region pairs, '
          f'{len(fit_rt.contact.segment_tables.names)} segments)', flush=True)
    phase_slice_kernels(fit_rt, kernels)
    demo_out = phase_fit(fit_rt, launches)
    phase_fit_parity(fit_rt)

    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = tf32
    for tag, pred in predictors.items():
        phase_times(tag, pred, card)
    phase_fit_times(fit_rt, card, demo_out)
    phase_routes(fit_rt, kernels, launches)

    # kernel 1 in both types: fp32 serves by default, bf16 with --dtype
    rows = [dict(name=name, source='tuch_tpu_torch/csrc/mha.cu',
                 replaces='tuch_tpu/ops/attention_pallas.py:70',
                 launches=launches[f'vit_s16 {dt}'],
                 **kernels[getattr(torch, dt)])
            for name, dt in (('mha', 'float32'), ('mha_bf16', 'bfloat16'))]
    for name, src, rep in (
            ('winding', 'winding.cu', 'contact_pallas.py:85'),
            ('masked_min', 'masked_min.cu', 'contact_pallas.py:404'),
            ('gather', 'gather.cu', 'gather_pallas.py:61'),
            ('scatter_add', 'gather.cu', 'gather_pallas.py:84'),
            ('winding_affine', 'winding_affine.cu', 'contact_pallas.py:205'),
            ('winding_near', 'winding_near.cu', 'winding_hier.py:121')):
        rows.append(dict(name=name, source=f'tuch_tpu_torch/csrc/{src}',
                         replaces=f'tuch_tpu/ops/{rep}',
                         launches=launches[name], **kernels[name]))
    keys = ('name', 'route', 'source', 'replaces', 'launches', 'max_abs_err',
            'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms')
    summary = {'kernels': [{key: dict(row, route='cuda')[key]
                            for key in keys} for row in rows]}
    print(card, flush=True)
    print(json.dumps(summary), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kinds,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
