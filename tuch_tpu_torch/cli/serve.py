"""serve: HTTP inference server for HMR + SMPL on the GPU.

Counterpart of tuch_tpu/cli/serve.py with the same contract: one warm
forward (HMR -> SMPL with rotation matrices -> weak-perspective translation
and axis-angle pose) behind a dependency-free stdlib HTTP server, with
power-of-two micro-batch buckets that are all warmed at start.

Endpoints:
  GET  /healthz   -> {"status": "ok", "backend": <torch device type>,
                      "warm": true}
  GET  /metrics   -> request counters, forward latency percentiles, batch
                     sizes
  POST /predict   -> body JSON:
      {"image_b64": <base64 of a PNG/JPEG>,          # required
       "bbox": [x, y, w, h],                          # optional crop box
       "center": [cx, cy], "scale": s,                # optional, overrides
       "return_vertices": false}                      # optional
    response:
      {"pose": [72 axis-angle], "betas": [10], "camera": [3 weak-persp],
       "cam_t": [3], "latency_ms": float, "vertices": [[x,y,z] x V]?}
  A bad payload answers 400; a fault of the server answers 500.

Usage:
  python -m tuch_tpu_torch.cli.serve --synthetic --backbone vit_s16
  python -m tuch_tpu_torch.cli.serve --synthetic --backbone vit_s16 \
      --dtype bfloat16
  python -m tuch_tpu_torch.cli.serve --checkpoint ckpt.pt --port 8000
  python -m tuch_tpu_torch.cli.serve --synthetic --bn_fold
"""

import argparse
import base64
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch
from PIL import Image

from tuch_tpu_torch import constants, resolve_device
from tuch_tpu_torch import runtime as rt
from tuch_tpu_torch.data import transforms as T
from tuch_tpu_torch.models import hmr as hmr_mod
from tuch_tpu_torch.models.smpl import smpl_forward
from tuch_tpu_torch.utils.projection import weak_perspective_to_translation
from tuch_tpu_torch.utils.rotations import rotmat_to_aa


class ClientError(ValueError):
    """Bad request payload -> HTTP 400 (server faults stay 500)."""


class _Pending:
    """One enqueued request awaiting the batcher: result or exception."""

    __slots__ = ('norm', 'event', 'out', 'err')

    def __init__(self, norm):
        self.norm = norm
        self.event = threading.Event()
        self.out = None
        self.err = None


class TuchPredictor:
    """One warm forward on the device plus the host-side crop around it.

    With max_batch > 1, concurrent requests are micro-batched: request
    threads decode and crop in parallel, enqueue their normalised crop, and
    one batcher thread groups up to max_batch of them (waiting at most
    batch_wait_ms after the first), pads to the next power-of-two bucket
    and runs ONE device forward. Every sample is independent of the others
    in the batch (convs, eval-mode BatchNorm, attention within an image,
    SMPL), so batched outputs match the B=1 path up to summation order.

    dtype ('float32' or 'bfloat16') is the backbone's compute dtype; the
    weights load as float32 and every output is float32 either way.
    bn_fold folds ResNet-50's eval-mode BatchNorm into its convolutions
    after the checkpoint is loaded (models/hmr.fold_batchnorm).
    """

    def __init__(self, checkpoint=None, synthetic=False, dtype='float32',
                 img_res=224, num_verts=None, max_batch=1,
                 batch_wait_ms=2.0, backbone='resnet50', device=None,
                 bn_fold=False):
        self.device = resolve_device(device)
        self.img_res = img_res
        runtime = rt.build_runtime(
            device=self.device, synthetic=synthetic or None,
            num_verts=num_verts, backbone=backbone, checkpoint=checkpoint,
            dtype=dtype, bn_fold=bn_fold, img_res=img_res)
        # the backbone's weights cast to dtype once here, not per forward
        self.hmr = hmr_mod.store_compute_weights(runtime.hmr)
        self.smpl = runtime.smpl
        self.num_verts = int(self.smpl.v_template.shape[0])
        self._lock = threading.Lock()
        self.warm = False
        # Rolling observability counters for /metrics (lock-protected;
        # latencies keep the newest 1024 samples).
        self._stats = {'requests_ok': 0, 'requests_client_error': 0,
                       'requests_server_error': 0}
        self._latencies_ms = []
        self._batch_sizes = []
        self.max_batch = max(1, int(max_batch))
        self._wait_s = max(0.0, float(batch_wait_ms)) / 1e3
        self._buckets = []
        b = 1
        while b < self.max_batch:
            self._buckets.append(b)
            b *= 2
        self._buckets.append(self.max_batch)
        self._queue = None
        self._batcher = None
        if self.max_batch > 1:
            self._queue = queue.Queue()
            self._batcher = threading.Thread(target=self._batch_loop,
                                             daemon=True)
            self._batcher.start()

    def forward(self, norm: torch.Tensor):
        """Normalised NHWC crops on the device -> (pose (B, 72), betas,
        camera, cam_t, vertices), all float32 tensors on the device."""
        with torch.inference_mode():
            rotmat, betas, cam = self.hmr(norm)
            out = smpl_forward(self.smpl, betas, rotmat[:, 1:],
                               rotmat[:, :1], pose2rot=False)
            cam_t = weak_perspective_to_translation(
                cam, constants.FOCAL_LENGTH, self.img_res)
            pose = torch.nan_to_num(rotmat_to_aa(rotmat)).reshape(-1, 72)
            return (pose.float(), betas.float(), cam.float(), cam_t.float(),
                    out.vertices.float())

    def warmup(self):
        """Run every batch bucket once at startup (kernel build, cuDNN
        algorithm selection, allocator) so no request pays for it."""
        for b in self._buckets:
            self._run_forward(
                np.zeros((b, self.img_res, self.img_res, 3), np.float32))
        self.warm = True

    def close(self):
        """Stop the batcher thread (pending requests still complete)."""
        if self._queue is not None:
            self._queue.put(None)

    # ------------------------------------------------------------------
    def _run_forward(self, norm: np.ndarray):
        """One device forward under the device lock; returns numpy."""
        with self._lock:
            x = torch.from_numpy(norm).to(self.device)
            return [o.cpu().numpy() for o in self.forward(x)]

    def _batch_loop(self):
        while True:
            item = self._queue.get()
            if item is None:
                return
            batch = [item]
            deadline = time.monotonic() + self._wait_s
            stop = False
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    stop = True
                    break
                batch.append(nxt)
            self._dispatch(batch)
            if stop:
                return

    def _dispatch(self, batch):
        n = len(batch)
        bucket = next(b for b in self._buckets if b >= n)
        norm = np.concatenate([p.norm for p in batch], axis=0)
        if bucket > n:
            pad = np.zeros((bucket - n,) + norm.shape[1:], norm.dtype)
            norm = np.concatenate([norm, pad], axis=0)
        try:
            outs = self._run_forward(norm)
        except Exception as e:  # hand the device fault to every caller
            for p in batch:
                p.err = e
                p.event.set()
            return
        with self._lock:
            self._batch_sizes = (self._batch_sizes + [n])[-1024:]
        for i, p in enumerate(batch):
            p.out = tuple(o[i:i + 1] for o in outs)
            p.event.set()

    # ------------------------------------------------------------------
    def _crop(self, img, req):
        if ('center' in req) != ('scale' in req):
            raise ClientError(
                "'center' and 'scale' must be provided together "
                '(a half-specified crop override would silently fall '
                'back to the bbox/full-image crop)')
        try:
            if 'center' in req:
                center = np.asarray(req['center'], np.float32).reshape(2)
                scale = float(req['scale'])
            elif 'bbox' in req:
                center, scale = T.bbox_center_scale(req['bbox'])
            else:
                center, scale = T.full_image_center_scale(*img.shape[:2])
        except (TypeError, ValueError) as e:
            raise ClientError(f'bad crop parameters: {e}') from e
        crop = T.crop_image(img, center, scale,
                            (self.img_res, self.img_res)) / 255.0
        return T.normalize_image(crop)[None].astype(np.float32)

    def predict(self, req: dict) -> dict:
        try:
            raw = base64.b64decode(req['image_b64'], validate=True)
            with Image.open(io.BytesIO(raw)) as im:
                img = np.asarray(im.convert('RGB'))
        except Exception as e:
            raise ClientError(
                f'image_b64 is not a decodable base64 image: {e}') from e
        norm = self._crop(img, req)
        t0 = time.time()
        if self._queue is not None:
            pending = _Pending(norm)
            self._queue.put(pending)
            pending.event.wait()
            if pending.err is not None:
                raise pending.err
            pose, betas, cam, cam_t, verts = pending.out
        else:
            pose, betas, cam, cam_t, verts = self._run_forward(norm)
        # queue wait + device forward: the latency a client experiences
        latency = round(1000.0 * (time.time() - t0), 3)
        out = {
            'pose': pose[0].tolist(),
            'betas': betas[0].tolist(),
            'camera': cam[0].tolist(),
            'cam_t': cam_t[0].tolist(),
            'latency_ms': latency,
        }
        if req.get('return_vertices'):
            out['vertices'] = verts[0].tolist()
        with self._lock:
            self._latencies_ms = (self._latencies_ms + [latency])[-1024:]
        return out

    def count(self, outcome: str):
        with self._lock:
            self._stats[f'requests_{outcome}'] += 1

    def metrics(self) -> dict:
        with self._lock:
            stats = dict(self._stats)
            lats = list(self._latencies_ms)
            sizes = list(self._batch_sizes)
        out = {**stats, 'warm': self.warm, 'max_batch': self.max_batch}
        if lats:
            q = np.percentile(np.asarray(lats), [50, 90, 99])
            out.update(forward_latency_ms_p50=round(float(q[0]), 3),
                       forward_latency_ms_p90=round(float(q[1]), 3),
                       forward_latency_ms_p99=round(float(q[2]), 3),
                       latency_samples=len(lats))
        if sizes:
            arr = np.asarray(sizes)
            out.update(batched_forwards=len(sizes),
                       batch_size_p50=float(np.percentile(arr, 50)),
                       batch_size_max=int(arr.max()))
        return out


def make_handler(predictor: TuchPredictor):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # quiet request lines
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == '/healthz':
                self._send(200, {'status': 'ok',
                                 'backend': predictor.device.type,
                                 'warm': predictor.warm})
            elif self.path == '/metrics':
                self._send(200, predictor.metrics())
            else:
                self._send(404, {'error': 'unknown path'})

        def do_POST(self):
            if self.path != '/predict':
                self._send(404, {'error': 'unknown path'})
                return
            try:
                n = int(self.headers.get('Content-Length', 0))
                try:
                    req = json.loads(self.rfile.read(n))
                except ValueError as e:
                    raise ClientError(f'body is not valid JSON: {e}') \
                        from e
                if not isinstance(req, dict) or 'image_b64' not in req:
                    raise ClientError('image_b64 is required')
                out = predictor.predict(req)
                predictor.count('ok')
                self._send(200, out)
            except ClientError as e:
                predictor.count('client_error')
                self._send(400, {'error': str(e)})
            except Exception as e:
                predictor.count('server_error')
                self._send(500, {'error': repr(e)})

    return Handler


def build_server(args) -> ThreadingHTTPServer:
    """Predictor + warmed buckets + bound (not yet serving) HTTP server.

    Split from main() so callers can serve on an ephemeral port
    (args.port = 0) from a thread.
    """
    predictor = TuchPredictor(
        checkpoint=args.checkpoint, synthetic=args.synthetic,
        dtype=getattr(args, 'dtype', 'float32'), img_res=args.img_res,
        num_verts=getattr(args, 'synthetic_num_verts', None),
        max_batch=getattr(args, 'max_batch', 1),
        batch_wait_ms=getattr(args, 'batch_wait_ms', 2.0),
        backbone=getattr(args, 'backbone', 'resnet50'),
        device=getattr(args, 'device', None),
        bn_fold=getattr(args, 'bn_fold', False))
    predictor.warmup()
    httpd = ThreadingHTTPServer((args.host, args.port),
                                make_handler(predictor))
    httpd.predictor = predictor  # callers reach it for close()
    return httpd


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--checkpoint', default=None,
                   help='HMR checkpoint (.pt reference or .npz pytree)')
    p.add_argument('--synthetic', action='store_true',
                   help='synthetic body (no assets required)')
    p.add_argument('--host', default='127.0.0.1')
    p.add_argument('--port', type=int, default=8000)
    p.add_argument('--img_res', type=int, default=224)
    p.add_argument('--synthetic_num_verts', type=int, default=None,
                   help='toy-scale synthetic body (tests/smokes)')
    p.add_argument('--dtype', default='float32',
                   choices=sorted(rt.COMPUTE_DTYPES),
                   help='backbone compute dtype; bfloat16 runs the '
                        'convolutions or the ViT in bf16 with float32 '
                        'weights, LayerNorms and IEF head')
    p.add_argument('--max_batch', type=int, default=1,
                   help='micro-batching: group up to this many concurrent '
                        'requests into one device forward (power-of-two '
                        'buckets, all warmed at startup). 1 = off')
    p.add_argument('--batch_wait_ms', type=float, default=2.0,
                   help='max time the batcher waits for more requests '
                        'after the first arrives')
    p.add_argument('--backbone', default='resnet50',
                   help='regressor backbone: resnet50 (reference), a '
                        'models/vit.py config name (vit_s16, ...) or '
                        'hmr2_vith16 (HMR 2.0, 4D-Humans: ViTPose-H/16 and '
                        'a transformer-decoder head, built for --img_res '
                        'crops, published 256; seeded weights until its '
                        'released checkpoint is in the repository)')
    p.add_argument('--bn_fold', action='store_true',
                   help='fold eval-mode BatchNorm into the ResNet-50 conv '
                        'weights after the checkpoint is loaded (the same '
                        'function to float32 rounding; inference only). '
                        'On an H100 it saves device time with --dtype '
                        'float32 only (PERF.md: slower under bfloat16)')
    p.add_argument('--device', default=None,
                   help="torch device (default cuda; 'cpu' to run there)")
    args = p.parse_args(argv)

    httpd = build_server(args)
    host, port = httpd.server_address[:2]
    print(f'serving on http://{host}:{port} (warm; POST /predict, '
          f'GET /healthz)', flush=True)

    # Graceful stop on SIGTERM: shutdown() must run on another thread than
    # serve_forever's, so the handler starts one.
    import signal

    def _on_term(signum, frame):
        print('SIGTERM: shutting down', flush=True)
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _on_term)
    except ValueError:
        pass
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.predictor.close()
        httpd.server_close()


if __name__ == '__main__':
    main()
