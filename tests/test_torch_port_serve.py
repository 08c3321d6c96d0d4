"""The serving slice as a whole: tuch_tpu_torch against tuch_tpu.

Both packages' TuchPredictor load the same .npz checkpoint (a Flax HMR from
init_hmr(PRNGKey(0))), get the same PNG request, and must agree on pose,
betas, camera, cam_t and vertices. The port's HTTP contract is checked over
an ephemeral port, and the port's import rules in a fresh interpreter.
"""

import base64
import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKBONES = ['vit_t8', 'resnet50']


def _png_b64(size=96, seed=0):
    from PIL import Image
    rng = np.random.RandomState(seed)
    img = Image.fromarray(rng.randint(0, 255, (size, size, 3), np.uint8))
    buf = io.BytesIO()
    img.save(buf, format='PNG')
    return base64.b64encode(buf.getvalue()).decode()


def _flax_checkpoint(path, backbone):
    """The Flax HMR of init_hmr(PRNGKey(0)) as the JAX package's .npz."""
    from tuch_tpu import assets
    from tuch_tpu.models import hmr as H
    _, extras = assets.synthetic_smpl(num_verts=170)
    model = H.create_hmr(extras.mean_pose6d, extras.mean_shape,
                         extras.mean_cam, backbone=backbone)
    variables = H.init_hmr(model, jax.random.PRNGKey(0), img_res=64)
    flat = traverse_util.flatten_dict(dict(variables))
    np.savez(path, **{'/'.join(k): np.asarray(v) for k, v in flat.items()})
    return path


@pytest.mark.parametrize('backbone', BACKBONES)
def test_predictor_matches_jax(backbone, tmp_path):
    from tuch_tpu.cli.serve import TuchPredictor as JaxPredictor
    from tuch_tpu_torch.cli.serve import TuchPredictor
    ckpt = _flax_checkpoint(str(tmp_path / 'hmr.npz'), backbone)
    kw = dict(checkpoint=ckpt, synthetic=True, img_res=64, num_verts=170,
              max_batch=2, backbone=backbone)
    req = {'image_b64': _png_b64(), 'bbox': [10, 6, 70, 80],
           'return_vertices': True}
    ref = JaxPredictor(**kw)
    port = TuchPredictor(device='cpu', **kw)
    try:
        ref.warmup()
        port.warmup()
        want, got = ref.predict(req), port.predict(req)
    finally:
        ref.close()
        port.close()
    assert np.asarray(got['vertices']).shape == \
        np.asarray(want['vertices']).shape
    for key in ('pose', 'betas', 'camera', 'cam_t', 'vertices'):
        np.testing.assert_allclose(np.asarray(got[key]),
                                   np.asarray(want[key]), atol=1e-3,
                                   err_msg=key)


@pytest.fixture(scope='module')
def server():
    from tuch_tpu_torch.cli.serve import build_server
    httpd = build_server(SimpleNamespace(
        checkpoint=None, synthetic=True, img_res=64, synthetic_num_verts=170,
        max_batch=2, batch_wait_ms=1.0, backbone='vit_t8', device='cpu',
        host='127.0.0.1', port=0))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f'http://127.0.0.1:{httpd.server_address[1]}'
    httpd.shutdown()
    httpd.predictor.close()
    httpd.server_close()
    t.join(timeout=5)
    assert not t.is_alive()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, json.loads(r.read())


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={'Content-Type': 'application/json'})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_healthz(server):
    code, body = _get(server + '/healthz')
    assert code == 200
    assert body == {'status': 'ok', 'backend': 'cpu', 'warm': True}


def test_http_predict_roundtrip(server):
    code, body = _post(server + '/predict',
                       {'image_b64': _png_b64(), 'return_vertices': True})
    assert code == 200, body
    assert [len(body[k]) for k in ('pose', 'betas', 'camera', 'cam_t')] \
        == [72, 10, 3, 3]
    verts = np.asarray(body['vertices'])
    assert verts.ndim == 2 and verts.shape[1] == 3 and verts.shape[0] > 100
    assert all(np.isfinite(body[k]).all()
               for k in ('pose', 'betas', 'camera', 'cam_t'))
    assert np.isfinite(verts).all() and body['latency_ms'] > 0


def test_http_error_contract(server):
    code, body = _post(server + '/predict', {'image_b64': 'not base64!'})
    assert code == 400 and 'error' in body
    code, body = _post(server + '/predict',
                       {'image_b64': _png_b64(), 'center': [1, 2]})
    assert code == 400 and 'center' in body['error']
    code, _ = _post(server + '/predict', {'no_image': 1})
    assert code == 400
    code, _ = _post(server + '/nope', {})
    assert code == 404
    code, m = _get(server + '/metrics')
    assert code == 200 and m['requests_client_error'] >= 3


# the training and evaluation slice's modules, named so that a move or a
# rename cannot drop one from the walk unnoticed
SLICE5_MODULES = ('cli.train', 'cli.eval', 'train.trainer',
                  'train.checkpoint', 'data.loader', 'data.mixed',
                  'eval.evaluate', 'utils.procrustes')
# and those of EFT and the demo and rendering path
SLICE6_MODULES = ('losses.eft', 'data.eft_dataset', 'fitting.eft',
                  'cli.fit_eft', 'viz', 'viz.native', 'viz.renderer',
                  'cli.demo_tuch')
# and those of the offline tools
OFFLINE_MODULES = ('data.preprocess', 'data.preprocess.dsc',
                   'data.preprocess.mtp', 'data.preprocess.pw3d',
                   'data.preprocess.mpi_inf_3dhp',
                   'data.preprocess.synthetic_raw', 'cli.preprocess',
                   'fitting.smplx_to_smpl', 'cli.smplx_to_smpl',
                   'cli.export_torch', 'cli.parity', 'models.torch_ref',
                   'utils.error_measures', 'utils.dload', 'utils.timing')
# and parallel/, the device mesh on torch.distributed
PARALLEL_MODULES = ('parallel', 'parallel.mesh', 'parallel.multihost',
                    'parallel.contact_parallel')
NAMED_MODULES = SLICE5_MODULES + SLICE6_MODULES + OFFLINE_MODULES \
    + PARALLEL_MODULES


def test_port_imports_no_jax_and_nothing_of_tuch_tpu():
    code = '\n'.join([
        'import importlib, pkgutil, sys',
        'import tuch_tpu_torch',
        'for m in pkgutil.walk_packages(tuch_tpu_torch.__path__,',
        "                               'tuch_tpu_torch.'):",
        '    importlib.import_module(m.name)',
        'import chip_smoke',
        f'missing = [m for m in {NAMED_MODULES!r}',
        "           if 'tuch_tpu_torch.' + m not in sys.modules]",
        'assert not missing, missing',
        "bad = sorted(n for n in sys.modules if n == 'jax'",
        "             or n.startswith(('jax.', 'jaxlib', 'flax'))",
        "             or n == 'tuch_tpu' or n.startswith('tuch_tpu.'))",
        "print(len([n for n in sys.modules",
        "           if n.startswith('tuch_tpu_torch.')]))",
        'assert not bad, bad',
    ])
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 67  # every module was imported


def test_predictor_without_device_raises_when_cuda_is_absent(monkeypatch):
    from tuch_tpu_torch.cli.serve import TuchPredictor
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TuchPredictor(synthetic=True, num_verts=170, img_res=64)
