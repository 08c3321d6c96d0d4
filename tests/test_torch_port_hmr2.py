"""HMR 2.0 (models/hmr2.py) against its plain reference (models/hmr2_ref.py)
at toy size on the CPU, and its wiring.

HMR 2.0 has no JAX counterpart: the plain float32 reference, which imports
nothing of the port, is what holds it. On the CPU: the model against the
reference in eval and in train on given drop-path masks (outputs and every
parameter's gradient); the padded patch convolution and the cls-slot
position embedding against a direct F.conv2d; the drop-path masks; the
spans; the first three EFT steps of fitting/eft against tuchref's fit
around the reference (the benchmark's reference path); build_runtime and
cli/serve's predictor with --backbone hmr2_toy; the masks' layouts that
models/hmr.HMRGraphs reads; the kernel-1 launch counter's replay count.
This file imports no JAX. The card tests of HMR 2.0's graphs and of kernel
1 at head dim 80 are in test_torch_port_eft_graph.py and
test_torch_port_kernels.py.
"""

import ast
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from tuch_tpu_torch import runtime as rt
from tuch_tpu_torch.models import hmr as H
from tuch_tpu_torch.models import hmr2 as H2
from tuch_tpu_torch.models import hmr2_ref as R
from tuch_tpu_torch.models import vit as V
from tuch_tpu_torch.ops import attention as A

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = 'hmr2_toy'


@pytest.fixture(scope='module', autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def means(seed=0):
    g = np.random.RandomState(seed)
    return (g.randn(144).astype(np.float32), g.randn(10).astype(np.float32),
            np.array([0.9, 0.1, -0.1], np.float32))


def pair(img_res=None, seed=3):
    """The port's HMR 2.0 toy with init_weights(seed) and the reference
    holding the same state."""
    model = H.create_hmr(*means(), backbone=TOY, img_res=img_res)
    H.init_weights(model, seed)
    ref = R.HMR2(*means(), name=TOY, img_res=img_res)
    ref.load_state_dict(model.state_dict())
    return model, ref


def images(B, res, seed=1):
    return torch.randn(B, res, res, 3, generator=torch.Generator()
                       .manual_seed(seed))


@pytest.mark.parametrize('mode', ['eval', 'train'])
def test_hmr2_matches_reference(mode):
    model, ref = pair()
    x = images(2, 64)
    model.train(mode == 'train')
    ref.train(mode == 'train')
    keep = None
    if mode == 'train':
        keep = model.draw_masks(2, torch.Generator().manual_seed(7))
        keep[3, 0] = False           # block 1's MLP dropped for image 0
    got, want = model(x, dropout=keep), ref(x, dropout=keep)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    w = [torch.randn(o.shape, generator=torch.Generator().manual_seed(i))
         for i, o in enumerate(want)]
    ga = torch.autograd.grad(sum((o * c).sum() for o, c in zip(got, w)),
                             list(model.parameters()))
    gb = torch.autograd.grad(sum((o * c).sum() for o, c in zip(want, w)),
                             list(ref.parameters()))
    for (name, _), a, b in zip(model.named_parameters(), ga, gb):
        scale = max(b.abs().max().item(), 1e-30)
        assert (a - b).abs().max().item() <= 1e-5 * scale, name


def test_names_and_shapes_are_the_reference_s():
    model, ref = pair()
    assert [(k, v.shape) for k, v in model.named_parameters()] == \
        [(k, v.shape) for k, v in ref.named_parameters()]


def test_published_widths():
    """hmr2_vith16's shapes, read on the meta device (nothing allocated)."""
    with torch.device('meta'):
        model = H.create_hmr(*means(), backbone='hmr2_vith16')
    shapes = {k: tuple(v.shape) for k, v in model.named_parameters()}
    assert shapes['backbone.pos_embed'] == (1, 193, 1280)
    assert shapes['backbone.patch_embed.proj.weight'] == (1280, 3, 16, 16)
    assert shapes['backbone.blocks.31.attn.qkv.weight'] == (3840, 1280)
    assert shapes['backbone.blocks.31.mlp.fc1.weight'] == (5120, 1280)
    head = 'smpl_head.transformer.transformer.layers.5.'
    assert shapes[head + '0.fn.to_qkv.weight'] == (1536, 1024)
    assert shapes[head + '1.fn.to_kv.weight'] == (1024, 1280)
    assert shapes[head + '1.fn.to_q.weight'] == (512, 1024)
    assert shapes[head + '2.fn.net.3.weight'] == (1024, 1024)
    assert shapes['smpl_head.decpose.weight'] == (144, 1024)
    assert len(shapes) == 500
    assert model.backbone.grid == (16, 12)
    assert model.backbone.blocks[0].attn.heads == 16


def test_patch_and_position_embedding_against_conv2d():
    model, _ = pair()
    bb = model.backbone
    x = images(2, 64)
    lo, hi = H2.crop_columns(64)
    assert (lo, hi) == (8, 56)
    nchw = x[:, :, lo:hi].permute(0, 3, 1, 2)
    w, b = bb.patch_embed.proj.weight, bb.patch_embed.proj.bias
    want = F.conv2d(nchw, w, b, stride=16, padding=2)
    assert want.shape[2:] == bb.grid == (4, 3)
    want = want.flatten(2).transpose(1, 2)
    pos = bb.pos_embed[0]
    want = want + pos[1:] + pos[0]
    got = bb.patch_embed(nchw) + bb.pos_embed[:, 1:] + bb.pos_embed[:, :1]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    # the crop at 256 is 256x192, a 16x12 grid
    assert H2.crop_columns(256) == (32, 224)
    assert V.PatchEmbed.grid(256, 16) == 16 and V.PatchEmbed.grid(192, 16) \
        == 12


def test_drop_path_masks():
    keep = H2.draw_drop_path_masks(4096, torch.Generator().manual_seed(0),
                                   depth=32, rate=0.55)
    assert keep.shape == (64, 4096) and keep.dtype == torch.bool
    assert keep[:2].all()                 # block 0's rate is 0
    rates = torch.linspace(0, 0.55, 32)
    share = 1 - keep.float().mean(1).view(32, 2)
    assert (share - rates[:, None]).abs().max() < 0.04
    probs = V.drop_path_keep_probs(32, 0.55)
    assert probs[0] == 1.0 and abs(probs[-1] - 0.45) < 1e-7


def test_drop_path_scales_kept_branches():
    y = torch.ones(3, 2, 4)
    keep = torch.tensor([True, False, True])
    out = V.drop_path(y, keep, 0.5)
    assert out[:, 0, 0].tolist() == [2.0, 0.0, 2.0]
    assert V.drop_path(y, keep, 1.0) is y
    assert V.drop_path(y, None, 0.5) is y


def test_eval_has_no_drop_path_and_train_draws_without_masks():
    model, _ = pair()
    x = images(1, 64)
    model.eval()
    a = model(x)
    model.train()
    torch.manual_seed(0)
    b = model(x)
    torch.manual_seed(0)
    c = model(x, dropout=model.draw_masks(1))
    for u, v in zip(b, c):
        assert torch.equal(u, v)
    assert not all(torch.equal(u, v) for u, v in zip(a, b))


def test_wrong_crop_size_raises():
    model, _ = pair()
    with pytest.raises(ValueError, match='64x64'):
        model(images(1, 96))


def test_forward_opens_its_spans():
    model, _ = pair()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model(images(1, 64))
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count('hmr.backbone') == 1
    assert names.count('hmr.head') == 1


def test_create_hmr_dispatch_and_refusals():
    assert isinstance(H.create_hmr(*means(), backbone=TOY), H2.HMR2)
    assert isinstance(H.create_hmr(*means(), backbone='vit_t8'), H.HMR)
    with pytest.raises(ValueError, match='hmr2_vith16'):
        H.create_hmr(*means(), backbone='vit_h14')
    with pytest.raises(ValueError, match='ResNet-50'):
        H.create_hmr(*means(), backbone=TOY, bn_fold=True)


def test_init_weights_is_seeded():
    a = H.init_weights(H.create_hmr(*means(), backbone=TOY), 5)
    b = H.init_weights(H.create_hmr(*means(), backbone=TOY), 5)
    for (k, u), v in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(u, v), k
    pos = a.backbone.pos_embed
    assert 0.01 < pos.std().item() < 0.03
    dec = a.smpl_head.decpose.weight
    assert dec.abs().max().item() <= 0.01 * np.sqrt(6 / (64 + 144))


@pytest.mark.parametrize('name', ['hmr', 'hmr2'])
def test_graph_mask_layouts_round_trip(name):
    """HMRGraphs' static mask buffer: load_masks then masks_in gives the
    masks back, in the forward's layout."""
    if name == 'hmr':
        model = H.create_hmr(*means(), backbone='vit_t8')
        masks = H.draw_dropout_masks(2, torch.Generator().manual_seed(1))
    else:
        model = H.create_hmr(*means(), backbone=TOY)
        masks = model.draw_masks(2, torch.Generator().manual_seed(1))
    buf = model.mask_buffer(2, 'cpu')
    assert buf.dtype == torch.bool and buf.all()
    model.load_masks(buf, masks)
    back = model.masks_in(buf)
    if name == 'hmr':
        assert buf.shape == (6, 2, H.HEAD_WIDTH)
        assert all(torch.equal(a, b) for p, q in zip(back, masks)
                   for a, b in zip(p, q))
    else:
        assert buf.shape == (4, 2) and torch.equal(back, masks)


def test_launch_counter_counts_replays():
    before = A.mha_cuda.launches
    A.count_replay(32)
    A.count_replay(0)
    assert A.mha_cuda.launches == before + 32
    A.mha_cuda.launches = before
    assert 80 in A.HEAD_DIMS


def test_reference_is_one_file_importing_only_torch_and_numpy():
    port = os.path.join(REPO, 'tuch_tpu_torch', 'models', 'hmr2_ref.py')
    bench = os.path.join(REPO, 'portbench', 'reference', 'hmr2_ref.py')
    with open(port, 'rb') as f, open(bench, 'rb') as g:
        text = f.read()
        assert text == g.read()
    tops = set()
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Import):
            tops |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops.add(node.module.split('.')[0])
    assert tops == {'numpy', 'torch'}


# ---------------------------------------------------------------------------
# the runtime, the predictor and the EFT fit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('img_res', [64, 224])
def test_build_runtime_and_predictor(img_res):
    from tuch_tpu_torch.cli.serve import TuchPredictor
    r = rt.build_runtime(device='cpu', synthetic=True, num_verts=170,
                         backbone=TOY, img_res=img_res)
    assert isinstance(r.hmr, H2.HMR2) and not r.hmr.training
    assert r.hmr.img_res == img_res
    port = TuchPredictor(synthetic=True, num_verts=170, img_res=img_res,
                         backbone=TOY, device='cpu')
    try:
        port.warmup()
        x = images(1, img_res)
        pose, betas, cam, cam_t, verts = port.forward(x)
        ref = R.HMR2(*(b.numpy() for b in (port.hmr.init_pose,
                                           port.hmr.init_shape,
                                           port.hmr.init_cam)),
                     name=TOY, img_res=img_res)
        ref.load_state_dict(port.hmr.state_dict())
        rotmat, want_betas, want_cam = ref.eval()(x)
        torch.testing.assert_close(betas, want_betas, rtol=0, atol=1e-5)
        torch.testing.assert_close(cam, want_cam, rtol=0, atol=1e-5)
        assert pose.shape == (1, 72) and verts.shape == (1, port.num_verts, 3)
        out = port.predict({'image_b64': _png_b64(), 'bbox': [10, 6, 70, 80]})
        assert np.isfinite(np.asarray(out['pose'])).all()
    finally:
        port.close()


def _png_b64(size=96, seed=0):
    import base64
    import io

    from PIL import Image
    rng = np.random.RandomState(seed)
    img = Image.fromarray(rng.randint(0, 255, (size, size, 3), np.uint8))
    buf = io.BytesIO()
    img.save(buf, format='PNG')
    return base64.b64encode(buf.getvalue()).decode()


STEPS = 3


class StepRecorder:
    """Each step's loss and updated parameters of an EFT module's fits, by
    wrapping its eft_loss and Adam (the port's fitting/eft or tuchref's)."""

    def __init__(self, mp, mod):
        self.steps = []
        rec, loss_fn, base = self, mod.eft_loss, mod.Adam

        def loss(*args, **kwargs):
            total, parts = loss_fn(*args, **kwargs)
            rec.steps.append(dict(loss=total.detach().clone()))
            return total, parts

        class Adam(base):
            def step(self, params, grads):
                out = super().step(params, grads)
                rec.steps[-1]['params'] = {k: v.clone()
                                           for k, v in out.items()}
                return out

        mp.setattr(mod, 'eft_loss', loss)
        mp.setattr(mod, 'Adam', Adam)


def test_first_eft_steps_match_tuchref_around_the_reference(monkeypatch):
    """fitting/eft with hmr2_toy against tuchref's fit around hmr2_ref, as
    the benchmark's check runs it (drivers/fit_hmr2), on the same weights,
    folding start, crop, keypoints, contact labels and drop-path masks:
    each of the first three steps' loss and updated parameters."""
    from portbench.drivers import fit as PF
    from portbench.drivers import fit_hmr2 as D
    from portbench.reference.tuchref.fitting import eft as reft
    from portbench.tests import toy
    from tuch_tpu_torch.fitting import eft
    cfg = toy.load('configs', 'hmr2_vith16')
    cfg.update(backbone=TOY, img_res=64, num_verts=170, num_hidden_layers=2)
    traffic = toy.load('workloads', 'eft_b1_hmr2')
    traffic.update(max_steps=STEPS, min_steps=1)
    seed = 2 ** 31 + 77
    port = StepRecorder(monkeypatch, eft)
    ref = StepRecorder(monkeypatch, reft)
    r = rt.build_runtime(device='cpu', synthetic=True, num_verts=170,
                         backbone=TOY, with_contact=True, img_res=64)
    start = PF.seed_model(r.hmr, cfg, traffic, seed, 'cpu')
    fit = PF.fit_function(eft, r, traffic, 64)
    got = D.fit_image(fit, start, seed, 0, len(r.contact_classes), cfg,
                      'cpu')
    assert got.steps == STEPS
    monkeypatch.setattr(D, 'FirstFit', lambda mod: type(
        'NoRecord', (), dict(arm=lambda self: None,
                             readings=lambda self: {}))())
    want = D.follow(cfg, traffic, seed, 'cpu')
    assert want['steps'] == STEPS
    assert len(port.steps) == len(ref.steps) == STEPS
    for i, (a, b) in enumerate(zip(port.steps, ref.steps)):
        torch.testing.assert_close(a['loss'], b['loss'], rtol=1e-5, atol=0,
                                   msg=f'step {i}')
        for k, v in b['params'].items():
            torch.testing.assert_close(a['params'][k], v, rtol=0,
                                       atol=1e-6, msg=f'step {i}: {k}')


def test_fit_eft_cli_fits_hmr2_on_its_own_masks(tmp_path, monkeypatch):
    """cli/fit_eft --backbone hmr2_toy: the fit draws HMR 2.0's drop-path
    masks (its draw_masks), never the IEF head's."""
    from tuch_tpu_torch.cli import fit_eft as pcli
    from tuch_tpu_torch.fitting import eft

    def no_ief_masks(*args, **kwargs):
        raise AssertionError('the IEF head\'s masks were drawn for HMR 2.0')
    monkeypatch.setattr(eft, 'draw_dropout_masks', no_ief_masks)
    (path,) = pcli.main(['--synthetic', '--synthetic_num_verts', '170',
                         '--img_res', '64', '--cbs', '2', '--max_steps', '3',
                         '--backbone', TOY, '--device', 'cpu',
                         '--out_dir', str(tmp_path)])
    with np.load(path) as d:
        assert np.isfinite(d['pose']).all() and np.isfinite(d['betas']).all()
        assert list(d['indices']) == [0, 1]
