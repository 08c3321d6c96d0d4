"""tuch_tpu_torch's ResNet-50 options stem_s2d and bn_fold against the stock
model and against tuch_tpu's, on the CPU.

- stem_s2d (in the JAX package the 7x7 stride-2 stem as a 4x4 conv on a
  2x2 space-to-depth input, on the same weight; here the plain stem)
  against the stock model through the whole backbone, at the JAX
  package's bar (tests/test_hmr.py, 2e-5; exact on an odd input); and the
  stem alone against the JAX package's StemS2D on even and odd sizes, at
  the same bar.
- fold_batchnorm's weights and biases against the JAX package's
  fold_batchnorm, element by element at rtol 1e-6, on BatchNorm
  statistics and affines drawn at random (a fresh model's would fold to
  nothing).
- The folded forward, with and without stem_s2d, against the stock eval
  forward at the JAX bar (atol 2e-4 on rotmat, betas and cam), through
  build_runtime and the serving predictor too.
- bn_fold in train mode raises, and so does either option on a ViT.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_train_parity import few_torch_threads  # noqa: F401
from tuch_tpu.models import hmr as JH
from tuch_tpu_torch import assets
from tuch_tpu_torch.models import convert as PC
from tuch_tpu_torch.models import hmr as H

S2D_ATOL = 2e-5     # tests/test_hmr.py test_stem_s2d_equivalence
FOLD_RTOL = 1e-6
FOLD_ATOL = 2e-4    # tests/test_hmr.py test_bn_fold_equivalence

pytestmark = pytest.mark.usefixtures('few_torch_threads')


@pytest.fixture(scope='module')
def means():
    return assets.synthetic_smpl(num_verts=170)[1]


def _randomize_bn(model, seed=0):
    """Non-trivial BatchNorm scales, biases and statistics, in place."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, H.BatchNorm2d):
                n = mod.weight.shape
                mod.weight.copy_(torch.randn(n, generator=g) * 0.3 + 1.0)
                mod.bias.copy_(torch.randn(n, generator=g) * 0.3)
                mod.running_mean.copy_(torch.randn(n, generator=g) * 0.3)
                mod.running_var.uniform_(0.2, 2.0, generator=g)
    return model


def _stock(means, seed=0, **kw):
    return _randomize_bn(H.init_weights(H.create_hmr(*means, **kw)),
                         seed).eval()


@pytest.mark.parametrize('shape,tol', [
    ((2, 64, 64, 3), S2D_ATOL), ((1, 63, 65, 3), 0.0),
    ((2, 224, 224, 3), S2D_ATOL)], ids=['64', 'odd', '224'])
def test_stem_s2d_matches_the_plain_stem(means, shape, tol):
    stock = H.init_weights(H.create_hmr(*means)).eval()
    s2d = H.create_hmr(*means, stem_s2d=True).eval()
    assert set(s2d.state_dict()) == set(stock.state_dict())
    s2d.load_state_dict(stock.state_dict())
    x = torch.from_numpy(np.random.RandomState(0).randn(*shape).astype(
        np.float32))
    with torch.no_grad():
        want, got = stock.features(x), s2d.features(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=tol)


@pytest.mark.parametrize('shape', [(2, 64, 64, 3), (1, 63, 65, 3),
                                   (1, 30, 18, 3)])
def test_stem_s2d_matches_jax_stem_s2d(means, shape):
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    stem = JH.StemS2D()
    variables = stem.init(jax.random.PRNGKey(0), jnp.asarray(x))
    kernel = np.array(variables['params']['kernel'])       # HWIO
    want = np.asarray(stem.apply(variables, jnp.asarray(x)))
    port = H.create_hmr(*means, stem_s2d=True).conv1
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=S2D_ATOL)


def test_fold_batchnorm_matches_jax(means):
    stock = _stock(means)
    sd = {k: v for k, v in stock.state_dict().items()
          if not k.endswith('num_batches_tracked')}
    # the same numbers as the JAX package's variables tree
    jm = JH.create_hmr(*means)
    tree = jax.tree_util.tree_map(np.asarray, JH.init_hmr(
        jm, jax.random.PRNGKey(0), img_res=64))
    def fill(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                fill(v, path + (k,))
                continue
            name = '.'.join(PC._module_path(path, vit=False)
                            + [{'kernel': 'weight', **PC._LEAVES}[k]])
            t = sd[name].numpy()
            node[k] = t.transpose(2, 3, 1, 0) if t.ndim == 4 else (
                t.T if k == 'kernel' else t)
    fill(tree['params'], ())
    fill(tree['batch_stats'], ())
    np.testing.assert_array_equal(
        PC.from_jax_variables(tree)['layer2.0.downsample.1.running_var'],
        sd['layer2.0.downsample.1.running_var'])
    want = PC.from_jax_variables(JH.fold_batchnorm(tree))
    got = H.fold_batchnorm(sd)
    assert set(got) == set(want)
    assert not any('bn' in k or k.endswith(('running_mean', 'running_var'))
                   for k in got)
    assert 'layer1.0.downsample.0.bias' in got and 'conv1.bias' in got
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(),
                                   rtol=FOLD_RTOL, atol=0, err_msg=k)


@pytest.mark.parametrize('stem_s2d', [False, True], ids=['stem', 's2d'])
def test_folded_forward_matches_stock(means, stem_s2d):
    stock = _stock(means, seed=5)
    src = H.create_hmr(*means, stem_s2d=stem_s2d).eval()
    src.load_state_dict(stock.state_dict())
    folded = H.folded(src)
    assert folded.bn_fold and folded.stem_s2d == stem_s2d
    assert not any(isinstance(m, H.BatchNorm2d) for m in folded.modules())
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 64, 64, 3)
                         .astype(np.float32))
    with torch.no_grad():
        for w, g in zip(stock(x), folded(x)):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=FOLD_ATOL)


def test_bn_fold_through_runtime_and_predictor(tmp_path):
    """build_runtime(bn_fold=True) folds the checkpoint's statistics after
    loading it, and TuchPredictor(bn_fold=True) serves that model."""
    from tuch_tpu_torch import runtime as prt
    from tuch_tpu_torch.cli.serve import TuchPredictor
    base = prt.build_runtime(device='cpu', synthetic=True, num_verts=170)
    _randomize_bn(base.hmr, seed=7)
    ckpt = tmp_path / 'w.pt'
    torch.save({'model': base.hmr.state_dict()}, ckpt)
    kw = dict(checkpoint=str(ckpt), synthetic=True, num_verts=170,
              img_res=64, device='cpu')
    stock, fold = TuchPredictor(**kw), TuchPredictor(bn_fold=True, **kw)
    assert fold.hmr.bn_fold and not stock.hmr.bn_fold
    norm = np.random.RandomState(4).randn(2, 64, 64, 3).astype(np.float32)
    want, got = stock._run_forward(norm), fold._run_forward(norm)
    # pose, betas, camera, vertices at the bar; cam_t (~200) relative
    for i in (0, 1, 2, 4):
        np.testing.assert_allclose(got[i], want[i], rtol=0, atol=FOLD_ATOL)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5)
    ckpt.unlink()


def test_stem_s2d_trains(means):
    model = H.init_weights(H.create_hmr(*means, stem_s2d=True)).train()
    x = torch.ones(2, 64, 64, 3)
    rotmat, betas, cam = model(x)
    (rotmat.square().sum() + betas.square().sum()
     + cam.square().sum()).backward()
    g = model.conv1.weight.grad
    assert g.shape == (64, 3, 7, 7)
    assert torch.isfinite(g).all() and g.abs().sum() > 0


def test_options_refused_where_they_do_not_apply(means):
    folded = H.folded(_stock(means))
    with pytest.raises(ValueError, match='inference-only'):
        folded.train()(torch.zeros(1, 64, 64, 3))
    for kw in (dict(stem_s2d=True), dict(bn_fold=True)):
        with pytest.raises(ValueError, match='ResNet-50'):
            H.create_hmr(*means, backbone='vit_t8', **kw)
    vit = H.create_hmr(*means, backbone='vit_t8')
    with pytest.raises(ValueError, match='BatchNorm'):
        H.fold_batchnorm(vit.state_dict())
