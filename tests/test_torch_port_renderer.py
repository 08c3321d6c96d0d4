"""tuch_tpu_torch's renderer and exports against tuch_tpu's, on the CPU.

The same vertex arrays (the synthetic body posed from a numpy seed) through
both packages' rasterizer and Renderer (render_over, render_rotated,
visualize_tbm, visualize_eft, visu_smplifycontactopti), with contact
regions coloured: bit for bit, since both run the same C++ source built
with the same flags (and, without it, the same numpy code). save_obj,
save_camera_pkl and save_png write the same bytes.
"""

import pickle

import numpy as np
import pytest

from tuch_tpu import assets as jax_assets
from tuch_tpu.models.smpl import smpl_forward as jax_smpl_forward
from tuch_tpu.viz import native as jax_native
from tuch_tpu.viz import renderer as JR
from tuch_tpu_torch import assets as pt_assets
from tuch_tpu_torch.viz import native
from tuch_tpu_torch.viz import renderer as PR


@pytest.fixture(scope='module', params=[170, 6890], ids=['v170', 'v6890'])
def scene(request):
    """Posed bodies (B=3), camera translations, images and contact labels
    of the synthetic body, and both packages' renderers."""
    import jax.numpy as jnp
    model, _ = jax_assets.synthetic_smpl(num_verts=request.param, seed=0,
                                         with_contact=False)
    # the region tables only (equal to the JAX package's, see
    # tests/test_torch_port_contact.py), without the geodesics
    extras = pt_assets.synthetic_contact(request.param, with_geodists=False)
    rng = np.random.RandomState(request.param)
    B = 3
    pose = (rng.randn(B, 72) * 0.4).astype(np.float32)
    betas = (rng.randn(B, 10) * 0.5).astype(np.float32)
    verts = np.asarray(jax_smpl_forward(
        model, jnp.asarray(betas), jnp.asarray(pose[:, 3:]),
        jnp.asarray(pose[:, :3])).vertices)
    cam_t = np.stack([rng.uniform(-0.2, 0.2, B), rng.uniform(-0.2, 0.2, B),
                      rng.uniform(35, 60, B)], -1).astype(np.float32)
    images = rng.rand(B, 64, 64, 3).astype(np.float32)
    P = len(extras.contact_classes)
    contact = (rng.rand(B, P) > 0.5).astype(np.float32)
    faces = np.asarray(model.faces)
    kw = dict(img_res=64, faces=faces,
              contact_classes=extras.contact_classes,
              contact_csig=extras.contact_csig)
    return dict(verts=verts, cam_t=cam_t, images=images, contact=contact,
                faces=faces, jr=JR.Renderer(**kw), pr=PR.Renderer(**kw),
                traj=np.stack([verts + 0.01 * t for t in range(5)]))


def test_rasterizer_bit_for_bit(scene):
    colors = np.random.RandomState(2).rand(
        scene['verts'].shape[1], 3).astype(np.float32)
    for i in range(3):
        v = scene['verts'][i] + scene['cam_t'][i]
        want = jax_native.rasterize(v, scene['faces'], colors, 64, 80,
                                    5000.0, 40.0, 32.0)
        got = native.rasterize(v, scene['faces'], colors, 64, 80, 5000.0,
                               40.0, 32.0)
        assert got[1].sum() > 50      # the body covers the frame
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_renderer_views_bit_for_bit(scene):
    jr, pr = scene['jr'], scene['pr']
    v, c, img, cv = (scene[k] for k in ('verts', 'cam_t', 'images',
                                        'contact'))
    np.testing.assert_array_equal(pr.vertex_colors(v.shape[1], cv[0]),
                                  jr.vertex_colors(v.shape[1], cv[0]))
    for i in range(3):
        for fn, args, kw in (
                ('render_over', (v[i], c[i], img[i]), dict(contact_vec=cv[i])),
                ('render_over', (v[i], c[i]), {}),
                ('render_rotated', (v[i], c[i], 90.0),
                 dict(contact_vec=cv[i])),
                ('render_rotated', (v[i], c[i], 300.0),
                 dict(image=img[i]))):
            got = getattr(pr, fn)(*args, **kw)
            want = getattr(jr, fn)(*args, **kw)
            assert got.shape == want.shape and got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=f'{fn} {i}')


def test_summary_strips_bit_for_bit(scene):
    jr, pr = scene['jr'], scene['pr']
    v, c, img, cv = (scene[k] for k in ('verts', 'cam_t', 'images',
                                        'contact'))
    for fn in ('visualize_tbm', 'visualize_eft'):
        got = getattr(pr, fn)(v, c, img, contact_vecs=cv)
        np.testing.assert_array_equal(got, getattr(jr, fn)(
            v, c, img, contact_vecs=cv))
        assert got.shape == (64, 3 * 64, 3)
    for sample in range(3):
        got = pr.visu_smplifycontactopti(scene['traj'], c, img,
                                         contact_vecs=cv, sample=sample)
        want = jr.visu_smplifycontactopti(scene['traj'], c, img,
                                          contact_vecs=cv, sample=sample)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('scene', [170], indirect=True, ids=['v170'])
def test_numpy_rasterizer_bit_for_bit(scene, monkeypatch):
    """Without a compiler: both packages' numpy rasterizers (170 vertices;
    the numpy version loops over faces)."""
    monkeypatch.setattr(jax_native, 'get_lib', lambda: None)
    monkeypatch.setattr(native, 'get_lib', lambda: None)
    v, c, img, cv = (scene[k] for k in ('verts', 'cam_t', 'images',
                                        'contact'))
    got = scene['pr'].render_over(v[0], c[0], img[0], contact_vec=cv[0])
    want = scene['jr'].render_over(v[0], c[0], img[0], contact_vec=cv[0])
    np.testing.assert_array_equal(got, want)
    assert (got != img[0]).any()


def test_exports_write_the_same_bytes(scene, tmp_path):
    v, faces = scene['verts'][0], scene['faces']
    for tag, mod in (('jax', JR), ('port', PR)):
        rot = mod.rotation_about([0, 1, 0], 60) @ mod.rotation_about(
            [1, 0, 0], 180)
        mod.save_obj(str(tmp_path / f'{tag}.obj'), v @ rot.T, faces)
        mod.save_camera_pkl(str(tmp_path / f'{tag}.pkl'),
                            np.array([[0.9, 0.1, -0.2]], np.float32),
                            scene['cam_t'][0])
        mod.save_png(str(tmp_path / f'{tag}.png'), scene['images'][0])
    for ext in ('obj', 'pkl', 'png'):
        assert (tmp_path / f'port.{ext}').read_bytes() == \
            (tmp_path / f'jax.{ext}').read_bytes(), ext
    with open(tmp_path / 'port.pkl', 'rb') as f:
        cam = pickle.load(f)
    assert cam['cam_transform_1'][0] == -cam['cam_transform'][0]
    np.testing.assert_array_equal(PR.rotation_about([1, 2, 3], 33.0),
                                  JR.rotation_about([1, 2, 3], 33.0))
