"""The seeded generators repeat from their seed, and every seed gets the
same amount of work."""

import torch

from portbench import common
from portbench.drivers import fit

SEED = 2 ** 31 + 11           # past 32 signed bits, as a check's seeds are


def test_weights_repeat_from_the_seed():
    shapes = {'conv1.weight': (8, 3, 3, 3), 'bn1.weight': (8,),
              'bn1.bias': (8,), 'decpose.weight': (4, 16)}
    a = common.seeded_weights(shapes, SEED, 'cpu')
    b = common.seeded_weights(shapes, SEED, 'cpu')
    c = common.seeded_weights(shapes, SEED + 1, 'cpu')
    for k in shapes:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a['conv1.weight'], c['conv1.weight'])
    assert torch.equal(a['bn1.weight'], torch.ones(8))
    assert torch.equal(a['bn1.bias'], torch.zeros(8))
    assert float(a['decpose.weight'].std()) < 0.01


def test_images_repeat_with_the_same_shapes():
    def draw(seed, i):
        img, kp, contact, gen = fit.image_inputs(seed, i, 5, 32, 'cpu')
        return img, kp, contact, fit.draw_masks(1, gen, 'cpu')
    a, b = draw(SEED, 3), draw(SEED, 3)
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x, y)
    for (a0, a1), (b0, b1) in zip(a[3], b[3]):
        assert torch.equal(a0, b0) and torch.equal(a1, b1)
    for other in (draw(SEED, 4), draw(SEED + 1, 3)):
        assert not torch.equal(a[0], other[0])
        assert [x.shape for x in other[:3]] == [x.shape for x in a[:3]]
    assert a[0].shape == (1, 32, 32, 3) and a[1].shape == (1, 49, 3)
    assert a[2].shape == (1, 5)


def test_masks_and_fold_pose_repeat():
    g = [common.seeded_generator(SEED, 15, 'cpu') for _ in range(2)]
    m0, m1 = (fit.draw_masks(4, gen, 'cpu') for gen in g)
    for (a0, a1), (b0, b1) in zip(m0, m1):
        assert torch.equal(a0, b0) and torch.equal(a1, b1)
    assert len(m0) == 3 and m0[0][0].shape == (4, 1024)
    p = [common.fold_pose6d(common.seeded_generator(SEED, 14, 'cpu'), 1.5,
                            'cpu') for _ in range(2)]
    assert torch.equal(p[0], p[1]) and p[0].shape == (1, 144)
    # each 6D pair is two orthonormal columns of a rotation
    cols = p[0].view(24, 3, 2)
    assert torch.allclose(cols.norm(dim=1), torch.ones(24, 2), atol=1e-5)
