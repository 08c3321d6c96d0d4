"""tuch_tpu_torch's parallel/ against tuch_tpu's, on gloo CPU ranks.

The cases of tests/test_parallel.py, on meshes of 2 and 4 ranks (dp x cp
= 1x2, 2x2, 1x4), each rank a spawned process (tests/_torch_dist.py): the
winding numbers with the triangle axis over cp, contact_neighbors exact
and with candidate_k, the masked nearest vertex over cp, the contact
fitting loss full and compacted, the batch's sharding round trip and the
per-process split, each against the JAX package's single-device result
(its own tests hold its cp mesh to that) and the port's single process.
Then the parts that need no ranks: shard_params_tp's split dims against
the JAX package's NamedSharding specs through the port's parameter names,
the mesh's size rules, the no-op start-up, and kernel 4's range keys.

Tolerances: winding atol 1e-5 (tests/test_parallel.py's); flags and
argmins exact; the losses rtol 1e-4 against JAX (the SMPLify slice's loss
bar, tests/test_torch_port_smplify.py) and rtol 1e-6 against the port's
single process (tests/test_parallel.py's cp bar). The ranks of a cp group
agree bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import _torch_dist as D
from tests.test_contact import unit_cube
from tests.test_parallel import _tiny_contact_problem
from tuch_tpu import assets as jax_assets
from tuch_tpu.losses import smplify as JSL
from tuch_tpu.losses.prior import create_gmm_prior
from tuch_tpu.models import hmr as jax_hmr
from tuch_tpu.models.smpl import smpl_forward_pose72
from tuch_tpu.ops.contact import winding_numbers_same_tris
from tuch_tpu.parallel import mesh as jmesh
from tuch_tpu_torch.models import convert as PC
from tuch_tpu_torch.models.hmr import HMR
from tuch_tpu_torch.ops import contact as PCo
from tuch_tpu_torch.ops import contact_kernels as CK
from tuch_tpu_torch.parallel import contact_parallel as CPAR
from tuch_tpu_torch.parallel import mesh as PM
from tuch_tpu_torch.parallel import multihost

MESHES = [(1, 2), (2, 2), (1, 4)]
K = 32
LOSS_RTOL = 1e-4
CP_RTOL = 1e-6


def _loss_inputs(B, seed, ignore=None, compact=None):
    """tests/test_parallel.py's contact-loss inputs as numpy."""
    model, extras, ca, verts = _tiny_contact_problem(B=B)
    rng = np.random.RandomState(seed)
    pose = (rng.randn(B, 72) * 0.1).astype(np.float32)
    out = smpl_forward_pose72(model, jnp.zeros((B, 10)), jnp.asarray(pose))
    P = ca.region_idx_a.shape[0]
    kp2d = rng.uniform(0, 224, (B, 49, 2)).astype(np.float32)
    gt = (rng.rand(B, P) > 0.5).astype(np.float32)
    return dict(
        pose=pose, betas=np.zeros((B, 10), np.float32),
        joints=np.asarray(out.joints), verts=np.asarray(out.vertices),
        cam_t=np.tile([[0, 0, 20.0]], (B, 1)).astype(np.float32),
        cc=np.full((B, 2), 112.0, np.float32), kp2d=kp2d,
        conf=np.ones((B, 49), np.float32), gt_contact=gt,
        ignore=np.zeros(B, bool) if ignore is None else ignore,
        has_disc=np.ones(B, bool), compact=compact)


def _jax_loss(ca, prior, x, compact=None):
    return float(JSL.contact_fitting_loss(
        jnp.asarray(x['pose'][:, 3:]), jnp.asarray(x['pose'][:, :3]),
        jnp.asarray(x['betas']), jnp.asarray(x['joints']),
        jnp.asarray(x['verts']), jnp.asarray(x['cam_t']),
        jnp.asarray(x['cc']), jnp.asarray(x['kp2d']),
        jnp.asarray(x['conf']), prior, ca, jnp.asarray(x['gt_contact']),
        jnp.asarray(x['ignore']), jnp.asarray(x['has_disc']),
        euclthres=0.02,
        compact_idx=None if compact is None else jnp.asarray(compact)))


@pytest.fixture(scope='module')
def problem():
    """Both packages' inputs and the JAX package's single-device answers."""
    model, extras, ca, verts = _tiny_contact_problem()
    cube_v, cube_f = unit_cube()
    B = 4
    cube_verts = np.tile(cube_v[None], (B, 1, 1))
    cube_pts = np.array([[[0, 0, 0], [2, 0, 0], [0.2, 0.1, -0.3],
                          [0, 1.2, 0]]], np.float32).repeat(B, 0)
    gmm = jax_assets.synthetic_gmm_prior()
    jprior = create_gmm_prior(gmm)
    ignore = np.array([False, True] * 4)
    compact = np.asarray(JSL.compact_take(jnp.asarray(~ignore), 4))
    losses = {'full': _loss_inputs(4, 5),
              'compacted': _loss_inputs(8, 7, ignore, compact),
              'uncompacted': _loss_inputs(8, 7, ignore)}
    want = {
        'winding': np.asarray(winding_numbers_same_tris(
            jnp.asarray(cube_pts), jnp.asarray(cube_verts),
            jnp.asarray(cube_f), block_f=4)),
        'neighbors': [np.asarray(a) for a in JSL.contact_neighbors(
            verts, ca)],
        'neighbors_k': [np.asarray(a) for a in JSL.contact_neighbors(
            verts, ca, candidate_k=K)],
        'loss_full': _jax_loss(ca, jprior, losses['full']),
        'loss_compacted': _jax_loss(ca, jprior, losses['compacted'],
                                    compact),
        'loss_uncompacted': _jax_loss(ca, jprior, losses['uncompacted']),
    }
    fields = {k: np.asarray(getattr(ca, k)) for k in (
        'geomask', 'faces', 'region_idx_a', 'region_idx_b',
        'region_mask_a', 'region_mask_b')}
    payload = dict(
        cube_pts=cube_pts, cube_verts=cube_verts,
        cube_faces=cube_f.astype(np.int64), assets=fields,
        verts=np.asarray(verts), K=K,
        prior=tuple(np.asarray(x) for x in jprior), losses=losses,
        batch_x=np.arange(8 * 3, dtype=np.float32).reshape(8, 3),
        shard_n=10)
    return payload, want


@pytest.fixture(scope='module', params=MESHES,
                ids=[f'dp{d}xcp{c}' for d, c in MESHES])
def ranks(request, problem, tmp_path_factory):
    dp, cp = request.param
    payload, _ = problem
    out = D.spawn('contact', dp * cp, tmp_path_factory.mktemp('ranks'),
                  dict(payload, dp=dp, cp=cp))
    return dp, cp, out


def _rows(out, key):
    """The global batch of a per-rank output: cp rank 0's rows of each dp
    row, in dp order."""
    mine = sorted((r for r in out if r['cp_rank'] == 0),
                  key=lambda r: r['dp_rank'])
    return torch.cat([r[key] for r in mine]).numpy()


def _dp_sum(out, key):
    return sum(float(r[key]) for r in out if r['cp_rank'] == 0)


def test_cp_ranks_agree_bit_for_bit(ranks):
    dp, cp, out = ranks
    for r in out:
        peer = out[r['dp_rank'] * cp]
        for k in ('winding', 'exterior', 'argmin', 'exterior_k', 'argmin_k',
                  'min_d2', 'argmin_mm', 'loss_full', 'loss_compacted'):
            assert torch.equal(r[k], peer[k]), k


def test_winding_cp_matches_single_device(ranks, problem):
    _, want = problem
    got = _rows(ranks[2], 'winding')
    np.testing.assert_allclose(got, want['winding'], atol=1e-5)
    np.testing.assert_allclose(got[0, :2], [1.0, 0.0], atol=1e-4)


def test_contact_neighbors_cp_matches_single_device(ranks, problem):
    payload, want = problem
    out = ranks[2]
    np.testing.assert_array_equal(_rows(out, 'exterior'),
                                  want['neighbors'][0])
    np.testing.assert_array_equal(_rows(out, 'argmin'), want['neighbors'][1])
    # the exact route is one contact_neighbors_cp call, nothing else
    assert out[0]['cp_calls'] == {'contact_neighbors_cp': 1,
                                  'masked_min_cp': 0,
                                  'winding_numbers_cp': 0}


def test_contact_neighbors_cp_candidate_k(ranks, problem):
    _, want = problem
    out = ranks[2]
    np.testing.assert_array_equal(_rows(out, 'exterior_k'),
                                  want['neighbors_k'][0])
    np.testing.assert_array_equal(_rows(out, 'argmin_k'),
                                  want['neighbors_k'][1])


def test_masked_min_cp_matches_single_process(ranks, problem):
    payload, _ = problem
    mask = torch.from_numpy(payload['assets']['geomask'].astype(np.uint8))
    d2, idx = PCo.masked_min_dist(torch.from_numpy(payload['verts']), mask)
    np.testing.assert_array_equal(_rows(ranks[2], 'min_d2'), d2.numpy())
    np.testing.assert_array_equal(_rows(ranks[2], 'argmin_mm'), idx.numpy())


@pytest.mark.parametrize('name', ['full', 'compacted'])
def test_contact_fitting_loss_cp_matches_single_device(ranks, problem,
                                                       name):
    payload, want = problem
    got = _dp_sum(ranks[2], f'loss_{name}')
    np.testing.assert_allclose(got, want[f'loss_{name}'], rtol=LOSS_RTOL)


def test_contact_fitting_loss_compacted_cp_matches_full(ranks, problem):
    """Compaction composes with the cp split and with dp: the compacted
    loss over the global batch, each rank running its part of it, equals
    the full loss where the capacity covers every active sample."""
    _, want = problem
    got = _dp_sum(ranks[2], 'loss_compacted')
    np.testing.assert_allclose(got, want['loss_uncompacted'],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(want['loss_compacted'],
                               want['loss_uncompacted'], rtol=CP_RTOL)


def test_batch_sharding_roundtrip(ranks, problem):
    payload, _ = problem
    dp, cp, out = ranks
    x = payload['batch_x']
    for r in out:
        n = len(x) // dp
        np.testing.assert_array_equal(
            r['batch_local'].numpy(), x[r['dp_rank'] * n:][:n])
        np.testing.assert_array_equal(r['batch_back'].numpy(), x)


def test_process_shard_by_rank(ranks):
    dp, cp, out = ranks
    world = dp * cp
    per = -(-10 // world)
    for rank, r in enumerate(out):
        lo = min(rank * per, 10)
        assert tuple(r['process_shard']) == (lo, min(lo + per, 10))
        assert r['shard_size'] == per


# ---------------------------------------------------------------------------
# without ranks
# ---------------------------------------------------------------------------

def _spec_code(spec):
    P = jax.sharding.PartitionSpec
    return {P(): None, P(None, 'cp'): 0, P('cp', None): 1}[spec]


@pytest.mark.parametrize('backbone', ['resnet50', 'vit_t8'])
def test_shard_params_tp_matches_jax_specs(backbone):
    """Each parameter's split dim, through the port's names: the JAX
    package's spec of each Flax leaf, carried to the port's name and
    layout by models/convert (a Dense kernel (in, out) becomes the torch
    weight (out, in), so P(None, 'cp') is dim 0)."""
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 virtual devices')
    m = jax_hmr.create_hmr(np.zeros(144, np.float32),
                           np.zeros(10, np.float32),
                           np.zeros(3, np.float32), backbone=backbone)
    variables = m.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                       train=False)
    specs = jmesh.shard_params_tp(variables['params'],
                                  jmesh.make_mesh(dp=4, cp=2))
    # a leaf shaped like its parameter, filled with its spec's code + 1
    coded = jax.tree_util.tree_map(
        lambda s, p: np.full(np.shape(p), -1 if _spec_code(s.spec) is None
                             else _spec_code(s.spec), np.float32),
        specs, variables['params'])
    want = {k: (None if v.flatten()[0] < 0 else int(v.flatten()[0]))
            for k, v in PC.params_from_jax(coded).items()}
    hmr = HMR(np.zeros(144, np.float32), np.zeros(10, np.float32),
              np.zeros(3, np.float32), backbone=backbone)
    got = PM.shard_params_tp(hmr.named_parameters())
    assert got == want
    assert sum(v is not None for v in got.values()) >= 2


def test_put_tree_splits_over_cp():
    mesh = PM.Mesh(dp=1, cp=2, rank=1, device='cpu')
    tree = {'fc1.weight': torch.arange(12.).reshape(4, 3),
            'fc2.weight': torch.arange(12.).reshape(3, 4),
            'fc1.bias': torch.arange(4.)}
    dims = PM.shard_params_tp(tree.items())
    assert dims == {'fc1.weight': 0, 'fc2.weight': 1, 'fc1.bias': None}
    got = PM.put_tree(tree, dims, mesh)
    assert torch.equal(got['fc1.weight'], tree['fc1.weight'][2:])
    assert torch.equal(got['fc2.weight'], tree['fc2.weight'][:, 2:])
    assert torch.equal(got['fc1.bias'], tree['fc1.bias'])


def test_mesh_dims_rules():
    assert PM.mesh_dims(0, 2, 4) == (2, 2)
    assert PM.mesh_dims(2, 2, 4) == (2, 2)
    with pytest.raises(ValueError, match='torchrun --nproc_per_node 4'):
        PM.mesh_dims(2, 2, 1)
    with pytest.raises(ValueError, match='torchrun --nproc_per_node 2'):
        PM.mesh_dims(2, 1, 4)      # a rank left out would hang its peers
    with pytest.raises(ValueError, match='does not divide'):
        PM.mesh_dims(0, 3, 4)


def test_single_process_mesh_is_a_no_op():
    mesh = PM.make_mesh(dp=1, cp=1, device='cpu')
    assert mesh.shape == {'dp': 1, 'cp': 1}
    assert mesh.dp_group is None and mesh.cp_group is None
    x = torch.randn(4, 3)
    assert PM.dp_gather(x, mesh) is x and PM.dp_sum(x, mesh) is x
    assert PM.shard_batch({'x': x}, mesh)['x'] is x


def test_process_shard_single_host():
    assert multihost.process_shard(100) == (0, 100)
    assert multihost.shard_size(100) == 100


def test_maybe_initialize_distributed_noop(monkeypatch):
    for k in multihost.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    assert multihost.maybe_initialize_distributed('cpu') is False
    monkeypatch.setenv('WORLD_SIZE', '2')
    with pytest.raises(ValueError, match='partial torchrun environment'):
        multihost.maybe_initialize_distributed('cpu')


def test_shard_range_cuts_at_mask_words():
    for n, parts in ((6890, 2), (6890, 4), (13776, 4), (110, 4), (12, 2)):
        cuts = [CPAR.shard_range(n, parts, i) for i in range(parts)]
        assert cuts[0][0] == 0 and cuts[-1][1] == n
        for (a, b), (c, d) in zip(cuts, cuts[1:]):
            assert b == c
        # kernel 4 reads whole mask words: a range starts on one (or is
        # empty) and ends on one or at the axis's end
        for lo, hi in cuts:
            assert (lo % CPAR.ALIGN == 0 or lo == hi) \
                and (hi % CPAR.ALIGN == 0 or hi == n)


def _tie_body(seed):
    """Vertices with exact d2 ties across the cuts (repeated points) and a
    query with nothing allowed."""
    rng = np.random.RandomState(seed)
    v = rng.randn(3, 100, 3).astype(np.float32)
    v[:, 40:44] = v[:, 70:74]
    v[:, 10] = v[:, 90]
    mask = (rng.rand(100, 100) > 0.3).astype(np.uint8)
    mask[5] = 0
    return torch.from_numpy(v), torch.from_numpy(mask)


@pytest.mark.parametrize('cuts', [(0, 100), (0, 32, 100), (0, 32, 64, 100),
                                  (0, 64, 96, 100)],
                         ids=['whole', 'two', 'three', 'uneven'])
def test_masked_min_keys_ref_ranges_give_masked_min_dist(cuts):
    """The MIN of the plain range keys over ranges that cover the axis
    decodes to masked_min_dist exactly: ties to the lowest index, +inf and
    index 0 where nothing is allowed."""
    verts, mask = _tie_body(len(cuts))
    want = PCo.masked_min_dist(verts, mask)
    keys = [CK.masked_min_keys_ref(verts, mask, a, b)
            for a, b in zip(cuts, cuts[1:])]
    got = CK.decode_keys(torch.stack(keys).amin(0))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.isinf(got[0][:, 5]).all() and (got[1][:, 5] == 0).all()
    assert (torch.stack(keys) >= 0).all()
