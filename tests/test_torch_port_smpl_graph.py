"""SMPL's CUDA graphs (models/smpl.SMPLGraphs), as the EFT fit runs them.

On the CPU: bind returns None off the card and captures nothing.

On the card (marked cuda; skipped without one): the full 6890-vertex
synthetic body at B=1 on rotation matrices, float32 with TF32 off and
deterministic algorithms. Three seeded poses and shapes replayed one
after another in the same pair of graphs: each forward replay's vertices,
joints and skeleton joints, and each backward replay's gradients of betas
and rotmat for seeded gradients of vertices and joints, equal eager
smpl_forward and torch.autograd.grad bit for bit; joints_smpl carries no
gradient; one pair of graphs serves all three.
"""

import pytest
import torch

from tuch_tpu_torch import runtime as rt
from tuch_tpu_torch.assets import synthetic_smpl
from tuch_tpu_torch.models.smpl import SMPL, SMPLGraphs, smpl_forward
from tuch_tpu_torch.utils.rotations import batch_rodrigues

SEEDS = (1, 2, 3)
PARTS = ('vertices', 'joints', 'joints_smpl', 'betas_grad', 'rotmat_grad')


def body_inputs(seed, num_verts, device):
    """betas (1, 10), rotmat (1, 24, 3, 3) and gradients of vertices and
    joints, seeded."""
    g = torch.Generator().manual_seed(seed)
    aa = 0.4 * torch.randn(1, 24, 3, generator=g)
    betas = torch.randn(1, 10, generator=g)
    g_verts = torch.randn(1, num_verts, 3, generator=g)
    g_joints = torch.randn(1, 49, 3, generator=g)
    return [x.to(device) for x in (betas, batch_rodrigues(aa), g_verts,
                                   g_joints)]


def smpl_step(forward, betas, rotmat, g_verts, g_joints):
    """forward's outputs and the gradients of betas and rotmat."""
    betas = betas.clone().requires_grad_()
    rotmat = rotmat.clone().requires_grad_()
    out = forward(betas, rotmat)
    grads = torch.autograd.grad((out.vertices, out.joints), (betas, rotmat),
                                (g_verts, g_joints))
    return dict(vertices=out.vertices.clone(), joints=out.joints.clone(),
                joints_smpl=out.joints_smpl.clone(),
                smpl_needs_grad=out.joints_smpl.requires_grad,
                betas_grad=grads[0].clone(), rotmat_grad=grads[1].clone())


@pytest.mark.parametrize('B', [1, 4])
def test_bind_is_none_off_the_card(B):
    smpl = SMPL(synthetic_smpl(num_verts=170)[0])
    graphs = SMPLGraphs(smpl)
    rotmat = torch.eye(3).expand(B, 24, 3, 3)
    assert graphs.bind(torch.zeros(B, 10), rotmat) is None
    assert graphs._steps == {}


@pytest.fixture(scope='module')
def replays():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (CUDA graphs have no CPU mode)')
    dev = torch.device('cuda')
    rt.deterministic(dev)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model, _ = synthetic_smpl()
        smpl = SMPL(model).to(dev)
        nv = smpl.v_template.shape[0]
        graphs = SMPLGraphs(smpl)
        first = body_inputs(SEEDS[0], nv, dev)
        step = graphs.bind(first[0], first[1])
        eager, graph = [], []
        for seed in SEEDS:
            ins = body_inputs(seed, nv, dev)
            assert graphs.bind(ins[0], ins[1]) is step
            graph.append(smpl_step(step, *ins))
            eager.append(smpl_step(
                lambda b, r: smpl_forward(smpl, b, r[:, 1:], r[:, :1],
                                          pose2rot=False), *ins))
        torch.cuda.synchronize()
        yield dict(eager=eager, graph=graph, graphs=graphs)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.cuda
@pytest.mark.parametrize('part', PARTS)
def test_replay_matches_eager_on_card(replays, part):
    for i, (a, b) in enumerate(zip(replays['eager'], replays['graph'])):
        assert torch.equal(a[part], b[part]), (part, SEEDS[i])
    # the seeds move every part: the graphs read each replay's inputs
    assert not torch.equal(replays['graph'][0][part],
                           replays['graph'][1][part])


@pytest.mark.cuda
def test_one_pair_of_graphs_and_no_skeleton_gradient_on_card(replays):
    assert len(replays['graphs']._steps) == 1
    assert not any(r['smpl_needs_grad'] for r in replays['graph'])
