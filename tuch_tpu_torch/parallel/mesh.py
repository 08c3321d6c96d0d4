"""The (dp, cp) mesh of ranks and the collectives of the port.

Counterpart of tuch_tpu/parallel/mesh.py. In the JAX package a mesh is one
program over several devices: jit with a dp-sharded batch computes what
one device computes, and XLA inserts the collectives. Here each rank is a
process that holds its part, and every place where the global semantics
couple the batch reduces by hand (train/module.py lists them):

  * axis 'dp' -- data parallel: each dp row of ranks holds a slice of the
    global batch; gradients, metrics, BatchNorm statistics and masked means
    reduce over it;
  * axis 'cp' -- contact parallel: the ranks of a dp row hold the same
    slice and split the triangle and searched axes of the contact
    quadratics (parallel/contact_parallel.py).

Ranks are row-major, as JAX's devices.reshape(dp, cp): rank = dp_rank * cp
+ cp_rank. The collectives are all_reduce and broadcast only, the two
that gloo also takes on CUDA tensors, so ranks may share a card. A gather
writes each rank's rows into a zero buffer of the global shape and sums
it over the integers of its bits, which is exact (the sign of a zero and
a NaN's payload included).
"""

from typing import Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as dist

from tuch_tpu_torch import resolve_device
from tuch_tpu_torch.parallel import multihost


class Mesh:
    """dp x cp ranks; this rank's place (dp_rank, cp_rank), the process
    groups of its dp column (the ranks with its cp_rank) and its cp row
    (None where the axis has size 1), and its device."""

    def __init__(self, dp: int, cp: int, rank: int, device,
                 dp_group=None, cp_group=None):
        self.dp, self.cp, self.rank = dp, cp, rank
        self.dp_rank, self.cp_rank = divmod(rank, cp)
        self.dp_group, self.cp_group = dp_group, cp_group
        self.device = torch.device(device)

    @property
    def shape(self) -> Dict[str, int]:
        return {'dp': self.dp, 'cp': self.cp}


def mesh_dims(dp: int, cp: int, world: int) -> Tuple[int, int]:
    """(dp, cp) of a mesh over `world` ranks; dp=0 means world // cp.
    Raises unless dp * cp == world: a rank with no place in the mesh would
    hang its peers' collectives (the JAX package's mesh may leave devices
    out, dp * cp <= devices)."""
    if cp < 1 or dp < 0:
        raise ValueError(f'mesh dp={dp}, cp={cp}: dp >= 0 and cp >= 1')
    if dp == 0:
        if world % cp:
            raise ValueError(f'mesh cp={cp} does not divide the world size '
                             f'{world}: launch with torchrun '
                             f'--nproc_per_node {cp} (or a multiple of it)')
        dp = world // cp
    if dp * cp != world:
        raise ValueError(
            f'a {dp}x{cp} mesh needs {dp * cp} ranks, the world has {world}: '
            f'launch with torchrun --nproc_per_node {dp * cp}')
    return dp, cp


def make_mesh(dp: int = 0, cp: int = 1, device=None) -> Mesh:
    """The (dp, cp) mesh over the default process group's ranks (one rank
    without a group). Every rank creates every group, in the same order."""
    rank, world = multihost.world()
    dp, cp = mesh_dims(dp, cp, world)
    dp_group = cp_group = None
    if world > 1:
        for c in range(cp):
            g = dist.new_group([d * cp + c for d in range(dp)])
            if rank % cp == c and dp > 1:
                dp_group = g
        for d in range(dp):
            g = dist.new_group([d * cp + c for c in range(cp)])
            if rank // cp == d and cp > 1:
                cp_group = g
    return Mesh(dp, cp, rank, resolve_device(device), dp_group, cp_group)


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    """all_reduce t in place over `group` (nothing for None) and return it;
    a CPU tensor goes through the device where the backend is NCCL."""
    if group is None:
        return t
    if t.device.type == 'cpu' and dist.get_backend(group) == 'nccl':
        dev = t.to(torch.device('cuda', torch.cuda.current_device()))
        dist.all_reduce(dev, op=op, group=group)
        return t.copy_(dev)
    dist.all_reduce(t, op=op, group=group)
    return t


def dp_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum over the dp axis of x (a new tensor, without gradient); x
    itself without a mesh or with dp 1."""
    if mesh is None or mesh.dp_group is None:
        return x
    return all_reduce_(x.detach().clone(), mesh.dp_group)


def local_rows(mesh: Optional[Mesh], b_local: int) -> Tuple[int, int]:
    """[lo, hi) of this rank's rows in the global batch."""
    lo = 0 if mesh is None else mesh.dp_rank * b_local
    return lo, lo + b_local


def _as_ints(x: torch.Tensor):
    """x as integers of at least 32 bits whose sum with zeros is exact,
    and the inverse."""
    if x.dtype == torch.bool:
        return x.to(torch.int32), lambda y: y.bool()
    if x.is_floating_point():
        iv = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            x.element_size()]
        i = x.contiguous().view(iv)
        if iv == torch.int16:
            return i.to(torch.int32), lambda y: y.to(iv).view(x.dtype)
        return i, lambda y: y.view(x.dtype)
    if x.element_size() < 4:
        return x.to(torch.int32), lambda y: y.to(x.dtype)
    return x, lambda y: y


def dp_gather(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The global batch of a (B_local, ...) tensor: every rank's rows in dp
    order, on every rank, bit for bit (a zero buffer summed over its
    integers). x itself without a mesh or with dp 1."""
    if mesh is None or mesh.dp_group is None:
        return x
    ints, back = _as_ints(x.detach())
    b = x.shape[0]
    buf = ints.new_zeros((b * mesh.dp,) + tuple(x.shape[1:]))
    lo, hi = local_rows(mesh, b)
    buf[lo:hi] = ints
    return back(all_reduce_(buf, mesh.dp_group))


def shard_rows(x, mesh: Optional[Mesh]):
    """This rank's dp slice of a global (B, ...) array or tensor; B must
    divide over dp."""
    if mesh is None or mesh.dp == 1:
        return x
    B = x.shape[0]
    if B % mesh.dp:
        raise ValueError(f'batch of {B} does not divide over dp={mesh.dp}')
    lo, hi = local_rows(mesh, B // mesh.dp)
    return x[lo:hi]


def shard_batch(batch: dict, mesh: Optional[Mesh]) -> dict:
    """This rank's dp slice of every entry of a global batch (the JAX
    package's batch_sharding: the batch axis over dp, replicated over
    cp)."""
    return {k: shard_rows(v, mesh) for k, v in batch.items()}


def local_compact(compact_idx: torch.Tensor, mesh: Optional[Mesh],
                  b_local: int) -> torch.Tensor:
    """The entries of a global compaction (losses/smplify.compact_take over
    the global batch) that fall in this rank's rows, as local indices, in
    the compaction's order."""
    lo, hi = local_rows(mesh, b_local)
    mine = compact_idx[(compact_idx >= lo) & (compact_idx < hi)]
    return (mine - lo).long()


def all_reduce_grads(grads, mesh: Optional[Mesh]):
    """The sum over dp of a sequence of gradients, as one flat all_reduce
    (gradients whose loss has global denominators are partial sums; not
    DDP's mean over the world)."""
    if mesh is None or mesh.dp_group is None:
        return list(grads)
    flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads]),
                       mesh.dp_group)
    out, off = [], 0
    for g in grads:
        out.append(flat[off:off + g.numel()].view_as(g))
        off += g.numel()
    return out


def broadcast_(tensors: Iterable[torch.Tensor], mesh: Optional[Mesh],
               src: int = 0):
    """Broadcast each tensor in place from rank `src` to every rank (the
    JAX package's replicated sharding); CPU tensors go through the device
    where the backend is NCCL."""
    if mesh is None or mesh.dp * mesh.cp == 1:
        return
    nccl = dist.get_backend() == 'nccl'
    for t in tensors:
        if nccl and t.device.type == 'cpu':
            dev = t.to(torch.device('cuda', torch.cuda.current_device()))
            dist.broadcast(dev, src)
            t.copy_(dev)
        else:
            dist.broadcast(t, src)


def replicated(module: torch.nn.Module, mesh: Optional[Mesh]):
    """Broadcast a module's parameters and buffers from rank 0."""
    with torch.no_grad():
        broadcast_(list(module.parameters()) + list(module.buffers()), mesh)
    return module


# The JAX package's tensor-parallel rules (mesh.shard_params_tp), on the
# torch weights' (out, in) layout: a Flax kernel P(None, 'cp') splits its
# output dim, torch weight dim 0; P('cp', None) its input dim, dim 1.
_TP_DIMS = {'fc1': 0, 'qkv': 0, 'fc2': 1, 'proj': 1}


def shard_params_tp(named_params, mesh: Optional[Mesh] = None
                    ) -> Dict[str, Optional[int]]:
    """The dim of each 2-D Linear weight that cp splits (None: replicated),
    by parameter name: fc1 and qkv split their output dim, fc2 and proj
    their input dim; every other parameter is replicated. A spec, as in the
    JAX package: no path applies it. named_params: (name, tensor) pairs,
    e.g. HMR.named_parameters()."""
    out = {}
    for name, p in named_params:
        parts = name.split('.')
        out[name] = _TP_DIMS.get(parts[-2]) if (
            len(parts) >= 2 and parts[-1] == 'weight' and p.dim() == 2) \
            else None
    return out


def put_tree(tree: Dict[str, torch.Tensor], dims: Dict[str, Optional[int]],
             mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's part of each tensor under shard_params_tp's dims: a
    contiguous 1/cp of the split dim by cp_rank (which must divide it),
    the whole tensor where the dim is None; on the mesh's device."""
    out = {}
    for k, t in tree.items():
        d = dims.get(k)
        if d is not None and mesh.cp > 1:
            if t.shape[d] % mesh.cp:
                raise ValueError(f'{k}: dim {d} of {tuple(t.shape)} does not '
                                 f'divide over cp={mesh.cp}')
            t = t.chunk(mesh.cp, dim=d)[mesh.cp_rank]
        out[k] = t.to(mesh.device)
    return out
