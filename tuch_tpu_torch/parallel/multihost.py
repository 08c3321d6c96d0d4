"""Process-group start-up and the per-process split of a work list.

Counterpart of tuch_tpu/parallel/multihost.py. The JAX package reads
JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID; the port
reads torchrun's standard environment (MASTER_ADDR, MASTER_PORT,
WORLD_SIZE, RANK, LOCAL_RANK, LOCAL_WORLD_SIZE):

  torchrun --nproc_per_node 2 -m tuch_tpu_torch.cli.train --mesh_dp 2 ...

The backend follows from the devices: 'nccl' when each rank has a card of
its own, 'gloo' when the ranks run on the CPU or share cards (NCCL refuses
two ranks on one card). A rank on a card uses cuda:(LOCAL_RANK % cards).
The choice is printed and never retried on the other backend.
"""

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from tuch_tpu_torch import resolve_device

# torchrun's variables without which a process group cannot start
TORCHRUN_ENV = ('MASTER_ADDR', 'MASTER_PORT', 'WORLD_SIZE', 'RANK')
TIMEOUT_S = 600.0     # a collective that waits longer fails the run


def backend_for(device: torch.device, local_world: int) -> str:
    """'nccl' when every local rank has a card of its own, else 'gloo'."""
    if device.type == 'cuda' and local_world <= torch.cuda.device_count():
        return 'nccl'
    return 'gloo'


def maybe_initialize_distributed(device=None, init_method: Optional[str] =
                                 None, world_size: Optional[int] = None,
                                 rank: Optional[int] = None,
                                 timeout_s: float = TIMEOUT_S) -> bool:
    """Start the default process group when torchrun's environment (or the
    explicit arguments) asks for one; returns whether a group is up.

    A no-op returning False when none of TORCHRUN_ENV is set and no
    init_method is given; idempotent (True once a group is up). A partial
    environment raises. device: the ranks' device kind (CUDA unless
    'cpu'); a CUDA rank takes cuda:(LOCAL_RANK % cards) as its current
    card. Collectives wait at most timeout_s, then fail.
    """
    if dist.is_initialized():
        return True
    env = os.environ
    if init_method is None:
        present = [k for k in TORCHRUN_ENV if k in env]
        if not present:
            return False
        if len(present) != len(TORCHRUN_ENV):
            missing = sorted(set(TORCHRUN_ENV) - set(present))
            raise ValueError(f'a partial torchrun environment: {missing} '
                             'unset; launch with torchrun --nproc_per_node N')
        init_method = 'env://'
    world_size = int(env['WORLD_SIZE']) if world_size is None else world_size
    rank = int(env['RANK']) if rank is None else rank
    local_rank = int(env.get('LOCAL_RANK', rank))
    local_world = int(env.get('LOCAL_WORLD_SIZE', world_size))
    dev = resolve_device(device)
    if dev.type == 'cuda':
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    backend = backend_for(dev, local_world)
    if rank == 0:
        why = ('one card a rank' if backend == 'nccl' else
               'ranks on the CPU' if dev.type != 'cuda' else
               f'{local_world} ranks share {torch.cuda.device_count()} '
               'card(s)')
        print(f'[dist] backend {backend} ({why}), world size {world_size}',
              flush=True)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def world() -> Tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_size(n_items: int) -> int:
    """The length of a process's shard of a length-n work list: the ceil
    split, ceil(n / world size)."""
    return -(-n_items // world()[1])


def process_shard(n_items: int) -> Tuple[int, int]:
    """This process's [lo, hi) of a length-n work list: contiguous ceil
    splits by rank (shard_size), the whole list without a group."""
    per = shard_size(n_items)
    lo = min(world()[0] * per, n_items)
    return lo, min(lo + per, n_items)
