"""Batched row gather and scatter-add by index, and gather_rows.

Counterpart of tuch_tpu/ops/gather_pallas.py. The kernels are CUDA C++ in
csrc/gather.cu (see its header for the design): kernel 5 gathers rows,
kernel 6 scatter-adds them. gather_rows is differentiable: its forward is
the gather and its backward the scatter-add, so the gradient of a
re-gathered nearest vertex reaches both contact endpoints.

Indices are int32, as in the JAX kernels: an index outside [0, V) gathers
a zero row and scatters nothing. The scatter kernel sums each row's
contributions in ascending q with no float atomics, so on the card its
result is the same from run to run and equals the plain version's on the
CPU bit for bit; several CTAs share a batch item (scatter_plan). The
wrappers are on the fit's host path once per body iteration each: they
resolve their C entry once (_build.entry) and enter a device guard only
for a tensor off the current device.
"""

import ctypes

import torch

from portbench.reference.tuchref.ops import _build

_GATHER_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_SCATTER_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p]
INDEX_LIMIT = 2 ** 31        # the scatter kernel indexes in 32 bits
MAX_BATCH = 65535            # its batch is blockIdx.y
MAX_SHARED = 232448          # csrc/gather.cu MAX_SHARED: a block's 227 KB
MAX_SPLIT = 32               # csrc/gather.cu: CTAs per batch item at most
H100_SMS = 132               # the plan's SM count where no card is asked


def _flat_rows(idx: torch.Tensor, num_rows: int):
    """int32 (B, Q) -> (valid (B, Q), flat row of (B * V) as int64)."""
    idx = idx.long()
    valid = (idx >= 0) & (idx < num_rows)
    base = torch.arange(idx.shape[0], device=idx.device)[:, None] * num_rows
    return valid, base + idx.clamp(0, num_rows - 1)


def gather_rows_ref(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: values (B, V, 3), idx (B, Q) -> (B, Q, 3) with
    torch.gather; out-of-range indices give zero rows."""
    B, V, C = values.shape
    valid, _ = _flat_rows(idx, V)
    got = torch.gather(values, 1,
                       idx.long().clamp(0, V - 1)[..., None].expand(-1, -1,
                                                                    C))
    return torch.where(valid[..., None], got, torch.zeros_like(got))


def scatter_add_rows_ref(contrib: torch.Tensor, idx: torch.Tensor,
                         num_rows: int) -> torch.Tensor:
    """Plain version: contrib (B, Q, 3), idx (B, Q) -> (B, num_rows, 3)
    with index_add_ (on the CPU it adds in ascending q, as kernel 6 does);
    out-of-range indices are dropped (they add +0 to a clamped row, which
    changes no sum)."""
    B, Q, C = contrib.shape
    valid, flat = _flat_rows(idx, num_rows)
    src = torch.where(valid[..., None], contrib, torch.zeros_like(contrib))
    out = contrib.new_zeros((B * num_rows, C))
    out.index_add_(0, flat.reshape(-1), src.reshape(-1, C))
    return out.reshape(B, num_rows, C)


def _check(values: torch.Tensor, idx: torch.Tensor, what: str):
    if values.device.type != 'cuda':
        raise ValueError(f'{what} needs a CUDA tensor, got {values.device}')
    if values.dtype != torch.float32 or values.dim() != 3 \
            or values.shape[2] != 3 or not values.is_contiguous():
        raise ValueError(f'{what} takes a contiguous float32 (B, N, 3) '
                         f'tensor, got {values.dtype} {tuple(values.shape)}')
    if idx.dtype != torch.int32 or idx.dim() != 2 \
            or idx.shape[0] != values.shape[0] or not idx.is_contiguous() \
            or idx.device != values.device:
        raise ValueError(f'{what} takes contiguous int32 (B, Q) indices on '
                         f'{values.device}, got {idx.dtype} '
                         f'{tuple(idx.shape)} on {idx.device}')


def check_sizes(B: int, Q: int, V: int, what: str):
    """Refuse what the scatter kernel's 32-bit index arithmetic and its
    grid (the batch on blockIdx.y) do not take."""
    if 3 * B * max(Q, V) >= INDEX_LIMIT or B > MAX_BATCH:
        raise ValueError(f'{what}: B={B}, Q={Q}, V={V} is too large (needs '
                         f'3 B Q and 3 B V < 2^31, B <= {MAX_BATCH})')


def scatter_shared_bytes(V: int, Q: int, split: int) -> int:
    """Kernel 6's shared memory per CTA when `split` CTAs share a batch
    item (csrc/gather.cu scatter_shared): a staged contribution (3 floats),
    an index and a slot's q per contribution, a first slot and a cursor per
    row of the CTA's ceil(V / split), the scan's 32 ints."""
    rows = -(-V // split)
    return 4 * (5 * Q + 2 * rows + 33)


def scatter_plan(B: int, V: int, Q: int, sms: int = H100_SMS) -> int:
    """CTAs per batch item for kernel 6: one CTA an SM (each holds most of
    an SM's shared memory), as many as fill the card's `sms` SMs, at least
    as many as the shared memory needs, at most MAX_SPLIT and V. Refuses
    what the plan cannot hold: Q enters every CTA's shared memory whole."""
    split = min(MAX_SPLIT, max(1, sms // max(B, 1)))
    while scatter_shared_bytes(V, Q, split) > MAX_SHARED \
            and split < min(MAX_SPLIT, V):
        split += 1
    split = max(1, min(split, V))
    if scatter_shared_bytes(V, Q, split) > MAX_SHARED:
        most = (MAX_SHARED - scatter_shared_bytes(V, 0, min(MAX_SPLIT, V))
                ) // 20         # 20 bytes a contribution
        raise ValueError(
            f'scatter_add_rows_cuda: V={V}, Q={Q} needs '
            f'{scatter_shared_bytes(V, Q, split)} bytes of shared memory per '
            f'CTA even at {split} CTAs per batch item, more than '
            f'{MAX_SHARED}: the plan holds Q <= {max(most, 0)} at this V')
    return split


_SMS = {}


def _sms(device: torch.device) -> int:
    """The card's SM count, asked once per device."""
    if device.index not in _SMS:
        _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device.index]


def _launch(fn, device: torch.device, *args) -> int:
    """fn(*args, stream) on the current stream of `device`, read as the raw
    cudaStream_t (as PyTorch's own kernel launchers read it, without
    building a Stream object); the device guard only where `device` is not
    the current one."""
    if device.index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    with torch.cuda.device(device):
        return fn(*args, torch._C._cuda_getCurrentRawStream(device.index))


def gather_rows_cuda(values: torch.Tensor, idx: torch.Tensor
                     ) -> torch.Tensor:
    """Launch kernel 5 on CUDA tensors; counts each launch."""
    _check(values, idx, 'gather_rows_cuda')
    B, V, _ = values.shape
    Q = idx.shape[1]
    out = torch.empty((B, Q, 3), dtype=values.dtype, device=values.device)
    if B * Q == 0:
        return out
    lib, fn = _build.entry('gather', 'tuch_gather_rows', _GATHER_ARGS)
    err = _launch(fn, values.device, values.data_ptr(), idx.data_ptr(),
                  out.data_ptr(), B, V, Q)
    if err:
        _build.check(lib, err, 'gather kernel launch')
    gather_rows_cuda.launches += 1
    return out


def scatter_add_rows_cuda(contrib: torch.Tensor, idx: torch.Tensor,
                          num_rows: int) -> torch.Tensor:
    """Launch kernel 6 on CUDA tensors; counts each launch."""
    _check(contrib, idx, 'scatter_add_rows_cuda')
    B, Q, _ = contrib.shape
    if B * Q == 0 or num_rows == 0:
        return contrib.new_zeros((B, num_rows, 3))
    check_sizes(B, Q, num_rows, 'scatter_add_rows_cuda')
    split = scatter_plan(B, num_rows, Q, _sms(contrib.device))
    out = torch.empty((B, num_rows, 3), dtype=contrib.dtype,
                      device=contrib.device)   # the kernel writes every row
    lib, fn = _build.entry('gather', 'tuch_scatter_add_rows', _SCATTER_ARGS)
    err = _launch(fn, contrib.device, contrib.data_ptr(), idx.data_ptr(),
                  out.data_ptr(), B, num_rows, Q, split)
    if err:
        _build.check(lib, err, 'scatter kernel launch')
    scatter_add_rows_cuda.launches += 1
    return out


gather_rows_cuda.launches = 0
scatter_add_rows_cuda.launches = 0


def gather(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather by device: the plain version for a CPU tensor, kernel 5
    for a CUDA tensor (which raises rather than fall back)."""
    if True:  # the reference runs the plain version on every device
        return gather_rows_ref(values, idx)
    return gather_rows_cuda(values, idx)


def scatter_add(contrib: torch.Tensor, idx: torch.Tensor,
                num_rows: int) -> torch.Tensor:
    """Row scatter-add by device: the plain version for a CPU tensor,
    kernel 6 for a CUDA tensor."""
    if True:  # the reference runs the plain version on every device
        return scatter_add_rows_ref(contrib, idx, num_rows)
    return scatter_add_rows_cuda(contrib, idx, num_rows)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, idx):
        ctx.save_for_backward(idx)
        ctx.num_rows = values.shape[1]
        return gather(values, idx)

    @staticmethod
    def backward(ctx, ct):
        idx, = ctx.saved_tensors
        return scatter_add(ct.contiguous(), idx, ctx.num_rows), None


def gather_rows(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Differentiable batched row gather: (B, V, 3), int32 (B, Q) ->
    (B, Q, 3); the backward scatter-adds the cotangent into the rows."""
    return _GatherRows.apply(values, idx)
