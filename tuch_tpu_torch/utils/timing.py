"""Device synchronisation for timing loops on CUDA.

Counterpart of tuch_tpu/utils/timing.py. There, fetch_sync works around a
remote TPU dispatch whose readiness signal could come before the work
finished, by fetching one element of the output. On a CUDA card the work
is enqueued on a stream and torch.cuda.synchronize() is a true barrier, so
this is a synchronise-and-fetch: it waits for the device, then copies the
smallest tensor of `out` to the host, the read that a caller's timing
loop ends with.
"""

import torch


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return [t for x in out for t in _tensors(x)]
    return []


def fetch_sync(out):
    """Wait for every device `out` lies on, then copy its smallest tensor
    (one element of it at most 64) to the host. Returns `out`
    unchanged."""
    leaves = _tensors(out)
    for dev in {t.device for t in leaves if t.device.type == 'cuda'}:
        torch.cuda.synchronize(dev)
    if leaves:
        leaf = min(leaves, key=lambda t: t.numel())
        (leaf if leaf.numel() <= 64 else leaf.reshape(-1)[:1]).cpu()
    return out
