"""tuch_tpu_torch: the PyTorch + CUDA port of tuch_tpu for NVIDIA Hopper.

Module names mirror the JAX package ``tuch_tpu`` so each counterpart is easy
to find. This package imports ``torch`` and never ``jax`` or ``tuch_tpu``.
Entry points run on CUDA unless the caller passes ``device='cpu'``.
"""

import torch

__version__ = '0.1.0'


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless 'cpu' is asked for.

    Raises RuntimeError when CUDA is asked for (explicitly or by default)
    and no CUDA device is present; it never drops to the CPU silently.
    """
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'tuch_tpu_torch runs on CUDA by default and no CUDA device is '
            "available; pass device='cpu' to run on the CPU")
    return dev
