"""Batch-to-device helper (counterpart of tuch_tpu/utils/dload.py, the
reference's tuch/utils/dload.py)."""

import numpy as np
import torch


def dict_to_device(batch: dict, device) -> dict:
    """Every array value of a batch dict (numpy array or tensor) as a
    tensor on `device`; other values pass through."""
    return {k: torch.as_tensor(v, device=device)
            if isinstance(v, (np.ndarray, torch.Tensor)) else v
            for k, v in batch.items()}
