"""Batch plumbing between the host and the device (the part of
sast_tpu/data/batch.py that the training loop needs)."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def split_device_batch(batch: Dict[str, np.ndarray]) -> Tuple[dict, dict]:
    """(device_arrays, host_extras): keys starting with ``_`` stay on the host."""
    device = {k: v for k, v in batch.items() if not k.startswith("_")}
    host = {k: v for k, v in batch.items() if k.startswith("_")}
    return device, host


def to_device(device_batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The numpy arrays of a device batch as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in device_batch.items()}
