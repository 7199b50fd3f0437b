"""Carrying data across: numpy <-> tensors, int32 words."""

from __future__ import annotations

import numpy as np
import torch


def to_tensor(a, device) -> torch.Tensor:
    """A copy of a numpy array (or anything np.array takes) on device."""
    return torch.from_numpy(np.array(a)).to(device)


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 tensor with the same bits."""
    return (x - ((x >> 31) << 32)).to(torch.int32)
