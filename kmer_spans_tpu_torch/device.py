"""Device selection: explicit, with no fallback."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``"cuda"``/``"cuda:N"``/``"cpu"`` (or a torch.device) -> torch.device.

    A CUDA device without a card raises; it never falls back to the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but no CUDA device is "
                "available (pass device='cpu' for the plain versions)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use cuda or cpu")
    return dev
