"""Device resolution for the port's entry points.

The port runs on the card: ``cuda`` is the default, the CPU is used only
when the caller names it (the tests do), and asking for ``cuda`` on a
host without one raises instead of quietly running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"`` -> the CPU; any ``cuda`` device
    must exist, else ``RuntimeError``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu) to run on the CPU explicitly")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use cuda or cpu")
    return dev

