"""Device selection: CUDA unless the caller asks for the CPU.

There is no silent fallback: a caller that names no device gets the first
CUDA card, and a machine without one raises instead of quietly running the
model on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` → ``cuda``; ``"cpu"`` only when asked; raise if CUDA is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
