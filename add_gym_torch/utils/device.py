"""Device selection: the port's entry points run on the card unless the
caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for a CUDA device where
    there is none (nothing falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device is available")
    return device
