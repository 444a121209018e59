"""Device selection for the engine's entry points.

Entry points run on the GPU unless the caller asks for the CPU.  With no
CUDA device and no explicit device they raise: a CPU run is always a
choice the caller made, never a silent substitute.
"""

from __future__ import annotations

import torch

from .memory import NoDeviceError


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raising :class:`NoDeviceError` when no CUDA
    device exists); anything else is taken as asked."""
    if device is None:
        if not torch.cuda.is_available():
            raise NoDeviceError(
                "no CUDA device is available; the engine runs on the GPU "
                "by default -- pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise NoDeviceError(f"device {device} requested but CUDA is not "
                            f"available")
    return device
