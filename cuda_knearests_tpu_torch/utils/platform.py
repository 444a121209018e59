"""Device selection for the engine's entry points, and the retry helpers.

Entry points run on the GPU unless the caller asks for the CPU.  With no
CUDA device and no explicit device they raise: a CPU run is always a
choice the caller made, never a silent substitute.  :func:`backoff_schedule`
and :func:`_env_number` are the reference's (``utils/platform.py``).
"""

from __future__ import annotations

import os
import sys

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


def backoff_schedule(tries: int, base_s: float = 5.0, factor: float = 2.0,
                     max_s: float = 120.0) -> list[float]:
    """Delays (seconds) between retry attempts: ``tries - 1`` entries of
    capped exponential backoff -- the one backoff law of the engine's
    retry loops (the supervisor's transient-transport retry,
    ``runtime/supervisor.py``)."""
    delays = []
    d = max(0.0, base_s)
    for _ in range(max(0, tries - 1)):
        delays.append(min(d, max_s))
        d *= factor
    return delays


def _env_number(name, default, cast):
    """Parse a numeric env knob; a malformed value falls back to the
    default with a stderr note instead of crashing the entry point."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return cast(raw)
    except ValueError:
        print(f"ignoring malformed {name}={raw!r}; using {default}",
              file=sys.stderr, flush=True)
        return default
