"""Counted host-boundary traffic of the one-sync solve.

Counterpart of ``cuda_knearests_tpu/runtime/dispatch.py``.  :func:`fetch` is
the one sanctioned device-to-host readback: every tensor of a call is
copied into host memory without blocking and the host then waits once, so
one call is one round trip however many tensors ride it.  :func:`stage` is
the non-blocking host-to-device upload.  A solve completes within
:data:`SYNC_BUDGET` fetches: one batched readback of the assembled rows,
plus one more when uncertified rows need the exact fallback.
:func:`kernel_stats` reads the kernel counters: builds and library loads
(``ops/_build``) and class-kernel launches (``ops/cuda_solve``).
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

SYNC_BUDGET = 2


@dataclasses.dataclass
class DispatchStats:
    """Host-boundary counters of one measurement window: blocking
    readbacks (``fetch`` calls)."""

    host_syncs: int = 0


_STATS = DispatchStats()
_STATS_LOCK = threading.Lock()


def reset_stats() -> None:
    """Zero the counters (the start of a measurement window)."""
    with _STATS_LOCK:
        _STATS.host_syncs = 0


def stats() -> DispatchStats:
    """Snapshot of the current window's counters."""
    with _STATS_LOCK:
        return dataclasses.replace(_STATS)


def stats_dict() -> dict:
    """The current window's counters as a plain dict."""
    return dataclasses.asdict(stats())


def kernel_stats() -> dict:
    """Process-wide kernel counters: ``kernel_builds`` (nvcc builds that
    succeeded) and ``kernel_loads`` (libraries loaded), whose sum inside a
    serving window is that window's ``recompiles``, and
    ``kernel_launches``, the class kernels' launches
    (``cuda_solve.launches + blocked_launches``; CUDA tensors only)."""
    from ..ops import _build, cuda_solve

    return {"kernel_builds": _build.builds, "kernel_loads": _build.loads,
            "kernel_launches": cuda_solve.launches
            + cuda_solve.blocked_launches}


def fetch(*tensors: torch.Tensor):
    """One batched readback: the tensors as host numpy arrays, in order.
    Counts one host round trip per call, on every device."""
    host = [t.to("cpu", non_blocking=True) for t in tensors]
    if any(t.is_cuda for t in tensors):
        torch.cuda.current_stream().synchronize()
    with _STATS_LOCK:
        _STATS.host_syncs += 1
    return [h.numpy() for h in host]


def stage(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host-to-device upload that does not block the host."""
    return torch.as_tensor(np.ascontiguousarray(array)).to(
        device, non_blocking=True)
