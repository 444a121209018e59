"""Counted host-boundary traffic of the one-sync solve.

Counterpart of ``cuda_knearests_tpu/runtime/dispatch.py``.  :func:`fetch` is
the one sanctioned device-to-host readback: every tensor of a call is
copied into host memory without blocking and the host then waits once, so
one call is one round trip however many tensors ride it.  :func:`stage` is
the non-blocking host-to-device upload.  A solve completes within
:data:`SYNC_BUDGET` fetches: one batched readback of the assembled rows,
plus one more when uncertified rows need the exact fallback.
The counters also carry the bytes each direction moved (``d2h_bytes``,
``h2d_bytes``), and :class:`trace_sites` records, for every ``fetch``,
``stage`` and ``ici`` call inside its window, the calling file and line
(a :class:`SiteRecord`).  With spans on, each transfer is a
``dispatch.fetch`` / ``dispatch.stage`` child span of whatever span the
caller holds open.  :func:`kernel_stats` reads the kernel counters:
builds and library loads (``ops/_build``) and class-kernel launches
(``ops/cuda_solve``).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import threading
from typing import Optional

import numpy as np
import torch

from ..obs import spans as _spans

SYNC_BUDGET = 2


@dataclasses.dataclass
class DispatchStats:
    """Host-boundary counters of one measurement window: blocking
    readbacks (``fetch`` calls) and the bytes they read (``d2h_bytes``),
    the bytes ``stage`` uploaded (``h2d_bytes``; an upload is traffic,
    not a sync), and ``ici_bytes``, the bytes a pod's halo exchange moved
    between chips (:func:`ici`; never a host sync)."""

    host_syncs: int = 0
    d2h_bytes: int = 0
    h2d_bytes: int = 0
    ici_bytes: int = 0


_STATS = DispatchStats()
_STATS_LOCK = threading.Lock()
# The active per-call-site trace (None = off; see trace_sites).
_SITE_TRACE: Optional[list] = None
_PACKAGE = "cuda_knearests_tpu_torch"


def reset_stats() -> None:
    """Zero the counters (the start of a measurement window).  The
    counters are one process-wide window: they attribute traffic to a
    single solve only when no other thread dispatches inside it."""
    with _STATS_LOCK:
        _STATS.host_syncs = 0
        _STATS.d2h_bytes = 0
        _STATS.h2d_bytes = 0
        _STATS.ici_bytes = 0


def stats() -> DispatchStats:
    """Snapshot of the current window's counters."""
    with _STATS_LOCK:
        return dataclasses.replace(_STATS)


def stats_dict() -> dict:
    """The current window's counters as a plain dict."""
    return dataclasses.asdict(stats())


@dataclasses.dataclass(frozen=True)
class SiteRecord:
    """One traced host-boundary transfer: the source line that moved how
    many bytes, which way.  ``path`` starts at the package directory;
    ``synced`` is True for a fetch (each one is a host round trip)."""

    kind: str      # 'fetch' | 'stage' | 'ici'
    path: str
    line: int
    nbytes: int
    synced: bool


def _record_site(kind: str, nbytes: int, synced: bool) -> None:
    """Append the caller of fetch/stage/ici to the active trace."""
    frame = sys._getframe(2)
    path = frame.f_code.co_filename
    cut = path.rfind(_PACKAGE)
    if cut >= 0:
        path = path[cut:].replace(os.sep, "/")
    _SITE_TRACE.append(SiteRecord(kind=kind, path=path, line=frame.f_lineno,
                                  nbytes=int(nbytes), synced=synced))


class trace_sites:
    """Context manager that collects one :class:`SiteRecord` per
    ``fetch``, ``stage`` and ``ici`` call inside the window (``with
    trace_sites() as records: ...``).  Single-threaded windows only, as
    the counters."""

    def __enter__(self) -> list:
        global _SITE_TRACE
        self._prev = _SITE_TRACE
        _SITE_TRACE = []
        return _SITE_TRACE

    def __exit__(self, *exc) -> None:
        global _SITE_TRACE
        _SITE_TRACE = self._prev


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
    Each CUDA tensor's copy is queued on the current stream of its own
    device, so the host waits on that stream of every distinct device
    among them (slabs of a sharded problem live on several cards).
    Counts one host round trip per call, on every device, and the
    tensors' bytes as ``d2h_bytes``."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    with _STATS_LOCK:
        _STATS.host_syncs += 1
        _STATS.d2h_bytes += nbytes
    if _SITE_TRACE is not None:
        _record_site("fetch", nbytes, True)
    if _spans.enabled():
        # a child span: the host wait lands inside whatever span the
        # caller holds open (a solve phase, a serving batch)
        with _spans.span("dispatch.fetch", nbytes=nbytes, synced=True):
            return _read_back(tensors)
    return _read_back(tensors)


def _read_back(tensors) -> list:
    host = [t.to("cpu", non_blocking=True) for t in tensors]
    for device in {t.device for t in tensors if t.is_cuda}:
        torch.cuda.current_stream(device).synchronize()
    return [h.numpy() for h in host]


def ici(nbytes: int) -> None:
    """Record ``nbytes`` moved between chips by a device-to-device
    exchange (``pod/halo.py``): it counts toward ``ici_bytes`` only, never
    ``host_syncs``."""
    with _STATS_LOCK:
        _STATS.ici_bytes += int(nbytes)
    if _SITE_TRACE is not None:
        _record_site("ici", int(nbytes), False)
    _spans.event("dispatch.ici", nbytes=int(nbytes))


def stage(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host-to-device upload that does not block the host; its bytes
    count as ``h2d_bytes``."""
    arr = np.ascontiguousarray(array)
    with _STATS_LOCK:
        _STATS.h2d_bytes += int(arr.nbytes)
    if _SITE_TRACE is not None:
        _record_site("stage", int(arr.nbytes), False)
    if _spans.enabled():
        with _spans.span("dispatch.stage", nbytes=int(arr.nbytes)):
            return torch.as_tensor(arr).to(device, non_blocking=True)
    return torch.as_tensor(arr).to(device, non_blocking=True)
