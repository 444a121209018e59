"""Device-level tracing hooks.

Counterpart of ``cuda_knearests_tpu/utils/profiling.py``: :func:`trace`
captures a ``torch.profiler`` trace of the enclosed block (CPU and, where
a card is present, CUDA activity: kernels, copies, the ``annotate``
regions) and writes it to ``log_dir`` as a Chrome trace that Perfetto and
TensorBoard read; :func:`annotate` names a region in such a trace.

Usage::

    from cuda_knearests_tpu_torch.utils.profiling import trace
    with trace("knn_trace"):
        problem.solve()
    # then load knn_trace/*.pt.trace.json in Perfetto (or TensorBoard)
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

import torch


def _sync_all() -> None:
    """Wait for every CUDA device, so trailing asynchronous work lands
    inside the trace (the reference's ``block_until_ready``)."""
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)  # kntpu-ok: host-sync-loop -- trace fence: one wait per device as a trace window closes, never on a solve path


@contextlib.contextmanager
def trace(log_dir: str, host_tracer_level: int = 2) -> Iterator[None]:
    """Capture a profiler trace of the enclosed block into ``log_dir``.
    ``host_tracer_level`` >= 2 also records the Python call stack of each
    host op (the reference's host tracer level)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
            activities=activities, with_stack=host_tracer_level >= 2,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)):
        yield
        _sync_all()


def annotate(name: str):
    """Named region that shows up in profiler traces (and costs next to
    nothing outside them): ``with annotate("halo-exchange"): ...``"""
    return torch.profiler.record_function(name)
