"""Observability: the span tracer (:mod:`spans`), the metrics registry
(:mod:`metrics`) and the flight recorder (:mod:`recorder`), with their
common names re-exported; :mod:`export` merges per-process span spills
into one Perfetto trace.  Pure Python; importing it touches no device.

Counterpart of ``cuda_knearests_tpu/obs/__init__.py``.
"""

from . import metrics, recorder, spans
from .metrics import REGISTRY, Histogram, metrics_snapshot
from .recorder import FLIGHT
from .spans import capture, emit, event, set_process_tag, span

__all__ = [
    "FLIGHT",
    "Histogram",
    "REGISTRY",
    "capture",
    "emit",
    "event",
    "metrics",
    "metrics_snapshot",
    "recorder",
    "set_process_tag",
    "span",
    "spans",
]
