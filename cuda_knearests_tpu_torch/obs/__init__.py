"""Observability: the span tracer (:mod:`spans`), the metrics registry
(:mod:`metrics`) and the flight recorder (:mod:`recorder`), with their
common names re-exported; :mod:`export` merges per-process span spills
into one Perfetto trace.  :mod:`device` (``torch.profiler`` capture of a
solve window, device-event attribution, the measured-memory verdict) and
:mod:`attribution` (parsing the capture) load on first access
(``obs.device``), so importing the package touches no device.

``python -m cuda_knearests_tpu_torch.obs`` runs the observability smoke.

Counterpart of ``cuda_knearests_tpu/obs/__init__.py``.
"""

import importlib

from . import metrics, recorder, spans
from .metrics import REGISTRY, Histogram, metrics_snapshot
from .recorder import FLIGHT
from .spans import capture, emit, event, set_process_tag, span

_LAZY = ("attribution", "device")


def __getattr__(name: str):
    if name in _LAZY:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


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
