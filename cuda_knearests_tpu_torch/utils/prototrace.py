"""Runtime protocol-action trace recorder.

Counterpart of ``cuda_knearests_tpu/utils/prototrace.py``, the whole
module.  Protocol methods (``pod/reshard.py``: the migration handover) call
:func:`record` at each ``# proto:``-annotated site; a drill turns the
recorder on around a run (:func:`enable`) and reconciles the drained
trace with the protocol's declared model.

Off by default and O(1) when off (one attribute load and truth test), so
the serving path pays nothing.  The buffer is bounded at
:data:`_MAX_EVENTS`: a runaway loop must not turn the recorder into a
leak; events past the bound are counted by :func:`dropped`.  Thread-safe.

Pure Python: nothing here touches a device.
"""

from __future__ import annotations

import threading
from typing import List, Tuple

_MAX_EVENTS = 100_000

_lock = threading.Lock()
_events: List[Tuple[str, str]] = []
_dropped = 0
enabled = False


def enable() -> None:
    """Start recording (clears any previous trace)."""
    global enabled, _dropped
    with _lock:
        _events.clear()
        _dropped = 0
        enabled = True


def disable() -> None:
    global enabled
    with _lock:
        enabled = False


def record(model: str, action: str) -> None:
    """Append one (model, action) event; no-op unless enabled."""
    global _dropped
    if not enabled:
        return
    with _lock:
        if not enabled:
            return
        if len(_events) >= _MAX_EVENTS:
            _dropped += 1
            return
        _events.append((model, action))


def drain() -> List[Tuple[str, str]]:
    """Return and clear the recorded trace (oldest first)."""
    global _dropped
    with _lock:
        out = list(_events)
        _events.clear()
        _dropped = 0
        return out


def dropped() -> int:
    """Events discarded because the bounded buffer was full."""
    with _lock:
        return _dropped
