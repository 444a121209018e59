"""What one run measured, as the metric readers see it."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from .trace import Capture


@dataclasses.dataclass
class RunContext:
    """One run's readings.  ``latencies_s``: every solve of the window,
    call to rows on the host; ``elapsed_s``: the window from its first
    solve's call to its last solve's return; ``counters``: the port's
    host syncs over the window (``host_syncs``, from ``dispatch.stats()``)
    and ``fallback_rows``, the rows the solves left to the exact fallback;
    ``prepare_spans``: the port's span events of its prepare;
    ``window_spans``: those of the window, kept in a ``--trace 1`` run;
    ``capture``: the traced window of a ``--trace 1`` run, else None."""

    n: int
    k: int
    d: int
    device_kind: str
    setup_s: Optional[float]
    latencies_s: List[float]
    solves: int
    elapsed_s: float
    peak_mem_bytes: Optional[int]
    counters: Dict[str, int]
    prepare_spans: List[dict]
    window_spans: List[dict] = dataclasses.field(default_factory=list)
    capture: Optional[Capture] = None

    def device_capture(self) -> Optional[Capture]:
        """The traced window where it holds device events and none was
        dropped; None otherwise (a CPU run, or an incomplete capture)."""
        cap = self.capture
        if cap is None or cap.solves <= 0 or not cap.device_events():
            return None
        return None if cap.dropped() else cap
