"""Delta-debugging auto-minimizer: shrink a failing point set to a minimal
repro before banking it.

Counterpart of ``cuda_knearests_tpu/fuzz/minimize.py``, the same probes.

Classic ddmin over point ROWS: at granularity g, try deleting each of g
contiguous chunks; any deletion that still fails is accepted and the
granularity resets coarse.  When no chunk at row granularity can be
removed, the set is 1-minimal -- every remaining point is necessary for
the failure.  The predicate re-runs the failing route + oracle comparison
on each candidate subset, so probes are bounded (``max_probes``) to keep a
pathological plateau from stalling the campaign; hitting the bound banks
the best-so-far reduction (still a valid repro, just maybe not minimal).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np


def ddmin_points(points: np.ndarray,
                 still_fails: Callable[[np.ndarray], bool],
                 max_probes: int = 64) -> Tuple[np.ndarray, int]:
    """Minimal (1-minimal, probe-budget permitting) subset of ``points``
    rows on which ``still_fails`` holds.  ``still_fails(points)`` must be
    True on entry (the caller observed the failure); returns
    (minimized points, probes spent)."""
    pts = np.asarray(points)
    probes = 0
    n = pts.shape[0]
    if n == 0:
        return pts, probes  # already minimal: the empty case IS the repro
    granularity = 2
    while pts.shape[0] >= 2 and probes < max_probes:
        n = pts.shape[0]
        granularity = min(granularity, n)
        chunks = np.array_split(np.arange(n), granularity)
        reduced = False
        for c in chunks:
            if probes >= max_probes:
                break
            keep = np.delete(np.arange(pts.shape[0]), c)
            if keep.size == pts.shape[0]:
                continue
            probes += 1
            candidate = pts[keep]
            if still_fails(candidate):
                pts = candidate  # chunk was irrelevant: drop it for good
                granularity = max(granularity - 1, 2)
                reduced = True
                break
        if not reduced:
            if granularity >= pts.shape[0]:
                break  # row granularity, nothing removable: 1-minimal
            granularity = min(granularity * 2, pts.shape[0])
    return pts, probes
