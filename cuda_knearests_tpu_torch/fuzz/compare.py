"""Tie-aware differential comparison: a route's output against an exact
oracle.

Counterpart of ``cuda_knearests_tpu/fuzz/compare.py``.  Index equality is
the wrong check on adversarial inputs -- duplicate and lattice clouds make
equal-distance neighbour sets common, and any of the tied ids is a correct
answer.  What is checkable exactly:

  1. the pad contract: ids >= 0 exactly where d2 is finite, and the number
     of valid neighbours per row equals the oracle's (k > n pads -1/inf);
  2. no duplicate neighbour ids within a row;
  3. rows ascend by distance;
  4. every reported id realizes its reported distance (recomputed in f64
     against the coordinates, within FMA tolerance);
  5. the sorted distance multiset per row equals the oracle's.

Together 1-5 imply the route's answer is an exact k-NN answer whenever the
oracle's is, without comparing ids directly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# FMA/reassociation tolerance for f32 distance arithmetic over the
# [0, 1000]^3 domain (d2 <= 3e6, f32 ulp there ~0.25).
RTOL = 1e-4
ATOL = 1e-2


@dataclasses.dataclass(frozen=True)
class Mismatch:
    """One disagreement between a route and its oracle."""

    row: int
    reason: str
    detail: str

    def render(self) -> str:
        return f"row {self.row}: {self.reason} ({self.detail})"


def check_route_result(points: np.ndarray, queries: np.ndarray,
                       ids: np.ndarray, d2: np.ndarray,
                       ref_d2: np.ndarray, k: int,
                       rtol: float = RTOL, atol: float = ATOL
                       ) -> Optional[Mismatch]:
    """First tie-aware disagreement between a route's (ids, d2) and the
    oracle's ref_d2, or None when the route's answer is exact."""
    m = queries.shape[0]
    if ids.shape != (m, k) or d2.shape != (m, k):
        return Mismatch(-1, "shape", f"got ids {ids.shape} d2 {d2.shape}, "
                                     f"want {(m, k)}")
    if m == 0:
        return None
    valid = ids >= 0
    finite = np.isfinite(d2)
    if (valid != finite).any():
        r = int(np.nonzero((valid != finite).any(axis=1))[0][0])
        return Mismatch(r, "pad-contract",
                        f"ids>=0 mask {valid[r].tolist()} != isfinite(d2) "
                        f"{finite[r].tolist()} (invalid slots must be "
                        f"-1/inf pairs)")
    ref_valid = np.isfinite(ref_d2)
    got_n, ref_n = valid.sum(axis=1), ref_valid.sum(axis=1)
    if (got_n != ref_n).any():
        r = int(np.nonzero(got_n != ref_n)[0][0])
        return Mismatch(r, "neighbor-count",
                        f"route found {int(got_n[r])} neighbors, oracle "
                        f"{int(ref_n[r])}")
    if points.shape[0] == 0:
        # no stored points: matching all-invalid rows is the whole contract
        return None
    # duplicate ids inside a row (invalid slots mapped to unique sentinels)
    sentinel = points.shape[0] + np.arange(k)[None, :]
    srt = np.sort(np.where(valid, ids, sentinel), axis=1)
    dup_rows = ((np.diff(srt, axis=1) == 0).any(axis=1))
    if dup_rows.any():
        r = int(np.nonzero(dup_rows)[0][0])
        return Mismatch(r, "duplicate-ids", f"row ids {ids[r].tolist()}")
    # ascending distances (inf pads sort last by the pad contract; inf-inf
    # differences are NaN, which compares False -- exactly right)
    d2a = np.where(finite, d2, np.inf)
    with np.errstate(invalid="ignore"):
        bad_order = (np.diff(d2a, axis=1) < -atol).any(axis=1)
    if bad_order.any():
        r = int(np.nonzero(bad_order)[0][0])
        return Mismatch(r, "not-ascending", f"d2 {d2[r].tolist()}")
    # reported ids realize reported distances (f64 recompute)
    safe = np.clip(ids, 0, max(points.shape[0] - 1, 0))
    real = ((points[safe].astype(np.float64)
             - queries[:, None, :].astype(np.float64)) ** 2).sum(-1)
    realized = np.isclose(real, d2, rtol=rtol, atol=atol) | ~valid
    if not realized.all():
        r, c = (int(x[0]) for x in np.nonzero(~realized))
        return Mismatch(r, "unrealized-distance",
                        f"id {int(ids[r, c])} reported d2={d2[r, c]:.6g} "
                        f"actual {real[r, c]:.6g}")
    # distance multiset against the oracle; valid counts already agree, so
    # sorting with inf pads aligns the slots
    ref_sorted = np.sort(np.where(ref_valid, ref_d2, np.inf), axis=1)
    got_sorted = np.sort(d2a, axis=1)
    agree = (np.isclose(got_sorted, ref_sorted, rtol=rtol, atol=atol)
             | (~np.isfinite(got_sorted) & ~np.isfinite(ref_sorted)))
    if not agree.all():
        r = int(np.nonzero(~agree.all(axis=1))[0][0])
        return Mismatch(r, "distance-mismatch",
                        f"route d2 {got_sorted[r].tolist()} vs oracle "
                        f"{ref_sorted[r].tolist()}")
    return None
