"""The tie-aware float64 recall oracle of the MXU scorers (numpy only).

Counterpart of ``cuda_knearests_tpu/mxu/measure.py``, the same measures on
the same arrays.  Both measures count a returned id as a hit when its
exact float64 squared distance is at most the true k-th:

* **band-free** (``band=None``): a pick that ties the true k-th at float32
  resolution also counts, since the engines select in float32 and cannot
  order two candidates closer than one float32 ulp;
* **declared precision** (``band``, usually :func:`declared_band`): the
  threshold widens by the row's dot-form band 2B, the band the
  certificate reasons with -- the recall measure of unrefined approximate
  rows, which never claimed float64 order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .topk import dot_error_bound


def declared_band(points: np.ndarray,
                  queries: Optional[np.ndarray] = None,
                  precision: str = "f32") -> np.ndarray:
    """Per-query 2B of the dot-form scores at ``precision``
    (``topk.dot_error_bound`` from float64 norms: the query's, and the
    largest stored point's)."""
    p64 = points.astype(np.float64)  # kntpu-ok: wide-dtype -- oracle math
    q64 = p64 if queries is None else queries.astype(np.float64)  # kntpu-ok: wide-dtype -- oracle math
    qn = (q64 * q64).sum(axis=1)
    pn_max = float((p64 * p64).sum(axis=1).max()) if p64.size else 0.0
    return 2.0 * dot_error_bound(qn, pn_max, points.shape[1], precision)


def f64_kth(points: np.ndarray, k: int,
            queries: Optional[np.ndarray] = None,
            exclude: Optional[np.ndarray] = None,
            exclude_self: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Per query (the true k-th squared distance, the neighbours available
    up to k) in float64, by a chunked brute force (fine to a few 10k
    points).  ``exclude`` masks one candidate per query; the default
    self-solve (``queries=None, exclude_self=True``) masks the
    diagonal."""
    p64 = points.astype(np.float64)  # kntpu-ok: wide-dtype -- oracle math
    q64 = p64 if queries is None else queries.astype(np.float64)  # kntpu-ok: wide-dtype -- oracle math
    if exclude is None and queries is None and exclude_self:
        exclude = np.arange(p64.shape[0])
    m = q64.shape[0]
    kth = np.empty((m,), np.float64)  # kntpu-ok: wide-dtype -- oracle math
    avail = np.empty((m,), np.int64)  # kntpu-ok: wide-dtype -- oracle math
    chunk = max(1, int(2.0e7) // max(1, p64.shape[0]))
    for s in range(0, m, chunk):
        q = q64[s:s + chunk]
        d2 = ((q[:, None, :] - p64[None, :, :]) ** 2).sum(-1)
        if exclude is not None:
            d2[np.arange(q.shape[0]), exclude[s:s + q.shape[0]]] = np.inf
        a = np.minimum(k, np.isfinite(d2).sum(1))
        avail[s:s + chunk] = a
        kth[s:s + chunk] = np.sort(d2, axis=1)[
            np.arange(q.shape[0]), np.maximum(a, 1) - 1]
    return kth, avail


def row_hits(points: np.ndarray, neighbors: np.ndarray,
             kth: np.ndarray,
             band: Optional[np.ndarray] = None,
             queries: Optional[np.ndarray] = None) -> np.ndarray:
    """Per row, the hits among its (k,) ``neighbors`` (-1 = none) against
    the ``kth`` thresholds; the rows answer ``queries`` (default: the
    points themselves)."""
    p64 = points.astype(np.float64)  # kntpu-ok: wide-dtype -- oracle math
    q64 = p64 if queries is None else queries.astype(np.float64)  # kntpu-ok: wide-dtype -- oracle math
    valid = neighbors >= 0
    c = p64[np.where(valid, neighbors, 0)]
    gd = ((q64[:, None, :] - c) ** 2).sum(-1)
    if band is not None:
        hit = gd <= (kth + band)[:, None]
    else:
        hit = ((gd <= kth[:, None])
               | (gd.astype(np.float32) <= kth[:, None].astype(np.float32)))
    return (valid & hit).sum(axis=1)


def measured_recall(points: np.ndarray, neighbors: np.ndarray,
                    k: int, queries: Optional[np.ndarray] = None,
                    exclude_self: bool = True,
                    band: Optional[np.ndarray] = None) -> float:
    """Aggregate tie-aware recall@k against the float64 oracle (``band``
    as in :func:`row_hits`); 1.0 when no row has a neighbour."""
    exclude = (np.arange(points.shape[0])
               if queries is None and exclude_self else None)
    kth, avail = f64_kth(points, k, queries=queries, exclude=exclude,
                         exclude_self=False)
    hits = row_hits(points, neighbors, kth, band=band, queries=queries)
    total = int(avail.sum())
    return float(hits.sum()) / total if total else 1.0


def certified_recall(points: np.ndarray, neighbors: np.ndarray,
                     rows: np.ndarray, k: int) -> float:
    """Band-free recall of the self-solve rows ``rows`` (the audit of
    certified rows: below 1.0 a certificate lied)."""
    q = points[rows]
    kth, avail = f64_kth(points, k, queries=q, exclude=rows,
                         exclude_self=False)
    hits = row_hits(points, neighbors[rows], kth, queries=q)
    total = int(avail.sum())
    return float(hits.sum()) / total if total else 1.0
