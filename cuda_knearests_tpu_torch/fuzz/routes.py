"""Runners for the four solve routes, and the seeded-fault injector.

Counterpart of ``cuda_knearests_tpu/fuzz/routes.py``.  Every runner takes
an in-domain point set and returns ``(ids, d2)``: (m, k) neighbour ids in
original point indexing (rows in input order, -1 beyond the available
neighbours) and (m, k) squared distances ascending (inf beyond), so the
campaign compares all four routes through one code path:

  * ``adaptive`` -- the capacity-class solve (``api.KnnProblem``,
                    backend 'auto', the adaptive planner).
  * ``legacy``   -- the single-schedule pack solve (``adaptive=False``).
  * ``query``    -- the external-query surface (no self-exclusion: the
                    stored points presented again as queries).
  * ``sharded``  -- the z-slab solve (``parallel.sharded``) over
                    ``n_devices`` slabs placed on the one ``device``, as
                    the reference runs it on an emulated mesh: on one GPU
                    that still runs the halo exchange between slabs.

Every route runs on ``device`` (default: the GPU, ``utils.platform
.resolve_device``).

Seeded faults (``KNTPU_FUZZ_FAULT=<kind>[:<route>]``, default route
'adaptive') corrupt a route's output after the solve, so the campaign's
detectors can be proven live without touching engine code:

  * ``drop-neighbor`` -- erase row 0's last valid neighbour.
  * ``perturb-d2``    -- inflate row 0's last valid distance.
  * ``skip-route``    -- the route silently produces no result.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

ROUTE_NAMES = ("adaptive", "legacy", "query", "sharded")

FAULT_KINDS = ("drop-neighbor", "perturb-d2", "skip-route")

_FAULT_ENV = "KNTPU_FUZZ_FAULT"


def route_excludes_self(route: str) -> bool:
    """Self-solve routes exclude the query point by storage index; the
    external-query surface does not -- the oracle reference must match."""
    return route != "query"


def parse_fault(spec: Optional[str] = None) -> Optional[Tuple[str, str]]:
    """(kind, target_route) from a ``KNTPU_FUZZ_FAULT`` value, or None."""
    spec = os.environ.get(_FAULT_ENV, "") if spec is None else spec
    spec = (spec or "").strip()
    if not spec:
        return None
    kind, _, route = spec.partition(":")
    if kind not in FAULT_KINDS:
        raise ValueError(f"unknown {_FAULT_ENV} kind {kind!r}: expected one "
                         f"of {FAULT_KINDS}")
    return kind, (route or "adaptive")


def _apply_fault(route: str, ids: np.ndarray, d2: np.ndarray):
    """Corrupt (ids, d2) per the env-seeded fault; None for skip-route."""
    fault = parse_fault()
    if fault is None or fault[1] != route:
        return ids, d2
    kind = fault[0]
    if kind == "skip-route":
        return None
    ids = np.array(ids, copy=True)
    d2 = np.array(d2, copy=True)
    valid = ids >= 0
    if not valid.any():
        return ids, d2  # nothing to corrupt (empty case): a no-op
    row = int(np.nonzero(valid.any(axis=1))[0][0])
    col = int(np.nonzero(valid[row])[0][-1])
    if kind == "drop-neighbor":
        ids[row, col] = -1  # d2 stays finite: a self-inconsistent row
    elif kind == "perturb-d2":
        d2[row, col] = d2[row, col] * 1.01 + 1.0
    return ids, d2


def self_solve(points: np.ndarray, config, device=None):
    """(ids, d2) of one all-points solve of ``points`` under ``config`` (a
    ``KnnConfig``) on ``device``, rows in input order."""
    from ..api import KnnProblem

    p = KnnProblem.prepare(points, config, device=device)
    p.solve()
    ids = p.get_knearests_original()
    d2 = np.empty_like(p.get_dists_sq())
    d2[p.get_permutation()] = p.get_dists_sq()
    return ids, d2


def run_route(route: str, points: np.ndarray, k: int,
              n_devices: int = 2, device=None):
    """Run one route on ``device``; returns (ids, d2) in original
    indexing and order, or None when a seeded skip-route fault suppressed
    the result."""
    from ..config import KnnConfig

    if route == "adaptive":
        ids, d2 = self_solve(points, KnnConfig(k=k, adaptive=True), device)
    elif route == "legacy":
        ids, d2 = self_solve(points, KnnConfig(k=k, adaptive=False), device)
    elif route == "query":
        from ..api import KnnProblem

        p = KnnProblem.prepare(points, KnnConfig(k=k), device=device)
        ids, d2 = p.query(points)
    elif route == "sharded":
        from ..parallel.sharded import ShardedKnnProblem
        from ..utils.platform import resolve_device

        dev = resolve_device(device)
        sp = ShardedKnnProblem.prepare(points, config=KnnConfig(k=k),
                                       devices=[dev] * max(1, n_devices))
        ids, d2, _cert = sp.solve()
    else:
        raise ValueError(f"unknown route {route!r}: expected one of "
                         f"{ROUTE_NAMES}")
    return _apply_fault(route, np.asarray(ids), np.asarray(d2))


def oracle_reference(points: np.ndarray, k: int, exclude_self: bool):
    """The exact answer (the kd-tree when the native oracle built, numpy
    brute force otherwise -- the same semantics): ((m, k) ids, (m, k)
    d2)."""
    from ..oracle import KdTreeOracle

    oracle = KdTreeOracle(points)
    if exclude_self:
        return oracle.knn_all_points(k)
    return oracle.knn(points, k)
