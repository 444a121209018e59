"""Incremental point insert/delete: the grid-hash delta overlay.

Counterpart of ``cuda_knearests_tpu/serve/delta.py``.  The base engine pays
a full ``prepare`` (sort, class plan, device upload) for any change to the
point cloud.  A serving daemon fronting a moving cloud cannot: mutations
arrive continuously and each one is small.  This module makes mutations
O(delta):

* **Inserts** accumulate in a host delta set organised by the same cell
  partition as the base grid (``gridhash.delta_csr_host``: the grid
  build's count / reserve / scatter over the delta alone), and the cells
  they touch form the **dirty-cell overlay**.
* **Deletes** tombstone base points (a host boolean mask).  A tombstone
  matters only where it intrudes into a base result row, which is found by
  id.
* **Queries** stay exact and byte-identical to a rebuild from scratch on
  the mutated cloud (``base.with_points(mutated_points()).query(...)``):
  the base problem answers as prepared (``KnnProblem.query``, the class
  kernels); rows whose base top-k holds a tombstone are answered again
  against the alive base points; delta candidates merge in from one more
  call.  Both extra calls are ``ops/query.brute_force_by_coords`` on the
  base problem's device.  The identity holds because every distance on
  the result path, whichever route made it -- the class kernels
  (``csrc/supercell_topk.cu``, ``csrc/blocked_topk.cu``, built with
  ``--fmad=false``), their plain versions or ``brute_force_by_coords``
  (``ops/solve.sum_sq_diff``) -- is the same float32 sum of per-axis
  squared differences in x, y, z order, each operation rounded on its own;
  the merge only compares.
* **Compaction**: once the absorbed mutations reach ``compact_threshold``
  the overlay folds into a full re-prepare of the mutated cloud
  (``KnnProblem.with_points``) and the delta empties.

Canonical indexing: the mutated cloud is ``[surviving base points in
original order] + [inserts in arrival order]`` -- ``np.delete`` then
``np.concatenate``, so the rebuild oracle is one line.  Result ids are
canonical current ids, and delete requests address the same indexing.

Dirty-cell pruning: before the delta call the overlay bounds each query's
distance to every dirty cell (``gridhash.cell_min_d2_host``, float64 cell
boxes).  A cell no query's bound can reach is dropped and its rows never
enter the call (the CSR gathers only surviving cells' rows); when every
cell drops, the call is skipped.  The bound is conservative, so pruning
never changes an answer.

Host round trips (``runtime/dispatch.fetch``): the base query's own (at
most 2), plus one for tombstone resolution when a row touched a deleted
point, plus one for the delta merge when the bound could not prune it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..api import KnnProblem
from ..ops.gridhash import cell_min_d2_host, delta_csr_host
from ..ops.query import brute_force_by_coords
from ..runtime import dispatch as _dispatch

# Far-away sentinel of the padding rows of the alive set and the delta:
# its float32 squared distance to any query in the domain is inf, so the
# (d2, id) keys order a pad after every real candidate and it comes back
# as (-1, inf).
_FAR = np.float32(1.0e30)


def _round_pow2(x: int, minimum: int = 8) -> int:
    return max(minimum, 1 << max(0, int(x) - 1).bit_length())


@dataclasses.dataclass
class OverlayStats:
    """Counters of one overlay's life (serving summaries stamp these)."""

    inserts: int = 0
    deletes: int = 0
    compactions: int = 0
    delta_launches: int = 0
    delta_skips: int = 0        # dirty-cell bound pruned the whole call
    delta_candidates: int = 0   # CSR-gathered rows the delta calls scored
    resolved_rows: int = 0      # rows answered again for tombstones

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class DeltaOverlay:
    """A mutable point cloud served as base problem + delta, always exact.

    Not thread-safe (the daemon's event loop is single-threaded); every
    public method runs on the host except the query calls, which run on
    the base problem's device.
    """

    def __init__(self, problem: KnnProblem, compact_threshold: int = 512):
        self.base = problem
        self.compact_threshold = max(1, int(compact_threshold))
        self.stats = OverlayStats()
        self._reset_delta()

    # -- state ---------------------------------------------------------------

    def _reset_delta(self) -> None:
        n = self.base.grid.n_points
        # the base cloud in original order (canonical ids 0..n-1 before any
        # mutation): the validated array prepare kept, read, never written
        self._base_orig = self.base._host_original()
        self.alive = np.ones((n,), bool)
        self.n_deleted = 0
        self.delta = np.empty((0, 3), np.float32)
        self.dirty_cells = np.empty((0,), np.int32)
        self._delta_csr: Optional[Tuple] = None  # (order, starts, counts)
        self._alive_cache: Optional[Tuple] = None  # (pts_dev, ids_dev)
        self._old2new: Optional[np.ndarray] = None

    @property
    def device(self):
        return self.base.device

    @property
    def n_points(self) -> int:
        """Size of the current mutated cloud."""
        return int(self.alive.sum()) + self.delta.shape[0]

    @property
    def mutations_pending(self) -> int:
        return self.n_deleted + self.delta.shape[0]

    def mutated_points(self) -> np.ndarray:
        """The mutated cloud in canonical order (the rebuild oracle's
        input): surviving base originals, then inserts in arrival order."""
        return np.ascontiguousarray(
            np.concatenate([self._base_orig[self.alive], self.delta]),
            dtype=np.float32)

    def _invalidate(self, alive_changed: bool) -> None:
        """Recompute the delta CSR and the dirty-cell overlay after a
        mutation: O(d log d) in the current delta, never in the base.  The
        alive-set caches (the staged resolution arrays and the old -> new
        id map) depend only on the tombstone mask, so an insert keeps them:
        it must never restage the O(n) base."""
        if alive_changed:
            self._alive_cache = None
            self._old2new = None
        if self.delta.shape[0]:
            order, dirty, starts, counts = delta_csr_host(
                self.delta, self.base.grid.dim, self.base.grid.domain)
            self._delta_csr = (order, starts, counts)
            self.dirty_cells = dirty
        else:
            self._delta_csr = None
            self.dirty_cells = np.empty((0,), np.int32)

    def _map_old2new(self) -> np.ndarray:
        """Base original id -> canonical current id (-1 for deleted)."""
        if self._old2new is None:
            m = np.cumsum(self.alive) - 1
            self._old2new = np.where(self.alive, m, -1).astype(np.int32)
        return self._old2new

    # -- mutations -----------------------------------------------------------

    def insert(self, points: np.ndarray) -> None:
        """Append validated points (the daemon validates at admission)."""
        points = np.asarray(points, np.float32).reshape(-1, 3)
        if points.shape[0] == 0:
            return
        self.delta = np.concatenate([self.delta, points])
        self.stats.inserts += points.shape[0]
        self._invalidate(alive_changed=False)
        self._maybe_compact()

    def delete(self, ids: np.ndarray) -> None:
        """Remove points by canonical current id (``np.delete``
        semantics)."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size == 0:
            return
        n_alive = int(self.alive.sum())
        base_ids = ids[ids < n_alive]
        delta_ids = ids[ids >= n_alive] - n_alive
        if base_ids.size:
            orig = np.nonzero(self.alive)[0][base_ids]
            self.alive[orig] = False
            self.n_deleted += base_ids.size
        if delta_ids.size:
            keep = np.ones((self.delta.shape[0],), bool)
            keep[delta_ids] = False
            self.delta = self.delta[keep]
        self.stats.deletes += ids.size
        self._invalidate(alive_changed=True)
        self._maybe_compact()

    def _maybe_compact(self) -> None:
        if self.mutations_pending >= self.compact_threshold:
            self.compact()

    def compact(self) -> None:
        """Fold the overlay into a full re-prepare of the mutated cloud,
        the one O(n) step, amortised over ``compact_threshold`` mutations.
        The base is swapped only after the re-prepare succeeds."""
        self.base = self.base.with_points(self.mutated_points(),
                                          validate=False)
        self.stats.compactions += 1
        self._reset_delta()

    # -- queries -------------------------------------------------------------

    def _alive_launch_arrays(self):
        """Device (points, canonical ids) of the alive base set, the
        tombstone resolution's inputs, cached until the next delete.
        Padded to a power-of-two row count (pads at _FAR, id -1), so the
        shape changes only when the alive count crosses a power of two."""
        if self._alive_cache is None:
            n_alive = int(self.alive.sum())
            cap = _round_pow2(n_alive, minimum=128)
            pts = np.full((cap, 3), _FAR, np.float32)
            pts[:n_alive] = self._base_orig[self.alive]
            ids = np.full((cap,), -1, np.int32)
            ids[:n_alive] = np.arange(n_alive, dtype=np.int32)
            self._alive_cache = (_dispatch.stage(pts, self.device),  # syncflow: overlay-alive-stage
                                 _dispatch.stage(ids, self.device))  # syncflow: overlay-alive-stage
        return self._alive_cache

    def _delta_launch_arrays(self, sel: np.ndarray, cap: int):
        """Device (points, canonical ids) of the selected delta rows padded
        to ``cap`` (pads at _FAR with id -1, so they lose every merge).
        ``sel`` comes out of the delta CSR: only rows in cells some query's
        bound could not prune."""
        pts = np.full((cap, 3), _FAR, np.float32)
        pts[: sel.size] = self.delta[sel]
        n_alive = int(self.alive.sum())
        ids = np.full((cap,), -1, np.int32)
        ids[: sel.size] = n_alive + sel.astype(np.int32)
        return (_dispatch.stage(pts, self.device),  # syncflow: overlay-delta-stage
                _dispatch.stage(ids, self.device))  # syncflow: overlay-delta-stage

    def query(self, queries: np.ndarray, k: int):
        """Exact kNN of ``queries`` against the current mutated cloud.

        Returns ((m, k) canonical ids, -1 padded; (m, k) d2 ascending, inf
        padded), byte-identical to
        ``base.with_points(mutated_points()).query(queries, k)`` (ids
        within an exact d2 tie may differ: the rebuild breaks ties by its
        own grid order, the merge by canonical id)."""
        queries = np.ascontiguousarray(queries, np.float32)
        m = queries.shape[0]
        if m == 0:
            return (np.empty((0, k), np.int32),
                    np.empty((0, k), np.float32))
        ids, d2 = self.base.query(queries, k)
        ids = np.array(ids)  # writable copies of the fetched rows
        d2 = np.array(d2)
        # base original ids -> canonical ids; rows a tombstone intruded
        # into are answered again against the alive set (the rare row pays
        # one more call, the batch never pays a sync per row)
        if self.n_deleted:
            deleted = np.nonzero(~self.alive)[0]
            bad = np.isin(ids, deleted).any(axis=1)
            o2n = self._map_old2new()
            ids = np.where(ids >= 0, o2n[np.clip(ids, 0, None)], -1)
            if bad.any():
                a_pts, a_ids = self._alive_launch_arrays()
                # the bad-row count pads to a power of two as well
                # (sentinel query rows, discarded)
                nb = int(bad.sum())
                bq = np.zeros((_round_pow2(nb), 3), np.float32)
                bq[:nb] = queries[bad]
                r_i, r_d = brute_force_by_coords(
                    a_pts, _dispatch.stage(bq, self.device), k,  # syncflow: overlay-resolve-stage
                    ids_map=a_ids)
                r_i, r_d = _dispatch.fetch(r_i, r_d)  # syncflow: overlay-resolve
                r_i, r_d = r_i[:nb], r_d[:nb]
                # the -1/inf pad contract (reachable only when the alive
                # set has fewer than k points)
                r_d = np.where(r_i >= 0, r_d, np.inf)
                ids[bad] = r_i
                d2[bad] = r_d
                self.stats.resolved_rows += nb
        if self.delta.shape[0] == 0:
            return ids, d2
        # dirty-cell pruning: a dirty cell survives only when some query's
        # cell-box bound is within that query's current k-th distance (a
        # row with fewer than k neighbours has inf there and keeps every
        # cell)
        kth = np.where(np.isfinite(d2[:, k - 1]), d2[:, k - 1], np.inf)
        bound = cell_min_d2_host(queries, self.dirty_cells,
                                 self.base.grid.dim, self.base.grid.domain)
        need = (bound <= kth[:, None]).any(axis=0)
        if not need.any():
            self.stats.delta_skips += 1
            return ids, d2
        # gather the surviving cells' delta rows through the CSR
        order, starts, counts = self._delta_csr
        sel = np.concatenate([order[s: s + c] for s, c
                              in zip(starts[need], counts[need])])
        cap = _round_pow2(int(sel.size))
        d_pts, d_ids = self._delta_launch_arrays(sel, cap)
        g_i, g_d = brute_force_by_coords(
            d_pts, _dispatch.stage(queries, self.device), min(k, cap),  # syncflow: overlay-delta-query-stage
            ids_map=d_ids)
        g_i, g_d = _dispatch.fetch(g_i, g_d)  # syncflow: overlay-delta-final
        self.stats.delta_launches += 1
        self.stats.delta_candidates += int(sel.size)
        return _merge_rows(ids, d2, g_i, g_d, k)


def _merge_rows(a_i: np.ndarray, a_d: np.ndarray, b_i: np.ndarray,
                b_d: np.ndarray, k: int):
    """Merge two ascending per-row candidate lists into the final top-k.

    Comparisons only, so merged distances keep their exact bits.  Invalid
    slots (id < 0, which covers the delta's pad rows) sort last via inf;
    ties break by the lower canonical id."""
    ids = np.concatenate([a_i, b_i], axis=1)
    d2 = np.concatenate([a_d, b_d], axis=1)
    d2 = np.where(ids >= 0, d2, np.inf)
    order = np.lexsort((ids, d2), axis=1)[:, :k]
    rows = np.arange(ids.shape[0])[:, None]
    out_i, out_d = ids[rows, order], d2[rows, order]
    out_i = np.where(np.isfinite(out_d), out_i, -1)
    return np.ascontiguousarray(out_i), np.ascontiguousarray(out_d)
