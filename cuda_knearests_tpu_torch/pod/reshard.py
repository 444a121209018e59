"""Mutating pod indexes: halo re-exchange and live Morton resharding.

Counterpart of ``cuda_knearests_tpu/pod/reshard.py``.  Two layers, both
answering what happens to a partitioned index when the cloud does not
hold still:

* :class:`PodOverlay` -- a mutating view over a prepared
  :class:`~.solve.PodKnnProblem`.  A delete tombstones bucket rows in
  place (coordinates at ``serve.delta._FAR``, id -1, as the reference);
  only the dirty chips' buckets are staged again, one ``dispatch.stage``
  per array a chip, and the halo exchange (``halo.exchange``) runs again
  only when a dirty cell lies in its owner's export block, i.e. some other
  chip holds a copy of it.  Its bytes count as ``ici_bytes``; nothing is
  read back, so a delete makes no host round trip.  Either way every
  cached ready state that packed the old rows is dropped (all chips after
  a re-exchange, else the dirty ones), since the window and the class
  packs are copies.  Inserts go to a host delta merged through
  ``ops/query.brute_force_by_coords`` on the first chip with dirty-cell
  pruning, the machinery of ``serve/delta``.
* :class:`ElasticIndex` -- the serving-tier index split into contiguous
  Morton-code ranges (:class:`RangeShard`: a legacy-route
  :class:`~..api.KnnProblem` plus a :class:`~..serve.delta.DeltaOverlay`).
  Queries go to every shard and come back through one deterministic
  merge, so the overlay's pin (answers byte-identical to a rebuild on the
  mutated cloud) holds shard by shard.  A :class:`Migration` moves a range
  boundary under traffic: committed records ship in order, the old owner
  answers until the receiver has acked every committed record, and the
  index answers byte-identical to :meth:`ElasticIndex.rebuild_oracle_query`
  at every pump.

The tombstone on the device.  A tombstoned row stays a slot of its cell's
CSR range, so it is scored as a candidate and sits at a query row.  At
``_FAR`` its f32 squared distance to any point of the domain is inf, in
the diff arithmetic and in the dot form alike, so it never enters a live
row's list: the solve turns every non-finite entry into (-1, inf).  Its
own query row is never placed (its bucket id is -1).  Under the MXU scorer
its norm is inf, which widens the error band of every supercell whose box
holds it to inf: those rows do not certify and resolve through the
kd-tree, as the reference's do.  Bucket pads stay at
``parallel.sharded._PAD_XYZ`` when a chip is staged again, as prepare
staged them.

Protocol table (model ``migration-handover``): start at
``ElasticIndex.maybe_rebalance`` / ``force_rebalance``; ship at
``Migration._append`` and ``_ship``; insert at ``Migration.on_insert`` /
``on_delete``; pump at ``ElasticIndex.pump``; handover at
``Migration.handover``; abort at ``Migration.abort``.  The ``# proto:``
comments mark those sites and :mod:`..utils.prototrace` records them.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..api import KnnProblem
from ..config import KnnConfig
from ..obs import spans as _spans
from ..ops.gridhash import cell_min_d2_host, delta_csr_host
from ..ops.query import brute_force_by_coords
from ..ops.topk import INVALID_ID
from ..parallel.sharded import _PAD_XYZ
from ..runtime import dispatch as _dispatch
from ..serve.delta import _FAR, DeltaOverlay, _merge_rows, _round_pow2
from ..utils import prototrace
from ..utils.platform import resolve_device
from ..utils.profiling import annotate
from . import halo as _halo
from .partition import morton3
from .solve import PodKnnProblem

__all__ = ["PodOverlay", "RangeShard", "ElasticIndex", "Migration",
           "morton_codes"]

_MORTON_BITS = 21
_MAX_CODE = np.iinfo(np.int64).max  # kntpu-ok: wide-dtype -- Morton code space bound, host-only constant

# (row, dirty cell) pairs of one chunk of the pruning bound: its float64
# temporaries stay near 100 MB however many rows a solve merges.
_BOUND_CHUNK_PAIRS = 1 << 22


def morton_codes(points: np.ndarray, domain: float = 1000.0) -> np.ndarray:
    """Morton (z-order) code of each point at full 21-bit resolution --
    the elastic tier's range key (finer than the supercell directory so a
    range boundary can land between any two points)."""
    pts = np.asarray(points, np.float64).reshape(-1, 3)  # kntpu-ok: wide-dtype -- 21-bit quantization needs f64 mantissa headroom, host-only
    scale = float(1 << _MORTON_BITS) / float(domain)
    c = np.clip((pts * scale).astype(np.int64), 0, (1 << _MORTON_BITS) - 1)  # kntpu-ok: wide-dtype -- 3x21-bit interleave headroom, host-only
    return morton3(c)


def need_cells(queries: np.ndarray, kth: np.ndarray, cells: np.ndarray,
               dim: int, domain: float) -> np.ndarray:
    """(c,) bool: the dirty cells some query's bound can reach,
    ``(cell_min_d2_host(queries, cells) <= kth[:, None]).any(axis=0)``
    bit for bit, without the (m, c) matrix.  Rows whose bound to the box
    spanning every cell exceeds their k-th distance cannot reach any cell
    and are dropped first: the box's corners are the very float64 values
    (``lo``, ``lo + w``) the cell bound computes, so per axis its gap is
    never above a cell's, and rounding is monotone, so neither is its
    bound.  The rest are bounded in chunks of ``_BOUND_CHUNK_PAIRS``
    pairs."""
    need = np.zeros((cells.size,), bool)
    if cells.size == 0 or queries.shape[0] == 0:
        return need
    w = np.float64(domain) / dim  # kntpu-ok: wide-dtype -- conservative pruning bound computed in f64 on host, never staged
    lo = np.stack([cells % dim, (cells // dim) % dim, cells // (dim * dim)],
                  axis=-1).astype(np.float64) * w  # kntpu-ok: wide-dtype -- conservative pruning bound computed in f64 on host, never staged
    box_lo, box_hi = lo.min(axis=0), (lo + w).max(axis=0)
    q = np.asarray(queries, np.float64)  # kntpu-ok: wide-dtype -- conservative pruning bound computed in f64 on host, never staged
    gap = np.maximum(np.maximum(box_lo - q, q - box_hi), 0.0)
    rows = np.nonzero((gap * gap).sum(-1) <= kth)[0]
    step = max(1, _BOUND_CHUNK_PAIRS // cells.size)
    for r0 in range(0, rows.size, step):
        r = rows[r0:r0 + step]
        bound = cell_min_d2_host(queries[r], cells, dim, domain)
        need |= (bound <= kth[r, None]).any(axis=0)
        if need.all():
            break
    return need


# =============================================================================
# Layer 1: PodOverlay -- solve-time halo re-exchange for mutating clouds
# =============================================================================

class PodOverlay:
    """A mutable point cloud served from a prepared pod decomposition.

    Ids are stable: base points keep their ORIGINAL index (0..n0-1);
    inserts get ``n0 + arrival_index`` and keep it for life (a deleted
    insert tombstones in place, so later inserts never shift).  Deletes
    accept both ranges.  ``solve()`` covers the original rows (deleted
    rows come back invalid: id -1 / d2 inf / cert False); inserts appear
    as neighbour CANDIDATES everywhere and get their own rows via
    ``query``.

    Not thread-safe, as the serve overlay.
    """

    def __init__(self, problem: PodKnnProblem):
        pp = self.pp = problem
        meta = pp.meta
        # own mutable copies of the host twins: prepare's arrays are shared
        # with the caller and the plan; the overlay never mutates them
        if pp._points_host is not None:
            pp._points_host = np.array(pp._points_host, np.float32)
        if pp._bucket_ids_host is not None:
            pp._bucket_ids_host = np.array(pp._bucket_ids_host)
        self.n0 = int(pp.n_points)
        self.alive = np.ones((self.n0,), bool)
        self.n_deleted = 0
        # (chip, bucket row) of every original point: the per-chip bucket
        # id table is the inverse permutation, inverted once here
        self._chip_of = (np.asarray(pp._chip_of_point, np.int32)
                         if pp._chip_of_point is not None
                         else np.zeros((self.n0,), np.int32))
        self._row_of = np.full((self.n0,), -1, np.int32)
        # host twin of the device buckets, rebuilt from the id tables (the
        # plan's bucket points are not kept by the problem); pads as
        # prepare staged them
        self._bkt_pts = np.full((meta.ndev, meta.pcap, 3), _PAD_XYZ,
                                np.float32)
        self._bkt_ids = (pp._bucket_ids_host
                         if pp._bucket_ids_host is not None
                         else np.full((meta.ndev, meta.pcap), -1, np.int32))
        for d in range(meta.ndev):
            ids = self._bkt_ids[d]
            rows = np.nonzero(ids >= 0)[0]
            if rows.size:
                self._row_of[ids[rows]] = rows.astype(np.int32)
                self._bkt_pts[d, rows] = pp._points_host[ids[rows]]
        # per-owner export-cell sets: the dirty-cell -> export-block
        # invalidation test ("does any other chip import this cell?")
        self._exported = [set(np.asarray(c.export_cells).tolist())
                          for c in pp.chip_plans]
        # insert delta (host side): arrival-order rows, tombstoned in place
        self.delta = np.empty((0, 3), np.float32)
        self._delta_alive = np.empty((0,), bool)
        self._delta_rows = np.empty((0,), np.int32)
        self._delta_csr: Optional[Tuple] = None
        self.dirty_cells = np.empty((0,), np.int32)
        self.stats = {"inserts": 0, "deletes": 0, "restaged_chips": 0,
                      "reexchanges": 0, "reexchanges_skipped": 0,
                      "delta_launches": 0, "delta_skips": 0}

    # -- state ----------------------------------------------------------------

    @property
    def n_points(self) -> int:
        return (self.n0 - self.n_deleted) + int(self._delta_alive.sum())

    def _cells_of(self, pts: np.ndarray) -> np.ndarray:
        dim = self.pp.meta.dim
        c = np.clip((np.asarray(pts, np.float32)
                     * (dim / self.pp.meta.domain)).astype(np.int64),  # kntpu-ok: wide-dtype -- dim^2 linearization headroom, host-only
                    0, dim - 1)
        return c[:, 0] + dim * c[:, 1] + dim * dim * c[:, 2]

    def mutated_points(self) -> np.ndarray:
        """The current cloud (alive base originals + alive inserts), the
        rebuild oracle's input."""
        base = self.pp._points_host[self.alive] if self.n0 else \
            np.empty((0, 3), np.float32)
        return np.ascontiguousarray(
            np.concatenate([base, self.delta[self._delta_alive]]),
            dtype=np.float32)

    # -- mutations ------------------------------------------------------------

    def insert(self, points: np.ndarray) -> np.ndarray:
        """Append points; returns their assigned (stable) ids."""
        pts = np.ascontiguousarray(
            np.asarray(points, np.float32).reshape(-1, 3))
        start = self.n0 + self.delta.shape[0]
        if pts.shape[0] == 0:
            return np.empty((0,), np.int32)
        self.delta = np.concatenate([self.delta, pts])
        self._delta_alive = np.concatenate(
            [self._delta_alive, np.ones((pts.shape[0],), bool)])
        self._invalidate_delta()
        self.stats["inserts"] += pts.shape[0]
        return np.arange(start, start + pts.shape[0], dtype=np.int32)

    def delete(self, ids: np.ndarray) -> None:
        """Remove points by stable id: base rows tombstone on device (dirty
        chips restage; the halo re-exchanges iff an exported cell went
        dirty), insert rows tombstone in the host delta."""
        ids = np.unique(np.asarray(ids, np.int64).reshape(-1))  # kntpu-ok: wide-dtype -- host id arithmetic, never staged
        ins = ids[ids >= self.n0] - self.n0
        if ins.size:
            live = ins[self._delta_alive[ins]]
            self._delta_alive[live] = False
            self.delta[live] = _FAR
            self._invalidate_delta()
            self.stats["deletes"] += int(live.size)
        base = ids[(ids >= 0) & (ids < self.n0)]
        base = base[self.alive[base]]
        if base.size == 0:
            return
        pp = self.pp
        # cells BEFORE tombstoning (the coords are about to go to _FAR)
        cells = self._cells_of(pp._points_host[base])
        chips = self._chip_of[base]
        rows = self._row_of[base]
        self.alive[base] = False
        self.n_deleted += int(base.size)
        # tombstone every host twin: FAR coords keep the kd-tree oracle
        # from ever preferring a deleted point, -1 bucket ids drop the rows
        # from solve placement AND from every export block
        pp._points_host[base] = _FAR
        pp._oracle_cache = None
        self._bkt_pts[chips, rows] = _FAR
        self._bkt_ids[chips, rows] = -1
        dirty = sorted(int(d) for d in np.unique(chips))
        self._restage(dirty)
        # export-block invalidation: re-exchange iff some dirty cell is in
        # its owner's export block (its points ride the halo)
        exported = any(int(c) in self._exported[int(d)]
                       for d, c in zip(chips, cells))
        if (exported and pp._halo is not None and pp.meta.steps
                and pp.meta.ndev > 1):
            self._reexchange()
            pp.drop_ready()
        else:
            if not exported:
                self.stats["reexchanges_skipped"] += 1
            # (exported but never exchanged: the lazy first exchange reads
            # the restaged buckets, nothing to invalidate)
            for d in dirty:
                pp.drop_ready(d)
        self.stats["deletes"] += int(base.size)

    def _restage(self, dirty: Sequence[int]) -> None:
        """Stage ONLY the dirty chips' buckets again, one transfer per
        array a chip; clean chips keep their tensors, uncopied."""
        pp = self.pp
        for d in dirty:
            pp.dev[d]["pts"] = _dispatch.stage(  # syncflow: pod-reexchange-stage
                self._bkt_pts[d], pp.mesh[d])
            pp.dev[d]["ids"] = _dispatch.stage(  # syncflow: pod-reexchange-stage
                self._bkt_ids[d], pp.mesh[d])
        self.stats["restaged_chips"] += len(dirty)

    def _reexchange(self) -> None:
        """Run the exchange again over the restaged buckets: the same walk,
        the same counted bytes, no host round trip."""
        pp = self.pp
        meta = pp.meta
        with _spans.span("solve.pod.rehalo", steps=meta.steps,
                         ici_bytes=meta.halo_bytes()), \
                annotate("kntpu:halo-reexchange"):
            pp._halo = _halo.exchange(meta, pp.dev, pp.mesh)
        _dispatch.ici(meta.halo_bytes())  # syncflow: pod-reexchange-ici
        self.stats["reexchanges"] += 1

    def _invalidate_delta(self) -> None:
        rows = np.nonzero(self._delta_alive)[0].astype(np.int32)
        self._delta_rows = rows
        if rows.size:
            order, dirty, starts, counts = delta_csr_host(
                self.delta[rows], self.pp.meta.dim, self.pp.meta.domain)
            self._delta_csr = (order, starts, counts)
            self.dirty_cells = dirty
        else:
            self._delta_csr = None
            self.dirty_cells = np.empty((0,), np.int32)

    # -- result paths ---------------------------------------------------------

    def _filter_deleted(self, ids: np.ndarray, d2: np.ndarray):
        """Drop tombstoned ids from result rows.  Only the host-oracle
        resolution path can surface one (the device buckets are FAR'd),
        and then only at a huge distance -- i.e. when fewer than k alive
        candidates exist -- so masked slots are always the row tail and
        the ascending -1/inf pad contract is preserved.  (Every id here is
        a base id, so a lookup in the tombstone mask is the reference's
        ``isin`` against the deleted ids.)"""
        bad = (ids >= 0) & ~self.alive[np.clip(ids, 0, max(0, self.n0 - 1))]
        return (np.where(bad, -1, ids).astype(np.int32),
                np.where(bad, np.inf, d2).astype(np.float32))

    def _delta_merge(self, queries: np.ndarray, ids: np.ndarray,
                     d2: np.ndarray, k: int):
        """Merge the alive insert delta into per-row results: dirty-cell
        pruning (:func:`need_cells`), one brute call on the first chip
        with one batched fetch, the comparison-only merge of
        ``serve/delta``."""
        rows = self._delta_rows
        if rows.size == 0:
            return ids, d2
        meta = self.pp.meta
        kth = np.where(np.isfinite(d2[:, k - 1]), d2[:, k - 1], np.inf)
        with _spans.span("solve.pod.overlay.bound",
                         rows=int(queries.shape[0]),
                         cells=int(self.dirty_cells.size)):
            need = need_cells(queries, kth, self.dirty_cells, meta.dim,
                              meta.domain)
        if not need.any():
            self.stats["delta_skips"] += 1
            return ids, d2
        order, starts, counts = self._delta_csr
        sel = np.concatenate([order[s: s + c] for s, c
                              in zip(starts[need], counts[need])])
        cap = _round_pow2(int(sel.size))
        pts = np.full((cap, 3), _FAR, np.float32)
        pts[: sel.size] = self.delta[rows[sel]]
        dids = np.full((cap,), -1, np.int32)
        dids[: sel.size] = self.n0 + rows[sel].astype(np.int32)
        device = self.pp.mesh[0]
        m = queries.shape[0]
        with _spans.span("solve.pod.overlay.brute", rows=m, cap=cap):
            d_pts = _dispatch.stage(pts, device)  # syncflow: reshard-delta-stage
            d_ids = _dispatch.stage(dids, device)  # syncflow: reshard-delta-stage
            g_i, g_d = brute_force_by_coords(
                d_pts, _dispatch.stage(queries, device),  # syncflow: reshard-delta-query-stage
                min(k, cap), ids_map=d_ids)
            g_i, g_d = _dispatch.fetch(g_i, g_d)  # syncflow: reshard-delta-final
        g_d = np.where(g_i >= 0, g_d, np.inf).astype(np.float32)
        self.stats["delta_launches"] += 1
        with _spans.span("solve.pod.overlay.merge", rows=m):
            return _merge_rows(ids, d2, g_i, g_d, k)

    def query(self, queries: np.ndarray, k: Optional[int] = None):
        """Exact kNN against the CURRENT mutated cloud (stable ids)."""
        k = self.pp.config.k if k is None else int(k)
        ids, d2 = self.pp.query(queries, k)
        queries = np.ascontiguousarray(queries, np.float32).reshape(-1, 3)
        if self.n_deleted:
            ids, d2 = self._filter_deleted(ids, d2)
        return self._delta_merge(queries, ids, d2, k)

    def solve(self):
        """All-points solve over the ORIGINAL rows against the mutated
        cloud: deleted rows come back invalid; alive rows see inserts as
        candidates through the same pruned delta merge."""
        nb, d2, cert = self.pp.solve()
        if self.n_deleted:
            with _spans.span("solve.pod.overlay.filter",
                             deleted=self.n_deleted):
                nb, d2 = self._filter_deleted(nb, d2)
                dead = ~self.alive
                nb[dead] = INVALID_ID
                d2[dead] = np.inf
                cert[dead] = False
        if self._delta_rows.size and self.n0:
            alive_rows = np.nonzero(self.alive)[0]
            if alive_rows.size:
                q = self.pp._points_host[alive_rows]
                m_i, m_d = self._delta_merge(q, nb[alive_rows],
                                             d2[alive_rows],
                                             self.pp.config.k)
                nb[alive_rows] = m_i
                d2[alive_rows] = m_d
        return nb, d2, cert

    def stats_dict(self) -> dict:
        return {**self.stats, "n_points": self.n_points,
                "n_deleted": self.n_deleted,
                "delta_pending": int(self._delta_alive.sum())}


# =============================================================================
# Layer 2: the elastic serving index -- Morton-range shards + live resharding
# =============================================================================

class RangeShard:
    """One contiguous Morton range: a base problem + delta overlay, with a
    uid ledger parallel to the overlay's canonical order.  Every answer
    and every migration speaks uids -- stable for a point's whole life, no
    matter how many shards it crosses.  The base is the legacy route
    (``adaptive=False``) on ``device`` (default: the GPU)."""

    def __init__(self, shard_id: int, points: np.ndarray, uids: np.ndarray,
                 k: int, compact_threshold: int = 512, *, device=None):
        self.shard_id = int(shard_id)
        self.k = int(k)
        self.compact_threshold = int(compact_threshold)
        pts = np.ascontiguousarray(
            np.asarray(points, np.float32).reshape(-1, 3))
        problem = KnnProblem.prepare(pts, KnnConfig(k=self.k,
                                                    adaptive=False),
                                     device=device)
        self.overlay = DeltaOverlay(problem,
                                    compact_threshold=compact_threshold)
        self.uids = np.asarray(uids, np.int64).reshape(-1).copy()  # kntpu-ok: wide-dtype -- uid ledger, host-only bookkeeping
        self.migrations_in = 0
        self.migrations_out = 0

    @property
    def n_points(self) -> int:
        return self.overlay.n_points

    def points(self) -> np.ndarray:
        """Canonical-order cloud, parallel to ``self.uids``."""
        return self.overlay.mutated_points()

    def insert(self, points: np.ndarray, uids: np.ndarray) -> None:
        pts = np.asarray(points, np.float32).reshape(-1, 3)
        if pts.shape[0] == 0:
            return
        self.overlay.insert(pts)
        self.uids = np.concatenate(
            [self.uids, np.asarray(uids, np.int64).reshape(-1)])  # kntpu-ok: wide-dtype -- uid ledger, host-only bookkeeping

    def delete_uids(self, uids: np.ndarray) -> int:
        """Delete by uid; returns how many were present (idempotent)."""
        sel = np.nonzero(np.isin(self.uids, np.asarray(uids)))[0]
        if sel.size == 0:
            return 0
        self.overlay.delete(sel)
        self.uids = np.delete(self.uids, sel)
        return int(sel.size)

    def query(self, queries: np.ndarray, k: int):
        """((m, k) uids, -1 pad; (m, k) d2) -- the overlay's canonical ids
        translated through the ledger."""
        m = np.asarray(queries).shape[0]
        if self.n_points == 0:
            return (np.full((m, k), -1, np.int64),  # kntpu-ok: wide-dtype -- uid rows, host-only
                    np.full((m, k), np.inf, np.float32))
        li, ld = self.overlay.query(queries, k)
        li = np.asarray(li)
        safe = np.clip(li, 0, max(0, self.uids.size - 1))
        out = np.where(li >= 0, self.uids[safe], np.int64(-1))  # kntpu-ok: wide-dtype -- uid rows, host-only
        return out, np.asarray(ld, np.float32)


@dataclasses.dataclass
class ShipRecord:
    """One committed migration record: dense 1-based seq, only-committed-
    acked (the receiver acks each record in order; the handover requires
    acked == committed)."""

    seq: int
    kind: str                      # 'insert' | 'delete'
    uids: np.ndarray               # (m,) i64
    points: Optional[np.ndarray]   # (m, 3) f32 for inserts


class Migration:
    """One live range-boundary move: donor shard -> receiver shard.

    Shipping is chunked and pumped (``step``) so queries interleave: the
    index keeps routing the moving range to the DONOR until the handover,
    and the receiver holds shipped records in a pending set it does not
    serve -- no row is ever answerable from two shards, so the merge needs
    no dedup and the byte-identity pin survives the whole migration.
    Mid-migration mutations in the moving range apply to the donor (the
    serving truth) AND append to the stream, like a replication log
    tail."""

    def __init__(self, index: "ElasticIndex", donor: int, receiver: int,
                 new_cuts: np.ndarray, chunk: int = 64):
        self.index = index
        self.donor = int(donor)
        self.receiver = int(receiver)
        self.new_cuts = np.asarray(new_cuts, np.int64)  # kntpu-ok: wide-dtype -- Morton cut table, host-only
        self.chunk = max(1, int(chunk))
        d = index.shards[self.donor]
        pts = d.points()
        codes = morton_codes(pts, index.domain)
        moving_mask = index._route(codes, self.new_cuts) != self.donor
        at = np.nonzero(moving_mask)[0]
        moving = d.uids[at].tolist()
        self.moving = set(moving)
        self._coords: Dict[int, np.ndarray] = {
            u: pts[i] for u, i in zip(moving, at.tolist())}
        self.queue: List[int] = moving
        self._qpos = 0
        self.records: List[ShipRecord] = []
        self.committed_seq = 0
        self.acked_seq = 0
        # receiver-side pending set (insertion-ordered): applied records
        # the receiver holds but does NOT serve until the handover
        self.pending: Dict[int, np.ndarray] = {}
        self.state = "shipping"
        self.wedged = False          # chaos: receiver stops acking
        self.handover_delay = 0      # chaos: pumps to sit ready before flip
        self.pumps = 0

    # -- the committed stream -------------------------------------------------

    def _append(self, kind: str, uids: np.ndarray,
                points: Optional[np.ndarray]) -> ShipRecord:
        # proto: migration-handover.ship
        prototrace.record("migration-handover", "ship")
        rec = ShipRecord(seq=self.committed_seq + 1, kind=kind,
                         uids=np.asarray(uids, np.int64).reshape(-1),  # kntpu-ok: wide-dtype -- uid payload, host-only
                         points=points)
        self.records.append(rec)
        self.committed_seq = rec.seq
        self._ship(rec)
        return rec

    def _ship(self, rec: ShipRecord) -> None:
        """Deliver one record to the receiver's pending set.  A wedged
        receiver drops the delivery AND the ack -- the handover gate
        (acked == committed) then holds the flip forever, which is what
        makes wedging safe: the donor keeps serving."""
        # proto: migration-handover.ship
        if self.wedged:
            return
        if rec.seq != self.acked_seq + 1:
            raise RuntimeError(
                f"migration sequence gap: receiver acked {self.acked_seq},"
                f" record carries seq {rec.seq}")
        if rec.kind == "insert":
            for i, u in enumerate(rec.uids.tolist()):
                self.pending[u] = np.asarray(rec.points[i], np.float32)  # kntpu-ok: host-sync-loop -- committed migration record (host numpy), no device array rides this loop
        else:
            for u in rec.uids.tolist():
                self.pending.pop(u, None)
        self.acked_seq = rec.seq

    # -- mid-migration mutations ---------------------------------------------

    def on_insert(self, points: np.ndarray, uids: np.ndarray) -> None:
        """New points that routed to the donor but live in the MOVING
        range: the donor serves them (old owner answers until handover)
        and the stream ships them."""
        # proto: migration-handover.insert
        prototrace.record("migration-handover", "insert")
        for u in np.asarray(uids).tolist():
            self.moving.add(int(u))
        self._append("insert", uids, np.asarray(points, np.float32))

    def on_delete(self, uids: np.ndarray) -> None:
        """Deletes of moving uids: already applied to the donor by the
        index; unshipped ones silently leave the queue, shipped ones ship
        a delete record so the receiver's pending set drops them."""
        # proto: migration-handover.insert -- mid-migration mutation, same action
        prototrace.record("migration-handover", "insert")
        dead = set(int(u) for u in np.asarray(uids).tolist()) & self.moving
        if not dead:
            return
        shipped = [u for u in dead
                   if u in self.pending or (self.wedged and u not in
                                            self.queue[self._qpos:])]
        unshipped = dead - set(shipped)
        for u in dead:
            self.moving.discard(u)
            self._coords.pop(u, None)
        if unshipped:
            rest = self.queue[self._qpos:]
            keep = [u for u in rest if u not in unshipped]
            self.queue = self.queue[: self._qpos] + keep
        if shipped:
            self._append("delete", np.asarray(sorted(shipped), np.int64),  # kntpu-ok: wide-dtype -- uid payload, host-only
                         None)

    # -- pumping --------------------------------------------------------------

    @property
    def shipping_done(self) -> bool:
        return self._qpos >= len(self.queue)

    @property
    def ready(self) -> bool:
        return (self.shipping_done
                and self.acked_seq == self.committed_seq
                and self.handover_delay <= 0)

    def step(self) -> None:
        """One pump: ship the next chunk, or burn a handover delay."""
        self.pumps += 1
        if not self.shipping_done:
            take = self.queue[self._qpos: self._qpos + self.chunk]
            self._qpos += len(take)
            take = [u for u in take if u in self.moving]
            if take:
                pts = np.stack([self._coords[u] for u in take])
                self._append("insert", np.asarray(take, np.int64), pts)  # kntpu-ok: wide-dtype -- uid payload, host-only
            return
        if self.handover_delay > 0:
            self.handover_delay -= 1

    def abort(self) -> None:
        """Abandon the move: the receiver discards its pending set, the
        cuts never flip, the donor never deleted -- zero data loss by
        construction (the donor stayed the serving truth throughout)."""
        # proto: migration-handover.abort
        prototrace.record("migration-handover", "abort")
        self.pending.clear()
        self.state = "aborted"

    def handover(self, fault: Optional[str] = None) -> dict:
        """Flip ownership: apply the pending set to the receiver, move the
        cut, delete the moved uids from the donor.

        ``fault`` forges a broken flip for the chaos/fault harness:
        'torn-migration' drops the stream's tail record at the flip (the
        receiver misses committed data it acked), 'lost-range' flips the
        cut and deletes from the donor while the receiver applies NOTHING
        -- both detectable by the rebuild and differential oracles."""
        # proto: migration-handover.handover
        prototrace.record("migration-handover", "handover")
        index = self.index
        pend = dict(self.pending)
        if fault == "torn-migration" and pend:
            torn = next(reversed(pend))
            del pend[torn]
        elif fault == "lost-range":
            pend = {}
        landed = np.asarray(list(pend.keys()), np.int64)  # kntpu-ok: wide-dtype -- uid payload, host-only
        if landed.size:
            pts = np.stack([pend[int(u)] for u in landed])
            index.shards[self.receiver].insert(pts, landed)
        index.cuts = self.new_cuts
        moved = np.asarray(sorted(self.moving), np.int64)  # kntpu-ok: wide-dtype -- uid payload, host-only
        deleted = index.shards[self.donor].delete_uids(moved)
        for u in landed.tolist():
            index._shard_of_uid[int(u)] = self.receiver
        index.shards[self.donor].migrations_out += 1
        index.shards[self.receiver].migrations_in += 1
        self.state = "done"
        return {"moved": int(moved.size), "landed": int(landed.size),
                "deleted_from_donor": int(deleted),
                "records": self.committed_seq, "fault": fault}


def _kernel_recompiles() -> int:
    """Kernel builds plus library loads so far: what the port's serving
    counts as recompiles (it has no executable cache)."""
    ks = _dispatch.kernel_stats()
    return ks["kernel_builds"] + ks["kernel_loads"]


class ElasticIndex:
    """The pod-partitioned serving index: Morton-range shards, scatter-
    gather queries, live resharding under traffic.

    Public ids are CANONICAL current ids with ``np.delete`` +
    ``np.concatenate`` semantics -- byte-compatible with the dense
    tenant's DeltaOverlay contract.  Internally every point carries a
    stable uid; the canonical <-> uid translation is two host arrays
    maintained per mutation.  Every shard lives on ``device`` (default:
    the GPU).
    """

    def __init__(self, points: np.ndarray, k: int, nshards: int = 2,
                 compact_threshold: int = 512, skew_threshold: float = 3.0,
                 migration_chunk: int = 64, domain: float = 1000.0,
                 abort_after_pumps: int = 256, *, device=None):
        pts = np.ascontiguousarray(
            np.asarray(points, np.float32).reshape(-1, 3))
        n = pts.shape[0]
        self.device = resolve_device(device)
        self.k = int(k)
        self.domain = float(domain)
        self.compact_threshold = int(compact_threshold)
        self.skew_threshold = float(skew_threshold)
        self.migration_chunk = int(migration_chunk)
        self.abort_after_pumps = int(abort_after_pumps)
        self.fault: Optional[str] = None   # seeded: torn-migration|lost-range
        self.migration: Optional[Migration] = None
        self.migrations_done = 0
        self.migrations_aborted = 0
        self.elastic_recompiles = 0   # kernel builds + loads attributed to
        #                               migration/rebuild work (the
        #                               --assert-steady carve-out)
        codes = morton_codes(pts, self.domain)
        nshards = max(1, min(int(nshards), max(1, n)))
        order = np.argsort(codes, kind="stable")
        cuts = [np.int64(0)]  # kntpu-ok: wide-dtype -- Morton cut table, host-only
        for j in range(1, nshards):
            cuts.append(codes[order[j * n // nshards]])
        cuts.append(np.int64(_MAX_CODE))  # kntpu-ok: wide-dtype -- Morton cut table, host-only
        self.cuts = np.asarray(cuts, np.int64)  # kntpu-ok: wide-dtype -- Morton cut table, host-only
        # duplicate-heavy clouds can collapse a cut; drop empty ranges
        # rather than preparing empty shards
        route = self._route(codes, self.cuts)
        keep = np.asarray([j for j in range(nshards)
                           if (route == j).any()])
        if keep.size < nshards:
            self.cuts = np.concatenate(
                [self.cuts[keep], self.cuts[-1:]])
            route = self._route(codes, self.cuts)
            nshards = keep.size
        self.nshards = int(nshards)
        uids = np.arange(n, dtype=np.int64)  # kntpu-ok: wide-dtype -- uid ledger, host-only
        self.uids_canonical = uids.copy()
        self.next_uid = n
        with self._attributed():
            self.shards = [self._shard(j, pts[route == j], uids[route == j])
                           for j in range(self.nshards)]
        self._shard_of_uid: Dict[int, int] = dict(
            zip(uids.tolist(), route.tolist()))
        self._canon_of_uid: Optional[np.ndarray] = None
        # query batch shapes served so far: a handover/chip-loss rebuild
        # re-warms these under _attributed(), so index maintenance never
        # leaks first-query builds into the serving steady state
        self._seen_batches: set = set()

    def _shard(self, j: int, points: np.ndarray,
               uids: np.ndarray) -> RangeShard:
        return RangeShard(j, points, uids, self.k, self.compact_threshold,
                          device=self.device)

    # -- routing / bookkeeping ------------------------------------------------

    def _route(self, codes: np.ndarray,
               cuts: Optional[np.ndarray] = None) -> np.ndarray:
        c = self.cuts if cuts is None else cuts
        return np.clip(np.searchsorted(c, codes, side="right") - 1,
                       0, c.size - 2).astype(np.int32)

    @contextlib.contextmanager
    def _attributed(self):
        """Attribute kernel builds and loads inside the block to elastic
        work (migration handovers, shard rebuilds): the loadgen
        steady-state gate subtracts these from its recompile count, so a
        live migration never trips ``--assert-steady`` while a genuine
        serving recompile still does."""
        m0 = _kernel_recompiles()
        try:
            yield
        finally:
            self.elastic_recompiles += _kernel_recompiles() - m0

    @property
    def n_points(self) -> int:
        return int(self.uids_canonical.size)

    @property
    def mutations_pending(self) -> int:
        return sum(s.overlay.mutations_pending for s in self.shards)

    def _canon_map(self) -> np.ndarray:
        if self._canon_of_uid is None:
            m = np.full((max(1, self.next_uid),), -1, np.int32)
            m[self.uids_canonical] = np.arange(
                self.uids_canonical.size, dtype=np.int32)
            self._canon_of_uid = m
        return self._canon_of_uid

    def mutated_points(self) -> np.ndarray:
        """The canonical cloud (the rebuild/replay oracle's input)."""
        pos: Dict[int, np.ndarray] = {}
        for s in self.shards:
            pts = s.points()
            for i, u in enumerate(s.uids.tolist()):
                pos[u] = pts[i]
        out = np.empty((self.uids_canonical.size, 3), np.float32)
        for i, u in enumerate(self.uids_canonical.tolist()):
            out[i] = pos[u]
        return np.ascontiguousarray(out)

    # -- mutations (canonical-id contract, same as DeltaOverlay) --------------

    def insert(self, points: np.ndarray) -> None:
        pts = np.ascontiguousarray(
            np.asarray(points, np.float32).reshape(-1, 3))
        if pts.shape[0] == 0:
            return
        uids = np.arange(self.next_uid, self.next_uid + pts.shape[0],
                         dtype=np.int64)  # kntpu-ok: wide-dtype -- uid ledger, host-only
        self.next_uid += pts.shape[0]
        self.uids_canonical = np.concatenate([self.uids_canonical, uids])
        self._canon_of_uid = None
        codes = morton_codes(pts, self.domain)
        route = self._route(codes)
        mig = self.migration
        for j in np.unique(route):
            sel = route == j
            with self._attributed():
                # overlay compaction past compact_threshold re-prepares
                # the shard base: index maintenance, not serving work
                self.shards[int(j)].insert(pts[sel], uids[sel])
            for u in uids[sel].tolist():
                self._shard_of_uid[int(u)] = int(j)
            if (mig is not None and mig.state == "shipping"
                    and int(j) == mig.donor):
                new_route = self._route(codes[sel], mig.new_cuts)
                mv = new_route != mig.donor
                if mv.any():
                    mig.on_insert(pts[sel][mv], uids[sel][mv])

    def delete(self, ids: np.ndarray) -> None:
        """Delete by canonical CURRENT id (np.delete semantics)."""
        ids = np.unique(np.asarray(ids, np.int64).reshape(-1))  # kntpu-ok: wide-dtype -- host id arithmetic, never staged
        if ids.size == 0:
            return
        uids = self.uids_canonical[ids]
        self.uids_canonical = np.delete(self.uids_canonical, ids)
        self._canon_of_uid = None
        shard_of = np.asarray([self._shard_of_uid[int(u)] for u in uids],
                              np.int32)
        for j in np.unique(shard_of):
            batch = uids[shard_of == j]
            with self._attributed():
                self.shards[int(j)].delete_uids(batch)
        for u in uids.tolist():
            self._shard_of_uid.pop(int(u), None)
        mig = self.migration
        if mig is not None and mig.state == "shipping":
            mig.on_delete(uids)

    # -- queries --------------------------------------------------------------

    @staticmethod
    def _merge_uid_rows(per_shard: List[Tuple[np.ndarray, np.ndarray]],
                        k: int):
        """Deterministic scatter-gather merge: pure comparisons over
        (d2, uid), invalid slots (uid < 0) last via inf, ties by lower
        uid -- the same discipline as serve/delta._merge_rows, lifted to
        uid rows."""
        ids = np.concatenate([p[0] for p in per_shard], axis=1)
        d2 = np.concatenate([p[1] for p in per_shard], axis=1)
        d2 = np.where(ids >= 0, d2, np.inf)
        order = np.lexsort((ids, d2), axis=1)[:, :k]
        rows = np.arange(ids.shape[0])[:, None]
        out_i, out_d = ids[rows, order], d2[rows, order]
        out_i = np.where(np.isfinite(out_d), out_i, np.int64(-1))  # kntpu-ok: wide-dtype -- uid rows, host-only
        return out_i, np.ascontiguousarray(out_d, np.float32)

    def _canonical(self, u_i: np.ndarray) -> np.ndarray:
        cmap = self._canon_map()
        safe = np.clip(u_i, 0, cmap.size - 1)
        return np.where(u_i >= 0, cmap[safe.astype(np.int64)],  # kntpu-ok: wide-dtype -- host id arithmetic, never staged
                        np.int32(-1)).astype(np.int32)

    def query(self, queries: np.ndarray, k: int):
        """((m, k) canonical ids, -1 pad; (m, k) d2) against the CURRENT
        cloud: every shard answers its exact local top-k (the old owner
        keeps answering for ranges mid-migration), one deterministic
        merge, uid -> canonical translation at the boundary."""
        queries = np.ascontiguousarray(queries, np.float32).reshape(-1, 3)
        m = queries.shape[0]
        if m == 0 or self.n_points == 0:
            return (np.full((m, k), -1, np.int32),
                    np.full((m, k), np.inf, np.float32))
        self._seen_batches.add((m, int(k)))
        per_shard = [s.query(queries, k) for s in self.shards]
        u_i, out_d = self._merge_uid_rows(per_shard, k)
        return self._canonical(u_i), out_d

    def rebuild_oracle_query(self, queries: np.ndarray, k: int):
        """The byte-identity oracle: a fresh from-scratch problem per
        shard over that shard's EXACT canonical-order cloud, queried and
        merged with the identical deterministic merge.  The serve-tier
        pin (DeltaOverlay == rebuild on the mutated cloud) makes each
        shard's answers byte-identical, and the merge is pure
        comparisons, so the whole index's answers must match this oracle
        byte for byte -- including mid- and post-migration."""
        queries = np.ascontiguousarray(queries, np.float32).reshape(-1, 3)
        m = queries.shape[0]
        if m == 0 or self.n_points == 0:
            return (np.full((m, k), -1, np.int32),
                    np.full((m, k), np.inf, np.float32))
        per_shard = []
        for s in self.shards:
            if s.n_points == 0:
                per_shard.append(
                    (np.full((m, k), -1, np.int64),  # kntpu-ok: wide-dtype -- uid rows, host-only
                     np.full((m, k), np.inf, np.float32)))
                continue
            fresh = KnnProblem.prepare(s.points(),
                                       KnnConfig(k=self.k, adaptive=False),
                                       device=self.device)
            li, ld = fresh.query(queries, k)
            li = np.asarray(li)  # kntpu-ok: host-sync-loop -- rebuild ORACLE path: one bounded fetch per shard by design, never the serving route
            safe = np.clip(li, 0, max(0, s.uids.size - 1))
            per_shard.append((np.where(li >= 0, s.uids[safe],
                                       np.int64(-1)),  # kntpu-ok: wide-dtype -- uid rows, host-only
                              np.asarray(ld, np.float32)))  # kntpu-ok: host-sync-loop -- rebuild ORACLE path: one bounded fetch per shard by design, never the serving route
        u_i, out_d = self._merge_uid_rows(per_shard, k)
        return self._canonical(u_i), out_d

    # -- resharding -----------------------------------------------------------

    def _skew(self) -> Tuple[float, int]:
        pops = np.asarray([s.n_points for s in self.shards], np.float64)  # kntpu-ok: wide-dtype -- host skew statistic
        mean = max(1.0, float(pops.mean()))
        hot = int(pops.argmax())
        return float(pops[hot]) / mean, hot

    def _plan_rebalance(self, donor: int) -> Optional[Migration]:
        """Move the boundary between the donor and its lighter adjacent
        neighbour so the pair's population equalizes: a range split on the
        donor side, merged into the receiver's range -- one cut moves,
        one slab migrates."""
        if self.nshards < 2:
            return None
        cands = [j for j in (donor - 1, donor + 1)
                 if 0 <= j < self.nshards]
        receiver = min(cands, key=lambda j: self.shards[j].n_points)
        d = self.shards[donor]
        if d.n_points <= 1:
            return None
        excess = (d.n_points - self.shards[receiver].n_points) // 2
        if excess <= 0:
            return None
        codes = np.sort(morton_codes(d.points(), self.domain))
        new_cuts = self.cuts.copy()
        if receiver < donor:
            # donate the donor's LOW end: raise the receiver/donor cut
            new_cuts[donor] = codes[min(excess, codes.size - 1)]
        else:
            # donate the donor's HIGH end: lower the donor/receiver cut
            new_cuts[donor + 1] = codes[max(0, codes.size - excess)]
        if np.array_equal(new_cuts, self.cuts):
            return None
        mig = Migration(self, donor, receiver, new_cuts,
                        chunk=self.migration_chunk)
        if not mig.moving:
            return None
        return mig

    def maybe_rebalance(self) -> bool:
        """Start a migration when the population skew crosses the
        threshold (deterministic: same stream -> same trigger)."""
        # proto: migration-handover.start
        if self.migration is not None or self.nshards < 2:
            return False
        skew, hot = self._skew()
        if skew < self.skew_threshold:
            return False
        self.migration = self._plan_rebalance(hot)
        if self.migration is not None:
            prototrace.record("migration-handover", "start")
        return self.migration is not None

    def force_rebalance(self) -> bool:
        """Start a boundary move off the hottest shard regardless of the
        threshold (the bench/chaos trigger)."""
        # proto: migration-handover.start
        if self.migration is not None or self.nshards < 2:
            return False
        _, hot = self._skew()
        self.migration = self._plan_rebalance(hot)
        if self.migration is not None:
            prototrace.record("migration-handover", "start")
        return self.migration is not None

    def pump(self) -> Optional[dict]:
        """Advance the live migration one step; returns the handover
        summary on the pump that completes it.  Called between batches by
        the fleet front door -- resharding progresses UNDER traffic, and
        no single pump does unbounded work (no stop-the-world)."""
        # proto: migration-handover.pump
        mig = self.migration
        if mig is None:
            return None
        prototrace.record("migration-handover", "pump")
        if mig.state != "shipping":
            self.migration = None
            return None
        if (mig.wedged and mig.pumps >= self.abort_after_pumps):
            mig.abort()
            self.migration = None
            self.migrations_aborted += 1
            return {"aborted": True, "records": mig.committed_seq}
        mig.step()
        if mig.ready:
            with self._attributed():
                info = mig.handover(fault=self.fault)
                # fold the shipped delta (receiver) and the tombstoned
                # moved range (donor) into fresh bases NOW, as index-
                # maintenance cost: post-handover serving queries must not
                # pay per-query delta launches against a slab-sized
                # pending delta (compaction is byte-identity-preserving)
                for j in (mig.donor, mig.receiver):
                    self.shards[j].overlay.compact()
                self._rewarm()
            self.migration = None
            self.migrations_done += 1
            return info
        return None

    def _rewarm(self) -> None:
        """Replay every query batch shape served so far against the
        post-rebuild shards (results discarded).  Runs INSIDE an
        ``_attributed()`` block: any kernel the rebuild needs anew is
        built or loaded here, as index-maintenance cost, instead of on the
        first serving query after the handover."""
        for m, k in sorted(self._seen_batches):
            self.query(np.zeros((m, 3), np.float32), k)

    # -- chaos surfaces -------------------------------------------------------

    def lose_shard(self, j: int, canonical_points: np.ndarray) -> dict:
        """Chip loss: shard ``j``'s in-memory state is gone; rebuild it
        from the committed log's replayed cloud (the caller supplies the
        canonical replay -- replication is the durability story).  An
        in-flight migration touching the shard aborts: the donor keeps (or
        regains) the truth, nothing committed is lost."""
        j = int(j) % max(1, self.nshards)
        mig = self.migration
        if mig is not None and j in (mig.donor, mig.receiver):
            mig.abort()
            self.migration = None
            self.migrations_aborted += 1
        pts = np.ascontiguousarray(
            np.asarray(canonical_points, np.float32).reshape(-1, 3))
        codes = morton_codes(pts, self.domain)
        route = self._route(codes)
        sel = route == j
        with self._attributed():
            self.shards[j] = self._shard(j, pts[sel],
                                         self.uids_canonical[sel])
            self._rewarm()
        for u in self.uids_canonical[sel].tolist():
            self._shard_of_uid[int(u)] = j
        return {"shard": j, "rebuilt_points": int(sel.sum())}

    def wedge_migration(self) -> bool:
        if self.migration is not None:
            self.migration.wedged = True
            return True
        return False

    def delay_handover(self, pumps: int) -> bool:
        if self.migration is not None:
            self.migration.handover_delay += max(0, int(pumps))
            return True
        return False

    # -- diagnostics ----------------------------------------------------------

    def stats_dict(self) -> dict:
        skew, hot = self._skew()
        return {
            "elastic_shards": self.nshards,
            "elastic_points": self.n_points,
            "elastic_skew": round(skew, 3),
            "elastic_hot_shard": hot,
            "elastic_migrations_done": self.migrations_done,
            "elastic_migrations_aborted": self.migrations_aborted,
            "elastic_migration_active": self.migration is not None,
            "elastic_recompiles": self.elastic_recompiles,
            "shard_points": [s.n_points for s in self.shards],
            "shard_migrations": [
                {"in": s.migrations_in, "out": s.migrations_out}
                for s in self.shards],
        }
