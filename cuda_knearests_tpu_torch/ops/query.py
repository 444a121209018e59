"""Exact kNN of external query coordinates: the brute force, and the
legacy route's query pipeline.

Counterpart of ``cuda_knearests_tpu/ops/query.py``.
:func:`brute_force_by_coords` is the external-query twin of
``ops.solve.brute_force_by_index``, plain torch like it.  It resolves the
external-query rows the class route cannot certify or has no class for
(``ops.adaptive.query_adaptive``), the brute route's uncertified rows
(``mxu/solve.py``), and the legacy route's.

:func:`query_knn` answers queries against a legacy problem
(``KnnConfig(adaptive=False)``): queries bucket by supercell on the host
(:func:`bucket_queries`), each supercell's queries fill a (S, q2cap) query
pack beside the legacy pack's candidates, and the class kernel
(``cuda_solve.supercell_topk``) selects their rows in one launch a chunk,
in either epilogue.  With ``query_chunk`` the queries split into chunks
packed at one shared q2cap (:func:`_inv_flat_at`), launched back to back
and read back in one fetch, byte for byte the single shot's rows.
Without a pack (``backend='xla'``), or where the kernel's launch gate
refuses the query pack, every query takes :func:`brute_force_by_coords`,
exact; :data:`route_queries` counts the queries each route answered.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..runtime import dispatch
from ..utils.memory import LaunchBudgetError
from . import solve as _solve
from .gridhash import cell_coords_host
from .topk import (INVALID_ID, init_topk, merge_topk, pack_key,
                   translate_ids, unpack_key)

# Queries answered by each route of :func:`query_knn`: 'kernel' (the class
# kernel over the legacy pack) or 'brute' (no pack, or a query pack the
# kernel's launch gate refuses).
route_queries = {"kernel": 0, "brute": 0}


def brute_force_by_coords(points: torch.Tensor, queries: torch.Tensor,
                          k: int, tile: int = 8192,
                          ids_map: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN of (m, d) query coordinates against the (n, d) stored
    points for any d >= 1, streamed over point tiles with the 'diff'
    arithmetic of :func:`ops.solve.sum_sq_diff`.  Returns ((m, k) ids
    ascending, (m, k) d2); ties go to the lowest stored id, missing
    neighbours are (-1, inf).  ``ids_map`` (the grid permutation)
    translates the ids on the device before any readback.  Query rows run
    in chunks that bound the (rows, tile) temporaries, as in the index
    twin."""
    n, m = int(points.shape[0]), int(queries.shape[0])
    out_d = torch.empty((m, k), dtype=torch.float32, device=points.device)
    out_i = torch.empty((m, k), dtype=torch.int32, device=points.device)
    step = max(1, _solve._BRUTE_CHUNK_PAIRS // tile)
    for r0 in range(0, m, step):
        q = queries[r0:r0 + step]
        best = init_topk((q.shape[0],), k, device=points.device)
        for t0 in range(0, n, tile):
            pts_t = points[t0:t0 + tile]
            ids_t = torch.arange(t0, t0 + pts_t.shape[0], dtype=torch.int32,  # kntpu-ok: jnp-in-loop -- one id row per candidate tile of the plain brute scan, bounded by n / tile
                                 device=points.device)
            d2 = _solve.sum_sq_diff(q, pts_t)
            best = merge_topk(best, pack_key(d2, ids_t.expand(d2.shape)))
        out_d[r0:r0 + step], out_i[r0:r0 + step] = unpack_key(best)
    if ids_map is not None:
        out_i = translate_ids(out_i, ids_map)
    return out_i, out_d


def bucket_queries(queries: np.ndarray, grid, supercell: int,
                   s_total: int):
    """Host bucketing of (m, 3) float32 queries over the legacy plan's
    ``s_total`` supercells, numpy over the host twin of the grid's cell
    mapping (no device round trip).  Returns (order, sc_counts, sc_starts,
    q2cap, inv_flat, inv_sc): ``order`` sorts the queries by supercell
    (stable), ``sc_counts``/``sc_starts`` each supercell's query count and
    first sorted row, ``q2cap`` the fullest count rounded up to 128, and
    sorted row r lives in flat slot ``inv_flat[r]`` of supercell
    ``inv_sc[r]``."""
    coords = cell_coords_host(queries, grid.dim, grid.domain)
    n_sc = -(-grid.dim // supercell)
    sc = coords.astype(np.int64) // supercell  # kntpu-ok: wide-dtype -- supercell-id headroom, host-only
    sid = sc[:, 0] + n_sc * (sc[:, 1] + n_sc * sc[:, 2])
    order = np.argsort(sid, kind="stable").astype(np.int32)
    sc_counts = np.bincount(sid, minlength=s_total).astype(np.int32)
    q2cap = _solve._round_up(int(sc_counts.max()) if sc_counts.size else 1,
                             128)
    starts = np.concatenate([[0], np.cumsum(sc_counts)[:-1]]).astype(
        np.int64)  # kntpu-ok: wide-dtype -- host index arithmetic, never staged
    sid_sorted = sid[order]
    inv_flat = (sid_sorted * q2cap
                + (np.arange(order.size) - starts[sid_sorted])).astype(
                    np.int32)
    return (order, sc_counts, starts.astype(np.int32), q2cap, inv_flat,
            sid_sorted.astype(np.int32))


def _inv_flat_at(sc_starts: np.ndarray, inv_sc: np.ndarray,
                 q2cap: int) -> np.ndarray:
    """A bucketing's ``inv_flat`` at another (shared) q2cap, its only
    q2cap-dependent output."""
    sid = inv_sc.astype(np.int64)  # kntpu-ok: wide-dtype -- host index arithmetic, never staged
    rank = np.arange(sid.size) - sc_starts.astype(np.int64)[sid]  # kntpu-ok: wide-dtype -- host index arithmetic, never staged
    return (sid * q2cap + rank).astype(np.int32)


def _query_packed(queries_sorted: torch.Tensor, sc_starts: torch.Tensor,
                  sc_counts: torch.Tensor, inv_flat: torch.Tensor,
                  inv_sc: torch.Tensor, pack, perm: torch.Tensor,
                  q2cap: int, k: int, domain: float,
                  epilogue: str = "scatter"):
    """One chunk's launch over the legacy pack's supercells: each
    supercell's queries (sorted rows ``sc_starts`` on) in its q2cap query
    slots, ids all ``_PAD_Q`` (an external query excludes nothing), beside
    the pack's candidates.  'scatter': mode (a) writes each slot's row at
    its sorted query row; 'gather': mode (b), then
    ``cuda_solve.gather_rows`` through ``inv_flat``/``inv_sc``.  Returns
    ((m, k) ids in original indexing -- translated on the device through
    ``perm`` --, (m, k) d2, (m,) certified), rows in sorted query
    order."""
    from .cuda_solve import _PAD_Q, ClassPack, pack_rows

    m = queries_sorted.shape[0]
    device = queries_sorted.device
    slots = torch.arange(q2cap, dtype=torch.int64, device=device)
    qs_idx = sc_starts.long()[:, None] + slots[None, :]
    qs_ok = slots[None, :] < sc_counts.long()[:, None]
    safe = torch.where(qs_ok, qs_idx, 0)
    qx, qy, qz = (queries_sorted[:, ax][safe].contiguous()
                  for ax in range(3))
    qid = torch.full(qx.shape, _PAD_Q, dtype=torch.int32, device=device)
    pk = ClassPack(qx, qy, qz, qid, pack.pk.cx, pack.pk.cy, pack.pk.cz,
                   pack.pk.cid)
    tgt = (torch.where(qs_ok, qs_idx, m).to(torch.int32).reshape(-1)
           if epilogue == "scatter" else None)
    row_d, row_i = pack_rows(pk, k, 0, False, epilogue, tgt, inv_flat,
                             inv_sc)
    ok = torch.isfinite(row_d)
    row_i = translate_ids(torch.where(ok, row_i, INVALID_ID), perm)
    row_d = torch.where(ok, row_d, float("inf"))
    box = inv_sc.long()
    cert = row_d[:, k - 1] <= _solve._margin_sq(
        queries_sorted, pack.lo[box], pack.hi[box], domain)
    return row_i, row_d, cert


def _launch_packed(qs: torch.Tensor, starts, sc_counts, inv_flat, inv_sc,
                   pack, perm: torch.Tensor, q2cap: int, k: int,
                   domain: float, epilogue: str):
    """One chunk's launch: its host index arrays staged without blocking,
    then :func:`_query_packed`.  (The reference keys an executable cache
    here; torch compiles nothing per shape, so there is none to key.)"""
    device = qs.device
    return _query_packed(qs, dispatch.stage(starts, device),  # syncflow: query-launch-stage
                         dispatch.stage(sc_counts, device),  # syncflow: query-launch-stage
                         dispatch.stage(inv_flat, device),  # syncflow: query-launch-stage
                         dispatch.stage(inv_sc, device), pack, perm, q2cap,  # syncflow: query-launch-stage
                         k, domain, epilogue)


def _kernel_takes(k: int, q2cap: int, ccap: int) -> bool:
    """The class kernel's launch gate as a predicate (``topk_plan``)."""
    from .cuda_solve import topk_plan

    try:
        topk_plan(k, q2cap, ccap)
    except LaunchBudgetError:
        return False
    return True


def query_knn(grid, plan, pack, queries: np.ndarray, k: int, supercell: int,
              fallback: str = "brute", epilogue: str = "scatter",
              chunk: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """The legacy route's external queries: ((m, k) ids in original
    indexing, ascending; (m, k) d2), rows in query order.

    Bucketing is host numpy; every chunk's launch is dispatched with no
    readback between chunks, then one batched fetch reads every chunk's
    rows back, and at most one more reads the exact resolution of
    uncertified kernel rows (with ``fallback='brute'``): at most two host
    round trips.  With ``chunk`` the queries split into chunks of that
    many, all packed at one shared q2cap, byte for byte the single shot.
    Without a ``pack``, or where the kernel's launch gate refuses (k,
    q2cap, ccap), every query takes :func:`brute_force_by_coords`."""
    queries = np.ascontiguousarray(queries, np.float32)
    m = queries.shape[0]
    if m == 0:
        return np.empty((0, k), np.int32), np.empty((0, k), np.float32)
    device = grid.device
    s_total = plan.n_chunks * plan.batch
    step = m if not chunk else max(1, int(chunk))
    bounds = [(a, min(a + step, m)) for a in range(0, m, step)]
    buckets = [bucket_queries(queries[a:b], grid, supercell, s_total)
               for a, b in bounds]
    q2cap = max(bk[3] for bk in buckets)
    if len(bounds) > 1:
        # one shared capacity: only inv_flat depends on it
        buckets = [(order, cnt, st, q2cap, _inv_flat_at(st, inv_sc, q2cap),
                    inv_sc) for order, cnt, st, _, _, inv_sc in buckets]
    use_kernel = pack is not None and _kernel_takes(k, q2cap, pack.ccap)
    route_queries["kernel" if use_kernel else "brute"] += m
    pending = []
    for (a, b), (order, sc_counts, starts, _, inv_flat, inv_sc) in zip(
            bounds, buckets):
        qs = dispatch.stage(queries[a:b][order], device)  # syncflow: query-chunk-stage
        if use_kernel:
            pending.extend(_launch_packed(
                qs, starts, sc_counts, inv_flat, inv_sc, pack,
                grid.permutation, q2cap, k, grid.domain, epilogue))
        else:
            pending.extend(brute_force_by_coords(grid.points, qs, k,
                                                 ids_map=grid.permutation))
    fetched = dispatch.fetch(*pending)  # syncflow: query-final
    per = 3 if use_kernel else 2
    nbrs = np.empty((m, k), np.int32)
    d2 = np.empty((m, k), np.float32)
    cert = np.ones((m,), bool)
    for i, ((a, _), bk) in enumerate(zip(bounds, buckets)):
        rows = a + bk[0]
        nbrs[rows] = fetched[per * i]
        d2[rows] = fetched[per * i + 1]
        if use_kernel:
            cert[rows] = fetched[per * i + 2]
    if use_kernel and fallback == "brute" and not cert.all():
        bad = np.nonzero(~cert)[0]
        b_i, b_d = brute_force_by_coords(
            grid.points, dispatch.stage(queries[bad], device), k,  # syncflow: query-fallback-stage
            ids_map=grid.permutation)
        b_i, b_d = dispatch.fetch(b_i, b_d)  # syncflow: query-fallback
        nbrs[bad] = b_i
        d2[bad] = b_d
    return nbrs, d2
