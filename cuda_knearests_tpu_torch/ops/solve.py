"""Supercell geometry, CSR slot packing, the certificate, the legacy
single-schedule route and the exact brute-force fallback.

Counterpart of ``cuda_knearests_tpu/ops/solve.py``.  Queries are grouped by
supercell (a tile of s^3 grid cells); every query of a supercell shares one
candidate set, the supercell dilated by its ring radius.  A query is
certified when its k-th distance is within its margin to the dilated box,
so no un-gathered point can be nearer; uncertified rows are resolved
exactly by :func:`brute_force_by_index`, which stays plain torch as it is
plain XLA in the reference package.

The legacy route (``KnnConfig(adaptive=False)``, or ``dist_method='dot'``
or ``backend='xla'``) plans one global radius and one global (qcap, ccap)
for every supercell (:func:`global_schedule`, :func:`build_plan`) and
solves either through the class kernel over one pack of every supercell
(``backend`` 'auto'/'pallas': :func:`prepare_pack`,
``cuda_solve.solve_packed``) or through :func:`chunk_best`, the supercell
scan in plain torch, ``sc_batch`` supercells a step (``backend='xla'``,
the only route of 'dot' arithmetic).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import KnnConfig
from .rings import box_sums
from .topk import (INVALID_ID, init_topk, merge_topk, pack_key,
                   smallest_keys, unpack_key)

# (query row, point) pairs per chunk of the brute-force fallback.
_BRUTE_CHUNK_PAIRS = 1 << 24


@dataclasses.dataclass(frozen=True)
class KnnResult:
    """Neighbours in *sorted* point indexing, ascending by distance.

    ``certified`` marks rows proven complete by the box-margin bound;
    ``uncert_count`` is the number of rows that were not (on a finalized
    result: the rows the exact fallback had to resolve).  ``planes`` is
    the Voronoi plane feed, rows in original order, when the solve was
    asked for it (``KnnConfig.plane_feed``, ``KnnProblem.get_planes``)."""

    neighbors: np.ndarray | torch.Tensor   # (n, k) i32
    dists_sq: np.ndarray | torch.Tensor    # (n, k) f32
    certified: np.ndarray | torch.Tensor   # (n,) bool
    uncert_count: Optional[np.ndarray | torch.Tensor] = None
    planes: Optional[np.ndarray] = None    # (n, k, 4) f32


def _boxes_grid(n_sc: int) -> np.ndarray:
    """(n_sc^3, 3) supercell integer coordinates, x fastest."""
    r = np.arange(n_sc, dtype=np.int32)
    zz, yy, xx = np.meshgrid(r, r, r, indexing="ij")
    return np.stack([xx.ravel(), yy.ravel(), zz.ravel()], axis=1)


def _box_cell_ids(sc_coords: np.ndarray, lo_off: int, hi_off: int, s: int,
                  dim: int) -> np.ndarray:
    """Linear cell ids of box [sc*s+lo_off, sc*s+s+hi_off) per supercell,
    -1 where the box leaves the grid.  Returns (num_sc, side^3) int32."""
    side = s + hi_off - lo_off
    offs = np.arange(lo_off, s + hi_off, dtype=np.int32)
    ax = sc_coords[:, :, None] * s + offs[None, None, :]
    ok = (ax >= 0) & (ax < dim)
    axc = np.clip(ax, 0, dim - 1)
    x, y, z = axc[:, 0], axc[:, 1], axc[:, 2]
    okx, oky, okz = ok[:, 0], ok[:, 1], ok[:, 2]
    lin = (x[:, None, None, :]
           + dim * y[:, None, :, None]
           + dim * dim * z[:, :, None, None])
    valid = (okx[:, None, None, :] & oky[:, None, :, None]
             & okz[:, :, None, None])
    out = np.where(valid, lin, -1).reshape(sc_coords.shape[0], side ** 3)
    return out.astype(np.int32)


def _round_up(x: int, m: int) -> int:
    return max(m, ((int(x) + m - 1) // m) * m)


@dataclasses.dataclass(frozen=True)
class SolvePlan:
    """The legacy route's schedule, built on the host at prepare time.

    ``own_cells`` (n_chunks, batch, s^3) and ``cand_cells`` (n_chunks,
    batch, (s + 2R)^3) int32 cell ids per supercell (-1 pad), ``box_lo`` /
    ``box_hi`` (n_chunks, batch, 3) f32 dilated-box corners, on the
    grid's device; ``qcap``/``ccap`` the global per-supercell capacities.
    The supercells past the grid's (padding the last chunk) are empty."""

    own_cells: torch.Tensor
    cand_cells: torch.Tensor
    box_lo: torch.Tensor
    box_hi: torch.Tensor
    qcap: int
    ccap: int
    n_chunks: int
    batch: int


def global_schedule(grid, cfg: KnnConfig,
                    cell_counts_host: np.ndarray | None = None):
    """The legacy route's host schedule over every supercell of the
    z-major supercell grid: (own_cells, cand_cells, box_lo, box_hi, qcap,
    ccap), as numpy.  One radius (``cfg.resolved_ring_radius()``) for
    every supercell; qcap is the fullest supercell's count rounded up to
    8, ccap the fullest dilated box's (at least k) rounded up to 128."""
    dim, s = grid.dim, cfg.supercell
    radius = cfg.resolved_ring_radius()
    sc = _boxes_grid(-(-dim // s))
    num_sc = sc.shape[0]
    counts = (np.asarray(cell_counts_host) if cell_counts_host is not None
              else grid.cell_counts.cpu().numpy())
    counts3 = counts.reshape(dim, dim, dim)
    own = _box_cell_ids(sc, 0, 0, s, dim)
    cand = _box_cell_ids(sc, -radius, radius, s, dim)
    own_n = box_sums(counts3, sc * s, np.minimum(sc * s + s, dim))
    cand_n = box_sums(counts3, sc * s - radius, sc * s + s + radius)
    qcap = _round_up(own_n.max() if num_sc else 1, 8)
    ccap = _round_up(max(cand_n.max() if num_sc else 1, cfg.k), 128)
    w = grid.domain / dim
    box_lo = ((sc * s - radius) * w).astype(np.float32)
    box_hi = ((sc * s + s + radius) * w).astype(np.float32)
    return own, cand, box_lo, box_hi, int(qcap), int(ccap)


def build_plan(grid, cfg: KnnConfig,
               cell_counts_host: np.ndarray | None = None) -> SolvePlan:
    """The global schedule in chunks of ``cfg.sc_batch`` supercells, the
    last one padded with empty supercells, staged on the grid's device."""
    own, cand, box_lo, box_hi, qcap, ccap = global_schedule(
        grid, cfg, cell_counts_host)
    batch = max(1, int(cfg.sc_batch))
    n_chunks = -(-own.shape[0] // batch)
    pad = n_chunks * batch - own.shape[0]

    def chunked(a: np.ndarray, fill) -> torch.Tensor:
        if pad:
            a = np.concatenate(
                [a, np.full((pad,) + a.shape[1:], fill, a.dtype)])
        return torch.as_tensor(a.reshape(n_chunks, batch, *a.shape[1:]),
                               device=grid.device)

    return SolvePlan(own_cells=chunked(own, -1), cand_cells=chunked(cand, -1),
                     box_lo=chunked(box_lo, 0.0), box_hi=chunked(box_hi, 0.0),
                     qcap=qcap, ccap=ccap, n_chunks=n_chunks, batch=batch)


def pack_cells(cells: torch.Tensor, starts: torch.Tensor,
               counts: torch.Tensor, cap: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense-pack the points of ragged cell lists: (B, M) cell ids (-1 pad)
    -> (B, cap) stored-point indices, slot t holding the t-th point across
    the row's cells in order.  Returns (indices clamped to 0 where invalid,
    valid mask)."""
    valid_cell = cells >= 0
    safe = torch.where(valid_cell, cells, 0).long()
    cnt = torch.where(valid_cell, counts[safe].long(), 0)
    cum = torch.cumsum(cnt, dim=1)
    off = cum - cnt
    total = cum[:, -1]
    slots = torch.arange(cap, dtype=torch.int64, device=cells.device)
    which = torch.searchsorted(
        cum, slots.expand(cells.shape[0], cap).contiguous(), right=True)
    which = torch.clamp(which, 0, cells.shape[1] - 1)
    adj = starts[safe].long() - off
    idx = slots[None, :] + torch.gather(adj, 1, which)
    ok = slots[None, :] < total[:, None]
    return torch.where(ok, idx, 0).to(torch.int32), ok


def _margin_sq(q: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
               domain: float) -> torch.Tensor:
    """Squared margin from each (n, 3) query to the complement of its
    dilated box [lo, hi); box sides at or beyond the domain boundary do not
    constrain.  Returns (n,)."""
    inf = torch.tensor(float("inf"), dtype=q.dtype, device=q.device)
    m_lo = torch.where(lo <= 0.0, inf, q - lo)
    m_hi = torch.where(hi >= domain, inf, hi - q)
    m = torch.clamp(torch.minimum(m_lo, m_hi).amin(dim=-1), min=0.0)
    return torch.where(torch.isinf(m), inf, m * m)


def sum_sq_diff(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(..., m, t) squared distances of (..., m, d) queries to (..., t, d)
    points (leading axes broadcast): the subtract-square-accumulate over
    axes 0..d-1, every op rounded on its own (the engine's 'diff'
    arithmetic)."""
    d2 = None
    for ax in range(q.shape[-1]):
        diff = q[..., :, None, ax] - p[..., None, :, ax]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    return d2


def _pair_d2(q: torch.Tensor, c: torch.Tensor, method: str) -> torch.Tensor:
    """(B, Q, 3) x (B, C, 3) -> (B, Q, C) squared distances.  'diff' sums
    (q - c)^2 over x, y, z, each op rounded on its own
    (:func:`sum_sq_diff`, the kernels' arithmetic); 'dot' is |q|^2 + |c|^2
    - 2 q.c with a torch matmul, never in TF32 (it may order near-ties
    differently, and dip below 0 for coincident points)."""
    if method != "dot":
        return sum_sq_diff(q, c)
    qq = (q * q).sum(-1)
    cc = (c * c).sum(-1)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        qc = torch.matmul(q, c.transpose(1, 2))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    return qq[:, :, None] + cc[:, None, :] - 2.0 * qc


def _signed_key(d2: torch.Tensor, ids: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """:func:`topk.pack_key` for d2 of either sign (the 'dot' form): a
    negative float's bits, all but the sign flipped, order like the
    float."""
    key = pack_key(torch.where(d2 <= 0, 0.0, d2), ids, mask)
    bits = d2.contiguous().view(torch.int32).to(torch.int64)
    neg = ((bits ^ 0x7FFFFFFF) << 32) | (ids.to(torch.int64) & 0xFFFFFFFF)
    return torch.where((d2 < 0) & mask, neg, key)


def _signed_unkey(key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`_signed_key`."""
    hi = key >> 32
    hi = torch.where(hi < 0, hi ^ 0x7FFFFFFF, hi)
    d2, ids = unpack_key(key)
    d2 = torch.where(key < 0, hi.to(torch.int32).view(torch.float32), d2)
    return d2, torch.where(key < 0, (key & 0xFFFFFFFF).to(torch.int32), ids)


def chunk_best(points: torch.Tensor, starts: torch.Tensor,
               counts: torch.Tensor, own: torch.Tensor, cand: torch.Tensor,
               lo: torch.Tensor, hi: torch.Tensor, qcap: int, ccap: int,
               k: int, dist_method: str, exclude_self: bool, domain: float):
    """One chunk of supercells of the legacy scan: pack their queries and
    candidates, score every pair (:func:`_pair_d2`), mask pads and (with
    ``exclude_self``) the query's own stored index, keep the k smallest by
    (d2, id), and certify each real query against its box.  Returns
    (q_idx, q_valid, best_d, best_i, cert), ids indexing ``points``."""
    q_idx, q_valid = pack_cells(own, starts, counts, qcap)
    c_idx, c_valid = pack_cells(cand, starts, counts, ccap)
    q = points[q_idx.long()]
    d2 = _pair_d2(q, points[c_idx.long()], dist_method)
    mask = q_valid[:, :, None] & c_valid[:, None, :]
    if exclude_self:
        mask = mask & (c_idx[:, None, :] != q_idx[:, :, None])
    ids = c_idx[:, None, :].expand(d2.shape)
    if dist_method == "dot":
        best_d, best_i = _signed_unkey(smallest_keys(
            _signed_key(d2, ids, mask), k))
    else:
        best_d, best_i = unpack_key(smallest_keys(pack_key(d2, ids, mask),
                                                  k))
    cert = q_valid & (best_d[..., -1]
                      <= _margin_sq(q, lo[:, None, :], hi[:, None, :],
                                    domain))
    return q_idx, q_valid, best_d, best_i, cert


def _solve_planned(points: torch.Tensor, starts: torch.Tensor,
                   counts: torch.Tensor, plan: SolvePlan, k: int,
                   dist_method: str, exclude_self: bool, domain: float):
    """The legacy scan: :func:`chunk_best` chunk by chunk, each chunk's
    rows written at their stored points (pads into a spare row n).
    Returns ((n, k) ids, (n, k) d2, (n,) certified, uncertified count)."""
    n = points.shape[0]
    out_d = torch.full((n + 1, k), float("inf"), dtype=torch.float32,
                       device=points.device)
    out_i = torch.full((n + 1, k), INVALID_ID, dtype=torch.int32,
                       device=points.device)
    out_cert = torch.zeros((n + 1,), dtype=torch.bool, device=points.device)
    for c in range(plan.n_chunks):
        q_idx, q_valid, best_d, best_i, cert = chunk_best(
            points, starts, counts, plan.own_cells[c], plan.cand_cells[c],
            plan.box_lo[c], plan.box_hi[c], plan.qcap, plan.ccap, k,
            dist_method, exclude_self, domain)
        safe = torch.where(q_valid, q_idx, n).long().reshape(-1)
        out_d[safe] = best_d.reshape(-1, k)
        out_i[safe] = best_i.reshape(-1, k)
        out_cert[safe] = cert.reshape(-1)
    cert = out_cert[:n]
    return out_i[:n], out_d[:n], cert, (~cert).sum().to(torch.int32)


def pick_backend(cfg: KnnConfig, qcap: int, ccap: int) -> str:
    """'pallas' (the class kernel over one pack of every supercell) or
    'xla' (the plain-torch scan) for a legacy schedule of capacities
    (qcap, ccap).  An explicit backend passes through, with the
    reference's refusals ('pallas' computes 'diff' only; 'oracle' has no
    grid route).  'auto' takes the kernel on either device unless 'dot'
    is asked for; a pack that the launch gate or the memory budget
    cannot take is refused by :func:`prepare_pack`, never sent to the
    scan (pass backend='xla' for that)."""
    if cfg.backend != "auto":
        if cfg.backend == "pallas" and cfg.dist_method == "dot":
            raise ValueError(
                "backend='pallas' computes 'diff' distances only; use "
                "dist_method='diff' or backend='xla'")
        if cfg.backend == "oracle":
            raise ValueError(
                "backend='oracle' is a single-chip host engine "
                "(api.KnnProblem); this path has no oracle route")
        return cfg.backend
    return "xla" if cfg.dist_method == "dot" else "pallas"


def resolve_backend(cfg: KnnConfig, plan: SolvePlan) -> str:
    return pick_backend(cfg, plan.qcap, plan.ccap)


def prepare_pack(grid, cfg: KnnConfig, plan: SolvePlan,
                 backend: Optional[str] = None):
    """The legacy kernel route's pack (``cuda_solve.build_pack``) when the
    backend (default: :func:`resolve_backend`) is 'pallas', else None.
    ``cuda_solve.preflight_launch`` refuses a pack the launch gate or the
    memory budget cannot take before anything is allocated."""
    from ..config import blocked_topm, resolve_kernel
    from .cuda_solve import build_pack, hbm_budget_bytes, preflight_launch

    if (backend or resolve_backend(cfg, plan)) != "pallas":
        return None
    kernel = resolve_kernel(cfg.effective_kernel(), cfg.k, plan.ccap)
    preflight_launch(plan.qcap, plan.ccap, cfg.k, plan.n_chunks * plan.batch,
                     grid.n_points,
                     m=blocked_topm(cfg.k, plan.ccap)
                     if kernel == "blocked" else 0,
                     epilogue=cfg.resolved_epilogue(), site="prepare_pack",
                     budget=hbm_budget_bytes(grid.device, cfg))
    return build_pack(grid.points, grid.cell_starts, grid.cell_counts, plan)


def solve(grid, cfg: KnnConfig, plan: Optional[SolvePlan] = None,
          pack=None, backend: Optional[str] = None) -> KnnResult:
    """The legacy route's all-points kNN, results on the grid's device in
    sorted indexing; uncertified rows are left for the api's exact
    fallback.  ``backend`` is the route chosen at prepare (default:
    'pallas' with a ``pack``, else :func:`resolve_backend` now): 'pallas'
    runs the class kernel over the pack (``cuda_solve.solve_packed``;
    packed first when none is given), 'xla' the scan."""
    from ..config import resolve_kernel
    from .cuda_solve import solve_packed

    if plan is None:
        plan = build_plan(grid, cfg)
    if backend is None:
        backend = ("pallas" if pack is not None
                   else resolve_backend(cfg, plan))
    if backend == "pallas":
        if pack is None:
            pack = prepare_pack(grid, cfg, plan, backend)
        nbr, d2, cert, n_unc = solve_packed(
            pack, grid.points, cfg.k, cfg.exclude_self, grid.domain,
            resolve_kernel(cfg.effective_kernel(), cfg.k, pack.ccap),
            cfg.resolved_epilogue())
    else:
        nbr, d2, cert, n_unc = _solve_planned(
            grid.points, grid.cell_starts, grid.cell_counts, plan, cfg.k,
            cfg.dist_method, cfg.exclude_self, grid.domain)
    return KnnResult(neighbors=nbr, dists_sq=d2, certified=cert,
                     uncert_count=n_unc)


def brute_force_by_index(points: torch.Tensor, q_idx: torch.Tensor, k: int,
                         exclude_self: bool = True, tile: int = 8192
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN of selected stored points against the whole set, streamed
    over point tiles.  ``q_idx`` may be padded with -1 (those rows come back
    all -1/inf).  Returns ((m, k) ids ascending, (m, k) d2) in sorted
    indexing; ties go to the lowest stored id.  Query rows run in chunks of
    at most ``_BRUTE_CHUNK_PAIRS // tile``, which bounds the (rows, tile)
    temporaries however many rows need the fallback.  Dimension-agnostic:
    ``points`` may be (n, d) for any d >= 1, d2 summed over axes 0..d-1."""
    n = int(points.shape[0])
    m = int(q_idx.shape[0])
    out_d = torch.empty((m, k), dtype=torch.float32, device=points.device)
    out_i = torch.empty((m, k), dtype=torch.int32, device=points.device)
    step = max(1, _BRUTE_CHUNK_PAIRS // tile)
    for r0 in range(0, m, step):
        qi = q_idx[r0:r0 + step]
        q_ok = qi >= 0
        q = points[torch.where(q_ok, qi, 0).long()] if n else None
        best = init_topk((qi.shape[0],), k, device=points.device)
        for t0 in range(0, n, tile):
            pts_t = points[t0:t0 + tile]
            ids_t = torch.arange(t0, t0 + pts_t.shape[0], dtype=torch.int32,  # kntpu-ok: jnp-in-loop -- one id row per candidate tile of the plain brute scan, bounded by n / tile
                                 device=points.device)
            d2 = sum_sq_diff(q, pts_t)
            mask = q_ok[:, None].expand(d2.shape)
            if exclude_self:
                mask = mask & (ids_t[None, :] != qi[:, None])
            best = merge_topk(best,
                              pack_key(d2, ids_t.expand(d2.shape), mask))
        out_d[r0:r0 + step], out_i[r0:r0 + step] = unpack_key(best)
    return out_i, out_d
