"""Adaptive supercell capacities: per-supercell radii, capacity classes,
the class-partitioned solve and external queries through the same classes.

Counterpart of ``cuda_knearests_tpu/ops/adaptive.py:56-1092``.  At prepare
time, on the host:

  1. each supercell gets the smallest dilation radius whose local ring
     occupancy predicts that its k-th neighbour fits inside the certified
     margin (:func:`select_radii`);
  2. nonempty supercells group by radius, split once at the 90th
     percentile of candidate count when the class maximum dwarfs it, and
     the smallest groups merge until at most ``max_classes`` remain
     (:func:`build_class_specs`) -- the same partition as the reference
     package, which the tests hold equal;
  3. each class is packed once into kernel inputs, and the slot partition
     is inverted into per-class forward row maps (``ClassPlan.tgt``), a
     per-point row map into the classes' concatenated rows
     (``AdaptivePlan.inv_row``, for the gather epilogue) and a per-point
     supercell map (``AdaptivePlan.inv_box``) for the certificate.

Each class takes one of three routes, chosen in the plan as the reference
chooses it (``cuda_knearests_tpu/ops/adaptive.py:185-224``):

  * 'kernel': one launch of the one-stage ``supercell_topk`` (or
    ``blocked_topk`` where ``config.resolve_kernel`` gives 'blocked')
    writing rows straight into the final (n, k) buffers -- where the
    launch gate takes the class's k and its packs fit the memory budget;
  * 'streamed': :func:`streamed_topk`, plain torch on either device,
    folding candidate tiles into a running top-k with a bounded
    temporary -- everywhere else (k too large for one block's lists, or a
    pack over the budget);
  * 'mxu': under ``resolved_scorer() == 'mxu'``, every class whose score
    tile ``mxu.scorer.class_eligible`` takes runs the MXU class scorer
    (``mxu.scorer.grid_class_topk``, plain torch; NaN at column k-1 on the
    rows its fold does not certify); the other classes keep the routes
    above.

A class never falls back after a kernel fails: the route is fixed when the
plan is built.  Under ``epilogue='scatter'`` (and 'auto') every class
writes its rows at their destinations; under 'gather' each kernel class
launches mode (b), every class's rows are concatenated and one gather
through ``inv_row`` reads the (n, k) rows.  Every row then gets its
box-margin certificate, and non-finite entries become (inf, -1).

External queries (:func:`query_adaptive`) reuse the plan: each query takes
its supercell's class, the class's candidate pack and its route, and a
kernel class streams its queries only when their padded query pack does
not fit the memory budget.  An 'mxu' class's queries take the class's
exact route (:func:`class_route`), as the reference sends them to its
exact dense route: the MXU scorer is a self-solve.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..config import (KnnConfig, blocked_topm, default_ring_radius,
                      resolve_kernel)
from ..mxu.scorer import class_eligible, class_rows_chunk, grid_class_topk
from ..obs import spans as _spans
from ..runtime import dispatch
from ..utils.memory import LaunchBudgetError
from ..utils.profiling import annotate
from .cuda_solve import (_PAD_Q, ClassPack, hbm_budget_bytes, launch_class,
                         pack_bytes, pack_inputs, pick_q_tile)
from .gridhash import GridHash, cell_coords_host
from .query import brute_force_by_coords
from .rings import ring_occupancy
from .solve import (KnnResult, _box_cell_ids, _boxes_grid, _margin_sq,
                    _round_up, pack_cells, sum_sq_diff)
from .topk import (INVALID_ID, init_topk, merge_topk, pack_key,
                   translate_ids, unpack_key)

# Candidate slots per step of the streamed route (the reference's
# KnnConfig.stream_tile default), and the bound on its (rows, qcap, tile)
# f32 distance tile.
STREAM_TILE = 2048
_STREAM_TILE_BYTES = 64 << 20
# Peak bytes of one streamed step per (query slot, tile + k slot) and per
# candidate slot of its pack (:func:`stream_step_bytes`).  On an H100 a
# step's torch.cuda.max_memory_allocated came to 28 bytes a slot at
# k=1000 and 38 at k=10 (tests/test_torch_cuda.py
# test_streamed_step_memory_within_its_model, which with chip_smoke.py
# holds every step to this model).
_STEP_SLOT_BYTES = 48
_STEP_PACK_BYTES = 64
# Per query slot of a streamed class at solve time: its coordinates,
# validity and the gather's int32 and int64 indices.
_SLOT_SOLVE_BYTES = 25
# Peak bytes of one step of an 'mxu' class (:func:`class_step_bytes`) per
# (query slot, candidate slot) pair -- the f32 scores, the int64 keys
# beside them (twice the reference's f32 tile) and the fold's masks and
# per-block lists -- and per candidate slot of its pack.
_CLASS_PAIR_BYTES = 40
_CLASS_CAND_BYTES = 64


def select_radii(points_cum: np.ndarray, cells_cum: np.ndarray, k: int,
                 rmax: int) -> np.ndarray:
    """Smallest per-supercell dilation radius consistent with local density:
    the smallest r >= ceil(expected k-th neighbour distance in cells at the
    r-dilated box's density) + 1; supercells that stay too sparse get
    rmax."""
    num_sc = points_cum.shape[0]
    radii = np.full((num_sc,), rmax, np.int32)
    unassigned = np.ones((num_sc,), bool)
    for r in range(1, rmax + 1):
        rho = points_cum[:, r] / np.maximum(cells_cum[:, r], 1)
        r_exp = np.cbrt(3.0 * k / (4.0 * math.pi * np.maximum(rho, 1e-12)))
        ok = unassigned & (r >= np.ceil(r_exp) + 1.0)
        radii[ok] = r
        unassigned &= ~ok
    return radii


@dataclasses.dataclass(frozen=True)
class ClassSpec:
    """Host-side description of one capacity class."""

    rows: np.ndarray      # (Sc,) indices into the global supercell list
    radius: int
    qcap: int             # per-supercell query capacity (8-aligned)
    ccap: int             # per-supercell candidate capacity (128-aligned)
    route: str = "kernel"  # 'kernel' | 'streamed' | 'mxu'


def class_route(cfg: KnnConfig, qcap: int, ccap: int) -> str:
    """'kernel' when the class kernel's launch gate takes k (``pick_q_tile``
    as a predicate), 'streamed' otherwise.  :func:`_preflight` then sends
    kernel classes whose packs do not fit the memory budget to the
    streamed route too."""
    try:
        pick_q_tile(cfg.k, qcap, class_blocked_m(cfg, ccap))
    except LaunchBudgetError:
        return "streamed"
    return "kernel"


def build_class_specs(own_n: np.ndarray, pts_cum: np.ndarray,
                      radii: np.ndarray, cfg: KnnConfig
                      ) -> Tuple[ClassSpec, ...]:
    """Partition nonempty supercells into <= cfg.max_classes classes.

    Grouped by radius, split once at the 90th percentile of candidate count
    when the group maximum exceeds twice it, then the smallest groups merge
    (taking the larger radius) until the class budget holds.  Each class's
    ccap is measured at its final radius, so packing never truncates a
    candidate list.  Under ``cfg.resolved_scorer() == 'mxu'`` a class
    whose score tile ``class_eligible`` takes is routed 'mxu'; every other
    class by :func:`class_route`."""
    def cand_at(rows: np.ndarray, radius: int) -> np.ndarray:
        return pts_cum[rows, radius]

    groups: list = []  # (rows, radius)
    nonempty = np.nonzero(own_n > 0)[0]
    for r in np.unique(radii[nonempty]):
        rows = nonempty[radii[nonempty] == r]
        cn = cand_at(rows, int(r))
        p90 = np.quantile(cn, 0.9) if rows.size > 8 else cn.max(initial=0)
        if rows.size > 8 and cn.max() > 2.0 * max(p90, 1.0):
            groups.append((rows[cn <= p90], int(r)))
            groups.append((rows[cn > p90], int(r)))
        else:
            groups.append((rows, int(r)))
    groups = [(rows, r) for rows, r in groups if rows.size]

    while len(groups) > max(1, int(cfg.max_classes)):
        groups.sort(key=lambda g: g[0].size)
        (rows_a, r_a), (rows_b, r_b) = groups[0], groups[1]
        groups = groups[2:] + [(np.concatenate([rows_a, rows_b]),
                                max(r_a, r_b))]

    mxu = cfg.resolved_scorer() == "mxu"

    def mk(rows: np.ndarray, radius: int) -> ClassSpec:
        qcap = _round_up(int(own_n[rows].max()), 8)
        ccap = _round_up(max(int(cand_at(rows, radius).max()), cfg.k), 128)
        route = ("mxu" if mxu and class_eligible(qcap, ccap)
                 else class_route(cfg, qcap, ccap))
        return ClassSpec(rows=rows, radius=radius, qcap=qcap, ccap=ccap,
                         route=route)

    return tuple(mk(rows, r) for rows, r in groups)


@dataclasses.dataclass(frozen=True)
class ClassPlan:
    """Device-side schedule of one class.

    ``lo``/``hi`` are the (Sc, 3) f32 dilated-box corners of the
    certificate; ``qid`` the (Sc, qcap) int32 stored point of each query
    slot (``_PAD_Q`` on pads); ``tgt`` the (Sc*qcap,) int32 forward row map
    (destination row per slot, ``n`` on pad slots).  A 'kernel' class
    carries its packed kernel inputs ``pk`` (whose ``qid`` is ``qid``); a
    'streamed' class carries ``cand``, the (Sc, side^3) int32 cell ids of
    each supercell's dilated box (-1 off the grid), which
    :func:`streamed_topk` packs tile by tile, and ``step_rows``, its
    supercells a step (from :func:`_preflight`).  An 'mxu' class carries
    ``cand``, ``own`` (the (Sc, s^3) cell ids of each supercell) and
    ``step_rows``: :func:`grid_class_topk` packs both step by step."""

    lo: torch.Tensor
    hi: torch.Tensor
    radius: int
    qcap: int
    ccap: int
    route: str
    qid: torch.Tensor
    pk: Optional[ClassPack]
    cand: Optional[torch.Tensor]
    step_rows: Optional[int]
    tgt: Optional[torch.Tensor]
    own: Optional[torch.Tensor] = None

    @property
    def n_sc(self) -> int:
        return int(self.qid.shape[0])


@dataclasses.dataclass(frozen=True)
class AdaptivePlan:
    """Class schedules plus ``inv_box``: (n,) int32 index of each stored
    point's supercell in the concatenation of the classes' supercell axes
    (for the per-row certificate boxes), and ``inv_row``: (n,) int32 row
    of each stored point in the row-major concatenation of every class's
    (Sc * qcap, k) rows, row_off + supercell * qcap + slot (the gather
    epilogue's map, built only under that epilogue, else None; equal to
    the reference's where its classes lay rows out at the same qcap, i.e.
    off its kernel platforms).

    ``class_of_sc`` / ``row_of_sc`` are (n_sc_global,) int32 host arrays,
    equal to the reference's: the class of each supercell of the grid (-1
    for one that holds no stored point) and its row in that class (0
    where it has none).  External queries bucket through them on the host
    (:func:`query_adaptive`), so one plan serves the self-solve and
    arbitrary query coordinates.  ``cand_table`` (None: rebuilt from the
    grid's supercells) gives a class's host (Sc, side^3) cell table, for
    a plan whose grid is not the whole cubic grid (a slab's window,
    ``parallel/sharded.py``)."""

    classes: Tuple[ClassPlan, ...]
    inv_box: torch.Tensor
    inv_row: Optional[torch.Tensor]
    n_points: int
    class_of_sc: np.ndarray
    row_of_sc: np.ndarray
    cand_table: Optional[Callable[[int], np.ndarray]] = None


def plan_class_specs(counts: np.ndarray, dim: int, cfg: KnnConfig):
    """The host half of :func:`build_adaptive_plan`: (supercell
    coordinates, class specs routed by the launch gate) from the per-cell
    counts."""
    s, k = cfg.supercell, cfg.k
    counts3 = counts.reshape(dim, dim, dim)
    sc = _boxes_grid(-(-dim // s))
    if cfg.ring_radius is not None:
        rmax = max(1, int(cfg.ring_radius))
        radii = np.full((sc.shape[0],), rmax, np.int32)
        pts_cum, _ = ring_occupancy(counts3, sc, s, rmax)
    else:
        rmax = int(min(dim, max(6, 2 * default_ring_radius(k, cfg.density))))
        pts_cum, cells_cum = ring_occupancy(counts3, sc, s, rmax)
        radii = select_radii(pts_cum, cells_cum, k, rmax)
    return sc, build_class_specs(pts_cum[:, 0], pts_cum, radii, cfg)


def class_blocked_m(cfg: KnnConfig, ccap: int, k: int | None = None) -> int:
    """The blocked kernel's m for a class of candidate capacity ``ccap``
    launched at ``k`` (default ``cfg.k``; an external query may ask for
    fewer), or 0 when the class runs the one-stage kernel."""
    k = cfg.k if k is None else k
    if resolve_kernel(cfg.effective_kernel(), k, ccap) == "blocked":
        return blocked_topm(k, ccap)
    return 0


def stream_tile(ccap: int) -> int:
    """Candidate slots per tile of a streamed class: ``STREAM_TILE``, or
    ccap (a multiple of 128) when narrower."""
    return min(STREAM_TILE, ccap)


def streamed_rows_chunk(n_sc: int, qcap: int, tile: int) -> int:
    """Supercells per step of :func:`streamed_topk`: the (rows, qcap, tile)
    f32 distance tile stays within 64 MB, as in the reference."""
    return max(1, min(n_sc, _STREAM_TILE_BYTES // (qcap * tile * 4)))


def stream_step_bytes(rows: int, qcap: int, ccap: int, k: int) -> int:
    """Device bytes one step of :func:`streamed_topk` over ``rows``
    supercells allocates at its peak: ``_STEP_SLOT_BYTES`` per (query
    slot, tile + k slot) for the distances, mask, keys and the merge, and
    ``_STEP_PACK_BYTES`` per candidate slot of the step's pack."""
    tile = stream_tile(ccap)
    c_pad = -(-ccap // tile) * tile
    return rows * (_STEP_SLOT_BYTES * qcap * (tile + k)
                   + _STEP_PACK_BYTES * c_pad)


def stream_table_bytes(n_sc: int, qcap: int, side: int) -> int:
    """Device bytes a streamed class holds through a solve: its query-slot
    ids and forward row map (Sc, qcap), its (Sc, side^3) cell table, and
    ``_SLOT_SOLVE_BYTES`` per query slot at solve time."""
    return n_sc * (8 * qcap + 4 * side ** 3 + _SLOT_SOLVE_BYTES * qcap)


def class_step_bytes(rows: int, qcap: int, ccap: int) -> int:
    """Device bytes one step of :func:`grid_class_topk` over ``rows``
    supercells allocates at its peak: ``_CLASS_PAIR_BYTES`` per (query
    slot, candidate slot) pair and ``_CLASS_CAND_BYTES`` per candidate
    slot of its pack."""
    return rows * ccap * (_CLASS_PAIR_BYTES * qcap + _CLASS_CAND_BYTES)


def step_bytes(sp: ClassSpec, k: int) -> int:
    """One supercell's step of a class that does not take the kernel
    route: its MXU scorer's step on an 'mxu' class, else its streamed
    step."""
    if sp.route == "mxu":
        return class_step_bytes(1, sp.qcap, sp.ccap)
    return stream_step_bytes(1, sp.qcap, sp.ccap, k)


def table_bytes(sp: ClassSpec, cfg: KnnConfig) -> int:
    """A class's tables without kernel packs: the streamed route's, and an
    'mxu' class's (Sc, s^3) cell table of its own supercells too."""
    own = 4 * sp.rows.size * cfg.supercell ** 3 if sp.route == "mxu" else 0
    return own + stream_table_bytes(sp.rows.size, sp.qcap,
                                    cfg.supercell + 2 * sp.radius)


def kernel_extra_bytes(sp: ClassSpec, cfg: KnnConfig) -> int:
    """What a class's kernel packs take beyond its streamed tables."""
    return (pack_bytes(sp.rows.size, sp.qcap, sp.ccap)
            - stream_table_bytes(sp.rows.size, sp.qcap,
                                 cfg.supercell + 2 * sp.radius))


def gather_bytes(specs, k: int) -> int:
    """Device bytes the gather epilogue adds: every class's (Sc * qcap, k)
    rows three times over (a kernel class's raw output, its row-major
    copy, the concatenation)."""
    return 3 * 8 * k * sum(sp.rows.size * sp.qcap for sp in specs)


def streamed_plan_bytes(specs, cfg: KnnConfig, n: int) -> int:
    """Device bytes of the plan with every class one supercell a step, the
    'mxu' classes on their route and every other class streamed: the
    (n + 1, k) outputs and the per-point supercell map, every class's
    tables (:func:`table_bytes`), the largest one-supercell step
    (:func:`step_bytes`), and under the gather epilogue its per-point row
    map and :func:`gather_bytes`."""
    gather = (n * 4 + gather_bytes(specs, cfg.k)
              if cfg.resolved_epilogue() == "gather" else 0)
    return ((n + 1) * cfg.k * 8 + n * 4 + gather
            + sum(table_bytes(sp, cfg) for sp in specs)
            + max(step_bytes(sp, cfg.k) for sp in specs))


def _preflight(specs, cfg: KnnConfig, n: int, budget: int | None):
    """Route the classes against the memory ``budget`` (None: unbounded)
    before anything is allocated, and refuse only a plan that no route
    can hold: one whose classes, one supercell a step (the 'mxu' classes
    on their route, the rest streamed), do not fit
    (:func:`streamed_plan_bytes`).  From what that plan leaves, each
    class the launch gate takes keeps the kernel route, in order, while
    its packs still fit; the rest stream, and an 'mxu' class keeps its
    route.  Returns (the routed specs, each class's supercells a step:
    None on the kernel route, else what its step may take of the budget
    left, at most :func:`streamed_rows_chunk`'s or, on an 'mxu' class,
    ``class_rows_chunk``'s)."""
    k = cfg.k

    def rows_chunk(sp, left):
        if sp.route == "mxu":
            rows = class_rows_chunk(sp.rows.size, sp.qcap, sp.ccap)
        else:
            rows = streamed_rows_chunk(sp.rows.size, sp.qcap,
                                       stream_tile(sp.ccap))
        if left is not None:
            rows = min(rows, left // step_bytes(sp, k))
        return rows

    if budget is None:
        return specs, [None if sp.route == "kernel" else rows_chunk(sp, None)
                       for sp in specs]
    need = streamed_plan_bytes(specs, cfg, n)
    if need > budget:
        raise LaunchBudgetError(
            f"adaptive plan: with every class streamed one supercell a "
            f"step, the (n, k) outputs, the classes' tables and one step "
            f"need {need} bytes, above the {budget}-byte budget (a fraction "
            f"of the device's free memory): no route can hold the problem; "
            f"shard it or lower k",
            requested=need, budget=budget, site="build_adaptive_plan")
    left = budget - need
    routed = []
    for sp in specs:
        if sp.route == "kernel":
            extra = kernel_extra_bytes(sp, cfg)
            if extra <= left:
                left -= max(extra, 0)
            else:
                sp = dataclasses.replace(sp, route="streamed")
        routed.append(sp)
    # classes run one after another: each step may take what is left and
    # the one-supercell step reserved for the largest
    step = max(step_bytes(sp, k) for sp in specs)
    return routed, [None if sp.route == "kernel" else
                    rows_chunk(sp, left + step) for sp in routed]


def build_adaptive_plan(grid: GridHash, cfg: KnnConfig,
                        cell_counts_host: np.ndarray | None = None
                        ) -> AdaptivePlan:
    """Host planning, then the per-class packs and the slot-partition
    inversion on the grid's device."""
    dim, s, k = grid.dim, cfg.supercell, cfg.k
    device = grid.device
    counts = (np.asarray(cell_counts_host) if cell_counts_host is not None
              else grid.cell_counts.cpu().numpy())
    sc, specs = plan_class_specs(counts, dim, cfg)
    specs, step_rows = _preflight(specs, cfg, grid.n_points,
                                  hbm_budget_bytes(device, cfg))

    w = grid.domain / dim
    classes = []
    class_of = np.full((sc.shape[0],), -1, np.int32)
    row_of = np.zeros((sc.shape[0],), np.int32)
    for ci, (spec, rows) in enumerate(zip(specs, step_rows)):
        class_of[spec.rows] = ci
        row_of[spec.rows] = np.arange(spec.rows.size, dtype=np.int32)
        sc_c = sc[spec.rows]
        own = torch.as_tensor(_box_cell_ids(sc_c, 0, 0, s, dim),
                              device=device)
        cand = torch.as_tensor(
            _box_cell_ids(sc_c, -spec.radius, spec.radius, s, dim),
            device=device)
        lo = ((sc_c * s - spec.radius) * w).astype(np.float32)
        hi = ((sc_c * s + s + spec.radius) * w).astype(np.float32)
        pk = None
        if spec.route == "kernel":
            pk = pack_inputs(grid.points, grid.cell_starts,
                             grid.cell_counts, own, cand, spec.qcap,
                             spec.ccap)
            qid, cand = pk.qid, None
        else:
            q_idx, q_ok = pack_cells(own, grid.cell_starts, grid.cell_counts,
                                     spec.qcap)
            qid = torch.where(q_ok, q_idx, _PAD_Q).to(torch.int32)
        classes.append(ClassPlan(
            lo=torch.as_tensor(lo, device=device),
            hi=torch.as_tensor(hi, device=device), radius=spec.radius,
            qcap=spec.qcap, ccap=spec.ccap, route=spec.route, qid=qid,
            pk=pk, cand=cand, step_rows=rows, tgt=None,
            own=own if spec.route == "mxu" else None))

    inv_box, inv_row, tgts = _invert_partition(
        classes, grid.n_points, device, cfg.resolved_epilogue() == "gather")
    classes = [dataclasses.replace(cp, tgt=t)
               for cp, t in zip(classes, tgts)]
    return AdaptivePlan(classes=tuple(classes), inv_box=inv_box,
                        inv_row=inv_row, n_points=grid.n_points,
                        class_of_sc=class_of, row_of_sc=row_of)


def _class_inverse_update(inv_box: torch.Tensor,
                          inv_row: Optional[torch.Tensor], cp: ClassPlan,
                          sentinel: int, row_off: int, box_off: int):
    """Scatter one class into the per-point supercell and row maps and
    return the class's forward row map ``tgt`` (slot -> stored point,
    ``sentinel`` on pad slots).  All three come from the packed query ids,
    so they cannot drift apart from the kernel's input.  ``inv_box`` and
    ``inv_row`` (None: not kept) have one spare slot at index ``sentinel``
    that absorbs pad writes."""
    qid = cp.qid
    safe = torch.where(qid >= 0, qid, sentinel).long().reshape(-1)
    rows = torch.arange(cp.n_sc, dtype=torch.int32,
                        device=qid.device)[:, None].expand(qid.shape)
    inv_box[safe] = (box_off + rows).reshape(-1)
    end = row_off + cp.n_sc * cp.qcap
    # past int32 row indexing a wrapped index would place wrong-yet-
    # certifiable rows; refuse loudly
    if end > 2**31 - 1:
        raise ValueError(
            f"solver output exceeds int32 row indexing ({end} rows): "
            f"shard the problem")
    if inv_row is not None:
        inv_row[safe] = torch.arange(row_off, end, dtype=torch.int32,
                                     device=qid.device)
    return end, box_off + cp.n_sc, safe.to(torch.int32)


def _invert_partition(classes, n: int, device: torch.device,
                      with_rows: bool):
    """Prepare-time inversion: (inv_box, inv_row -- None without
    ``with_rows`` --, per-class forward row maps)."""
    inv_box = torch.zeros((n + 1,), dtype=torch.int32, device=device)
    inv_row = (torch.zeros((n + 1,), dtype=torch.int32, device=device)
               if with_rows else None)
    row_off = box_off = 0
    tgts = []
    for cp in classes:
        row_off, box_off, tgt = _class_inverse_update(
            inv_box, inv_row, cp, n, row_off, box_off)
        tgts.append(tgt)
    return (inv_box[:n], None if inv_row is None else inv_row[:n],
            tuple(tgts))


def streamed_topk(points: torch.Tensor, starts: torch.Tensor,
                  counts: torch.Tensor, cand_cells: torch.Tensor,
                  q: torch.Tensor, q_ok: torch.Tensor, q_excl: torch.Tensor,
                  k: int, ccap: int, tile: int = STREAM_TILE,
                  rows_chunk: Optional[int] = None,
                  tgt: Optional[torch.Tensor] = None,
                  out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Memory-bounded candidate streaming through ``merge_topk``: the
    counterpart of the reference's ``_streamed_topk``
    (``cuda_knearests_tpu/ops/adaptive.py:494-556``), in plain torch.

    q: (Sc, qcap, 3) query coordinates; q_ok their validity; q_excl
    (Sc, qcap) the stored index each slot excludes (-2: none).
    ``cand_cells`` (Sc, M) are each supercell's candidate cells (-1 pad),
    packed by ``pack_cells`` at ceil(ccap / tile) tiles.  Supercells run
    ``rows_chunk`` a step (default :func:`streamed_rows_chunk`: the
    (rows, qcap, tile) distance tile stays within 64 MB whatever ccap is).
    d2 is summed x, y, z with every op rounded on its own
    (``sum_sq_diff``), pads and the excluded index are masked, and each
    tile folds into the running top-k on int64 (d2, id) keys.  Without
    ``tgt``, returns new (Sc * qcap, k) d2 and ids, ascending, missing
    entries (inf, -1).  With ``tgt`` ((Sc * qcap,) destination rows) and
    ``out`` ((rows, k) f32 d2, int32 ids), each step's slots are copied
    into ``out`` at their destinations instead; returns ``out``."""
    n_sc, qcap = q.shape[0], q.shape[1]
    c_pad = -(-int(ccap) // tile) * tile
    if rows_chunk is None:
        rows_chunk = streamed_rows_chunk(n_sc, qcap, tile)
    if tgt is None:
        out = (torch.empty((n_sc * qcap, k), dtype=torch.float32,
                           device=q.device),
               torch.empty((n_sc * qcap, k), dtype=torch.int32,
                           device=q.device))
        tgt = torch.arange(n_sc * qcap, device=q.device)
    for r0 in range(0, n_sc, rows_chunk):
        rs = slice(r0, r0 + rows_chunk)
        c_idx, c_ok = pack_cells(cand_cells[rs], starts, counts, c_pad)
        q_c, qo, qe = q[rs], q_ok[rs], q_excl[rs]
        best = init_topk(qo.shape, k, device=q.device)
        for t0 in range(0, c_pad, tile):
            ci, co = c_idx[:, t0:t0 + tile], c_ok[:, t0:t0 + tile]
            c = points[ci.long()]                       # (rows, tile, 3)
            d2 = sum_sq_diff(q_c, c)                    # (rows, qcap, tile)
            mask = (qo[:, :, None] & co[:, None, :]
                    & (ci[:, None, :] != qe[:, :, None]))
            best = merge_topk(best, pack_key(
                d2, ci[:, None, :].expand(d2.shape), mask))
        d, i = unpack_key(best)
        dst = tgt[r0 * qcap:(r0 + q_c.shape[0]) * qcap].long()
        out[0].index_copy_(0, dst, d.reshape(-1, k))
        out[1].index_copy_(0, dst, i.reshape(-1, k))
    return out


def launch_kernel_class(cfg: KnnConfig, ccap: int, pk: ClassPack,
                        tgt: Optional[torch.Tensor], k: int,
                        exclude_self: bool,
                        out: Optional[Tuple[torch.Tensor, torch.Tensor]]):
    """One 'kernel' class's launch: ``blocked_topk`` where the class of
    candidate capacity ``ccap`` runs the blocked kernel at ``k``
    (:func:`class_blocked_m`), else ``supercell_topk``; in mode (a) into
    ``out`` through the forward map ``tgt``, or without them in mode (b).
    Returns the kernel's output."""
    return launch_class(pk, k, class_blocked_m(cfg, ccap, k), exclude_self,
                        tgt, out)


def _streamed_class(grid: GridHash, cp: ClassPlan, k: int,
                    exclude_self: bool, out=None):
    """One streamed class, ``cp.step_rows`` supercells a step: with
    ``out``, the (n + 1, k) buffers, its rows scattered through the
    class's forward map (pad slots land in the spare row n); without,
    returned as new (Sc * qcap, k) rows."""
    q_ok = cp.qid >= 0
    q = grid.points[torch.where(q_ok, cp.qid, 0).long()]
    q_excl = cp.qid if exclude_self else torch.full_like(cp.qid, -2)
    return streamed_topk(grid.points, grid.cell_starts, grid.cell_counts,
                         cp.cand, q, q_ok, q_excl, k, cp.ccap,
                         stream_tile(cp.ccap), cp.step_rows,
                         tgt=None if out is None else cp.tgt, out=out)


def _mxu_class(grid: GridHash, cfg: KnnConfig, cp: ClassPlan, out=None):
    """One 'mxu' class through ``grid_class_topk``, ``cp.step_rows``
    supercells a step, into ``out`` as :func:`_streamed_class` does, or
    returned as new rows."""
    return grid_class_topk(grid.points, grid.cell_starts, grid.cell_counts,
                           cp.own, cp.cand, cp.qcap, cfg.k, cp.ccap,
                           cfg.exclude_self, float(cfg.recall_target),
                           cfg.resolved_precision(), cp.step_rows,
                           tgt=None if out is None else cp.tgt, out=out)


def class_rows(grid: GridHash, cfg: KnnConfig, classes):
    """Every class's rows as a row-major (Sc * qcap, k) block -- a kernel
    class's mode (b) output transposed, a streamed or 'mxu' class's rows
    as they come -- concatenated in class order: the rows the gather
    epilogue reads."""
    k = cfg.k
    blocks = []
    for cp in classes:
        if cp.route == "streamed":
            blocks.append(_streamed_class(grid, cp, k, cfg.exclude_self))
        elif cp.route == "mxu":
            blocks.append(_mxu_class(grid, cfg, cp))
        else:
            raw = launch_kernel_class(cfg, cp.ccap, cp.pk, None, k,
                                      cfg.exclude_self, None)
            blocks.append(tuple(a.transpose(1, 2).reshape(-1, k)
                                for a in raw))
    return (torch.cat([b[0] for b in blocks]),
            torch.cat([b[1] for b in blocks]))


def _gather_classes(grid: GridHash, cfg: KnnConfig, plan: AdaptivePlan):
    """The gather epilogue: :func:`class_rows`, and the (n, k) rows read
    by one gather through ``plan.inv_row``."""
    all_d, all_i = class_rows(grid, cfg, plan.classes)
    idx = plan.inv_row.long()
    return all_d[idx], all_i[idx]


def scatter_rows(grid: GridHash, cfg: KnnConfig, classes, n: int):
    """The scatter epilogue: new (n, k) d2 and ids, (inf, -1) where no
    slot writes, each class's rows placed through its forward map -- a
    kernel class by its mode (a) launch, which skips slots mapped outside
    [0, n); a streamed or 'mxu' class into buffers with one spare row n
    that absorbs its pad slots."""
    k = cfg.k
    buf_d = torch.full((n + 1, k), float("inf"), dtype=torch.float32,
                       device=grid.device)
    buf_i = torch.full((n + 1, k), INVALID_ID, dtype=torch.int32,
                       device=grid.device)
    out = (buf_d[:n], buf_i[:n])
    for cp in classes:
        if cp.route == "streamed":
            _streamed_class(grid, cp, k, cfg.exclude_self, (buf_d, buf_i))
        elif cp.route == "mxu":
            _mxu_class(grid, cfg, cp, (buf_d, buf_i))
        else:
            launch_kernel_class(cfg, cp.ccap, cp.pk, cp.tgt, k,
                                cfg.exclude_self, out)
    return out


def solve_adaptive(grid: GridHash, cfg: KnnConfig,
                   plan: AdaptivePlan | None = None) -> KnnResult:
    """All-points kNN over the class schedule, by ``cfg.resolved_epilogue()``:
    'scatter', one kernel launch per 'kernel' class (rows land in their
    final place), :func:`streamed_topk` per 'streamed' class and
    ``grid_class_topk`` per 'mxu' class (rows scattered through its
    forward map); 'gather', :func:`_gather_classes`.  Then the
    certificate of every row from its raw k-th distance -- a blocked
    deficit row's or an uncertified 'mxu' row's NaN there fails it (NaN <=
    margin is false) -- and non-finite entries become (inf, -1).  Results
    stay on the device, in sorted indexing; uncertified rows are left for
    the api's exact fallback."""
    if plan is None:
        plan = build_adaptive_plan(grid, cfg)
    k = cfg.k
    # named profiler scope: the class launches show as one labelled region
    # in torch.profiler traces; the span carries the phase into the
    # kntpu-trace timeline
    with _spans.span("solve.adaptive.launch", n=plan.n_points,
                     classes=len(plan.classes)), \
            annotate("kntpu:adaptive-solve"):
        if cfg.resolved_epilogue() == "gather":
            out_d, out_i = _gather_classes(grid, cfg, plan)
        else:
            out_d, out_i = scatter_rows(grid, cfg, plan.classes,
                                        plan.n_points)
    lo = torch.cat([cp.lo for cp in plan.classes])[plan.inv_box.long()]
    hi = torch.cat([cp.hi for cp in plan.classes])[plan.inv_box.long()]
    cert = out_d[:, k - 1] <= _margin_sq(grid.points, lo, hi, grid.domain)
    ok = torch.isfinite(out_d)
    return KnnResult(neighbors=torch.where(ok, out_i, INVALID_ID),
                     dists_sq=torch.where(ok, out_d, float("inf")),
                     certified=cert,
                     uncert_count=(~cert).sum().to(torch.int32))


# -- external queries through the class schedule ------------------------------

# Device bytes of one slot of a class's query pack on the kernel route: its
# three coordinates, its (pad) id and its destination row.
_QUERY_SLOT_BYTES = 20


@dataclasses.dataclass(frozen=True)
class QueryBucket:
    """Host plan of one class's external queries (:func:`plan_queries`).

    ``src`` are the queries' indices in the call, stably sorted by their
    supercell row in class ``cls``; ``slot`` is each one's flat slot, row *
    ``q2cap`` + rank, in the class's (Sc, q2cap) query pack; ``starts``
    (Sc + 1,) where each row's queries begin in ``src``.  ``route`` is
    'kernel' (one launch over the whole pack) or 'streamed'
    (:func:`streamed_topk`, ``step_rows`` supercells a step)."""

    cls: int
    src: np.ndarray
    slot: np.ndarray
    starts: np.ndarray
    n_sc: int
    q2cap: int
    route: str
    step_rows: Optional[int]

    @property
    def pack_bytes(self) -> int:
        """Device bytes of the kernel route's query pack (the streamed
        route builds one step's slots at a time)."""
        return _QUERY_SLOT_BYTES * self.n_sc * self.q2cap


def bucket_queries(grid: GridHash, cfg: KnnConfig, plan: AdaptivePlan,
                   queries: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host bucketing of (m, 3) float32 queries: each query's class (-1
    where its supercell holds no stored point) and its row in that class,
    from the grid cells :func:`gridhash.cell_coords_host` gives."""
    scc = cell_coords_host(queries, grid.dim, grid.domain) // cfg.supercell
    n_sc = -(-grid.dim // cfg.supercell)
    # int64: n_sc^3 passes int32 at dim / supercell ~ 1,290
    sid = (scc[:, 0].astype(np.int64) + n_sc * (scc[:, 1].astype(np.int64)
           + n_sc * scc[:, 2].astype(np.int64)))
    return plan.class_of_sc[sid], plan.row_of_sc[sid]


def query_step_rows(cp: ClassPlan, q2cap: int, k: int, n_class: int,
                    m: int, side: int, budget: int | None) -> int:
    """Supercells a step of one class's streamed queries: at most
    :func:`streamed_rows_chunk`'s, and within what the memory ``budget``
    leaves after the call's (m + 1, k) outputs, the class's staged query
    indices and, for a kernel class, the cell table built for the call.
    Each step holds its slots (``_SLOT_SOLVE_BYTES`` each) and
    :func:`stream_step_bytes`.  Raises :class:`LaunchBudgetError` when not
    even one supercell a step fits."""
    rows = streamed_rows_chunk(cp.n_sc, q2cap, stream_tile(cp.ccap))
    if budget is None:
        return rows
    fixed = ((m + 1) * k * 8 + 16 * n_class
             + (0 if cp.cand is not None else 4 * cp.n_sc * side ** 3))
    per_row = (stream_step_bytes(1, q2cap, cp.ccap, k)
               + _SLOT_SOLVE_BYTES * q2cap)
    if budget - fixed < per_row:
        raise LaunchBudgetError(
            f"external query: a class's outputs and one streamed supercell "
            f"of {q2cap} query slots need {fixed + per_row} bytes, above the "
            f"{budget}-byte budget (a fraction of the device's free "
            f"memory); reduce the query batch",
            requested=fixed + per_row, budget=budget, site="query_adaptive")
    return min(rows, (budget - fixed) // per_row)


def plan_queries(cfg: KnnConfig, plan: AdaptivePlan, qcls: np.ndarray,
                 qrow: np.ndarray, k: int, budget: int | None
                 ) -> Tuple[QueryBucket, ...]:
    """Host plan of an external-query call: per class with queries, their
    row-major order and slots, and the padded per-supercell capacity
    ``q2cap`` -- a multiple of 128 on the kernel route, a power of two >= 8
    on the streamed route, as the reference sizes them.  A kernel class
    keeps the kernel when its query pack (``_QUERY_SLOT_BYTES`` a slot) and
    the call's (m + 1, k) outputs fit the memory ``budget`` (None:
    unbounded); otherwise its queries stream."""
    m = qcls.shape[0]
    buckets = []
    for ci, cp in enumerate(plan.classes):
        sel = np.nonzero(qcls == ci)[0]
        if sel.size == 0:
            continue
        rows = qrow[sel]
        # numpy sorts 16-bit keys stably by radix sort, in linear time
        order = np.argsort(rows.astype(np.uint16) if cp.n_sc <= 1 << 16
                           else rows, kind="stable")
        rows = rows[order]
        counts = np.bincount(rows, minlength=cp.n_sc)
        starts = np.concatenate([[0], np.cumsum(counts)])
        rank = np.arange(sel.size, dtype=np.int64) - starts[rows]
        max_q = int(counts.max())
        q2cap = -(-max_q // 128) * 128
        route = cp.route
        # an 'mxu' class keeps no candidate pack: its queries take the
        # class's exact route, the kernel on a pack built for the call
        cand_pack = 0
        if route == "mxu":
            route = class_route(cfg, cp.qcap, cp.ccap)
            cand_pack = pack_bytes(cp.n_sc, cp.qcap, cp.ccap)
        if (route == "kernel" and budget is not None
                and (_QUERY_SLOT_BYTES * cp.n_sc * q2cap + cand_pack
                     + (m + 1) * k * 8) > budget):
            route = "streamed"
        step = None
        if route == "streamed":
            q2cap = 1 << max(3, (max_q - 1).bit_length())
            step = query_step_rows(cp, q2cap, k, sel.size, m,
                                   cfg.supercell + 2 * cp.radius, budget)
        elif cp.n_sc * q2cap > 2**31 - 1:
            # a wrapped int32 slot index would place wrong-yet-certifiable
            # rows
            raise ValueError(
                f"query pack exceeds int32 slot indexing ({cp.n_sc} "
                f"supercells x {q2cap} slots); reduce the query batch")
        buckets.append(QueryBucket(
            cls=ci, src=sel[order].astype(np.int32),
            slot=rows.astype(np.int64) * q2cap + rank, starts=starts,
            n_sc=cp.n_sc, q2cap=q2cap, route=route, step_rows=step))
    return tuple(buckets)


def query_pack(queries: torch.Tensor, cp: ClassPlan, b: QueryBucket,
               m: int) -> Tuple[ClassPack, torch.Tensor]:
    """The kernel route's inputs for one class's queries: per-axis (Sc,
    q2cap) query coordinates (zero on pad slots), ``qid`` all ``_PAD_Q``
    (an external query excludes nothing), beside the class's own packed
    candidates, and the forward map ``tgt``: each slot's row in the call's
    (m, k) outputs, ``m`` on pad slots, which mode (a) skips."""
    pk = cp.pk
    if tuple(pk.cx.shape) != (cp.n_sc, cp.ccap):
        raise ValueError(
            f"ClassPack/plan mismatch: candidate pack {tuple(pk.cx.shape)} "
            f"vs plan (n_sc={cp.n_sc}, ccap={cp.ccap}); was this plan built "
            f"against a different grid?")
    device = queries.device
    src = dispatch.stage(b.src, device)
    slot = dispatch.stage(b.slot, device)
    q = queries[src.long()]
    axes = []
    for ax in range(3):
        a = torch.zeros((b.n_sc * b.q2cap,), dtype=torch.float32,
                        device=device)
        a[slot] = q[:, ax]
        axes.append(a.view(b.n_sc, b.q2cap))
    qid = torch.full((b.n_sc, b.q2cap), _PAD_Q, dtype=torch.int32,
                     device=device)
    tgt = torch.full((b.n_sc * b.q2cap,), m, dtype=torch.int32,
                     device=device)
    tgt[slot] = src
    return ClassPack(*axes, qid, pk.cx, pk.cy, pk.cz, pk.cid), tgt


def _streamed_query_class(grid: GridHash, plan: AdaptivePlan,
                          b: QueryBucket, queries: torch.Tensor, k: int,
                          supercell: int, buf_d: torch.Tensor,
                          buf_i: torch.Tensor) -> None:
    """One class's queries through :func:`streamed_topk`, ``b.step_rows``
    supercells a step, each step's query slots built from the staged
    queries (steps without a query are skipped); rows land in the (m + 1,
    k) buffers through each step's forward map (pads in the spare row
    m).  A kernel class has no cell table: it is rebuilt from the class's
    supercells, found in the plan's host maps, or taken from the plan's
    ``cand_table``."""
    device = queries.device
    m = buf_d.shape[0] - 1
    cp = plan.classes[b.cls]
    cand = cp.cand
    if cand is None and plan.cand_table is not None:
        cand = torch.as_tensor(plan.cand_table(b.cls), device=device)
    elif cand is None:
        sids = np.nonzero(plan.class_of_sc == b.cls)[0]
        sids = sids[np.argsort(plan.row_of_sc[sids])]
        coords = _boxes_grid(-(-grid.dim // supercell))[sids]
        cand = torch.as_tensor(
            _box_cell_ids(coords, -cp.radius, cp.radius, supercell,
                          grid.dim), device=device)
    src = dispatch.stage(b.src, device)
    slot = dispatch.stage(b.slot, device)
    q2cap, tile = b.q2cap, stream_tile(cp.ccap)
    for r0 in range(0, b.n_sc, b.step_rows):
        r1 = min(r0 + b.step_rows, b.n_sc)
        a, e = int(b.starts[r0]), int(b.starts[r1])
        if a == e:
            continue
        rows = r1 - r0
        s = slot[a:e] - r0 * q2cap
        q = torch.zeros((rows * q2cap, 3), dtype=torch.float32,
                        device=device)
        q[s] = queries[src[a:e].long()]
        q_ok = torch.zeros((rows * q2cap,), dtype=torch.bool, device=device)
        q_ok[s] = True
        tgt = torch.full((rows * q2cap,), m, dtype=torch.int32,
                         device=device)
        tgt[s] = src[a:e]
        streamed_topk(grid.points, grid.cell_starts, grid.cell_counts,
                      cand[r0:r1], q.view(rows, q2cap, 3),
                      q_ok.view(rows, q2cap),
                      torch.full((rows, q2cap), -2, dtype=torch.int32,
                                 device=device),
                      k, cp.ccap, tile, rows, tgt=tgt, out=(buf_d, buf_i))


def query_device(grid: GridHash, cfg: KnnConfig, plan: AdaptivePlan,
                 queries: np.ndarray, qcls: np.ndarray, qrow: np.ndarray,
                 k: int):
    """The device half of :func:`query_adaptive` over queries bucketed on
    the host (``qcls``/``qrow``: each query's class, -1 for none, and its
    row there): every class's launch back to back into (m + 1, k) buffers
    on the grid's device, the certificates, and ids translated through
    ``grid.permutation``.  No readback happens here.  Returns device
    tensors: (m, k) ids, (m, k) d2 and (m,) certified, False where a
    query has no class."""
    m = queries.shape[0]
    device = grid.device
    buckets = plan_queries(cfg, plan, qcls, qrow, k,
                           hbm_budget_bytes(device, cfg))
    q_dev = dispatch.stage(queries, device)
    buf_d = torch.full((m + 1, k), float("inf"), dtype=torch.float32,
                       device=device)
    buf_i = torch.full((m + 1, k), INVALID_ID, dtype=torch.int32,
                       device=device)
    out_d, out_i = buf_d[:m], buf_i[:m]
    for b in buckets:
        cp = plan.classes[b.cls]
        if b.route == "streamed":
            _streamed_query_class(grid, plan, b, q_dev, k, cfg.supercell,
                                  buf_d, buf_i)
            continue
        if cp.pk is None:  # an 'mxu' class
            cp = dataclasses.replace(cp, pk=pack_inputs(
                grid.points, grid.cell_starts, grid.cell_counts, cp.own,
                cp.cand, cp.qcap, cp.ccap))
        pk, tgt = query_pack(q_dev, cp, b, m)
        launch_kernel_class(cfg, cp.ccap, pk, tgt, k, False, (out_d, out_i))
    has = qcls >= 0
    box_off = np.cumsum([0] + [cp.n_sc for cp in plan.classes])[:-1]
    box = dispatch.stage(
        np.where(has, box_off[np.maximum(qcls, 0)] + qrow, 0), device).long()
    lo = torch.cat([cp.lo for cp in plan.classes])[box]
    hi = torch.cat([cp.hi for cp in plan.classes])[box]
    cert = ((out_d[:, k - 1] <= _margin_sq(q_dev, lo, hi, grid.domain))
            & dispatch.stage(has, device))
    ok = torch.isfinite(out_d)
    ids = translate_ids(torch.where(ok, out_i, INVALID_ID), grid.permutation)
    d2 = torch.where(ok, out_d, float("inf"))
    return ids, d2, cert


def query_adaptive(grid: GridHash, cfg: KnnConfig, plan: AdaptivePlan,
                   queries: np.ndarray, k: int, fallback: str = "brute"
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact kNN of arbitrary query coordinates through the plan prepare()
    built: the external-query twin of :func:`solve_adaptive`, counterpart
    of the reference's ``query_adaptive``
    (``cuda_knearests_tpu/ops/adaptive.py:1011-1092``).

    Queries bucket by supercell on the host (:func:`bucket_queries`) and
    inherit their supercell's class: its radius, its candidate pack and
    its route (:func:`plan_queries`).  Every class launches back to back
    into device-resident (m + 1, k) buffers (:func:`query_device`): a
    kernel class in one mode (a) launch of ``supercell_topk`` (or
    ``blocked_topk``) over its query pack, whose forward map places each
    row and skips pads; a streamed class through :func:`streamed_topk`.
    Each row is certified from its raw k-th d2 against its supercell's
    dilated box (a blocked deficit row's NaN fails), then non-finite
    entries become (-1, inf) and ids translate to original indexing on
    the device, and one batched fetch reads ids, d2 and certificates back.
    Queries whose supercell holds no stored point (no class) always
    resolve through :func:`brute_force_by_coords`; uncertified rows do
    too under ``fallback='brute'``, behind one more fetch: at most two
    host round trips.  Returns ((m, k) ids in original indexing,
    ascending; (m, k) d2), in query order."""
    queries = np.ascontiguousarray(queries, np.float32)
    m = queries.shape[0]
    if m == 0:
        return np.empty((0, k), np.int32), np.empty((0, k), np.float32)
    qcls, qrow = bucket_queries(grid, cfg, plan, queries)
    ids, d2, cert = dispatch.fetch(*query_device(grid, cfg, plan, queries,
                                                 qcls, qrow, k))
    need = ~cert if fallback == "brute" else qcls < 0
    if need.any():
        bad = np.nonzero(need)[0]
        b_i, b_d = brute_force_by_coords(
            grid.points, dispatch.stage(queries[bad], grid.device), k,
            ids_map=grid.permutation)
        b_i, b_d = dispatch.fetch(b_i, b_d)
        ids[bad] = b_i
        d2[bad] = b_d
    return ids, d2
