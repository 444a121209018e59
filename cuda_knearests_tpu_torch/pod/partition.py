"""Prepare-time partition of the grid over the chips of a pod: Morton
supercell ranges, the cell directory, each chip's window layout and class
tables.

Counterpart of ``cuda_knearests_tpu/pod/partition.py``, host numpy like
it, with the same tables.  From one global cell histogram it derives

* the **z-order partition**: supercells sorted by Morton code and split
  into ``ndev`` contiguous rank ranges balanced by point population (a
  chip owns every cell of every supercell in its range);
* the **directory**: the (ndev + 1,) Morton-rank bounds, which map a cell
  to its owning chip and route external queries;
* each chip's **window layout**: its own cells' CSR over its bucket (the
  own region, rows [0, pcap)), then every remote cell one of its candidate
  boxes reaches, each at a fixed offset inside its owner's export block,
  which the exchange lands at ``PodMeta.halo_base`` (``halo.py``);
* each chip's **classes** over that window (``ops.adaptive``'s
  ``build_class_specs`` and ``_preflight``, as ``parallel.sharded`` plans
  a slab), as :class:`parallel.sharded.SlabClass` tables whose cells are
  window cell slots, so ``parallel.sharded._chip_ready_state`` takes a
  chip as it takes a slab.

The ring depth ``steps`` is measured: the largest Morton-rank distance
between a chip and the owner of any occupied cell its boxes reach.  The
reference's loops over cells are vectorised here (boolean cell masks and
``searchsorted`` in place of Python sets and dicts); the tables are equal
(``tests/test_torch_pod.py``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..config import DOMAIN_SIZE, KnnConfig, default_ring_radius
from ..ops.adaptive import (ClassSpec, _preflight, build_class_specs,
                            select_radii)
from ..ops.rings import ring_occupancy
from ..ops.solve import _box_cell_ids, _round_up
from ..parallel.sharded import _PAD_XYZ, ChipPlan, SlabClass
from ..utils.memory import LaunchBudgetError


def morton3(coords: np.ndarray) -> np.ndarray:
    """Morton (z-order) codes of (m, 3) integer coords, int64, x-minor
    interleave, 21 bits an axis."""
    c = coords.astype(np.int64)  # kntpu-ok: wide-dtype -- 3x21-bit interleave headroom, host-only
    out = np.zeros(c.shape[0], dtype=np.int64)  # kntpu-ok: wide-dtype -- 3x21-bit interleave headroom, host-only
    for bit in range(21):
        for ax in range(3):
            out |= ((c[:, ax] >> bit) & 1) << (3 * bit + ax)
    return out


@dataclasses.dataclass(frozen=True)
class PodDirectory:
    """The cell -> chip ownership map.

    ``order``: (n_sc,) global supercell id per Morton rank; ``rank_of``:
    (n_sc,) Morton rank per global supercell id; ``bounds``: (ndev + 1,)
    int32, chip d owns ranks [bounds[d], bounds[d + 1])."""

    order: np.ndarray
    rank_of: np.ndarray
    bounds: np.ndarray

    def chip_of_rank(self, rank: np.ndarray) -> np.ndarray:
        return (np.searchsorted(self.bounds, rank, side="right") - 1) \
            .astype(np.int32)

    def chip_of_sc(self, sc_id: np.ndarray) -> np.ndarray:
        return self.chip_of_rank(self.rank_of[sc_id])


@dataclasses.dataclass(frozen=True)
class PodMeta:
    """Static decomposition metadata."""

    ndev: int
    dim: int
    supercell: int
    pcap: int       # per-chip own-point capacity (max population, 8-padded)
    hcap: int       # export-block capacity (max export population, 8-padded)
    steps: int      # measured ring depth (chain steps per direction)
    domain: float

    @property
    def n_ext(self) -> int:
        """Rows of one chip's window: own region, then 2 * steps blocks."""
        return self.pcap + 2 * self.steps * self.hcap

    def halo_base(self, receiver: int, owner: int) -> int:
        """Window row of ``owner``'s export block in ``receiver``'s window:
        owners below at slots 0..steps-1 (nearest first), owners above at
        slots steps..2*steps-1, the order ``halo.exchange`` lands them."""
        if owner < receiver:
            slot = receiver - owner - 1
        else:
            slot = self.steps + (owner - receiver - 1)
        return self.pcap + slot * self.hcap

    def halo_bytes(self) -> int:
        """Bytes the exchange moves: per step and direction, every link of
        the (non-wrapping) chain carries one export block of hcap points
        (12 B) and ids (4 B)."""
        return 32 * self.hcap * self.steps * (self.ndev - 1)


@dataclasses.dataclass
class PodChipPlan:
    """One chip's static schedule: its classes over its window and the
    window's layout.  Cell tables hold window cell slots (-1: off the grid,
    or an empty remote cell)."""

    classes: Tuple[SlabClass, ...]
    class_of: np.ndarray    # (n_sc_local,) class per owned supercell (-1)
    row_of: np.ndarray      # (n_sc_local,) row within the class's tables
    sc_ids: np.ndarray      # (n_sc_local,) global supercell ids, Morton order
    ext_starts: np.ndarray  # (n_ext_cells,) int32 window row of each cell
    ext_counts: np.ndarray  # (n_ext_cells,) int32 points of each cell
    export_idx: np.ndarray  # (hcap,) int32 own rows to export, -1 pad
    export_cells: np.ndarray  # sorted global cell ids behind export_idx
    n_local: int            # real points on this chip
    remote_cells: int       # halo cells this chip's boxes reach
    max_owner_dist: int     # ring distance to the farthest needed owner

    def chip_plan(self) -> ChipPlan:
        """The class schedule as ``parallel.sharded`` consumes it."""
        return ChipPlan(classes=self.classes, class_of=self.class_of,
                        row_of=self.row_of)


@dataclasses.dataclass
class PodPlan:
    """Everything prepare computes on the host before staging.
    ``cloud_specs`` are the classes a single-device plan of the whole
    cloud would take (``stream.full_cloud_model`` sizes them)."""

    meta: PodMeta
    directory: PodDirectory
    chips: List[PodChipPlan]
    bucket_pts: np.ndarray     # (ndev, pcap, 3) f32, pads at _PAD_XYZ
    bucket_ids: np.ndarray     # (ndev, pcap) int32 original index, -1 pad
    chip_of_point: np.ndarray  # (n,) int32 owning chip per original point
    cloud_specs: Tuple[ClassSpec, ...] = ()


def _sc_cells(sc: np.ndarray, s: int, dim: int) -> np.ndarray:
    """(m, s^3) global cell ids of each supercell's own cells, -1 off the
    grid."""
    return _box_cell_ids(sc, 0, 0, s, dim)


def _box_cells(sc: np.ndarray, radius: int, s: int, dim: int) -> np.ndarray:
    """(m, (s + 2r)^3) global cell ids of each supercell's dilated box, -1
    off the grid."""
    return _box_cell_ids(sc, -radius, radius, s, dim)


def build_directory(counts_sc: np.ndarray, sc_coords: np.ndarray,
                    ndev: int) -> PodDirectory:
    """Morton-sort the supercells and split them into ndev contiguous rank
    ranges balanced by point population (a prefix split of the cumulative
    counts; a degenerate cloud may leave trailing chips empty)."""
    codes = morton3(sc_coords)
    order = np.argsort(codes, kind="stable").astype(np.int32)
    rank_of = np.empty_like(order)
    rank_of[order] = np.arange(order.size, dtype=np.int32)
    cum = np.cumsum(counts_sc[order])
    total = int(cum[-1]) if cum.size else 0
    targets = [total * d // ndev for d in range(1, ndev)]
    inner = np.searchsorted(cum, targets, side="left") + 1
    inner = np.minimum(np.maximum.accumulate(inner), order.size)
    bounds = np.concatenate([[0], inner, [order.size]]).astype(np.int32)
    return PodDirectory(order=order, rank_of=rank_of, bounds=bounds)


def _mask_cells(size: int, *cell_arrays: np.ndarray) -> np.ndarray:
    """Sorted unique nonnegative ids of the arrays (a boolean mask over
    [0, size))."""
    mark = np.zeros(size, bool)
    for cells in cell_arrays:
        mark[cells[cells >= 0]] = True
    return np.flatnonzero(mark)


def _refusal(d: int, meta: PodMeta, requested: int, budget: int,
             k: int) -> LaunchBudgetError:
    """The pod's typed refusal: chip ``d`` cannot hold its share."""
    return LaunchBudgetError(
        f"pod-prepare: chip {d}'s modeled footprint {requested} bytes "
        f"(pcap={meta.pcap}, halo={2 * meta.steps}x{meta.hcap}, k={k}) "
        f"exceeds the {budget} byte per-chip HBM budget even after "
        f"cell-range splitting across {meta.ndev} chip(s); use more "
        f"devices, a coarser grid (config.density), or raise "
        f"config.hbm_budget_bytes / KNTPU_HBM_BUDGET_BYTES",
        requested=requested, budget=budget, site="pod-prepare")


def build_pod_plan(points: np.ndarray, ndev: int, cfg: KnnConfig, dim: int,
                   on_kernel_platform: bool,
                   budgets: Optional[Sequence[Optional[int]]] = None
                   ) -> PodPlan:
    """The whole prepare-time decomposition (see the module docstring).

    Off the kernel platforms (``backend='xla'``) every class not routed
    'mxu' streams.  ``budgets`` (per chip, None: unbounded) route each
    chip's classes through ``adaptive._preflight`` against what its budget
    leaves after the chip's window and epilogue
    (``stream.resident_bytes``); a chip whose classes cannot fit even
    streamed raises the pod's typed refusal (``LaunchBudgetError``, site
    'pod-prepare')."""
    from .stream import resident_bytes

    n = points.shape[0]
    s = cfg.supercell
    n_sc_side = -(-dim // s)
    w = DOMAIN_SIZE / dim
    ncell = dim ** 3

    coords = np.clip((points * (dim / DOMAIN_SIZE)).astype(np.int64),  # kntpu-ok: wide-dtype -- dim^2 linearization headroom, host-only
                     0, dim - 1)
    cell_of = coords[:, 0] + dim * coords[:, 1] + dim * dim * coords[:, 2]
    cnt_flat = np.bincount(cell_of, minlength=ncell)
    counts3 = cnt_flat.reshape(dim, dim, dim)
    scc = coords // s
    sc_of = (scc[:, 0] + n_sc_side * scc[:, 1]
             + n_sc_side * n_sc_side * scc[:, 2])
    counts_sc = np.bincount(sc_of, minlength=n_sc_side ** 3)

    r = np.arange(n_sc_side, dtype=np.int32)
    zz, yy, xx = np.meshgrid(r, r, r, indexing="ij")
    sc_all = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], axis=1)

    directory = build_directory(counts_sc, sc_all, ndev)
    chip_of_sc_all = directory.chip_of_rank(directory.rank_of)

    # the global ring occupancy and radii, as the single-device planner
    # reads them, sliced per chip
    if cfg.ring_radius is not None:
        rmax = max(1, int(cfg.ring_radius))
    else:
        rmax = int(min(dim, max(6, 2 * default_ring_radius(cfg.k,
                                                           cfg.density))))
    pts_cum, cells_cum = ring_occupancy(counts3, sc_all, s, rmax)
    if cfg.ring_radius is not None:
        radii_all = np.full((sc_all.shape[0],), rmax, np.int32)
    else:
        radii_all = select_radii(pts_cum, cells_cum, cfg.k, rmax)
    cloud_specs = build_class_specs(counts_sc, pts_cum, radii_all, cfg)

    # owner chip of every cell of the grid (via its supercell)
    cid = np.arange(ncell, dtype=np.int64)  # kntpu-ok: wide-dtype -- cell-id table, host-only
    owner_of_cell = chip_of_sc_all[
        (cid // (dim * dim)) // s * (n_sc_side ** 2)
        + ((cid // dim) % dim) // s * n_sc_side + (cid % dim) // s]
    del cid

    # -- pass A: per-chip supercells, classes, candidate boxes, reach --
    per_chip: List[dict] = []
    needed = np.zeros(ncell, bool)   # cells some other chip's boxes reach
    steps = 0
    for d in range(ndev):
        sc_ids = directory.order[directory.bounds[d]:directory.bounds[d + 1]]
        own_n = counts_sc[sc_ids]
        if own_n.sum() == 0:
            per_chip.append(dict(sc_ids=sc_ids, specs=(), boxes=[],
                                 own_cells=np.empty((0,), np.int64),  # kntpu-ok: wide-dtype -- cell-id table, host-only
                                 reach=np.empty((0,), np.int64)))  # kntpu-ok: wide-dtype -- host index arithmetic, never staged
            continue
        sc_d = sc_all[sc_ids]
        specs = build_class_specs(own_n, pts_cum[sc_ids], radii_all[sc_ids],
                                  cfg)
        if not on_kernel_platform:
            specs = tuple(dataclasses.replace(sp, route="streamed")
                          if sp.route == "kernel" else sp for sp in specs)
        own_tab = _sc_cells(sc_d, s, dim)
        flat = own_tab.reshape(-1)
        boxes = [_box_cells(sc_d[sp.rows], sp.radius, s, dim)
                 for sp in specs]
        # empty cells never ride the exchange: a zero-population cell adds
        # no candidate, so it stays unmapped (-1 in the cand tables)
        reach = _mask_cells(ncell, *boxes)
        reach = reach[cnt_flat[reach] > 0]
        owners = owner_of_cell[reach]
        if reach.size:
            steps = max(steps, int(np.abs(owners.astype(np.int64) - d).max()))  # kntpu-ok: wide-dtype -- host index arithmetic, never staged
        needed[reach[owners != d]] = True
        per_chip.append(dict(sc_ids=sc_ids, specs=specs, boxes=boxes,
                             own_cells=flat[flat >= 0].astype(np.int64),  # kntpu-ok: wide-dtype -- cell-id table, host-only
                             own_tab=own_tab, reach=reach))

    # -- pass B: export blocks, capacities --
    exports, export_pref = [], []
    hmax = 1
    for o in range(ndev):
        cells_o = np.flatnonzero(needed & (owner_of_cell == o))
        cnt_o = cnt_flat[cells_o]
        exports.append(cells_o)
        export_pref.append(np.cumsum(cnt_o) - cnt_o)
        hmax = max(hmax, int(cnt_o.sum()))
    hcap = _round_up(hmax, 8)

    chip_of_point = chip_of_sc_all[sc_of].astype(np.int32)
    pop = np.bincount(chip_of_point, minlength=ndev)
    pcap = _round_up(int(pop.max()) if n else 1, 8)
    meta = PodMeta(ndev=ndev, dim=dim, supercell=s, pcap=pcap, hcap=hcap,
                   steps=steps, domain=DOMAIN_SIZE)

    # -- point buckets in (chip, own-cell slot, original id) order --
    slot_map = np.full(ncell, -1, np.int64)  # kntpu-ok: wide-dtype -- host index arithmetic, never staged
    own_starts_by_chip: List[np.ndarray] = []
    for d in range(ndev):
        oc = per_chip[d]["own_cells"]
        slot_map[oc] = np.arange(oc.size)
        own_starts_by_chip.append(
            (np.cumsum(cnt_flat[oc]) - cnt_flat[oc]).astype(np.int32))
    key = (chip_of_point.astype(np.int64) * (slot_map.max() + 2)  # kntpu-ok: wide-dtype -- host sort-key headroom, never staged
           + slot_map[cell_of])
    order = np.argsort(key, kind="stable")
    del key
    bucket_pts = np.full((ndev, pcap, 3), _PAD_XYZ, np.float32)
    bucket_ids = np.full((ndev, pcap), -1, np.int32)
    starts_pt = np.cumsum(pop) - pop
    for d in range(ndev):
        rows = order[starts_pt[d]: starts_pt[d] + pop[d]]
        bucket_pts[d, : pop[d]] = points[rows]
        bucket_ids[d, : pop[d]] = rows.astype(np.int32)

    # -- pass C: per-chip window layout and class tables --
    slot_map[:] = -1
    chips: List[PodChipPlan] = []
    for d in range(ndev):
        info = per_chip[d]
        oc = info["own_cells"]
        own_starts = own_starts_by_chip[d]
        reach = info["reach"]
        remote_cells = reach[owner_of_cell[reach] != d]
        r_owner = owner_of_cell[remote_cells].astype(np.int64)  # kntpu-ok: wide-dtype -- host index arithmetic, never staged
        r_start = np.zeros(remote_cells.size, np.int64)  # kntpu-ok: wide-dtype -- host index arithmetic, never staged
        for o in np.unique(r_owner):
            sel = r_owner == o
            r_start[sel] = (meta.halo_base(d, int(o)) + export_pref[o][
                np.searchsorted(exports[o], remote_cells[sel])])
        max_dist = (int(np.abs(r_owner - d).max()) if remote_cells.size
                    else 0)

        slot_map[oc] = np.arange(oc.size)
        slot_map[remote_cells] = oc.size + np.arange(remote_cells.size)
        ext_starts = np.concatenate([own_starts, r_start]).astype(np.int32)
        ext_counts = np.concatenate(
            [cnt_flat[oc], cnt_flat[remote_cells]]).astype(np.int32)

        export_idx = np.full((hcap,), -1, np.int32)
        e_cnt = cnt_flat[exports[d]]
        total = int(e_cnt.sum())
        if total:
            e_start = own_starts[slot_map[exports[d]]].astype(np.int64)  # kntpu-ok: wide-dtype -- host index arithmetic, never staged
            export_idx[:total] = (np.repeat(e_start - (np.cumsum(e_cnt)
                                                       - e_cnt), e_cnt)
                                  + np.arange(total))

        specs = info["specs"]
        class_of = np.full((info["sc_ids"].size,), -1, np.int32)
        row_of = np.zeros_like(class_of)
        classes: List[SlabClass] = []
        if specs:
            budget = None if budgets is None else budgets[d]
            resident = resident_bytes(meta, oc.size + remote_cells.size, cfg)
            left = None if budget is None else budget - resident
            if left is not None and left < 0:
                raise _refusal(d, meta, resident, budget, cfg.k)
            try:
                specs, step_rows = _preflight(specs, cfg, pcap, left)
            except LaunchBudgetError as e:
                raise _refusal(d, meta, resident + e.requested, budget,
                               cfg.k) from e
            for ci, (spec, rows) in enumerate(zip(specs, step_rows)):
                class_of[spec.rows] = ci
                row_of[spec.rows] = np.arange(spec.rows.size, dtype=np.int32)
                own_g = info["own_tab"][spec.rows]
                box = info["boxes"][ci]
                gsc = sc_all[info["sc_ids"][spec.rows]]
                classes.append(SlabClass(
                    radius=spec.radius, qcap=spec.qcap, ccap=spec.ccap,
                    route=spec.route,
                    own=np.where(own_g >= 0, slot_map[np.clip(own_g, 0, None)],
                                 -1).astype(np.int32),
                    cand=np.where(box >= 0, slot_map[np.clip(box, 0, None)],
                                  -1).astype(np.int32),
                    lo=((gsc * s - spec.radius) * w).astype(np.float32),
                    hi=((gsc * s + s + spec.radius) * w).astype(np.float32),
                    step_rows=rows))
        slot_map[oc] = -1
        slot_map[remote_cells] = -1

        chips.append(PodChipPlan(
            classes=tuple(classes), class_of=class_of, row_of=row_of,
            sc_ids=info["sc_ids"], ext_starts=ext_starts,
            ext_counts=ext_counts, export_idx=export_idx,
            export_cells=exports[d], n_local=int(pop[d]),
            remote_cells=int(remote_cells.size), max_owner_dist=max_dist))

    return PodPlan(meta=meta, directory=directory, chips=chips,
                   bucket_pts=bucket_pts, bucket_ids=bucket_ids,
                   chip_of_point=chip_of_point, cloud_specs=cloud_specs)


def route_queries(directory: PodDirectory, meta: PodMeta,
                  queries: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(owning chip, local supercell rank) per query, via the directory.
    A query routed to chip d has its whole candidate box inside d's window
    (the window was sized from exactly these boxes), so the single-device
    certificates hold for boundary-straddling queries too."""
    dim, s = meta.dim, meta.supercell
    n_sc_side = -(-dim // s)
    coords = np.clip((queries * (dim / meta.domain)).astype(np.int64),  # kntpu-ok: wide-dtype -- dim^2 linearization headroom, host-only
                     0, dim - 1)
    scc = coords // s
    sc_id = (scc[:, 0] + n_sc_side * scc[:, 1]
             + n_sc_side * n_sc_side * scc[:, 2])
    rank = directory.rank_of[sc_id]
    chip = directory.chip_of_rank(rank)
    local = (rank - directory.bounds[chip]).astype(np.int32)
    return chip, local
