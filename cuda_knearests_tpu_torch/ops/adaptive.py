"""Adaptive supercell capacities: per-supercell radii, capacity classes and
the class-partitioned solve.

Counterpart of ``cuda_knearests_tpu/ops/adaptive.py:56-836``.  At prepare
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
     is inverted into per-class forward row maps (``ClassPlan.tgt``) and a
     per-point supercell map (``AdaptivePlan.inv_box``) for the
     certificate.

A solve is then one kernel launch per class writing rows straight into the
final (n, k) buffers, plus the box-margin certificate of every row.  On
Hopper the kernel streams candidates through shared memory, so no class is
too wide for it: every class takes the kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from ..config import KnnConfig, default_ring_radius
from ..utils.memory import LaunchBudgetError
from .cuda_solve import (ClassPack, hbm_budget_bytes, pack_bytes,
                         pack_inputs, pick_q_tile, supercell_topk)
from .gridhash import GridHash
from .rings import ring_occupancy
from .solve import (KnnResult, _box_cell_ids, _boxes_grid, _margin_sq,
                    _round_up)
from .topk import INVALID_ID


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


def build_class_specs(own_n: np.ndarray, pts_cum: np.ndarray,
                      radii: np.ndarray, cfg: KnnConfig
                      ) -> Tuple[ClassSpec, ...]:
    """Partition nonempty supercells into <= cfg.max_classes classes.

    Grouped by radius, split once at the 90th percentile of candidate count
    when the group maximum exceeds twice it, then the smallest groups merge
    (taking the larger radius) until the class budget holds.  Each class's
    ccap is measured at its final radius, so packing never truncates a
    candidate list."""
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

    def mk(rows: np.ndarray, radius: int) -> ClassSpec:
        qcap = _round_up(int(own_n[rows].max()), 8)
        ccap = _round_up(max(int(cand_at(rows, radius).max()), cfg.k), 128)
        return ClassSpec(rows=rows, radius=radius, qcap=qcap, ccap=ccap)

    return tuple(mk(rows, r) for rows, r in groups)


@dataclasses.dataclass(frozen=True)
class ClassPlan:
    """Device-side schedule of one class.

    ``lo``/``hi`` are the (Sc, 3) f32 dilated-box corners of the
    certificate; ``pk`` the packed kernel inputs; ``tgt`` the (Sc*qcap,)
    int32 forward row map (destination row per slot, ``n`` on pad slots)."""

    lo: torch.Tensor
    hi: torch.Tensor
    radius: int
    qcap: int
    ccap: int
    pk: ClassPack
    tgt: torch.Tensor

    @property
    def n_sc(self) -> int:
        return int(self.pk.qid.shape[0])


@dataclasses.dataclass(frozen=True)
class AdaptivePlan:
    """Class schedules plus ``inv_box``: (n,) int32 index of each stored
    point's supercell in the concatenation of the classes' supercell axes
    (for the per-row certificate boxes)."""

    classes: Tuple[ClassPlan, ...]
    inv_box: torch.Tensor
    n_points: int


def plan_class_specs(counts: np.ndarray, dim: int, cfg: KnnConfig):
    """The host half of :func:`build_adaptive_plan`: (supercell
    coordinates, class specs) from the per-cell counts."""
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


def _preflight(specs, k: int, n: int, device: torch.device) -> None:
    """Refuse a plan whose packs and outputs would not fit the device's
    memory, before anything is allocated (demotion to a streamed route is
    not ported: the plan is refused whole)."""
    budget = hbm_budget_bytes(device)
    if budget is None:
        return
    need = sum(pack_bytes(sp.rows.size, sp.qcap, sp.ccap) for sp in specs)
    need += n * k * 8 + n * 4
    if need > budget:
        raise LaunchBudgetError(
            f"adaptive plan: packed inputs and outputs need {need} bytes, "
            f"above the {budget}-byte budget of {device} (a fraction of its "
            f"free memory); shard the problem or lower config.supercell",
            requested=need, budget=budget, site="build_adaptive_plan")


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
    for spec in specs:
        pick_q_tile(k, spec.qcap)  # refuses a k one block cannot hold
    _preflight(specs, k, grid.n_points, device)

    w = grid.domain / dim
    classes = []
    for spec in specs:
        sc_c = sc[spec.rows]
        own = torch.as_tensor(_box_cell_ids(sc_c, 0, 0, s, dim),
                              device=device)
        cand = torch.as_tensor(
            _box_cell_ids(sc_c, -spec.radius, spec.radius, s, dim),
            device=device)
        lo = ((sc_c * s - spec.radius) * w).astype(np.float32)
        hi = ((sc_c * s + s + spec.radius) * w).astype(np.float32)
        pk = pack_inputs(grid.points, grid.cell_starts, grid.cell_counts,
                         own, cand, spec.qcap, spec.ccap)
        classes.append(ClassPlan(
            lo=torch.as_tensor(lo, device=device),
            hi=torch.as_tensor(hi, device=device), radius=spec.radius,
            qcap=spec.qcap, ccap=spec.ccap, pk=pk, tgt=None))

    inv_box, tgts = _invert_partition(classes, grid.n_points, device)
    classes = [dataclasses.replace(cp, tgt=t)
               for cp, t in zip(classes, tgts)]
    return AdaptivePlan(classes=tuple(classes), inv_box=inv_box,
                        n_points=grid.n_points)


def _class_inverse_update(inv_box: torch.Tensor, cp: ClassPlan,
                          sentinel: int, row_off: int, box_off: int):
    """Scatter one class into the per-point supercell map and return the
    class's forward row map ``tgt`` (slot -> stored point, ``sentinel`` on
    pad slots).  Both directions come from the packed query ids, so they
    cannot drift apart from the kernel's input.  ``inv_box`` has one spare
    slot at index ``sentinel`` that absorbs pad writes."""
    qid = cp.pk.qid
    safe = torch.where(qid >= 0, qid, sentinel).long()
    rows = torch.arange(cp.n_sc, dtype=torch.int32,
                        device=qid.device)[:, None].expand(qid.shape)
    inv_box[safe.reshape(-1)] = (box_off + rows).reshape(-1)
    row_off += cp.n_sc * cp.qcap
    box_off += cp.n_sc
    # past int32 row indexing a wrapped index would place wrong-yet-
    # certifiable rows; refuse loudly
    if row_off > 2**31 - 1:
        raise ValueError(
            f"solver output exceeds int32 row indexing ({row_off} rows): "
            f"shard the problem")
    return row_off, box_off, safe.reshape(-1).to(torch.int32)


def _invert_partition(classes, n: int, device: torch.device):
    """Prepare-time inversion: (inv_box, per-class forward row maps)."""
    inv_box = torch.zeros((n + 1,), dtype=torch.int32, device=device)
    row_off = box_off = 0
    tgts = []
    for cp in classes:
        row_off, box_off, tgt = _class_inverse_update(
            inv_box, cp, n, row_off, box_off)
        tgts.append(tgt)
    return inv_box[:n], tuple(tgts)


def solve_adaptive(grid: GridHash, cfg: KnnConfig,
                   plan: AdaptivePlan | None = None) -> KnnResult:
    """All-points kNN over the class schedule: one kernel launch per class
    (rows land in their final place), then the certificate of every row
    from its raw k-th distance.  Results stay on the device, in sorted
    indexing; uncertified rows are left for the api's exact fallback."""
    if plan is None:
        plan = build_adaptive_plan(grid, cfg)
    n, k = plan.n_points, cfg.k
    device = grid.device
    out_d = torch.full((n, k), float("inf"), dtype=torch.float32,
                       device=device)
    out_i = torch.full((n, k), INVALID_ID, dtype=torch.int32, device=device)
    for cp in plan.classes:
        supercell_topk(*cp.pk.args(), k, cfg.exclude_self, tgt=cp.tgt,
                       out=(out_d, out_i))
    lo = torch.cat([cp.lo for cp in plan.classes])[plan.inv_box.long()]
    hi = torch.cat([cp.hi for cp in plan.classes])[plan.inv_box.long()]
    cert = out_d[:, k - 1] <= _margin_sq(grid.points, lo, hi, grid.domain)
    return KnnResult(neighbors=out_i, dists_sq=out_d, certified=cert,
                     uncert_count=(~cert).sum().to(torch.int32))
