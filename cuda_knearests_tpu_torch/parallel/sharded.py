"""Multi-GPU kNN: z-slabs of the grid over a list of devices, with the halo
exchange between neighbouring slabs.

Counterpart of ``cuda_knearests_tpu/parallel/sharded.py``.  A mesh is a
list of slabs (:class:`Slab`), each bound to a torch device on the process
that owns it; several slabs may share one device.  That is the port's form
of the reference's emulated mesh: four slabs on one card, or on the CPU in
the tests.  Three phases, as in the reference:

  1. **host partition** (numpy): each point's z-cell picks its slab, and
     points bucket per slab, padded to the fullest slab
     (:func:`_partition_host`);
  2. **per-slab build and halo exchange**: each slab sorts its bucket on
     its device by local cell id (a stable sort, pads last), counts its
     cells with a scatter-add, cuts its bottom and top blocks of R layers
     and hands them to its neighbours (:func:`_build_slab`,
     :func:`_exchange`): a copy to the neighbour's device within one
     process (a peer copy between cards, a plain copy on one card), and
     ``torch.distributed`` point-to-point at a process seam
     (:mod:`.distributed`);
  3. **per-slab plan and solve**: each slab plans its capacity classes from
     the occupancy of its halo-extended window (:func:`_plan_chip`) and
     solves them with the class kernels of the single-device route over
     that window (:func:`_chip_solve`).

The halo depth is the largest dilation radius any nonempty supercell
selects, so every candidate box lies inside its slab's window and the
certificates hold as on one device; uncertified rows are resolved exactly
by the host kd-tree (``oracle.KdTreeOracle``).  Window indices follow the
global sorted order (z-major cells, original index within a cell), so ties
go to the same neighbour as in a single-device solve, and certified rows
equal it bit for bit.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DOMAIN_SIZE, KnnConfig, default_ring_radius, grid_dim_for
from ..io import validate_or_raise
from ..obs import spans as _spans
from ..ops.adaptive import (AdaptivePlan, ClassPlan, _class_inverse_update,
                            _preflight, build_class_specs, class_rows,
                            query_device, scatter_rows, select_radii)
from ..ops.cuda_solve import _PAD_Q, hbm_budget_bytes, pack_inputs
from ..ops.gridhash import GridHash, cell_coords, cell_coords_host
from ..ops.rings import box_sums, ring_occupancy, summed_area_table
from ..ops.solve import _boxes_grid, _margin_sq, _round_up, pack_cells
from ..ops.topk import INVALID_ID, translate_ids
from ..runtime import dispatch
from ..utils.memory import InvalidConfigError, InvalidKError, NoDeviceError
from ..utils.platform import resolve_device
from . import distributed as _dist

# Coordinate of pad rows (bucket pads and the edge slabs' empty halos).
# Pads are never read as points (the CSR never counts them); pad slots of
# a pack gather index 0 of the window, which may be one of them, and the
# MXU class scorer needs finite norms there.  The reference pads at 1e30.
_PAD_XYZ = 0.0


@dataclasses.dataclass(frozen=True)
class Slab:
    """One slab of a mesh: the process that owns it and, on that process,
    the device that holds it (None on the other processes)."""

    process: int
    device: Optional[torch.device]


def _slab_bounds(dim: int, supercell: int, ndev: int
                 ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Supercell-aligned z-cell ranges per slab: [zc0[d], zc1[d])."""
    n_sc_z = -(-dim // supercell)
    layers = -(-n_sc_z // ndev)
    zcap = layers * supercell
    zc0 = np.arange(ndev) * zcap
    zc1 = np.minimum(zc0 + zcap, dim)
    zc1 = np.maximum(zc1, np.minimum(zc0, dim))  # empty slabs: zc1 == zc0
    return zc0, zc1, zcap


@dataclasses.dataclass(frozen=True)
class ShardMeta:
    """Host-side static decomposition metadata."""

    ndev: int
    dim: int
    zcap: int
    radius: int     # halo depth == max per-slab dilation radius
    pcap: int       # per-slab point capacity (max slab population, padded)
    hcap: int       # halo block capacity (max boundary-layer population)
    domain: float


def _measured_halo_depth(points: np.ndarray, dim: int, zcap: int,
                         cfg: KnnConfig) -> int:
    """The largest dilation radius any nonempty supercell will select, from
    global cell occupancy (O(cells) host work).  Each slab's planner later
    derives its radii from the same occupancy boxes (window slices of the
    same counts), so every choice is <= this depth and candidate boxes fit
    the halo-extended window.  Capped at the slab thickness: supercells
    whose sparse neighbourhood wants more stay uncertified and resolve
    through the exact host fallback."""
    s = cfg.supercell
    rmax = min(zcap, int(min(dim, max(6, 2 * default_ring_radius(
        cfg.k, cfg.density)))))
    # int64 coords: the dim^2 linearization below must not wrap
    coords = np.clip((points * (dim / DOMAIN_SIZE)).astype(np.int64),
                     0, dim - 1)
    lin = coords[:, 0] + dim * coords[:, 1] + dim * dim * coords[:, 2]
    counts3 = np.bincount(lin, minlength=dim ** 3).reshape(dim, dim, dim)
    sc = _boxes_grid(-(-dim // s))
    pts_cum, cells_cum = ring_occupancy(counts3, sc, s, rmax)
    radii = select_radii(pts_cum, cells_cum, cfg.k, rmax)
    nonempty = pts_cum[:, 0] > 0
    return max(1, int(radii[nonempty].max()) if nonempty.any() else rmax)


def _partition_host(points: np.ndarray, dim: int, zcap: int, radius: int,
                    ndev: int, domain: float):
    """Bucket points by owning slab (z-cell // zcap), in numpy.  Returns
    (bucket_pts (ndev, pcap, 3) f32, pads at ``_PAD_XYZ``; bucket_ids
    (ndev, pcap) int32 original index, -1 on pads; n_local (ndev,); pcap;
    hcap)."""
    n = points.shape[0]
    cz = np.clip((points[:, 2] * (dim / domain)).astype(np.int32), 0,
                 dim - 1)
    chip = np.minimum(cz // zcap, ndev - 1).astype(np.int32)
    order = np.argsort(chip, kind="stable")
    # int64: slab populations cumsum to n
    counts = np.bincount(chip[order], minlength=ndev).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pcap = _round_up(int(counts.max()) if n else 1, 8)

    bucket_pts = np.full((ndev, pcap, 3), _PAD_XYZ, np.float32)
    bucket_ids = np.full((ndev, pcap), -1, np.int32)
    for d in range(ndev):
        rows = order[starts[d]: starts[d] + counts[d]]
        bucket_pts[d, : counts[d]] = points[rows]
        bucket_ids[d, : counts[d]] = rows.astype(np.int32)

    # halo capacity: the most points in any slab's R bottom or top z-cell
    # layers, from one z-layer histogram
    zhist = np.bincount(cz, minlength=dim)
    hmax = 1
    for d in range(ndev):
        zc0 = d * zcap
        hmax = max(hmax,
                   int(zhist[zc0: zc0 + radius].sum()),
                   int(zhist[max(zc0 + zcap - radius, 0): zc0 + zcap].sum()))
    hcap = _round_up(hmax, 8)
    return bucket_pts, bucket_ids, counts.astype(np.int32), pcap, hcap


_BLOCK = ("pts", "ids", "counts")


def _build_slab(pts: torch.Tensor, ids: torch.Tensor, nloc: int, d: int,
                meta: ShardMeta) -> Dict[str, torch.Tensor]:
    """Slab ``d``'s build on its device (the reference's shard_map program
    without its exchange): its points sorted by local cell id, a stable
    sort with pads last (``spts``, ``sids``), its per-cell counts (a
    scatter-add over the real rows), and its bottom and top blocks of R
    layers (``bot_*``, ``top_*``: hcap points, ids and R*dim^2 counts).
    The sorted array is cell-ascending, so the bottom layers are a prefix
    and the top layers the suffix of the real rows; the suffix is taken
    from the array padded by hcap rows, so it never shifts."""
    dim, zcap, R, hcap = meta.dim, meta.zcap, meta.radius, meta.hcap
    A = dim * dim
    ncell = zcap * A
    device = pts.device
    pcap = pts.shape[0]
    cc = cell_coords(pts, dim, meta.domain)
    lid = cc[:, 0] + dim * cc[:, 1] + A * (cc[:, 2] - d * zcap)
    lid = torch.where(torch.arange(pcap, device=device) < nloc, lid, ncell)
    order = torch.sort(lid, stable=True).indices
    spts, sids = pts[order], ids[order]
    counts = torch.bincount(lid[:nloc], minlength=ncell).to(torch.int32)

    tcount = counts[(zcap - R) * A:].sum()
    spts_ext = torch.cat([spts, torch.full((hcap, 3), _PAD_XYZ,
                                           dtype=spts.dtype, device=device)])
    sids_ext = torch.cat([sids, torch.full((hcap,), -1, dtype=sids.dtype,
                                           device=device)])
    top = (nloc - tcount).clamp(min=0) + torch.arange(hcap, device=device)
    return {"spts": spts, "sids": sids, "counts": counts,
            "bot_pts": spts[:hcap], "bot_ids": sids[:hcap],
            "bot_counts": counts[: R * A],
            "top_pts": spts_ext[top], "top_ids": sids_ext[top],
            "top_counts": counts[(zcap - R) * A:]}


def _edge_block(meta: ShardMeta, device: torch.device):
    """The empty halo of an edge slab: pad points, -1 ids, zero counts
    (zero counts: nothing is ever gathered from it)."""
    return (torch.full((meta.hcap, 3), _PAD_XYZ, dtype=torch.float32,
                       device=device),
            torch.full((meta.hcap,), -1, dtype=torch.int32, device=device),
            torch.zeros((meta.radius * meta.dim ** 2,), dtype=torch.int32,
                        device=device))


def _exchange(built: Dict[int, dict], meta: ShardMeta,
              mesh: Sequence[Slab]) -> Dict[int, dict]:
    """The halo exchange (the reference's ``lax.ppermute`` pair): each
    slab's top block becomes the next slab's lower halo (``lo_*``) and its
    bottom block the previous slab's upper halo (``hi_*``); edge slabs get
    :func:`_edge_block`.  Between slabs of this process a block is copied
    to the neighbour's device without blocking the host; at a process seam
    it crosses by ``distributed.exchange_seams``.  Returns the build
    outputs of every local slab with its halos (the boundary blocks
    dropped)."""
    remote = (_dist.exchange_seams(built, meta, mesh)
              if _dist.world_size() > 1 else {})
    out = {}
    for d, b in built.items():
        device = b["spts"].device

        def take(src: int, side: str):
            if src < 0 or src >= meta.ndev:
                return _edge_block(meta, device)
            if src in built:
                return tuple(built[src][f"{side}_{x}"].to(
                    device, non_blocking=True) for x in _BLOCK)
            return remote[d, side]

        lo, hi = take(d - 1, "top"), take(d + 1, "bot")
        out[d] = {"spts": b["spts"], "sids": b["sids"],
                  "counts": b["counts"],
                  **{f"lo_{x}": t for x, t in zip(_BLOCK, lo)},
                  **{f"hi_{x}": t for x, t in zip(_BLOCK, hi)}}
    return out


def _window_occupancy(win3: np.ndarray, sc: np.ndarray, s: int, R: int,
                      dim: int, zc0: int, rmax: int):
    """Per-supercell cumulative points and in-grid cells over the slab's
    halo-extended window (the z-slab twin of ``rings.ring_occupancy``).

    win3: (2R+zcap, dim, dim) [z,y,x] counts; sc: (m, 3) slab-local
    supercell coords.  Boxes are in window cell coordinates (z offset +R);
    in-grid cell counts clip z against the *global* grid through the
    window mapping zw -> zc0 - R + zw."""
    zwin = win3.shape[0]
    base_lo = sc * s + np.array([0, 0, R])
    base_hi = base_lo + s
    sat = summed_area_table(win3)
    z_valid_lo = max(0, R - zc0)
    z_valid_hi = min(zwin, dim + R - zc0)
    pts = np.empty((sc.shape[0], rmax + 1), np.int64)
    cells = np.empty((sc.shape[0], rmax + 1), np.int64)
    for r in range(rmax + 1):
        lo = base_lo - r
        hi = base_hi + r
        pts[:, r] = box_sums(win3, lo, hi, sat=sat)
        cx = (np.clip(hi[:, 0], 0, dim) - np.clip(lo[:, 0], 0, dim))
        cy = (np.clip(hi[:, 1], 0, dim) - np.clip(lo[:, 1], 0, dim))
        cz = (np.clip(hi[:, 2], z_valid_lo, z_valid_hi)
              - np.clip(lo[:, 2], z_valid_lo, z_valid_hi))
        cells[:, r] = cx * cy * np.maximum(cz, 0)
    return pts, cells


def _window_box_cells(sc: np.ndarray, lo_off: int, hi_off: int, s: int,
                      dim: int, R: int, zc0: int, zwin: int) -> np.ndarray:
    """Linear window-cell ids of [sc*s+lo_off, sc*s+s+hi_off) per
    supercell, -1 outside the grid (x/y) or outside the global z range
    (z).  Window linearization: x + dim*y + dim^2*zw, zw = local z + R."""
    side = s + hi_off - lo_off
    # int64 intermediates: the dim^2 linearization must not wrap before
    # the int32 cast of its result
    offs = np.arange(lo_off, s + hi_off, dtype=np.int64)
    ax = sc[:, :, None].astype(np.int64) * s + offs[None, None, :]
    x, y, z = ax[:, 0], ax[:, 1], ax[:, 2] + R       # z in window coords
    okx = (x >= 0) & (x < dim)
    oky = (y >= 0) & (y < dim)
    # window z must be inside the window and map to a real global layer
    gz = z + zc0 - R
    okz = (z >= 0) & (z < zwin) & (gz >= 0) & (gz < dim)
    xc = np.clip(x, 0, dim - 1)
    yc = np.clip(y, 0, dim - 1)
    zc = np.clip(z, 0, zwin - 1)
    lin = (xc[:, None, None, :] + dim * yc[:, None, :, None]
           + dim * dim * zc[:, :, None, None])
    valid = (okx[:, None, None, :] & oky[:, None, :, None]
             & okz[:, :, None, None])
    return np.where(valid, lin, -1).reshape(sc.shape[0],
                                            side ** 3).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class SlabClass:
    """Host schedule of one class of a slab: its radius, capacities and
    route, its supercells' own cells and dilated boxes as window cell ids
    (``own`` (Sc, s^3), ``cand`` (Sc, side^3), -1 off the grid), their
    certificate boxes in global domain coordinates (``lo``/``hi`` (Sc, 3)
    f32) and, off the kernel route, its supercells a step."""

    radius: int
    qcap: int
    ccap: int
    route: str
    own: np.ndarray
    cand: np.ndarray
    lo: np.ndarray
    hi: np.ndarray
    step_rows: Optional[int] = None

    @property
    def n_sc(self) -> int:
        return int(self.own.shape[0])


@dataclasses.dataclass(frozen=True)
class ChipPlan:
    """One slab's static class schedule over its window.  ``class_of`` /
    ``row_of``: (n_sc_local,) host arrays mapping every slab-local
    supercell to its class (-1: no stored point) and its row there;
    external queries bucket through them (:meth:`ShardedKnnProblem.query`).
    """

    classes: Tuple[SlabClass, ...]
    class_of: np.ndarray
    row_of: np.ndarray


def _plan_chip(counts_all: np.ndarray, d: int, meta: ShardMeta,
               cfg: KnnConfig, on_kernel_platform: bool,
               budget: Optional[int] = None) -> ChipPlan:
    """Slab d's class partition from its window's ring occupancy.

    ``counts_all``: (ndev, zcap*dim^2) host copies of every slab's cell
    counts.  The partition is ``adaptive.build_class_specs``'s; off the
    kernel platforms (``backend='xla'``) every class not routed 'mxu'
    streams.  ``_preflight`` then routes the classes against ``budget``
    (None: unbounded) and sizes the steps of those not on the kernel
    route."""
    dim, zcap, R, s = meta.dim, meta.zcap, meta.radius, cfg.supercell

    def mk3(c):
        return c.reshape(zcap, dim, dim)

    # int64: the window feeds summed_area_table, whose sums reach n
    zeros = np.zeros((R, dim, dim), np.int64)
    lo3 = mk3(counts_all[d - 1])[-R:] if d > 0 else zeros
    hi3 = mk3(counts_all[d + 1])[:R] if d + 1 < meta.ndev else zeros
    win3 = np.concatenate([lo3, mk3(counts_all[d]).astype(np.int64), hi3])

    n_sc_xy = -(-dim // s)
    r = np.arange(n_sc_xy, dtype=np.int32)
    lz = np.arange(zcap // s, dtype=np.int32)
    zz, yy, xx = np.meshgrid(lz, r, r, indexing="ij")
    sc = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], axis=1)

    zc0 = d * zcap
    if cfg.ring_radius is not None:
        rmax = min(R, max(1, int(cfg.ring_radius)))
        pts_cum, _ = _window_occupancy(win3, sc, s, R, dim, zc0, rmax)
        radii = np.full((sc.shape[0],), rmax, np.int32)
    else:
        pts_cum, cells_cum = _window_occupancy(win3, sc, s, R, dim, zc0, R)
        radii = select_radii(pts_cum, cells_cum, cfg.k, R)

    specs = build_class_specs(pts_cum[:, 0], pts_cum, radii, cfg)
    if not on_kernel_platform:
        specs = tuple(dataclasses.replace(sp, route="streamed")
                      if sp.route == "kernel" else sp for sp in specs)
    step_rows = []
    if specs:
        specs, step_rows = _preflight(specs, cfg, meta.pcap, budget)
    w = meta.domain / dim
    zwin = win3.shape[0]
    classes = []
    class_of = np.full((sc.shape[0],), -1, np.int32)
    row_of = np.zeros((sc.shape[0],), np.int32)
    for ci, (spec, rows) in enumerate(zip(specs, step_rows)):
        class_of[spec.rows] = ci
        row_of[spec.rows] = np.arange(spec.rows.size, dtype=np.int32)
        sc_c = sc[spec.rows]
        # certificate boxes in global domain coordinates (z offset by zc0)
        gsc = sc_c + np.array([0, 0, zc0 // s])
        classes.append(SlabClass(
            radius=spec.radius, qcap=spec.qcap, ccap=spec.ccap,
            route=spec.route,
            own=_window_box_cells(sc_c, 0, 0, s, dim, R, zc0, zwin),
            cand=_window_box_cells(sc_c, -spec.radius, spec.radius, s, dim,
                                   R, zc0, zwin),
            lo=((gsc * s - spec.radius) * w).astype(np.float32),
            hi=((gsc * s + s + spec.radius) * w).astype(np.float32),
            step_rows=rows))
    return ChipPlan(classes=tuple(classes), class_of=class_of, row_of=row_of)


def _assemble_ext(spts, sids, counts, lo_pts, lo_ids, lo_counts,
                  hi_pts, hi_ids, hi_counts, hcap: int):
    """Halo-extended point, id and CSR arrays: lower halo | local | upper
    halo."""
    pcap = spts.shape[0]

    def starts(c):
        return torch.cumsum(c, 0) - c

    ext_starts = torch.cat([starts(lo_counts), starts(counts) + hcap,
                            starts(hi_counts) + hcap + pcap])
    return (torch.cat([lo_pts, spts, hi_pts]),
            torch.cat([lo_ids, sids, hi_ids]),
            ext_starts.to(torch.int32),
            torch.cat([lo_counts, counts, hi_counts]))


@dataclasses.dataclass(frozen=True)
class SlabReady:
    """A slab's solve state, built once per problem (:func:`_chip_ready_state`).

    ``window`` is the halo-extended window as a grid: ext points, their
    original ids in place of the permutation (so ``translate_ids`` maps a
    window index straight to an original id), the ext CSR; its ``dim`` is
    the global grid's, whose cubic geometry it does not have.  ``spts``
    are the local rows' points (window rows ``loc0 .. loc0 + pcap``),
    ``plan`` the window's classes (forward maps ``tgt`` in local rows, the
    spare row ``pcap`` for pads and for slots outside the local rows; on a
    kernel class its pack) with ``inv_box`` / ``inv_row`` over the local
    rows, ``lo_rows`` / ``hi_rows`` each local row's certificate box, and
    ``has_slot`` which local rows a class slot writes (False on pads)."""

    window: GridHash
    spts: torch.Tensor
    plan: AdaptivePlan
    lo_rows: torch.Tensor
    hi_rows: torch.Tensor
    has_slot: torch.Tensor


def _chip_ready_state(window: GridHash, plan: ChipPlan, loc0: int, pcap: int,
                      epilogue: str) -> SlabReady:
    """Pack each 'kernel' class against the window arrays (the other routes
    keep their query-slot ids and cell tables), and invert the slot
    partition for the local rows ``loc0 .. loc0 + pcap``.

    A slot's forward row is its window index minus ``loc0``.  Own cells
    never cover a halo layer, so every real slot lands in the local rows;
    should that ever break, a slot outside them goes to the spare row
    ``pcap`` (as pads do) rather than to a wrapped or out-of-range row,
    and the local row it should have written keeps no slot: ``has_slot``
    is False there and the row stays uncertified."""
    device = window.device
    n_ext = window.n_points
    inv_box = torch.full((n_ext + 1,), -1, dtype=torch.int32, device=device)
    inv_row = (torch.zeros((n_ext + 1,), dtype=torch.int32, device=device)
               if epilogue == "gather" else None)
    row_off = box_off = 0
    classes = []
    for sc in plan.classes:
        own = torch.as_tensor(sc.own, device=device)
        cand = torch.as_tensor(sc.cand, device=device)
        pk = None
        if sc.route == "kernel":
            pk = pack_inputs(window.points, window.cell_starts,
                             window.cell_counts, own, cand, sc.qcap, sc.ccap)
            qid, cand = pk.qid, None
        else:
            q_idx, q_ok = pack_cells(own, window.cell_starts,
                                     window.cell_counts, sc.qcap)
            qid = torch.where(q_ok, q_idx, _PAD_Q).to(torch.int32)
        cp = ClassPlan(lo=torch.as_tensor(sc.lo, device=device),
                       hi=torch.as_tensor(sc.hi, device=device),
                       radius=sc.radius, qcap=sc.qcap, ccap=sc.ccap,
                       route=sc.route, qid=qid, pk=pk, cand=cand,
                       step_rows=sc.step_rows, tgt=None,
                       own=own if sc.route == "mxu" else None)
        row_off, box_off, tgt = _class_inverse_update(
            inv_box, inv_row, cp, n_ext, row_off, box_off)
        local = tgt - loc0
        local = torch.where((local < 0) | (local >= pcap), pcap, local)
        classes.append(dataclasses.replace(cp, tgt=local.to(torch.int32)))
    loc = slice(loc0, loc0 + pcap)
    box = inv_box[loc]
    has_slot = box >= 0
    safe = box.clamp(min=0).long()
    lo_rows = torch.cat([cp.lo for cp in classes])[safe]
    hi_rows = torch.cat([cp.hi for cp in classes])[safe]
    return SlabReady(
        window=window, spts=window.points[loc],
        plan=AdaptivePlan(
            classes=tuple(classes), inv_box=box,
            inv_row=None if inv_row is None else inv_row[loc],
            n_points=pcap, class_of_sc=plan.class_of,
            row_of_sc=plan.row_of,
            cand_table=lambda ci: plan.classes[ci].cand),
        lo_rows=lo_rows, hi_rows=hi_rows, has_slot=has_slot)


def _chip_solve(ready: SlabReady, cfg: KnnConfig):
    """One slab's solve over its prepared state: every class on its route
    over the window (the single-device route's epilogues: 'scatter' places
    each class's rows in the local rows through its forward map, 'gather'
    concatenates every class's rows and reads the local rows through
    ``inv_row``), then the certificate from each row's raw k-th d2 (a
    blocked deficit's NaN fails it; a row no slot wrote fails it too),
    non-finite entries become (-1, inf), and window indices translate to
    original ids on the device.  Returns ((pcap, k) original ids, (pcap,
    k) d2 ascending, (pcap,) certified), rows in local sorted order; pad
    rows carry (-1, inf), uncertified.  No readback happens here."""
    k = cfg.k
    window, plan = ready.window, ready.plan
    if cfg.resolved_epilogue() == "gather":
        all_d, all_i = class_rows(window, cfg, plan.classes)
        idx = plan.inv_row.long()
        row_d, row_i = all_d[idx], all_i[idx]
    else:
        row_d, row_i = scatter_rows(window, cfg, plan.classes, plan.n_points)
    raw_kth = row_d[:, k - 1]
    ok = torch.isfinite(row_d) & ready.has_slot[:, None]
    row_i = torch.where(ok, row_i, INVALID_ID)
    row_d = torch.where(ok, row_d, float("inf"))
    cert = ((raw_kth <= _margin_sq(ready.spts, ready.lo_rows, ready.hi_rows,
                                   window.domain)) & ready.has_slot)
    return translate_ids(row_i, window.permutation), row_d, cert


def save_sharded(problem: "ShardedKnnProblem", path: str) -> None:
    """Checkpoint a sharded problem to one ``.npz`` ('.npz' appended when
    missing), in the reference's schema: points, grid dim, slab count and
    config.  The decomposition, build and plan are deterministic, so a
    resume re-prepares, onto whatever mesh the resuming process has."""
    from ..api import _npz_path

    cfg = dataclasses.asdict(problem.config)
    np.savez_compressed(
        _npz_path(path),
        points=problem._points_host,
        dim=np.int64(problem.meta.dim),
        n_devices=np.int64(problem.meta.ndev),
        config_json=np.bytes_(json.dumps(
            {k: v for k, v in cfg.items() if v is not None}).encode()))


def load_sharded(path: str, n_devices: Optional[int] = None, mesh=None, *,
                 devices=None) -> "ShardedKnnProblem":
    """Resume a checkpointed sharded problem (see :func:`save_sharded`),
    also one the reference wrote.  The slab count defaults to the
    checkpoint's; ``n_devices``, ``mesh`` or ``devices`` re-shard it (as in
    :meth:`ShardedKnnProblem.prepare`).  ``interpret`` and ``stream_tile``,
    which the port does not honour, are dropped from the config."""
    from ..api import _REFERENCE_RUNTIME_KNOBS, _npz_path

    with np.load(_npz_path(path)) as z:
        saved = json.loads(bytes(z["config_json"]).decode())
        cfg = KnnConfig(**{k: v for k, v in saved.items()
                           if k not in _REFERENCE_RUNTIME_KNOBS})
        points = z["points"]
        dim = int(z["dim"])
        if n_devices is None and mesh is None and devices is None:
            n_devices = int(z["n_devices"])
    return ShardedKnnProblem.prepare(points, n_devices=n_devices, config=cfg,
                                     mesh=mesh, dim=dim, devices=devices)


def _resolve_mesh(n_devices: Optional[int], mesh, devices) -> List[Slab]:
    """The slab list of :meth:`ShardedKnnProblem.prepare`: ``mesh`` as
    given (``distributed.z_mesh``); else one slab per entry of
    ``devices`` (repeats allowed); else one slab per visible CUDA device
    (``n_devices`` of them), raising :class:`NoDeviceError` without one."""
    if mesh is not None:
        return list(mesh)
    if devices is not None:
        devices = [resolve_device(dv) for dv in devices]
        if not devices:
            raise InvalidConfigError("devices= lists no device")
        if n_devices is not None and n_devices != len(devices):
            raise InvalidConfigError(
                f"n_devices={n_devices} does not match the {len(devices)} "
                f"devices given")
        return [Slab(0, dv) for dv in devices]
    if not torch.cuda.is_available():
        raise NoDeviceError(
            "no CUDA device is available; the sharded engine runs on the "
            "GPU by default -- pass devices=['cpu'] * n to run its slabs on "
            "the CPU")
    count = torch.cuda.device_count()
    n = count if n_devices is None else int(n_devices)
    if not 1 <= n <= count:
        raise InvalidConfigError(
            f"n_devices={n_devices} with {count} visible CUDA device(s); "
            f"pass devices= to place several slabs on one device")
    return [Slab(0, torch.device("cuda", i)) for i in range(n)]


def round_robin_devices(device, n_slabs: int) -> List[str]:
    """``devices=`` for ``n_slabs`` slabs from one resolved ``device``: on
    CUDA slab i on card i mod the card count (one card: ``cuda:0``
    repeated), else ``device`` repeated."""
    device = torch.device(device)
    if device.type != "cuda":
        return [str(device)] * n_slabs
    cards = torch.cuda.device_count()
    return [f"cuda:{i % cards}" for i in range(n_slabs)]


@dataclasses.dataclass
class ShardedKnnProblem:
    """One prepared problem over a mesh of slabs: the multi-device twin of
    ``api.KnnProblem``.  No device ever holds the global set: each slab
    builds and owns its own.  ``dev`` holds the build outputs of this
    process's slabs (``spts``, ``sids``, ``counts`` and the ``lo_*`` /
    ``hi_*`` halos), on their devices; ``prepare_seconds`` the host wall of
    prepare's phases."""

    config: KnnConfig
    mesh: List[Slab]
    meta: ShardMeta
    n_points: int
    chip_plans: List[ChipPlan]
    dev: Dict[int, Dict[str, torch.Tensor]] = dataclasses.field(
        default_factory=dict, repr=False)
    prepare_seconds: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    _points_host: Optional[np.ndarray] = dataclasses.field(default=None,
                                                           repr=False)
    _oracle_cache: Optional[object] = dataclasses.field(default=None,
                                                        repr=False)
    _ready_cache: Dict[int, SlabReady] = dataclasses.field(
        default_factory=dict, repr=False)
    _solved_cache: Optional[tuple] = dataclasses.field(default=None,
                                                       repr=False)
    _device_out_cache: Optional[dict] = dataclasses.field(default=None,
                                                          repr=False)
    # rows the last solve() resolved through the kd-tree
    fallback_rows: Optional[np.ndarray] = dataclasses.field(default=None,
                                                            repr=False)

    def _oracle(self):
        """The host kd-tree over the full set, built once per problem and
        only when a row is open (the exact resolver)."""
        if self._oracle_cache is None:
            from ..oracle import KdTreeOracle

            self._oracle_cache = KdTreeOracle(self._points_host)
        return self._oracle_cache

    @classmethod
    def prepare(cls, points, n_devices: Optional[int] = None,
                config: Optional[KnnConfig] = None, mesh=None,
                dim: Optional[int] = None, *,
                devices=None) -> "ShardedKnnProblem":
        """Validate ``points``, partition them into z-slabs over the mesh
        (:func:`_resolve_mesh`: one slab per CUDA device by default; ``mesh``
        from ``distributed.z_mesh()`` across processes; ``devices`` to
        place slabs, repeats allowed, e.g. ``['cpu'] * 4``), build every
        local slab on its device, exchange the halos and plan every slab.
        ``backend='oracle'``, and the MXU scorer under ``dist_method='dot'``,
        are refused with the reference's messages."""
        config = config or KnnConfig()
        if config.backend == "oracle":
            raise InvalidConfigError(
                "backend='oracle' is a single-chip host engine; the sharded "
                "path runs grid engines only ('auto'/'pallas'/'xla')")
        config.resolved_precision()
        if config.resolved_scorer() == "mxu" and config.dist_method != "diff":
            raise InvalidConfigError(
                f"scorer='mxu' (recall_target={config.recall_target}) "
                f"composes with the per-chip class solves only under "
                f"dist_method='diff' (got {config.dist_method!r}): the class "
                f"scorers realize distances in diff arithmetic")
        mesh = _resolve_mesh(n_devices, mesh, devices)
        ndev = len(mesh)
        rank = _dist.rank()
        if _dist.world_size() > 1:
            _dist.check_process_major(mesh)
        local = [d for d, sl in enumerate(mesh) if sl.process == rank]
        seconds = {}
        with _spans.span("prepare.sharded.validate", force=True) as sp:
            points = validate_or_raise(points, k=config.k)
        seconds["validate"] = sp.dur_ms / 1e3
        n = points.shape[0]
        dim = grid_dim_for(n, config.density) if dim is None else int(dim)
        _, _, zcap = _slab_bounds(dim, config.supercell, ndev)

        with _spans.span("prepare.sharded.halo_depth", force=True) as sp:
            if config.ring_radius is not None:
                radius = max(1, int(config.ring_radius))
                if zcap < radius:
                    raise InvalidConfigError(
                        f"slab thickness {zcap} cells < halo depth {radius}: "
                        f"halo would span multiple slabs. Use fewer devices, "
                        f"a larger supercell, or a smaller ring radius "
                        f"(dim={dim}, ndev={ndev}).")
            else:
                radius = _measured_halo_depth(points, dim, zcap, config)
        seconds["halo_depth"] = sp.dur_ms / 1e3
        with _spans.span("prepare.sharded.partition", force=True) as sp:
            b_pts, b_ids, n_local, pcap, hcap = _partition_host(
                points, dim, zcap, radius, ndev, DOMAIN_SIZE)
        seconds["partition"] = sp.dur_ms / 1e3
        meta = ShardMeta(ndev=ndev, dim=dim, zcap=zcap, radius=radius,
                         pcap=pcap, hcap=hcap, domain=DOMAIN_SIZE)

        # each local slab sorts on its device, then the halos cross; the
        # counts readback (4 bytes a cell) ends the phase
        with _spans.span("prepare.sharded.build", force=True,
                         slabs=len(local)) as sp:
            built = {}
            for d in local:
                device = mesh[d].device
                built[d] = _build_slab(dispatch.stage(b_pts[d], device),
                                       dispatch.stage(b_ids[d], device),
                                       int(n_local[d]), d, meta)
            dev = _exchange(built, meta, mesh)
            del built
            if _dist.world_size() > 1:
                counts_all = _dist.allgather_counts(
                    [dev[d]["counts"] for d in local], ndev)
            else:
                counts_all = np.stack(dispatch.fetch(
                    *[dev[d]["counts"] for d in local]))
        seconds["build_exchange"] = sp.dur_ms / 1e3

        # explicit backend='xla' streams every class, as the reference's
        # does off its kernel platforms; slabs sharing a device split its
        # memory budget
        on_kernel = config.backend != "xla"
        share = {}
        for d in local:
            share[mesh[d].device] = share.get(mesh[d].device, 0) + 1
        with _spans.span("prepare.sharded.plan", force=True) as sp:
            plans = []
            for d in range(ndev):
                budget = None
                if d in dev:
                    device = mesh[d].device
                    budget = hbm_budget_bytes(device, config)
                    if budget is not None:
                        budget //= share[device]
                plans.append(_plan_chip(counts_all, d, meta, config,
                                        on_kernel, budget))
        seconds["plan"] = sp.dur_ms / 1e3
        return cls(config=config, mesh=mesh, meta=meta, n_points=n,
                   chip_plans=plans, dev=dev, prepare_seconds=seconds,
                   _points_host=points)

    # -- per-slab access ------------------------------------------------------

    def local_chips(self) -> List[int]:
        """Mesh positions of the slabs this process holds: all of them in
        one process, its own in a multi-process mesh (the build and the
        exchange span the processes; each then solves its own slabs)."""
        return sorted(self.dev)

    def _chip_inputs(self, d: int) -> Dict[str, torch.Tensor]:
        """Slab d's build outputs, on its device."""
        return self.dev[d]

    def _chip_ready(self, d: int) -> SlabReady:
        """Slab d's solve state (:func:`_chip_ready_state`), built once per
        problem and cached.  It pins an extra copy of the slab's window and
        every kernel class's pack on the slab's device for the problem's
        lifetime (``solve_device`` and ``query`` both build it); release
        it with :meth:`drop_ready`."""
        if not self.chip_plans[d].classes:
            raise ValueError(f"slab {d} has an empty class schedule")
        if d not in self._ready_cache:
            b = self._chip_inputs(d)
            ext_pts, ext_ids, ext_starts, ext_counts = _assemble_ext(
                b["spts"], b["sids"], b["counts"], b["lo_pts"], b["lo_ids"],
                b["lo_counts"], b["hi_pts"], b["hi_ids"], b["hi_counts"],
                self.meta.hcap)
            window = GridHash(points=ext_pts, permutation=ext_ids,
                              cell_starts=ext_starts, cell_counts=ext_counts,
                              dim=self.meta.dim, domain=self.meta.domain)
            self._ready_cache[d] = _chip_ready_state(
                window, self.chip_plans[d], self.meta.hcap, self.meta.pcap,
                self.config.resolved_epilogue())
        return self._ready_cache[d]

    def drop_ready(self, chip: Optional[int] = None) -> None:
        """Release the cached solve state (see :meth:`_chip_ready`) of every
        slab, or of one mesh position; the next solve or query rebuilds
        it.  The build outputs in ``dev`` stay."""
        if chip is None:
            self._ready_cache.clear()
            self._device_out_cache = None
        else:
            self._ready_cache.pop(chip, None)
            if self._device_out_cache is not None:
                self._device_out_cache.pop(chip, None)

    def _require_all_slabs(self, what: str) -> None:
        chips = self.local_chips()
        if len(chips) < self.meta.ndev:
            raise RuntimeError(
                f"{what} covers all {self.meta.ndev} slabs but this process "
                f"holds only slabs {chips}; on a multi-host mesh use "
                f"solve_device() per process and aggregate externally")

    def solve_device(self) -> Dict[int, Optional[tuple]]:
        """Every local slab's solve (:func:`_chip_solve`), results left on
        the slabs' devices: {mesh position: (original ids (pcap, k), d2
        (pcap, k), certified (pcap,)), or None for an empty slab}.  The
        host loop only launches: slabs on different cards run at once."""
        outs = {}
        with _spans.span("solve.sharded.chips",
                         chips=len(self.local_chips())):
            for d in self.local_chips():
                if not self.chip_plans[d].classes:  # empty slab: no work
                    outs[d] = None
                    continue
                outs[d] = _chip_solve(self._chip_ready(d), self.config)
        # kept for stats()' margin telemetry (released by drop_ready)
        self._device_out_cache = outs
        return outs

    def solve(self, device_out=None
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The sharded all-points solve in original indexing: (neighbours
        (n, k), d2 (n, k), certified (n,)).  One batched fetch reads every
        slab's ids, rows and certificates; the host places them; with
        ``fallback='brute'`` uncertified rows are resolved exactly by the
        host kd-tree (built only then) and count as certified.  Pass
        ``device_out`` (a :meth:`solve_device` result) to skip the solve.
        Single-controller: a multi-process mesh raises."""
        self._require_all_slabs("solve()")
        cfg = self.config
        outs = device_out if device_out is not None else self.solve_device()
        n, k = self.n_points, cfg.k
        neighbors = np.full((n, k), INVALID_ID, np.int32)
        d2 = np.full((n, k), np.inf, np.float32)
        cert = np.zeros((n,), bool)
        live = [d for d in sorted(outs) if outs[d] is not None]
        with _spans.span("solve.sharded.fetch", slabs=len(live)):
            fetched = dispatch.fetch(*[
                t for d in live
                for t in (self._chip_inputs(d)["sids"],) + tuple(outs[d])])
        with _spans.span("solve.sharded.place"):
            for j in range(len(live)):
                sids, o_i, o_d, o_c = fetched[4 * j: 4 * j + 4]
                rows = sids >= 0
                neighbors[sids[rows]] = o_i[rows]
                d2[sids[rows]] = o_d[rows]
                cert[sids[rows]] = o_c[rows]
        self.fallback_rows = np.nonzero(~cert)[0].astype(np.int32)
        if cfg.fallback == "brute" and self.fallback_rows.size:
            with _spans.span("solve.sharded.fallback",
                             rows=int(self.fallback_rows.size)):
                bad = self.fallback_rows
                b_ids, b_d2 = self._oracle().knn(
                    self._points_host[bad], k,
                    exclude_ids=bad if cfg.exclude_self else None)
                neighbors[bad] = b_ids
                d2[bad] = b_d2
                cert[bad] = True
        # kept for get_edges(); treat the arrays as immutable
        self._solved_cache = (neighbors, d2, cert)
        return neighbors, d2, cert

    def permutation(self) -> np.ndarray:
        """Original index of every stored row, slab by slab (a bijection
        over [0, n)); one batched fetch.  Single-controller."""
        self._require_all_slabs("permutation()")
        ids = dispatch.fetch(*[self._chip_inputs(d)["sids"]
                               for d in self.local_chips()])
        flat = np.concatenate(ids)
        return flat[flat >= 0]

    # -- queries and derived views -------------------------------------------

    def query(self, queries, k: Optional[int] = None, planes: bool = False):
        """Exact kNN of (m, 3) query coordinates against the sharded set:
        each query routes to the slab owning its z-cell and rides that
        slab's classes over its window (``adaptive.query_device``), every
        slab's launches dispatched before one batched fetch; queries in a
        supercell without a class, or on an empty slab, and uncertified
        rows resolve exactly through the host kd-tree.  No self-exclusion.
        Returns ((m, k) original ids, ascending; (m, k) d2), in query
        order, and with ``planes=True`` the (m, k, 4) plane feed.
        Single-controller."""
        cfg, meta = self.config, self.meta
        k = cfg.k if k is None else k
        queries = validate_or_raise(queries, k=k, what="queries")
        k = int(k)
        if k > cfg.k:
            raise InvalidKError(
                f"k={k} exceeds the prepared k={cfg.k} (it sized the "
                f"candidate dilation)")
        self._require_all_slabs("query()")
        queries = np.ascontiguousarray(queries, np.float32)
        m = queries.shape[0]
        if m == 0:
            empty = (np.empty((0, k), np.int32),
                     np.empty((0, k), np.float32))
            if planes:
                return empty + (np.zeros((0, k, 4), np.float32),)
            return empty
        s = cfg.supercell
        # int64: the supercell linearization multiplies by n_sc_xy^2
        coords = cell_coords_host(queries, meta.dim, meta.domain).astype(
            np.int64)
        owner = np.minimum(coords[:, 2] // meta.zcap, meta.ndev - 1)
        n_sc_xy = -(-meta.dim // s)
        out_i = np.full((m, k), INVALID_ID, np.int32)
        out_d = np.full((m, k), np.inf, np.float32)
        cert = np.zeros((m,), bool)
        pending = []
        for d in self.local_chips():
            on_d = np.nonzero(owner == d)[0]
            plan = self.chip_plans[d]
            if on_d.size == 0 or not plan.classes:
                continue  # an empty slab's queries go to the kd-tree
            ready = self._chip_ready(d)
            cc = coords[on_d]
            scidx = ((cc[:, 2] - d * meta.zcap) // s * (n_sc_xy ** 2)
                     + (cc[:, 1] // s) * n_sc_xy + (cc[:, 0] // s))
            pending.append((on_d, query_device(
                ready.window, cfg, ready.plan, queries[on_d],
                plan.class_of[scidx], plan.row_of[scidx], k)))
        fetched = dispatch.fetch(*[t for _, ts in pending for t in ts])
        for j, (rows, _) in enumerate(pending):
            out_i[rows], out_d[rows], cert[rows] = fetched[3 * j: 3 * j + 3]
        if not cert.all():
            bad = np.nonzero(~cert)[0]
            out_i[bad], out_d[bad] = self._oracle().knn(queries[bad], k)
        if planes:
            from ..cluster.planes import bisector_planes

            return out_i, out_d, bisector_planes(queries, self._points_host,
                                                 out_i)
        return out_i, out_d

    def query_radius(self, queries, radius: float,
                     max_neighbors: Optional[int] = None):
        """All stored points within ``radius`` of each query, at most
        ``max_neighbors`` (default k): the sharded twin of
        ``KnnProblem.query_radius``, over :meth:`query`.  Returns (ids,
        d2, counts, truncated)."""
        from ..api import radius_mask_from_knn

        cap = self.config.k if max_neighbors is None else int(max_neighbors)
        if cap > self.config.k:
            raise InvalidKError(
                f"max_neighbors={cap} exceeds the prepared k={self.config.k}")
        ids, d2 = self.query(queries, k=cap)
        return radius_mask_from_knn(ids, d2, radius, cap)

    def get_edges(self, symmetric: bool = False, device_out=None,
                  solved=None) -> np.ndarray:
        """The kNN graph as a COO edge list (E, 2) of original ids, over
        ``solved`` (a :meth:`solve` result), else ``device_out``, else the
        last solve's result, else a new solve."""
        from ..api import edges_from_neighbors

        if solved is None:
            if device_out is not None:
                solved = self.solve(device_out=device_out)
            else:
                solved = self._solved_cache or self.solve()
        return edges_from_neighbors(solved[0], symmetric)

    def get_planes(self, solved=None, device_out=None) -> np.ndarray:
        """(n, k, 4) f32 Voronoi plane feed of the all-points solve
        (``cluster.planes.bisector_planes``), over ``solved`` or
        ``device_out`` when given."""
        from ..cluster.planes import bisector_planes

        neighbors = (solved[0] if solved is not None
                     else self.solve(device_out=device_out)[0])
        return bisector_planes(self._points_host, self._points_host,
                               neighbors)

    def stats(self) -> dict:
        """The decomposition and every local slab's schedule, as the
        reference's ``stats``: per slab its points, cell occupancy and
        classes and, once a solve has run and its state is cached, the
        achieved-margin summary (``utils.stats.margin_summary``)."""
        from ..utils.stats import _margin_sq_np, margin_summary, \
            occupancy_stats

        meta = self.meta
        chips = []
        for d in self.local_chips():
            inp = self._chip_inputs(d)
            counts = inp["counts"].cpu().numpy()
            plan = self.chip_plans[d]
            row = {
                "chip": d,
                "n_points": int(counts.sum()),
                "occupancy": occupancy_stats(counts),
                "classes": [{"radius": cp.radius, "n_supercells": cp.n_sc,
                             "qcap": cp.qcap, "ccap": cp.ccap,
                             "route": cp.route} for cp in plan.classes],
            }
            out = (self._device_out_cache or {}).get(d)
            if out is not None and d in self._ready_cache:
                ready = self._ready_cache[d]
                sids = inp["sids"].cpu().numpy()
                real = sids >= 0
                kth = None
                if self._solved_cache is not None:
                    kth = self._solved_cache[1][sids[real], -1]
                else:
                    cert = out[2].cpu().numpy()[real]
                    if cert.all():
                        kth = out[1].cpu().numpy()[real, -1]
                    else:
                        row["margin_pending_fallback"] = int((~cert).sum())
                if kth is not None:
                    msq = _margin_sq_np(ready.spts.cpu().numpy()[real],
                                        ready.lo_rows.cpu().numpy()[real],
                                        ready.hi_rows.cpu().numpy()[real],
                                        meta.domain)
                    row["margin"] = margin_summary(kth, msq)
            chips.append(row)
        return {
            "n_points": self.n_points,
            "n_devices": meta.ndev,
            "grid_dim": meta.dim,
            "slab_cells_z": meta.zcap,
            "halo_depth": meta.radius,
            "pcap": meta.pcap,
            "hcap": meta.hcap,
            "k": self.config.k,
            "chips": chips,
        }

    def print_stats(self) -> dict:
        """Print :meth:`stats` for a person; returns the dict."""
        s = self.stats()
        print(f"grid {s['grid_dim']}^3, {s['n_points']} points over "
              f"{s['n_devices']} slabs; z-slab {s['slab_cells_z']} cells, "
              f"halo {s['halo_depth']} cells, pcap {s['pcap']}, "
              f"hcap {s['hcap']}")
        for c in s["chips"]:
            occ = c["occupancy"]
            print(f"slab {c['chip']}: {c['n_points']} points, "
                  f"max {occ['max_per_cell']}/cell")
            for cl in c["classes"]:
                print(f"  class r={cl['radius']}: {cl['n_supercells']} "
                      f"supercells, qcap {cl['qcap']}, ccap {cl['ccap']} "
                      f"[{cl['route']}]")
            if c.get("margin", {}).get("n"):
                m = c["margin"]
                print(f"  margin ratio: p50 {m['p50']:.3f}, "
                      f"p99 {m['p99']:.3f}, max {m['max']:.3f}; "
                      f"{m['decertified']} decertified")
        return s
