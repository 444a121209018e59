"""PodKnnProblem: the cell-partitioned kNN index (prepare, solve, query).

Counterpart of ``cuda_knearests_tpu/pod/solve.py``: one prepared problem
whose grid cells are split over the chips of a pod as contiguous Morton
ranges (``partition.py``), whose boundary candidates move between chips
along the chain (``halo.py``), and whose per-chip memory is the only
limit (``stream.py``).  A chip is a torch device; several chips may share
one (``["cuda:0"] * 4`` on one card, ``["cpu"] * 4`` in the tests), which
is the port's form of the reference's emulated mesh.

* prepare -- host planning, then each chip's bucket, export indices and
  window CSR staged onto its device, one ``dispatch.stage`` each: the
  whole cloud never rides one transfer.  No host sync.
* exchange -- at the first solve (or query), once per problem: the export
  blocks walked along the chain (``halo.exchange``); its bytes are
  recorded as ``ici_bytes``, never as a host sync.
* solve -- per chip the window's classes through the z-slab route's
  per-chip solve (``parallel.sharded._chip_ready_state`` and
  ``_chip_solve``: the class kernels over the window), then ONE batched
  fetch of every chip's rows; the bucket ids are already on the host, and
  uncertified rows resolve through the host kd-tree.

Certified rows equal the single-device solve's d2 bit for bit (the same
kernels on the same candidates); ids may differ among equal-distance
ties, since the window orders candidates by chip and Morton range.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import KnnConfig, grid_dim_for
from ..io import validate_or_raise
from ..obs import spans as _spans
from ..ops.adaptive import query_device
from ..ops.gridhash import GridHash
from ..ops.topk import INVALID_ID
from ..parallel.sharded import (SlabReady, _chip_ready_state, _chip_solve,
                               check_grid_engine)
from ..runtime import dispatch
from ..utils.memory import (InvalidConfigError, InvalidKError,
                            LaunchBudgetError, NoDeviceError)
from ..utils.platform import resolve_device
from . import halo as _halo
from .partition import (PodChipPlan, PodDirectory, PodMeta, build_pod_plan,
                        route_queries)
from .stream import auto_devices, chip_budgets, full_cloud_model, \
    preflight_pod


def _device_pool(mesh, devices) -> Tuple[List[torch.device], bool]:
    """(the chips to choose from, whether they are fixed): ``mesh`` as
    given (fixed); else ``devices`` (repeats allowed); else every visible
    CUDA device, raising :class:`NoDeviceError` without one."""
    if mesh is not None:
        pool, fixed = list(mesh), True
    elif devices is not None:
        pool, fixed = list(devices), False
    else:
        if not torch.cuda.is_available():
            raise NoDeviceError(
                "no CUDA device is available; the pod runs on the GPU by "
                "default -- pass devices=['cpu'] * n to run its chips on "
                "the CPU")
        pool = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        fixed = False
    pool = [resolve_device(dv) for dv in pool]
    if not pool:
        raise InvalidConfigError("the pod's mesh lists no device")
    return pool, fixed


@dataclasses.dataclass
class PodKnnProblem:
    """One prepared cell-partitioned problem over a list of chips.
    ``dev[d]`` holds chip d's staged bucket (``pts``, ``ids``), its
    ``export_idx`` and its window CSR (``ext_starts``, ``ext_counts``) on
    ``mesh[d]``; ``prepare_seconds`` the host wall of prepare's phases."""

    config: KnnConfig
    mesh: List[torch.device]
    meta: PodMeta
    directory: PodDirectory
    n_points: int
    chip_plans: List[PodChipPlan]
    hbm: dict
    dev: Dict[int, Dict[str, torch.Tensor]] = dataclasses.field(
        default_factory=dict, repr=False)
    prepare_seconds: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    _points_host: Optional[np.ndarray] = dataclasses.field(default=None,
                                                           repr=False)
    _bucket_ids_host: Optional[np.ndarray] = dataclasses.field(default=None,
                                                               repr=False)
    _chip_of_point: Optional[np.ndarray] = dataclasses.field(default=None,
                                                             repr=False)
    _oracle_cache: Optional[object] = dataclasses.field(default=None,
                                                        repr=False)
    _ready_cache: Dict[int, SlabReady] = dataclasses.field(
        default_factory=dict, repr=False)
    _halo: Optional[dict] = dataclasses.field(default=None, repr=False)
    # rows the last solve() / query() resolved through the kd-tree
    fallback_rows: Optional[np.ndarray] = dataclasses.field(default=None,
                                                            repr=False)
    query_fallback_rows: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False)

    # -- prepare ------------------------------------------------------------

    @classmethod
    def prepare(cls, points, n_devices: Optional[int] = None,
                config: Optional[KnnConfig] = None, mesh=None,
                dim: Optional[int] = None, *,
                devices=None) -> "PodKnnProblem":
        """Validate ``points``, plan the partition over the chips, check
        every chip's memory model against its budget and stage each chip's
        share onto its device.  Chips: ``mesh`` (a list of devices, used
        as given); else ``n_devices`` of the pool ``devices`` (repeats
        allowed), or of the visible CUDA devices.  With a budget and
        ``n_devices=None`` the auto-splitter takes the smallest prefix of
        the pool it estimates fits (``stream.auto_devices``), doubling it
        while a chip's model does not fit, and refuses only when the whole
        pool cannot hold the cloud (``LaunchBudgetError``, kind 'oom').
        ``backend='oracle'``, and the MXU scorer outside
        ``dist_method='diff'``, are refused with the reference's messages,
        before and after a tuned plan (keyed by the first chip's device)
        fills the config's still-default knobs."""
        from ..api import _resolve_tuned_for

        config = config or KnnConfig()
        check_grid_engine(config, "pod")
        pool, fixed = _device_pool(mesh, devices)
        tuned = _resolve_tuned_for(config, points, pool[0])
        if tuned is not config:
            config = tuned
            check_grid_engine(config, "pod")
        seconds = {}
        with _spans.span("prepare.pod.validate", force=True) as sp:
            points = validate_or_raise(points, k=config.k)
        seconds["validate"] = sp.dur_ms / 1e3
        n = points.shape[0]
        if fixed:
            ndev = len(pool)
        elif n_devices is not None:
            ndev = max(1, min(int(n_devices), len(pool)))
        else:
            bounded = [b for b in chip_budgets(pool, config)
                       if b is not None]
            ndev = (auto_devices(n, config.k, min(bounded), len(pool))
                    if bounded else None) or len(pool)
        dim = grid_dim_for(n, config.density) if dim is None else int(dim)

        if n == 0:
            meta = PodMeta(ndev=ndev, dim=dim, supercell=config.supercell,
                           pcap=8, hcap=8, steps=0, domain=1000.0)
            return cls(config=config, mesh=pool[:ndev], meta=meta,
                       directory=PodDirectory(
                           order=np.empty(0, np.int32),
                           rank_of=np.empty(0, np.int32),
                           bounds=np.zeros(ndev + 1, np.int32)),
                       n_points=0, chip_plans=[], hbm={},
                       prepare_seconds=seconds, _points_host=points)

        on_kernel = config.backend != "xla"
        auto = n_devices is None and not fixed
        with _spans.span("prepare.pod.plan", force=True) as sp:
            while True:
                chips = pool[:ndev]
                budgets = chip_budgets(chips, config)
                try:
                    plan = build_pod_plan(points, ndev, config, dim,
                                          on_kernel, budgets)
                    hbm = preflight_pod(
                        plan.meta, plan.chips, config, budgets,
                        full_cloud_model(n, config.k, config, dim,
                                         plan.cloud_specs))
                    break
                except LaunchBudgetError:
                    # the estimate before planning is optimistic (halo
                    # blocks and class plans exist only after it): split
                    # over more chips and plan again
                    if not auto or ndev >= len(pool):
                        raise
                    ndev = min(ndev * 2, len(pool))
        seconds["plan"] = sp.dur_ms / 1e3
        with _spans.span("prepare.pod.stage", force=True) as sp:
            dev = _halo.stage_chips(
                plan.bucket_pts, plan.bucket_ids,
                np.stack([c.export_idx for c in plan.chips]), chips)
            for d, c in enumerate(plan.chips):
                dev[d]["ext_starts"] = dispatch.stage(c.ext_starts, chips[d])  # syncflow: pod-prepare-stage
                dev[d]["ext_counts"] = dispatch.stage(c.ext_counts, chips[d])  # syncflow: pod-prepare-stage
        seconds["stage"] = sp.dur_ms / 1e3
        return cls(config=config, mesh=chips, meta=plan.meta,
                   directory=plan.directory, n_points=n,
                   chip_plans=plan.chips, hbm=hbm, dev=dev,
                   prepare_seconds=seconds, _points_host=points,
                   _bucket_ids_host=plan.bucket_ids,
                   _chip_of_point=plan.chip_of_point)

    # -- internals ------------------------------------------------------------

    def _oracle(self):
        """The host kd-tree over the full set, built once, on first need."""
        if self._oracle_cache is None:
            from ..oracle import KdTreeOracle

            self._oracle_cache = KdTreeOracle(self._points_host)
        return self._oracle_cache

    def _exchange(self) -> None:
        """The halo exchange, once per problem (``halo.exchange``); its
        bytes are recorded as ``ici_bytes``."""
        if self._halo is not None:
            return
        meta = self.meta
        with _spans.span("solve.pod.halo", steps=meta.steps,
                         ici_bytes=meta.halo_bytes()):
            self._halo = _halo.exchange(meta, self.dev, self.mesh)
        if meta.steps and meta.ndev > 1:
            dispatch.ici(meta.halo_bytes())  # syncflow: pod-ici

    def _window(self, d: int) -> GridHash:
        """Chip d's window as a grid: [own region | received blocks in
        slot order], the original ids in place of the permutation, the
        window CSR."""
        self._exchange()
        b = self.dev[d]
        h_pts, h_ids = self._halo[d]
        return GridHash(points=torch.cat([b["pts"], h_pts.reshape(-1, 3)]),
                        permutation=torch.cat([b["ids"], h_ids.reshape(-1)]),
                        cell_starts=b["ext_starts"],
                        cell_counts=b["ext_counts"], dim=self.meta.dim,
                        domain=self.meta.domain)

    def _chip_ready(self, d: int) -> SlabReady:
        """Chip d's solve state over its window
        (``parallel.sharded._chip_ready_state``, the own region at rows
        [0, pcap)), built once and cached until :meth:`drop_ready`."""
        if not self.chip_plans[d].classes:
            raise ValueError(f"chip {d} has an empty class schedule")  # kntpu-ok: bare-valueerror -- internal invariant (callers skip empty chips), not input validation
        if d not in self._ready_cache:
            self._ready_cache[d] = _chip_ready_state(
                self._window(d), self.chip_plans[d].chip_plan(), 0,
                self.meta.pcap, self.config.resolved_epilogue())
        return self._ready_cache[d]

    def drop_ready(self, chip: Optional[int] = None) -> None:
        """Release the cached solve state of every chip, or of one; the
        staged buckets and received blocks stay."""
        if chip is None:
            self._ready_cache.clear()
        else:
            self._ready_cache.pop(chip, None)

    # -- solve ------------------------------------------------------------------

    def solve_device(self) -> Dict[int, Optional[tuple]]:
        """Every chip's solve over its window (``_chip_solve``), results
        left on the chips' devices: {chip: ((pcap, k) original ids, (pcap,
        k) d2, (pcap,) certified), or None for a chip without points}.  No
        host sync happens here."""
        outs: Dict[int, Optional[tuple]] = {}
        with _spans.span("solve.pod.chips", ndev=self.meta.ndev):
            for d in range(len(self.chip_plans)):
                if not self.chip_plans[d].classes:
                    outs[d] = None
                    continue
                outs[d] = _chip_solve(self._chip_ready(d), self.config)
        return outs

    def solve(self, device_out=None
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The partitioned all-points solve in original indexing:
        (neighbours (n, k), d2 (n, k), certified (n,)).  One batched fetch
        reads every chip's rows; the host places them by the bucket ids it
        planned; with ``fallback='brute'`` uncertified rows are resolved by
        the host kd-tree and count as certified.  Pass ``device_out`` (a
        :meth:`solve_device` result) to skip the chip solves."""
        cfg = self.config
        n, k = self.n_points, cfg.k
        if n == 0:
            return (np.empty((0, k), np.int32),
                    np.empty((0, k), np.float32), np.empty((0,), bool))
        outs = device_out if device_out is not None else self.solve_device()
        neighbors = np.full((n, k), INVALID_ID, np.int32)
        d2 = np.full((n, k), np.inf, np.float32)
        cert = np.zeros((n,), bool)
        live = [d for d in sorted(outs) if outs[d] is not None]
        with _spans.span("solve.pod.fetch", chips=len(live)):
            fetched = dispatch.fetch(*[t for d in live for t in outs[d]])  # syncflow: pod-solve-final
        with _spans.span("solve.pod.place"):
            for j, d in enumerate(live):
                o_i, o_d, o_c = fetched[3 * j: 3 * j + 3]
                sids = self._bucket_ids_host[d]
                rows = sids >= 0
                neighbors[sids[rows]] = o_i[rows]
                d2[sids[rows]] = o_d[rows]
                cert[sids[rows]] = o_c[rows]
        self.fallback_rows = np.nonzero(~cert)[0].astype(np.int32)
        if cfg.fallback == "brute" and self.fallback_rows.size:
            with _spans.span("solve.pod.fallback",
                             rows=int(self.fallback_rows.size)):
                bad = self.fallback_rows
                b_ids, b_d2 = self._oracle().knn(
                    self._points_host[bad], k,
                    exclude_ids=bad if cfg.exclude_self else None)
                neighbors[bad] = b_ids
                d2[bad] = b_d2
                cert[bad] = True
        return neighbors, d2, cert

    # -- external queries -------------------------------------------------------

    def query(self, queries, k: Optional[int] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact kNN of (m, 3) query coordinates against the partitioned
        set.  Each query routes through the directory to the chip owning
        its supercell (``route_queries``) and rides that chip's classes
        over its window (``adaptive.query_device``): a boundary-straddling
        query's whole candidate box lies in its owner's window.  One
        batched fetch; classless and uncertified rows resolve through the
        host kd-tree.  No self-exclusion.  Returns ((m, k) ids in original
        indexing, ascending; (m, k) d2)."""
        cfg, meta = self.config, self.meta
        k = cfg.k if k is None else k
        queries = validate_or_raise(queries, k=k, what="queries")
        k = int(k)
        if k > cfg.k:
            raise InvalidKError(
                f"k={k} exceeds the prepared k={cfg.k} (it sized the "
                f"candidate dilation)")
        queries = np.ascontiguousarray(queries, np.float32)
        m = queries.shape[0]
        out_i = np.full((m, k), INVALID_ID, np.int32)
        out_d = np.full((m, k), np.inf, np.float32)
        if m == 0 or self.n_points == 0:
            return out_i, out_d
        chip, local = route_queries(self.directory, meta, queries)
        cert = np.zeros((m,), bool)
        pending = []
        for d, plan in enumerate(self.chip_plans):
            on_d = np.nonzero(chip == d)[0]
            if on_d.size == 0 or not plan.classes:
                continue  # a chip without points: the kd-tree answers
            ready = self._chip_ready(d)
            pending.append((on_d, query_device(
                ready.window, cfg, ready.plan, queries[on_d],
                plan.class_of[local[on_d]], plan.row_of[local[on_d]], k)))
        if pending:
            fetched = dispatch.fetch(*[t for _, ts in pending for t in ts])  # syncflow: pod-query-final
            for j, (rows, _) in enumerate(pending):
                out_i[rows], out_d[rows], cert[rows] = \
                    fetched[3 * j: 3 * j + 3]
        self.query_fallback_rows = np.nonzero(~cert)[0]
        if self.query_fallback_rows.size:
            bad = self.query_fallback_rows
            out_i[bad], out_d[bad] = self._oracle().knn(queries[bad], k)
        return out_i, out_d

    # -- diagnostics ------------------------------------------------------------

    def stats(self) -> dict:
        """The decomposition, the exchange and the memory stamp, as the
        reference's (host state only: no device round trip)."""
        meta = self.meta
        return {
            "n_points": self.n_points,
            "n_devices": meta.ndev,
            "grid_dim": meta.dim,
            "supercell": meta.supercell,
            "pcap": meta.pcap,
            "hcap": meta.hcap,
            "ring_depth": meta.steps,
            "halo_bytes": meta.halo_bytes(),
            **self.hbm,
            "chips": [{
                "chip": d,
                "n_points": c.n_local,
                "n_supercells": int(c.sc_ids.size),
                "remote_cells": c.remote_cells,
                "max_owner_dist": c.max_owner_dist,
                "classes": [{"radius": cp.radius, "n_supercells": cp.n_sc,
                             "qcap": cp.qcap, "ccap": cp.ccap,
                             "route": cp.route}
                            for cp in c.classes],
            } for d, c in enumerate(self.chip_plans)],
        }
