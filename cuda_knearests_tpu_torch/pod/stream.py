"""Memory auto-splitting: the per-chip footprint model and its budget gate.

Counterpart of ``cuda_knearests_tpu/pod/stream.py``.  A cloud whose
single-device footprint exceeds the budget is not refused: it is split
over the chips of the pod and staged chip by chip, and the budget gates
each chip's model instead.  Only a cloud whose share does not fit one chip
is refused, with the typed ``LaunchBudgetError`` (kind 'oom', site
'pod-prepare') and a pointer at the knob that helps (more chips).

The models describe what the port allocates on a chip's device (each an
overestimate, held against ``torch.cuda.max_memory_allocated`` on the
card by ``chip_smoke.py``):

* :func:`resident_bytes`: the staged bucket and export indices, the
  received halo blocks, the window assembled from them, its CSR, the
  ready state's per-row maps, and the epilogue's temporaries;
* :func:`class_plan_bytes`: the class plan as ``ops.adaptive._preflight``
  gates it (the (pcap + 1, k) outputs, every class's tables, each kernel
  class's pack, the streamed and 'mxu' steps at their supercells a step),
  plus the transient of building the largest pack.

A configured budget (``KnnConfig.hbm_budget_bytes`` or
``KNTPU_HBM_BUDGET_BYTES``) is per chip; the default one (a fraction of
the device's free memory) is split between the chips that share a device
(:func:`chip_budgets`).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from ..config import KnnConfig
from ..ops.adaptive import (ClassSpec, class_step_bytes, kernel_extra_bytes,
                            step_bytes, stream_step_bytes,
                            streamed_plan_bytes)
from ..ops.cuda_solve import _HBM_BUDGET_ENV, hbm_budget_bytes
from .partition import PodChipPlan, PodMeta, _refusal

# Transient bytes of building one class's kernel pack, per query and
# candidate slot: ``pack_cells``' int64 slot, search and gather
# intermediates, then the int64 indices beside the gathered coordinates.
_PACK_BUILD_SLOT_BYTES = 32
# Per (row, k) entry of the epilogue beyond the (pcap + 1, k) outputs: the
# sanitised d2 and ids, the id translation's int64 index and its result.
_EPILOGUE_ENTRY_BYTES = 24


def resident_bytes(meta: PodMeta, n_ext_cells: int, cfg: KnnConfig) -> int:
    """A chip's device bytes outside its class plan: the staged bucket
    (points, ids) and export indices, the gathered export block, the
    2 * steps received blocks, the window (points, ids) assembled from
    them, its CSR (starts, counts), the ready state's per-row maps
    (``inv_box``, ``inv_row`` under gather, certificate boxes), and the
    epilogue's temporaries and certificate."""
    pcap, hcap, k = meta.pcap, meta.hcap, cfg.k
    n_ext = meta.n_ext
    maps = 2 if cfg.resolved_epilogue() == "gather" else 1
    return (16 * pcap + 4 * hcap + 16 * hcap
            + 16 * 2 * meta.steps * hcap + 16 * n_ext
            + 8 * max(1, n_ext_cells)
            + 4 * maps * (n_ext + 1) + 25 * pcap
            + _EPILOGUE_ENTRY_BYTES * pcap * k + pcap)


def _specs(classes) -> List[ClassSpec]:
    """``SlabClass`` tables as the ``ClassSpec`` shapes ``adaptive``'s
    byte models read."""
    return [ClassSpec(rows=np.empty(c.n_sc, np.int32), radius=c.radius,
                      qcap=c.qcap, ccap=c.ccap, route=c.route)
            for c in classes]


def class_plan_bytes(specs: Sequence[ClassSpec], step_rows: Sequence,
                     cfg: KnnConfig, n: int) -> int:
    """A plan's device bytes over ``n`` rows as ``adaptive._preflight``
    counts them (``streamed_plan_bytes`` and each kernel class's pack),
    its one-supercell step reserve replaced by the largest step at the
    classes' own supercells a step (``step_rows``; None on the kernel
    route) where that is larger, and the transient of building the
    largest kernel pack."""
    if not specs:
        return 0
    k = cfg.k
    total = streamed_plan_bytes(specs, cfg, n)
    total += sum(max(kernel_extra_bytes(sp, cfg), 0) for sp in specs
                 if sp.route == "kernel")
    one = max(step_bytes(sp, k) for sp in specs)
    real = max((class_step_bytes(rows, sp.qcap, sp.ccap)
                if sp.route == "mxu"
                else stream_step_bytes(rows, sp.qcap, sp.ccap, k)
                for sp, rows in zip(specs, step_rows)
                if sp.route != "kernel"), default=0)
    build = max((sp.rows.size * (sp.qcap + sp.ccap) for sp in specs
                 if sp.route == "kernel"), default=0)
    return total + max(real - one, 0) + _PACK_BUILD_SLOT_BYTES * build


def chip_hbm_model(meta: PodMeta, chip: PodChipPlan, cfg: KnnConfig) -> int:
    """Modeled peak device bytes one chip commits to the problem
    (:func:`resident_bytes` + :func:`class_plan_bytes`); a chip without
    classes holds only its bucket and export indices."""
    if not chip.classes:
        return 20 * meta.pcap + 4 * meta.hcap
    return (resident_bytes(meta, chip.ext_starts.size, cfg)
            + class_plan_bytes(_specs(chip.classes),
                               [c.step_rows for c in chip.classes], cfg,
                               meta.pcap))


def chip_floor_bytes(meta: PodMeta, chip: PodChipPlan,
                     cfg: KnnConfig) -> int:
    """The least budget a chip's plan fits: its :func:`resident_bytes` and
    ``adaptive.streamed_plan_bytes`` (every class streamed, or 'mxu', one
    supercell a step).  Below it prepare refuses the chip; at or above it
    ``_preflight`` streams what does not fit and the chip's model stays
    within the budget."""
    if not chip.classes:
        return chip_hbm_model(meta, chip, cfg)
    return (resident_bytes(meta, chip.ext_starts.size, cfg)
            + streamed_plan_bytes(_specs(chip.classes), cfg, meta.pcap))


def full_cloud_model(n: int, k: int, cfg: Optional[KnnConfig] = None,
                     dim: int = 0, cloud_specs: Sequence = ()) -> int:
    """Modeled peak device bytes of a single-device ``KnnProblem`` of the
    whole cloud: the staged and sorted points, the permutation, the grid
    build's sort temporaries, the cell CSR, the class plan
    (:func:`class_plan_bytes` of ``cloud_specs``, else the (n + 1, k)
    outputs alone) and the epilogue's temporaries.  With only (n, k) it is
    the pre-partition estimate :func:`auto_devices` reads."""
    grid = n * (12 + 12 + 4 + 16) + 24 * dim ** 3
    if cloud_specs:
        plan = class_plan_bytes(cloud_specs, [1] * len(cloud_specs), cfg, n)
    else:
        plan = (n + 1) * k * 8 + 4 * n
    return grid + plan + _EPILOGUE_ENTRY_BYTES * n * k + n


def chip_budgets(devices: Sequence, cfg: KnnConfig) -> List[Optional[int]]:
    """Each chip's budget (None: unbounded): a configured budget applies
    to every chip as it is; the default one of a device
    (``cuda_solve.hbm_budget_bytes``) is split between the chips on it."""
    configured = (cfg.hbm_budget_bytes is not None
                  or os.environ.get(_HBM_BUDGET_ENV) is not None)
    share = {}
    for dv in devices:
        share[dv] = share.get(dv, 0) + 1
    out = []
    for dv in devices:
        b = hbm_budget_bytes(dv, cfg)
        out.append(b if b is None or configured else b // share[dv])
    return out


def preflight_pod(meta: PodMeta, chips: List[PodChipPlan], cfg: KnnConfig,
                  budgets: Sequence[Optional[int]], full: int) -> dict:
    """The auto-splitter's gate: every chip's model must fit its budget.
    Returns the stamp ``stats()`` carries: ``hbm_budget_bytes`` (the
    smallest chip budget, None: unbounded), ``hbm_high_water_bytes`` (the
    largest chip model), ``hbm_full_cloud_bytes`` (``full``) and
    ``streamed_prepare`` (the whole cloud exceeds the budget: the split was
    needed).  Raises the typed refusal when a chip's model does not fit."""
    per_chip = [chip_hbm_model(meta, c, cfg) for c in chips]
    for d, (model, b) in enumerate(zip(per_chip, budgets)):
        if b is not None and model > b:
            raise _refusal(d, meta, model, b, cfg.k)
    bounded = [b for b in budgets if b is not None]
    budget = min(bounded) if bounded else None
    return {
        "hbm_budget_bytes": budget,
        "hbm_high_water_bytes": max(per_chip) if per_chip else 0,
        "hbm_full_cloud_bytes": full,
        "streamed_prepare": bool(budget is not None and full > budget),
    }


def auto_devices(n_points: int, k: int, budget: Optional[int],
                 available: int) -> Optional[int]:
    """The splitter's chip count for ``n_devices=None``: the smallest whose
    even share of the cloud fits ``budget`` twice over (an estimate before
    partitioning; :func:`preflight_pod` then gates the real models).  None
    without a budget."""
    if budget is None:
        return None
    for ndev in range(1, available + 1):
        if full_cloud_model(-(-n_points // ndev), k) * 2 <= budget:
            return ndev
    return available
