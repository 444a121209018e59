"""Diagnostics of a prepared problem: grid occupancy, the plan, the
certificate margins and device memory, as a dict.

Counterpart of ``cuda_knearests_tpu/utils/stats.py``, with the same keys:
numpy over arrays fetched from the device.  The occupancy histogram and the
per-query achieved margin (k-th distance over the certificate margin)
stand in for the reference kernel's min/max/avg points per cell and its
"max visited ring".
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch


def device_nbytes(tree) -> int:
    """Bytes of every distinct torch tensor in a nest of dataclasses,
    tuples, lists and dicts (host numpy arrays are not counted)."""
    seen, total, stack = set(), 0, [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if id(x) not in seen:
                seen.add(id(x))
                total += x.numel() * x.element_size()
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            stack.extend(getattr(x, f.name) for f in dataclasses.fields(x))
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return total


def occupancy_stats(cell_counts: np.ndarray) -> Dict[str, Any]:
    """Points per grid cell: min, max, mean and the full histogram."""
    counts = np.asarray(cell_counts)
    vals, freq = np.unique(counts, return_counts=True)
    return {
        "num_cells": int(counts.size),
        "num_points": int(counts.sum()),
        "min_per_cell": int(counts.min()) if counts.size else 0,
        "max_per_cell": int(counts.max()) if counts.size else 0,
        "avg_per_cell": float(counts.mean()) if counts.size else 0.0,
        "histogram": {int(v): int(f) for v, f in zip(vals, freq)},
    }


def _margin_sq_np(q: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                  domain: float) -> np.ndarray:
    """Squared margin from each (n, 3) query row to the complement of its
    dilated box (numpy twin of ``ops.solve._margin_sq``)."""
    with np.errstate(invalid="ignore"):
        m_lo = np.where(lo <= 0.0, np.inf, q - lo)
        m_hi = np.where(hi >= domain, np.inf, hi - q)
        m = np.maximum(np.minimum(m_lo, m_hi).min(axis=-1), 0.0)
    return np.where(np.isinf(m), np.inf, m * m)


def margin_summary(kth_sq: np.ndarray, margin_sq: np.ndarray
                   ) -> Dict[str, Any]:
    """Per-query ratio of the k-th distance to the certificate margin
    (both from squares, in float64: near 1 the ratio decides whether a row
    could certify).  Below 1 the row's k-th neighbour used that fraction
    of its margin; at or above 1 ('decertified') the grid route could
    never have certified it.  An infinite margin counts as 0."""
    kth = np.asarray(kth_sq, np.float64)  # kntpu-ok: wide-dtype -- f64 certificate telemetry (see above)
    msq = np.asarray(margin_sq, np.float64)  # kntpu-ok: wide-dtype -- f64 certificate telemetry (see above)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.sqrt(kth / msq)
    ratio = np.where(np.isinf(msq), 0.0, ratio)
    ratio = np.where(np.isnan(ratio), 1.0, ratio)
    n = ratio.size
    if n == 0:
        return {"n": 0}
    edges = np.linspace(0.0, 1.0, 11)
    hist = np.histogram(ratio[ratio < 1.0], bins=edges)[0]
    return {
        "n": int(n),
        "mean": float(np.mean(np.minimum(ratio, 1.0))),
        "p50": float(np.percentile(ratio, 50)),
        "p90": float(np.percentile(ratio, 90)),
        "p99": float(np.percentile(ratio, 99)),
        "max": float(ratio.max()),
        "histogram": {f"{edges[i]:.1f}-{edges[i + 1]:.1f}": int(hist[i])
                      for i in range(10)},
        "decertified": int((ratio >= 1.0).sum()),
    }


def problem_margins(problem):
    """The achieved-margin summary of a solved problem, from the boxes its
    certificate used (the adaptive classes through ``inv_box``, or the
    legacy pack through ``inv_sc``); None without a result or boxes (the
    oracle and the legacy scan keep none)."""
    if problem.result is None:
        return None
    aplan, pack = problem.aplan, problem.pack
    if aplan is not None:
        lo = torch.cat([cp.lo for cp in aplan.classes]).cpu().numpy()
        hi = torch.cat([cp.hi for cp in aplan.classes]).cpu().numpy()
        inv = aplan.inv_box.cpu().numpy()
    elif pack is not None:
        lo, hi = pack.lo.cpu().numpy(), pack.hi.cpu().numpy()
        inv = pack.inv_sc.cpu().numpy()
    else:
        return None
    kth = np.asarray(problem.result.dists_sq)[:, -1]
    msq = _margin_sq_np(problem.grid.points.cpu().numpy(), lo[inv], hi[inv],
                        problem.grid.domain)
    return margin_summary(kth, msq)


def problem_stats(problem) -> Dict[str, Any]:
    """Statistics of a prepared problem (the solved fields once solved):
    the grid, the plan (the adaptive classes, or the legacy schedule's
    (qcap, ccap) and chunks), device bytes, and after a solve the
    certified fraction and the margin summary."""
    grid, cfg, aplan = problem.grid, problem.config, problem.aplan
    out: Dict[str, Any] = {
        "n_points": grid.n_points,
        "grid_dim": grid.dim,
        "k": cfg.k,
        "ring_radius": cfg.resolved_ring_radius(),
        "supercell": cfg.supercell,
        "occupancy": occupancy_stats(grid.cell_counts.cpu().numpy()),
        "device_bytes": device_nbytes((grid, problem.plan, aplan,
                                       problem.pack)),
    }
    if aplan is not None:
        classes = [{"radius": cp.radius, "n_supercells": cp.n_sc,
                    "qcap": cp.qcap, "ccap": cp.ccap, "route": cp.route,
                    "use_pallas": cp.route == "kernel"}
                   for cp in aplan.classes]
        out["plan"] = {"adaptive": True, "n_classes": len(classes),
                       "qcap": max(c["qcap"] for c in classes),
                       "ccap": max(c["ccap"] for c in classes),
                       "classes": classes}
    elif problem.plan is not None:
        out["plan"] = {"qcap": problem.plan.qcap, "ccap": problem.plan.ccap,
                       "n_supercell_chunks": problem.plan.n_chunks,
                       "chunk_batch": problem.plan.batch}
    if problem.result is not None:
        cert = np.asarray(problem.result.certified)
        out["certified_fraction"] = float(cert.mean()) if cert.size else 1.0
        out["uncertified"] = int((~cert).sum())
        margins = problem_margins(problem)
        if margins is not None:
            out["margin"] = margins
    return out


def print_stats(problem) -> Dict[str, Any]:
    """Print :func:`problem_stats` for a person; returns the dict."""
    s = problem_stats(problem)
    occ = s["occupancy"]
    print(f"grid {s['grid_dim']}^3, {s['n_points']} points, k={s['k']}, "
          f"ring_radius={s['ring_radius']}, supercell={s['supercell']}^3")
    print(f"points per cell: min {occ['min_per_cell']} / "
          f"avg {occ['avg_per_cell']:.2f} / max {occ['max_per_cell']}")
    for v in sorted(occ["histogram"]):
        print(f"  cells with {v:3d} points: {occ['histogram'][v]}")
    plan = s.get("plan")
    if plan is not None and plan.get("adaptive"):
        print(f"adaptive schedule: {plan['n_classes']} capacity classes "
              f"(max qcap {plan['qcap']}, max ccap {plan['ccap']})")
        for c in plan["classes"]:
            print(f"  class r={c['radius']}: {c['n_supercells']} supercells, "
                  f"qcap {c['qcap']}, ccap {c['ccap']} [{c['route']}]")
    elif plan is not None:
        print(f"schedule: qcap {plan['qcap']}, ccap {plan['ccap']}, "
              f"{plan['n_supercell_chunks']} chunks x {plan['chunk_batch']}")
    if "certified_fraction" in s:
        print(f"certified: {100.0 * s['certified_fraction']:.4f}% "
              f"({s['uncertified']} fallback queries)")
    if "margin" in s and s["margin"].get("n"):
        m = s["margin"]
        print(f"achieved margin ratio (kth_dist/margin; 1.0 = decertify): "
              f"p50 {m['p50']:.3f}, p90 {m['p90']:.3f}, p99 {m['p99']:.3f}, "
              f"max {m['max']:.3f}; {m['decertified']} decertified")
    print(f"device memory: {s['device_bytes'] / 1e6:.1f} MB")
    return s
