"""The measured-cost plan searcher.

Counterpart of ``cuda_knearests_tpu/tune/search.py``.

Objective law: a candidate plan's cost is what the hardware spends on one
solve of the problem -- DEVICE time (``obs.device.profile_window``'s
attributed ``device_total_ms``) when a profiler capture is requested and
succeeds, WALL time otherwise; which one measured is stamped on every row
(``objective_source``), and a capture that fell back to wall time says
why (``device_capture_skipped``).  Wall time is the min over ``repeats``
iterations after an untimed warm-up; a solve returns host-resident
results, so the timer needs no synchronization of its own.  The race is
ranked by the rows' own objective when every row measured the same one;
when some captures were refused and others not, device and wall seconds
are not comparable, so every row is ranked by its wall time and the
winner is stamped ``objective_source='wall'`` (:func:`_pick_winner`).

Search space: ``scorer`` x ``precision`` x ``query_chunk`` on the brute
route (``mxu.solve_general``), plus the exact elementwise baseline at
``recall_target`` 1.0.  The fold's block count and per-block m ride
``recall_target``; the store's schema and the ``config.resolve_tuned``
seam also carry ``epilogue`` (``store.RESOLVABLE_KEYS``), which the
search leaves to its default.

Sync discipline: each trial iteration (:func:`_run_trial`, the sync
window 'tune-trial') is ONE ``solve_general`` call, within
``dispatch.SYNC_BUDGET`` host round trips, re-asserted per trial from the
dispatch counters (``sync_bound_ok`` on every row).

Every entry runs on the GPU unless ``device='cpu'`` is passed; on the
card an 'mxu' trial launches the tier's selection kernel
(``csrc/mxu_select.cu`` at f32, ``csrc/mxu_select_bf16.cu`` at bf16).
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np

from ..runtime import dispatch as _dispatch
from . import store as _store

#: query_chunk candidates (None = one selection launch); 8-aligned.
_QUERY_CHUNKS = (None, 128, 512)


def candidate_plans(recall_target: float,
                    budget: Optional[int] = None) -> List[dict]:
    """The plan space, cheapest-to-build first: the MXU engine at every
    precision tier across query-chunk candidates, plus the elementwise
    engine as the exact baseline where it is admissible (recall_target
    1.0 -- it cannot honour an approximation budget).  ``budget``
    truncates (>= 1 kept)."""
    plans: List[dict] = []
    for precision in ("f32", "bf16"):
        for qc in _QUERY_CHUNKS:
            plan = {"scorer": "mxu", "precision": precision}
            if qc:
                plan["query_chunk"] = qc
            plans.append(plan)
    if float(recall_target) >= 1.0:
        plans.append({"scorer": "elementwise", "precision": "f32"})
    if budget is not None:
        plans = plans[: max(1, int(budget))]
    return plans


def _run_trial(points: np.ndarray, k: int, recall_target: float,
               plan: dict, interpret: bool = False, *,
               device=None) -> Tuple[object, float, int]:
    """One measured trial iteration: ONE brute-route solve of the problem
    under ``plan``'s knobs on ``device``, timed end to end, with the
    dispatch sync counters read back for the per-trial budget check.

    This is the sync window 'tune-trial': what the trial moves across the
    host boundary is ``solve_general``'s own (1 + fallback fetches).
    Resetting the process counters makes the window a measurement, with
    ``dispatch.reset_stats``'s single-threaded caveat.  Exact problems
    (recall_target >= 1.0) time the refined answer; approximate ones time
    ``refine='none'``."""
    from ..mxu.solve import solve_general

    refine = "brute" if float(recall_target) >= 1.0 else "none"
    _dispatch.reset_stats()
    t0 = time.perf_counter()
    res = solve_general(points, k=int(k),
                        recall_target=float(recall_target), refine=refine,
                        interpret=interpret,
                        scorer=plan.get("scorer", "mxu"),
                        precision=plan.get("precision", "auto"),
                        query_chunk=plan.get("query_chunk"), device=device)
    wall = time.perf_counter() - t0
    return res, wall, _dispatch.stats().host_syncs


def measure_plan(points: np.ndarray, k: int, recall_target: float,
                 plan: dict, repeats: int = 3, interpret: bool = False,
                 capture: bool = False, *, device=None) -> dict:
    """Measure one candidate plan on ``device``: a warm-up iteration
    (kernel build and load, untimed), ``repeats`` timed iterations (min
    wall), and -- with ``capture`` -- one captured iteration whose
    attributed device time replaces the objective
    (``objective_source='device'``).  A refused capture (another session
    active, an incomplete trace, BENCH_DEVICE_CAPTURE=0, no device time)
    keeps the wall objective and stamps the reason in
    ``device_capture_skipped``; nothing else falls back."""
    res, _, _ = _run_trial(points, k, recall_target, plan, interpret,
                           device=device)
    walls: List[float] = []
    syncs_max = 0
    for _ in range(max(1, int(repeats))):
        res, wall, syncs = _run_trial(points, k, recall_target, plan,
                                      interpret, device=device)
        walls.append(wall)
        syncs_max = max(syncs_max, syncs)
    row = dict(plan)
    row.update(
        wall_s=min(walls), objective_s=min(walls),
        objective_source="wall", syncs_per_trial_max=syncs_max,
        sync_bound_ok=syncs_max <= _dispatch.SYNC_BUDGET,
        backend=res.backend, bound=res.bound,
        uncert_count=int(res.uncert_count),
        precision=res.precision)  # the tier that RAN (resolved, not asked)
    if capture:
        from ..obs import device as _device

        if not _device.bench_capture_enabled():
            row["device_capture_skipped"] = "BENCH_DEVICE_CAPTURE=0"
        else:
            try:
                rep = _device.profile_window(
                    lambda: _run_trial(points, k, recall_target, plan,
                                       interpret, device=device)[0],
                    device=device)
                dev_ms = rep.decomposition.get("device_total_ms")
                if dev_ms:
                    row.update(objective_s=float(dev_ms) / 1e3,
                               objective_source="device",
                               device_total_ms=float(dev_ms))
                else:
                    row["device_capture_skipped"] = (
                        "the capture recorded no device time")
            except _device.CaptureError as e:
                row["device_capture_skipped"] = str(e)[:200]
    return row


def _pick_winner(rows: List[dict]) -> Tuple[dict, float, str]:
    """The winning row of a race, with the objective it won on:
    ``(row, objective_s, objective_source)``.  Rows that all measured the
    same objective are ranked by it; a race that mixes device and wall
    rows (a refused capture) is ranked by every row's ``wall_s``."""
    if len({r["objective_source"] for r in rows}) == 1:
        best = min(rows, key=lambda r: r["objective_s"])
        return best, best["objective_s"], best["objective_source"]
    best = min(rows, key=lambda r: r["wall_s"])
    return best, best["wall_s"], "wall"


def search(points: np.ndarray, k: int = 10, recall_target: float = 1.0,
           device_kind: Optional[str] = None,
           budget: Optional[int] = None, repeats: int = 3,
           interpret: bool = False, capture: bool = False,
           store: Optional[_store.TunedPlanStore] = None,
           force: bool = False, *, device=None
           ) -> Tuple[dict, List[dict], dict]:
    """Race the plan space for one problem signature on ``device``
    (default: the GPU) and persist the winner.  Returns ``(winner, rows,
    meta)``: the winning plan with its objective provenance, every
    measured trial row, and the search metadata (``searched`` = plans
    raced, 0 on a store hit).  The store key is ``(device_key(device_kind,
    device=device), plan_signature(n, d, k, recall_target))``.

    A stored plan for this key short-circuits the race unless ``force``:
    the second run re-searches nothing.  ``interpret=True`` is refused as
    ``solve_general`` refuses it (``InvalidConfigError``), store hit or
    not."""
    from ..mxu.solve import check_interpret
    from ..utils.platform import resolve_device

    check_interpret(interpret)
    device = resolve_device(device)
    points = np.ascontiguousarray(points, dtype=np.float32)
    n, d = points.shape
    sig = _store.plan_signature(n, d, k, recall_target)
    dev = _store.device_key(device_kind, device=device)
    st = store if store is not None else _store.active_store()
    if st is not None and not force:
        cached = st.lookup(sig, dev)
        if cached is not None:
            meta = {"signature": sig, "device_kind": dev, "searched": 0,
                    "store_hit": True}
            return dict(cached), [], meta
    rows = [measure_plan(points, k, recall_target, plan, repeats=repeats,
                         interpret=interpret, capture=capture, device=device)
            for plan in candidate_plans(recall_target, budget)]
    best, objective_s, source = _pick_winner(rows)
    winner = {kk: best[kk] for kk in _store.RESOLVABLE_KEYS if kk in best}
    winner.update(objective_s=objective_s, objective_source=source,
                  sync_bound_ok=best["sync_bound_ok"],
                  signature=sig, device_kind=dev, schema=_store.SCHEMA)
    if st is not None:
        st.record(sig, dev, winner)
    meta = {"signature": sig, "device_kind": dev, "searched": len(rows),
            "store_hit": False}
    return winner, rows, meta
