"""``python -m cuda_knearests_tpu_torch.obs`` -- the observability smoke.

Counterpart of ``cuda_knearests_tpu/obs/__main__.py``.  Runs on the card
unless ``--device cpu`` is given (no card and no ``--device``: rc 4, a
``no-device`` line).  Staged (``--stage all|host|device``):

1. **Trace capture** (host stage): prepare, solve and query a uniform
   cloud of ``--n`` points with tracing on (collector + per-process jsonl
   spill), then VALIDATE -- every event passes the schema check, the
   instrumented seams all appear (``knn.prepare`` / ``knn.solve`` /
   ``knn.query`` / ``dispatch.fetch``), and the fetch spans nest INSIDE
   the solve's span tree (depth > 0).
2. **Disabled-overhead bound** (host stage): the measured cost of one
   disabled ``span()`` call, times the spans one traced run emits, must
   stay under ``--overhead-pct`` (default 2%) of the measured solve.
3. **Device capture round trip** (device stage): one warm solve under
   ``torch.profiler`` through ``obs/device.profile_window``: at least one
   exec event, every one attributed to a host span (zero unattributed),
   the measured-memory verdict true against the engine's own model, the
   mounted device events schema-valid and exported into the SAME merged
   timeline as the host spans, a ``kntpu:*`` scope in the decomposition,
   and on the card at least one ``supercell_topk`` kernel event.  The
   capture-off fast path is bounded under ``--overhead-pct`` of the
   captured window.
4. **Artifacts**: the merged host+device Chrome trace (Perfetto-loadable)
   and one metrics snapshot line land in ``--out-dir``.

Exit 0 iff every check passes; one JSON summary line either way.
``KNTPU_OBS_N`` sets the default size.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional


def _overhead_per_call_s(calls: int = 200_000) -> float:
    """Measured cost of one DISABLED span() call (enter+exit included)."""
    from . import spans as _spans

    assert not _spans.enabled()
    t0 = time.perf_counter()
    for _ in range(calls):
        with _spans.span("overhead.probe"):
            pass
    return (time.perf_counter() - t0) / calls


def _capture_disabled_cost_s(calls: int = 200_000) -> float:
    """Measured cost of the capture-off fast path (the only thing a bench
    row pays when BENCH_DEVICE_CAPTURE=0): one environment check."""
    from . import device as _device

    t0 = time.perf_counter()
    for _ in range(calls):
        _device.bench_capture_enabled()
    return (time.perf_counter() - t0) / calls


def _device_stage(args, points, device, summary: dict,
                  failures: List[str]) -> None:
    """The capture round trip: one warm solve under the profiler,
    attributed, memory reconciled, the device lane mounted into the
    export directory, and the capture-off cost bounded."""
    from .. import KnnConfig, KnnProblem
    from . import attribution as _attr
    from . import device as _device
    from . import spans as _spans

    problem = KnnProblem.prepare(points, KnnConfig(k=8), device=device)
    problem.solve()  # warm-up: the capture measures a steady-state solve
    try:
        report = _device.profile_window(
            problem.solve, trace_id="obs-smoke", device=device,
            hbm_model_bytes=_device.problem_hbm_model(problem))
    except Exception as e:  # noqa: BLE001 -- the smoke's verdict IS the failure list
        failures.append(f"device capture failed: {type(e).__name__}: {e}")
        return
    dec = report.decomposition
    summary.update(
        device_events=len(report.attributed),
        device_unattributed=len(report.unattributed),
        device_outside_window=report.outside_window,
        device_joined_by_correlation=dec["joined_by_correlation"],
        device_total_ms=dec["device_total_ms"],
        device_by_module=dec["by_module"],
        hbm_model_ok=report.hbm["hbm_model_ok"],
        hbm_measured_source=report.hbm["hbm_measured_source"],
        hbm_window_delta_bytes=report.hbm["hbm_window_delta_bytes"],
        hbm_model_bytes=report.hbm["hbm_model_bytes"])
    if not report.attributed:
        failures.append("device capture attributed zero exec events (the "
                        "profiler recorded nothing)")
    if report.unattributed:
        failures.append(
            f"{len(report.unattributed)} device events attributed to NO "
            f"host span (first: {report.unattributed[0].name!r})")
    if report.hbm["hbm_model_ok"] is not True:
        failures.append(f"hbm_model_ok failed: {report.hbm}")
    mounted_bad = [ev for ev in report.mounted
                   if _spans.validate_event(ev) is not None]
    if mounted_bad:
        failures.append(f"{len(mounted_bad)} mounted device events "
                        f"violate the span schema")
    scopes = set(dec["by_scope"])
    if not any(s.startswith(_attr.SCOPE_PREFIX) for s in scopes):
        failures.append(f"no kntpu:* named scope in the decomposition "
                        f"(got {sorted(scopes)})")
    if device.type == "cuda":
        n_topk = sum(a.event.module == "supercell_topk"
                     for a in report.attributed)
        summary["device_supercell_topk_events"] = n_topk
        if not n_topk:
            failures.append(f"no supercell_topk kernel event attributed "
                            f"(modules {sorted(dec['by_module'])})")
    # the device lane joins the SAME merged timeline as the host spans
    _attr.write_spill(report.mounted, os.path.join(
        args.out_dir, f"trace_obs-device_{os.getpid()}.jsonl"))
    # capture-off fast-path bound; denominator: the captured window's own
    # measured duration (the umbrella span)
    window = [e for e in report.host_events
              if e.get("name") == _device.WINDOW_SPAN]
    solve_s = (window[0]["dur_ms"] / 1e3 if window else 0.0)
    if solve_s <= 0:
        failures.append("capture window span missing from the host "
                        "events: no denominator for the overhead bound")
        return
    per_call = _capture_disabled_cost_s()
    off_pct = 100.0 * per_call / solve_s
    summary.update(device_window_s=round(solve_s, 4),
                   capture_off_ns_per_check=round(per_call * 1e9, 1),
                   capture_off_overhead_pct=round(off_pct, 6))
    if off_pct >= args.overhead_pct:
        failures.append(f"capture-off overhead {off_pct:.4f}% >= "
                        f"{args.overhead_pct}% bound")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cuda_knearests_tpu_torch.obs",
        description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", default="obs_artifacts",
                    help="artifact directory (merged trace + metrics "
                         "snapshot; default ./obs_artifacts)")
    ap.add_argument("--n", type=int,
                    default=int(os.environ.get("KNTPU_OBS_N", "20000")),
                    help="fixture size (default 20000; KNTPU_OBS_N "
                         "overrides)")
    ap.add_argument("--overhead-pct", type=float, default=2.0,
                    help="disabled-mode overhead bound, percent of one "
                         "solve (default 2.0)")
    ap.add_argument("--stage", choices=("all", "host", "device"),
                    default="all", help="which smoke stages to run")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run "
                         "on the CPU)")
    args = ap.parse_args(argv)

    from ..utils.memory import NoDeviceError
    from ..utils.platform import resolve_device

    summary: dict = {"config": "obs smoke", "n": args.n}
    try:
        device = resolve_device(args.device)
    except NoDeviceError as e:
        summary.update(ok=False, error=str(e), failure_kind=e.kind)
        print(json.dumps(summary), flush=True)
        return 4
    summary["device"] = str(device)

    from .. import KnnConfig, KnnProblem
    from ..io import generate_uniform
    from . import export as _export
    from . import metrics as _metrics
    from . import spans as _spans

    os.makedirs(args.out_dir, exist_ok=True)
    _spans.set_process_tag("obs-smoke")
    failures: List[str] = []

    points = generate_uniform(args.n, seed=5)
    queries = generate_uniform(max(256, args.n // 16), seed=6)

    if args.stage in ("all", "host"):
        # 1. traced run: collector + spill, then schema/seam validation
        sink = _spans.start_file_trace(os.path.join(
            args.out_dir, f"trace_obs-smoke_{os.getpid()}.jsonl"))
        with _spans.capture() as events:
            problem = KnnProblem.prepare(points, KnnConfig(k=8),
                                         device=device)
            problem.solve()
            problem.query(queries)
        sink.close()
        bad = [(ev.get("name"), why) for ev in events
               if (why := _spans.validate_event(ev)) is not None]
        if bad:
            failures.append(f"schema violations: {bad[:5]}")
        names = {ev["name"] for ev in events}
        for need in ("knn.prepare", "knn.solve", "knn.query",
                     "dispatch.fetch"):
            if need not in names:
                failures.append(f"missing expected span {need!r}")
        if not [ev for ev in events
                if ev["name"] == "dispatch.fetch" and ev["depth"] > 0]:
            failures.append("dispatch.fetch spans did not nest inside the "
                            "solve span tree")
        summary["events"] = len(events)
        solve_events = [ev for ev in events if ev["name"] == "knn.solve"]
        solve_s = (solve_events[0]["dur_ms"] / 1e3 if solve_events else 0.0)

        # 2. disabled-overhead bound (the near-zero-cost contract)
        spans_per_solve = len(events)
        per_call = _overhead_per_call_s()
        overhead_pct = (100.0 * spans_per_solve * per_call / solve_s
                        if solve_s > 0 else 0.0)
        summary.update(spans_per_solve=spans_per_solve,
                       disabled_ns_per_span=round(per_call * 1e9, 1),
                       solve_s=round(solve_s, 4),
                       disabled_overhead_pct=round(overhead_pct, 4))
        if overhead_pct >= args.overhead_pct:
            failures.append(
                f"disabled-mode overhead {overhead_pct:.3f}% >= "
                f"{args.overhead_pct}% bound")

        # 3. metrics registry sanity + snapshot artifact
        _metrics.REGISTRY.counter("obs.smoke_runs").inc()
        hist = _metrics.Histogram("obs.probe_ms")
        for v in (1.0, 2.0, 4.0, 8.0):
            hist.observe(v)
        if hist.snapshot()["count"] != 4 or hist.percentile(0.5) is None:
            failures.append("histogram self-check failed")
        snap = _metrics.metrics_snapshot()
        for key in ("v", "ts", "counters", "histograms", "dispatch",
                    "kernels"):
            if key not in snap:
                failures.append(f"metrics snapshot missing {key!r}")
        with open(os.path.join(args.out_dir, "metrics.jsonl"), "a",
                  encoding="utf-8") as f:
            f.write(json.dumps(snap) + "\n")

    if args.stage in ("all", "device"):
        _device_stage(args, points, device, summary, failures)

    # 4. merged Perfetto trace artifact
    merged = os.path.join(args.out_dir, "trace_merged.json")
    exp = _export.export_dir(args.out_dir, merged)
    summary["trace_events"] = exp["events"]
    if exp["events"] == 0:
        failures.append("merged trace is empty")
    with open(merged, encoding="utf-8") as f:
        if not json.load(f).get("traceEvents"):
            failures.append("merged trace has no traceEvents")

    summary["ok"] = not failures
    if failures:
        summary["failures"] = failures
    print(json.dumps(summary), flush=True)
    return 0 if not failures else 1


if __name__ == "__main__":
    sys.exit(main())
