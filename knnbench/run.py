"""One run of one cell: set-up, an optional traced window, the measured
window, the check, and the result line.

The window drives ``KnnProblem.solve()`` on a prepared problem in a closed
loop: one client calls the next solve when the last one's (n, k) ids and
distances are on the host.  Each solve keeps a few of its rows, drawn
from the seed; once the window has closed, the peak memory has been read
and the program's state is freed, the plain reference judges them
(``compare.py``).  Standard output's last line is the result; standard
error's last lines are the numbers compared, each beside its limit.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time
import traceback
from typing import Callable, List, Optional

import numpy as np

from . import compare, generate
from . import spec as _spec
from . import trace as _trace
from .context import RunContext
from .metrics import read_metrics

PROGRAM = "cuda_knearests_tpu_torch"
#: Top-level modules the process must not hold once the window has
#: closed: JAX and the JAX package (compared whole: the port's name
#: begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "cuda_knearests_tpu")


def err(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def isolate_env(root) -> None:
    """The port at its defaults, with its caches at fixed paths inside
    the checkout: no tuned-plan store, memory budget or trace spill from
    the environment."""
    for key in [k for k in os.environ if k.startswith("KNTPU_")]:
        del os.environ[key]
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(
        root, "build", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "build", "triton")


def run(cell: _spec.Cell, seed: int, seconds: float, trace: bool,
        device: str = "cuda", n_points: Optional[int] = None,
        t_main: Optional[float] = None, t_torch: Optional[float] = None,
        log: Callable[..., None] = err) -> dict:
    """One run of ``cell``; returns the result line as a dict.
    ``n_points`` replaces the configuration's n (the CPU tests' size);
    ``t_main`` is the ``perf_counter`` reading that set-up counts from:
    the entry module's first statement, before any import; ``t_torch``
    the one once torch was imported."""
    import torch

    import cuda_knearests_tpu_torch as program
    from cuda_knearests_tpu_torch.obs import spans
    from cuda_knearests_tpu_torch.runtime import dispatch

    t_main = time.perf_counter() if t_main is None else t_main
    cfg, traffic = cell.config, cell.traffic
    n = int(n_points or cfg["n_points"])
    k, d = int(cfg["k"]), int(cfg["d"])
    cuda = torch.device(device).type == "cuda"

    marks = ([("torch", t_torch)] if t_torch is not None else []) + [
        ("program", time.perf_counter())]
    pts = generate.make_cloud(traffic, n, seed, cfg["domain"])
    marks.append(("cloud", time.perf_counter()))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    marks.append(("device", time.perf_counter()))
    with spans.capture() as prep_spans:
        problem = program.KnnProblem.prepare(
            pts, program.KnnConfig(**cfg["knn_config"]), device=device)
    marks.append(("prepare", time.perf_counter()))
    for _ in range(int(traffic["warmup_solves"])):
        problem.solve()
    marks.append(("warm-up", time.perf_counter()))
    log("set-up: " + ", ".join(f"{name} {m - t:.3f} s"
                              for (name, m), t in zip(
                                  marks, [t_main] + [m for _, m in marks])))
    cap = None
    if trace:
        cap = _trace.capture(problem.solve, int(traffic["trace_solves"]),
                             cuda, spans)

    sampler = generate.RowSampler(seed, n, traffic["check_rows_per_solve"])
    lat: List[float] = []
    kept: List[tuple] = []
    attempted = failed = fallback_rows = 0
    syncs0 = dispatch.stats().host_syncs
    # a traced run, which reports no end-to-end metric, also keeps the
    # port's spans of its window (``metrics/host_launch_ms.py``)
    window = spans.capture() if trace else contextlib.nullcontext([])
    t_first = time.perf_counter()
    setup_s = t_first - t_main
    deadline = t_first + float(seconds)
    t_last = t_first
    with window as window_spans:
        while time.perf_counter() < deadline:
            attempted += 1
            t0 = time.perf_counter()
            try:
                res = problem.solve()
            except Exception:  # noqa: BLE001 -- a failed solve is counted and the window goes on
                failed += 1
                if failed == 1:
                    log(traceback.format_exc())
                continue
            t_last = time.perf_counter()
            lat.append(t_last - t0)
            rows = sampler.next()
            kept.append((rows, res.neighbors[rows], res.dists_sq[rows],
                         res.certified[rows]))
            fallback_rows += int(res.uncert_count)
            del res
    elapsed = t_last - t_first
    syncs1 = dispatch.stats().host_syncs
    peak = int(torch.cuda.max_memory_allocated()) if cuda else None
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    perm = problem.grid.permutation.cpu().numpy()
    del problem
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    pick = sampler.subsample(len(kept) * sampler.per_solve,
                             int(traffic["check_rows_max"]))
    if kept:
        rows, ids, d2, cert = (np.concatenate([r[i] for r in kept])[pick]
                               for i in range(4))
        checks = compare.judge(torch.as_tensor(pts, device=device), perm,
                               rows, ids, d2, cert, k, failed)
    else:
        checks = {name: {"value": 0, "limit": lim}
                  for name, lim in compare.LIMITS.items()}
        checks["failed_solves"]["value"] = failed
    rows_checked = int(len(pick)) if kept else 0
    if lat:
        ms = np.asarray(lat) * 1e3
        log(f"window: {len(lat)} solves in {elapsed:.6f} s; latency median "
            f"{np.median(ms):.6f} ms, p95 {np.percentile(ms, 95):.6f} ms; "
            f"{fallback_rows} rows to the exact fallback; reference "
            f"{time.perf_counter() - t_ref:.3f} s on {rows_checked} rows")

    ctx = RunContext(
        n=n, k=k, d=d, device_kind=kind, setup_s=setup_s, latencies_s=lat,
        solves=len(lat), elapsed_s=elapsed, peak_mem_bytes=peak,
        counters={"host_syncs": syncs1 - syncs0,
                  "fallback_rows": fallback_rows},
        prepare_spans=list(prep_spans), window_spans=list(window_spans),
        capture=cap)
    out = {"correct": compare.is_correct(checks, rows_checked),
           "attempted": attempted, "failed": failed,
           "metrics": read_metrics(cell.per_layer if trace
                                   else cell.end_to_end, ctx),
           "device": {"platform": "gpu" if cuda else "cpu", "kind": kind,
                      "count": cell.chips if cuda else 0,
                      "memory_peak_bytes": peak}}
    if cap is not None:
        out["device"]["busy_s"] = cap.busy_s()
        out["device"]["window_s"] = cap.window_s
        if cap.dropped():
            log(f"trace: the profiler dropped {cap.dropped()} device "
                f"events; the device metrics are left out")
        out["breakdown"] = cap.breakdown()
    out["checks"] = {"rows_checked": {"value": rows_checked, "least": 1},
                     **checks}
    return out


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m knnbench",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t_main: Optional[float] = None) -> int:
    t_main = time.perf_counter() if t_main is None else t_main
    args = parse(argv)
    try:
        cell = _spec.cell(_spec.load_benchmark(), args.workload)
    except _spec.SpecError as e:
        err(f"knnbench: {e}")
        return 2
    isolate_env(str(_spec.ROOT))
    import torch

    t_torch = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        err(f"knnbench: {args.workload} needs {cell.chips} CUDA device(s); "
            f"this machine has {torch.cuda.device_count()} "
            f"(available: {torch.cuda.is_available()}); no result")
        return 4
    try:
        result = run(cell, args.seed, args.seconds, bool(args.trace),
                     device="cuda", t_main=t_main, t_torch=t_torch)
    except ModuleNotFoundError as e:
        if e.name is None or e.name.split(".")[0] != PROGRAM:
            raise
        err(f"knnbench: the program under test ({PROGRAM}) is not in the "
            f"checkout: {e}; no result")
        return 3
    bad = forbidden_modules()
    if bad:
        err(f"knnbench: the process holds {bad} after the window (JAX or "
            f"the JAX package); no result")
        return 5
    checks = result["checks"]
    for line in compare.lines({k: v for k, v in checks.items()
                               if k != "rows_checked"},
                              checks["rows_checked"]["value"]):
        err(line)
    print(json.dumps(result), flush=True)
    return 0
