"""End-to-end differential run: the port's ``test_knearests``.

Counterpart of ``cuda_knearests_tpu/cli.py``, after the CUDA reference's
``test_knearests.cu:117-235``: load an ``.xyz`` point cloud (normalizing it
into the engine's domain), dump the device properties, run the all-points
kNN on the card (timed, the first solve's kernel loads split out), check
the permutation and duplicate invariants, run the exact host kd-tree
(timed), and compare the two per point.  Differences by design: k and the
other knobs are flags, the comparison is tie-aware (exact f32 ties accept
either id), a recall@k summary is printed for machine consumption, and
``--sharded N`` runs the multi-slab path the reference does not have;
``--capture`` adds one solve captured by ``obs.device.profile_window`` and
the timed solve's roofline.

It runs on the card unless ``--device cpu`` is given; with no card and no
``--device`` it exits rc 4 (``failure_kind: "no-device"``), never falling
back to the CPU.  Exit codes: 0 success, 1 a hard mismatch against the
kd-tree (or a failed serving request), 4 a classified device error, 5 an
input-contract refusal (bad file, NaN coordinates, illegal k).  A path
that does not exist is looked up as a dataset by its file name
(``io.get_dataset``: the checkout's ``data/`` when there, else
regenerated from its seed).

Usage:
    python -m cuda_knearests_tpu_torch.cli data/900k_blue_cube.xyz --k 10
    python -m cuda_knearests_tpu_torch.cli pts20K.xyz --k 10 --device cpu
    python -m cuda_knearests_tpu_torch.cli 900k_blue_cube.xyz --sharded 4
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch


def set_recall(got: np.ndarray, ref_ids: np.ndarray) -> float:
    """Order-insensitive recall@k: mean fraction of oracle ids recovered."""
    got_s = np.sort(got, axis=1)
    ref_s = np.sort(ref_ids, axis=1)
    n, k = got_s.shape
    hits = (got_s == ref_s).sum(axis=1).astype(np.float64)
    for i in np.nonzero((got_s != ref_s).any(axis=1))[0]:
        hits[i] = len(set(got_s[i].tolist()) & set(ref_s[i].tolist()))
    return float(hits.sum() / (n * k))


def _tie_aware_mismatches(points: np.ndarray, got: np.ndarray,
                          ref_ids: np.ndarray,
                          ref_d2: np.ndarray) -> tuple[int, int]:
    """Count per-point neighbour-set disagreements, splitting exact-tie
    flips (acceptable) from hard mismatches (bugs).  Returns (ties,
    hard)."""
    got_s = np.sort(got, axis=1)
    ref_s = np.sort(ref_ids, axis=1)
    rows = np.nonzero((got_s != ref_s).any(axis=1))[0]
    ties = hard = 0
    for i in rows:
        diff = np.array(sorted(set(got_s[i].tolist())
                               ^ set(ref_s[i].tolist())))
        kth = float(ref_d2[i, -1])
        d2 = ((points[diff].astype(np.float64)
               - points[i].astype(np.float64)) ** 2).sum(-1)
        if np.allclose(d2, kth, rtol=2e-6, atol=0.0):
            ties += 1
        else:
            hard += 1
    return ties, hard


def _refuse(e, summary: dict, rc: int) -> int:
    """One machine-readable line for a classified refusal, and its rc."""
    summary.update(error=str(e), failure_kind=e.kind)
    print(json.dumps(summary), flush=True)
    print(f"REFUSED [{e.kind}]: {e}", file=sys.stderr, flush=True)
    return rc


def _load_points(path: str) -> np.ndarray:
    from .io import get_dataset, load_xyz, normalize_points

    if os.path.exists(path):
        return normalize_points(load_xyz(path))
    return get_dataset(os.path.basename(path))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="All-points kNN: the engine on the card vs the exact "
                    "kd-tree (the reference test_knearests, rebuilt)")
    ap.add_argument("points", help=".xyz file path or known dataset name "
                    "(e.g. pts20K.xyz, 900k_blue_cube.xyz)")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--density", type=float, default=3.1)
    ap.add_argument("--ring-radius", type=int, default=None)
    ap.add_argument("--supercell", type=int, default=None,
                    help="query-tile side in cells (default: KnnConfig "
                         "default)")
    ap.add_argument("--dist", choices=("diff", "dot"), default="diff")
    ap.add_argument("--sharded", type=int, default=0, metavar="N",
                    help="solve over N z-slabs (slab + halo exchange); "
                         "slab i on card i mod the card count")
    ap.add_argument("--no-oracle", action="store_true",
                    help="skip the kd-tree comparison (benchmark mode)")
    ap.add_argument("--json", action="store_true",
                    help="emit a JSON summary line")
    ap.add_argument("--serve", type=float, default=None, metavar="RATE",
                    help="serve the loaded cloud instead of solving it: "
                         "the open-loop load harness (Poisson arrivals at "
                         "RATE/sec through the dynamic-batching daemon, "
                         "serve/) prints the serving summary JSON.  rc 0 "
                         "iff every request completed")
    ap.add_argument("--serve-requests", type=int, default=200,
                    help="with --serve: scheduled arrivals (default 200)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run on "
                         "the CPU)")
    ap.add_argument("--save", default=None, metavar="PATH",
                    help="write the solve's (n, k) neighbour ids (original "
                         "indexing) and squared distances to PATH (.npz)")
    ap.add_argument("--capture", action="store_true",
                    help="after the timed solve, capture one more under "
                         "torch.profiler (obs.device.profile_window): the "
                         "device-time decomposition, the memory verdict "
                         "and the timed solve's roofline join the summary")
    args = ap.parse_args(argv)
    if args.capture and (args.sharded or args.serve is not None):
        ap.error("--capture captures the single-device solve")

    from .utils import watchdog
    from .utils.memory import NoDeviceError
    from .utils.platform import resolve_device

    try:
        device = resolve_device(args.device)
    except NoDeviceError as e:
        return _refuse(e, {"k": args.k, "platform": args.device or "cuda"},
                       4)
    if device.type == "cuda":
        watchdog.start(tag="cli")  # a hung device call must exit, not pin
    try:
        return _run(args, device)
    finally:
        watchdog.disable()  # every return path: main may run in-process


def _run(args, device) -> int:
    """main's flow once the device is resolved (see the module
    docstring for the exit codes)."""
    from . import KnnConfig, KnnProblem
    from .utils import watchdog
    from .utils.memory import DeviceMemoryError, InputContractError
    from .utils.devinfo import print_device_properties
    from .utils.stopwatch import Stopwatch, timed

    platform = (torch.cuda.get_device_name(device)
                if device.type == "cuda" else str(device))
    print_device_properties()

    try:
        points = _load_points(args.points)
    except InputContractError as e:
        return _refuse(e, {"k": args.k, "platform": platform}, 5)
    n = points.shape[0]
    print(f"loaded {n} points -> [0,1000]^3")

    cfg_kw = {} if args.supercell is None else {"supercell": args.supercell}
    summary = {"n": n, "k": args.k,
               "mode": ("serve" if args.serve is not None else
                        "sharded" if args.sharded else "single"),
               "platform": platform}
    try:
        cfg = KnnConfig(k=args.k, density=args.density,
                        ring_radius=args.ring_radius, dist_method=args.dist,
                        **cfg_kw)
    except InputContractError as e:
        return _refuse(e, summary, 5)

    if args.serve is not None:
        # serving mode: the daemon and the open-loop harness on the legacy
        # external-query route (serve/__main__.py has the same pin)
        from .config import ServeConfig
        from .serve import LoadSpec, ServeDaemon, run_session

        try:
            problem = KnnProblem.prepare(
                points, dataclasses.replace(cfg, adaptive=False),
                device=device)
            daemon = ServeDaemon(problem, ServeConfig())
        except InputContractError as e:
            return _refuse(e, summary, 5)
        except DeviceMemoryError as e:
            return _refuse(e, summary, 4)
        watchdog.disable()  # open-loop pacing, not a stall
        result = run_session(daemon, LoadSpec(rate=args.serve,
                                              requests=args.serve_requests))
        summary.update(result)
        print(json.dumps(summary), flush=True)
        return 0 if result["failed_requests"] == 0 else 1

    # --- the solve (the reference's "knn gpu" phase, test_knearests.cu:136)
    # A refusal before launch (LaunchBudgetError, kind 'oom') or a device
    # fault exits rc 4 with failure_kind on the machine-readable line.
    try:
        if args.sharded:
            from .parallel.sharded import (ShardedKnnProblem,
                                           round_robin_devices)

            slabs = round_robin_devices(device, args.sharded)
            print(f"slabs -> devices: {slabs}")
            summary["slab_devices"] = slabs
            with Stopwatch("prepare (grid + slab plan)"):
                sp = ShardedKnnProblem.prepare(points, config=cfg,
                                               devices=slabs)
            watchdog.heartbeat()
            dev_out, t = timed(sp.solve_device, warmup=1, iters=1)
            watchdog.heartbeat()
            print(f"solve (sharded): first {t['warmup_s']:.3f}s, "
                  f"steady {t['min_s']:.3f}s "
                  f"({n / t['min_s']:.0f} queries/sec)")
            summary["solve_s"] = t["min_s"]
            summary["qps"] = n / t["min_s"]
            with Stopwatch("assemble (host readback)"):
                neighbors, d2, _cert = sp.solve(device_out=dev_out)
            perm = sp.permutation()
        else:
            with Stopwatch("prepare (grid + plan)"):
                problem = KnnProblem.prepare(points, cfg, device=device)
            watchdog.heartbeat()
            _, t = timed(problem.solve, warmup=1, iters=1)
            watchdog.heartbeat()
            print(f"solve: first {t['warmup_s']:.3f}s, "
                  f"steady {t['min_s']:.3f}s "
                  f"({n / t['min_s']:.0f} queries/sec)")
            summary["solve_s"] = t["min_s"]
            summary["qps"] = n / t["min_s"]
            problem.print_stats()
            if args.capture:
                summary.update(_captured(problem, t["min_s"], device))
            neighbors = problem.get_knearests_original()
            perm = problem.get_permutation()
            d2 = problem.get_dists_sq()[np.argsort(perm)]
    except InputContractError as e:
        # before DeviceMemoryError: NonFiniteInputError is both, and the
        # input-contract reading (rc 5, fix the input) is the actionable one
        return _refuse(e, summary, 5)
    except DeviceMemoryError as e:
        return _refuse(e, summary, 4)

    # the device work is done; the kd-tree and the tie analysis are host
    # work that may legitimately exceed the stall limit
    watchdog.heartbeat()
    watchdog.disable()
    if args.save:
        np.savez(args.save, neighbors=neighbors, dists_sq=d2)

    # --- sanity: permutation bijection (test_knearests.cu:162-168)
    assert np.array_equal(np.sort(perm), np.arange(n)), \
        "permutation not a bijection"
    # --- sanity: no duplicate neighbour ids (test_knearests.cu:174-191)
    valid = neighbors >= 0
    srt = np.sort(np.where(valid, neighbors, np.arange(n)[:, None] + n),
                  axis=1)
    dupes = int(((np.diff(srt, axis=1) == 0) & valid[:, 1:]).sum())
    print(f"duplicate-neighbor check: {dupes} duplicates")
    assert dupes == 0, "duplicate neighbor ids found"

    # --- exact kd-tree comparison (test_knearests.cu:194-232)
    if not args.no_oracle:
        from .oracle import KdTreeOracle

        with Stopwatch("knn cpu (kd-tree oracle)"):
            oracle = KdTreeOracle(points)
            ref_ids, ref_d2 = oracle.knn_all_points(k=args.k)
        ties, hard = _tie_aware_mismatches(points, neighbors, ref_ids,
                                           ref_d2)
        matched = n - ties - hard
        recall = set_recall(neighbors, ref_ids)
        print(f"oracle comparison: {matched}/{n} exact, {ties} tie flips, "
              f"{hard} hard mismatches; recall@{args.k} = {recall:.6f}")
        summary.update(exact=matched, ties=ties, hard=hard,
                       recall=float(recall))
        if hard:
            print("FAILED", file=sys.stderr)
            return 1
    print("OK")
    if args.json:
        print(json.dumps(summary))
    return 0


def _captured(problem, solve_s: float, device) -> dict:
    """One more solve under ``obs.device.profile_window``: its device-time
    decomposition and memory verdict, and ``utils.roofline`` of the timed
    solve (``solve_s``) against the device's peaks."""
    from .obs import device as obs_device
    from .utils import roofline

    rep = obs_device.profile_window(
        problem.solve, device=device, trace_id="cli",
        hbm_model_bytes=obs_device.problem_hbm_model(problem))
    dec = rep.decomposition
    roof = roofline.roofline_fields(roofline.problem_traffic(problem),
                                    solve_s, device.type)
    print(f"captured solve: {dec['events']} device events "
          f"({dec['joined_by_correlation']} joined to their launch), "
          f"{dec['device_total_ms']} ms, by module "
          f"{json.dumps(dec['by_module'])}; memory growth "
          f"{rep.hbm['hbm_window_delta_bytes']} of model "
          f"{rep.hbm['hbm_model_bytes']} bytes "
          f"({rep.hbm['hbm_measured_source']})")
    print(f"roofline of the timed solve: {json.dumps(roof)}")
    return {"device_time_decomposition": dec, **rep.hbm, **roof}


if __name__ == "__main__":
    sys.exit(main())
