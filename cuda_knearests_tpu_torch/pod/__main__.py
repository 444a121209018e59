"""``python -m cuda_knearests_tpu_torch.pod [--device cpu] [--devices N]``:
the pod's smoke, on the GPU unless ``--device cpu`` is given (chips
``[device] * N``; on the GPU one chip a card where there are N cards).
Counterpart of ``python -m cuda_knearests_tpu.pod``, the same checks:

1. **partition pin**: the pod's solve of the reference's 20k fixture
   (its first ``--smoke-n`` points; 0: all) is tie-aware equal to the
   kd-tree and to the single-device route, also under ``scorer='mxu'`` at
   recall_target 0.9 and 1.0 (with at least one 'mxu' class), and
   boundary-straddling external queries are exact;
2. **streamed prepare**: under a budget between the per-chip high water
   and the full-cloud model, prepare streams (does not refuse), keeps the
   high water <= budget < full and stays exact; a budget below any chip
   refuses with the typed oom;
3. **counters**: one solve makes one host round trip, and ``ici_bytes``
   equals ``PodMeta.halo_bytes``.

``--bench --points-per-chip P`` instead prints one JSON row of a
weak-scaling measurement: queries/s a chip over warm solves (each to a
synchronize of every chip's device), recall on 2,000 sampled rows, host
round trips and ``ici_bytes``.

Prints one JSON line per check; exits 0 when all pass, 1 when one fails,
2 when the device asked for does not exist.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def _chips(device: str, n: int) -> list:
    dv = torch.device(device)
    if dv.type == "cuda" and dv.index is None \
            and torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [dv] * n


def _sync(chips) -> None:
    for dv in set(chips):
        if dv.type == "cuda":
            torch.cuda.synchronize(dv)  # kntpu-ok: host-sync-loop -- the smoke's timing fence: one wait per chip between timed phases, never inside a solve


def _row(check: str, ok: bool, **extra) -> bool:
    print(json.dumps({"check": check, "ok": bool(ok), **extra}), flush=True)
    return bool(ok)


def _smoke(chips, n_cap: int) -> int:
    from .. import KnnConfig, KnnProblem
    from ..fuzz.compare import check_route_result
    from ..io import get_dataset
    from ..oracle import KdTreeOracle
    from ..runtime import dispatch
    from ..utils.memory import LaunchBudgetError
    from . import PodKnnProblem

    ndev, k, ok = len(chips), 10, True

    def mismatch(points, q, ids, d2, ref_d2, kk=k):
        mm = check_route_result(points, q, ids, d2, ref_d2, kk)
        return None if mm is None else mm.render()

    points = get_dataset("pts20K.xyz")
    if n_cap and n_cap < points.shape[0]:
        points = np.ascontiguousarray(points[:n_cap])
    tree = KdTreeOracle(points)
    ref_d = tree.knn_all_points(k)[1]

    # 1a. partitioned == kd-tree == single device
    pp = PodKnnProblem.prepare(points, config=KnnConfig(k=k), mesh=chips)
    dispatch.reset_stats()
    ids, d2, _cert = pp.solve()
    counters = dispatch.stats()
    sp = KnnProblem.prepare(points, KnnConfig(k=k), device=chips[0])
    sp.solve()
    sd2 = np.empty_like(sp.get_dists_sq())
    sd2[sp.get_permutation()] = sp.get_dists_sq()
    m1, m2 = (mismatch(points, points, ids, d2, ref_d),
              mismatch(points, points, ids, d2, sd2))
    ok &= _row("pod-vs-single-device-pin", m1 is None and m2 is None,
               n=int(points.shape[0]), n_devices=ndev,
               ring_depth=pp.meta.steps, mismatch=m1,
               single_device_mismatch=m2)

    # 1b. boundary-straddling external queries (jittered stored points)
    rng = np.random.default_rng(3)
    q = np.clip(points[rng.integers(0, points.shape[0], 512)]
                + rng.normal(0, 1.0, (512, 3)).astype(np.float32),
                0.0, 1000.0).astype(np.float32)
    qi, qd = pp.query(q)
    mq = mismatch(points, q, qi, qd, tree.knn(q, k)[1])
    ok &= _row("pod-query-pin", mq is None, mismatch=mq)

    # 1c. the MXU tier, both recall targets
    sub = np.ascontiguousarray(points[:4000])
    sub_d = KdTreeOracle(sub).knn_all_points(k)[1]
    for rt in (0.9, 1.0):
        pm = PodKnnProblem.prepare(sub, config=KnnConfig(
            k=k, scorer="mxu", recall_target=rt), mesh=chips)
        mi, md, _mc = pm.solve()
        mm = mismatch(sub, sub, mi, md, sub_d)
        n_mxu = sum(cp.route == "mxu" for c in pm.chip_plans
                    for cp in c.classes)
        ok &= _row(f"pod-mxu-rt{rt:g}", mm is None and n_mxu > 0,
                   mxu_classes=n_mxu, mismatch=mm)

    # 2. the streamed prepare and the typed refusal
    high = pp.hbm["hbm_high_water_bytes"]
    full = pp.hbm["hbm_full_cloud_bytes"]
    budget = (high + full) // 2
    try:
        ps = PodKnnProblem.prepare(points, config=KnnConfig(
            k=k, hbm_budget_bytes=budget), mesh=chips)
        si, s_d2, _sc = ps.solve()
        ms = mismatch(points, points, si, s_d2, ref_d)
        ok &= _row("pod-streamed-prepare",
                   ps.hbm["streamed_prepare"] and ms is None
                   and ps.hbm["hbm_high_water_bytes"] <= budget < full,
                   mismatch=ms, **ps.hbm)
    except LaunchBudgetError as e:
        ok &= _row("pod-streamed-prepare", False, error=str(e))
    try:
        PodKnnProblem.prepare(points, config=KnnConfig(
            k=k, hbm_budget_bytes=max(1, high // 8)), mesh=chips)
        ok &= _row("pod-budget-refusal", False,
                   error="an undersized budget was not refused")
    except LaunchBudgetError as e:
        ok &= _row("pod-budget-refusal", e.kind == "oom", kind=e.kind,
                   site=e.site)

    # 3. round trips and the exchange's bytes over the first solve
    ok &= _row("pod-sync-ici",
               counters.host_syncs == 1
               and counters.ici_bytes == pp.meta.halo_bytes(),
               host_syncs=counters.host_syncs, ici_bytes=counters.ici_bytes,
               halo_bytes=pp.meta.halo_bytes(), hcap=pp.meta.hcap)
    return 0 if ok else 1


def _bench(chips, points_per_chip: int, k: int) -> int:
    from .. import KnnConfig
    from ..io import generate_uniform
    from ..oracle import KdTreeOracle
    from ..runtime import dispatch
    from . import PodKnnProblem

    ndev = len(chips)
    n = points_per_chip * ndev
    points = generate_uniform(n, seed=12)
    dispatch.reset_stats()
    pp = PodKnnProblem.prepare(points, config=KnnConfig(k=k), mesh=chips)

    def run():
        pp.solve_device()
        _sync(chips)

    run()  # the exchange, every chip's ready state, kernel builds
    ici_bytes = dispatch.stats().ici_bytes
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    s = (time.perf_counter() - t0) / iters
    dispatch.reset_stats()
    neighbors, _d2, cert = pp.solve()
    syncs = dispatch.stats().host_syncs
    sample = np.random.default_rng(8).permutation(n)[: min(2000, n)]
    ref, _ = KdTreeOracle(points).knn(points[sample], k,
                                      exclude_ids=sample.astype(np.int32))
    hits = sum(np.intersect1d(a[a >= 0], b[b >= 0]).size
               for a, b in zip(neighbors[sample], ref))
    recall = hits / max(1, int((ref >= 0).sum()))
    print(json.dumps({
        "config": f"pod weak-scaling: {points_per_chip} points/chip over "
                  f"{ndev} chip(s) (k={k}, cell-partitioned)",
        "value": n / s / ndev, "unit": "queries/sec/chip",
        "total_qps": n / s, "n_devices": ndev, "n_points": n,
        "solve_device_s": s, "recall": recall,
        "certified_fraction": float(np.asarray(cert).mean()),
        "ring_depth": pp.meta.steps, "halo_bytes": pp.meta.halo_bytes(),
        "ici_bytes": ici_bytes, "host_syncs": syncs, **pp.hbm,
        "devices": sorted({str(dv) for dv in chips}),
        "device_name": (torch.cuda.get_device_name(chips[0])
                        if chips[0].type == "cuda" else "cpu")}),
        flush=True)
    return 0 if syncs == 1 and recall >= 0.999 else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m cuda_knearests_tpu_torch.pod",
                                 description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the chips (default: cuda)")
    ap.add_argument("--devices", type=int, default=4,
                    help="chips in the pod (default 4)")
    ap.add_argument("--bench", action="store_true",
                    help="print one weak-scaling JSON row instead")
    ap.add_argument("--points-per-chip", type=int, default=20_000)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--smoke-n", type=int, default=0,
                    help="cap the smoke fixture's size (0: all 20,626)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        print(f"no CUDA device for --device {args.device}; pass --device "
              f"cpu to run on the CPU", file=sys.stderr)
        return 2
    chips = _chips(args.device, max(1, args.devices))
    if args.bench:
        return _bench(chips, max(1, args.points_per_chip), max(1, args.k))
    return _smoke(chips, args.smoke_n)


if __name__ == "__main__":
    sys.exit(main())
