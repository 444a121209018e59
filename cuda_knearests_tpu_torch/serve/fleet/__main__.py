"""``python -m cuda_knearests_tpu_torch.serve.fleet`` -- the fleet's smokes.

Counterpart of ``python -m cuda_knearests_tpu.serve.fleet``.  Every mode
runs on the GPU unless ``--device cpu`` is given (no GPU and no
``--device`` -> rc 4).

* ``--loadgen`` (default): a mixed-SLO multi-tenant open-loop session
  (``loadgen.py``): tenants alternate latency / throughput classes, one
  tiny tenant rides the host sidecar.  Prints the fleet summary as one
  JSON line.  ``--assert-steady`` exits 1 unless >= 2 dense tenants were
  served with 0 recompiles fleet-wide (kernel builds and library loads in
  the window, elastic index work aside), 0 failed requests, a defined
  Jain index and, on the card, class kernels launched
  (``kernel_route == 'cuda'`` and ``kernel_launches > 0``).
* ``--autoscale``: the autoscale and brownout smoke.  A diurnal
  (sine-modulated Poisson) session with client backoff drives the
  Autoscaler; dense tenants ship lazily, so the log's compaction floor is
  exercised.  A deterministic epilogue then ticks the loop until the
  ladder is back at exact and every added replica is gone.  Exit 0 needs
  (a) >= 1 scale event, (b) full recovery, (c) the anti-flap bound
  (consecutive actuations of a class more than the cooldown apart) and
  (d) every tenant's committed tail still replayable from its pool's
  applied floor.  Composes with ``--assert-steady``.
* ``--pod-tenant``: adds one pod-placed tenant (a cloud above
  ``pod_threshold``, hotspot inserts) and forces a live Morton rebalance
  before the session; ``--assert-steady`` then also needs >= 1 completed
  migration.
* ``--failover-smoke``: the process-level failover proof
  (``replica.failover_drill``): a primary and a replica as child
  processes, a SIGKILL of the primary mid-stream, zero lost committed
  mutations and post-failover answers byte-identical to a rebuild.

Exit codes: 0 ok; 1 assertion or summary failure; 4 classified device
fault (or no GPU); 5 input-contract violation.
"""

from __future__ import annotations

import argparse
import json
import sys


def _failover_smoke(n: int, k: int, ops: int, seed: int, device) -> int:
    from .replica import failover_drill

    summary = {"config": "fleet failover smoke",
               **failover_drill(n=n, k=k, ops=ops, seed=seed,
                                log=lambda s: print(
                                    json.dumps({"event": s}), flush=True),
                                device=device)}
    print(json.dumps(summary), flush=True)
    return 0 if summary["failover_ok"] else 1


def _autoscale_epilogue(fleet, summary: dict) -> int:
    """The --autoscale smoke's deterministic tail.

    Pumps synthetic ticks until the ladder walks back to exact and
    every added replica is gone, then runs a deterministic scale-down
    drill -- add a replica, commit an UNSHIPPED tail past it (lazy
    shipping keeps the replica at its birth seq), remove it through the
    same actuator call the policy uses -- and finally the four
    assertions the seeded autoscale faults must each fail: liveness,
    recovery, anti-flap, no-drop-tail."""
    import time

    import numpy as np

    sc = fleet.autoscaler
    cfg = sc.config
    base = time.monotonic()
    recovered = False
    for i in range(600):
        fleet.poll(base + (i + 1) * cfg.period_s * 1.01)
        dense = [t for t in fleet.tenants.values()
                 if t.daemon is not None]
        if (all(t.degraded_tier == 0 for t in dense)
                and all(st.tier == 0 for st in sc.classes.values())
                and sum(sc.added.values()) == 0):
            recovered = True
            break
    # the scale-down drill: the policy's own scale_down may have fired
    # before any mutation committed (nothing at risk), so exercise the
    # compaction floor deterministically with the SAME actuator pair
    # the policy calls -- under the scale-drop-tail fault this compacts
    # the committed tail away and the probe below provably fails
    drill = next((t for t in fleet.tenants.values()
                  if t.daemon is not None and not t.spec.replicas), None)
    if drill is not None and drill.add_replica():
        pts = (np.random.default_rng(7).random((4, 3)) * 100.0
               + 5.0).astype(np.float32)
        rs = drill.daemon.submit(10**9, "insert", pts,
                                 now=fleet.clock())
        if rs and rs[-1].ok:
            drill.commit_mutation("insert", pts)
        drill.remove_replica(
            unsafe_compact=fleet._fault == "scale-drop-tail")
    stats = sc.stats_dict()
    # anti-flap: within one class, consecutive actuations must be
    # separated by MORE than the cooldown (the policy's structural
    # bound; the flap-policy fault fires back-to-back and fails this)
    flap_ok = True
    by_cls: dict = {}
    for ev in stats["events"]:
        by_cls.setdefault(ev["class"], []).append(ev["tick"])
    for ticks in by_cls.values():
        for a, b in zip(ticks, ticks[1:]):
            if b - a <= cfg.cooldown_ticks:
                flap_ok = False
    # no-drop-tail: every tenant's committed log tail must still be
    # replayable from its surviving pool's applied floor (an unsafe
    # compaction past that floor makes the next failover's re-ship
    # unrecoverable -- the scale-drop-tail fault's exact corruption)
    drop_tail = None
    for t in fleet.tenants.values():
        if t.log is None:
            continue
        floor = min((r.applied_seq for r in t.replica_pool), default=0)
        try:
            list(t.log.since(floor))
        except RuntimeError as e:
            drop_tail = f"{t.spec.name}: {e}"
            break
    checks = {
        "scale_event": stats["scale_up"] >= 1,
        "recovered_to_exact": recovered,
        "anti_flap": flap_ok,
        "no_drop_tail": drop_tail is None,
    }
    summary["autoscale"] = stats
    summary["autoscale_recovered"] = recovered
    summary["autoscale_checks"] = checks
    if all(checks.values()):
        return 0
    print(f"AUTOSCALE ASSERTION FAILED: {checks} "
          f"ticks={stats['ticks']} drop_tail={drop_tail}",
          file=sys.stderr, flush=True)
    return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cuda_knearests_tpu_torch.serve.fleet",
        description=__doc__.splitlines()[0])
    ap.add_argument("--loadgen", action="store_true",
                    help="run the mixed-SLO open-loop fleet session (the "
                         "default mode; the flag exists for symmetry with "
                         "python -m cuda_knearests_tpu_torch.serve)")
    ap.add_argument("--tenants", type=int, default=4,
                    help="fleet size for --loadgen (mixed SLO classes; "
                         "the last tenant is tiny -> host sidecar)")
    ap.add_argument("--points", type=int, default=6000,
                    help="dense-tenant cloud size (default 6000)")
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--rate", type=float, default=300.0,
                    help="per-tenant mean arrivals/sec (Poisson)")
    ap.add_argument("--requests", type=int, default=60,
                    help="per-tenant scheduled arrivals")
    ap.add_argument("--mutation-ratio", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replicas", type=int, default=0,
                    help="in-process replicas per dense tenant")
    ap.add_argument("--pod-tenant", action="store_true",
                    help="add one pod-placed tenant (cloud above "
                         "pod_threshold, hotspot mutation mix) and FORCE a "
                         "live Morton rebalance before the session starts: "
                         "the migration rides the measured traffic, and "
                         "--assert-steady must still hold (elastic index "
                         "maintenance is carved out of the recompile gate; "
                         "the session additionally requires >= 1 completed "
                         "migration)")
    ap.add_argument("--autoscale", action="store_true",
                    help="run the diurnal autoscale + brownout smoke: "
                         "sine-modulated arrivals with client backoff, "
                         "lazy-shipping dense tenants, a deterministic "
                         "recovery epilogue, then the liveness / "
                         "recovery / anti-flap / no-drop-tail "
                         "assertions (exit 1 on any)")
    ap.add_argument("--diurnal", type=float, default=4.0,
                    help="peak/trough arrival ratio for --autoscale's "
                         "sine-modulated Poisson loads (default 4.0)")
    ap.add_argument("--assert-steady", action="store_true",
                    help="exit 1 unless >= 2 tenants flushed batches with "
                         "zero fleet-wide steady-state recompiles, no "
                         "failed request, a defined fairness index and, "
                         "on the card, class kernels launched")
    ap.add_argument("--failover-smoke", action="store_true",
                    help="run the process-level SIGKILL failover proof "
                         "instead of the loadgen session")
    ap.add_argument("--failover-ops", type=int, default=24)
    ap.add_argument("--failover-points", type=int, default=1500)
    ap.add_argument("--metrics-jsonl", default=None,
                    help="periodically append unified metrics snapshots "
                         "(obs.metrics) to this path, one JSON line each")
    ap.add_argument("--metrics-period-s", type=float, default=1.0)
    ap.add_argument("--device", default=None,
                    help="torch device the tenants serve on (default: the "
                         "GPU; 'cpu' runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    from ...utils.memory import DeviceMemoryError, InputContractError

    try:
        if args.failover_smoke:
            return _failover_smoke(args.failover_points, args.k,
                                   args.failover_ops, args.seed, args.device)

        from .frontdoor import FleetDaemon
        from .loadgen import (TenantLoad, default_fleet_builds,
                              run_fleet_session)

        builds = default_fleet_builds(
            n_tenants=max(1, args.tenants), base_n=args.points, k=args.k,
            seed=args.seed, replicas=args.replicas)
        as_cfg = None
        if args.autoscale:
            import dataclasses as _dc

            from .autoscale import AutoscaleConfig

            # dense tenants ship lazily so the scale-down compaction
            # floor (the no-drop-tail probe below) is genuinely
            # exercised; the smoke disables promotion so the clear
            # ladder's scale-down is deterministic (the added replica is
            # never promoted away)
            builds = [(_dc.replace(spec, ship_mode="lazy"), pts)
                      for spec, pts in builds]
            as_cfg = AutoscaleConfig(promote_min_points=1 << 30)
        cfg = None
        if args.pod_tenant:
            import dataclasses as _dc

            import numpy as np

            from ...config import ServeFleetConfig
            from ...io import generate_uniform
            from .tenants import TenantSpec

            # the threshold sits above every dense tenant's cloud, so
            # ONLY the extra tenant lands on the pod rung
            pod_threshold = args.points + 1024 * max(1, args.tenants)
            cfg = _dc.replace(ServeFleetConfig(),
                              pod_threshold=pod_threshold, pod_shards=2)
            builds.append((TenantSpec(name="pod0", k=args.k),
                           generate_uniform(pod_threshold + 512,
                                            seed=args.seed + 997)))
        fleet = FleetDaemon(builds, cfg, autoscale=as_cfg,
                            device=args.device)
        loads = []
        for i, (spec, _) in enumerate(builds):
            t = fleet.tenants[spec.name]
            mr = args.mutation_ratio if not t.is_sidecar else 0.0
            hotspot = (0.0, 0.12) if t.is_pod and mr > 0 else None
            loads.append(TenantLoad(tenant=spec.name, rate=args.rate,
                                    requests=args.requests,
                                    mutation_ratio=mr, hotspot=hotspot,
                                    diurnal=(args.diurnal
                                             if args.autoscale else None),
                                    backoff=args.autoscale,
                                    seed=args.seed + 31 * i))
        if args.pod_tenant:
            el = fleet.tenants["pod0"].elastic
            # seed a hotspot skew (one bulk insert past the compaction
            # threshold, so the delta folds into the base before the
            # measured window), warm the scatter-gather path at the batch
            # mix's shapes, then start the live migration the measured
            # session must ride (queries pump it; the session epilogue
            # pumps it dry)
            rng = np.random.default_rng(args.seed + 5)
            n_hot = cfg.compact_threshold + 64
            el.insert((rng.random((n_hot, 3)) * 110.0
                       + 5.0).astype(np.float32))
            for m in (1, 4, 16, 64):
                el.query(np.zeros((m, 3), np.float32), args.k)
            el.force_rebalance()
        from ...obs import spans as _spans
        from ...obs.metrics import JsonlEmitter

        trace_sink = _spans.start_file_trace_from_env("fleet")
        emitter = None
        if args.metrics_jsonl:
            emitter = JsonlEmitter(args.metrics_jsonl,
                                   period_s=args.metrics_period_s,
                                   snapshot_fn=fleet.metrics_snapshot)
            emitter.start()
        try:
            summary = run_fleet_session(fleet, loads)
        finally:
            if emitter is not None:
                emitter.stop()
            if trace_sink is not None:
                trace_sink.close()
        as_rc = (_autoscale_epilogue(fleet, summary)
                 if args.autoscale else 0)
    except InputContractError as e:
        print(json.dumps({"error": str(e),
                          "failure_kind": getattr(e, "kind", "crash")}),
              flush=True)
        return 5
    except DeviceMemoryError as e:
        print(json.dumps({"error": str(e),
                          "failure_kind": getattr(e, "kind", "crash")}),
              flush=True)
        return 4

    print(json.dumps(summary), flush=True)
    if args.assert_steady:
        dense_served = [name for name, pt in summary["per_tenant"].items()
                        if not pt["sidecar"] and pt["served_rows"] > 0]
        pod_ok = True
        if args.pod_tenant:
            pt = summary["per_tenant"].get("pod0", {})
            pod_ok = (bool(pt.get("pod"))
                      and pt.get("served_rows", 0) > 0
                      and summary["migrations_done"] >= 1)
        launched = (summary["kernel_route"] != "cuda"
                    or summary["kernel_launches"] > 0)
        ok = (len(dense_served) >= 2
              and summary["recompiles"] == 0
              and launched
              and summary["failed_requests"] == 0
              and summary["jain_fairness"] is not None
              and pod_ok)
        if not ok:
            print(f"FLEET STEADY-STATE ASSERTION FAILED: "
                  f"dense_served={dense_served} "
                  f"recompiles={summary['recompiles']} "
                  f"kernel_route={summary['kernel_route']} "
                  f"kernel_launches={summary['kernel_launches']} "
                  f"failed={summary['failed_requests']} "
                  f"jain={summary['jain_fairness']} "
                  f"pod_ok={pod_ok}",
                  file=sys.stderr, flush=True)
            return 1
    return as_rc


if __name__ == "__main__":
    sys.exit(main())
