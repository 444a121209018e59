"""CLI of the port's differential fuzz campaigns.

    python -m cuda_knearests_tpu_torch.fuzz --cases 64 --seed 0
    python -m cuda_knearests_tpu_torch.fuzz --approx --cases 32
    python -m cuda_knearests_tpu_torch.fuzz --cases 8 --device cpu
    python -m cuda_knearests_tpu_torch.fuzz --chaos --cases 8
    python -m cuda_knearests_tpu_torch.fuzz --fleet --cases 4 --device cpu
    python -m cuda_knearests_tpu_torch.fuzz --cases 36 --seed 2 \
        --isolation none --ns 1000,4000,16000 --ks 10,33,60,128 \
        --card-rows 4000

Counterpart of ``python -m cuda_knearests_tpu.fuzz``, with ``--device``
(default: the GPU; ``cpu`` runs the kernels' plain versions).  Exit codes:
0 = campaign clean (no unwaived failure), 1 = failures found (each
minimized and banked), 2 = usage error.

``--ns`` / ``--ks`` replace the point campaign's size and k palettes
(``generators.DEFAULT_NS``, ``DEFAULT_KS``).  ``--card-rows MAX_N`` then
also runs every case through ``campaign.check_card_rows``: the four
routes and ``campaign.CARD_CONFIGS`` exact against the oracle, and on
cases of at most MAX_N points equal bit for bit to the same runs on the
CPU (beyond, the CPU's plain versions take minutes a case).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _parse_budget(text):
    if text is None:
        return None
    t = str(text).strip().lower()
    if t.endswith("s"):
        t = t[:-1]
    return float(t)


def _parse_ints(text):
    return None if text is None else tuple(
        int(t) for t in str(text).split(",") if t.strip())


def _finish_campaign(manifest: dict, args, failed_banner: str) -> int:
    """The campaigns' shared epilogue: optional --manifest write, one JSON
    line on stdout, a banner and rc 1 on failures."""
    if args.manifest:
        os.makedirs(os.path.dirname(os.path.abspath(args.manifest)),
                    exist_ok=True)
        with open(args.manifest, "w") as f:
            json.dump(manifest, f, indent=2)
    print(json.dumps(manifest))
    if not manifest["ok"]:
        print(f"{failed_banner}: {len(manifest['failures'])} failure(s); "
              f"minimized repros banked", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cuda_knearests_tpu_torch.fuzz",
        description="Adversarial differential fuzz campaign: every "
                    "generator-zoo case through the four solve routes "
                    "against the exact oracle, on the GPU unless --device "
                    "cpu.")
    ap.add_argument("--cases", type=int,
                    default=int(os.environ.get("KNTPU_FUZZ_CASES", "64")),
                    help="campaign size (default: $KNTPU_FUZZ_CASES or 64)")
    ap.add_argument("--mutations", type=int, default=None, metavar="N",
                    help="run the mutation-stream campaign instead: N "
                         "seeded insert/delete/query streams through the "
                         "serving delta overlay against a rebuild "
                         "(fuzz/mutation.py)")
    ap.add_argument("--approx", action="store_true",
                    help="run the approximate-mode campaign instead: the "
                         "brute route at several recall targets, measured "
                         "recall against its bound and certificate "
                         "soundness against the oracle (fuzz/approx.py)")
    ap.add_argument("--fleet", action="store_true",
                    help="run the fleet campaign instead: seeded "
                         "multi-tenant streams through the fleet front "
                         "door against per-tenant rebuild oracles "
                         "(fuzz/fleet.py)")
    ap.add_argument("--pod", action="store_true",
                    help="run the pod campaign instead: boundary-weighted "
                         "zoo clouds through the cell-partitioned route "
                         "against the oracle and the single-chip route "
                         "(fuzz/pod.py)")
    ap.add_argument("--chaos", action="store_true",
                    help="run the chaos campaign instead: seeded fault "
                         "schedules against the elastic pod fleet, the "
                         "named autoscale schedules, then the cross-mesh "
                         "SIGKILL drill (fuzz/chaos.py)")
    ap.add_argument("--fof", action="store_true",
                    help="run the FoF campaign instead: zoo clouds and "
                         "seeded linking lengths through cluster.fof "
                         "against the union-find oracle (fuzz/fof.py)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--routes", default=None,
                    help="comma-separated subset of "
                         "adaptive,legacy,query,sharded (default: all)")
    ap.add_argument("--budget", default=None, metavar="SECONDS",
                    help="wall-time bound, e.g. 60 or 60s; the seeded case "
                         "list truncates, never fails, on expiry")
    ap.add_argument("--bank-dir", default=None,
                    help="where failing repros are banked "
                         "(default: tests/corpus_torch)")
    ap.add_argument("--isolation", choices=("auto", "case", "none"),
                    default="auto",
                    help="'case' = one supervisor worker per case (crash "
                         "containment), 'none' = in-process, 'auto' = "
                         "'case' on the GPU (default)")
    ap.add_argument("--devices", type=int, default=2,
                    help="slabs of the sharded route (chips of the pod "
                         "campaign: at least 4), all on --device; "
                         "default 2")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: cuda)")
    ap.add_argument("--ns", default=None, metavar="N,N,...",
                    help="point campaign: the palette of cloud sizes "
                         "(default: 33,96,257)")
    ap.add_argument("--ks", default=None, metavar="K,K,...",
                    help="point campaign: the palette of k (default: "
                         "1,4,10)")
    ap.add_argument("--card-rows", type=int, default=None, metavar="MAX_N",
                    help="point campaign: also hold every case's rows on "
                         "--device, the routes plus the blocked kernel and "
                         "the gather epilogue, to the oracle, and on cases "
                         "of at most MAX_N points to the CPU's bit for bit")
    ap.add_argument("--no-minimize", action="store_true",
                    help="bank failing cases unminimized")
    ap.add_argument("--manifest", default=None,
                    help="also write the campaign manifest JSON here")
    args = ap.parse_args(argv)
    if args.cases < 0:
        ap.error("--cases must be >= 0")
    try:
        ns, ks = _parse_ints(args.ns), _parse_ints(args.ks)
    except ValueError:
        ap.error("--ns and --ks take comma-separated integers")
    try:
        budget = _parse_budget(args.budget)
    except ValueError:
        ap.error(f"--budget {args.budget!r} is not a number of seconds")

    flavors = [f for f, on in (("--fof", args.fof),
                               ("--approx", args.approx),
                               ("--fleet", args.fleet),
                               ("--pod", args.pod),
                               ("--chaos", args.chaos),
                               ("--mutations", args.mutations is not None))
               if on]
    if len(flavors) > 1:
        ap.error(f"{' and '.join(flavors)} are mutually exclusive campaigns")
    single_route = (args.fof or args.approx or args.fleet or args.pod
                    or args.chaos)
    if single_route and args.routes:
        ap.error("--routes applies to the point-case campaign only")
    point_only = [f for f, on in (("--ns", ns), ("--ks", ks),
                                  ("--card-rows",
                                   args.card_rows is not None)) if on]
    if point_only and (single_route or args.mutations is not None):
        ap.error(f"{', '.join(point_only)} apply to the point-case "
                 f"campaign only")
    if single_route and args.isolation != "auto":
        ap.error("--isolation applies to the point-case campaign only; "
                 "the other campaigns run in-process")
    kwargs = {} if args.bank_dir is None else {"bank_dir": args.bank_dir}
    common = dict(seed=args.seed, budget_s=budget,
                  minimize=not args.no_minimize, device=args.device,
                  **kwargs)
    if args.pod:
        from .pod import run_pod_campaign

        manifest = run_pod_campaign(n_cases=args.cases,
                                    ndev=max(4, args.devices), **common)
        return _finish_campaign(manifest, args, "POD FUZZ FAILED")
    if args.chaos:
        from .chaos import run_chaos_campaign

        manifest = run_chaos_campaign(n_cases=args.cases, **common)
        return _finish_campaign(manifest, args, "CHAOS FUZZ FAILED")
    if args.fleet:
        from .fleet import run_fleet_campaign

        manifest = run_fleet_campaign(n_cases=args.cases, **common)
        return _finish_campaign(manifest, args, "FLEET FUZZ FAILED")
    if args.approx:
        from .approx import run_approx_campaign

        manifest = run_approx_campaign(n_cases=args.cases, **common)
        return _finish_campaign(manifest, args, "APPROX FUZZ FAILED")
    if args.fof:
        from .fof import run_fof_campaign

        manifest = run_fof_campaign(n_cases=args.cases, **common)
        return _finish_campaign(manifest, args, "FOF FUZZ FAILED")
    if args.mutations is not None:
        from .mutation import run_mutation_campaign

        manifest = run_mutation_campaign(n_cases=args.mutations, **common)
        return _finish_campaign(manifest, args, "MUTATION FUZZ FAILED")

    from .campaign import run_campaign
    from .routes import ROUTE_NAMES

    routes = tuple(r.strip() for r in args.routes.split(",")) \
        if args.routes else ROUTE_NAMES
    unknown = [r for r in routes if r not in ROUTE_NAMES]
    if unknown:
        ap.error(f"unknown route(s) {unknown}: expected {ROUTE_NAMES}")
    palettes = {k: v for k, v in (("ns", ns), ("ks", ks)) if v}
    manifest = run_campaign(
        n_cases=args.cases, routes=routes, isolation=args.isolation,
        n_devices=max(1, args.devices), **palettes, **common)
    if args.card_rows is not None:
        manifest["card_rows"] = _card_rows(manifest, palettes, args)
        manifest["ok"] = manifest["ok"] and not manifest["card_rows"][
            "failures"]
    return _finish_campaign(manifest, args, "FUZZ CAMPAIGN FAILED")


def _card_rows(manifest: dict, palettes: dict, args) -> dict:
    """``campaign.check_card_rows`` on every case the campaign completed."""
    import time

    from .campaign import check_card_rows, prepare_device
    from .generators import draw_cases

    t0 = time.monotonic()
    dev = prepare_device(args.device)
    cases = draw_cases(args.cases, args.seed, **palettes)
    runs, failures = 0, []
    for spec in cases[:manifest["completed_cases"]]:
        n, bad = check_card_rows(spec, dev, max(1, args.devices),
                                 against_cpu=spec.n <= args.card_rows)
        runs += n
        failures += bad
    return {"runs": runs, "cpu_max_n": args.card_rows, **palettes,
            "elapsed_s": round(time.monotonic() - t0, 3),
            "failures": failures}


if __name__ == "__main__":
    sys.exit(main())
