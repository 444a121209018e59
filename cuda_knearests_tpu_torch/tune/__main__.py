"""CLI: search (or re-use) a tuned plan for one problem signature.

    python -m cuda_knearests_tpu_torch.tune --n 20000 --k 10 --rt 0.9 \\
        --store plans.json [--device cpu] [--capture]

The first run races the plan space on the device and persists the winner;
a second run with the same signature, device and store hits the persisted
plan and races nothing (``searched`` 0 on the meta line).  One
``tune-trial`` JSON line prints per plan raced, then ``tune-winner`` and
``tune-meta`` (with the store's counters).  Runs on the GPU unless
``--device`` names another device: with no GPU and no ``--device`` it
exits rc 4 (``failure_kind`` 'no-device'); ``--interpret`` (the
reference's Pallas interpret mode) is refused with rc 5.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cuda_knearests_tpu_torch.tune",
        description="measured-cost plan search with a persisted store")
    ap.add_argument("--n", type=int, default=20000,
                    help="problem size (points; signature buckets to pow2)")
    ap.add_argument("--d", type=int, default=3, help="dimensions")
    ap.add_argument("--k", type=int, default=10, help="neighbors per query")
    ap.add_argument("--rt", type=float, default=1.0,
                    help="recall target (1.0 = exact tier)")
    ap.add_argument("--seed", type=int, default=0,
                    help="fixture seed (uniform points in the domain)")
    ap.add_argument("--store", default=None,
                    help="tuned-plan store path (default: "
                         "$KNTPU_TUNE_STORE; omit both for an in-memory "
                         "store that dies with this process)")
    ap.add_argument("--device-kind", default=None,
                    help="override the hardware key (default: the kind of "
                         "--device)")
    ap.add_argument("--budget", type=int, default=None,
                    help="max candidate plans to race (default: all)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed iterations per plan (min wall wins)")
    ap.add_argument("--force", action="store_true",
                    help="re-search even on a store hit")
    ap.add_argument("--capture", action="store_true",
                    help="measure device time under a profiler capture "
                         "(objective_source='device'; a refused capture "
                         "keeps wall time with the reason stamped)")
    ap.add_argument("--interpret", action="store_true",
                    help="the reference's Pallas interpret mode: refused "
                         "(the port has none)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run on "
                         "the CPU)")
    args = ap.parse_args(argv)

    from ..utils.memory import InvalidConfigError, NoDeviceError
    from ..utils.platform import resolve_device
    from .search import search
    from .store import STORE_ENV, TunedPlanStore

    try:
        device = resolve_device(args.device)
    except NoDeviceError as e:
        print(json.dumps({"kind": "tune-meta", "ok": False, "error": str(e),
                          "failure_kind": e.kind}), flush=True)
        return 4

    path = args.store or os.environ.get(STORE_ENV) or None
    store = TunedPlanStore(path=path)
    if path is None:
        print("[tune] no --store/KNTPU_TUNE_STORE: winners are not "
              "persisted beyond this process", file=sys.stderr)

    rng = np.random.default_rng(args.seed)
    points = (rng.random((args.n, args.d)) * 1000.0).astype(np.float32)

    try:
        winner, rows, meta = search(
            points, k=args.k, recall_target=args.rt,
            device_kind=args.device_kind, budget=args.budget,
            repeats=args.repeats, interpret=args.interpret,
            capture=args.capture, store=store, force=args.force,
            device=device)
    except InvalidConfigError as e:
        print(json.dumps({"kind": "tune-meta", "ok": False, "error": str(e),
                          "failure_kind": e.kind}), flush=True)
        return 5
    for row in rows:
        print(json.dumps({"kind": "tune-trial", **row}, sort_keys=True))
    print(json.dumps({"kind": "tune-winner", **winner}, sort_keys=True))
    print(json.dumps({"kind": "tune-meta", **meta, **store.stats_dict()},
                     sort_keys=True), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
