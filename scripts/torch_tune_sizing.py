#!/usr/bin/env python3
"""What do the autotuner's plans cost on the card, at the smoke's sizes?

    python3 scripts/torch_tune_sizing.py [--ns 100000,50000,25000]

On one CUDA device, the two measurements that size ``chip_smoke.py``'s
phase 10i:

* the brute route at d=128, k=10, recall 0.9, unrefined (the race of
  phase 10i (b)): one ``mxu.solve_general`` of each of the 6 plans
  (precision f32 and bf16 x ``query_chunk`` None, 128 and 512) at each n
  of ``--ns``, host wall to the answer, and the sum over the plans; a race
  runs 3 solves a plan (warm-up, timed, captured);
* the tuned-plan seam's bf16 plan ``{'precision': 'bf16', 'query_chunk':
  128}`` on the 900k/k=10 blue cube (``seed=900``) at recall 1.0: the
  prepare and solve's host wall and the rows it refined (the bf16 band
  certifies none, so every row takes the exact fallback).
"""

import argparse
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ns", default="100000,50000,25000")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import cuda_knearests_tpu_torch as pt
    from cuda_knearests_tpu_torch import mxu
    from cuda_knearests_tpu_torch.io import generate_blue_noise
    from cuda_knearests_tpu_torch.ops import _build
    from cuda_knearests_tpu_torch.tune import store as tstore

    print(f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}",
          flush=True)
    _build.load_all(_build.KERNELS)
    ns = [int(n) for n in args.ns.split(",")]
    x = (np.random.default_rng(0).random((max(ns), 128)) * 1000.0).astype(
        np.float32)
    kw = dict(k=10, recall_target=0.9, refine="none", device="cuda")
    for precision in ("f32", "bf16"):      # build and load both tiers
        mxu.solve_general(x[:2000], precision=precision, **kw)
    for n in ns:
        total = 0.0
        for precision in ("f32", "bf16"):
            for qc in (None, 128, 512):
                t0 = time.perf_counter()
                res = mxu.solve_general(x[:n], precision=precision,
                                        query_chunk=qc, **kw)
                dt = time.perf_counter() - t0
                total += dt
                print(f"n={n} x 128 {precision} query_chunk={qc}: "
                      f"{dt * 1e3:.1f} ms (backend {res.backend})",
                      flush=True)
        print(f"n={n}: one solve of every plan {total:.1f} s", flush=True)

    pts = generate_blue_noise(900_000, seed=900)
    st = tstore.TunedPlanStore()
    st.record(tstore.plan_signature(900_000, 3, 10, 1.0),
              tstore.device_key(device="cuda"),
              {"precision": "bf16", "query_chunk": 128})
    tstore.set_default_store(st)
    t0 = time.perf_counter()
    prob = pt.KnnProblem.prepare(pts, pt.KnnConfig(k=10), device="cuda")
    res = prob.solve()
    dt = time.perf_counter() - t0
    print(f"900k/k=10 under the bf16 plan (precision {prob.config.precision},"
          f" query_chunk {prob.config.query_chunk}): prepare + solve "
          f"{dt:.3f} s, {int(res.uncert_count)} of {pts.shape[0]} rows "
          f"refined", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
