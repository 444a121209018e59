#!/usr/bin/env python3
"""Time the PyTorch port's class kernels and its split selection of one
or more checkouts on one CUDA GPU, in turns, by CUDA events and device
time.

    python3 scripts/torch_class_kernel_ab.py ROOT [ROOT ...]

Each ROOT is the root of a checkout of the repository (the working tree,
or an unpacked ``git archive`` of another commit).  Each runs in a process
of its own, in the order given, so list them as parent, change, change,
parent to compare two commits on one card.  A process builds its
checkout's kernels, prepares 900k blue noise at k=10 and 300k blue noise
at k=50 (``chip_smoke.py``'s seeds) and times, over every class in mode
(a), 20 launches after a warm-up: ``blocked_topk`` at the m that
``kernel='blocked'`` gives, on the packs as packed and (900k) crowded in
stored-id order, and ``supercell_topk`` on the packs as packed.  It prints
one JSON line of milliseconds per call: by CUDA events around the 20
launches, and ("(profiler)") the kernels' device time under torch.profiler,
which leaves out host gaps between launches.  Then it times the split
selection (``mxu.kernel.select_split``, f32, its two prep passes
included) over all 20,000 queries of ``chip_smoke.py``'s gate-refused
cloud (20k uniform 3-D points, k=1,800) at m=128 and m=100, 3 calls after
a warm-up; where the checkout's ``select_split`` takes ``arm``, also each
arm at d=3 and at d=128 (20k x 128, k=1,600, m=128).  Only the port is
imported, never JAX.

Before the roots run, the working tree this script belongs to buckets
``chip_smoke.py``'s external queries against the 900k/k=10 plan (1M
uniform queries, seed 901, and 200k clustered ones, seed 902) into
``build/ab_query_slots.npz``; each root then times ``supercell_topk``
(mode (a), no self-exclusion) on the query packs built from those slots
and its own class pack, as ``ops/adaptive.query_pack`` builds them, so
checkouts older than the query route time their kernel on the same
inputs.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CLOUDS = (("900k/k=10", 900_000, 900, 10), ("300k/k=50", 300_000, 301, 50))
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUERY_SLOTS = os.path.join(HERE, "build", "ab_query_slots.npz")
QUERY_SETS = ("uniform", "clustered")


def save_query_slots() -> None:
    """The slots of ``chip_smoke.py``'s query sets in the 900k/k=10 plan's
    one class, from this working tree's query planning."""
    sys.path.insert(0, HERE)
    import numpy as np

    import cuda_knearests_tpu_torch as pt
    from cuda_knearests_tpu_torch.io import (generate_blue_noise,
                                             generate_clustered,
                                             generate_uniform)
    from cuda_knearests_tpu_torch.ops import adaptive

    prob = pt.KnnProblem.prepare(generate_blue_noise(900_000, seed=900),
                                 pt.KnnConfig(k=10), device="cuda")
    out = {}
    for name, q in (("uniform", generate_uniform(1_000_000, seed=901)),
                    ("clustered", generate_clustered(200_000, seed=902))):
        qcls, qrow = adaptive.bucket_queries(prob.grid, prob.config,
                                             prob.aplan, q)
        (b,) = adaptive.plan_queries(prob.config, prob.aplan, qcls, qrow, 10,
                                     None)
        out.update({f"{name}_queries": q, f"{name}_src": b.src,
                    f"{name}_slot": b.slot, f"{name}_q2cap": b.q2cap})
    os.makedirs(os.path.dirname(QUERY_SLOTS), exist_ok=True)
    np.savez(QUERY_SLOTS, **out)


def query_packs(pk, n_sc: int):
    """(name, kernel arguments, forward map, m) of each saved query set
    over the class pack ``pk`` (query coordinates scattered to their
    slots, ids all pads, pad slots targeting row m)."""
    import numpy as np
    import torch

    packs = []
    with np.load(QUERY_SLOTS) as z:
        for name in QUERY_SETS:
            q = torch.as_tensor(z[f"{name}_queries"], device="cuda")
            src = torch.as_tensor(z[f"{name}_src"], device="cuda")
            slot = torch.as_tensor(z[f"{name}_slot"], device="cuda")
            q2cap, m = int(z[f"{name}_q2cap"]), q.shape[0]
            axes = []
            for ax in range(3):
                a = torch.zeros(n_sc * q2cap, device="cuda")
                a[slot] = q[src.long(), ax]
                axes.append(a.view(n_sc, q2cap))
            qid = torch.full((n_sc, q2cap), -2, dtype=torch.int32,
                             device="cuda")
            tgt = torch.full((n_sc * q2cap,), m, dtype=torch.int32,
                             device="cuda")
            tgt[slot] = src
            packs.append((name, [*axes, qid, *pk[4:]], tgt, m))
    return packs


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, kernel) -> float:
    """Mean device milliseconds per call of ``fn`` spent in kernels whose
    name holds ``kernel`` (a string, or a tuple of them) (torch.profiler:
    host gaps between launches are not counted)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    names = (kernel,) if isinstance(kernel, str) else kernel
    us = sum(getattr(e, "device_time_total", None)
             or getattr(e, "cuda_time_total", 0)
             for e in prof.key_averages()
             if any(name in e.key for name in names))
    return us / 1e3 / reps


def crowded(args):
    """Each supercell's candidates in stored-id order (grid order)."""
    import torch

    order = torch.sort(torch.where(args[7] >= 0, args[7], 2**30),
                       dim=1).indices
    return list(args[:4]) + [torch.gather(a, 1, order).contiguous()
                             for a in args[4:]]


def time_root(root: str) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    import cuda_knearests_tpu_torch as pt
    from cuda_knearests_tpu_torch.io import generate_blue_noise
    from cuda_knearests_tpu_torch.ops import cuda_solve as cs
    from cuda_knearests_tpu_torch.ops.adaptive import class_blocked_m

    if not pt.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {pt.__file__}, not the port in {root}")
    res = {"root": root}
    for name, n, seed, k in CLOUDS:
        cfg = pt.KnnConfig(k=k, kernel="blocked")
        prob = pt.KnnProblem.prepare(generate_blue_noise(n, seed=seed), cfg,
                                     device="cuda")
        classes = prob.aplan.classes
        ms = [class_blocked_m(cfg, cp.ccap) for cp in classes]
        out = (torch.full((n, k), float("inf"), device="cuda"),
               torch.full((n, k), -1, dtype=torch.int32, device="cuda"))
        packed = [list(cp.pk.args()) for cp in classes]
        layouts = [("packed", packed)]
        if n == 900_000:
            layouts.append(("crowded", [crowded(a) for a in packed]))
        runs = [(f"blocked {name} {layout}", "blocked_topk", lambda p=packs: [
            cs.blocked_topk(*a, k, m, True, tgt=cp.tgt, out=out)
            for cp, a, m in zip(classes, p, ms)]) for layout, packs in layouts]
        runs.append((f"one-stage {name} packed", "supercell_topk", lambda: [
            cs.supercell_topk(*a, k, True, tgt=cp.tgt, out=out)
            for cp, a in zip(classes, packed)]))
        if n == 900_000:
            for qname, args, tgt, m in query_packs(packed[0],
                                                   classes[0].n_sc):
                q_out = (torch.full((m, k), float("inf"), device="cuda"),
                         torch.full((m, k), -1, dtype=torch.int32,
                                    device="cuda"))
                runs.append((f"one-stage {name} {qname} queries",
                             "supercell_topk",
                             lambda a=args, t=tgt, o=q_out: cs.supercell_topk(
                                 *a, k, False, tgt=t, out=o)))
        for label, kernel, fn in runs:
            res[label] = cuda_ms(fn, 20)
            res[label + " (profiler)"] = device_ms(fn, 20, kernel)
        del prob, packed, layouts, runs
        torch.cuda.empty_cache()
    res.update(time_split())
    return res


# The split selection's kernels: the f32 prep pass, the pool arm's fold
# and selection, the direct arm.
SPLIT_KERNELS = ("prep_kernel", "fold_kernel", "select_kernel",
                 "direct_kernel")


def time_split() -> dict:
    import inspect

    import numpy as np
    import torch

    from cuda_knearests_tpu_torch.mxu import kernel as mk
    from cuda_knearests_tpu_torch.mxu.solve import select_inputs

    def inputs(pts):
        qid, il, cid = select_inputs(pts, pts.shape[0], True)
        return tuple(torch.as_tensor(a, device="cuda")
                     for a in (pts, qid, il, cid))

    res = {}
    pts3 = (np.random.default_rng(1800).random((20_000, 3)) * 1000).astype(
        np.float32)
    runs = [(f"split 20k x 3 k=1800 m={m}", pts3, 1800, m, {})
            for m in (128, 100)]
    if "arm" in inspect.signature(mk.select_split).parameters:
        pts128 = (np.random.default_rng(1600).random((20_000, 128))
                  * 100).astype(np.float32)
        runs += [(f"split 20k x {d} k={k} m=128 {arm}", pts, k, 128,
                  {"arm": arm}) for d, pts, k in ((3, pts3, 1800),
                                                  (128, pts128, 1600))
                 for arm in ("direct", "pool")]
    for label, pts, k, m, kw in runs:
        args = inputs(pts)
        d = pts.shape[1]
        fn = (lambda a=args, k=k, m=m, d=d, kw=kw:
              mk.select_split(*a, k, m, d, True, **kw))
        res[label] = cuda_ms(fn, 3)
        res[label + " (profiler)"] = device_ms(fn, 3, SPLIT_KERNELS)
        del args
        torch.cuda.empty_cache()
    return res


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--root":
        print(json.dumps(time_root(sys.argv[2])), flush=True)
        return 0
    if sys.argv[1:] == ["--save-query-slots"]:
        save_query_slots()
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    subprocess.run([sys.executable, os.path.abspath(__file__),
                    "--save-query-slots"], check=True)
    for root in sys.argv[1:]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--root",
                        root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
