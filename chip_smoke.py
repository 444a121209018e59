#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check every result.

    python3 chip_smoke.py

Run from the root of a checkout on a host with one CUDA GPU (built for an
H100: the kernel targets sm_90a).  It imports only the port
(``cuda_knearests_tpu_torch``), never JAX or the reference package.  It:

  1. prints the card (``nvidia-smi`` name and power limit) and builds the
     kernel ``csrc/supercell_topk.cu`` from the checkout;
  2. holds the kernel against its plain torch version on the card, in both
     output modes, on every class of the 300k/k=50 and 300k clustered plans
     (whole, or a wide class's largest supercells) and on synthetic packs
     (k in {1, 10, 50, 128}, exclude_self on and off,
     rows with fewer than k candidates, a query capacity that is not a
     multiple of the block's query tile, candidate lists longer than one
     shared-memory tile, coordinates on a coarse lattice so distance ties
     are common); d2 and ids must be equal (``torch.equal``);
  3. runs the main path -- ``KnnProblem.prepare(points).solve()`` then
     ``get_knearests_original()`` -- on 900k blue noise at k=10 and 300k
     blue noise at k=50, and a clustered 300k cloud with ring_radius=1 that
     needs several classes and the exact fallback; each solve must launch
     the kernel once per class, stay within two host round trips, and agree
     with scipy's cKDTree on 20,000 sampled rows (tie-aware);
  4. breaks one 900k/k=10 and one 300k/k=50 solve down by device time
     (torch.profiler);
  5. times the kernel at both blue-noise class shapes against its plain
     version, a ``torch.cdist`` + ``torch.topk`` yardstick and its bound,
     and requires the timed kernel's outputs, in both modes, to equal the
     plain version's (the JSON line carries the 900k/k=10 shape).

Any failed check exits non-zero without printing a result.  The last three
lines are the card, one JSON object of kernel measurements, and
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 2.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

# Tie-aware tolerance on squared distances over the [0, 1000]^3 domain
# (d2 <= 3e6, float32 ulp there ~0.25): the same band the reference
# package's differential comparator uses.
RTOL = 1e-4
ATOL = 1e-2
# Published peaks of one H100 SXM at its full 700 W power limit.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
SAMPLE_ROWS = 20_000
DEV = "cuda"
REPLACES = "cuda_knearests_tpu/ops/pallas_solve.py:480"
SOURCE = "cuda_knearests_tpu_torch/csrc/supercell_topk.cu"


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events), after
    one warm-up call."""
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


# -- phase 2: kernel against its plain version --------------------------------

def synthetic_pack(rng, n_sc: int, qcap: int, ccap: int, max_real_c: int):
    """A random class pack on a coarse lattice (many exact distance ties):
    per supercell a random number of real candidates (some below k, some
    none), its queries a subset of its candidates (so exclude_self bites),
    pads with garbage coordinates and sentinel ids, and a forward row map
    over the real query slots."""
    import torch

    from cuda_knearests_tpu_torch.ops.cuda_solve import _PAD_C, _PAD_Q

    cx = rng.integers(0, 24, (n_sc, ccap)).astype(np.float32) * 7.5
    cy = rng.integers(0, 24, (n_sc, ccap)).astype(np.float32) * 7.5
    cz = rng.integers(0, 24, (n_sc, ccap)).astype(np.float32) * 7.5
    cid = np.full((n_sc, ccap), _PAD_C, np.int32)
    qx = rng.random((n_sc, qcap)).astype(np.float32) * 1000
    qy = rng.random((n_sc, qcap)).astype(np.float32) * 1000
    qz = rng.random((n_sc, qcap)).astype(np.float32) * 1000
    qid = np.full((n_sc, qcap), _PAD_Q, np.int32)
    n_real_q = 0
    for s in range(n_sc):
        nc = int(rng.integers(0, max_real_c + 1))
        slots = rng.permutation(ccap)[:nc]
        cid[s, slots] = rng.permutation(1 << 20)[:nc]
        nq = min(qcap, nc, int(rng.integers(0, qcap + 1)))
        pick = slots[rng.permutation(nc)[:nq]]
        qx[s, :nq], qy[s, :nq], qz[s, :nq] = cx[s, pick], cy[s, pick], \
            cz[s, pick]
        qid[s, :nq] = cid[s, pick]
        n_real_q += nq
    real = (qid >= 0).reshape(-1)
    tgt = np.full(n_sc * qcap, n_real_q, np.int32)
    tgt[real] = rng.permutation(n_real_q)
    dev = torch.device(DEV)
    arrays = [torch.as_tensor(a, device=dev)
              for a in (qx, qy, qz, qid, cx, cy, cz, cid)]
    return arrays, torch.as_tensor(tgt, device=dev), n_real_q


def row_buffers(n_rows: int, k: int):
    import torch

    return (torch.full((n_rows, k), float("inf"), device=DEV),
            torch.full((n_rows, k), -1, dtype=torch.int32, device=DEV))


def require_equal(what: str, got, want) -> float:
    """Kernel (d2, ids) must equal the plain version's; returns the largest
    |d2 difference| over finite entries (0 when equal)."""
    import torch

    torch.cuda.synchronize()
    (a_d, a_i), (b_d, b_i) = got, want
    require(torch.equal(a_i, b_i),
            f"{what}: kernel ids differ from the plain version at "
            f"{int((a_i != b_i).sum())} entries")
    require(torch.equal(a_d, b_d),
            f"{what}: kernel d2 differs from the plain version at "
            f"{int((a_d != b_d).sum())} entries")
    fin = torch.isfinite(b_d)
    return float((a_d - b_d)[fin].abs().max()) if bool(fin.any()) else 0.0


def compare_modes(name, args, tgt, n_rows, k, exclude_self) -> float:
    """Kernel vs plain version in both modes; returns the largest
    |d2 difference| over finite entries (0 when equal)."""
    from cuda_knearests_tpu_torch.ops import cuda_solve as cs

    err = require_equal(f"{name} raw",
                        cs.supercell_topk(*args, k, exclude_self),
                        cs.supercell_topk_plain(*args, k, exclude_self))
    err = max(err, require_equal(
        f"{name} rows",
        cs.supercell_topk(*args, k, exclude_self, tgt=tgt,
                          out=row_buffers(n_rows, k)),
        cs.supercell_topk_plain(*args, k, exclude_self, tgt=tgt,
                                out=row_buffers(n_rows, k))))
    print(f"  {name}: k={k} exclude_self={exclude_self} S={args[0].shape[0]}"
          f" Q={args[0].shape[1]} C={args[4].shape[1]}: equal in both modes",
          flush=True)
    return err


# A class whose padded (query, candidate) pairs exceed this is checked on a
# few of its supercells, so the plain version stays within seconds.
WHOLE_CLASS_PAIRS = 1 << 30


def class_slices(cp):
    """The packed inputs and forward row map of a whole class, or of the
    supercells of a wide class that carry the most real pairs, the most
    real queries (the one that sets qcap, so every query tile runs) and
    the most real candidates, plus its first."""
    import torch

    if cp.n_sc * cp.qcap * cp.ccap <= WHOLE_CLASS_PAIRS:
        return "whole", list(cp.pk.args()), cp.tgt
    nq = (cp.pk.qid >= 0).sum(1).long()
    nc = (cp.pk.cid >= 0).sum(1).long()
    pick = torch.unique(torch.cat([
        torch.topk(nq * nc, min(6, cp.n_sc)).indices,
        nq.argmax()[None], nc.argmax()[None],
        torch.zeros(1, dtype=torch.long, device=nq.device)]))
    args = [a[pick].contiguous() for a in cp.pk.args()]
    tgt = cp.tgt.view(cp.n_sc, cp.qcap)[pick].reshape(-1).contiguous()
    return f"{pick.numel()} supercells", args, tgt


def kernel_checks(problems) -> float:
    """Every class of the prepared problems (whole, or sliced when wide),
    then synthetic packs."""
    rng = np.random.default_rng(2024)
    err = 0.0
    for name, prob, cfg in problems:
        for ci, cp in enumerate(prob.aplan.classes):
            what, args, tgt = class_slices(cp)
            err = max(err, compare_modes(
                f"{name} class {ci} ({what})", args, tgt,
                prob.grid.n_points, cfg.k, cfg.exclude_self))
    shapes = [(1, 40, 100, 700, 60), (10, 40, 100, 700, 60),
              (10, 12, 300, 520, 520), (50, 40, 100, 1000, 200),
              (128, 20, 100, 600, 400)]
    for k, n_sc, qcap, ccap, max_c in shapes:
        args, tgt, n_rows = synthetic_pack(rng, n_sc, qcap, ccap, max_c)
        for excl in (True, False):
            err = max(err, compare_modes("synthetic", args, tgt, n_rows,
                                         k, excl))
    return err


# -- phase 3/4: the main path --------------------------------------------------

def check_exact(points: np.ndarray, nbrs: np.ndarray, rows: np.ndarray,
                k: int, tree) -> None:
    """Rows of the original-order neighbour table against the kd-tree,
    tie-aware: valid unique ids, not the query itself, distances realized
    and equal to the tree's as multisets, and every tree neighbour strictly
    inside the k-th distance's tolerance band present."""
    q = points[rows].astype(np.float64)
    dk, ik = tree.query(q, k=k + 1)
    is_self = ik == rows[:, None]
    keep = ~is_self
    keep[~is_self.any(axis=1), -1] = False
    dk = (dk[keep].reshape(-1, k)) ** 2
    ik = ik[keep].reshape(-1, k)
    ids = nbrs[rows]
    require(bool((ids >= 0).all()), "a sampled row has missing neighbours")
    require(bool((ids != rows[:, None]).all()), "a row lists its own point")
    srt = np.sort(ids, axis=1)
    require(not bool((np.diff(srt, axis=1) == 0).any()),
            "a row repeats a neighbour")
    dp = ((points[ids].astype(np.float64) - q[:, None, :]) ** 2).sum(-1)
    require(bool(np.allclose(np.sort(dp, axis=1), dk, rtol=RTOL, atol=ATOL)),
            "sampled rows disagree with the kd-tree's distances")
    band = ATOL + RTOL * dk[:, -1:]
    must = dk < dk[:, -1:] - band
    for r in np.nonzero(must.any(axis=1))[0]:
        missing = set(ik[r][must[r]].tolist()) - set(ids[r].tolist())
        require(not missing, f"row {rows[r]} misses kd-tree neighbours "
                             f"{sorted(missing)}")


def main_path(name: str, points: np.ndarray, cfg, runs: int,
              expect_multi: bool = False):
    """Prepare once, solve 1 + ``runs`` times, check every solve's launches
    and round trips, and the answers against the kd-tree."""
    import torch
    from scipy.spatial import cKDTree

    import cuda_knearests_tpu_torch as pt
    from cuda_knearests_tpu_torch.ops import cuda_solve as cs
    from cuda_knearests_tpu_torch.runtime import dispatch

    t0 = time.perf_counter()
    prob = pt.KnnProblem.prepare(points, cfg, device=DEV)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    n_cls = len(prob.aplan.classes)
    times, launches, max_syncs = [], 0, 0
    for i in range(1 + runs):
        cs.launches = 0
        dispatch.reset_stats()
        t0 = time.perf_counter()
        res = prob.solve()
        dt = time.perf_counter() - t0
        syncs = dispatch.stats().host_syncs
        require(cs.launches == n_cls,
                f"{name}: solve launched the kernel {cs.launches} times for "
                f"{n_cls} classes")
        require(syncs <= dispatch.SYNC_BUDGET,
                f"{name}: solve made {syncs} host round trips")
        launches += cs.launches
        max_syncs = max(max_syncs, syncs)
        if i:
            times.append(dt)
    n = prob.grid.n_points
    unc = int(res.uncert_count)
    nbrs = prob.get_knearests_original()
    require(nbrs.shape == (n, cfg.k), f"{name}: result shape {nbrs.shape}")
    require(bool(np.isfinite(prob.get_dists_sq()).all()),
            f"{name}: non-finite distances")
    require(bool(np.asarray(res.certified).all()),
            f"{name}: rows left uncertified after the fallback")
    if expect_multi:
        require(n_cls > 1 and unc > 0,
                f"{name}: expected several classes and fallback rows, got "
                f"{n_cls} classes, {unc} fallback rows")
    rng = np.random.default_rng(7)
    bad = np.empty(0, np.int64)
    if unc:  # the fallback rows, in original indexing
        cert = solve_certificates(prob, cfg)
        bad = prob.get_permutation()[np.nonzero(~cert)[0]].astype(np.int64)
    take = bad[rng.permutation(bad.size)[:2000]]
    rest = rng.permutation(n)[: SAMPLE_ROWS - take.size]
    rows = np.unique(np.concatenate([take, rest])).astype(np.int64)
    t0 = time.perf_counter()
    tree = cKDTree(points.astype(np.float64))
    check_exact(points, nbrs, rows, cfg.k, tree)
    med = float(np.median(times))
    kernel_ms, _ = class_kernel_ms(prob, cfg.k, cfg.exclude_self,
                                   reps=1 if med > 0.5 else 10)
    print(f"  {name}: n={n} k={cfg.k} classes={n_cls} "
          f"(qcap, ccap, radius, supercells)="
          f"{[(c.qcap, c.ccap, c.radius, c.n_sc) for c in prob.aplan.classes]}"
          f"\n    prepare {prep_s:.3f} s; solve median of {runs} "
          f"{med * 1e3:.3f} ms = {n / med:,.0f} queries/s "
          f"(runs ms {[round(t * 1e3, 3) for t in times]}); kernel "
          f"{kernel_ms:.4f} ms per solve (CUDA events)"
          f"\n    launches per solve {n_cls}; certified fraction "
          f"{1 - unc / n:.6f}; fallback rows {unc}; host round trips "
          f"{max_syncs} (max over solves, budget {dispatch.SYNC_BUDGET}); "
          f"exact vs cKDTree on {rows.size} rows "
          f"({take.size} of them fallback rows), checked in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return prob, launches, med


def class_kernel_ms(prob, k: int, exclude_self: bool, reps: int):
    """Device ms of one solve's kernel launches (mode (a), every class),
    outside the counted main-path runs, and the (d2, ids) rows they
    wrote."""
    from cuda_knearests_tpu_torch.ops import cuda_solve as cs

    out = row_buffers(prob.grid.n_points, k)

    def kernel():
        for cp in prob.aplan.classes:
            cs.supercell_topk(*cp.pk.args(), k, exclude_self, tgt=cp.tgt,
                              out=out)

    before = cs.launches
    ms = cuda_ms(kernel, reps)
    cs.launches = before
    return ms, out


def solve_certificates(prob, cfg):
    """The pre-fallback certificate mask of one more solve (device side)."""
    from cuda_knearests_tpu_torch.ops.adaptive import solve_adaptive
    from cuda_knearests_tpu_torch.ops import cuda_solve as cs

    before = cs.launches
    cert = solve_adaptive(prob.grid, cfg, prob.aplan).certified.cpu().numpy()
    cs.launches = before
    return cert


# -- phase 5: timing at the main path's class shape -----------------------------

def class_timing(name: str, prob, k: int, exclude_self: bool) -> dict:
    """The kernel over every class of a prepared problem (mode (a), as the
    solve launches it) against its plain version and a cdist + topk
    yardstick, with the bound: the larger of the input and output bytes
    over the HBM rate and the pair arithmetic over the f32 rate.  The
    timed kernel's outputs, in both modes, must equal the plain
    version's; returns the timings and the largest |d2 difference|."""
    import torch

    from cuda_knearests_tpu_torch.ops import cuda_solve as cs

    n = prob.grid.n_points
    plain_out = row_buffers(n, k)
    classes = prob.aplan.classes

    def plain():
        for cp in classes:
            cs.supercell_topk_plain(*cp.pk.args(), k, exclude_self,
                                    tgt=cp.tgt, out=plain_out)

    stacked = [(torch.stack([cp.pk.qx, cp.pk.qy, cp.pk.qz], dim=-1),
                torch.stack([cp.pk.cx, cp.pk.cy, cp.pk.cz], dim=-1),
                max(1, (1 << 26) // (cp.qcap * cp.ccap))) for cp in classes]

    def library():
        for q, c, step in stacked:
            for s0 in range(0, q.shape[0], step):
                d = torch.cdist(q[s0:s0 + step], c[s0:s0 + step])
                torch.topk(d, k, dim=-1, largest=False)

    raw_out = []

    def kernel_raw():
        raw_out[:] = [cs.supercell_topk(*cp.pk.args(), k, exclude_self)
                      for cp in classes]

    ms, kernel_out = class_kernel_ms(prob, k, exclude_self, reps=20)
    before = cs.launches
    raw_ms = cuda_ms(kernel_raw, 20)
    cs.launches = before
    plain_ms = cuda_ms(plain, 3)
    library_ms = cuda_ms(library, 3)
    err = require_equal(f"{name} rows (timed)", kernel_out, plain_out)
    for ci, (cp, got) in enumerate(zip(classes, raw_out)):
        err = max(err, require_equal(
            f"{name} class {ci} raw (timed)", got,
            cs.supercell_topk_plain(*cp.pk.args(), k, exclude_self)))
    print(f"  {name}: the timed kernel's outputs equal the plain version's "
          f"in both modes", flush=True)
    in_bytes = sum(a.numel() * a.element_size()
                   for cp in classes for a in (*cp.pk.args(), cp.tgt))
    out_bytes = n * k * 8
    raw_out_bytes = sum(cp.n_sc * cp.qcap * k * 8 for cp in classes)
    pairs = sum(int(((cp.pk.qid >= 0).sum(1).long()
                     * (cp.pk.cid >= 0).sum(1).long()).sum())
                for cp in classes)
    flops = 8 * pairs  # 3 subtractions, 3 multiplications, 2 additions
    t_bytes = (in_bytes + out_bytes) / PEAK_HBM_BYTES * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"cdist+topk {library_ms:.4f} ms; bytes {in_bytes + out_bytes} "
          f"-> {t_bytes:.4f} ms at 3.35 TB/s; pairs {pairs}, {flops} f32 "
          f"ops -> {t_ops:.4f} ms at 67 TFLOP/s", flush=True)
    raw_bytes = in_bytes - sum(cp.tgt.numel() * 4 for cp in classes) \
        + raw_out_bytes
    print(f"  {name} raw (S, k, Q) layout: kernel {raw_ms:.4f} ms; bytes "
          f"{raw_bytes} -> {raw_bytes / PEAK_HBM_BYTES * 1e3:.4f} ms; bound "
          f"{max(raw_bytes / PEAK_HBM_BYTES * 1e3, t_ops):.4f} ms",
          flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}, err


def solve_breakdown(name: str, prob) -> None:
    """Device time by kernel of one warm solve under torch.profiler, and
    the device's busy share of the solve's (profiled) wall time."""
    from torch.profiler import ProfilerActivity, profile

    from cuda_knearests_tpu_torch.ops import cuda_solve as cs

    prob.solve()
    cs.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prob.solve()
        wall_ms = (time.perf_counter() - t0) * 1e3
    require(cs.launches == len(prob.aplan.classes),
            f"{name}: profiled solve launched {cs.launches} kernels")
    rows = []
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = getattr(e, "cuda_time_total", 0)
            rows.append((us / 1e3, e.count, e.key))
    busy = sum(r[0] for r in rows)
    print(f"  {name}: one solve {wall_ms:.3f} ms wall under the profiler; "
          f"device busy {busy:.3f} ms ({busy / wall_ms:.1%} of wall)",
          flush=True)
    if not rows:
        print("    the profiler recorded no device time", flush=True)
    for ms, count, key in sorted(rows, reverse=True)[:8]:
        print(f"    {ms:9.4f} ms  x{count:<3d} {key[:80]}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import cuda_knearests_tpu_torch as pt
    from cuda_knearests_tpu_torch.io import (generate_blue_noise,
                                             generate_clustered)
    from cuda_knearests_tpu_torch.ops import _build

    card = card_line()
    print(f"device: {card} ({torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda})", flush=True)
    t0 = time.perf_counter()
    _build.load("supercell_topk")
    print(f"build: supercell_topk.cu in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for line in _build.BUILD_LOGS.get("supercell_topk", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    print("phase: main-path problems", flush=True)
    pts900 = generate_blue_noise(900_000, seed=900)
    pts300 = generate_blue_noise(300_000, seed=301)
    pts_cl = generate_clustered(300_000, seed=5)
    cfg10, cfg50 = pt.KnnConfig(k=10), pt.KnnConfig(k=50)
    cfg_cl = pt.KnnConfig(k=10, ring_radius=1)
    checked = [(name, pt.KnnProblem.prepare(pts, cfg, device=DEV), cfg)
               for name, pts, cfg in (("300k/k=50", pts300, cfg50),
                                      ("300k clustered", pts_cl, cfg_cl))]

    print("phase: kernel against its plain version on the card", flush=True)
    max_err = kernel_checks(checked)
    del checked

    print("phase: main path", flush=True)
    prob10, launches, _ = main_path("900k blue noise", pts900, cfg10, runs=5)
    prob50, _, _ = main_path("300k blue noise", pts300, cfg50, runs=5)
    main_path("300k clustered", pts_cl, cfg_cl, runs=2, expect_multi=True)

    print("phase: where one solve's device time goes", flush=True)
    solve_breakdown("900k/k=10", prob10)
    solve_breakdown("300k/k=50", prob50)

    print("phase: timing at the main path's class shapes", flush=True)
    timing, err10 = class_timing("900k/k=10", prob10, 10, True)
    _, err50 = class_timing("300k/k=50", prob50, 50, True)

    kernels = [dict(name="supercell_topk", route="cuda", source=SOURCE,
                    replaces=REPLACES, launches=launches,
                    max_abs_err=max(max_err, err10, err50), **timing)]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
