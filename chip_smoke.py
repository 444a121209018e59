#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check every result.

    python3 chip_smoke.py

Run from the root of a checkout on a host with one CUDA GPU (built for an
H100: the kernels target sm_90a).  It imports only the port
(``cuda_knearests_tpu_torch``), never JAX or the reference package.  It:

  1. prints the card (``nvidia-smi`` name and power limit) and builds the
     five kernel sources of ``csrc/`` from the checkout, one ``nvcc`` each,
     all at once, printing their ptxas lines;
  2. holds each kernel against its plain torch version on the card, equal
     bit for bit (``torch.equal``; NaN deficit flags in the same places),
     except the bf16 selection, which is held to its source's contract:
     - ``supercell_topk`` in both output modes on every class of the
       300k/k=50 and 300k clustered plans (whole, or a wide class's
       largest supercells) and on synthetic packs (k in {1, 10, 50, 128},
       exclude_self on and off, rows with fewer than k candidates, ragged
       query tiles, coarse-lattice ties), then at every list width the
       kernel instantiates and its edges (k in {1, 10, 31, 32, 33, 50, 64,
       65, 128, 500, 892}) with qcap 45 and an all-pad supercell, and at
       ccaps beyond the staged tile (candidates streamed in tiles);
     - ``blocked_topk`` in both modes on the class packs of 900k/k=10,
       300k/k=50 and the 300k clustered plan (its wide class sliced), as
       packed and with candidates crowded in stored-id order, on synthetic
       packs at several m, and at ``BLOCKED_SHAPES``: every list width up
       to the gate's edge (k + m = 892), m = 128, and ccaps beyond the
       staged tile, as made and crowded by x; each check prints the rows
       the kernel answers block by block (counted from the plain version)
       and the deficit rows;
     - ``mxu_select`` (f32) and ``mxu_select_bf16`` at d in {1, 3, 17,
       128}, k in {1, 10, 50, 128}, m in {1, 3, min(k, 128)}, exclude_self
       on and off, n = 1000 and n = 40 < k candidates, 300 and 40
       queries, and well-separated blobs (k = 9 and 10) where bf16 rows
       certify: f32 bit for bit; bf16 prep bit for bit, the selection bit
       for bit on lattice coordinates (exact partial sums) and elsewhere
       2*delta_max within the f32 term of B, 4*(d+8)*eps32*(qn + pn_max),
       and every selected score within the row's 2*delta_max (delta_max
       measured from the kernel's own scores); certified rows exact against
       an f64 brute force, and on the blobs at m = k at least 90% certified;
       then the f32 selection alone, and its prep pass, bit for bit at
       ``F32_WIDE``: d=64 (resident queries, two d-chunks), d=300 and
       d=2,048 (queries streamed in d-chunks), and k=900 and 1,707 in
       16-row blocks;
     - ``mxu_select_split`` bit for bit at both tiers at ``SPLIT_SHAPES``,
       both arms at m = 128: m < 128 (the fold's sort) and m = 128, n < k
       and n = k + 1, the gate-refused k=1,800 (d=3; 3,000 queries, and
       lattice ties that overflow the row) and 1,590 (d=128), d on either
       side of the arms' threshold, and k=2,100 and 8,200 (sort rows in
       scratch);
  3. runs the grid main path -- ``KnnProblem.prepare(points).solve()`` then
     ``get_knearests_original()`` -- on 900k blue noise at k=10, 300k blue
     noise at k=50 and a clustered 300k cloud (ring_radius=1, several
     classes, exact fallback); each solve must launch the kernel once per
     class, stay within two host round trips, and agree with scipy's
     cKDTree on 20,000 sampled rows (tie-aware);
  4. breaks one 900k/k=10 and one 300k/k=50 solve down by device time
     (torch.profiler);
  5. runs the brute route ``mxu.solve_general`` at full width on 300k
     uniform 3-D points (k=10: f32 exact with the brute refine, then
     recall targets 0.95/0.8/0.6 unrefined at f32 and bf16) and on 100k
     uniform points at d=128 (f32 exact refined; f32 and bf16 at 0.9
     unrefined): one selection launch and at most two host round trips per
     solve, refined answers exact on sampled rows (cKDTree at d=3, an f64
     brute force at d=128), every certified sampled row exact, and recall
     on the sampled rows at least the fold's bound at the 2B band; then
     one solve at k=1,800 on 20k uniform 3-D points, which the one-block
     kernels' gates refuse: it runs the split selection (backend
     'cuda_split', no one-block launch), exact against cKDTree on 2,000
     sampled rows;
  6. runs the grid main path with ``KnnConfig(kernel='blocked')`` on the
     900k/k=10 cloud: the blocked kernel launched, per-block and deficit
     rows counted, exact vs cKDTree, and the same distances as the
     one-stage path;
  7. runs the grid main path at k=1000 on 100k blue noise, where no class
     kernel holds the lists and every class takes the streamed route: no
     class-kernel launch, exact vs cKDTree on 2,000 sampled rows, each
     streamed class's peak allocation within the plan's memory model, the
     route of each class and the streamed route's time printed;
  8. answers external queries (``KnnProblem.query``) against the 900k/k=10
     problem: (i) 1,000,000 uniform queries (20,000 sampled rows exact
     against cKDTree, ``query_radius`` on 2,000 of them against
     ``cKDTree.query_ball_point``), (ii) 200,000 clustered queries (whose
     fullest supercell inflates the padded query capacity q2cap), (iii)
     (i) under ``kernel='blocked'``, equal to (i), and (iv) 20,000 uniform
     queries against a 300k cloud confined to x < 500, whose queries in
     empty supercells the exact fallback answers (all rows exact); each
     call launches the class kernel once per kernel-route class and makes
     at most two host round trips; (i) and (ii) print their route, q2cap,
     query-pack bytes, queries/s, the kernel's time on the query packs
     (held to its plain version) and one profiled call's device busy
     share and device-to-host copies;
  9. runs friends-of-friends (``cluster.fof_labels``, plain torch rounds)
     on the reference's pts300K.xyz (300,000 points) at b = 14.938 (its
     mean spacing) and 2.988: 1 cold and 5 warm calls in rounds + 1 host
     round trips, labels and sizes equal to the same call on the CPU and
     inside the bracket of cKDTree's pairs at sqrt(b^2 -+ band) (the
     union-find oracle's, ``cluster.compare.check_fof_bracket``), with the
     host twin, the staging (the links scored once) and the rounds'
     device time, kernels and host wall under torch.profiler; then
     requires the 900k blue cube at b = 10.357 to be refused with
     ``LaunchBudgetError`` before any allocation on the card, as the
     reference refuses it; then one 900k/k=10 solve with
     ``plane_feed=True`` and one ``query(planes=True)`` of (i)'s 1M
     queries, each through the class kernel in at most two host round
     trips with planes bit-identical to a float64 recompute from its ids;
 10. serves the 900k/k=10 problem through the serving daemon
     (``serve.ServeDaemon`` driven by ``serve.run_session``, open-loop
     Poisson traffic at the reference bench's serve sessions: steady 400/s,
     mutating 20%, an injected oom batch plus a malformed probe, and 50%
     mutations at compact_threshold=256 forcing compactions of the 900k
     cloud), each session on a fresh daemon with zero recompiles (kernel
     builds plus library loads), the class kernel launched and no failed
     request but the injected batch's; answers exact against cKDTree, and
     with mutations pending 8 batches of 256 queries through the overlay
     bit for bit equal in d2 to a rebuild (ids but in exact ties), each
     batch split into host bucketing, class-kernel device ms, the query
     pack's pad share and the overlay's brute calls; a fof request on the
     900k daemon refused as one typed oom failure, the daemon still
     serving; and a FoF session on pts300K.xyz whose labels equal
     ``fof_labels`` of the mutated cloud, a repeat a memo hit;
 11. times each kernel at its main path's shapes against its plain version
     (the selections' plain version on 1,024 of the queries), a PyTorch
     library yardstick and its bound (for supercell_topk and at f32 also
     the --fmad=false ceiling, twice the operations bound, and the
     one-stage kernel's launch geometry), and requires the timed outputs to equal
     the plain version's (bf16: to meet the contract above); the bf16
     selection also at m = k, where its fold takes the m >= 2 path; the
     blocked kernel at 900k/k=10, 300k/k=50 and on the 900k packs crowded
     in stored-id order; the split selection's arm, launches and passes
     at m = 128 and m = 100, and both arms at d=3 and d=128 (the
     measurement behind ``_SPLIT_DIRECT_MAX_D``), which must agree.

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
# Published peaks of one H100 SXM at its full 700 W power limit: FP32 on
# the CUDA cores, dense BF16 on the tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
SAMPLE_ROWS = 20_000
DEV = "cuda"
CSRC = "cuda_knearests_tpu_torch/csrc/"
KERNELS = ("supercell_topk", "blocked_topk", "mxu_select", "mxu_select_bf16",
           "mxu_select_split")
REPLACES = {
    "supercell_topk": "cuda_knearests_tpu/ops/pallas_solve.py:480",
    "blocked_topk": "cuda_knearests_tpu/ops/pallas_solve.py:168",
    "mxu_select": "cuda_knearests_tpu/mxu/kernel.py:59",
    "mxu_select_bf16": "cuda_knearests_tpu/mxu/kernel.py:59",
    # the reference's arm for the shapes its selection kernel refuses
    "mxu_select_split": "cuda_knearests_tpu/mxu/scorer.py:209",
}


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


def quiet(fn):
    """Run ``fn`` (launches made to check or time a kernel) and restore
    every kernel's launch count: only the main paths' launches count."""
    from cuda_knearests_tpu_torch.mxu import kernel as mk
    from cuda_knearests_tpu_torch.ops import cuda_solve as cs

    saved = (cs.launches, cs.blocked_launches, mk.launches,
             mk.launches_bf16, mk.split_launches, mk.prep_launches,
             mk.prep_launches_f32)
    try:
        return fn()
    finally:
        (cs.launches, cs.blocked_launches, mk.launches, mk.launches_bf16,
         mk.split_launches, mk.prep_launches, mk.prep_launches_f32) = saved


# -- phase 2: kernels against their plain versions ----------------------------

def synthetic_pack(rng, n_sc: int, qcap: int, ccap: int, max_real_c: int,
                   pad_last: bool = False):
    """A random class pack on a coarse lattice (many exact distance ties):
    per supercell a random number of real candidates (some below k, some
    none; none in the last with ``pad_last``, an all-pad supercell), its
    queries a subset of its candidates (so exclude_self bites), pads with
    garbage coordinates and sentinel ids, and a forward row map over the
    real query slots."""
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
        if pad_last and s == n_sc - 1:
            nc = 0
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
    """Kernel outputs must equal the plain version's: the ids (and any
    further exact arrays, such as certificates) with ``torch.equal``, the
    distances or scores (first array) with NaN in the same places and
    equal elsewhere.  Returns the largest |difference| over finite entries
    (0 when equal)."""
    import torch

    torch.cuda.synchronize()
    a_d, b_d = got[0], want[0]
    for n, (a, b) in enumerate(zip(got[1:], want[1:])):
        require(torch.equal(a, b),
                f"{what}: kernel output {n + 1} differs from the plain "
                f"version at {int((a != b).sum())} entries")
    nan = torch.isnan(b_d)
    require(torch.equal(torch.isnan(a_d), nan),
            f"{what}: NaN deficit flags differ at "
            f"{int((torch.isnan(a_d) != nan).sum())} entries")
    require(torch.equal(a_d[~nan], b_d[~nan]),
            f"{what}: kernel d2 differs from the plain version at "
            f"{int((a_d[~nan] != b_d[~nan]).sum())} entries")
    fin = torch.isfinite(b_d)
    return float((a_d - b_d)[fin].abs().max()) if bool(fin.any()) else 0.0


def compare_modes(name, args, tgt, n_rows, k, exclude_self, m=0) -> float:
    """Kernel vs plain version in both modes (``m`` > 0: the blocked
    kernel); returns the largest |d2 difference| over finite entries."""
    import torch

    from cuda_knearests_tpu_torch.ops import cuda_solve as cs

    if m:
        kern = lambda *a, **kw: cs.blocked_topk(*a[:9], m, *a[9:], **kw)  # noqa: E731
        plain = lambda *a, **kw: cs.blocked_topk_plain(  # noqa: E731
            *a[:9], m, *a[9:], **kw)
    else:
        kern, plain = cs.supercell_topk, cs.supercell_topk_plain
    raw = quiet(lambda: kern(*args, k, exclude_self))
    err = require_equal(f"{name} raw", raw, plain(*args, k, exclude_self))
    err = max(err, require_equal(
        f"{name} rows",
        quiet(lambda: kern(*args, k, exclude_self, tgt=tgt,
                           out=row_buffers(n_rows, k))),
        plain(*args, k, exclude_self, tgt=tgt, out=row_buffers(n_rows, k))))
    blocked = ""
    if m:
        # real slots are those with a destination row; on a query pack
        # every qid is a pad
        real = ((tgt >= 0) & (tgt < n_rows)).view(args[3].shape)
        deficit = (torch.isnan(raw[0][:, k - 1, :]) & real).sum()
        blocked = (f"; per-block rows "
                   f"{per_block_rows(args, k, m, exclude_self, real)}"
                   f", deficit rows {int(deficit)}")
    print(f"  {name}: k={k}{f' m={m}' if m else ''} exclude_self="
          f"{exclude_self} S={args[0].shape[0]} Q={args[0].shape[1]} "
          f"C={args[4].shape[1]}: equal in both modes{blocked}", flush=True)
    return err


def per_block_rows(args, k: int, m: int, exclude_self: bool,
                   real=None) -> int:
    """Real query slots (``real``, (S, Q) bool; default: those with a
    stored id) whose exact top-k (``supercell_topk_plain``) holds more
    than m entries of one 128-slot candidate block: the rows the blocked
    kernel answers block by block, counted from the plain version."""
    import torch

    from cuda_knearests_tpu_torch.ops import cuda_solve as cs

    if m >= k:
        return 0
    ids = cs.supercell_topk_plain(*args, k, exclude_self)[1].transpose(1, 2)
    cid = args[7]
    srt, order = torch.sort(cid, dim=1)
    flat = ids.reshape(ids.shape[0], -1).contiguous()
    slot = order.gather(1, torch.searchsorted(srt, flat).clamp(
        max=cid.shape[1] - 1))
    # missing entries get distinct negative blocks; sorted, a row has more
    # than m entries in one block where entry j equals entry j + m
    col = torch.arange(flat.shape[1], device=flat.device)
    blk = torch.where(flat >= 0, slot // 128, -1 - col).view(ids.shape)
    blk = torch.sort(blk, dim=-1).values
    if real is None:
        real = args[3] >= 0
    over = (blk[..., m:] == blk[..., :-m]).any(-1) & real
    return int(over.sum())


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


def crowded(args, by_x: bool = False):
    """A pack with each supercell's candidates in stored-id order (grid
    order) instead of interleaved, or with ``by_x`` in ascending x (for
    synthetic packs, whose ids are random): spatial neighbours crowd into
    one 128-slot block, so the blocked kernel meets rows where a block
    holds more than m of the exact top-k, and deficit rows."""
    import torch

    key = args[4] if by_x else torch.where(args[7] >= 0, args[7], 2**30)
    order = torch.sort(key, dim=1, stable=True).indices
    return list(args[:4]) + [torch.gather(a, 1, order).contiguous()
                             for a in args[4:]]


# (k, supercells, qcap, ccap): every list width the
# one-stage kernel instantiates and its edges (k = 32*E, one past it, and
# k = 892, the gate's last), at a qcap that is not a multiple of 32 with
# an all-pad supercell; then ccaps beyond the staged tile (_TOPK_TILE), so
# the candidates stream in tiles.
LIST_WIDTH_SHAPES = [(k, 8, 45, max(384, -(-(k + 100) // 128) * 128))
                     for k in (1, 10, 31, 32, 33, 50, 64, 65, 128, 500, 892)]
TILED_SHAPES = [(10, 4, 70, 6477), (50, 3, 70, 9300)]


def kernel_checks(problems) -> float:
    """supercell_topk: every class of the prepared problems (whole, or
    sliced when wide), then synthetic packs: the earlier shapes, every
    list width, and wide ccaps (tiled staging)."""
    from cuda_knearests_tpu_torch.ops import cuda_solve as cs

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
    for k, n_sc, qcap, ccap in LIST_WIDTH_SHAPES + TILED_SHAPES:
        args, tgt, n_rows = synthetic_pack(rng, n_sc, qcap, ccap, ccap,
                                           pad_last=True)
        plan = cs.topk_plan(k, qcap, ccap)
        for excl in (True, False):
            err = max(err, compare_modes(
                f"synthetic {plan} {'tiled' if plan.tile < ccap else 'resident'}",
                args, tgt, n_rows, k, excl))
    return err


def blocked_ccap(k: int) -> int:
    """The narrowest ccap, a multiple of 128 of at least 384 and k + 100,
    at which ``blocked_topm`` finds k eligible."""
    from cuda_knearests_tpu_torch.config import blocked_topm

    ccap = max(384, -(-(k + 100) // 128) * 128)
    while not blocked_topm(k, ccap):
        ccap += 128
    return ccap


# (k, supercells, qcap, ccap, m; m=0: blocked_topm's) of the blocked
# kernel: every list width and its edges up to the gate's (k + m = 892 at
# k = 876), each at the narrowest ccap blocked_topm takes (k = 128, 500 and
# 876 stream theirs in tiles), qcap 45 with an all-pad supercell; m = 128
# (blocks keep all they hold); and ccaps beyond the staged tile.
BLOCKED_SHAPES = (
    [(k, 8, 45, None, 0) for k in (1, 10, 31, 32, 33, 50, 64, 65, 128, 500,
                                   876)]
    + [(10, 6, 45, 1152, 128), (764, 6, 45, 896, 128)]
    + [(10, 4, 70, 6272, 0), (50, 3, 70, 9344, 0)])


def blocked_checks(problems) -> float:
    """blocked_topk: the class packs of the given problems at the m their
    k and ccap give (whole, or a wide class's largest supercells; as
    packed and crowded), synthetic packs at that m, at m=1 and at m=16,
    then ``BLOCKED_SHAPES`` as made and crowded by x.  Each check prints
    its per-block and deficit rows."""
    from cuda_knearests_tpu_torch.config import blocked_topm
    from cuda_knearests_tpu_torch.ops import cuda_solve as cs

    rng = np.random.default_rng(2025)
    err = 0.0
    for name, prob, cfg in problems:
        for ci, cp in enumerate(prob.aplan.classes):
            m = blocked_topm(cfg.k, cp.ccap)
            require(m > 0, f"{name} class {ci}: not blocked-eligible")
            what, args, tgt = class_slices(cp)
            for layout, pack in (("packed", args), ("crowded",
                                                    crowded(args))):
                err = max(err, compare_modes(
                    f"{name} class {ci} ({what}, {layout})", pack, tgt,
                    prob.grid.n_points, cfg.k, True, m))
    for k, n_sc, qcap, ccap, max_c in [(10, 12, 100, 768, 700),
                                       (30, 8, 96, 1280, 1200),
                                       (16, 10, 50, 1152, 400)]:
        args, tgt, n_rows = synthetic_pack(rng, n_sc, qcap, ccap, max_c)
        for m in sorted({blocked_topm(k, ccap), 1, 16}):
            for excl in (True, False):
                err = max(err, compare_modes("synthetic", args, tgt, n_rows,
                                             k, excl, m))
    for k, n_sc, qcap, ccap, m in BLOCKED_SHAPES:
        ccap = ccap or blocked_ccap(k)
        m = m or blocked_topm(k, ccap)
        args, tgt, n_rows = synthetic_pack(rng, n_sc, qcap, ccap, ccap,
                                           pad_last=True)
        plan = cs.topk_plan(k, qcap, ccap, m)
        for layout, pack in (("made", args), ("crowded",
                                              crowded(args, by_x=True))):
            for excl in (True, False):
                err = max(err, compare_modes(
                    f"synthetic {layout} {plan} "
                    f"{'tiled' if plan.tile < ccap else 'resident'}",
                    pack, tgt, n_rows, k, excl, m))
    return err


def certified_exact(what: str, points: np.ndarray, q, ids, cert, k: int,
                    exclude_self: bool) -> None:
    """Every certified row (queries ``q`` = points[:rows]) selects a true
    top-k set of the f32 points in f64 arithmetic, ties allowed: as many
    ids as there are candidates, up to k, none beyond the true k-th
    distance."""
    import torch

    p = torch.as_tensor(points, device=DEV, dtype=torch.float64)
    rows = torch.nonzero(cert).flatten()
    if not rows.numel():
        return
    d2 = ((q[rows].double()[:, None, :] - p[None]) ** 2).sum(-1)
    if exclude_self:
        d2[torch.arange(rows.numel(), device=DEV), rows] = float("inf")
    avail = int(min(k, points.shape[0] - (1 if exclude_self else 0)))
    kth = torch.topk(d2, avail, dim=1, largest=False).values[:, -1]
    sel = ids[rows].long()
    require(bool((sel[:, :avail] >= 0).all())
            and bool((sel[:, avail:] < 0).all()),
            f"{what}: a certified row misses neighbours")
    got = torch.gather(d2, 1, sel[:, :avail])
    require(bool((got <= kth[:, None]).all()),
            f"{what}: a certified row is not a true top-k set")


def bf16_contract(what: str, got, want, dump, s_plain, cid, qn, pn_max,
                  d: int, lattice: bool):
    """The bf16 kernel's selection (ids, scores, certified) against
    select_plain's: equal bit for bit on lattice inputs; everywhere, the
    row's 2*delta_max (the largest |kernel score - plain score| over real
    candidates, from the kernel's own scores ``dump``) within the f32 term
    of B, 4*(d+8)*eps32*(qn + pn_max), and every selected score within
    it.  Returns (largest |selected score difference|, largest
    2*delta_max / B, largest 2*delta_max / f32 term)."""
    import torch

    from cuda_knearests_tpu_torch.mxu import scorer as ms
    from cuda_knearests_tpu_torch.mxu.topk import dot_error_bound

    torch.cuda.synchronize()
    if lattice:
        require_equal(what, (got[1], got[0], got[2]),
                      (want[1], want[0], want[2]))
    band = ms.score_band(dump, s_plain, cid)
    f32_term = dot_error_bound(qn, pn_max, d, "f32")
    require(bool((band <= f32_term).all()),
            f"{what}: 2*delta_max above the f32 term of B on "
            f"{int((band > f32_term).sum())} rows")
    fin = torch.isfinite(want[1])
    require(torch.equal(torch.isfinite(got[1]), fin),
            f"{what}: missing entries differ from the plain version's")
    diff = torch.where(fin, (got[1] - want[1]).abs(), 0.0)
    require(bool((diff <= band[:, None]).all()),
            f"{what}: a selected score differs from the plain version's "
            f"by more than the row's 2*delta_max")
    err_b = dot_error_bound(qn, pn_max, d, "bf16")
    return (float(diff.max()), float((band / err_b).max()),
            float((band / f32_term).max()))


def separated(d: int, seed: int) -> np.ndarray:
    """10-point blobs of radius ~1e-3 at +-e_i (20*d points): a row's 9
    nearest others are its blob, and the next blob is ~sqrt(2) away, a gap
    that clears the bf16 band, so rows certify."""
    rng = np.random.default_rng(seed)
    centers = np.concatenate([np.eye(d), -np.eye(d)])
    return (np.repeat(centers, 10, axis=0)
            + rng.normal(size=(20 * d, d)) * 1e-3).astype(np.float32)


def select_checks() -> tuple:
    """mxu_select (f32) and mxu_select_bf16 against select_plain at small
    shapes: every d, k, m and exclude_self of the list, on lattice
    coordinates (exact ties and exact partial sums), on random ones, with
    n not a multiple of 128, n < k, and query counts that are not
    multiples of 128, and on well-separated blobs where bf16 rows certify
    (at m = k at least 90% of them must, each exact); then the f32 kernel
    at ``F32_WIDE`` and the split selection at ``SPLIT_SHAPES``.  Returns
    the largest |score difference| of each one-block kernel, the largest
    2*delta_max / B of the bf16 one, its largest 2*delta_max / f32 term of
    B, and the split selection's largest |score difference|."""
    import torch

    from cuda_knearests_tpu_torch.mxu import kernel as mk
    from cuda_knearests_tpu_torch.mxu import scorer as ms
    from cuda_knearests_tpu_torch.mxu.solve import select_inputs

    rng = np.random.default_rng(2026)
    err, err16, ratio, ratio32, n_cmp, n_cert = 0.0, 0.0, 0.0, 0.0, 0, 0
    for d in (1, 3, 17, 128):
        for kind, n in (("lattice", 1000), ("random", 1000), ("random", 40),
                        ("separated", 20 * d)):
            pts = (rng.integers(0, 6, (n, d)) * 2.5 if kind == "lattice"
                   else separated(d, d) if kind == "separated"
                   else rng.random((n, d)) * 100).astype(np.float32)
            lattice = kind == "lattice"
            m_q = min(300, n)
            qid, pts_il, cid_il = select_inputs(pts, m_q, True)
            args = [torch.as_tensor(a, device=DEV)
                    for a in (pts[:m_q], qid, pts_il, cid_il)]
            q, _, p, cid = args
            for x, ids in ((q, None), (p, cid)):
                for a, b in zip(quiet(lambda: mk.prep(x, ids)),
                                mk.prep_plain(x, ids)):
                    require(b is None or torch.equal(a, b),
                            f"prep d={d} n={n}: differs from prep_plain")
            s_plain = ms.score_tile(q, p, "bf16")
            qn, pn_max = ms.norms(q), mk.prep_plain(p, cid)[3]
            kex = (((9, True), (10, False)) if kind == "separated" else
                   [(k, e) for k in (1, 10, 50, 128) for e in (True, False)])
            for precision in ("f32", "bf16"):
                for k, excl in kex:
                    for m in sorted({1, 3, min(k, 128)}):
                        what = (f"select d={d} n={n} {kind} {precision} "
                                f"k={k} m={m} excl={excl}")
                        want = ms.select_plain(*args, k, m, d, excl,
                                               precision)
                        n_cmp += 1
                        if precision == "f32":
                            got = quiet(lambda: mk.select(
                                *args, k, m, d, excl, precision))
                            err = max(err, require_equal(
                                what, (got[1], got[0], got[2]),
                                (want[1], want[0], want[2])))
                            continue
                        *got, dump = quiet(lambda: mk._select_bf16_with_scores(
                            *args, k, m, d, excl))
                        e, r, r32 = bf16_contract(what, got, want, dump,
                                                  s_plain, cid, qn, pn_max, d,
                                                  lattice)
                        err16 = max(err16, e)
                        ratio, ratio32 = max(ratio, r), max(ratio32, r32)
                        certified_exact(what, pts, q, got[0], got[2], k,
                                        excl)
                        if kind == "separated" and m == k:
                            frac = float(got[2].float().mean())
                            require(frac >= 0.9,
                                    f"{what}: only {frac:.3f} of the rows "
                                    f"certify on separated blobs")
                            n_cert += int(got[2].sum())
        print(f"  mxu_select d={d}: f32 equal to select_plain, bf16 within "
              f"its contract, on every listed shape ({n_cmp} comparisons "
              f"so far; {n_cert} bf16 rows of separated blobs certified, "
              f"each exact; largest bf16 2*delta_max/B {ratio:.3e}, "
              f"/f32 term {ratio32:.3e}; largest bf16 |score difference| "
              f"{err16:.6g})", flush=True)
    err = max(err, select_checks_f32_wide(rng))
    return err, err16, ratio, ratio32, split_checks(rng)


# f32 launch shapes beyond select_checks' grid: (d, k, m) with resident
# queries in two d-chunks, streamed queries (a ragged last chunk; 128
# chunks), and lists past the old f32 limit in 16-row blocks (at d=13 with
# narrower d-chunks).
F32_WIDE = ((64, 10, 3), (300, 1, 1), (300, 10, 1), (300, 50, 3),
            (300, 128, 128), (2048, 1, 1), (2048, 10, 10), (2048, 50, 3),
            (2048, 128, 1), (3, 900, 128), (3, 900, 1), (3, 900, 3),
            (13, 1707, 3))


def select_checks_f32_wide(rng) -> float:
    """mxu_select (f32) against select_plain bit for bit at ``F32_WIDE``
    on 40 of 1,000 lattice and random points, exclude_self on and off,
    and its prep pass against the plain prep.  Returns the largest
    |score difference| (0 when equal)."""
    import torch

    from cuda_knearests_tpu_torch.mxu import kernel as mk
    from cuda_knearests_tpu_torch.mxu import scorer as ms
    from cuda_knearests_tpu_torch.mxu.solve import select_inputs

    err, plans = 0.0, set()
    for d, k, m in F32_WIDE:
        plans.add(mk.pick_launch(d, k, m))
        for kind in ("lattice", "random"):
            pts = (rng.integers(0, 6, (1000, d)) * 2.5 if kind == "lattice"
                   else rng.random((1000, d)) * 100).astype(np.float32)
            qid, pts_il, cid_il = select_inputs(pts, 40, True)
            args = [torch.as_tensor(a, device=DEV)
                    for a in (pts[:40], qid, pts_il, cid_il)]
            for a, b in zip(quiet(lambda: mk.prep_f32(args[2], args[3])),
                            mk.prep_f32_plain(args[2], args[3])):
                require(torch.equal(a, b),
                        f"f32 prep d={d}: differs from prep_f32_plain")
            for excl in (True, False):
                what = f"select d={d} {kind} f32 k={k} m={m} excl={excl}"
                want = ms.select_plain(*args, k, m, d, excl, "f32")
                got = quiet(lambda: mk.select(*args, k, m, d, excl, "f32"))
                err = max(err, require_equal(
                    what, (got[1], got[0], got[2]),
                    (want[1], want[0], want[2])))
    print(f"  mxu_select f32 at (d, k, m) {list(F32_WIDE)}: equal to "
          f"select_plain, prep equal to prep_f32_plain; launch plans "
          f"(rows, kc, queries resident) {sorted(plans)}", flush=True)
    return err


# The split selection's shapes (d, n, k, m): the fold's sort (m < 128) and
# pass-through, fewer candidates than k, the k the one-block gates refuse
# at d=3 and d=128 (a pool narrower than k + 1 at m=100), a sort in a
# device scratch row, the direct arm over many blocks (all 3,000 queries),
# lattice buckets that overflow the row, n < k + 1 and n = k + 1, d on
# either side of the arms' threshold, and direct rows in scratch.  At m =
# 128 both arms run.
SPLIT_SHAPES = ((3, 1000, 10, 3), (3, 1000, 50, 128), (17, 1000, 128, 7),
                (3, 40, 50, 1), (3, 2000, 1800, 128), (3, 2000, 1800, 100),
                (128, 1700, 1590, 128), (3, 9000, 8200, 128),
                (3, 3000, 1800, 128), (3, 4000, 1800, 128),
                (3, 1500, 1800, 128), (3, 1801, 1800, 128),
                ("max_d", 2000, 1800, 128), ("max_d + 1", 2000, 1800, 128),
                (3, 4000, 2100, 128))
SPLIT_ALL_QUERIES = {(3, 3000, 1800, 128)}


def split_checks(rng) -> float:
    """mxu_select_split against select_plain bit for bit at both tiers at
    ``SPLIT_SHAPES``, through the arm split_plan picks and (m = 128) both
    arms, on lattice and random points, 40 queries (all of them in
    ``SPLIT_ALL_QUERIES``), exclude_self on and off.  Returns the largest
    |score difference| (0 when equal)."""
    import torch

    from cuda_knearests_tpu_torch.mxu import kernel as mk
    from cuda_knearests_tpu_torch.mxu import scorer as ms
    from cuda_knearests_tpu_torch.mxu.solve import select_inputs

    err, shapes = 0.0, []
    for shape in SPLIT_SHAPES:
        d, n, k, m = shape
        if isinstance(d, str):
            d = mk._SPLIT_DIRECT_MAX_D + (d == "max_d + 1")
        shapes.append((d, n, k, m))
        nq = n if shape in SPLIT_ALL_QUERIES else 40
        arms = (None, "direct", "pool") if m >= 128 else (None,)
        for kind in ("lattice", "random"):
            pts = (rng.integers(0, 6, (n, d)) * 2.5 if kind == "lattice"
                   else rng.random((n, d)) * 100).astype(np.float32)
            qid, pts_il, cid_il = select_inputs(pts, nq, True)
            args = [torch.as_tensor(a, device=DEV)
                    for a in (pts[:nq], qid, pts_il, cid_il)]
            for precision in ("f32", "bf16"):
                for excl in (True, False):
                    want = ms.select_plain(*args, k, m, d, excl, precision)
                    for arm in arms:
                        what = (f"split select d={d} n={n} {kind} "
                                f"{precision} k={k} m={m} excl={excl} "
                                f"arm={arm or mk.split_arm(d, k, m)}")
                        got = quiet(lambda: mk.select_split(
                            *args, k, m, d, excl, precision, arm=arm))
                        err = max(err, require_equal(
                            what, (got[1], got[0], got[2]),
                            (want[1], want[0], want[2])))
    print(f"  mxu_select_split at (d, n, k, m) {shapes}: equal to "
          f"select_plain at f32 and bf16, both arms at m = 128 (direct up "
          f"to d = {mk._SPLIT_DIRECT_MAX_D})", flush=True)
    return err


# -- phase 3/4: the grid main path ---------------------------------------------

def tree_reference(points: np.ndarray, rows: np.ndarray, k: int, tree):
    """Exact squared distances (f64) and ids of the k nearest other points
    of the sampled rows, from the kd-tree."""
    q = points[rows].astype(np.float64)
    dk, ik = tree.query(q, k=k + 1)
    is_self = ik == rows[:, None]
    keep = ~is_self
    keep[~is_self.any(axis=1), -1] = False
    return (dk[keep].reshape(-1, k)) ** 2, ik[keep].reshape(-1, k)


def brute_reference(points: np.ndarray, rows: np.ndarray, k: int):
    """The same from an f64 brute force on the card (exact differences,
    any d), for clouds a kd-tree cannot serve."""
    import torch

    p = torch.as_tensor(points, device=DEV, dtype=torch.float64)
    dks, iks = [], []
    for r0 in range(0, rows.size, 8):
        r = torch.as_tensor(rows[r0:r0 + 8], device=DEV).long()
        d2 = ((p[r][:, None, :] - p[None, :, :]) ** 2).sum(-1)
        d2[torch.arange(r.numel(), device=DEV), r] = float("inf")
        v, i = torch.topk(d2, k, dim=1, largest=False, sorted=True)
        dks.append(v.cpu().numpy())
        iks.append(i.cpu().numpy())
    return np.concatenate(dks), np.concatenate(iks)


def check_rows_exact(points: np.ndarray, nbrs: np.ndarray, rows: np.ndarray,
                     dk: np.ndarray, ik: np.ndarray,
                     queries: np.ndarray | None = None) -> None:
    """Rows of the original-order neighbour table against the exact
    reference (dk squared, ik ids), tie-aware: valid unique ids, not the
    query itself, distances realized and equal to the reference's as
    multisets, and every reference neighbour strictly inside the k-th
    distance's tolerance band present.  With ``queries``, the rows answer
    those external query coordinates (no self-exclusion)."""
    q = (points if queries is None else queries)[rows].astype(np.float64)
    ids = nbrs[rows]
    require(bool((ids >= 0).all()), "a sampled row has missing neighbours")
    require(queries is not None or bool((ids != rows[:, None]).all()),
            "a row lists its own point")
    srt = np.sort(ids, axis=1)
    require(not bool((np.diff(srt, axis=1) == 0).any()),
            "a row repeats a neighbour")
    dp = ((points[ids].astype(np.float64) - q[:, None, :]) ** 2).sum(-1)
    require(bool(np.allclose(np.sort(dp, axis=1), dk, rtol=RTOL, atol=ATOL)),
            "sampled rows disagree with the reference's distances")
    band = ATOL + RTOL * dk[:, -1:]
    must = dk < dk[:, -1:] - band
    for r in np.nonzero(must.any(axis=1))[0]:
        missing = set(ik[r][must[r]].tolist()) - set(ids[r].tolist())
        require(not missing, f"row {rows[r]} misses reference neighbours "
                             f"{sorted(missing)}")


def check_exact(points: np.ndarray, nbrs: np.ndarray, rows: np.ndarray,
                k: int, tree) -> None:
    dk, ik = tree_reference(points, rows, k, tree)
    check_rows_exact(points, nbrs, rows, dk, ik)


def prepared(points: np.ndarray, cfg):
    """(problem, host seconds of ``KnnProblem.prepare`` on the card)."""
    import torch

    import cuda_knearests_tpu_torch as pt

    t0 = time.perf_counter()
    prob = pt.KnnProblem.prepare(points, cfg, device=DEV)
    torch.cuda.synchronize()
    return prob, time.perf_counter() - t0


def main_path(name: str, points: np.ndarray, cfg, runs: int, prob,
              prep_s: float, expect_multi: bool = False,
              counter: str = "launches"):
    """Solve a prepared problem 1 + ``runs`` times, check every solve's
    launches of the class kernel (``counter`` names its count in
    ops/cuda_solve) and round trips, and the answers against the kd-tree.
    Returns (launches, median s, pre-fallback certificates)."""
    from scipy.spatial import cKDTree

    from cuda_knearests_tpu_torch.ops import cuda_solve as cs
    from cuda_knearests_tpu_torch.runtime import dispatch

    n_cls = len(prob.aplan.classes)
    times, launches, max_syncs = [], 0, 0
    setattr(cs, counter, 0)
    for i in range(1 + runs):
        before = getattr(cs, counter)
        dispatch.reset_stats()
        t0 = time.perf_counter()
        res = prob.solve()
        dt = time.perf_counter() - t0
        syncs = dispatch.stats().host_syncs
        done = getattr(cs, counter) - before
        require(done == n_cls,
                f"{name}: solve made {done} {counter} for {n_cls} classes")
        require(syncs <= dispatch.SYNC_BUDGET,
                f"{name}: solve made {syncs} host round trips")
        max_syncs = max(max_syncs, syncs)
        if i:
            times.append(dt)
    launches = getattr(cs, counter)
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
    cert = solve_certificates(prob, cfg)
    bad = prob.get_permutation()[np.nonzero(~cert)[0]].astype(np.int64)
    take = bad[rng.permutation(bad.size)[:2000]]
    rest = rng.permutation(n)[: SAMPLE_ROWS - take.size]
    rows = np.unique(np.concatenate([take, rest])).astype(np.int64)
    t0 = time.perf_counter()
    tree = cKDTree(points.astype(np.float64))
    check_exact(points, nbrs, rows, cfg.k, tree)
    med = float(np.median(times))
    kernel_ms, _ = class_kernel_ms(prob, cfg, reps=1 if med > 0.5 else 10)
    print(f"  {name}: n={n} k={cfg.k} classes={n_cls} "
          f"(qcap, ccap, radius, supercells)="
          f"{[(c.qcap, c.ccap, c.radius, c.n_sc) for c in prob.aplan.classes]}"
          f"\n    prepare {prep_s:.3f} s; solve median of {runs} "
          f"{med * 1e3:.3f} ms = {n / med:,.0f} queries/s "
          f"(runs ms {[round(t * 1e3, 3) for t in times]}); kernel "
          f"{kernel_ms:.4f} ms per solve (CUDA events)"
          f"\n    {counter} per solve {n_cls}; certified fraction "
          f"{1 - unc / n:.6f}; fallback rows {unc}; host round trips "
          f"{max_syncs} (max over solves, budget {dispatch.SYNC_BUDGET}); "
          f"exact vs cKDTree on {rows.size} rows "
          f"({take.size} of them fallback rows), checked in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches, med, cert


def class_kernel_ms(prob, cfg, reps: int):
    """Device ms of one solve's class-kernel launches (mode (a), every
    class, the kernel ``cfg`` selects), outside the counted main-path
    runs, and the (d2, ids) rows they wrote."""
    from cuda_knearests_tpu_torch.ops import cuda_solve as cs
    from cuda_knearests_tpu_torch.ops.adaptive import class_blocked_m

    out = row_buffers(prob.grid.n_points, cfg.k)

    def kernel():
        for cp in prob.aplan.classes:
            m = class_blocked_m(cfg, cp.ccap)
            if m:
                cs.blocked_topk(*cp.pk.args(), cfg.k, m, cfg.exclude_self,
                                tgt=cp.tgt, out=out)
            else:
                cs.supercell_topk(*cp.pk.args(), cfg.k, cfg.exclude_self,
                                  tgt=cp.tgt, out=out)

    return quiet(lambda: cuda_ms(kernel, reps)), out


def solve_certificates(prob, cfg):
    """The pre-fallback certificate mask of one more solve (device side)."""
    from cuda_knearests_tpu_torch.ops.adaptive import solve_adaptive

    return quiet(lambda: solve_adaptive(prob.grid, cfg, prob.aplan)
                 .certified.cpu().numpy())


# -- phase 9: timing at the main path's class shape -----------------------------

def class_timing(name: str, prob, cfg) -> dict:
    """The class kernel ``cfg`` selects over every class of a prepared
    problem (mode (a), as the solve launches it) against its plain version
    and a cdist + topk yardstick, with the bound: the larger of the input
    and output bytes over the HBM rate and the pair arithmetic over the
    f32 rate.  The timed kernel's outputs, in both modes, must equal the
    plain version's; returns the timings and the largest |d2
    difference|."""
    import torch

    from cuda_knearests_tpu_torch.ops import cuda_solve as cs
    from cuda_knearests_tpu_torch.ops.adaptive import class_blocked_m

    k, excl = cfg.k, cfg.exclude_self
    n = prob.grid.n_points
    plain_out = row_buffers(n, k)
    classes = prob.aplan.classes
    ms_of = [class_blocked_m(cfg, cp.ccap) for cp in classes]

    def run(cp, m, plain=False, **kw):
        if m:
            fn = cs.blocked_topk_plain if plain else cs.blocked_topk
            return fn(*cp.pk.args(), k, m, excl, **kw)
        fn = cs.supercell_topk_plain if plain else cs.supercell_topk
        return fn(*cp.pk.args(), k, excl, **kw)

    def plain():
        for cp, m in zip(classes, ms_of):
            run(cp, m, plain=True, tgt=cp.tgt, out=plain_out)

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
        raw_out[:] = [run(cp, m) for cp, m in zip(classes, ms_of)]

    ms, kernel_out = class_kernel_ms(prob, cfg, reps=20)
    raw_ms = quiet(lambda: cuda_ms(kernel_raw, 20))
    plain_ms = cuda_ms(plain, 3)
    library_ms = cuda_ms(library, 3)
    err = require_equal(f"{name} rows (timed)", kernel_out, plain_out)
    for ci, (cp, m, got) in enumerate(zip(classes, ms_of, raw_out)):
        err = max(err, require_equal(f"{name} class {ci} raw (timed)", got,
                                     run(cp, m, plain=True)))
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
    geometry = [cs.topk_plan(k, cp.qcap, cp.ccap) for cp, m in
                zip(classes, ms_of) if not m]
    # bit identity forbids fused multiply-adds: each operation is one
    # instruction where the 67 TFLOP/s rate counts an FMA as two
    print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"cdist+topk {library_ms:.4f} ms; bytes {in_bytes + out_bytes} "
          f"-> {t_bytes:.4f} ms at 3.35 TB/s; pairs {pairs}, {flops} f32 "
          f"ops -> {t_ops:.4f} ms at 67 TFLOP/s; --fmad=false ceiling "
          f"{2 * t_ops:.4f} ms (one instruction per operation)"
          f"{f'; one-stage launch geometry {geometry}' if geometry else ''}",
          flush=True)
    raw_bytes = in_bytes - sum(cp.tgt.numel() * 4 for cp in classes) \
        + raw_out_bytes
    print(f"  {name} raw (S, k, Q) layout: kernel {raw_ms:.4f} ms; bytes "
          f"{raw_bytes} -> {raw_bytes / PEAK_HBM_BYTES * 1e3:.4f} ms; bound "
          f"{max(raw_bytes / PEAK_HBM_BYTES * 1e3, t_ops):.4f} ms",
          flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}, err


def crowded_timing(name: str, prob, cfg) -> dict:
    """The blocked kernel (mode (a), every class) on the packs of a
    prepared problem with each supercell's candidates crowded in stored-id
    order, against its plain version, by CUDA events; its outputs must
    equal the plain version's.  Returns the timings and the rows answered
    block by block."""
    from cuda_knearests_tpu_torch.ops import cuda_solve as cs
    from cuda_knearests_tpu_torch.ops.adaptive import class_blocked_m

    k, excl, n = cfg.k, cfg.exclude_self, prob.grid.n_points
    packs = [(crowded(list(cp.pk.args())), cp.tgt,
              class_blocked_m(cfg, cp.ccap)) for cp in prob.aplan.classes]
    out, plain_out = row_buffers(n, k), row_buffers(n, k)

    def run(fn, buf):
        for args, tgt, m in packs:
            fn(*args, k, m, excl, tgt=tgt, out=buf)

    ms = quiet(lambda: cuda_ms(lambda: run(cs.blocked_topk, out), 20))
    plain_ms = cuda_ms(lambda: run(cs.blocked_topk_plain, plain_out), 3)
    err = require_equal(f"{name} crowded rows (timed)", out, plain_out)
    rows = sum(per_block_rows(args, k, m, excl) for args, _, m in packs)
    deficit = int(out[0][:, k - 1].isnan().sum())
    print(f"  {name} crowded in stored-id order: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms; per-block rows {rows} of {n}, deficit rows "
          f"{deficit}; outputs equal the plain version's", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "per_block_rows": rows,
            "deficit_rows": deficit}, err


def device_breakdown(name: str, what: str, run, launches: int,
                     counter: str = "launches") -> dict:
    """Device time by kernel of one warm call of ``run`` under
    torch.profiler (which must launch the class kernel ``counter`` names
    ``launches`` times), the device's busy share of its (profiled) wall
    time and its device-to-host copies."""
    from torch.profiler import ProfilerActivity, profile

    from cuda_knearests_tpu_torch.ops import cuda_solve as cs

    run()

    def profiled():
        before = getattr(cs, counter)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            wall = (time.perf_counter() - t0) * 1e3
        done = getattr(cs, counter) - before
        require(done == launches,
                f"{name}: profiled {what} made {done} {counter}, expected "
                f"{launches}")
        return prof, wall

    prof, wall_ms = quiet(profiled)
    rows = []
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = getattr(e, "cuda_time_total", 0)
            rows.append((us / 1e3, e.count, e.key))
    busy = sum(r[0] for r in rows)
    dtoh = sum(r[0] for r in rows if "DtoH" in r[2])
    print(f"  {name}: one {what} {wall_ms:.3f} ms wall under the profiler; "
          f"device busy {busy:.3f} ms ({busy / wall_ms:.1%} of wall), DtoH "
          f"{dtoh:.4f} ms", flush=True)
    if not rows:
        print("    the profiler recorded no device time", flush=True)
    for ms, count, key in sorted(rows, reverse=True)[:8]:
        print(f"    {ms:9.4f} ms  x{count:<3d} {key[:80]}", flush=True)
    return {"wall_ms": wall_ms, "busy_ms": busy, "dtoh_ms": dtoh}


def solve_breakdown(name: str, prob) -> None:
    """Device time by kernel of one warm solve (:func:`device_breakdown`)."""
    device_breakdown(name, "solve", prob.solve, len(prob.aplan.classes))


# -- phase 5: the brute route at full width ------------------------------------

def sampled_hits(points: np.ndarray, nbrs: np.ndarray, rows: np.ndarray,
                 kth: np.ndarray, band=None) -> np.ndarray:
    """Per sampled row, the returned ids that are true top-k picks, as
    ``mxu/measure.py`` counts them: exact f64 distance at most the true
    k-th (``kth``), widened by the row's ``band`` (2B), or without a band
    tying it at f32 resolution."""
    return row_hits(points, rows, nbrs[rows], kth, band)


def row_hits(points: np.ndarray, rows: np.ndarray, ids: np.ndarray,
             kth: np.ndarray, band=None) -> np.ndarray:
    """:func:`sampled_hits` of the (len(rows), k) ids of the rows."""
    q = points[rows].astype(np.float64)
    valid = ids >= 0
    c = points[np.where(valid, ids, 0)].astype(np.float64)
    gd = ((c - q[:, None, :]) ** 2).sum(-1)
    if band is None:
        hit = ((gd <= kth[:, None])
               | (gd.astype(np.float32) <= kth[:, None].astype(np.float32)))
    else:
        hit = gd <= (kth + band)[:, None]
    return (valid & hit).sum(axis=1)


def declared_band(points: np.ndarray, rows: np.ndarray,
                  precision: str) -> np.ndarray:
    """``mxu/measure.declared_band`` on the sampled rows: 2B from f64
    norms, B = topk.dot_error_bound at the scoring precision."""
    from cuda_knearests_tpu_torch.mxu.topk import dot_error_bound

    p64 = points.astype(np.float64)
    qn = (p64[rows] ** 2).sum(axis=1)
    pn_max = float((p64 * p64).sum(axis=1).max())
    return 2.0 * dot_error_bound(qn, pn_max, points.shape[1], precision)


def split_timers(split: dict):
    """Wrap the brute route's stages for one solve: the selection kernel
    timed with CUDA events, the host rescore with the host clock, the
    exact fallback with the host clock between synchronizations.  Returns
    the restore function."""
    import torch

    from cuda_knearests_tpu_torch.mxu import solve as msolve

    saved = {n: getattr(msolve, n) for n in
             ("kernel", "_host_rescore", "brute_force_by_index",
              "brute_force_by_coords")}

    class Kernel:
        @staticmethod
        def select_routed(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = saved["kernel"].select_routed(*a, **kw)
            end.record()
            end.synchronize()
            split["select"] = start.elapsed_time(end)
            return out

    def host(name, fn, sync):
        def wrapped(*a, **kw):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            split[name] = split.get(name, 0.0) + (time.perf_counter()
                                                  - t0) * 1e3
            return out
        return wrapped

    msolve.kernel = Kernel
    msolve._host_rescore = host("rescore", saved["_host_rescore"], False)
    for n in ("brute_force_by_index", "brute_force_by_coords"):
        setattr(msolve, n, host("fallback", saved[n], True))
    return lambda: [setattr(msolve, n, f) for n, f in saved.items()]


def brute_run(label: str, points: np.ndarray, k: int, rt: float,
              refine: str, precision: str, runs: int, rows: np.ndarray,
              ref) -> dict:
    """``mxu.solve_general`` 1 + ``runs`` times with its checks; the first
    (not counted in the median) also records the time split: the
    selection kernel (CUDA events), the host rescore, and the exact
    fallback of the uncertified rows."""
    from cuda_knearests_tpu_torch import mxu
    from cuda_knearests_tpu_torch.mxu import kernel as mk
    from cuda_knearests_tpu_torch.runtime import dispatch

    n, d = points.shape
    times, max_syncs, split = [], 0, {}
    counter = "launches_bf16" if precision == "bf16" else "launches"
    other = "launches" if precision == "bf16" else "launches_bf16"
    before_all, other_all = getattr(mk, counter), getattr(mk, other)
    for i in range(1 + runs):
        before = getattr(mk, counter)
        restore = split_timers(split) if i == 0 else (lambda: None)
        dispatch.reset_stats()
        t0 = time.perf_counter()
        try:
            res = mxu.solve_general(points, k=k, recall_target=rt,
                                    refine=refine, precision=precision,
                                    device=DEV)
        finally:
            restore()
        dt = time.perf_counter() - t0
        syncs = dispatch.stats().host_syncs
        require(getattr(mk, counter) == before + 1,
                f"{label}: solve launched the {precision} selection kernel "
                f"{getattr(mk, counter) - before} times")
        require(syncs <= dispatch.SYNC_BUDGET,
                f"{label}: solve made {syncs} host round trips")
        max_syncs = max(max_syncs, syncs)
        if i:
            times.append(dt)
        else:
            split["total"] = dt * 1e3
    launches = getattr(mk, counter) - before_all
    require(getattr(mk, other) == other_all,
            f"{label}: a {precision} solve launched the other tier's kernel")
    require(res.backend == "cuda" and res.precision == precision,
            f"{label}: ran {res.backend}/{res.precision}")
    require(res.neighbors.shape == (n, k) and bool((res.neighbors >= 0)
                                                   .all()),
            f"{label}: result shape {res.neighbors.shape} or missing rows")
    dk, ik = ref
    kth = dk[:, -1]
    cert_rows = rows[res.certified[rows]]
    if refine == "brute":
        require(bool(res.certified.all()), f"{label}: rows left uncertified")
        check_rows_exact(points, res.neighbors, rows, dk, ik)
    exact_hits = sampled_hits(points, res.neighbors, rows, kth)
    require(bool((exact_hits[res.certified[rows]] == k).all()),
            f"{label}: a certified sampled row is not exact")
    band = declared_band(points, rows, precision)
    recall = float(sampled_hits(points, res.neighbors, rows, kth,
                                band).sum()) / (k * rows.size)
    require(recall >= res.bound,
            f"{label}: recall {recall} on the sampled rows below the bound "
            f"{res.bound}")
    med = float(np.median(times))
    print(f"  {label}: n={n} d={d} k={k} rt={rt} refine={refine} "
          f"{precision}: solve median of {runs} {med * 1e3:.3f} ms = "
          f"{n / med:,.0f} queries/s (runs ms "
          f"{[round(t * 1e3, 3) for t in times]})"
          f"\n    first solve {split['total']:.3f} ms: select kernel "
          f"{split['select']:.3f} ms (CUDA events), host rescore "
          f"{split['rescore']:.3f} ms, fallback "
          f"{split.get('fallback', 0.0):.3f} ms for "
          f"{res.uncert_count if refine == 'brute' else 0} rows"
          f"\n    launches {launches} ({1 + runs} solves); m={res.m} "
          f"n_blocks={res.n_blocks} bound={res.bound:.6f}; certified "
          f"fraction {1 - res.uncert_count / n:.6f}; uncert_count "
          f"{res.uncert_count}; host round trips {max_syncs}; sampled rows "
          f"{rows.size}: recall at the 2B band {recall:.6f}, certified "
          f"{cert_rows.size} all exact", flush=True)
    return dict(launches=launches, m=res.m, median_s=med, **split)


def select_timing(label: str, points: np.ndarray, k: int, m: int,
                  precision: str, rows: np.ndarray, ref) -> tuple:
    """The selection kernel over all queries at its main path's shape,
    against its plain version and the kernel itself on 1,024 of the
    queries (which must agree exactly at f32, and meet the bf16 contract
    at bf16, certified rows exact against ``ref``), a chunked matmul +
    topk yardstick (f32 without TF32, or a bf16 matmul) and the bound:
    2*d operations per (query, candidate) pair over the FP32 (or dense
    BF16) peak, or the bytes of inputs and outputs over the HBM rate,
    whichever is larger.  At bf16 the kernel time covers the wrapper's
    three launches (two prep passes and the selection)."""
    import torch

    from cuda_knearests_tpu_torch.mxu import kernel as mk
    from cuda_knearests_tpu_torch.mxu import scorer as ms
    from cuda_knearests_tpu_torch.mxu.solve import select_inputs

    bf16 = precision == "bf16"
    n, d = points.shape
    qid, pts_il, cid_il = select_inputs(points, n, True)
    q, qid_t, p, cid = [torch.as_tensor(a, device=DEV)
                        for a in (points, qid, pts_il, cid_il)]
    ms_full = quiet(lambda: cuda_ms(
        lambda: mk.select(q, qid_t, p, cid, k, m, d, True, precision),
        1 if d > 8 else 3))
    sub = torch.as_tensor(rows[:1024], device=DEV).long()
    qs, qids = q[sub].contiguous(), qid_t[sub].contiguous()
    what = f"{label} select on {sub.numel()} sampled queries"
    want = ms.select_plain(qs, qids, p, cid, k, m, d, True, precision)
    extra = ""
    if bf16:
        *got, dump = quiet(lambda: mk._select_bf16_with_scores(
            qs, qids, p, cid, k, m, d, True))
        s_plain = torch.cat([ms.score_tile(qs[r0:r0 + 256], p, "bf16")
                             for r0 in range(0, sub.numel(), 256)])
        err, ratio, ratio32 = bf16_contract(
            what, got, want, dump, s_plain, cid, ms.norms(qs),
            mk.prep_plain(p, cid)[3], d, False)
        del dump, s_plain
        cert = got[2].cpu().numpy()
        hits = row_hits(points, rows[:sub.numel()], got[0].cpu().numpy(),
                        ref[0][:sub.numel(), -1])
        require(bool((hits[cert] == k).all()),
                f"{what}: a certified row is not exact")
        prep_ms = quiet(lambda: cuda_ms(lambda: (mk.prep(q),
                                                 mk.prep(p, cid)), 3))
        extra = (f"; 2*delta_max/B at most {ratio:.3e} (/f32 term "
                 f"{ratio32:.3e}), selected scores "
                 f"within 2*delta_max (largest difference {err:.6g}), "
                 f"{int(cert.sum())} certified rows exact; prep passes "
                 f"{prep_ms:.3f} ms of the kernel time")
    else:
        got = quiet(lambda: mk.select(qs, qids, p, cid, k, m, d, True,
                                      precision))
        err = require_equal(what, (got[1], got[0], got[2]),
                            (want[1], want[0], want[2]))
        ratio = ratio32 = 0.0
        prep_ms = quiet(lambda: cuda_ms(lambda: (mk.prep_f32(q),
                                                 mk.prep_f32(p, cid)), 3))
        extra = (f"; plan (rows, kc, queries resident) "
                 f"{mk.pick_launch(d, k, m)}; prep passes {prep_ms:.3f} ms "
                 f"of the kernel time")
    sub_ms = quiet(lambda: cuda_ms(
        lambda: mk.select(qs, qids, p, cid, k, m, d, True, precision), 3))
    plain_ms = cuda_ms(lambda: ms.select_plain(qs, qids, p, cid, k, m, d,
                                               True, precision), 1)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    qn = (q * q).sum(1)
    lib_q = q.to(torch.bfloat16) if bf16 else q
    step = max(1, (1 << 30) // (4 * n))

    def library():
        for r0 in range(0, n, step):
            prod = (lib_q[r0:r0 + step] @ lib_q.T).float()
            s = qn[r0:r0 + step, None] + qn[None, :] - 2.0 * prod
            torch.topk(s, k + 1, dim=1, largest=False)

    try:
        library_ms = cuda_ms(library, 1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    flops = 2 * d * n * n
    peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
    nbytes = (4 * n * d + 4 * pts_il.size + 4 * n + 4 * cid_il.size
              + 8 * n * k + n)
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    # at f32 each (pair, axis) is a separate FMUL and FADD (bit identity
    # with the plain version), so the FP32 pipes, rated for fused
    # multiply-adds, need twice the operations bound
    ceiling = "" if bf16 else (f"; --fmad=false ceiling {2 * t_ops:.4f} ms "
                               f"(one instruction per operation)")
    print(f"  {label}: select kernel {ms_full:.3f} ms over {n} queries (m="
          f"{m}); on {sub.numel()} of them kernel {sub_ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms ({'within the contract' if bf16 else 'equal outputs'}"
          f"{extra}); matmul+topk {library_ms:.3f} ms; {flops} ops -> "
          f"{t_ops:.4f} ms at {peak / 1e12:.0f} TFLOP/s{ceiling}, {nbytes} "
          f"bytes -> {t_bytes:.4f} ms", flush=True)
    out = {"ms": ms_full, "plain_ms": plain_ms,
           "plain_queries": int(sub.numel()), "ms_on_plain_queries": sub_ms,
           "library_ms": library_ms, "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    return out, err, (ratio, ratio32)


def path_a():
    """The brute route at full width; returns (selection launches by tier,
    the timing entries by shape, the largest |score difference| seen by
    tier, the largest bf16 2*delta_max / B and / the f32 term of B)."""
    from scipy.spatial import cKDTree

    from cuda_knearests_tpu_torch.io import generate_uniform

    k = 10
    launches = {"f32": 0, "bf16": 0}
    timing, err, ratio = {}, {"f32": 0.0, "bf16": 0.0}, (0.0, 0.0)
    rng = np.random.default_rng(11)
    pts3 = generate_uniform(300_000, seed=300)
    rows3 = np.sort(rng.permutation(pts3.shape[0])[:SAMPLE_ROWS])
    ref3 = tree_reference(pts3, rows3, k, cKDTree(pts3.astype(np.float64)))
    runs3 = [(1.0, "brute", "f32")] + [(rt, "none", p) for rt in
                                       (0.95, 0.8, 0.6)
                                       for p in ("f32", "bf16")]
    m3 = {}
    for rt, refine, precision in runs3:
        out = brute_run("300k x 3", pts3, k, rt, refine, precision, 3,
                        rows3, ref3)
        launches[precision] += out["launches"]
        m3.setdefault(precision, out["m"])
    gen = np.random.default_rng(128)
    pts128 = (gen.random((100_000, 128)) * 100).astype(np.float32)
    rows128 = np.sort(rng.permutation(pts128.shape[0])[:2000])
    ref128 = brute_reference(pts128, rows128, k)
    m128 = {}
    for rt, refine, precision in ((1.0, "brute", "f32"), (0.9, "none", "f32"),
                                  (0.9, "none", "bf16")):
        out = brute_run("100k x 128", pts128, k, rt, refine, precision, 3,
                        rows128, ref128)
        launches[precision] += out["launches"]
        m128.setdefault(precision, out["m"])
    phase("timing the selection kernels")
    for precision in ("f32", "bf16"):
        label = f"300k x 3 {precision}"
        timing[label], e, r = select_timing(label, pts3, k, m3[precision],
                                            precision, rows3, ref3)
        err[precision] = max(err[precision], e)
        ratio = tuple(map(max, ratio, r))
    for precision in ("f32", "bf16"):
        label = f"100k x 128 {precision}"
        timing[label], e, r = select_timing(label, pts128, k,
                                            m128[precision], precision,
                                            rows128, ref128)
        err[precision] = max(err[precision], e)
        ratio = tuple(map(max, ratio, r))
    # the bf16 fold at m >= 2, which the recall-bounded bf16 runs (m=1)
    # do not reach
    for label, pts in (("300k x 3", pts3), ("100k x 128", pts128)):
        fold_timing(f"{label} bf16", pts, k, k)
    return launches, timing, err, ratio


def brute_refused_run(points: np.ndarray, k: int) -> dict:
    """One ``mxu.solve_general`` at a k whose lists no one-block selection
    kernel holds (their gates refuse it): the solve runs the split
    selection (backend 'cuda_split', its launches counted, no one-block
    launch, two f32 prep passes), within two round trips, and answers
    exactly against cKDTree on 2,000 sampled rows.  Prints the route, the
    solve time and its split; returns the split selection's launches."""
    from scipy.spatial import cKDTree

    from cuda_knearests_tpu_torch import mxu
    from cuda_knearests_tpu_torch.mxu import kernel as mk
    from cuda_knearests_tpu_torch.runtime import dispatch

    n, d = points.shape
    one_block = (mk.launches, mk.launches_bf16, mk.prep_launches)
    before, prep_before = mk.split_launches, mk.prep_launches_f32
    split = {}
    restore = split_timers(split)
    dispatch.reset_stats()
    t0 = time.perf_counter()
    try:
        res = mxu.solve_general(points, k=k, device=DEV)
    finally:
        restore()
    dt = time.perf_counter() - t0
    syncs = dispatch.stats().host_syncs
    launches = mk.split_launches - before
    require(syncs <= dispatch.SYNC_BUDGET,
            f"brute k={k}: solve made {syncs} host round trips")
    require(res.backend == "cuda_split",
            f"brute k={k}: ran {res.backend}, not the split selection")
    require(launches > 0 and mk.prep_launches_f32 == prep_before + 2,
            f"brute k={k}: {launches} split launches, "
            f"{mk.prep_launches_f32 - prep_before} f32 prep passes")
    require((mk.launches, mk.launches_bf16, mk.prep_launches) == one_block,
            f"brute k={k}: a one-block selection kernel was launched")
    require(res.neighbors.shape == (n, k) and bool(res.certified.all()),
            f"brute k={k}: result shape {res.neighbors.shape} or rows left "
            f"uncertified")
    rows = np.sort(np.random.default_rng(23).permutation(n)[:2000])
    t0 = time.perf_counter()
    check_exact(points, res.neighbors, rows, k,
                cKDTree(points.astype(np.float64)))
    plan = mk.split_plan(n, -(-n // 128) * 128, d, k, res.m)
    print(f"  brute {n // 1000}k x {d} k={k}: the one-block gates refuse "
          f"it, route '{res.backend}' ({launches} split launches of the "
          f"{plan.arm} arm, {plan.rows} queries a launch); one solve "
          f"{dt * 1e3:.3f} ms (cold): split selection "
          f"{split['select']:.3f} ms (CUDA events, prep passes included), "
          f"host rescore {split['rescore']:.3f} ms, fallback "
          f"{split.get('fallback', 0.0):.3f} ms for {res.uncert_count} rows; "
          f"host round trips {syncs}; exact vs cKDTree on {rows.size} rows, "
          f"checked in {time.perf_counter() - t0:.1f} s", flush=True)
    return {"launches": launches, "m": res.m, "arm": plan.arm}


def split_run(q, qid, p, cid, k: int, m: int, d: int, arm=None,
              precision: str = "f32") -> dict:
    """One split selection over all queries (exclude_self): its arm,
    launches and the blocks' pass counts ({passes: blocks}), then its time
    (CUDA events, 3 calls after a warm-up; the wrapper's prep passes
    included).  Launch counts are restored (``quiet``)."""
    import torch

    from cuda_knearests_tpu_torch.mxu import kernel as mk

    passes = torch.zeros(mk.SPLIT_MAX_PASSES, dtype=torch.int32, device=DEV)

    def once():
        before = mk.split_launches
        out = mk.select_split(q, qid, p, cid, k, m, d, True, precision,
                              arm=arm, passes=passes)
        return out, mk.split_launches - before

    out, launches = quiet(once)
    counts = passes.cpu().numpy()
    ms = quiet(lambda: cuda_ms(lambda: mk.select_split(
        q, qid, p, cid, k, m, d, True, precision, arm=arm), 3))
    return {"arm": arm or mk.split_arm(d, k, m), "launches": launches,
            "passes": {int(i): int(c) for i, c in enumerate(counts) if c},
            "ms": ms, "out": out}


def split_timing(points: np.ndarray, k: int, m: int) -> dict:
    """The split selection over all queries at the brute phase's
    gate-refused shape (f32), against its plain version and the kernel on
    1,024 of the queries (which must agree exactly), a chunked matmul +
    topk yardstick (no TF32) and the bound: the larger of 2*d operations
    per (query, candidate) pair over the FP32 peak and the bytes of inputs
    and outputs over the HBM rate.  The kernel time covers the wrapper's
    launches (two prep passes and one launch a chunk of queries).  Prints
    the arm, launches and passes at m, at m = 100 (the pool arm) and at
    bf16, and the one measurement that sets ``_SPLIT_DIRECT_MAX_D``: both
    arms at d=3 (these points, k) and at d=128 (20k x 128, k=1,600), whose
    outputs must agree."""
    import torch

    from cuda_knearests_tpu_torch.mxu import kernel as mk
    from cuda_knearests_tpu_torch.mxu import scorer as ms
    from cuda_knearests_tpu_torch.mxu.solve import select_inputs

    n, d = points.shape
    qid, pts_il, cid_il = select_inputs(points, n, True)
    q, qid_t, p, cid = [torch.as_tensor(a, device=DEV)
                        for a in (points, qid, pts_il, cid_il)]
    main = split_run(q, qid_t, p, cid, k, m, d)
    ms_full = main["ms"]
    sub = torch.as_tensor(np.random.default_rng(5).permutation(n)[:1024],
                          device=DEV).long()
    qs, qids = q[sub].contiguous(), qid_t[sub].contiguous()
    want = ms.select_plain(qs, qids, p, cid, k, m, d, True)
    got = quiet(lambda: mk.select_split(qs, qids, p, cid, k, m, d, True))
    err = require_equal(f"split select k={k} on {sub.numel()} queries",
                        (got[1], got[0], got[2]), (want[1], want[0], want[2]))
    sub_ms = quiet(lambda: cuda_ms(
        lambda: mk.select_split(qs, qids, p, cid, k, m, d, True), 3))
    plain_ms = cuda_ms(lambda: ms.select_plain(qs, qids, p, cid, k, m, d,
                                               True), 1)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    qn = (q * q).sum(1)
    step = max(1, (1 << 30) // (4 * n))

    def library():
        for r0 in range(0, n, step):
            s = (qn[r0:r0 + step, None] + qn[None, :]
                 - 2.0 * (q[r0:r0 + step] @ q.T))
            torch.topk(s, k + 1, dim=1, largest=False)

    try:
        library_ms = cuda_ms(library, 1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    flops = 2 * d * n * n
    nbytes = (4 * n * d + 4 * pts_il.size + 4 * n + 4 * cid_il.size
              + 8 * n * k + n)
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    plan = mk.split_plan(n, pts_il.shape[0], d, k, m)
    print(f"  split select {n // 1000}k x {d} k={k} m={m}: {plan.arm} arm, "
          f"{main['launches']} launch(es) a call, passes {{passes: blocks}} "
          f"{main['passes']}; kernel {ms_full:.3f} ms over {n} queries "
          f"({plan.rows} a launch, pool {plan.p_len} keys a query, sort "
          f"width {plan.n2}"
          f"{' in a scratch row' if plan.scratch else ' in shared memory'});"
          f" on {sub.numel()} of them kernel {sub_ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms (equal outputs); matmul+topk "
          f"{library_ms:.3f} ms; {flops} ops -> {t_ops:.4f} ms at "
          f"{PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s, {nbytes} bytes -> "
          f"{t_bytes:.4f} ms", flush=True)
    m100 = split_run(q, qid_t, p, cid, k, 100, d)
    print(f"  split select {n // 1000}k x {d} k={k} m=100: {m100['arm']} "
          f"arm, {m100['launches']} launches, passes {m100['passes']}; "
          f"kernel {m100['ms']:.3f} ms", flush=True)
    bf16 = split_run(q, qid_t, p, cid, k, m, d, precision="bf16")
    print(f"  split select {n // 1000}k x {d} k={k} m={m} bf16: "
          f"{bf16['arm']} arm, {bf16['launches']} launch(es), passes "
          f"{bf16['passes']}; kernel {bf16['ms']:.3f} ms", flush=True)
    arms = {}
    pts128 = (np.random.default_rng(1600).random((n, 128)) * 100).astype(
        np.float32)
    for label, pts_a, k_a in (("d=3", None, k), ("d=128", pts128, 1600)):
        if pts_a is None:
            args = (q, qid_t, p, cid)
        else:
            qid_a, il_a, cid_a = select_inputs(pts_a, n, True)
            args = tuple(torch.as_tensor(a, device=DEV)
                         for a in (pts_a, qid_a, il_a, cid_a))
        d_a = args[0].shape[1]
        runs = {arm: split_run(*args, k_a, 128, d_a, arm)
                for arm in ("direct", "pool")}
        o, w = runs["direct"]["out"], runs["pool"]["out"]
        err = max(err, require_equal(
            f"split select {label} k={k_a}: direct arm against pool arm",
            (o[1], o[0], o[2]), (w[1], w[0], w[2])))
        for arm, r in runs.items():
            arms[f"{label} {arm}"] = r["ms"]
            print(f"  split arms at {n // 1000}k, {label}, k={k_a}, m=128: "
                  f"{arm} {r['ms']:.3f} ms ({r['launches']} launches, "
                  f"passes {r['passes']})", flush=True)
        del runs, args
    print(f"  split arms: routed by split_plan to direct up to d = "
          f"{mk._SPLIT_DIRECT_MAX_D}", flush=True)
    return err, {"ms": ms_full, "plain_ms": plain_ms,
                 "plain_queries": int(sub.numel()),
                 "ms_on_plain_queries": sub_ms, "library_ms": library_ms,
                 "bound_ms": max(t_ops, t_bytes),
                 "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                 "arm": main["arm"], "launches_per_call": main["launches"],
                 "passes": main["passes"], "ms_m100": m100["ms"],
                 "ms_bf16": bf16["ms"],
                 "ms_arms": arms}


def fold_timing(label: str, points: np.ndarray, k: int, m: int) -> float:
    """The bf16 selection over all queries at m >= 2, where each row's
    fold runs select_fold.cuh's ``fold_step``: ms per call (CUDA events,
    mean of 3 after a warm-up, prep passes included)."""
    import torch

    from cuda_knearests_tpu_torch.mxu import kernel as mk
    from cuda_knearests_tpu_torch.mxu.solve import select_inputs

    n, d = points.shape
    qid, pts_il, cid_il = select_inputs(points, n, True)
    q, qid_t, p, cid = [torch.as_tensor(a, device=DEV)
                        for a in (points, qid, pts_il, cid_il)]
    t = quiet(lambda: cuda_ms(
        lambda: mk.select(q, qid_t, p, cid, k, m, d, True, "bf16"), 3))
    print(f"  {label}: select kernel {t:.3f} ms over {n} queries at m={m} "
          f"(the fold's m >= 2 path)", flush=True)
    return t


# -- phase 6: the grid path with the blocked kernel ----------------------------

def path_b(points: np.ndarray, kpass_prob) -> tuple:
    """The 900k/k=10 main path with kernel='blocked': blocked launches,
    deficit rows, exactness, and the one-stage path's distances (ids equal
    but inside exact distance ties)."""
    import torch

    import cuda_knearests_tpu_torch as pt
    from cuda_knearests_tpu_torch.ops import cuda_solve as cs
    from cuda_knearests_tpu_torch.ops.adaptive import (class_blocked_m,
                                                       solve_adaptive)

    cfg = pt.KnnConfig(k=10, kernel="blocked")
    prob, prep_s = prepared(points, cfg)
    require(all(class_blocked_m(cfg, cp.ccap) for cp in prob.aplan.classes),
            "900k/k=10 blocked: a class is not blocked-eligible")
    kpass_launches = cs.launches
    launches, _, cert = main_path("900k blocked", points, cfg, 3, prob,
                                  prep_s, counter="blocked_launches")
    require(cs.launches == kpass_launches,
            "900k blocked: the one-stage kernel ran on the blocked path")
    raw = quiet(lambda: solve_adaptive(prob.grid, cfg, prob.aplan))
    deficit = int(torch.isnan(raw.dists_sq[:, cfg.k - 1]).sum())
    a_d, b_d = prob.get_dists_sq(), kpass_prob.get_dists_sq()
    require(np.array_equal(a_d, b_d),
            "900k blocked: distances differ from the one-stage path")
    a_i, b_i = prob.get_knearests(), kpass_prob.get_knearests()
    for r, c in zip(*np.nonzero(a_i != b_i)):
        require(int((a_d[r] == a_d[r, c]).sum()) > 1,
                f"900k blocked: row {r} column {c} differs from the "
                f"one-stage path outside a distance tie")
    per_block = sum(per_block_rows(cp.pk.args(), cfg.k,
                                   class_blocked_m(cfg, cp.ccap),
                                   cfg.exclude_self)
                    for cp in prob.aplan.classes)
    print(f"  900k blocked: m={[class_blocked_m(cfg, cp.ccap) for cp in prob.aplan.classes]}"
          f"; per-block rows {per_block}; deficit rows {deficit}; "
          f"uncertified rows {int((~cert).sum())}; "
          f"distances equal to the one-stage path's, ids equal but "
          f"{int((a_i != b_i).sum())} entries inside distance ties",
          flush=True)
    return prob, cfg, launches


# -- phase 7: the grid path at a k no class kernel holds -----------------------

def streamed_path(points: np.ndarray, k: int, runs: int) -> dict:
    """``KnnProblem.prepare(points).solve()`` at k = ``k`` (>= 893: the
    class kernels' lists do not fit one block, so every class takes the
    streamed route): no class-kernel launch, at most two host round trips,
    every row certified after the fallback, and exact against cKDTree on
    2,000 sampled rows (tie-aware), and in one more solve each streamed
    class's peak allocation (``torch.cuda.max_memory_allocated``) within
    the model the plan routes by.  Prints each class's route and streaming
    geometry, the solve times, and the streamed route's time and memory
    in that solve."""
    import torch
    from scipy.spatial import cKDTree

    import cuda_knearests_tpu_torch as pt
    from cuda_knearests_tpu_torch.ops import adaptive
    from cuda_knearests_tpu_torch.ops import cuda_solve as cs
    from cuda_knearests_tpu_torch.runtime import dispatch

    cfg = pt.KnnConfig(k=k)
    prob, prep_s = prepared(points, cfg)
    classes = prob.aplan.classes
    require(all(cp.route == "streamed" for cp in classes),
            f"k={k}: a class was routed to the kernel")
    cs.launches = cs.blocked_launches = 0
    times, max_syncs = [], 0
    for i in range(1 + runs):
        dispatch.reset_stats()
        t0 = time.perf_counter()
        res = prob.solve()
        dt = time.perf_counter() - t0
        syncs = dispatch.stats().host_syncs
        require(syncs <= dispatch.SYNC_BUDGET,
                f"k={k}: solve made {syncs} host round trips")
        max_syncs = max(max_syncs, syncs)
        if i:
            times.append(dt)
    require(cs.launches == cs.blocked_launches == 0,
            f"k={k}: a class kernel was launched on the streamed path")
    n = prob.grid.n_points
    nbrs = prob.get_knearests_original()
    require(nbrs.shape == (n, k), f"k={k}: result shape {nbrs.shape}")
    require(bool(np.isfinite(prob.get_dists_sq()).all()),
            f"k={k}: non-finite distances")
    require(bool(np.asarray(res.certified).all()),
            f"k={k}: rows left uncertified after the fallback")
    rows = np.sort(np.random.default_rng(17).permutation(n)[:2000])
    t0 = time.perf_counter()
    check_exact(points, nbrs, rows, k, cKDTree(points.astype(np.float64)))
    check_s = time.perf_counter() - t0
    streamed_ms, peak_mb = [], []
    orig = adaptive._streamed_class

    def timed(grid, cp, *a, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        orig(grid, cp, *a, **kw)
        torch.cuda.synchronize()
        streamed_ms.append((time.perf_counter() - t1) * 1e3)
        # the class's solve-time temporaries against the model the plan
        # routes by
        peak = torch.cuda.max_memory_allocated() - base
        model = (adaptive._SLOT_SOLVE_BYTES * cp.n_sc * cp.qcap
                 + adaptive.stream_step_bytes(cp.step_rows, cp.qcap,
                                              cp.ccap, k))
        peak_mb.append((peak / 2**20, model / 2**20))
        require(peak <= model, f"k={k}: a streamed class allocated {peak} "
                f"bytes, above its modeled {model}")

    adaptive._streamed_class = timed
    try:
        adaptive.solve_adaptive(prob.grid, cfg, prob.aplan)
    finally:
        adaptive._streamed_class = orig
    med = float(np.median(times))
    print(f"  {n // 1000}k blue noise k={k}: classes (route, supercells "
          f"a step, tile, qcap, ccap, radius, supercells) "
          f"{[(cp.route, cp.step_rows, adaptive.stream_tile(cp.ccap), cp.qcap, cp.ccap, cp.radius, cp.n_sc) for cp in classes]}"
          f"\n    prepare {prep_s:.3f} s; solve median of {runs} "
          f"{med * 1e3:.3f} ms (runs ms "
          f"{[round(t * 1e3, 3) for t in times]}); streamed route "
          f"{sum(streamed_ms):.3f} ms of one more solve (host clock between "
          f"synchronizations, by class {[round(t, 3) for t in streamed_ms]})"
          f"\n    streamed classes' peak allocation (torch.cuda."
          f"max_memory_allocated) against the plan's model, MiB "
          f"{[(round(a, 3), round(b, 3)) for a, b in peak_mb]}"
          f"\n    class-kernel launches 0; fallback rows "
          f"{int(res.uncert_count)}; host round trips {max_syncs}; exact vs "
          f"cKDTree on {rows.size} rows, checked in {check_s:.1f} s",
          flush=True)
    return {"median_s": med, "streamed_ms": sum(streamed_ms),
            "fallback_rows": int(res.uncert_count)}


# -- phase 8: external queries through the class kernels ----------------------

# A query pack whose padded (query, candidate) pairs exceed this is held
# to the plain version on its fullest supercells only.
WHOLE_QUERY_PAIRS = 1 << 33


def query_plan(prob, queries: np.ndarray):
    """(class of each query, per-class host plans) of one query call, as
    ``query_adaptive`` makes them."""
    from cuda_knearests_tpu_torch.ops import adaptive

    qcls, qrow = adaptive.bucket_queries(prob.grid, prob.config, prob.aplan,
                                         queries)
    return qcls, adaptive.plan_queries(
        prob.config, prob.aplan, qcls, qrow, prob.config.k,
        adaptive.hbm_budget_bytes(prob.device))


def query_calls(name: str, prob, queries: np.ndarray, runs: int,
                counter: str = "launches"):
    """``prob.query(queries)`` 1 + ``runs`` times: each call must launch
    the class kernel ``counter`` names once per kernel-route class with
    queries, make at most two host round trips and answer every row; the
    rows the exact fallback resolves are counted.  Both class kernels'
    counts are set to 0 just before the calls and read just after (facts
    ``launches``, ``blocked_launches``).  Prints each class's route, q2cap
    and query-pack bytes, and the median and spread of the warm calls'
    throughput.  Returns (ids, d2, facts)."""
    from cuda_knearests_tpu_torch.ops import adaptive
    from cuda_knearests_tpu_torch.ops import cuda_solve as cs
    from cuda_knearests_tpu_torch.runtime import dispatch

    m, k = queries.shape[0], prob.config.k
    qcls, buckets = query_plan(prob, queries)
    n_kernel = sum(b.route == "kernel" for b in buckets)
    resolved = []
    brute = adaptive.brute_force_by_coords

    def counted(points, q, *a, **kw):
        resolved.append(int(q.shape[0]))
        return brute(points, q, *a, **kw)

    times, max_syncs = [], 0
    adaptive.brute_force_by_coords = counted
    cs.launches = cs.blocked_launches = 0
    try:
        for i in range(1 + runs):
            before = getattr(cs, counter)
            dispatch.reset_stats()
            t0 = time.perf_counter()
            ids, d2 = prob.query(queries)
            dt = time.perf_counter() - t0
            syncs = dispatch.stats().host_syncs
            done = getattr(cs, counter) - before
            require(done == n_kernel,
                    f"{name}: query made {done} {counter} for {n_kernel} "
                    f"kernel-route classes")
            require(syncs <= dispatch.SYNC_BUDGET,
                    f"{name}: query made {syncs} host round trips")
            max_syncs = max(max_syncs, syncs)
            if i:
                times.append(dt)
    finally:
        adaptive.brute_force_by_coords = brute
    launched = {"launches": cs.launches,
                "blocked_launches": cs.blocked_launches}
    require(ids.shape == (m, k) and d2.shape == (m, k),
            f"{name}: result shapes {ids.shape} {d2.shape}")
    require(bool((ids >= 0).all()) and bool(np.isfinite(d2).all()),
            f"{name}: rows with missing neighbours")
    fallback = resolved[-1] if resolved else 0
    classless = int((qcls < 0).sum())
    med = float(np.median(times))
    print(f"  {name}: m={m} k={k}; classes (class, route, q2cap, query-pack "
          f"bytes, supercells a step, queries) "
          f"{[(b.cls, b.route, b.q2cap, b.pack_bytes if b.route == 'kernel' else 0, b.step_rows, b.src.size) for b in buckets]}"
          f"\n    query median of {runs} {med * 1e3:.3f} ms = "
          f"{m / med:,.0f} queries/s, range {m / max(times):,.0f}-"
          f"{m / min(times):,.0f} (runs ms "
          f"{[round(t * 1e3, 3) for t in times]}); {counter} per call "
          f"{n_kernel}; fallback rows {fallback} ({classless} classless); "
          f"host round trips {max_syncs} (max over calls, budget "
          f"{dispatch.SYNC_BUDGET})", flush=True)
    return ids, d2, {"median_s": med, "queries_per_s": m / med,
                     "queries_per_s_range": (m / max(times), m / min(times)),
                     "launches_per_call": n_kernel, "syncs": max_syncs,
                     **launched,
                     "fallback_rows": fallback, "classless": classless,
                     "buckets": buckets}


def check_queries_exact(name: str, points: np.ndarray, queries: np.ndarray,
                        ids: np.ndarray, rows: np.ndarray, k: int,
                        tree) -> None:
    """Sampled query rows against the kd-tree, tie-aware."""
    t0 = time.perf_counter()
    dk, ik = tree.query(queries[rows].astype(np.float64), k=k)
    check_rows_exact(points, ids, rows, dk ** 2, ik, queries=queries)
    print(f"  {name}: exact vs cKDTree on {rows.size} rows, checked in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def check_radius(name: str, prob, points: np.ndarray, queries: np.ndarray,
                 radius: float, tree) -> None:
    """``query_radius`` at the prepared k against
    ``cKDTree.query_ball_point``: in-range ids, counts and ``truncated``,
    with points within a relative 1e-5 of the radius allowed either way
    (float32 d2 against the tree's float64 distances)."""
    k = prob.config.k
    ids, d2, counts, trunc = prob.query_radius(queries, radius)
    inner = tree.query_ball_point(queries.astype(np.float64),
                                  radius * (1 - 1e-5))
    outer = tree.query_ball_point(queries.astype(np.float64),
                                  radius * (1 + 1e-5))
    for r in range(queries.shape[0]):
        got = set(ids[r][ids[r] >= 0].tolist())
        lo, hi = set(inner[r]), set(outer[r])
        require(len(got) == counts[r] and bool(trunc[r]) == (counts[r] >= k),
                f"{name}: row {r} count {counts[r]} / truncated {trunc[r]} "
                f"disagree with its ids")
        if counts[r] < k:
            require(lo <= got <= hi, f"{name}: row {r} in-range ids {got} "
                                     f"differ from cKDTree's {lo}")
        else:
            require(len(hi) >= k and got <= hi,
                    f"{name}: truncated row {r} has ids out of range")
    print(f"  {name}: query_radius({radius}) on {queries.shape[0]} rows "
          f"equal to cKDTree.query_ball_point (counts {int(counts.sum())}, "
          f"truncated {int(trunc.sum())})", flush=True)


def host_profile(name: str, what: str, run, top: int = 8) -> None:
    """The host functions that take the most time in one warm call of
    ``run`` (cProfile, own time; numpy and torch calls count whole)."""
    import cProfile
    import pstats

    run()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    run()
    prof.disable()
    wall = (time.perf_counter() - t0) * 1e3
    stats = pstats.Stats(prof).stats
    rows = sorted(((tt, nc, f"{os.path.basename(f)}:{line} {fn}")
                   for (f, line, fn), (_, nc, tt, _, _) in stats.items()),
                  reverse=True)[:top]
    print(f"  {name}: one {what} {wall:.3f} ms wall under cProfile; host "
          f"time by function (own time):", flush=True)
    for tt, nc, where in rows:
        print(f"    {tt * 1e3:9.3f} ms  x{nc:<5d} {where[:80]}", flush=True)


def query_kernel(name: str, prob, queries: np.ndarray, buckets,
                 reps: int) -> dict:
    """The class kernel over one query call's packs (mode (a), as
    ``query()`` launches it) by CUDA events, with the bound of the work the
    packs hold: 20 bytes a real query slot and 4 a pad (mode (a) reads
    only a pad's target), the candidates of the supercells that hold a
    query once, the (m, k) outputs, and 8 f32 operations a real pair; then
    held to its plain version in both modes on the whole pack, or on its
    fullest supercells and its first when wider than
    ``WHOLE_QUERY_PAIRS``."""
    import torch

    from cuda_knearests_tpu_torch.ops import adaptive

    cfg, m = prob.config, queries.shape[0]
    k = cfg.k
    q_dev = torch.as_tensor(queries, device=DEV)
    packs = []
    for b in buckets:
        if b.route == "kernel":
            cp = prob.aplan.classes[b.cls]
            pk, tgt = adaptive.query_pack(q_dev, cp, b, m)
            packs.append((b, cp, pk, tgt,
                          adaptive.class_blocked_m(cfg, cp.ccap, k)))
    require(bool(packs), f"{name}: no kernel-route class")
    out = row_buffers(m, k)

    def kernel(tgts):
        for (_, cp, pk, _, _), tgt in zip(packs, tgts):
            adaptive.launch_kernel_class(cfg, cp.ccap, pk, tgt, k, False,
                                         out)

    ms = quiet(lambda: cuda_ms(lambda: kernel([p[3] for p in packs]), reps))
    # the same launches with every slot a pad (target row m): what the
    # padding alone costs
    pads = [torch.full_like(p[3], m) for p in packs]
    pads_ms = quiet(lambda: cuda_ms(lambda: kernel(pads), reps))
    del pads
    in_bytes, pairs = 0, 0
    for b, cp, pk, tgt, _ in packs:
        slots, real = b.n_sc * b.q2cap, b.src.size
        nq = b.starts[1:] - b.starts[:-1]
        # cx, cy, cz, cid of each candidate slot of a supercell with queries
        in_bytes += (20 * real + 4 * (slots - real)
                     + 16 * cp.ccap * int((nq > 0).sum()))
        pairs += int((torch.as_tensor(nq, device=DEV)
                      * (pk.cid >= 0).sum(1)).sum())
    out_bytes = m * k * 8
    t_bytes = (in_bytes + out_bytes) / PEAK_HBM_BYTES * 1e3
    t_ops = 8 * pairs / PEAK_F32_FLOPS * 1e3
    err = 0.0
    for b, cp, pk, tgt, blk in packs:
        args, what = list(pk.args()), "whole"
        if b.n_sc * b.q2cap * cp.ccap > WHOLE_QUERY_PAIRS:
            nq = b.starts[1:] - b.starts[:-1]
            pick = np.unique(np.concatenate([np.argsort(nq)[-4:], [0]]))
            sel = torch.as_tensor(pick, device=DEV)
            args = [a[sel].contiguous() for a in args]
            tgt = tgt.view(b.n_sc, b.q2cap)[sel].reshape(-1).contiguous()
            what = f"{pick.size} supercells"
        err = max(err, compare_modes(
            f"{name} query pack, class {b.cls} ({what})", args, tgt, m, k,
            False, blk))
    q2cap = max(b.q2cap for b, *_ in packs)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"  {name}: class kernel on the query packs {ms:.4f} ms (CUDA "
          f"events, {reps} launches), on the same packs all pads "
          f"{pads_ms:.4f} ms; q2cap {q2cap}; bytes {in_bytes + out_bytes} "
          f"-> {t_bytes:.4f} ms at 3.35 TB/s; real pairs {pairs} -> "
          f"{t_ops:.4f} ms at 67 TFLOP/s; bound {max(t_bytes, t_ops):.4f} "
          f"ms by {bound_by}, kernel {ms / max(t_bytes, t_ops):.1f}x over it",
          flush=True)
    return {"ms": ms, "pads_ms": pads_ms, "q2cap": q2cap,
            "bound_ms": max(t_bytes, t_ops), "bound_by": bound_by,
            "bytes_ms": t_bytes, "ops_ms": t_ops, "max_abs_err": err}


def query_phase(points: np.ndarray, prob, prob_b) -> dict:
    """External queries against the 900k/k=10 problem (``prob``, and
    ``prob_b`` with kernel='blocked'): (i) 1,000,000 uniform queries,
    20,000 sampled rows exact against cKDTree and ``query_radius`` on
    2,000 of them against ``query_ball_point``; (ii) 200,000 clustered
    queries, whose fullest supercell inflates q2cap; (iii) (i) with the
    blocked kernel, whose answers must equal (i)'s; (iv) 20,000 uniform
    queries against a 300k cloud confined to x < 500, whose queries in
    empty supercells (no class) the exact fallback answers.  (i) and (ii)
    are timed end to end, by kernel and under the profiler.  Returns the
    launches and measurements for the kernels line."""
    from scipy.spatial import cKDTree

    import cuda_knearests_tpu_torch as pt
    from cuda_knearests_tpu_torch.io import (generate_clustered,
                                             generate_uniform)

    k = prob.config.k
    tree = cKDTree(points.astype(np.float64))
    rng = np.random.default_rng(905)
    q_uni = generate_uniform(1_000_000, seed=901)
    ids, d2, uni = query_calls("(i) 1M uniform", prob, q_uni, 3)
    check_queries_exact("(i) 1M uniform", points, q_uni, ids,
                        np.sort(rng.permutation(q_uni.shape[0])[:SAMPLE_ROWS]),
                        k, tree)
    check_radius("(i) 1M uniform", prob, points, q_uni[:2000], 12.0, tree)
    uni.update(kernel=query_kernel("(i) 1M uniform", prob, q_uni,
                                   uni["buckets"], 20),
               profile=device_breakdown("(i) 1M uniform", "query",
                                        lambda: prob.query(q_uni),
                                        uni["launches_per_call"]))
    quiet(lambda: host_profile("(i) 1M uniform", "query",
                               lambda: prob.query(q_uni)))
    q_cl = generate_clustered(200_000, seed=902)
    ids_cl, _, clu = query_calls("(ii) 200k clustered", prob, q_cl, 3)
    check_queries_exact("(ii) 200k clustered", points, q_cl, ids_cl,
                        np.sort(rng.permutation(q_cl.shape[0])[:2000]), k,
                        tree)
    clu.update(kernel=query_kernel("(ii) 200k clustered", prob, q_cl,
                                   clu["buckets"], 5),
               profile=device_breakdown("(ii) 200k clustered", "query",
                                        lambda: prob.query(q_cl),
                                        clu["launches_per_call"]))
    quiet(lambda: host_profile("(ii) 200k clustered", "query",
                               lambda: prob.query(q_cl)))
    del q_cl, ids_cl

    half = np.random.default_rng(903)
    pts_half = (half.random((300_000, 3)) * [500.0, 1000.0, 1000.0]).astype(
        np.float32)
    q_half = (half.random((20_000, 3)) * 1000.0).astype(np.float32)
    prob_half, _ = prepared(pts_half, pt.KnnConfig(k=k))
    ids_h, _, hal = query_calls("(iv) 20k vs 300k at x < 500", prob_half,
                                q_half, 1)
    require(hal["classless"] > 0 and hal["fallback_rows"]
            >= hal["classless"], "(iv): no classless queries resolved")
    check_queries_exact("(iv) 20k vs 300k at x < 500", pts_half, q_half,
                        ids_h, np.arange(q_half.shape[0]), k,
                        cKDTree(pts_half.astype(np.float64)))
    del prob_half, pts_half

    ids_b, d2_b, blk = query_calls("(iii) 1M uniform, blocked", prob_b,
                                   q_uni, 1, counter="blocked_launches")
    runs = (uni, clu, hal, blk)
    launches = sum(r["launches"] for r in runs)
    blocked_launches = sum(r["blocked_launches"] for r in runs)
    require(np.array_equal(d2_b, d2),
            "(iii): blocked distances differ from the one-stage path's")
    for r, c in zip(*np.nonzero(ids_b != ids)):
        require(int((d2[r] == d2[r, c]).sum()) > 1,
                f"(iii): row {r} column {c} differs from the one-stage "
                f"path outside a distance tie")
    blk.update(kernel=query_kernel("(iii) 1M uniform, blocked", prob_b,
                                   q_uni, blk["buckets"], 20))
    print(f"  (iii): distances equal to the one-stage path's, ids equal but "
          f"{int((ids_b != ids).sum())} entries inside distance ties",
          flush=True)
    return {"launches": launches, "blocked_launches": blocked_launches,
            "uniform": uni, "clustered": clu, "blocked": blk}


# -- phase 10: friends-of-friends and the plane feed ---------------------------

# The reference's FoF row (its fof_300k bench row): b = the mean spacing of
# pts300K.xyz, and 0.2 x that, the usual halo-finder linking length.
FOF_LENGTHS = (14.938, 2.988)


def kdtree_bracket(points: np.ndarray, b: float, band: float):
    """The union-find oracle's bracketing partitions (``oracle.fof_oracle``)
    at a size its O(n^2) pairs cannot reach: connected components of
    cKDTree's pairs within sqrt(max(b^2 - band, 0)) (must link) and
    sqrt(b^2 + band) (may link), in float64."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    from scipy.spatial import cKDTree

    tree = cKDTree(points.astype(np.float64))
    n = points.shape[0]
    b2 = float(np.float64(b) ** 2)
    out = []
    for r2 in (max(b2 - band, 0.0), b2 + band):
        pairs = tree.query_pairs(np.sqrt(r2), output_type="ndarray")
        graph = coo_matrix((np.ones(len(pairs), np.int8),
                            (pairs[:, 0], pairs[:, 1])), shape=(n, n))
        out.append(connected_components(graph, directed=False)[1])
    return out


def fof_breakdown(name: str, points: np.ndarray, b: float) -> dict:
    """One FoF solve taken apart: the host twin (sort and densest cell)
    and the neighbour cells by host clock; the staging (grid build,
    neighbour cells again, upload, ``link_slots``) by host clock ending in
    a synchronize; the rounds under torch.profiler (device time and
    kernels a round against host wall a round, each round ending in its
    counted flag read); the finalize by CUDA events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cuda_knearests_tpu_torch.cluster import fof
    from cuda_knearests_tpu_torch.runtime import dispatch

    n = points.shape[0]
    t0 = time.perf_counter()
    plan = fof.plan_fof(points, b)
    twin_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    fof._neighbor_cells_host(points, plan.order, plan.dim, 1000.0)
    cells_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid, slots = fof.stage_fof(points, b, plan, 1000.0, torch.device(DEV))
    labels = dispatch.stage(np.arange(n, dtype=np.int32), DEV)
    torch.cuda.synchronize()
    stage_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rounds, changed = 0, True
        while changed:
            labels, chg = fof.fof_round(labels, slots)
            rounds += 1
            changed = bool(dispatch.fetch(chg)[0])
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy, kernels = 0.0, 0
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = getattr(e, "cuda_time_total", 0)
            busy += us / 1e3
            if "Memcpy" not in e.key and "Memset" not in e.key:
                kernels += e.count
    fin_ms = cuda_ms(lambda: fof.fof_finalize(labels, grid.permutation), 10)
    print(f"  FoF {name}: host twin (sort, densest cell) {twin_ms:.3f} ms, "
          f"neighbour cells {cells_ms:.3f} ms; staging (grid build, "
          f"neighbour cells, upload, link_slots: {slots.numel() * 4:,} "
          f"bytes) {stage_ms:.3f} ms; {rounds} rounds in {wall_ms:.3f} ms "
          f"wall under the profiler = {wall_ms / rounds:.3f} ms a round, "
          f"device {busy / rounds:.4f} ms a round ({busy / wall_ms:.1%} of "
          f"wall), {kernels / rounds:.0f} kernels a round; finalize "
          f"{fin_ms:.4f} ms (CUDA events)", flush=True)
    if not busy:
        print("    the profiler recorded no device time", flush=True)
    return {"twin_ms": twin_ms, "cells_ms": cells_ms, "stage_ms": stage_ms,
            "rounds": rounds, "round_wall_ms": wall_ms / rounds,
            "round_device_ms": busy / rounds,
            "kernels_per_round": kernels / rounds, "finalize_ms": fin_ms}


def fof_run(points: np.ndarray, b: float, warm: int) -> dict:
    """``fof_labels`` on the card, 1 cold and ``warm`` warm calls (the same
    answer each time, ``rounds + 1`` host round trips), against the same
    call on the CPU (labels, sizes and rounds equal) and the kd-tree
    bracket (``check_fof_bracket``)."""
    from cuda_knearests_tpu_torch.cluster import fof
    from cuda_knearests_tpu_torch.cluster.compare import (check_fof_bracket,
                                                          fof_band)

    n = points.shape[0]
    name = f"{n:,} points, b={b}"
    plan = fof.plan_fof(points, b)
    times = []
    for i in range(1 + warm):
        t0 = time.perf_counter()
        res = fof.fof_labels(points, b)
        times.append(time.perf_counter() - t0)
        require(res.host_syncs == res.rounds + 1,
                f"FoF {name}: {res.host_syncs} host round trips for "
                f"{res.rounds} rounds")
        if i:
            require(np.array_equal(res.labels, first.labels)
                    and np.array_equal(res.sizes, first.sizes),
                    f"FoF {name}: a warm call answered differently")
        else:
            first = res
    t0 = time.perf_counter()
    cpu = fof.fof_labels(points, b, device="cpu")
    cpu_s = time.perf_counter() - t0
    require(np.array_equal(res.labels, cpu.labels)
            and np.array_equal(res.sizes, cpu.sizes)
            and res.rounds == cpu.rounds,
            f"FoF {name}: the card's labels differ from the CPU's "
            f"({int((res.labels != cpu.labels).sum())} points)")
    t0 = time.perf_counter()
    band = fof_band(b)
    mand, allowed = kdtree_bracket(points, b, band)
    bad = check_fof_bracket(res.labels, res.sizes, mand, allowed)
    require(bad is None, f"FoF {name}: {bad.render() if bad else ''}")
    check_s = time.perf_counter() - t0
    ms = np.array(times[1:]) * 1e3
    med = float(np.median(ms))
    largest = int(res.sizes.max())
    print(f"  FoF {name}: dim {res.dim}, cell_max {res.cell_max}, m "
          f"{plan.m}; {res.rounds} rounds, {res.host_syncs} host round "
          f"trips, {res.n_clusters:,} clusters, largest {largest:,}; cold "
          f"{times[0] * 1e3:.3f} ms, warm median of {warm} {med:.3f} ms "
          f"(min {ms.min():.3f}, max {ms.max():.3f}) = {n / med * 1e3:,.0f} "
          f"points/s (range {n / ms.max() * 1e3:,.0f}-"
          f"{n / ms.min() * 1e3:,.0f}); equal to the CPU run "
          f"({cpu_s:.1f} s); inside the cKDTree bracket (band {band:.6g}; "
          f"mandatory {int(np.unique(mand).size):,} and allowed "
          f"{int(np.unique(allowed).size):,} components, checked in "
          f"{check_s:.1f} s)", flush=True)
    return {"b": b, "dim": res.dim, "cell_max": res.cell_max, "m": plan.m,
            "rounds": res.rounds, "n_clusters": res.n_clusters,
            "largest": largest, "cold_ms": times[0] * 1e3,
            "median_ms": med, "min_ms": float(ms.min()),
            "max_ms": float(ms.max()), "points_per_s": n / med * 1e3,
            **fof_breakdown(name, points, b)}


def fof_refusal(points: np.ndarray, b: float) -> None:
    """The 900k blue cube at its mean spacing holds 900,000 x 16 x 27 =
    388,800,000 candidate slots a round, over the 268,435,456 of
    ``MAX_PAIR_SLOTS``: ``fof_labels`` must refuse it, as the reference
    does, before allocating anything on the card."""
    import torch

    from cuda_knearests_tpu_torch.cluster import fof
    from cuda_knearests_tpu_torch.utils.memory import LaunchBudgetError

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        fof.fof_labels(points, b)
    except LaunchBudgetError as e:
        err = e
    else:
        raise SmokeFailure(f"FoF on the 900k blue cube at b={b} ran; the "
                           f"reference refuses it")
    slots = points.shape[0] * 16 * 27
    require(err.site == "cluster.fof" and err.kind == "oom"
            and err.requested == slots * 4
            and err.budget == fof.MAX_PAIR_SLOTS * 4,
            f"FoF refusal: {err.site} {err.kind} {err.requested} "
            f"{err.budget}")
    peak = torch.cuda.max_memory_allocated()
    require(peak == before, f"FoF refusal allocated {peak - before} bytes "
                            f"on the card first")
    print(f"  FoF 900k blue cube, b={b}: refused with LaunchBudgetError "
          f"({slots:,} candidate slots > {fof.MAX_PAIR_SLOTS:,}; requested "
          f"{err.requested:,} bytes, budget {err.budget:,}), nothing "
          f"allocated on the card", flush=True)


def ref_planes(sites: np.ndarray, points: np.ndarray,
               ids: np.ndarray) -> np.ndarray:
    """The plane feed recomputed in float64 from returned ids."""
    q = sites.astype(np.float64)[:, None, :]
    p = points[np.clip(ids, 0, None)].astype(np.float64)
    nn = (p - q).astype(np.float32)
    d = (((p * p).sum(-1) - (q * q).sum(-1)) / 2.0).astype(np.float32)
    ok = ids >= 0
    return np.concatenate(
        [np.where(ok[..., None], nn, np.float32(0.0)),
         np.where(ok, d, np.float32(np.inf))[..., None]], axis=-1)


def plane_feed_phase(points: np.ndarray) -> dict:
    """One solve with ``plane_feed=True`` on the 900k/k=10 main path and
    one ``query(planes=True)`` of 1M uniform queries against it: each
    launches the class kernel once per class (counts set to 0 just before,
    read just after), makes at most two host round trips, and gives planes
    equal bit for bit to a float64 recompute from its ids.  The host
    epilogue (``bisector_planes`` over the fetched rows) is timed apart,
    once more."""
    import cuda_knearests_tpu_torch as pt
    from cuda_knearests_tpu_torch.cluster.planes import bisector_planes
    from cuda_knearests_tpu_torch.io import generate_uniform
    from cuda_knearests_tpu_torch.ops import adaptive
    from cuda_knearests_tpu_torch.ops import cuda_solve as cs
    from cuda_knearests_tpu_torch.runtime import dispatch

    prob = pt.KnnProblem.prepare(points, pt.KnnConfig(k=10, plane_feed=True))
    n_cls = len(prob.aplan.classes)
    cs.launches = cs.blocked_launches = 0
    dispatch.reset_stats()
    t0 = time.perf_counter()
    res = prob.solve()
    solve_ms = (time.perf_counter() - t0) * 1e3
    syncs, solve_launches = dispatch.stats().host_syncs, cs.launches
    require(solve_launches == n_cls and syncs <= dispatch.SYNC_BUDGET,
            f"plane feed solve: {solve_launches} launches for {n_cls} "
            f"classes, {syncs} host round trips")
    ids = prob.get_knearests_original()
    require(res.planes is not None
            and np.array_equal(res.planes, ref_planes(points, points, ids)),
            "plane feed solve: planes differ from the float64 recompute")

    def epilogue_ms(fn) -> float:
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    solve_epi = epilogue_ms(prob._compute_planes)
    print(f"  plane feed, 900k/k=10 solve: {solve_ms:.3f} ms with the feed, "
          f"{solve_launches} launches, {syncs} host round trips; planes "
          f"{res.planes.shape} bit-identical to the float64 recompute; host "
          f"epilogue {solve_epi:.3f} ms", flush=True)
    queries = generate_uniform(1_000_000, seed=901)
    qcls, _ = adaptive.bucket_queries(prob.grid, prob.config, prob.aplan,
                                      queries)
    n_q = len(np.unique(qcls[qcls >= 0]))
    cs.launches = cs.blocked_launches = 0
    dispatch.reset_stats()
    t0 = time.perf_counter()
    q_ids, _, q_planes = prob.query(queries, planes=True)
    query_ms = (time.perf_counter() - t0) * 1e3
    q_syncs, query_launches = dispatch.stats().host_syncs, cs.launches
    require(query_launches == n_q and q_syncs <= dispatch.SYNC_BUDGET,
            f"plane feed query: {query_launches} launches for {n_q} "
            f"classes, {q_syncs} host round trips")
    require(np.array_equal(q_planes, ref_planes(queries, points, q_ids)),
            "plane feed query: planes differ from the float64 recompute")
    query_epi = epilogue_ms(lambda: bisector_planes(queries, points, q_ids))
    print(f"  plane feed, 1M uniform queries: {query_ms:.3f} ms with the "
          f"feed, {query_launches} launches, {q_syncs} host round trips; "
          f"planes {q_planes.shape} bit-identical to the float64 "
          f"recompute; host epilogue {query_epi:.3f} ms", flush=True)
    return {"solve_launches": solve_launches,
            "query_launches": query_launches, "solve_ms": solve_ms,
            "solve_epilogue_ms": solve_epi, "query_ms": query_ms,
            "query_epilogue_ms": query_epi}


# -- the serving daemon -----------------------------------------------------------

# The reference bench's serve sessions (its ``bench.py`` serve rows, at the
# same traffic), then one that forces compactions of the 900k cloud: (name,
# LoadSpec fields, KNTPU_SERVE_FAULT, compact_threshold).
SERVE_SESSIONS = (
    ("steady", dict(rate=400.0, requests=240, seed=20), None, 4096),
    ("mutating", dict(rate=400.0, requests=160, mutation_ratio=0.2,
                      seed=21), None, 4096),
    ("contained fault", dict(rate=400.0, requests=120, seed=22),
     "batch:1:oom", 4096),
    ("compaction", dict(rate=400.0, requests=160, mutation_ratio=0.5,
                        seed=23), None, 256),
)
SERVE_BATCHES = 8
FOF_SERVE_B = 14.938


class Recorder:
    """Keeps every response of a daemon (its ``submit``, ``poll`` and
    ``drain`` wrapped on the instance), the host seconds of each
    compaction's re-prepare and each re-warm, and those of each overlay
    insert and delete that did not compact (host numpy alone)."""

    def __init__(self, daemon):
        self.responses = {}
        self.compact_s, self.warm_s = [], []
        self.mutate_s = {"insert": [], "delete": []}
        for name in ("submit", "poll", "drain"):
            setattr(daemon, name, self._keep(getattr(daemon, name)))
        ov = daemon.overlay
        ov.compact = self._timed(ov.compact, self.compact_s)
        daemon.warmup = self._timed(daemon.warmup, self.warm_s)
        for name, into in self.mutate_s.items():
            setattr(ov, name, self._mutation(ov, getattr(ov, name), into))

    def _keep(self, fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            for r in out:
                self.responses[r.req_id] = r
            return out
        return wrapped

    @staticmethod
    def _mutation(ov, fn, into):
        def wrapped(*a, **kw):
            n0 = ov.stats.compactions
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if ov.stats.compactions == n0:
                into.append(time.perf_counter() - t0)
            return out
        return wrapped

    @staticmethod
    def _timed(fn, into):
        import torch

        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            into.append(time.perf_counter() - t0)
            return out
        return wrapped


def served_queries(spec, n0: int, responses) -> tuple:
    """(queries, ids, d2) of every answered query request of a session,
    stacked: the payloads regenerated from the seeded schedule
    (``run_session`` numbers request i of the schedule i + 1)."""
    from cuda_knearests_tpu_torch.serve import build_schedule

    qs, ids, d2 = [], [], []
    for i, item in enumerate(build_schedule(spec, n0), start=1):
        r = responses.get(i)
        if item["kind"] == "query" and r is not None and r.ok:
            qs.append(item["payload"])
            ids.append(r.ids)
            d2.append(r.d2)
    return np.concatenate(qs), np.concatenate(ids), np.concatenate(d2)


def check_served_exact(name: str, points: np.ndarray, queries, ids, tree,
                       k: int) -> None:
    dk, ik = tree.query(queries.astype(np.float64), k=k)
    check_rows_exact(points, ids, np.arange(queries.shape[0]), dk ** 2, ik,
                     queries=queries)
    print(f"  serve {name}: {queries.shape[0]} served query rows exact "
          f"against cKDTree", flush=True)


def timed_brute(log: list):
    """A stand-in for ``serve.delta.brute_force_by_coords`` that records
    (stored rows, query rows, ms to a synchronize) of each overlay call."""
    import torch

    from cuda_knearests_tpu_torch.serve import delta

    brute = delta.brute_force_by_coords

    def timed(points, queries, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = brute(points, queries, *a, **kw)
        torch.cuda.synchronize()
        log.append((int(points.shape[0]), int(queries.shape[0]),
                    (time.perf_counter() - t0) * 1e3))
        return out
    return brute, timed


def batch_kernel_ms(prob, queries: np.ndarray, buckets, reps: int) -> float:
    """The class kernel over one batch's query packs (mode (a), as
    ``query()`` launches it), by CUDA events."""
    import torch

    from cuda_knearests_tpu_torch.ops import adaptive

    cfg, m = prob.config, queries.shape[0]
    q_dev = torch.as_tensor(queries, device=DEV)
    packs = []
    for b in buckets:
        if b.route == "kernel":
            cp = prob.aplan.classes[b.cls]
            packs.append((cp, *adaptive.query_pack(q_dev, cp, b, m)))
    out = row_buffers(m, cfg.k)

    def run():
        for cp, pk, tgt in packs:
            adaptive.launch_kernel_class(cfg, cp.ccap, pk, tgt, cfg.k, False,
                                         out)
    return quiet(lambda: cuda_ms(run, reps))


def overlay_batches(name: str, daemon, seed: int, tree_of) -> dict:
    """``SERVE_BATCHES`` seeded batches of 256 uniform queries, and one
    whose first 16 queries sit next to deleted points (the tombstone
    probe), through the daemon's overlay with mutations pending, against a
    rebuild
    (``base.with_points(mutated_points()).query``): d2 bit for bit, ids
    equal except inside exact d2 ties (counted), both exact against a
    cKDTree of the mutated cloud.  Each batch split: host bucketing
    (``bucket_queries``, ``plan_queries``), the class kernel's device ms
    (CUDA events; the first batch also held to its plain version with its
    bound), the query pack's pad share, and the overlay's brute calls
    (tombstone resolution over the alive set, the delta merge).  The base
    problem's and the rebuild's queries run under ``quiet``: only the
    overlay's own launches count as serving."""
    from cuda_knearests_tpu_torch.io import generate_uniform
    from cuda_knearests_tpu_torch.ops import adaptive
    from cuda_knearests_tpu_torch.serve import delta

    ov, k = daemon.overlay, daemon.k_serve
    require(ov.n_deleted > 0 and ov.delta.shape[0] > 0,
            f"serve {name}: no tombstone or insert pending")
    prob = ov.base
    t0 = time.perf_counter()
    rebuild = prob.with_points(ov.mutated_points(), validate=False)
    rebuild_s = time.perf_counter() - t0
    pts = ov.mutated_points()
    tree = tree_of(pts)
    log = []
    brute, timed = timed_brute(log)
    rows, ties = [], 0
    delta.brute_force_by_coords = timed
    try:
        for i in range(SERVE_BATCHES + 1):
            q = generate_uniform(256, seed=seed + i)
            if i == SERVE_BATCHES:
                # the tombstone probe: 16 queries next to deleted points,
                # so the alive-set resolution runs and is timed
                gone = ov._base_orig[~ov.alive][:16]
                q[:gone.shape[0]] = np.clip(gone + np.float32(0.01), 0,
                                            1000)
            t0 = time.perf_counter()
            qcls, qrow = adaptive.bucket_queries(prob.grid, prob.config,
                                                 prob.aplan, q)
            t1 = time.perf_counter()
            buckets = adaptive.plan_queries(
                prob.config, prob.aplan, qcls, qrow, k,
                adaptive.hbm_budget_bytes(prob.device))
            t2 = time.perf_counter()
            t3 = time.perf_counter()
            quiet(lambda: prob.query(q, k))
            base_ms = (time.perf_counter() - t3) * 1e3
            n_log = len(log)
            t3 = time.perf_counter()
            got_i, got_d = ov.query(q, k)
            query_ms = (time.perf_counter() - t3) * 1e3
            brute_ms = [(n, rq, ms) for n, rq, ms in log[n_log:]]
            ref_i, ref_d = quiet(lambda: rebuild.query(q, k))
            require(np.array_equal(got_d, ref_d),
                    f"serve {name} batch {i}: overlay d2 differ from the "
                    f"rebuild's")
            differ = (got_i != ref_i).any(axis=1)
            ties += int(differ.sum())
            for r in np.nonzero(differ)[0]:
                for dv in np.unique(got_d[r][got_i[r] != ref_i[r]]):
                    at = got_d[r] == dv
                    require(at.sum() > 1 or dv == got_d[r][-1],
                            f"serve {name} batch {i} row {r}: ids differ "
                            f"outside an exact d2 tie")
            for what, ids in (("overlay", got_i), ("rebuild", ref_i)):
                check_served_exact(f"{name} batch {i} {what}", pts, q, ids,
                                   tree, k)
            kern = [b for b in buckets if b.route == "kernel"]
            slots = sum(b.n_sc * b.q2cap for b in kern)
            pads = 1.0 - sum(b.src.size for b in kern) / max(slots, 1)
            if i == 0:
                kstats = query_kernel(f"serve {name} batch 0", prob, q,
                                      buckets, 20)
                kernel_ms = kstats["ms"]
            else:
                kernel_ms = batch_kernel_ms(prob, q, buckets, 20)
            row = {"bucket_ms": (t1 - t0) * 1e3, "plan_ms": (t2 - t1) * 1e3,
                   "kernel_ms": kernel_ms, "pad_share": pads,
                   "q2cap": max((b.q2cap for b in kern), default=0),
                   "brute": brute_ms, "query_ms": query_ms,
                   "base_ms": base_ms}
            rows.append(row)
            print(f"  serve {name} batch {i}"
                  f"{' (tombstone probe)' if i == SERVE_BATCHES else ''}: "
                  f"256 queries, overlay query "
                  f"{query_ms:.3f} ms (the base problem's query alone "
                  f"{base_ms:.3f} ms); host bucket_queries "
                  f"{row['bucket_ms']:.3f} ms, plan_queries "
                  f"{row['plan_ms']:.3f} ms; class kernel {kernel_ms:.4f} ms "
                  f"(CUDA events), q2cap {row['q2cap']}, pads "
                  f"{pads:.1%} of the query pack; brute calls (stored rows, "
                  f"query rows, ms) {[(n, rq, round(ms, 3)) for n, rq, ms in brute_ms]}",
                  flush=True)
    finally:
        delta.brute_force_by_coords = brute
    alive_rows = delta._round_pow2(int(ov.alive.sum()), minimum=128)
    require(any(n == alive_rows for n, _, _ in rows[-1]["brute"]),
            f"serve {name}: the tombstone probe ran no alive-set "
            f"resolution")
    print(f"  serve {name}: {SERVE_BATCHES} + 1 batches of 256 with "
          f"{ov.n_deleted} tombstones and {ov.delta.shape[0]} inserts "
          f"pending: d2 bit for bit equal to the rebuild ({rebuild_s:.3f} s "
          f"to re-prepare), ids equal but in {ties} rows (exact d2 ties), "
          f"both exact against cKDTree", flush=True)
    return {"ties": ties, "rebuild_s": rebuild_s, "batches": rows,
            "kernel": kstats}


def serve_session(name: str, prob, points: np.ndarray, spec_kw: dict,
                  fault, threshold: int, tree, tree_of) -> tuple:
    """One open-loop session of ``SERVE_SESSIONS`` on a fresh daemon over
    the prepared 900k/k=10 problem: zero recompiles and the class kernel
    launched; no failed request but the injected batch's; checks by
    session (see the phase's docstring).  Returns (measurements,
    daemon)."""
    import torch

    from cuda_knearests_tpu_torch.obs import spans
    from cuda_knearests_tpu_torch.serve import (LoadSpec, ServeConfig,
                                                ServeDaemon, run_session)

    from cuda_knearests_tpu_torch.ops import cuda_solve as cs

    launches0 = cs.launches + cs.blocked_launches
    saved = os.environ.pop("KNTPU_SERVE_FAULT", None)
    if fault:
        os.environ["KNTPU_SERVE_FAULT"] = fault
    try:
        torch.cuda.reset_peak_memory_stats()
        daemon = ServeDaemon(prob, ServeConfig(
            max_batch=256, max_delay_s=0.004, compact_threshold=threshold))
    finally:
        os.environ.pop("KNTPU_SERVE_FAULT", None)
        if saved is not None:
            os.environ["KNTPU_SERVE_FAULT"] = saved
    rec = Recorder(daemon)
    spec = LoadSpec(**spec_kw)
    t0 = time.perf_counter()
    with spans.capture() as events:
        summary = run_session(daemon, spec)
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    require(summary["recompiles"] == 0 and summary["kernel_launches"] > 0
            and summary["kernel_route"] == "cuda",
            f"serve {name}: recompiles {summary['recompiles']}, kernel "
            f"launches {summary['kernel_launches']}, route "
            f"{summary['kernel_route']}")
    require(summary["responses"] == summary["requests"]
            and summary["refused"] == 0,
            f"serve {name}: {summary['responses']} responses to "
            f"{summary['requests']} requests, {summary['refused']} refused")
    if fault:
        failed = [r for r in rec.responses.values() if not r.ok]
        require(summary["failed_batches"] == 1
                and summary["failure_kinds"] == {"oom": 1}
                and summary["failed_requests"] == len(failed) > 0
                and all(r.failure_kind == "oom" for r in failed),
                f"serve {name}: {summary['failed_batches']} failed batches "
                f"{summary['failure_kinds']}, {summary['failed_requests']} "
                f"failed requests")
        probe = daemon.submit(req_id=-1, kind="query",
                              payload=np.full((4, 3), -5.0, np.float32))
        require(len(probe) == 1 and not probe[0].ok
                and probe[0].failure_kind == "invalid-input"
                and daemon.refused == 1 and daemon.failed_batches == 1,
                f"serve {name}: the malformed probe was not refused alone")
    else:
        require(summary["failed_requests"] == 0
                and summary["failed_batches"] == 0
                and summary["failed_mutations"] == 0,
                f"serve {name}: {summary['failed_requests']} failed "
                f"requests, kinds {summary['failure_kinds']}")
    out = {key: summary[key] for key in (
        "sustained_qps", "p50_ms", "p99_ms", "p999_ms", "occupancy_mean",
        "flushes", "latency_decomposition", "batches", "host_syncs",
        "kernel_launches", "recompiles", "failed_requests", "elapsed_s")}
    out.update({key: v for key, v in summary.items()
                if key.startswith("overlay_")})
    out.update(peak_bytes=peak, wall_s=wall_s,
               syncs_per_batch=summary["host_syncs"] / summary["batches"],
               compact_s=rec.compact_s, rewarm_s=rec.warm_s)
    print(f"  serve {name}: {json.dumps(out)}", flush=True)
    # the batches' device spans (the overlay query each batch ran): the
    # slowest, with what flushed them
    execs = {e["attrs"]["batch"]: e["attrs"] for e in events
             if e["name"] == "serve.execute"}
    dev = sorted(((e["dur_ms"], e["attrs"]["batch"]) for e in events
                  if e["name"] == "serve.device"), reverse=True)
    out["slowest_batches"] = [
        (round(ms, 3), b, execs[b]["reason"], execs[b]["rows"])
        for ms, b in dev[:5]]
    print(f"  serve {name}: slowest batches (overlay query ms, batch, "
          f"flush, rows) {out['slowest_batches']}; median "
          f"{dev[len(dev) // 2][0]:.3f} ms of {len(dev)}", flush=True)
    # the session's host time by piece: the batches' overlay queries (and
    # those over 20 ms, where a tombstone resolution ran), the inserts and
    # deletes that did not compact, and the admission's n_points (an
    # alive.sum() over the base cloud, read once per admitted request and
    # once per mutation's response), timed here over 50 reads
    t0 = time.perf_counter()
    for _ in range(50):
        daemon.overlay.n_points
    n_points_ms = (time.perf_counter() - t0) * 1e3 / 50
    slow = [ms for ms, _ in dev if ms > 20.0]
    split = {"elapsed_ms": summary["elapsed_s"] * 1e3,
             "batches_ms": sum(ms for ms, _ in dev),
             "slow_batches": len(slow), "slow_batches_ms": sum(slow),
             "n_points_ms": n_points_ms,
             "n_points_reads": summary["requests"]
             + sum(len(v) for v in rec.mutate_s.values())}
    for kind, secs in rec.mutate_s.items():
        split[f"{kind}s"] = len(secs)
        split[f"{kind}_ms_median"] = (float(np.median(secs)) * 1e3
                                      if secs else 0.0)
        split[f"{kind}_ms_total"] = sum(secs) * 1e3
    out["host_split"] = split
    print(f"  serve {name}: host split of the {split['elapsed_ms']:.3f} ms "
          f"window: overlay queries {split['batches_ms']:.3f} ms over "
          f"{len(dev)} batches ({len(slow)} over 20 ms: "
          f"{split['slow_batches_ms']:.3f} ms); {split['inserts']} inserts "
          f"{split['insert_ms_total']:.3f} ms (median "
          f"{split['insert_ms_median']:.4f}); {split['deletes']} deletes "
          f"{split['delete_ms_total']:.3f} ms (median "
          f"{split['delete_ms_median']:.4f}); n_points {n_points_ms:.4f} ms "
          f"a read x ~{split['n_points_reads']} reads", flush=True)
    if spec.mutation_ratio == 0:
        q, ids, _ = served_queries(spec, points.shape[0], rec.responses)
        check_served_exact(name, points, q, ids, tree, daemon.k_serve)
    else:
        require(name != "compaction" or summary["overlay_compactions"] >= 2,
                f"serve {name}: {summary['overlay_compactions']} "
                f"compactions, not >= 2")
        rng = np.random.default_rng(spec.seed + 100)
        extra = 0
        while daemon.overlay.n_deleted == 0 or \
                daemon.overlay.delta.shape[0] == 0:
            ins = (rng.random((4, 3)) * 980 + 10).astype(np.float32)
            dels = np.sort(rng.choice(daemon.overlay.n_points, 4,
                                      replace=False))
            extra += 1
            for kind, payload in (("insert", ins), ("delete", dels)):
                r = daemon.submit(req_id=-10 * extra, kind=kind,
                                  payload=payload)
                require(r[-1].ok, f"serve {name}: extra {kind} failed")
        out["extra_mutations"] = extra
        n0 = cs.launches + cs.blocked_launches
        out["overlay"] = overlay_batches(name, daemon, spec.seed + 200,
                                         tree_of)
        out["overlay_launches"] = cs.launches + cs.blocked_launches - n0
    out["launches"] = cs.launches + cs.blocked_launches - launches0
    return out, daemon


def profiled_session(daemon) -> dict:
    """One more steady session (400/s, 120 requests, seed 24) on a warmed
    daemon under torch.profiler: the device's busy and idle shares of the
    session's wall time, and its device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from cuda_knearests_tpu_torch.serve import LoadSpec, run_session

    batches0 = daemon.batches_executed
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        summary = run_session(daemon, LoadSpec(rate=400.0, requests=120,
                                               seed=24))
        wall_ms = (time.perf_counter() - t0) * 1e3
    batches = daemon.batches_executed - batches0
    require(summary["failed_requests"] == 0 and summary["recompiles"] == 0,
            f"serve profiled session: {summary['failed_requests']} failed, "
            f"{summary['recompiles']} recompiles")
    rows = []
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = getattr(e, "cuda_time_total", 0)
            rows.append((us / 1e3, e.count, e.key))
    busy = sum(r[0] for r in rows)
    print(f"  serve profiled steady session: {batches} batches, "
          f"{summary['completed_queries']} queries in {wall_ms:.3f} ms wall "
          f"under the profiler (p50 {summary['p50_ms']} ms, p99 "
          f"{summary['p99_ms']} ms); device busy {busy:.3f} ms = "
          f"{busy / wall_ms:.2%} of wall, idle {1 - busy / wall_ms:.2%}",
          flush=True)
    if not rows:
        print("    the profiler recorded no device time", flush=True)
    for ms, count, key in sorted(rows, reverse=True)[:6]:
        print(f"    {ms:9.4f} ms  x{count:<4d} {key[:80]}", flush=True)
    return {"wall_ms": wall_ms, "busy_ms": busy,
            "idle_share": 1 - busy / wall_ms, "batches": batches,
            "p50_ms": summary["p50_ms"], "p99_ms": summary["p99_ms"]}


def serve_fof_session(points: np.ndarray) -> dict:
    """A daemon over pts300K.xyz: two fof requests at the mean spacing
    with an 8-point insert between them, each equal to ``fof_labels`` of
    the mutated cloud on the card, and a repeat a memo hit."""
    from cuda_knearests_tpu_torch.cluster import fof_labels
    from cuda_knearests_tpu_torch.io import generate_uniform
    import cuda_knearests_tpu_torch as pt
    from cuda_knearests_tpu_torch.serve import ServeConfig, ServeDaemon

    prob = pt.KnnProblem.prepare(points, pt.KnnConfig(k=10))
    daemon = ServeDaemon(prob, ServeConfig(max_batch=256, max_delay_s=0.004))
    times = []
    out = daemon.submit(1, "query", generate_uniform(64, seed=310))
    for i, (kind, payload) in enumerate(
            (("fof", FOF_SERVE_B),
             ("insert", generate_uniform(8, seed=311)),
             ("fof", FOF_SERVE_B), ("fof", FOF_SERVE_B)), start=2):
        t0 = time.perf_counter()
        got = daemon.submit(i, kind, payload)
        times.append((kind, (time.perf_counter() - t0) * 1e3))
        require(all(r.ok for r in got), f"serve FoF: request {i} failed")
        out += got
        if kind == "fof":
            want = fof_labels(daemon.overlay.mutated_points(), FOF_SERVE_B)
            require(np.array_equal(got[-1].labels, want.labels)
                    and got[-1].n_clusters == want.n_clusters,
                    f"serve FoF: request {i}'s labels differ from "
                    f"fof_labels of the mutated cloud")
    require(daemon.fof_requests == 3 and daemon.fof_memo_hits == 1
            and out[-1].labels is out[-2].labels,
            f"serve FoF: {daemon.fof_memo_hits} memo hits")
    require(out[0].ok and out[0].ids.shape == (64, 10),
            "serve FoF: the query before the fof requests failed")
    print(f"  serve FoF, pts300K.xyz b={FOF_SERVE_B}: fof, insert 8, fof, "
          f"fof (memo hit) host ms {[(k, round(t, 3)) for k, t in times]}; "
          f"labels equal fof_labels of the mutated cloud, "
          f"{out[-1].n_clusters:,} clusters of {out[-1].n_points:,} points",
          flush=True)
    return {"ms": times, "n_clusters": out[-1].n_clusters}


def serve_phase(points: np.ndarray, prob) -> dict:
    """The serving daemon (``serve/``) on the 900k/k=10 problem: the four
    ``SERVE_SESSIONS``, each on a fresh daemon, with zero recompiles, the
    class kernel launched and no failed request but the injected oom
    batch (whose session also refuses a malformed probe alone); the
    steady and fault sessions' answers exact against cKDTree; the
    mutating and compaction sessions end with tombstones and inserts
    pending and hold the overlay to a rebuild (``overlay_batches``).  A
    fof request on the 900k daemon comes back as one typed oom failure
    and the next query is served; then the FoF session on pts300K.xyz.
    The class-kernel launches of the phase are counted from 0."""
    from scipy.spatial import cKDTree

    from cuda_knearests_tpu_torch.io import generate_uniform, get_dataset
    from cuda_knearests_tpu_torch.ops import cuda_solve as cs

    t0 = time.perf_counter()
    tree = cKDTree(points.astype(np.float64))

    def tree_of(pts):
        return cKDTree(pts.astype(np.float64))

    print(f"  serve: cKDTree of the 900k cloud in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    cs.launches = cs.blocked_launches = 0
    sessions, daemons = {}, {}
    for name, spec_kw, fault, threshold in SERVE_SESSIONS:
        sessions[name], daemons[name] = serve_session(
            name, prob, points, spec_kw, fault, threshold, tree, tree_of)
    daemon = daemons["steady"]
    del daemons
    parts = {name: s["launches"] for name, s in sessions.items()}
    n0 = cs.launches + cs.blocked_launches
    sessions["steady"]["profiled"] = profiled_session(daemon)
    parts["profiled"] = cs.launches + cs.blocked_launches - n0
    n0 = cs.launches + cs.blocked_launches
    refused = daemon.submit(1, "fof", 10.357)
    require(len(refused) == 1 and not refused[0].ok
            and refused[0].failure_kind == "oom"
            and "LaunchBudgetError" in refused[0].error,
            f"serve: the 900k fof request came back {refused}")
    q = generate_uniform(32, seed=320)
    nxt = daemon.submit(2, "query", q) + daemon.drain()
    require(len(nxt) == 1 and nxt[0].ok, "serve: no query served after the "
                                         "refused fof request")
    check_served_exact("after the fof refusal", points, q, nxt[0].ids, tree,
                       10)
    print(f"  serve: fof b=10.357 on the 900k daemon refused as one typed "
          f"{refused[0].failure_kind} failure; the next query served",
          flush=True)
    parts["900k fof refusal + next query"] = (cs.launches + cs.blocked_launches
                                             - n0)
    n0 = cs.launches + cs.blocked_launches
    fof = serve_fof_session(get_dataset("pts300K.xyz"))
    parts["pts300K fof daemon"] = cs.launches + cs.blocked_launches - n0
    require(cs.launches > 0, "serve: the phase launched no class kernel")
    require(sum(parts.values()) == cs.launches + cs.blocked_launches,
            f"serve: the launch split {parts} does not add up to "
            f"{cs.launches} + {cs.blocked_launches}")
    split = {name: (sessions[name]["kernel_launches"],
                    sessions[name].get("overlay_launches", 0))
             for name in sessions}
    print(f"  serve: {cs.launches} supercell_topk launches in the phase "
          f"({cs.blocked_launches} blocked): by part {parts}; per session "
          f"(in its measured window, in the overlay check batches) {split}; "
          f"the rest are the daemons' warmups; the check batches' "
          f"baseline and rebuild queries are not counted", flush=True)
    return {"sessions": sessions, "fof": fof, "launches": cs.launches,
            "blocked_launches": cs.blocked_launches, "launch_parts": parts}


_T0 = time.perf_counter()


def phase(name: str) -> None:
    print(f"phase: {name} [{time.perf_counter() - _T0:.1f} s]", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import cuda_knearests_tpu_torch as pt
    from cuda_knearests_tpu_torch.io import (generate_blue_noise,
                                             generate_clustered, get_dataset)
    from cuda_knearests_tpu_torch.mxu import kernel as mk
    from cuda_knearests_tpu_torch.ops import _build

    t_start = time.perf_counter()
    card = card_line()
    print(f"device: {card} ({torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda})", flush=True)
    t0 = time.perf_counter()
    _build.load_all(KERNELS)
    print(f"build: {', '.join(f'{n}.cu' for n in KERNELS)} in "
          f"{time.perf_counter() - t0:.1f} s (one nvcc each, in parallel)",
          flush=True)
    for name in KERNELS:
        for line in _build.BUILD_LOGS.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)

    phase("main-path problems")
    pts900 = generate_blue_noise(900_000, seed=900)
    pts300 = generate_blue_noise(300_000, seed=301)
    pts_cl = generate_clustered(300_000, seed=5)
    cfg10, cfg50 = pt.KnnConfig(k=10), pt.KnnConfig(k=50)
    cfg_cl = pt.KnnConfig(k=10, ring_radius=1)
    prob10, prep10 = prepared(pts900, cfg10)
    prob50, prep50 = prepared(pts300, cfg50)
    prob_cl, prep_cl = prepared(pts_cl, cfg_cl)

    phase("kernels against their plain versions on the card")
    max_err = {"supercell_topk": kernel_checks(
        [("300k/k=50", prob50, cfg50), ("300k clustered", prob_cl, cfg_cl)])}
    max_err["blocked_topk"] = blocked_checks(
        [("900k/k=10", prob10, cfg10), ("300k/k=50", prob50, cfg50),
         ("300k clustered", prob_cl, cfg_cl)])
    (max_err["mxu_select"], max_err["mxu_select_bf16"], *band_ratio,
     max_err["mxu_select_split"]) = select_checks()

    phase("grid main path")
    launches, _, _ = main_path("900k blue noise", pts900, cfg10, 3, prob10,
                               prep10)
    main_path("300k blue noise", pts300, cfg50, 3, prob50, prep50)
    main_path("300k clustered", pts_cl, cfg_cl, 2, prob_cl, prep_cl,
              expect_multi=True)
    del prob_cl

    phase("where one solve's device time goes")
    solve_breakdown("900k/k=10", prob10)
    solve_breakdown("300k/k=50", prob50)

    phase("brute route at full width")
    mk.launches = mk.launches_bf16 = mk.prep_launches = 0
    mk.prep_launches_f32 = 0
    select_launches, select_timings, err, ratio = path_a()
    require(mk.launches == select_launches["f32"] > 0
            and mk.launches_bf16 == select_launches["bf16"] > 0
            and mk.prep_launches == 2 * mk.launches_bf16
            and mk.prep_launches_f32 == 2 * mk.launches,
            f"brute route: selection launches miscounted ({mk.launches} "
            f"f32, {mk.launches_bf16} bf16, {mk.prep_launches_f32} f32 "
            f"prep, {mk.prep_launches} bf16 prep)")
    max_err["mxu_select"] = max(max_err["mxu_select"], err["f32"])
    max_err["mxu_select_bf16"] = max(max_err["mxu_select_bf16"],
                                     err["bf16"])
    band_ratio = tuple(map(max, band_ratio, ratio))
    print(f"  mxu_select_bf16: largest 2*delta_max over every check "
          f"{band_ratio[0]:.6e} of B, {band_ratio[1]:.6e} of its f32 term",
          flush=True)
    pts_k1800 = (np.random.default_rng(1800).random((20_000, 3))
                 * 1000).astype(np.float32)
    mk.split_launches = 0
    refused = brute_refused_run(pts_k1800, 1800)
    err_split, split_timings = split_timing(pts_k1800, 1800, refused["m"])
    max_err["mxu_select_split"] = max(max_err["mxu_select_split"], err_split)
    del pts_k1800

    phase("grid main path with the blocked kernel")
    prob_b, cfg_b, blocked_launches = path_b(pts900, prob10)
    require(blocked_launches > 0, "the blocked path launched no kernel")

    phase("grid main path at k=1000 (streamed route)")
    streamed_path(generate_blue_noise(100_000, seed=1000), 1000, 5)

    phase("external queries through the class kernels")
    query = query_phase(pts900, prob10, prob_b)
    require(query["launches"] > 0 and query["blocked_launches"] > 0,
            "the query path launched no class kernel")

    phase("friends-of-friends and the plane feed")
    pts_fof = get_dataset("pts300K.xyz")
    fof_runs = [fof_run(pts_fof, b, 5) for b in FOF_LENGTHS]
    del pts_fof
    fof_refusal(get_dataset("900k_blue_cube.xyz"), 10.357)
    planes = plane_feed_phase(pts900)

    phase("the serving daemon")
    serve = serve_phase(pts900, prob10)

    phase("timing at the main paths' class shapes")
    timing, err10 = class_timing("900k/k=10", prob10, cfg10)
    _, err50 = class_timing("300k/k=50", prob50, cfg50)
    blocked_timing, err_b = class_timing("900k/k=10 blocked", prob_b, cfg_b)
    blocked50, err_b50 = class_timing("300k/k=50 blocked", prob50,
                                      pt.KnnConfig(k=50, kernel="blocked"))
    blocked_crowded, err_bc = crowded_timing("900k/k=10 blocked", prob_b,
                                             cfg_b)

    kernels = [
        dict(name="supercell_topk", route="cuda",
             source=CSRC + "supercell_topk.cu",
             replaces=REPLACES["supercell_topk"], launches=launches,
             max_abs_err=max(max_err["supercell_topk"], err10, err50,
                             query["uniform"]["kernel"]["max_abs_err"],
                             query["clustered"]["kernel"]["max_abs_err"]),
             **timing, query_launches=query["launches"],
             query_ms=query["uniform"]["kernel"]["ms"],
             query_q2cap=query["uniform"]["kernel"]["q2cap"],
             query_bound_ms=query["uniform"]["kernel"]["bound_ms"],
             query_bound_by=query["uniform"]["kernel"]["bound_by"],
             query_ms_clustered=query["clustered"]["kernel"]["ms"],
             query_q2cap_clustered=query["clustered"]["kernel"]["q2cap"],
             query_pads_ms_clustered=query["clustered"]["kernel"]["pads_ms"],
             query_bound_ms_clustered=query["clustered"]["kernel"][
                 "bound_ms"],
             query_bound_by_clustered=query["clustered"]["kernel"][
                 "bound_by"],
             plane_feed_launches=planes["solve_launches"],
             plane_query_launches=planes["query_launches"],
             serve_launches=serve["launches"]),
        dict(name="blocked_topk", route="cuda",
             source=CSRC + "blocked_topk.cu",
             replaces=REPLACES["blocked_topk"], launches=blocked_launches,
             max_abs_err=max(max_err["blocked_topk"], err_b, err_b50,
                             err_bc, query["blocked"]["kernel"]["max_abs_err"]),
             **blocked_timing, ms_300k_k50=blocked50["ms"],
             bound_ms_300k_k50=blocked50["bound_ms"],
             ms_crowded=blocked_crowded["ms"],
             per_block_rows_crowded=blocked_crowded["per_block_rows"],
             query_launches=query["blocked_launches"],
             query_ms=query["blocked"]["kernel"]["ms"],
             query_bound_ms=query["blocked"]["kernel"]["bound_ms"]),
        dict(name="mxu_select", route="cuda", source=CSRC + "mxu_select.cu",
             replaces=REPLACES["mxu_select"],
             launches=select_launches["f32"],
             max_abs_err=max_err["mxu_select"], shape="100k x 128 f32",
             **select_timings["100k x 128 f32"]),
        dict(name="mxu_select_bf16", route="cuda",
             source=CSRC + "mxu_select_bf16.cu",
             replaces=REPLACES["mxu_select_bf16"],
             launches=select_launches["bf16"],
             max_abs_err=max_err["mxu_select_bf16"],
             max_band_ratio=band_ratio[0],
             max_band_ratio_f32=band_ratio[1], shape="100k x 128 bf16",
             **select_timings["100k x 128 bf16"]),
        dict(name="mxu_select_split", route="cuda",
             source=CSRC + "mxu_select_split.cu",
             replaces=REPLACES["mxu_select_split"],
             launches=refused["launches"],
             max_abs_err=max_err["mxu_select_split"],
             shape="20k x 3 f32 k=1800", **split_timings),
    ]
    print(f"  FoF (plain torch, no kernel of its own): "
          f"{json.dumps(fof_runs)}", flush=True)
    print(f"  plane feed: {json.dumps(planes)}", flush=True)
    print(f"  serving: {json.dumps(serve)}", flush=True)
    print(f"smoke: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
