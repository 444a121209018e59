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
  4a. runs the legacy single-schedule route and the gather epilogue on the
     900k/k=10 cloud: ``adaptive=False`` under scatter and gather, the
     adaptive route and ``kernel='blocked'`` under gather (1 + 3 solves
     each), ``backend='xla'`` (one solve), 1M uniform queries through the
     legacy pipeline (``ops.query.query_knn``) one shot and at
     query_chunk=262,144 (byte for byte equal, one launch a chunk, at most
     two host round trips) and ``backend='oracle'`` (the engine that
     answered printed); every exact route's ids equal the adaptive scatter
     solve's (the kd-tree's within the tie band); the class kernels' mode
     (b) on the legacy pack held to its plain version and timed with the
     gather epilogue; and at a budget of 0.5 x the card's free memory the
     clustered cloud's legacy pack refused in ``prepare`` before it is
     allocated;
  4b. runs the grid route's MXU tier (``KnnConfig(scorer='mxu')``,
     ``mxu.scorer.grid_class_topk``, plain torch): (a) 300k blue noise at
     k=50, f32, recall_target=1.0, 1 cold + 2 warm solves, ids and d2
     equal to the elementwise solve and exact against cKDTree on 20,000
     sampled rows, one class step's peak allocation within its model,
     one pass of the tier broken down by kernel under torch.profiler;
     (b) the same at bf16 and 0.9, one solve, exact; (c) the clustered
     300k cloud at k=10 (per-supercell radii), recall_target=0.6,
     fallback='none': a fold below min(k, 128), recall on 20,000 sampled
     rows at the declared 2B band (``mxu/measure.py``) at least the
     classes' bound, certified sampled rows exact, every row the fold
     left open with (-1, inf) at column k-1; (d) slices of the 'mxu'
     classes of (a) and (c), card = CPU bit for bit.  Each solve makes
     at most two host round trips and prints the per-class route and
     fold, the certified fraction, the fallback rows and ms and the
     tier's ms by CUDA events;
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
 10b. runs the multi-GPU z-slab solve (``parallel.ShardedKnnProblem``) on
     the reference bench's ``sharded_10m_k10`` cloud
     (``generate_uniform(10_000_000, seed=10)``, k=10): (a) 4 slabs on
     cuda:0 (and, with two or more cards, one slab per card): prepare split
     into validation, halo depth, host partition, per-slab build and
     exchange (to the counts readback) and planning, the ``ShardMeta``,
     per slab its points, classes, resident bytes, kernel ms by CUDA
     events (slab 1's held bit for bit to the plain version) and its
     whole slab solve; 1 + 3 solves split into the slabs' solves, the
     batched fetch, host placement and the kd-tree fallback, each at most
     two host round trips and one class-kernel launch per kernel class of
     every slab; peak allocation against the single-device problem's;
     (b) the rows equal a single-device ``KnnProblem`` solve of the same
     cloud on the card bit for bit on every row both certify, and 20,000
     sampled rows exact against cKDTree; (c) 1M ``generate_uniform(seed=
     901)`` queries equal to the single-device ``query`` bit for bit and
     exact on sampled rows; (d) on 200k points at 4 slabs the card's
     slab rows equal the CPU run's bit for bit under 'scatter' and
     'gather'; (e) 2 processes x 2 slabs on 1M points
     (``python -m cuda_knearests_tpu_torch.parallel``; gloo, both on
     cuda:0, on a one-card host; NCCL, a card each, on two), each slab's
     rows equal the single-process 4-slab run's bit for bit, the backend
     printed;
 10c. runs the pod (``pod.PodKnnProblem``) on 10b's 10M cloud over four
     chips: the plan against the JAX package's integers, solves and their
     exchange bytes, each chip's memory against its model, rows against
     the single-device solve and cKDTree, the 1M queries, card = CPU, the
     MXU tier and the budget cases;
 10d. mutates that pod (``pod.PodOverlay``): 100,000 deletes in 10
     batches, each timed into its restage and halo re-exchange with 0
     host round trips, at most 8 stages and 83,819,520 ici bytes per
     re-exchange; an all-points solve (deleted rows invalid, no live row
     holding a deleted id, 20,000 sampled rows exact against cKDTree over
     the mutated cloud); 512 hotspot inserts, the 1M queries (every row
     exact) and one more all-points solve split into the pod solve, the
     filter, the pruning bound, the brute call and the merge; then the
     elastic index (``pod.ElasticIndex``, 1M points, k=10, two shards):
     200,000 hotspot inserts, ``force_rebalance`` and pumps to the
     handover, a 64-row batch between pumps equal to the rebuild oracle
     byte for byte, 0 kernel builds or loads outside its attributed work;
 10e. runs the fuzz campaigns (``cuda_knearests_tpu_torch.fuzz``) on the
     card: (a) the point campaign in-process, 48 zoo cases (all 12
     generators 4 times over) through the four routes, each exact against
     the kd-tree, then every case through the four routes and
     ``kernel='blocked'``, ``epilogue='gather'`` and both, card rows equal
     to the CPU run's bit for bit; (b) 6 cases under ``isolation='case'``
     (one supervisor worker each, timed) and an abort drill: a SIGKILLed
     worker's case banked as 'crash' with its flight-recorder tail, the
     next case answered; (c) the approx (12 cases, f32 and bf16, plus
     k=1,800 on quantized and coincident clouds: the split selection's
     two arms), FoF (8), mutation (4 streams) and pod (8 cases, 4 chips on
     the card) campaigns, all clean, every selection kernel launched; (d)
     ``KNTPU_FUZZ_FAULT=drop-neighbor`` and ``KNTPU_MXU_FAULT=drop-block``
     each detected, minimized and banked in a scratch directory (no
     selection launch under the fault); (e) ``tests/corpus`` and
     ``tests/corpus_torch`` replayed clean; each kernel's launches in the
     phase printed;
 10f. runs the serving fleet (``serve.fleet``) on the card: (a) the
     reference's ``fleet_4tenant_mix`` fleet at full width
     (``default_fleet_builds(4, base_n=1_000_000, k=10, seed=11)``: dense
     tenants of 1,000,000, 1,000,000 and 1,002,048 points on the legacy
     route, a replica each, and the 48-point host sidecar tenant), the
     throughput tenant flooding at 900/s: every answered row exact against
     cKDTree, 0 failed, 0 recompiles, a Jain index, per-tenant
     percentiles, round trips and bytes, the class kernel's launches
     (mode (a): legacy queries scatter) counted from 0 over the session; (b) a session with 20% mutations, then each dense
     tenant's probe rows equal to a rebuild of its mutated cloud byte for
     byte, before and after an in-process failover; (c) the process-level
     ``failover_drill`` at 1,000,000 points with both children on the
     card; (d) the reference's ``diurnal_autoscale`` row at base n =
     1,000,000: every actuator family, a brownout episode through the
     bf16 selection kernel (its batches timed), recovery to
     byte-identical answers, 0 lost committed mutations; (e) the
     ``--pod-tenant`` recipe on a 1,000,000-point pod tenant: a live
     migration under queries, every row exact; (f) a small fleet on the
     card and on the CPU under one fake clock, every response equal bit
     for bit, a bf16 brownout episode included; the phase's seconds and
     each kernel's launches printed;
 10g. runs mesh failover and the fleet and chaos campaigns on the card:
     (a) ``serve.fleet.elastic.mesh_failover_drill`` at 1,000,000 points,
     k=10, with the primary and the standby mesh both child processes on
     the card: a forced live rebalance, a snapshot under the migration, a
     SIGKILL mid-migration, the standby restored and the log tail
     replayed, zero lost committed mutations and answers byte-identical
     to the parent's per-shard rebuild; the snapshot's seconds and bytes,
     the restore and replay seconds, the probe latencies and free card
     memory before and after printed; (b) the chaos campaign
     (``fuzz.chaos``, 8 schedules at the reference's case sizes, and the
     4 named autoscale schedules, whose brownouts run the bf16
     selection), clean, its protocol trace a word of the declared models,
     the class kernel and the bf16 selection launched; (c) the fleet
     campaign (``fuzz.fleet``, 8 streams), clean; (d)
     ``KNTPU_FLEET_FAULT`` torn-migration, lost-range, scale-drop-tail
     (chaos) and cross-tenant (fleet) each caught and banked into a
     temporary directory, never into ``tests/corpus_torch``; (e) 3 chaos
     schedules and 3 fleet streams on the card and on the CPU, every
     checked answer equal bit for bit; the phase's seconds and each
     kernel's launches printed;
 10h. (run after 11, whose CUDA-event time of ``supercell_topk`` it reads)
     the CLI and device observability on the card: (d) the 900k/k=10 job
     through ``python -m cuda_knearests_tpu_torch.cli ... --no-oracle
     --capture`` in a process of its own (torch.profiler drops a growing
     share of device events in sessions long after a process's first):
     rc 0, every device event attributed and joined to its launch by
     correlation id, ``supercell_topk`` once per class, its captured ms
     within 10% of the CUDA-event time, the memory growth within the model
     from the allocator, and ``utils.roofline.roofline_fields`` of the
     timed solve, of a warm solve here and of the kernel alone against the
     card's own peaks entry, each share at most 105%, printed beside the
     static-shape and real-pair bounds; meanwhile (a) ``cli.main`` on
     ``data/900k_blue_cube.xyz`` (regenerated from its seed where the file
     is absent) at k=10 in this process: rc 0, 0 hard mismatches against
     the kd-tree, ``supercell_topk`` once per class per solve, the card as
     its platform, and (b) a NaN file refused rc 5; then three processes
     at once: the CLI with ``CUDA_VISIBLE_DEVICES=""`` and no ``--device``
     (rc 4, ``no-device``), ``python -m cuda_knearests_tpu_torch.obs``
     (rc 0: zero unattributed, a ``supercell_topk`` event, the verdict
     from the allocator, the merged trace written) and ``python -m
     cuda_knearests_tpu_torch.runtime.dispatch`` (rc 0: six routes, each
     within two host round trips, the sharded ones on cuda:0 twice);
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

import dataclasses
import json
import os
import re
import shutil
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

    saved = (cs.launches, cs.blocked_launches, cs.launches_b,
             cs.blocked_launches_b, mk.launches, mk.launches_bf16,
             mk.split_launches, mk.prep_launches, mk.prep_launches_f32)
    try:
        return fn()
    finally:
        (cs.launches, cs.blocked_launches, cs.launches_b,
         cs.blocked_launches_b, mk.launches, mk.launches_bf16,
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


# -- phase 3/4: the grid main path --------------------------------------------

def tree_reference(points: np.ndarray, rows: np.ndarray, k: int, tree):
    """Exact squared distances (f64) and ids of the k nearest other points
    of the sampled rows, from the kd-tree."""
    q = points[rows].astype(np.float64)
    _, ik = tree.query(q, k=k + 1)
    is_self = ik == rows[:, None]
    keep = ~is_self
    keep[~is_self.any(axis=1), -1] = False
    ik = ik[keep].reshape(-1, k)
    # the tree's distances squared can fall an ulp short of the exact f64
    # squared distance, and an f32-tie test against that k-th then fails
    # an exact pick: recompute them from the coordinates
    dk = ((points[ik].astype(np.float64) - q[:, None, :]) ** 2).sum(-1)
    order = np.argsort(dk, axis=1, kind="stable")
    return (np.take_along_axis(dk, order, axis=1),
            np.take_along_axis(ik, order, axis=1))


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


# -- phase 9: timing at the main path's class shape ---------------------------

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


# -- phase 4a: the legacy route and the gather epilogue -----------------------

LEGACY_QUERY_CHUNK = 262_144


def legacy_solves(name: str, prob, runs: int, want: np.ndarray) -> dict:
    """Solve a prepared problem 1 + ``runs`` times with every class-kernel
    count set to 0 just before and read just after; each solve in at most
    two host round trips, its ids after the fallback equal to ``want``
    (the adaptive scatter solve's).  Returns the counts and times."""
    from cuda_knearests_tpu_torch.ops import cuda_solve as cs
    from cuda_knearests_tpu_torch.runtime import dispatch

    counters = ("launches", "launches_b", "blocked_launches",
                "blocked_launches_b")
    for c in counters:
        setattr(cs, c, 0)
    times, syncs = [], 0
    for i in range(1 + runs):
        dispatch.reset_stats()
        t0 = time.perf_counter()
        res = prob.solve()
        dt = time.perf_counter() - t0
        syncs = max(syncs, dispatch.stats().host_syncs)
        if i or not runs:
            times.append(dt)
    counts = {c: getattr(cs, c) for c in counters}
    require(syncs <= dispatch.SYNC_BUDGET,
            f"{name}: a solve made {syncs} host round trips")
    require(bool(np.asarray(res.certified).all()),
            f"{name}: rows left uncertified after the fallback")
    got = prob.get_knearests_original()
    differ = int((got != want).any(axis=1).sum())
    require(differ == 0, f"{name}: {differ} rows' ids differ from the "
                         f"adaptive scatter solve's")
    med = float(np.median(times))
    n = prob.grid.n_points
    print(f"  {name}: route {prob._route_name()}"
          f"{'/' + prob.backend if prob.backend else ''}; solve median of "
          f"{runs} {med * 1e3:.3f} ms = {n / med:,.0f} queries/s (runs ms "
          f"{[round(t * 1e3, 3) for t in times]}); fallback rows "
          f"{int(res.uncert_count)}; launches {counts}; host round trips "
          f"{syncs}; ids equal to the adaptive scatter solve's", flush=True)
    return {"median_ms": med * 1e3, "runs_ms": [t * 1e3 for t in times],
            "fallback_rows": int(res.uncert_count), **counts}


def mode_b_timing(name: str, pack, k: int, m: int = 0) -> dict:
    """The class kernel's mode (b) over a legacy pack (``m`` > 0: the
    blocked kernel) against its plain version and a cdist + topk
    yardstick, with the bound (inputs once and the raw (S, k, qcap)
    output once over the HBM rate, 8 f32 operations a real pair over the
    f32 rate), and the gather epilogue's time on the kernel's output;
    outputs equal to the plain version's."""
    import torch

    from cuda_knearests_tpu_torch.ops import cuda_solve as cs

    args = pack.pk.args()
    if m:
        def run(plain=False):
            fn = cs.blocked_topk_plain if plain else cs.blocked_topk
            return fn(*args, k, m, True)
    else:
        def run(plain=False):
            fn = cs.supercell_topk_plain if plain else cs.supercell_topk
            return fn(*args, k, True)
    out = []

    def kernel():
        out[:] = [run()]

    def gather():
        out[1:] = [cs.gather_rows(out[0], pack.inv_flat, pack.inv_sc,
                                  pack.qcap, k)]

    ms = quiet(lambda: cuda_ms(kernel, 20))
    plain_out = run(plain=True)
    plain_ms = cuda_ms(lambda: run(plain=True), 3)
    err = require_equal(f"{name} mode (b) (timed)", out[0], plain_out)
    gather_ms = cuda_ms(gather, 20)
    require_equal(f"{name} gathered rows", out[1], cs.gather_rows(
        plain_out, pack.inv_flat, pack.inv_sc, pack.qcap, k))
    q = torch.stack([pack.pk.qx, pack.pk.qy, pack.pk.qz], dim=-1)
    c = torch.stack([pack.pk.cx, pack.pk.cy, pack.pk.cz], dim=-1)
    step = max(1, (1 << 26) // (pack.qcap * pack.ccap))

    def library():
        for s0 in range(0, q.shape[0], step):
            d = torch.cdist(q[s0:s0 + step], c[s0:s0 + step])
            torch.topk(d, k, dim=-1, largest=False)

    library_ms = cuda_ms(library, 3)
    in_bytes = sum(a.numel() * a.element_size() for a in args)
    out_bytes = pack.s_total * k * pack.qcap * 8
    pairs = int(((pack.pk.qid >= 0).sum(1).long()
                 * (pack.pk.cid >= 0).sum(1).long()).sum())
    t_bytes = (in_bytes + out_bytes) / PEAK_HBM_BYTES * 1e3
    t_ops = 8 * pairs / PEAK_F32_FLOPS * 1e3
    g_bytes = (pack.inv_flat.numel() * 8 + 2 * pack.inv_flat.numel() * k * 8)
    print(f"  {name} mode (b): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"cdist+topk {library_ms:.4f} ms; bytes {in_bytes + out_bytes} -> "
          f"{t_bytes:.4f} ms; pairs {pairs} -> {t_ops:.4f} ms at 67 TFLOP/s; "
          f"gather epilogue {gather_ms:.4f} ms ({g_bytes} bytes read and "
          f"written -> {g_bytes / PEAK_HBM_BYTES * 1e3:.4f} ms); outputs "
          f"equal the plain version's", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "gather_ms": gather_ms,
            "gather_bound_ms": g_bytes / PEAK_HBM_BYTES * 1e3}, err


def legacy_queries(prob, chunked, queries: np.ndarray, want) -> dict:
    """1M queries through the legacy pipeline (``ops.query.query_knn``),
    one shot on ``prob`` and in chunks on ``chunked``: byte for byte equal,
    ids equal to the adaptive route's (``want``), each call one kernel
    launch a chunk and at most two host round trips."""
    from cuda_knearests_tpu_torch.ops import cuda_solve as cs
    from cuda_knearests_tpu_torch.ops import query as pq
    from cuda_knearests_tpu_torch.runtime import dispatch

    m = queries.shape[0]
    out, facts = {}, {}
    for name, p in (("one shot", prob), ("chunked", chunked)):
        chunks = -(-m // (p.config.resolved_query_chunk() or m))
        times = []
        cs.launches = cs.launches_b = 0
        brute = pq.route_queries["brute"]
        for i in range(2):
            dispatch.reset_stats()
            t0 = time.perf_counter()
            out[name] = p.query(queries)
            times.append(time.perf_counter() - t0)
            syncs = dispatch.stats().host_syncs
            require(syncs <= dispatch.SYNC_BUDGET,
                    f"legacy queries ({name}): {syncs} host round trips")
        require(cs.launches == 2 * chunks and pq.route_queries["brute"]
                == brute, f"legacy queries ({name}): {cs.launches} kernel "
                f"launches for 2 calls of {chunks} chunks, or a brute route")
        facts[name] = {"ms": times[-1] * 1e3, "queries_per_s":
                       m / times[-1], "launches": cs.launches,
                       "launches_b": cs.launches_b, "chunks": chunks,
                       "syncs": syncs}
    for a, b in zip(out["chunked"], out["one shot"]):
        require(a.dtype == b.dtype and np.array_equal(a, b),
                "legacy queries: the chunked rows differ from the one shot")
    differ = int((out["one shot"][0] != want).any(axis=1).sum())
    require(differ == 0, f"legacy queries: {differ} rows' ids differ from "
                         f"the adaptive route's")
    print(f"  legacy queries, m={m}: {json.dumps(facts)}; chunked rows byte "
          f"for byte the one shot's; ids equal to the adaptive route's",
          flush=True)
    return facts


def oracle_run(points: np.ndarray, want: np.ndarray, k: int) -> dict:
    """backend='oracle' on the cloud: the C++ kd-tree of ``oracle/``
    (built here from its sources; a build or load failure fails the
    phase), its build and solve seconds, every row certified with no
    device round trip, and its ids against the adaptive solve's (equal,
    or where they differ, the same distances tie-aware: the kd-tree rounds
    its own sums)."""
    import cuda_knearests_tpu_torch as pt
    from cuda_knearests_tpu_torch import oracle
    from cuda_knearests_tpu_torch.runtime import dispatch

    t0 = time.perf_counter()
    native = oracle.native_available()
    lib_s = time.perf_counter() - t0
    require(native, "oracle: the kd-tree library of oracle/ did not build "
                    "or load (the numpy engine would answer instead)")
    t0 = time.perf_counter()
    prob = pt.KnnProblem.prepare(points, pt.KnnConfig(k=k, backend="oracle"),
                                 device=DEV)
    build_s = time.perf_counter() - t0
    dispatch.reset_stats()
    t0 = time.perf_counter()
    res = prob.solve()
    solve_s = time.perf_counter() - t0
    require(dispatch.stats().host_syncs == 0 and res.certified.all(),
            "oracle: a device round trip, or an uncertified row")
    got = prob.get_knearests_original()
    rows = np.nonzero((got != want).any(axis=1))[0]
    if rows.size:
        pts64 = points.astype(np.float64)
        d_got = ((pts64[got[rows]] - pts64[rows, None]) ** 2).sum(-1)
        d_want = ((pts64[want[rows]] - pts64[rows, None]) ** 2).sum(-1)
        require(bool(np.allclose(np.sort(d_got, 1), np.sort(d_want, 1),
                                 rtol=RTOL, atol=ATOL)),
                "oracle: rows whose distances differ from the grid's")
    print(f"  oracle: engine C++ kd-tree (oracle.native_available() = "
          f"{native}; library built and loaded in {lib_s:.3f} s, "
          f"build {oracle.build_kind!r}); n={points.shape[0]}; "
          f"tree build {build_s:.3f} s, solve {solve_s:.3f} s = "
          f"{points.shape[0] / solve_s:,.0f} queries/s; every row certified, "
          f"0 device round trips; {rows.size} rows' ids differ from the "
          f"adaptive solve's, all within the tie band", flush=True)
    return {"native": native, "lib": oracle.build_kind,
            "n": int(points.shape[0]), "lib_s": lib_s, "build_s": build_s,
            "solve_s": solve_s, "rows_differing": int(rows.size)}


def budget_refusal(points: np.ndarray, k_choices=(10, 50, 100, 200)) -> dict:
    """The memory budget at 0.5 x the card's free memory on a skewed cloud
    under ``adaptive=False``: one global ccap makes every supercell as
    wide as the densest.  Prints the plan's (qcap, ccap) and modeled
    bytes at each k, and requires the smallest k whose legacy pack (gather
    epilogue) exceeds the budget to be refused in prepare under
    backend='auto' (no scan stands in for the kernel), with the
    card's peak allocation during the refused prepare far below the
    pack."""
    import torch

    import cuda_knearests_tpu_torch as pt
    from cuda_knearests_tpu_torch.ops import cuda_solve as cs
    from cuda_knearests_tpu_torch.ops import gridhash, solve as ps
    from cuda_knearests_tpu_torch.utils.memory import LaunchBudgetError

    free, _ = torch.cuda.mem_get_info()
    budget = int(0.5 * free)
    grid = gridhash.build_grid(torch.as_tensor(points, device=DEV))
    rows = []
    for k in k_choices:
        cfg = pt.KnnConfig(k=k, ring_radius=1, adaptive=False,
                           epilogue="gather", hbm_budget_bytes=budget)
        plan = ps.build_plan(grid, cfg)
        need = cs.legacy_pack_bytes(grid.n_points, plan.n_chunks * plan.batch,
                                    plan.qcap, plan.ccap, k, "gather")
        rows.append((k, plan.qcap, plan.ccap, need))
        if need > budget:
            break
    del grid, plan
    k, qcap, ccap, need = rows[-1]
    require(need > budget, f"budget: no k in {k_choices} exceeds "
                           f"{budget} bytes")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        pt.KnnProblem.prepare(points, pt.KnnConfig(
            k=k, ring_radius=1, adaptive=False, epilogue="gather",
            hbm_budget_bytes=budget), device=DEV)
        refused = None
    except LaunchBudgetError as e:
        refused = (e.requested, e.budget, e.site)
    peak = torch.cuda.max_memory_allocated() - base
    require(refused is not None and refused[0] == need,
            f"budget: the legacy pack of {need} bytes at k={k} was not "
            f"refused at a {budget}-byte budget ({refused})")
    require(peak < need // 10, f"budget: the refused prepare allocated "
                               f"{peak} bytes on the card")
    print(f"  budget 0.5 x free = {budget} bytes: legacy (k, qcap, ccap, "
          f"modeled bytes) {rows}; k={k} refused in {refused[2]} "
          f"(requested {refused[0]}), peak allocation during the refused "
          f"prepare {peak} bytes", flush=True)
    return {"budget": budget, "plans": rows, "refused_k": k,
            "requested": refused[0], "peak_bytes": peak}


def legacy_phase(pts900: np.ndarray, prob10, pts_cl: np.ndarray) -> dict:
    """The legacy single-schedule route and the gather epilogue on the
    900k blue cube (k=10), every exact route's ids equal to the adaptive
    scatter solve's: adaptive=False under scatter and gather (1 + 3
    solves each), adaptive=True and kernel='blocked' under gather (1 + 3),
    backend='xla' (one solve); 1M uniform queries through the legacy
    pipeline one shot and at query_chunk=262,144; backend='oracle'; the
    mode (b) kernels and the gather epilogue timed on the legacy pack;
    and the budget's refusal on the clustered cloud."""
    import torch

    import cuda_knearests_tpu_torch as pt
    from cuda_knearests_tpu_torch.config import blocked_topm
    from cuda_knearests_tpu_torch.io import generate_uniform
    from cuda_knearests_tpu_torch.ops import cuda_solve as cs

    want = prob10.get_knearests_original()
    k = 10
    out = {}
    for name, kw, runs in (
            ("legacy scatter", dict(adaptive=False), 3),
            ("legacy gather", dict(adaptive=False, epilogue="gather"), 3),
            ("adaptive gather", dict(epilogue="gather"), 3),
            ("adaptive blocked gather", dict(kernel="blocked",
                                             epilogue="gather"), 3),
            ("legacy xla", dict(adaptive=False, backend="xla"), 0)):
        prob, prep_s = prepared(pts900, pt.KnnConfig(k=k, **kw))
        if prob.plan is not None:
            plan = prob.plan
            s_total = plan.n_chunks * plan.batch
            need = cs.legacy_pack_bytes(prob.grid.n_points, s_total,
                                        plan.qcap, plan.ccap, k,
                                        prob.config.resolved_epilogue())
            lanes = None if prob.pack is None else prob.pack.qcap
            print(f"  {name}: plan (qcap, ccap, supercells, chunks x batch) "
                  f"({plan.qcap}, {plan.ccap}, {s_total}, {plan.n_chunks} x "
                  f"{plan.batch}); pack {lanes} lanes, modeled bytes {need}; "
                  f"prepare {prep_s:.3f} s", flush=True)
        out[name] = legacy_solves(name, prob, runs, want)
        if name == "legacy gather":
            legacy = prob
        del prob
    require(out["legacy gather"]["launches_b"] == 4
            and out["adaptive gather"]["launches_b"] == 4
            * len(prob10.aplan.classes)
            and out["adaptive blocked gather"]["blocked_launches_b"] > 0
            and out["legacy scatter"]["launches"] == 4
            and out["legacy scatter"]["launches_b"] == 0
            and out["legacy xla"]["launches"] == 0,
            f"legacy phase: launches miscounted {out}")
    timing, err = mode_b_timing("900k/k=10 legacy pack", legacy.pack, k)
    m = blocked_topm(k, legacy.pack.ccap)
    blocked, err_b = mode_b_timing(f"900k/k=10 legacy pack blocked m={m}",
                                   legacy.pack, k, m)
    queries = generate_uniform(1_000_000, seed=901)
    q_want = prob10.query(queries)[0]
    chunked = pt.KnnProblem.prepare(pts900, pt.KnnConfig(
        k=k, adaptive=False, epilogue="gather",
        query_chunk=LEGACY_QUERY_CHUNK), device=DEV)
    out["queries"] = legacy_queries(legacy, chunked, queries, q_want)
    del legacy, chunked, queries
    torch.cuda.empty_cache()
    out["oracle"] = oracle_run(pts900, want, k)
    out["budget"] = budget_refusal(pts_cl)
    out["mode_b"], out["mode_b_blocked"] = timing, blocked
    out["launches_b"] = (out["legacy gather"]["launches_b"]
                         + out["adaptive gather"]["launches_b"]
                         + out["queries"]["one shot"]["launches_b"]
                         + out["queries"]["chunked"]["launches_b"])
    out["blocked_launches_b"] = out["adaptive blocked gather"][
        "blocked_launches_b"]
    out["max_abs_err"], out["max_abs_err_blocked"] = err, err_b
    return out


# -- phase 4b: the grid route's MXU tier --------------------------------------

# (query slot, candidate slot) pairs of the class slices run on both
# devices in phase 4b's card-equals-CPU check.
MXU_SLICE_PAIRS = 1 << 25


def mxu_class_lines(prob, cfg) -> float:
    """Print each class's route and fold (m, g = ccap / 128, qcap, ccap);
    returns the smallest recall bound of the 'mxu' classes."""
    from cuda_knearests_tpu_torch.mxu.topk import (BLOCK, per_block_m,
                                                   recall_bound)

    bound = 1.0
    for i, cp in enumerate(prob.aplan.classes):
        g = cp.ccap // BLOCK
        m = None
        if cp.route == "mxu":
            m = per_block_m(cfg.recall_target, cfg.k, g)
            bound = min(bound, recall_bound(cfg.k, g, m))
        print(f"    class {i}: route {cp.route}, m {m}, g {g}, qcap "
              f"{cp.qcap}, ccap {cp.ccap}, supercells {cp.n_sc}, rows a "
              f"step {cp.step_rows}", flush=True)
    return bound


def tier_timers(split: dict):
    """Wrap the MXU tier's class scorer (CUDA events around each class)
    and the api's exact fallback (host clock between synchronizations)
    for the solves that follow.  Returns the restore function."""
    import torch

    from cuda_knearests_tpu_torch import api
    from cuda_knearests_tpu_torch.ops import adaptive

    scorer, fallback = adaptive.grid_class_topk, api.brute_force_by_index

    def tier(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = scorer(*a, **kw)
        end.record()
        end.synchronize()
        split["tier_ms"] = split.get("tier_ms", 0.0) + start.elapsed_time(end)
        return out

    def timed_fallback(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fallback(*a, **kw)
        torch.cuda.synchronize()
        split["fallback_ms"] = (split.get("fallback_ms", 0.0)
                                + (time.perf_counter() - t0) * 1e3)
        return out

    adaptive.grid_class_topk, api.brute_force_by_index = tier, timed_fallback

    def restore():
        adaptive.grid_class_topk, api.brute_force_by_index = scorer, fallback
    return restore


def mxu_solves(name: str, prob, cfg, runs: int) -> dict:
    """Solve an mxu-planned problem 1 + ``runs`` times on the card: each
    within two host round trips, one class-kernel launch a solve per
    'kernel' class and none for an 'mxu' class, timed by
    :func:`tier_timers`.  Prints the certified fraction, the fallback rows
    and ms, and the tier's ms; returns them with the launches."""
    from cuda_knearests_tpu_torch.ops import cuda_solve as cs
    from cuda_knearests_tpu_torch.runtime import dispatch

    require(prob.device.type == DEV, f"{name}: prepared on {prob.device}")
    n = prob.grid.n_points
    per_solve = sum(cp.route == "kernel" for cp in prob.aplan.classes)
    splits, max_syncs = [], 0
    cs.launches = 0
    for _ in range(1 + runs):
        split = {}
        restore = tier_timers(split)
        before = cs.launches
        dispatch.reset_stats()
        t0 = time.perf_counter()
        try:
            res = prob.solve()
        finally:
            restore()
        split["solve_ms"] = (time.perf_counter() - t0) * 1e3
        syncs = dispatch.stats().host_syncs
        require(syncs <= dispatch.SYNC_BUDGET,
                f"{name}: solve made {syncs} host round trips")
        require(cs.launches - before == per_solve,
                f"{name}: solve made {cs.launches - before} class-kernel "
                f"launches for {per_solve} kernel classes")
        max_syncs = max(max_syncs, syncs)
        splits.append(split)
    unc = int(res.uncert_count)
    require(prob.get_knearests().shape == (n, cfg.k),
            f"{name}: result shape {prob.get_knearests().shape}")
    warm = splits[1:] or splits
    out = dict(
        certified_fraction=1.0 - unc / n, fallback_rows=unc,
        tier_ms=[s.get("tier_ms", 0.0) for s in splits],
        fallback_ms=[s.get("fallback_ms", 0.0) for s in splits],
        solve_ms=[s["solve_ms"] for s in splits],
        solve_median_ms=float(np.median([s["solve_ms"] for s in warm])),
        launches=cs.launches, host_round_trips=max_syncs)
    print(f"  {name}: n={n} k={cfg.k} rt={cfg.recall_target} "
          f"{cfg.resolved_precision()} fallback={cfg.fallback}: certified "
          f"fraction {out['certified_fraction']:.6f}; fallback rows {unc}; "
          f"tier ms (CUDA events) "
          f"{[round(t, 3) for t in out['tier_ms']]}; fallback ms "
          f"{[round(t, 3) for t in out['fallback_ms']]}; solve ms "
          f"{[round(t, 3) for t in out['solve_ms']]} (median of warm "
          f"{out['solve_median_ms']:.3f} = "
          f"{n / out['solve_median_ms'] * 1e3:,.0f} queries/s); class-kernel "
          f"launches {cs.launches}; host round trips {max_syncs}",
          flush=True)
    return out


def mxu_step_memory(prob, cfg) -> float:
    """One step of the widest 'mxu' class at its planned rows, run alone:
    its peak allocation (above what was allocated before) within
    ``adaptive.class_step_bytes``.  Returns the bytes per (query slot,
    candidate slot) pair."""
    import torch

    from cuda_knearests_tpu_torch.ops import adaptive

    cp = max((c for c in prob.aplan.classes if c.route == "mxu"),
             key=lambda c: c.qcap * c.ccap)
    g, rows = prob.grid, cp.step_rows
    out = (torch.empty((rows * cp.qcap, cfg.k), device=DEV),
           torch.empty((rows * cp.qcap, cfg.k), dtype=torch.int32,
                       device=DEV))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    adaptive.grid_class_topk(
        g.points, g.cell_starts, g.cell_counts, cp.own[:rows],
        cp.cand[:rows], cp.qcap, cfg.k, cp.ccap, cfg.exclude_self,
        cfg.recall_target, cfg.resolved_precision(), rows,
        tgt=torch.arange(rows * cp.qcap, device=DEV), out=out)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    model = adaptive.class_step_bytes(rows, cp.qcap, cp.ccap)
    per_pair = peak / (rows * cp.qcap * cp.ccap)
    print(f"    one step of {rows} supercells (qcap {cp.qcap}, ccap "
          f"{cp.ccap}): peak {peak} bytes, model {model} "
          f"({peak / model:.3f}), {per_pair:.2f} bytes a pair", flush=True)
    require(peak <= model, "an MXU class step allocated above its model")
    return per_pair


def mxu_card_equals_cpu(name: str, prob, cfg, precisions) -> None:
    """``grid_class_topk`` on the leading supercells of each 'mxu' class
    (at most ``MXU_SLICE_PAIRS`` pairs) on the card and on the CPU: d2 (NaN
    flags included) and ids equal bit for bit."""
    import torch

    from cuda_knearests_tpu_torch.mxu.scorer import grid_class_topk

    g = prob.grid
    for cp in (c for c in prob.aplan.classes if c.route == "mxu"):
        rows = max(1, min(cp.n_sc, MXU_SLICE_PAIRS // (cp.qcap * cp.ccap)))
        dev_args = (g.points, g.cell_starts, g.cell_counts, cp.own[:rows],
                    cp.cand[:rows])
        cpu_args = [a.cpu() for a in dev_args]
        for prec in precisions:
            kw = dict(qcap=cp.qcap, k=cfg.k, ccap=cp.ccap,
                      exclude_self=cfg.exclude_self,
                      recall_target=cfg.recall_target, precision=prec)
            gd, gi = grid_class_topk(*dev_args, **kw)
            t0 = time.perf_counter()
            cd, ci = grid_class_topk(*cpu_args, **kw)
            cpu_s = time.perf_counter() - t0
            gd, gi = gd.cpu(), gi.cpu()
            require(torch.equal(gd.view(torch.int32), cd.view(torch.int32))
                    and torch.equal(gi, ci),
                    f"{name} {prec}: the 'mxu' class on the card differs "
                    f"from the CPU")
            print(f"    card = CPU bit for bit: {rows} supercells (qcap "
                  f"{cp.qcap}, ccap {cp.ccap}) at {prec}, rt "
                  f"{cfg.recall_target}: {int(torch.isnan(cd[:, -1]).sum())} "
                  f"NaN rows of {cd.shape[0]} slots (CPU {cpu_s:.1f} s)",
                  flush=True)


def fold_open_rows(prob, cfg) -> np.ndarray:
    """Sorted-index rows whose fold did not certify: NaN at column k-1 of
    one more run of every 'mxu' class."""
    import torch

    from cuda_knearests_tpu_torch.mxu.scorer import grid_class_topk

    g, n, k = prob.grid, prob.grid.n_points, cfg.k
    out = (torch.zeros((n + 1, k), device=DEV),
           torch.zeros((n + 1, k), dtype=torch.int32, device=DEV))
    for cp in (c for c in prob.aplan.classes if c.route == "mxu"):
        grid_class_topk(g.points, g.cell_starts, g.cell_counts, cp.own,
                        cp.cand, cp.qcap, k, cp.ccap, cfg.exclude_self,
                        cfg.recall_target, cfg.resolved_precision(),
                        cp.step_rows, tgt=cp.tgt, out=out)
    return torch.isnan(out[0][:n, k - 1]).cpu().numpy()


def mxu_phase(pts300: np.ndarray, prob50, pts_cl: np.ndarray) -> dict:
    """Phase 4b: the grid route's MXU tier (``KnnConfig(scorer='mxu')``)
    on the card.  (a) 300k blue noise at k=50, f32, recall_target=1.0,
    1 cold + 2 warm solves: ids and d2 equal to the elementwise solve
    (``prob50``'s), exact against cKDTree on 20,000 sampled rows, one step
    within its memory model, one pass of the tier by kernel under
    torch.profiler; (b) the same at bf16, recall_target=0.9, one
    solve: exact; (c) the 300k clustered cloud at k=10 (per-supercell
    radii), recall_target=0.6, fallback='none': a fold that is not exhaustive
    (m < min(k, 128)), recall on 20,000 sampled rows at the declared 2B
    band at least the classes' smallest bound, certified sampled rows
    exact, every row the fold left open with (-1, inf) at column k-1;
    (d) the 'mxu' classes of (a) and (c) on a slice, card = CPU bit for
    bit."""
    from scipy.spatial import cKDTree

    import cuda_knearests_tpu_torch as pt

    out = {}
    rng = np.random.default_rng(13)
    cfg_a = pt.KnnConfig(k=50, scorer="mxu", recall_target=1.0)
    prob_a, prep_s = prepared(pts300, cfg_a)
    print(f"  (a) 300k blue noise, k=50, f32, recall_target=1.0: prepare "
          f"{prep_s:.3f} s", flush=True)
    mxu_class_lines(prob_a, cfg_a)
    require(all(cp.route == "mxu" for cp in prob_a.aplan.classes),
            "(a): a class of the 300k/k=50 plan is not on the MXU route")
    want = (prob50.get_knearests(), prob50.get_dists_sq())
    out["a"] = mxu_solves("(a) 300k/k=50 f32", prob_a, cfg_a, 2)
    require(np.array_equal(prob_a.get_knearests(), want[0])
            and np.array_equal(prob_a.get_dists_sq(), want[1]),
            "(a): ids or d2 differ from the elementwise solve")
    tree = cKDTree(pts300.astype(np.float64))
    rows = np.sort(rng.permutation(pts300.shape[0])[:SAMPLE_ROWS])
    check_exact(pts300, prob_a.get_knearests_original(), rows, 50, tree)
    out["a"]["bytes_per_pair"] = mxu_step_memory(prob_a, cfg_a)
    out["a"]["tier_profile"] = device_breakdown(
        "(a) 300k/k=50 f32", "pass of the MXU tier",
        lambda: fold_open_rows(prob_a, cfg_a), 0)
    print(f"    ids and d2 equal to the elementwise solve; exact vs cKDTree "
          f"on {rows.size} rows", flush=True)

    cfg_b = pt.KnnConfig(k=50, scorer="mxu", recall_target=0.9,
                         precision="bf16")
    prob_b, _ = prepared(pts300, cfg_b)
    print("  (b) 300k blue noise, k=50, bf16, recall_target=0.9", flush=True)
    mxu_class_lines(prob_b, cfg_b)
    out["b"] = mxu_solves("(b) 300k/k=50 bf16", prob_b, cfg_b, 0)
    require(np.array_equal(prob_b.get_knearests(), want[0])
            and np.array_equal(prob_b.get_dists_sq(), want[1]),
            "(b): ids or d2 differ from the elementwise solve")
    check_exact(pts300, prob_b.get_knearests_original(), rows, 50, tree)
    print(f"    exact: equal to the elementwise solve, and vs cKDTree on "
          f"{rows.size} rows", flush=True)
    del prob_b, tree

    k = 10
    # its default per-supercell radii: at ring_radius=1 the one class
    # class_eligible takes has ccap 256 (g = 2), whose fold keeps all k at
    # any recall target, and the class with g >= 13 is the 14,392 x 24,704
    # blob, which class_eligible refuses
    cfg_c = pt.KnnConfig(k=k, recall_target=0.6, fallback="none")
    prob_c, _ = prepared(pts_cl, cfg_c)
    print("  (c) 300k clustered, k=10, recall_target=0.6, fallback='none'",
          flush=True)
    bound = mxu_class_lines(prob_c, cfg_c)
    from cuda_knearests_tpu_torch.mxu.topk import BLOCK, per_block_m

    ms = [per_block_m(0.6, k, cp.ccap // BLOCK)
          for cp in prob_c.aplan.classes if cp.route == "mxu"]
    require(bool(ms) and min(ms) < min(k, BLOCK),
            f"(c): no 'mxu' class folds below min(k, 128) (m {ms})")
    out["c"] = mxu_solves("(c) 300k clustered", prob_c, cfg_c, 1)
    res = prob_c.result
    ids, d2 = prob_c.get_knearests(), prob_c.get_dists_sq()
    open_ = fold_open_rows(prob_c, cfg_c)
    require(bool((ids[open_, k - 1] == -1).all())
            and bool(np.isinf(d2[open_, k - 1]).all()),
            "(c): a row the fold left open lacks (-1, inf) at column k-1")
    require(not bool(np.asarray(res.certified)[open_].any()),
            "(c): a row the fold left open is certified")
    perm = prob_c.get_permutation()
    cert = np.empty(perm.shape, bool)
    cert[perm] = np.asarray(res.certified)
    nbrs = prob_c.get_knearests_original()
    rows = np.sort(rng.permutation(pts_cl.shape[0])[:SAMPLE_ROWS])
    dk, ik = tree_reference(pts_cl, rows, k,
                            cKDTree(pts_cl.astype(np.float64)))
    kth = dk[:, -1]
    sel = cert[rows]
    check_rows_exact(pts_cl, nbrs, rows[sel], dk[sel], ik[sel])
    require(bool((sampled_hits(pts_cl, nbrs, rows[sel], kth[sel]) == k)
                 .all()), "(c): a certified sampled row is not exact")
    recall = float(sampled_hits(pts_cl, nbrs, rows, kth,
                                sampled_band(pts_cl, rows, "f32")).sum()) \
        / (k * rows.size)
    require(recall >= bound, f"(c): recall {recall} on the sampled rows "
                             f"below the bound {bound}")
    out["c"].update(recall=recall, bound=bound, fold_open_rows=int(
        open_.sum()), m=ms)
    print(f"    fold left {int(open_.sum())} rows open, each (-1, inf) at "
          f"column k-1; sampled rows {rows.size}: {int(sel.sum())} "
          f"certified, all exact; recall at the 2B band {recall:.6f} >= "
          f"bound {bound:.6f}", flush=True)

    print("  (d) the 'mxu' classes on the card against the CPU", flush=True)
    mxu_card_equals_cpu("(a)", prob_a, cfg_a, ("f32", "bf16"))
    mxu_card_equals_cpu("(c)", prob_c, cfg_c, ("f32",))
    out["launches"] = sum(out[c]["launches"] for c in "abc")
    return out


# -- phase 5: the brute route at full width -----------------------------------

def sampled_hits(points: np.ndarray, nbrs: np.ndarray, rows: np.ndarray,
                 kth: np.ndarray, band=None) -> np.ndarray:
    """Per sampled row, the returned ids that are true top-k picks
    (``mxu/measure.row_hits``): exact f64 distance at most the true k-th
    (``kth``), widened by the row's ``band`` (2B), or without a band tying
    it at f32 resolution."""
    from cuda_knearests_tpu_torch.mxu.measure import row_hits

    return row_hits(points, nbrs[rows], kth, band, queries=points[rows])


def sampled_band(points: np.ndarray, rows: np.ndarray,
                 precision: str) -> np.ndarray:
    """``mxu/measure.declared_band`` of the sampled rows: 2B from f64
    norms at the scoring precision."""
    from cuda_knearests_tpu_torch.mxu.measure import declared_band

    return declared_band(points, points[rows], precision)


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
    band = sampled_band(points, rows, precision)
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
    from cuda_knearests_tpu_torch.mxu.measure import row_hits
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
        hits = row_hits(points, got[0].cpu().numpy(),
                        ref[0][:sub.numel(), -1],
                        queries=points[rows[:sub.numel()]])
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


# -- phase 6: the grid path with the blocked kernel ---------------------------

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
    # a deficit row's NaN at column k-1 is cleared to (-1, inf) after the
    # certificate; every box here holds more than k points
    deficit = int((raw.neighbors[:, cfg.k - 1] < 0).sum())
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


# -- phase 7: the grid path at a k no class kernel holds ----------------------

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


# -- phase 10: friends-of-friends and the plane feed --------------------------

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


# -- the serving daemon -------------------------------------------------------

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


# -- phase 10b: the multi-GPU z-slab solve -----------------------------------

SHARDED_N = 10_000_000
SHARDED_SLABS = 4
SHARDED_CPU_N = 200_000
SHARDED_MP_N = 1_000_000
SHARDED_WARM = 3
SHARDED_QUERIES = 1_000_000
SHARDED_DEVICE = "cuda:0"


def storage_bytes(*trees) -> int:
    """Bytes of the distinct device storages reachable from ``trees``
    (dataclasses, tuples, lists, dicts; views counted once)."""
    import dataclasses

    import torch

    seen, total, stack = set(), 0, list(trees)
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            if st.data_ptr() not in seen:
                seen.add(st.data_ptr())
                total += st.nbytes()
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            stack.extend(getattr(x, f.name) for f in dataclasses.fields(x))
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return total


def sharded_solve(sp) -> tuple:
    """One sharded solve, split: the slabs' solves (``solve_device`` up to
    a synchronize of the card), then ``solve(device_out=...)``: its
    batched fetch, the host placement and the kd-tree fallback (the
    engine's spans).  Returns (the solve's result, the split in ms, host
    round trips, class-kernel launches)."""
    import torch

    from cuda_knearests_tpu_torch.obs import spans
    from cuda_knearests_tpu_torch.ops import cuda_solve as cs
    from cuda_knearests_tpu_torch.runtime import dispatch

    before = cs.launches + cs.blocked_launches
    dispatch.reset_stats()
    with spans.capture() as events:
        t0 = time.perf_counter()
        outs = sp.solve_device()
        for dv in {sl.device for sl in sp.mesh}:
            torch.cuda.synchronize(dv)
        t1 = time.perf_counter()
        res = sp.solve(device_out=outs)
        t2 = time.perf_counter()
    span = {e["name"].rsplit(".", 1)[-1]: e["dur_ms"] for e in events}
    split = {"total_ms": (t2 - t0) * 1e3, "slabs_ms": (t1 - t0) * 1e3,
             "fetch_ms": span["fetch"], "place_ms": span["place"],
             "fallback_ms": span.get("fallback", 0.0)}
    return (res, split, dispatch.stats().host_syncs,
            cs.launches + cs.blocked_launches - before)


def slab_kernel_timing(sp, d: int, cfg, check_plain: bool) -> dict:
    """Slab ``d``'s class-kernel launches (mode (a), every 'kernel' class,
    as its solve makes them) by CUDA events, their bound (bytes of the
    packs, forward maps and (pcap, k) rows over 3.35 TB/s; 8 f32 ops a
    real pair over 67 TFLOP/s) and, with ``check_plain``, the same
    launches against the plain version on the same packs, equal bit for
    bit."""
    import torch

    from cuda_knearests_tpu_torch.ops import cuda_solve as cs
    from cuda_knearests_tpu_torch.ops.adaptive import class_blocked_m

    ready = sp._chip_ready(d)
    device = ready.window.device
    k, pcap = cfg.k, sp.meta.pcap
    classes = [cp for cp in ready.plan.classes if cp.route == "kernel"]

    def bufs():
        return (torch.full((pcap, k), float("inf"), device=device),
                torch.full((pcap, k), -1, dtype=torch.int32, device=device))

    out, plain_out = bufs(), bufs()

    def run(target, plain=False):
        for cp in classes:
            m = class_blocked_m(cfg, cp.ccap)
            args = (*cp.pk.args(), k)
            if m:
                fn = cs.blocked_topk_plain if plain else cs.blocked_topk
                fn(*args, m, cfg.exclude_self, tgt=cp.tgt, out=target)
            else:
                fn = cs.supercell_topk_plain if plain else cs.supercell_topk
                fn(*args, cfg.exclude_self, tgt=cp.tgt, out=target)

    ms = quiet(lambda: cuda_ms(lambda: run(out), 5))
    res = {"ms": ms, "kernel_classes": len(classes)}
    if check_plain:
        res["plain_ms"] = cuda_ms(lambda: run(plain_out, plain=True), 1)
        res["max_abs_err"] = require_equal(f"sharded slab {d} rows", out,
                                           plain_out)
    in_bytes = sum(a.numel() * a.element_size()
                   for cp in classes for a in (*cp.pk.args(), cp.tgt))
    pairs = sum(int(((cp.pk.qid >= 0).sum(1).long()
                     * (cp.pk.cid >= 0).sum(1).long()).sum())
                for cp in classes)
    t_bytes = (in_bytes + pcap * k * 8) / PEAK_HBM_BYTES * 1e3
    t_ops = 8 * pairs / PEAK_F32_FLOPS * 1e3
    res.update(bound_ms=max(t_bytes, t_ops),
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    return res


def sharded_rows_equal(what: str, got, want, rows: np.ndarray) -> None:
    """Original-order (ids, d2) tables equal bit for bit on ``rows``."""
    for name, a, b in (("ids", got[0], want[0]), ("d2", got[1], want[1])):
        bad = np.nonzero((a[rows] != b[rows]).any(axis=1))[0]
        require(bad.size == 0,
                f"{what}: {bad.size} of {rows.size} rows differ in {name} "
                f"(first: row {rows[bad[:1]]})")


def sharded_main(pts: np.ndarray, cfg, devices, tree, single) -> dict:
    """(a) and (b) on one mesh: prepare (split), ShardMeta, per slab its
    points, classes and resident bytes, 1 + SHARDED_WARM solves (split,
    round trips, launches), per-slab kernel ms, then the rows against the
    single-device solve on the card (bit for bit where both certify) and
    cKDTree on SAMPLE_ROWS sampled rows."""
    import dataclasses

    import torch

    from cuda_knearests_tpu_torch.ops import cuda_solve as cs
    from cuda_knearests_tpu_torch.parallel import ShardedKnnProblem
    from cuda_knearests_tpu_torch.parallel.sharded import _chip_solve

    label = f"{len(devices)} slabs on {sorted({str(d) for d in devices})}"
    n = pts.shape[0]
    base = {}
    for dv in set(devices):
        torch.cuda.synchronize(dv)
        base[dv] = torch.cuda.memory_allocated(dv)
        torch.cuda.reset_peak_memory_stats(dv)
    t0 = time.perf_counter()
    sp = ShardedKnnProblem.prepare(pts, config=cfg, devices=devices)
    prep_s = time.perf_counter() - t0
    m = sp.meta
    print(f"  sharded 10M/k={cfg.k}, {label}: prepare {prep_s:.3f} s = "
          + ", ".join(f"{key} {v:.3f}" for key, v in
                      sp.prepare_seconds.items())
          + f" s\n    ShardMeta dim={m.dim} zcap={m.zcap} radius={m.radius} "
          f"pcap={m.pcap} hcap={m.hcap}", flush=True)
    n_kernel = sum(cp.route == "kernel" for p in sp.chip_plans
                   for cp in p.classes)
    require(n_kernel > 0, "the sharded plan has no kernel class")
    cs.launches = cs.blocked_launches = 0
    runs, launches, syncs = [], 0, 0
    for i in range(1 + SHARDED_WARM):
        res, split, s, done = sharded_solve(sp)
        require(done == n_kernel,
                f"sharded solve made {done} class-kernel launches for "
                f"{n_kernel} kernel classes")
        require(s <= 2, f"sharded solve made {s} host round trips")
        syncs = max(syncs, s)
        launches += done
        runs.append(split)
        if i == 0:
            print(f"    first solve (with every slab's ready state) "
                  f"{split['total_ms']:.3f} ms", flush=True)
    main_launches = cs.launches + cs.blocked_launches
    require(main_launches == launches, "sharded launch counts disagree")
    warm = runs[1:]
    med = float(np.median([r["total_ms"] for r in warm]))
    # above what the card held before prepare (the single-device problem)
    peak = max(torch.cuda.max_memory_allocated(dv) - base[dv]
               for dv in set(devices))
    ids, d2, cert = res
    unc = int(sp.fallback_rows.size)
    print(f"    solve median of {SHARDED_WARM} {med:.3f} ms = "
          f"{n / med * 1e3:,.0f} queries/s; splits (ms) "
          + "; ".join(", ".join(f"{key[:-3]} {v:.3f}" for key, v in r.items())
                      for r in warm)
          + f"\n    host round trips {syncs} per solve; class-kernel "
          f"launches {n_kernel} per solve ({launches} over "
          f"{1 + SHARDED_WARM}); certified fraction {1 - unc / n:.6f} "
          f"({unc} kd-tree rows); peak allocated {peak:,} bytes",
          flush=True)
    slabs = []
    for d in range(m.ndev):
        plan = sp.chip_plans[d]
        row = {"slab": d, "device": str(sp.mesh[d].device),
               "points": int(sp.dev[d]["counts"].sum()),
               "classes": [(c.radius, c.qcap, c.ccap, c.route, c.n_sc)
                           for c in plan.classes],
               "resident_bytes": storage_bytes(sp.dev[d],
                                               sp._ready_cache.get(d))}
        if plan.classes:
            row.update(slab_kernel_timing(sp, d, cfg, check_plain=(d == 1)))
            row["slab_solve_ms"] = quiet(lambda: cuda_ms(
                lambda: _chip_solve(sp._chip_ready(d), cfg), 3))
        slabs.append(row)
        print(f"    slab {d}: {json.dumps(row)}", flush=True)
    kernel_ms = sum(r.get("ms", 0.0) for r in slabs)

    # (b) against the single-device solve on the card and cKDTree
    s_peak, s_ids, s_d2, s_cert = single
    both = s_cert & cert
    both[sp.fallback_rows] = False
    rows = np.nonzero(both)[0]
    sharded_rows_equal(f"sharded ({label}) vs single-device", (ids, d2),
                       (s_ids, s_d2), rows)
    rng = np.random.default_rng(17)
    take = sp.fallback_rows[rng.permutation(unc)[:2000]].astype(np.int64)
    sample = np.unique(np.concatenate(
        [take, rng.permutation(n)[: SAMPLE_ROWS - take.size]]))
    t0 = time.perf_counter()
    check_exact(pts, ids, sample, cfg.k, tree)
    print(f"    rows equal the single-device solve's bit for bit on {rows.size:,} "
          f"rows both certify ({n - rows.size} left out: fallback rows); "
          f"exact vs cKDTree on {sample.size} sampled rows "
          f"({take.size} kd-tree rows), checked in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {"sp": sp, "label": label, "prepare_s": prep_s,
            "prepare_split_s": dict(sp.prepare_seconds),
            "meta": dataclasses.asdict(m), "solve_median_ms": med,
            "queries_per_s": n / med * 1e3, "warm_splits": warm,
            "host_round_trips": syncs, "launches": launches,
            "kernel_classes": n_kernel, "kernel_ms": kernel_ms,
            "bound_ms": sum(r.get("bound_ms", 0.0) for r in slabs),
            "certified_fraction": 1 - unc / n, "peak_allocated": peak,
            "single_peak_allocated": s_peak, "slabs": slabs}


def sharded_queries(sp, s_prob, queries: np.ndarray, tree, pts) -> dict:
    """(c): the queries through the sharded problem, 1 + 1 calls, equal
    bit for bit to the single-device ``query`` and exact against cKDTree
    on sampled rows; one batched fetch a call."""
    from cuda_knearests_tpu_torch.ops import cuda_solve as cs
    from cuda_knearests_tpu_torch.runtime import dispatch

    times = []
    before = cs.launches + cs.blocked_launches
    for _ in range(2):
        dispatch.reset_stats()
        t0 = time.perf_counter()
        ids, d2 = sp.query(queries)
        times.append(time.perf_counter() - t0)
        require(dispatch.stats().host_syncs <= 2,
                f"sharded query made {dispatch.stats().host_syncs} round "
                f"trips")
    launches = cs.launches + cs.blocked_launches - before
    t0 = time.perf_counter()
    s_ids, s_d2 = quiet(lambda: s_prob.query(queries))
    s_ms = (time.perf_counter() - t0) * 1e3
    sharded_rows_equal("sharded queries vs single-device", (ids, d2),
                       (s_ids, s_d2), np.arange(queries.shape[0]))
    rows = np.random.default_rng(19).permutation(queries.shape[0])[
        :SAMPLE_ROWS]
    check_queries_exact("sharded queries", pts, queries, ids, rows,
                        sp.config.k, tree)
    m = queries.shape[0]
    print(f"  sharded queries: {m:,} in {times[0] * 1e3:.3f} ms (first) / "
          f"{times[1] * 1e3:.3f} ms = {m / times[1]:,.0f} queries/s; "
          f"class-kernel launches {launches}; equal to the single-device "
          f"query bit for bit (single-device call {s_ms:.3f} ms)",
          flush=True)
    return {"first_ms": times[0] * 1e3, "warm_ms": times[1] * 1e3,
            "queries_per_s": m / times[1], "launches": launches,
            "single_ms": s_ms}, (s_ids, s_d2)


def sharded_card_equals_cpu(cfg_kw: dict) -> None:
    """(d): on SHARDED_CPU_N points at 4 slabs, the card's sharded solve
    equals the CPU run bit for bit (ids, d2, certificates of every slab),
    under 'scatter' and 'gather'."""
    import torch

    import cuda_knearests_tpu_torch as pt
    from cuda_knearests_tpu_torch.io import generate_uniform
    from cuda_knearests_tpu_torch.parallel import ShardedKnnProblem

    pts = generate_uniform(SHARDED_CPU_N, seed=10)
    for epilogue in ("scatter", "gather"):
        cfg = pt.KnnConfig(**cfg_kw, epilogue=epilogue)
        t0 = time.perf_counter()
        got = {}
        for dev in (SHARDED_DEVICE, "cpu"):
            sp = ShardedKnnProblem.prepare(pts, config=cfg,
                                           devices=[dev] * SHARDED_SLABS)
            outs = quiet(sp.solve_device)
            got[dev] = {d: [t.cpu() for t in o] for d, o in outs.items()
                        if o is not None}
        for d, want in got["cpu"].items():
            for name, a, b in zip(("ids", "d2", "cert"),
                                  got[SHARDED_DEVICE][d], want):
                require(torch.equal(a, b), f"sharded {epilogue}: slab {d} "
                                           f"{name} differ card vs CPU")
        print(f"  sharded card = CPU: {SHARDED_CPU_N:,} points, "
              f"{SHARDED_SLABS} slabs, {epilogue}: every slab's ids, d2 and "
              f"certificates equal bit for bit "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)


def sharded_processes(cfg_k: int) -> dict:
    """(e): 2 processes x 2 slabs on SHARDED_MP_N points
    (``python -m cuda_knearests_tpu_torch.parallel``): gloo with both on
    cuda:0 on a one-card host (NCCL refuses two ranks on one card), NCCL
    with one card each where there are two.  Each process's slab rows must
    equal the single-process 4-slab run's bit for bit."""
    import socket
    import tempfile

    import torch

    import cuda_knearests_tpu_torch as pt
    from cuda_knearests_tpu_torch.io import generate_uniform
    from cuda_knearests_tpu_torch.parallel import ShardedKnnProblem

    two = torch.cuda.device_count() >= 2
    backend = "nccl" if two else "gloo"
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out_dir = tempfile.mkdtemp(prefix="sharded_mp_")
    root = os.path.dirname(os.path.abspath(__file__))
    env = {key: v for key, v in os.environ.items()
           if key not in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT",
                          "LOCAL_RANK")}
    env["PYTHONPATH"] = root
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "cuda_knearests_tpu_torch.parallel",
         "--rank", str(r), "--world", "2", "--address", f"localhost:{port}",
         "--out", out_dir, "--n", str(SHARDED_MP_N), "--seed", "10",
         "--k", str(cfg_k), "--slabs", "2",
         "--device", f"cuda:{r}" if two else SHARDED_DEVICE,
         "--backend", backend,
         "--timeout", "120"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=root) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, out) in enumerate(zip(procs, outs)):
        for line in out.strip().splitlines()[-2:]:
            print(f"    {line}", flush=True)
        require(p.returncode == 0 and f"WORKER_OK {r}" in out
                and f"backend={backend}" in out,
                f"multi-process rank {r} failed (rc {p.returncode}):\n"
                f"{out[-3000:]}")
    pts = generate_uniform(SHARDED_MP_N, seed=10)
    sp = ShardedKnnProblem.prepare(pts, config=pt.KnnConfig(k=cfg_k),
                                   devices=[SHARDED_DEVICE] * 4)
    want = quiet(sp.solve_device)
    seen = np.zeros((SHARDED_MP_N,), np.int32)
    for d in range(4):
        z = np.load(os.path.join(out_dir, f"rank{d // 2}_slab{d}.npz"))
        sids = sp.dev[d]["sids"].cpu().numpy()
        real = sids >= 0
        require(np.array_equal(z["sids"], sids[real]),
                f"multi-process slab {d}: ids differ")
        for name, t in zip(("nbr", "d2", "cert"), want[d]):
            require(np.array_equal(z[name], t.cpu().numpy()[real]),
                    f"multi-process slab {d}: {name} differ from the "
                    f"single-process run")
        seen[z["sids"]] += 1
    shutil.rmtree(out_dir, ignore_errors=True)
    require(bool((seen == 1).all()), "multi-process rows not covered once")
    print(f"  sharded multi-process: 2 processes x 2 slabs on "
          f"{SHARDED_MP_N:,} points over {backend}, in {wall:.1f} s; every "
          f"slab's rows equal the single-process 4-slab run's bit for bit",
          flush=True)
    return {"backend": backend, "wall_s": wall}


def sharded_phase() -> dict:
    """Phase 10b: the multi-GPU z-slab solve (``parallel.sharded``) on the
    reference bench's ``sharded_10m_k10`` cloud (a)-(c), card = CPU (d) and
    two processes (e)."""
    import torch
    from scipy.spatial import cKDTree

    import cuda_knearests_tpu_torch as pt
    from cuda_knearests_tpu_torch.io import generate_uniform
    from cuda_knearests_tpu_torch.ops.adaptive import solve_adaptive

    t_phase = time.perf_counter()
    cfg = pt.KnnConfig(k=10)
    pts = generate_uniform(SHARDED_N, seed=10)
    n = pts.shape[0]
    # the single-device solve it is held to, and its peak allocation
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s_prob = quiet(lambda: pt.KnnProblem.prepare(pts, cfg, device=DEV))
    quiet(s_prob.solve)
    s_times = []
    for _ in range(2):
        t1 = time.perf_counter()
        quiet(s_prob.solve)
        s_times.append(time.perf_counter() - t1)
    s_peak = torch.cuda.max_memory_allocated() - base
    perm = s_prob.get_permutation()
    t1 = time.perf_counter()
    s_ids = s_prob.get_knearests_original()
    # the single-device rows in original order: the same host scatter of
    # n rows that the sharded solve's placement makes (for ids alone)
    s_orig_ms = (time.perf_counter() - t1) * 1e3
    s_d2 = np.empty_like(s_prob.get_dists_sq())
    s_d2[perm] = s_prob.get_dists_sq()
    s_cert = np.empty((n,), bool)
    s_cert[perm] = quiet(lambda: solve_adaptive(
        s_prob.grid, cfg, s_prob.aplan).certified.cpu().numpy())
    s_med = float(np.median(s_times))
    print(f"  single-device 10M/k=10 on the card: prepare+solve "
          f"{time.perf_counter() - t0:.3f} s, warm solves "
          f"{[round(t * 1e3, 3) for t in s_times]} ms; peak allocated "
          f"{s_peak:,} bytes; get_knearests_original {s_orig_ms:.3f} ms",
          flush=True)
    t0 = time.perf_counter()
    tree = cKDTree(pts.astype(np.float64))
    print(f"  cKDTree over 10M points in {time.perf_counter() - t0:.1f} s",
          flush=True)
    single = (s_peak, s_ids, s_d2, s_cert)
    main = sharded_main(pts, cfg, [SHARDED_DEVICE] * SHARDED_SLABS, tree,
                        single)
    per_card = None
    if torch.cuda.device_count() >= 2:
        per_card = sharded_main(
            pts, cfg, [f"cuda:{i}" for i in range(torch.cuda.device_count())],
            tree, single)
        per_card.pop("sp")
    queries = generate_uniform(SHARDED_QUERIES, seed=901)
    query, query_single = sharded_queries(main["sp"], s_prob, queries, tree,
                                          pts)
    main.pop("sp")
    del s_prob
    sharded_card_equals_cpu({"k": 10})
    procs = sharded_processes(10)
    took = time.perf_counter() - t_phase
    print(f"  sharded phase: {took:.1f} s", flush=True)
    # what phase 10c reuses: the cloud, its kd-tree, the single-device rows
    # and peak, the queries and the single-device query rows
    reuse = {"pts": pts, "tree": tree, "single": single, "queries": queries,
             "query_single": query_single}
    return {"main": main, "per_card": per_card, "queries": query,
            "processes": procs, "single_solve_ms": s_med * 1e3,
            "single_original_order_ms": s_orig_ms,
            "phase_s": took}, reuse


# -- phase 10c: the pod, the cell-partitioned index ---------------------------

POD_CHIPS = 4
# the plan of generate_uniform(10_000_000, seed=10), k=10, over 4 chips, as
# the JAX package's build_pod_plan gives it
POD_META = {"pcap": 2_500_088, "hcap": 291_040, "steps": 3,
            "n_ext": 4_246_328}
POD_HALO_BYTES = 83_819_520
POD_WARM = 3
POD_CPU_N = 200_000
POD_BUDGET_N = 1_000_000
POD_MXU_N = 4_000


def pod_devices() -> list:
    """Four chips: one a card where the runner has four, else four on
    SHARDED_DEVICE."""
    import torch

    if torch.cuda.device_count() >= POD_CHIPS:
        return [f"cuda:{i}" for i in range(POD_CHIPS)]
    return [SHARDED_DEVICE] * POD_CHIPS


def sync_chips(pp) -> None:
    import torch

    for dv in set(pp.mesh):
        torch.cuda.synchronize(dv)


def pod_solve(pp) -> tuple:
    """One pod solve, split: the chips' solves (``solve_device`` up to a
    synchronize), then ``solve(device_out=...)``: its batched fetch, the
    host placement and the kd-tree fallback (the engine's spans).  Returns
    (the solve's result, the split in ms, host round trips, ici bytes,
    class-kernel launches)."""
    from cuda_knearests_tpu_torch.obs import spans
    from cuda_knearests_tpu_torch.ops import cuda_solve as cs
    from cuda_knearests_tpu_torch.runtime import dispatch

    before = cs.launches + cs.blocked_launches
    dispatch.reset_stats()
    with spans.capture() as events:
        t0 = time.perf_counter()
        outs = pp.solve_device()
        sync_chips(pp)
        t1 = time.perf_counter()
        res = pp.solve(device_out=outs)
        t2 = time.perf_counter()
    span = {e["name"].rsplit(".", 1)[-1]: e["dur_ms"] for e in events}
    split = {"total_ms": (t2 - t0) * 1e3, "chips_ms": (t1 - t0) * 1e3,
             "fetch_ms": span["fetch"], "place_ms": span["place"],
             "fallback_ms": span.get("fallback", 0.0)}
    st = dispatch.stats()
    return (res, split, st.host_syncs, st.ici_bytes,
            cs.launches + cs.blocked_launches - before)


def pod_chip_peaks(pp, cfg) -> list:
    """Per chip: its ready state rebuilt and its solve run alone, the peak
    allocation above what the card held before it (its staged share and
    received blocks counted in), against ``stream.chip_hbm_model``."""
    import torch

    from cuda_knearests_tpu_torch.parallel.sharded import _chip_solve
    from cuda_knearests_tpu_torch.pod.stream import chip_hbm_model

    out = []
    for d, plan in enumerate(pp.chip_plans):
        pp.drop_ready(d)
        dv = pp.mesh[d]
        own = sum(t.untyped_storage().nbytes()
                  for t in list(pp.dev[d].values()) + list(pp._halo[d]))
        torch.cuda.synchronize(dv)
        base = torch.cuda.memory_allocated(dv) - own
        torch.cuda.reset_peak_memory_stats(dv)
        res = quiet(lambda: _chip_solve(pp._chip_ready(d), cfg))
        torch.cuda.synchronize(dv)
        peak = torch.cuda.max_memory_allocated(dv) - base
        del res
        model = chip_hbm_model(pp.meta, plan, cfg)
        require(peak <= model, f"pod chip {d}: peak {peak} bytes above its "
                               f"model {model}")
        out.append({"chip": d, "peak": peak, "model": model})
    return out


def rows_tie_aware(what: str, coords: np.ndarray, pts: np.ndarray, got,
                   want, rows: np.ndarray) -> int:
    """d2 equal bit for bit on ``rows``; where ids differ, the two id rows
    must realize the same distances from ``coords`` (ties).  Returns the
    rows whose ids differ."""
    bad = rows[(got[1][rows] != want[1][rows]).any(axis=1)]
    require(bad.size == 0, f"{what}: {bad.size} of {rows.size} rows differ "
                           f"in d2 (first: row {bad[:1]})")
    diff = rows[(got[0][rows] != want[0][rows]).any(axis=1)]
    for r0 in range(0, diff.size, 100_000):
        r = diff[r0:r0 + 100_000]
        q = coords[r].astype(np.float64)[:, None, :]
        da = ((pts[got[0][r]].astype(np.float64) - q) ** 2).sum(-1)
        db = ((pts[want[0][r]].astype(np.float64) - q) ** 2).sum(-1)
        require(bool(np.allclose(np.sort(da, 1), np.sort(db, 1),
                                 rtol=RTOL, atol=ATOL)),
                f"{what}: rows with other ids are not ties")
    return int(diff.size)


def pod_main(pts: np.ndarray, cfg, devices, tree, single) -> dict:
    """The 10M pod: prepare (plan, stage), its meta against the JAX
    package's integers, 1 + POD_WARM solves (split, round trips, ici bytes,
    launches), the exchange and the ready states timed apart, each chip's
    peak against its model and its class kernels by CUDA events, then the
    rows against the single-device solve (d2 bit for bit where both
    certify, ids tie-aware) and cKDTree on SAMPLE_ROWS rows."""
    import torch

    from cuda_knearests_tpu_torch.ops import cuda_solve as cs
    from cuda_knearests_tpu_torch.parallel.sharded import _chip_solve
    from cuda_knearests_tpu_torch.pod import PodKnnProblem
    from cuda_knearests_tpu_torch.pod import halo

    label = f"{len(devices)} chips on {sorted(set(devices))}"
    n = pts.shape[0]
    t0 = time.perf_counter()
    pp = PodKnnProblem.prepare(pts, config=cfg, mesh=devices)
    sync_chips(pp)
    prep_s = time.perf_counter() - t0
    m = pp.meta
    got = {"pcap": m.pcap, "hcap": m.hcap, "steps": m.steps,
           "n_ext": m.n_ext}
    print(f"  pod 10M/k={cfg.k}, {label}: prepare {prep_s:.3f} s = "
          + ", ".join(f"{key} {v:.3f}" for key, v in
                      pp.prepare_seconds.items())
          + f" s\n    PodMeta dim={m.dim} supercell={m.supercell} "
          f"{json.dumps(got)} halo_bytes {m.halo_bytes()}; model high "
          f"water {pp.hbm['hbm_high_water_bytes']:,}, full cloud "
          f"{pp.hbm['hbm_full_cloud_bytes']:,} bytes", flush=True)
    require(got == POD_META and m.halo_bytes() == POD_HALO_BYTES,
            f"pod meta {got} (halo {m.halo_bytes()}) is not the JAX "
            f"package's {POD_META} ({POD_HALO_BYTES})")
    for d, c in enumerate(pp.chip_plans):
        print(f"    chip {d}: {c.n_local:,} points, {c.sc_ids.size:,} "
              f"supercells, {c.remote_cells:,} remote cells, "
              f"{len(c.classes)} class(es): "
              + "; ".join(f"{cl.n_sc:,} supercells r={cl.radius} qcap "
                          f"{cl.qcap} ccap {cl.ccap} [{cl.route}]"
                          for cl in c.classes), flush=True)
    n_kernel = sum(cl.route == "kernel" for c in pp.chip_plans
                   for cl in c.classes)
    require(n_kernel > 0, "the pod's plan has no kernel class")
    cs.launches = cs.blocked_launches = 0
    runs, launches = [], 0
    for i in range(1 + POD_WARM):
        res, split, syncs, ici, done = pod_solve(pp)
        want_ici = m.halo_bytes() if i == 0 else 0
        require(done == n_kernel,
                f"pod solve made {done} class-kernel launches for "
                f"{n_kernel} kernel classes")
        require(syncs == 1 and ici == want_ici,
                f"pod solve {i}: {syncs} host round trips, {ici} ici bytes "
                f"(want 1 and {want_ici})")
        launches += done
        runs.append(split)
        if i == 0:
            print(f"    first solve (the exchange and every chip's ready "
                  f"state) {split['total_ms']:.3f} ms: 1 host round trip, "
                  f"ici_bytes {ici:,} = halo_bytes", flush=True)
    require(cs.launches + cs.blocked_launches == launches,
            "pod launch counts disagree")
    warm = runs[1:]
    med = float(np.median([r["total_ms"] for r in warm]))
    ids, d2, cert = res
    unc = int(pp.fallback_rows.size)

    ex_ms = []
    for _ in range(3):
        sync_chips(pp)
        t1 = time.perf_counter()
        halo.exchange(m, pp.dev, pp.mesh)
        sync_chips(pp)
        ex_ms.append((time.perf_counter() - t1) * 1e3)
    ready_ms = []
    for d in range(m.ndev):
        pp.drop_ready(d)
        sync_chips(pp)
        t1 = time.perf_counter()
        pp._chip_ready(d)
        sync_chips(pp)
        ready_ms.append((time.perf_counter() - t1) * 1e3)
    print(f"    solve median of {POD_WARM} {med:.3f} ms = "
          f"{n / med * 1e3:,.0f} queries/s; splits (ms) "
          + "; ".join(", ".join(f"{key[:-3]} {v:.3f}" for key, v in r.items())
                      for r in warm)
          + f"\n    exchange alone {[round(x, 3) for x in ex_ms]} ms; ready "
          f"states {[round(x, 3) for x in ready_ms]} ms; class-kernel "
          f"launches {n_kernel} per solve ({launches} over {1 + POD_WARM})",
          flush=True)
    peaks = pod_chip_peaks(pp, cfg)
    print(f"    per-chip peak above what the card held before it, against "
          f"its model: {json.dumps(peaks)}", flush=True)
    chips = []
    for d in range(m.ndev):
        row = {"chip": d, **slab_kernel_timing(pp, d, cfg,
                                               check_plain=(d == 1))}
        row["chip_solve_ms"] = quiet(lambda: cuda_ms(
            lambda: _chip_solve(pp._chip_ready(d), cfg), 3))
        chips.append(row)
        print(f"    chip {d}: {json.dumps(row)}", flush=True)

    s_peak, s_ids, s_d2, s_cert = single
    both = s_cert & cert
    both[pp.fallback_rows] = False
    rows = np.nonzero(both)[0]
    tied = rows_tie_aware("pod vs single-device", pts, pts, (ids, d2),
                          (s_ids, s_d2), rows)
    rng = np.random.default_rng(23)
    sample = np.unique(np.concatenate([
        pp.fallback_rows[rng.permutation(unc)[:2000]].astype(np.int64),
        rng.permutation(n)[:SAMPLE_ROWS]]))[:SAMPLE_ROWS]
    check_exact(pts, ids, sample, cfg.k, tree)
    full = pp.hbm["hbm_full_cloud_bytes"]
    require(full >= s_peak, f"the full-cloud model {full} is below the "
                            f"single-device problem's peak {s_peak}")
    print(f"    d2 equal to the single-device solve's bit for bit on "
          f"{rows.size:,} rows both certify ({tied} with other ids, ties); "
          f"certified fractions: pod {1 - unc / n:.6f} ({unc} kd-tree "
          f"rows), single-device {float(s_cert.mean()):.6f}; exact vs "
          f"cKDTree on {sample.size} sampled rows; full-cloud model "
          f"{full:,} >= the single-device peak {s_peak:,} bytes",
          flush=True)
    return {"pp": pp, "label": label, "prepare_s": prep_s,
            "prepare_split_s": dict(pp.prepare_seconds),
            "exchange_ms": ex_ms, "ready_ms": ready_ms,
            "meta": got, "halo_bytes": m.halo_bytes(),
            "solve_median_ms": med, "queries_per_s": n / med * 1e3,
            "warm_splits": warm, "launches": launches,
            "kernel_classes": n_kernel,
            "kernel_ms": sum(r["ms"] for r in chips),
            "bound_ms": sum(r["bound_ms"] for r in chips),
            "certified_fraction": 1 - unc / n,
            "single_certified_fraction": float(s_cert.mean()),
            "rows_tied": tied, "peaks": peaks, "full_model": full,
            "single_peak": s_peak, "hbm": dict(pp.hbm), "chips": chips}


def pod_queries(pp, queries: np.ndarray, query_single, tree,
                pts: np.ndarray) -> dict:
    """The 1M queries through the directory, 1 + 1 calls of one round
    trip: d2 equal to the single-device query's bit for bit on the rows
    the pod certified, ids tie-aware, sampled rows exact."""
    from cuda_knearests_tpu_torch.ops import cuda_solve as cs
    from cuda_knearests_tpu_torch.runtime import dispatch

    times = []
    before = cs.launches + cs.blocked_launches
    for _ in range(2):
        dispatch.reset_stats()
        t0 = time.perf_counter()
        ids, d2 = pp.query(queries)
        times.append((time.perf_counter() - t0) * 1e3)
        require(dispatch.stats().host_syncs == 1,
                f"pod query made {dispatch.stats().host_syncs} round trips")
    launches = cs.launches + cs.blocked_launches - before
    m = queries.shape[0]
    rows = np.setdiff1d(np.arange(m), pp.query_fallback_rows)
    tied = rows_tie_aware("pod queries vs single-device", queries, pts,
                          (ids, d2), query_single, rows)
    sample = np.random.default_rng(29).permutation(m)[:SAMPLE_ROWS]
    check_queries_exact("pod queries", pts, queries, ids, sample,
                        pp.config.k, tree)
    print(f"  pod queries: {m:,} in {times[0]:.3f} ms (first) / "
          f"{times[1]:.3f} ms = {m / times[1] * 1e3:,.0f} queries/s; "
          f"class-kernel launches {launches}; d2 equal to the single-device "
          f"query bit for bit on {rows.size:,} rows ({tied} with other ids, "
          f"ties; {pp.query_fallback_rows.size} kd-tree rows)", flush=True)
    return {"first_ms": times[0], "warm_ms": times[1],
            "queries_per_s": m / times[1] * 1e3, "launches": launches,
            "fallback_rows": int(pp.query_fallback_rows.size)}


def pod_card_equals_cpu(pts: np.ndarray) -> float:
    """On a POD_CPU_N cut, the pod on four chips of the card equals the pod
    on four CPU chips bit for bit: every chip's received blocks, ids, d2
    and certificates."""
    import torch

    import cuda_knearests_tpu_torch as pt
    from cuda_knearests_tpu_torch.pod import PodKnnProblem

    t0 = time.perf_counter()
    cut = np.ascontiguousarray(pts[:POD_CPU_N])
    got = {}
    for dev in (SHARDED_DEVICE, "cpu"):
        pp = PodKnnProblem.prepare(cut, config=pt.KnnConfig(k=10),
                                   mesh=[dev] * POD_CHIPS)
        outs = quiet(pp.solve_device)
        got[dev] = ({d: [t.cpu() for t in o] for d, o in outs.items()
                     if o is not None},
                    {d: [t.cpu() for t in h] for d, h in pp._halo.items()})
    for part in (0, 1):
        want = got["cpu"][part]
        for d, ts in want.items():
            for j, (a, b) in enumerate(zip(got[SHARDED_DEVICE][part][d],
                                           ts)):
                require(torch.equal(a, b),
                        f"pod card vs CPU: chip {d} "
                        f"{('rows', 'halo')[part]} tensor {j} differs")
    took = time.perf_counter() - t0
    print(f"  pod card = CPU: {POD_CPU_N:,} points, {POD_CHIPS} chips: every "
          f"chip's received blocks, ids, d2 and certificates equal bit for "
          f"bit ({took:.1f} s)", flush=True)
    return took


def pod_mxu(pts: np.ndarray, devices) -> dict:
    """The MXU tier on a POD_MXU_N cut at recall targets 0.9 and 1.0: at
    least one 'mxu' class, every row exact after the fallback."""
    from scipy.spatial import cKDTree

    import cuda_knearests_tpu_torch as pt
    from cuda_knearests_tpu_torch.pod import PodKnnProblem

    cut = np.ascontiguousarray(pts[:POD_MXU_N])
    tree = cKDTree(cut.astype(np.float64))
    out = {}
    for rt in (0.9, 1.0):
        pm = PodKnnProblem.prepare(cut, config=pt.KnnConfig(
            k=10, scorer="mxu", recall_target=rt), mesh=devices)
        n_mxu = sum(cl.route == "mxu" for c in pm.chip_plans
                    for cl in c.classes)
        require(n_mxu > 0, f"pod MXU tier at {rt}: no 'mxu' class")
        ids, _d2, cert = quiet(pm.solve)
        require(bool(cert.all()), f"pod MXU tier at {rt}: open rows")
        check_exact(cut, ids, np.arange(cut.shape[0]), 10, tree)
        out[str(rt)] = {"mxu_classes": n_mxu,
                        "kd_tree_rows": int(pm.fallback_rows.size)}
    print(f"  pod MXU tier on {POD_MXU_N:,} points: {json.dumps(out)}; "
          f"every row exact", flush=True)
    return out


def pod_budget(pts: np.ndarray, devices) -> dict:
    """On a POD_BUDGET_N cut, budgets read from the cut's own plan: one
    between the per-chip high water and the full-cloud model streams and
    stays exact (high water <= budget < full); one an eighth of the high
    water is refused (kind 'oom'); with n_devices=None and a budget just
    below the least one chip can take (``stream.chip_floor_bytes`` of a
    one-chip plan: every class streamed), the auto-splitter widens over
    the pool."""
    from scipy.spatial import cKDTree

    import cuda_knearests_tpu_torch as pt
    from cuda_knearests_tpu_torch.pod import PodKnnProblem
    from cuda_knearests_tpu_torch.pod.partition import build_pod_plan
    from cuda_knearests_tpu_torch.pod.stream import chip_floor_bytes
    from cuda_knearests_tpu_torch.utils.memory import LaunchBudgetError

    cut = np.ascontiguousarray(pts[:POD_BUDGET_N])
    cfg = pt.KnnConfig(k=10)
    base = PodKnnProblem.prepare(cut, config=cfg, mesh=devices)
    high = base.hbm["hbm_high_water_bytes"]
    full = base.hbm["hbm_full_cloud_bytes"]
    require(high < full, f"pod budget: the high water {high} is not below "
                         f"the full-cloud model {full}")
    budget = (high + full) // 2
    ps = PodKnnProblem.prepare(cut, config=pt.KnnConfig(
        k=10, hbm_budget_bytes=budget), mesh=devices)
    require(ps.hbm["streamed_prepare"]
            and ps.hbm["hbm_high_water_bytes"] <= budget < full,
            f"pod budget {budget}: {ps.hbm}")
    want = quiet(base.solve)
    got = quiet(ps.solve)
    require(bool(np.array_equal(got[1], want[1])),
            "pod under a budget: d2 differ from the unbounded pod's")
    rows = np.random.default_rng(31).permutation(cut.shape[0])[:2000]
    check_exact(cut, got[0], rows, 10, cKDTree(cut.astype(np.float64)))
    try:
        PodKnnProblem.prepare(cut, config=pt.KnnConfig(
            k=10, hbm_budget_bytes=max(1, high // 8)), mesh=devices)
        require(False, "pod: an undersized budget was not refused")
    except LaunchBudgetError as e:
        require(e.kind == "oom" and e.site == "pod-prepare",
                f"pod refusal kind {e.kind}, site {e.site}")
        refusal = str(e)
    plan1 = build_pod_plan(cut, 1, cfg, base.meta.dim, True)
    one = chip_floor_bytes(plan1.meta, plan1.chips[0], cfg)
    b_w = one - 1
    pa = PodKnnProblem.prepare(cut, config=pt.KnnConfig(
        k=10, hbm_budget_bytes=b_w), devices=devices)
    require(pa.meta.ndev > 1 and pa.hbm["hbm_high_water_bytes"] <= b_w,
            f"pod auto-split under {b_w}: {pa.meta.ndev} chips, {pa.hbm}")
    out = {"high_water": high, "full_cloud": full, "budget": budget,
           "streamed_high_water": ps.hbm["hbm_high_water_bytes"],
           "refused_at": max(1, high // 8), "one_chip_floor": one,
           "widen_budget": b_w, "widened_to": pa.meta.ndev,
           "widened_high_water": pa.hbm["hbm_high_water_bytes"]}
    print(f"  pod budget on {POD_BUDGET_N:,} points: {json.dumps(out)}; "
          f"streamed prepare exact; refusal: {refusal[:120]}...",
          flush=True)
    return out


def pod_phase(reuse: dict) -> dict:
    """Phase 10c: the pod (``pod/``) on phase 10b's 10M cloud over four
    chips: the plan against the JAX package's integers, solves, the
    exchange's bytes, memory against the models, rows against the
    single-device solve, 1M queries, card = CPU, the MXU tier and the
    budget cases."""
    import torch

    import cuda_knearests_tpu_torch as pt

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    pts, tree = reuse["pts"], reuse["tree"]
    devices = pod_devices()
    main = pod_main(pts, pt.KnnConfig(k=10), devices, tree, reuse["single"])
    queries = pod_queries(main["pp"], reuse["queries"],
                          reuse["query_single"], tree, pts)
    phase("the mutating pod: PodOverlay on the 10M pod")
    overlay = reshard_overlay(main.pop("pp"), reuse)
    torch.cuda.empty_cache()
    card_cpu_s = pod_card_equals_cpu(pts)
    mxu = pod_mxu(pts, devices)
    budget = pod_budget(pts, devices)
    took = time.perf_counter() - t_phase
    print(f"  pod phase: {took:.1f} s", flush=True)
    return {"main": main, "queries": queries, "card_equals_cpu_s": card_cpu_s,
            "mxu": mxu, "budget": budget, "overlay": overlay,
            "phase_s": took}


# -- phase 10d: the mutating pod and the elastic index -------------------------

RESHARD_DELETES = 100_000
RESHARD_BATCHES = 10
RESHARD_INSERTS = 512
ELASTIC_N = 1_000_000
ELASTIC_INSERTS = 200_000
ELASTIC_WARM = (1, 4, 16, 64)
ELASTIC_CHUNK = 8192
ELASTIC_BATCH = 64


def hotspot(seed: int, n: int) -> np.ndarray:
    """The reference bench's insert hotspot: n points in [5, 115]^3."""
    rng = np.random.default_rng(seed)
    return (rng.random((n, 3)) * 110.0 + 5.0).astype(np.float32)


def alive_reference(tree, pts: np.ndarray, q: np.ndarray, k: int,
                    dead: np.ndarray, own=None, extra=None) -> tuple:
    """Exact (f64) squared distances and stable ids of the k nearest alive
    points of each query: the kd-tree over the original cloud ``pts``,
    asked wide enough to pass over the ids ``dead`` marks (and ``own``,
    each row's own id), merged with ``extra`` = (stable ids, coordinates)
    by brute force."""
    q64 = q.astype(np.float64)
    kk = k + 9
    while True:
        _, ik = tree.query(q64, k=kk, workers=-1)
        ok = ~dead[ik]
        if own is not None:
            ok &= ik != own[:, None]
        if (ok.sum(axis=1) >= k).all():
            break
        kk *= 2
    ik = np.take_along_axis(ik, np.argsort(~ok, axis=1, kind="stable")[:, :k],
                            axis=1)
    coords = pts
    if extra is not None:
        e_ids, e_pts = extra
        near = np.empty((q.shape[0], k), np.int64)
        for r0 in range(0, q.shape[0], 8192):
            d = ((e_pts.astype(np.float64)[None]
                  - q64[r0:r0 + 8192, None, :]) ** 2).sum(-1)
            near[r0:r0 + 8192] = e_ids[np.argpartition(d, k - 1,
                                                       axis=1)[:, :k]]
        ik = np.concatenate([ik, near], axis=1)
        coords = np.concatenate([pts, e_pts])
    dk = ((coords[ik].astype(np.float64) - q64[:, None, :]) ** 2).sum(-1)
    order = np.argsort(dk, axis=1, kind="stable")[:, :k]
    return (np.take_along_axis(dk, order, axis=1),
            np.take_along_axis(ik, order, axis=1))


def bulk_rows_exact(what: str, coords: np.ndarray, ids: np.ndarray,
                    q: np.ndarray, dk: np.ndarray, ik: np.ndarray) -> None:
    """``check_rows_exact`` over many rows at once: every id valid and
    unique in its row, the distances it realizes equal to the reference's
    as multisets, and every reference neighbour strictly inside the k-th
    distance's band present."""
    for r0 in range(0, ids.shape[0], 100_000):
        i, d_k, i_k = (a[r0:r0 + 100_000] for a in (ids, dk, ik))
        require(bool((i >= 0).all()), f"{what}: a row has missing "
                                      f"neighbours")
        require(not bool((np.diff(np.sort(i, axis=1), axis=1) == 0).any()),
                f"{what}: a row repeats a neighbour")
        dp = ((coords[i].astype(np.float64)
               - q[r0:r0 + 100_000, None, :].astype(np.float64)) ** 2).sum(-1)
        require(bool(np.allclose(np.sort(dp, axis=1), d_k, rtol=RTOL,
                                 atol=ATOL)),
                f"{what}: rows disagree with the reference's distances")
        must = d_k < d_k[:, -1:] - (ATOL + RTOL * d_k[:, -1:])
        present = (i_k[:, :, None] == i[:, None, :]).any(axis=-1)
        require(not bool((must & ~present).any()),
                f"{what}: a row misses a reference neighbour")


def overlay_solve(ov, what: str) -> tuple:
    """One ``PodOverlay.solve`` split by the engine's spans: the pod solve
    (chip solves, fetch, placement, kd-tree fallback), the tombstone
    filter, the pruning bound, the brute call (stage, launch and its
    fetch) and the merge.  At most 2 host round trips."""
    from cuda_knearests_tpu_torch.obs import spans
    from cuda_knearests_tpu_torch.runtime import dispatch

    dispatch.reset_stats()
    with spans.capture() as events:
        t0 = time.perf_counter()
        res = ov.solve()
        total = (time.perf_counter() - t0) * 1e3
    syncs = dispatch.stats().host_syncs
    require(syncs <= 2, f"{what}: {syncs} host round trips")
    split = {"total_ms": total}
    for e in events:
        key = e["name"].rsplit(".", 1)[-1] + "_ms"
        split[key] = split.get(key, 0.0) + e["dur_ms"]
    split["other_ms"] = total - sum(v for key, v in split.items()
                                    if key != "total_ms")
    print(f"    {what}: {total:.3f} ms, {syncs} host round trips = "
          + ", ".join(f"{key[:-3]} {v:.3f}" for key, v in split.items()
                      if key != "total_ms"), flush=True)
    return res, split


def overlay_deletes(ov, ids: np.ndarray) -> list:
    """The deletes in RESHARD_BATCHES batches, each timed to a synchronize
    and split into its restage and re-exchange (each also timed to a
    synchronize): 0 host round trips, at most 2 * ndev stages, and
    POD_HALO_BYTES of ici bytes per re-exchange."""
    from cuda_knearests_tpu_torch.runtime import dispatch

    pp = ov.pp
    times = {}

    def timed(name, fn):
        def run(*args):
            sync_chips(pp)
            t0 = time.perf_counter()
            fn(*args)
            sync_chips(pp)
            times[name] = times.get(name, 0.0) \
                + (time.perf_counter() - t0) * 1e3
        return run

    ov._restage = timed("restage", ov._restage)
    ov._reexchange = timed("reexchange", ov._reexchange)
    stages = []
    real_stage = dispatch.stage

    def counted(array, device):
        stages.append(device)
        return real_stage(array, device)

    dispatch.stage = counted
    out = []
    try:
        for batch in np.array_split(ids, RESHARD_BATCHES):
            times.clear()
            stages.clear()
            before = dict(ov.stats)
            dispatch.reset_stats()
            sync_chips(pp)
            t0 = time.perf_counter()
            ov.delete(batch)
            sync_chips(pp)
            total = (time.perf_counter() - t0) * 1e3
            st = dispatch.stats()
            again = ov.stats["reexchanges"] - before["reexchanges"]
            require(st.host_syncs == 0 and len(stages) <= 2 * pp.meta.ndev
                    and st.ici_bytes == again * POD_HALO_BYTES,
                    f"pod delete: {st.host_syncs} host round trips, "
                    f"{len(stages)} stages, {st.ici_bytes} ici bytes for "
                    f"{again} re-exchanges")
            out.append({
                "ms": total, "restage_ms": times.get("restage", 0.0),
                "reexchange_ms": times.get("reexchange", 0.0),
                "restaged_chips": ov.stats["restaged_chips"]
                - before["restaged_chips"],
                "reexchanges": again, "skips": ov.stats["reexchanges_skipped"]
                - before["reexchanges_skipped"], "stages": len(stages),
                "ici_bytes": st.ici_bytes})
    finally:
        dispatch.stage = real_stage
        del ov._restage, ov._reexchange
    return out


def reshard_overlay(pp, reuse: dict) -> dict:
    """Phase 10d (a): ``PodOverlay`` on phase 10c's 10M pod.  RESHARD_DELETES
    base ids deleted in batches (restage, re-exchange, skips; 0 host round
    trips each), an all-points solve (deleted rows invalid, no live row
    holding a deleted id, SAMPLE_ROWS live rows exact against the kd-tree
    over the mutated cloud), RESHARD_INSERTS hotspot inserts, the 1M
    queries of phase 10c (every row exact), and one more all-points solve
    split into its pieces.  Returns its numbers and its class-kernel
    launches (supercell_topk mode (a))."""
    from cuda_knearests_tpu_torch.ops import cuda_solve as cs
    from cuda_knearests_tpu_torch.pod import PodOverlay
    from cuda_knearests_tpu_torch.runtime import dispatch

    t_phase = time.perf_counter()
    pts, tree, queries = reuse["pts"], reuse["tree"], reuse["queries"]
    n, k = pts.shape[0], pp.config.k
    cs.launches = cs.blocked_launches = cs.launches_b = 0
    cs.blocked_launches_b = 0
    ov = PodOverlay(pp)
    ids = np.random.default_rng(170).choice(n, RESHARD_DELETES,
                                            replace=False)
    batches = overlay_deletes(ov, ids)
    print(f"  pod overlay, {n:,} points, k={k}: {RESHARD_DELETES:,} deletes in "
          f"{RESHARD_BATCHES} batches (ms: total / restage / re-exchange): "
          + "; ".join(f"{b['ms']:.3f} / {b['restage_ms']:.3f} / "
                      f"{b['reexchange_ms']:.3f}" for b in batches)
          + f"\n    per batch {batches[0]['restaged_chips']} chips restaged, "
          f"{sum(b['reexchanges'] for b in batches)} re-exchanges of "
          f"{POD_HALO_BYTES:,} bytes, {sum(b['skips'] for b in batches)} "
          f"skipped, at most {max(b['stages'] for b in batches)} stages, 0 "
          f"host round trips", flush=True)
    dead = np.zeros((n + RESHARD_INSERTS,), bool)
    dead[ids] = True
    (nb, d2, cert), solve_del = overlay_solve(ov, "solve after the deletes")
    require(bool((nb[ids] == -1).all() and np.isinf(d2[ids]).all()
                  and not cert[ids].any()),
            "pod overlay: a deleted row is not (-1, inf, uncertified)")
    require(not bool(dead[np.clip(nb, 0, None)][nb >= 0].any()),
            "pod overlay: a live row holds a deleted id")
    live = np.nonzero(~dead[:n])[0]
    rows = np.sort(np.random.default_rng(171).choice(live, SAMPLE_ROWS,
                                                     replace=False))
    dk, ik = alive_reference(tree, pts, pts[rows], k, dead, own=rows)
    bulk_rows_exact("pod overlay solve", pts, nb[rows], pts[rows], dk, ik)

    ins = hotspot(29, RESHARD_INSERTS)
    new_ids = ov.insert(ins)
    coords = np.concatenate([pts, ins])
    extra = (new_ids.astype(np.int64), ins)
    dispatch.reset_stats()
    t0 = time.perf_counter()
    qi, qd = ov.query(queries)
    query_ms = (time.perf_counter() - t0) * 1e3
    q_syncs = dispatch.stats().host_syncs
    require(q_syncs <= 2, f"pod overlay query: {q_syncs} host round trips")
    dk, ik = alive_reference(tree, pts, queries, k, dead, extra=extra)
    bulk_rows_exact("pod overlay queries", coords, qi, queries, dk, ik)
    hits = int((qi >= n).any(axis=1).sum())
    print(f"    {RESHARD_INSERTS} hotspot inserts; {queries.shape[0]:,} "
          f"queries in {query_ms:.3f} ms ({q_syncs} host round trips), "
          f"every row exact against cKDTree over the mutated cloud "
          f"({hits:,} rows hold an insert)", flush=True)
    (nb, d2, cert), solve_ins = overlay_solve(ov, "solve after the inserts")
    require(bool((nb[ids] == -1).all()) and not bool(
        dead[np.clip(nb, 0, None)][nb >= 0].any()),
        "pod overlay: deleted ids after the inserts")
    dk, ik = alive_reference(tree, pts, pts[rows], k, dead, own=rows,
                             extra=extra)
    bulk_rows_exact("pod overlay solve with inserts", coords, nb[rows],
                    pts[rows], dk, ik)
    launches = cs.launches - cs.launches_b
    require(launches > 0 and cs.blocked_launches == 0,
            f"pod overlay: {launches} mode (a) launches, "
            f"{cs.blocked_launches} blocked")
    took = time.perf_counter() - t_phase
    print(f"    exact against cKDTree on {rows.size:,} sampled rows of "
          f"both solves; counters {json.dumps(ov.stats_dict())}; "
          f"supercell_topk mode (a) launches {launches}; phase {took:.1f} s",
          flush=True)
    return {"deletes": batches, "solve_after_deletes": solve_del,
            "query_ms": query_ms, "query_syncs": q_syncs,
            "solve_after_inserts": solve_ins, "stats": ov.stats_dict(),
            "launches": launches, "phase_s": took}


def hotspot_kernel_check(el) -> dict:
    """``supercell_topk`` against its plain version at the elastic index's
    largest legacy caps: the densest supercell of the shard pack with the
    most candidate slots, at its full qcap and ccap, both modes, bit for
    bit; the kernel's mode (a) ms (CUDA events) and the plain version's."""
    import torch

    from cuda_knearests_tpu_torch.ops import cuda_solve as cs

    pack = max((s.overlay.base.pack for s in el.shards),
               key=lambda p: p.ccap)
    pk = pack.pk
    sc = int((pk.cid != cs._PAD_C).sum(dim=1).argmax())
    args = tuple(a[sc:sc + 1].contiguous() for a in pk.args())
    qid = args[3].reshape(-1)
    lanes = torch.arange(qid.numel(), dtype=torch.int32, device=qid.device)
    tgt = torch.where(qid >= 0, lanes, qid.numel()).to(torch.int32)
    n_rows, k = qid.numel(), el.k
    err = compare_modes(f"elastic hotspot shard, supercell {sc}", args, tgt,
                        n_rows, k, True)
    out = row_buffers(n_rows, k)
    ms = quiet(lambda: cuda_ms(lambda: cs.supercell_topk(
        *args, k, True, tgt=tgt, out=out), 3))
    plain_ms = cuda_ms(lambda: cs.supercell_topk_plain(
        *args, k, True, tgt=tgt, out=out), 1)
    real_q, real_c = int((qid >= 0).sum()), int((args[7] != cs._PAD_C).sum())
    print(f"    at qcap {pack.qcap:,}, ccap {pack.ccap:,} ({real_q:,} real "
          f"queries, {real_c:,} real candidates): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, max_abs_err {err}", flush=True)
    return {"qcap": pack.qcap, "ccap": pack.ccap, "real_queries": real_q,
            "real_candidates": real_c, "ms": ms, "plain_ms": plain_ms,
            "max_abs_err": err}


def elastic_phase() -> dict:
    """Phase 10d (b): ``ElasticIndex`` on the card at ``ServeFleetConfig``'s
    defaults (two shards, compaction at 512, skew threshold 3.0) over
    ELASTIC_N uniform points, k=10: the batch shapes warmed,
    ELASTIC_INSERTS hotspot inserts, ``force_rebalance`` and pumps to the
    handover with a 64-row query between pumps, each equal to the rebuild
    oracle byte for byte and exact against the kd-tree over the mutated
    cloud, as is a batch inside the hotspot at the first pump and after
    the handover; the kernel against its plain version at the hotspot
    shard's caps; 0 kernel builds or loads outside the index's attributed
    maintenance."""
    import torch
    from scipy.spatial import cKDTree

    from cuda_knearests_tpu_torch.io import generate_uniform
    from cuda_knearests_tpu_torch.ops import cuda_solve as cs
    from cuda_knearests_tpu_torch.pod import ElasticIndex
    from cuda_knearests_tpu_torch.pod.reshard import _kernel_recompiles

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cs.launches = cs.blocked_launches = cs.launches_b = 0
    cs.blocked_launches_b = 0
    t0 = time.perf_counter()
    el = ElasticIndex(generate_uniform(ELASTIC_N, seed=17), k=10, nshards=2,
                      compact_threshold=512, skew_threshold=3.0,
                      migration_chunk=ELASTIC_CHUNK)
    build_s = time.perf_counter() - t0
    for m in ELASTIC_WARM:
        el.query(np.zeros((m, 3), np.float32), 10)
    r0, a0 = _kernel_recompiles(), el.elastic_recompiles
    t0 = time.perf_counter()
    el.insert(hotspot(31, ELASTIC_INSERTS))
    insert_s = time.perf_counter() - t0
    pops = [s.n_points for s in el.shards]
    hot = hotspot_kernel_check(el)
    t0 = time.perf_counter()
    cloud = el.mutated_points()
    tree = cKDTree(cloud.astype(np.float64))
    dead = np.zeros((cloud.shape[0],), bool)
    tree_s = time.perf_counter() - t0
    q = (np.random.default_rng(6).random((ELASTIC_BATCH, 3)) * 980.0
         + 10.0).astype(np.float32)
    q_hot = hotspot(7, ELASTIC_BATCH)

    def exact(what, queries, ids):
        dk, ik = alive_reference(tree, cloud, queries, 10, dead)
        bulk_rows_exact(f"elastic: {what}", cloud, ids, queries, dk, ik)

    rewarm_ms = []
    rewarm = el._rewarm

    def timed_rewarm():
        t1 = time.perf_counter()
        rewarm()
        rewarm_ms.append((time.perf_counter() - t1) * 1e3)

    el._rewarm = timed_rewarm
    require(el.force_rebalance(), "elastic: force_rebalance started nothing")
    mig = el.migration
    query_ms, pump_ms, info, pumps = [], [], None, 0
    try:
        while True:
            t0 = time.perf_counter()
            got = el.query(q, 10)
            query_ms.append((time.perf_counter() - t0) * 1e3)
            want = quiet(lambda: el.rebuild_oracle_query(q, 10))
            require(all(np.array_equal(a, b) for a, b in zip(got, want)),
                    f"elastic: pump {pumps} answers differ from the rebuild "
                    f"oracle")
            exact(f"pump {pumps}", q, got[0])
            if pumps == 0 or info is not None:
                exact(f"hotspot batch at pump {pumps}", q_hot,
                      el.query(q_hot, 10)[0])
            if info is not None:
                break
            t0 = time.perf_counter()
            info = el.pump()
            pump_ms.append((time.perf_counter() - t0) * 1e3)
            pumps += 1
            require(pumps < 1000, "elastic: the migration never handed over")
    finally:
        del el._rewarm
    require(np.array_equal(el.mutated_points(), cloud),
            "elastic: the migration changed the canonical cloud")
    outside = (_kernel_recompiles() - r0) - (el.elastic_recompiles - a0)
    require(outside == 0 and el.migrations_done == 1,
            f"elastic: {outside} kernel builds or loads outside the "
            f"attributed work")
    launches = cs.launches - cs.launches_b
    require(launches > 0, "elastic: no supercell_topk launch")
    took = time.perf_counter() - t_phase
    out = {"build_s": build_s, "insert_s": insert_s, "tree_s": tree_s,
           "hotspot_kernel": hot, "rewarm_ms": rewarm_ms[-1],
           "populations_before": pops, "moving": len(mig.queue),
           "pumps": pumps, "records": info["records"], "handover": info,
           "query_ms_median": float(np.median(query_ms)),
           "query_ms_max": float(np.max(query_ms)),
           "handover_ms": pump_ms[-1],
           "pump_ms_median": float(np.median(pump_ms[:-1])),
           "elastic_recompiles": el.elastic_recompiles,
           "recompiles_outside": outside,
           "populations_after": [s.n_points for s in el.shards],
           "launches": launches, "phase_s": took}
    print(f"  elastic index, {ELASTIC_N:,} points, k=10, 2 shards: built in "
          f"{build_s:.3f} s, {ELASTIC_INSERTS:,} hotspot inserts in "
          f"{insert_s:.3f} s -> {pops}; migration of {out['moving']:,} "
          f"points: {pumps} pumps, {out['records']} records, query ms "
          f"median {out['query_ms_median']:.3f} max "
          f"{out['query_ms_max']:.3f}, pump ms median "
          f"{out['pump_ms_median']:.3f}, handover (compaction and rewarm) "
          f"{out['handover_ms']:.3f} ms, of which rewarm "
          f"{out['rewarm_ms']:.3f} ms -> {out['populations_after']}; "
          f"every pump's batch equal to the rebuild oracle byte for byte "
          f"and exact against cKDTree over the mutated cloud (tree "
          f"{tree_s:.3f} s), the hotspot batch at the first pump and after "
          f"the handover too; "
          f"elastic_recompiles {el.elastic_recompiles}, {outside} outside; "
          f"supercell_topk mode (a) launches {launches}; phase {took:.1f} s",
          flush=True)
    return out


FUZZ_CASES = 48
FUZZ_SUPERVISED = 6
FUZZ_APPROX = 12
FUZZ_FOF = 8
FUZZ_MUTATIONS = 4
FUZZ_POD = 8
FUZZ_POD_CHIPS = 4
# Gate-refused k on zoo clouds: the split selection's two arms (m = 128 at
# recall 1.0, the direct arm; m < 128 at 0.6, the pool arm) on exact ties.
FUZZ_SPLIT = (("quantized-dups", 1.0, "f32"),
              ("all-coincident", 0.6, "bf16"))
FUZZ_SPLIT_N, FUZZ_SPLIT_K = 2048, 1800


def kernel_counts() -> dict:
    """Every kernel's launch count, by the name the kernels line uses."""
    from cuda_knearests_tpu_torch.runtime.dispatch import kernel_launches

    return kernel_launches()


def zero_kernel_counts() -> None:
    from cuda_knearests_tpu_torch.mxu import kernel as mk
    from cuda_knearests_tpu_torch.ops import cuda_solve as cs

    cs.launches = cs.blocked_launches = cs.launches_b = 0
    cs.blocked_launches_b = 0
    mk.launches = mk.launches_bf16 = mk.split_launches = 0
    mk.prep_launches = mk.prep_launches_f32 = 0


def fuzz_zoo_rows(n_cases: int) -> dict:
    """Phase 12 (a), second half: every zoo case through the four routes
    and ``campaign.CARD_CONFIGS`` on the card and on the CPU
    (``campaign.check_card_rows``): card rows exact against the kd-tree
    (tie-aware) and equal to the CPU's bit for bit."""
    from cuda_knearests_tpu_torch.fuzz.campaign import check_card_rows
    from cuda_knearests_tpu_torch.fuzz.generators import draw_cases

    t0 = time.perf_counter()
    checked, problems = 0, []
    for spec in draw_cases(n_cases, 0):
        runs, bad = check_card_rows(spec, DEV)
        checked += runs
        problems += bad
    require(not problems, f"fuzz zoo rows: {len(problems)} disagreements, "
                          f"first {problems[:3]}")
    return {"cases": n_cases, "runs": checked,
            "s": time.perf_counter() - t0}


def fuzz_drill(scratch: str) -> dict:
    """Phase 12 (b), the abort drill: one supervised worker is SIGKILLed
    (``KNTPU_FAULT=abort:<label>``); its case must come back banked as a
    'crash' with the worker's flight-recorder tail, and the next case runs
    on a fresh worker of the same supervisor."""
    from cuda_knearests_tpu_torch.fuzz.campaign import _run_one
    from cuda_knearests_tpu_torch.fuzz.generators import draw_cases
    from cuda_knearests_tpu_torch.fuzz.routes import ROUTE_NAMES
    from cuda_knearests_tpu_torch.runtime.supervisor import Supervisor

    killed, after = draw_cases(2, 1)
    bank = os.path.join(scratch, "drill")
    sup = Supervisor(timeout_s=240)
    t0 = time.perf_counter()
    os.environ["KNTPU_FAULT"] = f"abort:{killed.case_id()}"
    try:
        out = _run_one(killed, ROUTE_NAMES, bank, True, 2, sup, DEV)
    finally:
        del os.environ["KNTPU_FAULT"]
    record = sup.quarantined.get(killed.case_id())
    require(len(out) == 1 and out[0].kind == "crash" and record is not None
            and record.signal == 9, f"abort drill: {out}")
    require(bool(out[0].banked) and out[0].banked.startswith(bank)
            and os.path.exists(out[0].banked),
            f"abort drill: the killed case was not banked ({out[0]})")
    require(len(record.flight_tail) > 0,
            "abort drill: the killed worker left no flight-recorder tail")
    require(_run_one(after, ROUTE_NAMES, bank, True, 2, sup, DEV) == [],
            "abort drill: the next case failed")
    return {"killed": killed.case_id(), "kind": out[0].kind,
            "banked": os.path.basename(out[0].banked),
            "flight_tail": [e["name"] for e in record.flight_tail],
            "next": after.case_id(), "s": time.perf_counter() - t0}


def fuzz_faults(scratch: str) -> dict:
    """Phase 12 (d): the seeded faults on the card, each a minimized
    failure banked under ``scratch`` (never in ``tests/corpus*``); under
    ``KNTPU_MXU_FAULT`` the selection runs its plain version, so no
    selection kernel launches."""
    from cuda_knearests_tpu_torch.fuzz import approx, campaign
    from cuda_knearests_tpu_torch.fuzz.generators import CaseSpec

    out = {}
    bank = os.path.join(scratch, "faults")
    os.environ["KNTPU_FUZZ_FAULT"] = "drop-neighbor"
    try:
        got = campaign.run_case(CaseSpec("uniform", 77, 33, 4),
                                routes=("adaptive",), bank_dir=bank,
                                max_probes=16, device=DEV)
    finally:
        del os.environ["KNTPU_FUZZ_FAULT"]
    require(len(got) == 1 and got[0].kind == "mismatch"
            and got[0].minimized_n < got[0].original_n,
            f"KNTPU_FUZZ_FAULT=drop-neighbor not detected: {got}")
    out["drop-neighbor"] = got[0]
    before = kernel_counts()
    os.environ["KNTPU_MXU_FAULT"] = "drop-block"
    try:
        f = approx.run_approx_case(
            approx.ApproxCaseSpec("block-aliased", 3, 2048, 10, 0.6),
            bank_dir=bank, max_probes=8, device=DEV)
    finally:
        del os.environ["KNTPU_MXU_FAULT"]
    require(f is not None and f.kind == "certified-unsound",
            f"KNTPU_MXU_FAULT=drop-block not detected: {f}")
    require(kernel_counts() == before,
            "KNTPU_MXU_FAULT: a selection kernel launched under the fault")
    out["drop-block"] = f
    corpora = [os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", d) for d in ("corpus", "corpus_torch")]
    for name, fail in out.items():
        require(bool(fail.banked) and fail.banked.startswith(bank)
                and os.path.exists(fail.banked)
                and not any(fail.banked.startswith(c) for c in corpora),
                f"{name}: banked at {fail.banked}")
    return {name: {"kind": fail.kind, "original_n": fail.original_n,
                   "minimized_n": fail.minimized_n,
                   "banked": os.path.basename(fail.banked)}
            for name, fail in out.items()}


def fuzz_phase() -> dict:
    """Phase 12: the fuzz campaigns on the card (``fuzz/``), with every
    kernel's launches counted from 0 over the phase (in this process; a
    supervised worker's launches are its own)."""
    import tempfile

    from cuda_knearests_tpu_torch import fuzz
    from cuda_knearests_tpu_torch.fuzz import (approx, campaign, fof,
                                               mutation, pod)
    from cuda_knearests_tpu_torch.fuzz.generators import (CaseSpec,
                                                          generate_case)

    t_phase = time.perf_counter()
    scratch = tempfile.mkdtemp(prefix="chip-smoke-fuzz-")
    saved_env = {k: os.environ.get(k) for k in ("BENCH_ROW_TIMEOUT_S",
                                                "KNTPU_FAILURE_DIR")}
    os.environ["BENCH_ROW_TIMEOUT_S"] = "240"
    os.environ["KNTPU_FAILURE_DIR"] = scratch
    zero_kernel_counts()
    out, flavors = {}, {}

    def flavor(name: str, manifest: dict, cases: int) -> None:
        require(manifest["ok"] and manifest["completed_cases"] == cases,
                f"fuzz {name}: {manifest['failures'][:2]} "
                f"({manifest['completed_cases']}/{cases} cases)")
        flavors[name] = {"cases": manifest["completed_cases"],
                         "failures": len(manifest["failures"]),
                         "s": manifest["elapsed_s"]}
        print(f"  fuzz {name}: {manifest['completed_cases']} cases, "
              f"{len(manifest['failures'])} failures, "
              f"{manifest['elapsed_s']:.3f} s", flush=True)

    def bank(name: str) -> str:
        return os.path.join(scratch, name)

    try:
        # (a) the point campaign in-process, then card = CPU on its cases
        flavor("point", campaign.run_campaign(
            n_cases=FUZZ_CASES, isolation="none", bank_dir=bank("point"),
            log=None, device=DEV), FUZZ_CASES)
        out["zoo_rows"] = fuzz_zoo_rows(FUZZ_CASES)
        print(f"  fuzz zoo rows: {out['zoo_rows']['runs']} route runs of "
              f"{FUZZ_CASES} cases exact and card = CPU bit for bit "
              f"(routes {', '.join(r for r, _ in campaign.CARD_CONFIGS)}"
              f" too), "
              f"{out['zoo_rows']['s']:.3f} s", flush=True)
        # (b) supervised cases, then the abort drill
        m = campaign.run_campaign(
            n_cases=FUZZ_SUPERVISED, isolation="case",
            bank_dir=bank("supervised"), log=None, device=DEV)
        require(m["isolation"] == "case", "fuzz: isolation did not resolve "
                                          "to 'case' on the card")
        flavor("supervised", m, FUZZ_SUPERVISED)
        out["supervised_case_s"] = m["elapsed_s"] / FUZZ_SUPERVISED
        out["drill"] = fuzz_drill(scratch)
        print(f"  fuzz supervised: {out['supervised_case_s']:.3f} s a case "
              f"(spawn, torch import, CUDA init, kernel load, 4 routes); "
              f"abort drill: {json.dumps(out['drill'])}", flush=True)
        # (c) the other flavors
        before = kernel_counts()
        flavor("approx", approx.run_approx_campaign(
            n_cases=FUZZ_APPROX, bank_dir=bank("approx"), log=None,
            device=DEV), FUZZ_APPROX)
        t0 = time.perf_counter()
        for generator, rt, precision in FUZZ_SPLIT:
            spec = CaseSpec(generator, 18, FUZZ_SPLIT_N, FUZZ_SPLIT_K)
            got = approx._approx_failure(generate_case(spec), FUZZ_SPLIT_K,
                                         rt, precision=precision, device=DEV)
            require(got is None, f"fuzz split {generator} at {rt} "
                                 f"{precision}: {got}")
        sel = {k: kernel_counts()[k] - before[k]
               for k in ("mxu_select", "mxu_select_bf16",
                         "mxu_select_split")}
        require(all(v > 0 for v in sel.values()),
                f"fuzz approx: a selection kernel never launched {sel}")
        out["approx_launches"] = sel
        print(f"  fuzz approx selections launched {json.dumps(sel)}; "
              f"split cases (k={FUZZ_SPLIT_K}, n={FUZZ_SPLIT_N}) exact "
              f"in {time.perf_counter() - t0:.3f} s", flush=True)
        flavor("fof", fof.run_fof_campaign(
            n_cases=FUZZ_FOF, bank_dir=bank("fof"), log=None, device=DEV),
            FUZZ_FOF)
        flavor("mutation", mutation.run_mutation_campaign(
            n_cases=FUZZ_MUTATIONS, bank_dir=bank("mutation"), log=None,
            device=DEV), FUZZ_MUTATIONS)
        flavor("pod", pod.run_pod_campaign(
            n_cases=FUZZ_POD, ndev=FUZZ_POD_CHIPS, bank_dir=bank("pod"),
            log=None, device=DEV), FUZZ_POD)
        # (d) the seeded faults
        out["faults"] = fuzz_faults(scratch)
        print(f"  fuzz seeded faults: {json.dumps(out['faults'])}",
              flush=True)
        # (e) both corpora replay clean
        replayed = 0
        for d in (fuzz.REFERENCE_CORPUS_DIR, fuzz.CORPUS_DIR):
            for name in sorted(os.listdir(d)):
                if name.endswith(".npz"):
                    got = campaign.replay_banked(os.path.join(d, name),
                                                 device=DEV)
                    require(got is None, f"corpus {name} regressed: {got}")
                    replayed += 1
        out["corpus_replayed"] = replayed
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        # the banked cases, flight and stall files were read above
        shutil.rmtree(scratch, ignore_errors=True)
    out["flavors"] = flavors
    out["launches"] = kernel_counts()
    require(all(v > 0 for v in out["launches"].values()),
            f"fuzz: a kernel never launched in the phase {out['launches']}")
    out["s"] = time.perf_counter() - t_phase
    print(f"  fuzz corpus: {replayed} banked cases replayed clean; kernel "
          f"launches in the phase {json.dumps(out['launches'])}; phase "
          f"{out['s']:.1f} s", flush=True)
    return out


FLEET_N = 1_000_000
FLEET_K = 10
FLEET_REQS = 80              # the reference's fleet_4tenant_mix row
FLEET_MUT_REQS = 60
FLEET_PROBE = 256
AUTOSCALE_K = 8
AUTOSCALE_REQS = 240         # the reference's diurnal_autoscale row
AUTOSCALE_RATE = 3600.0
POD_TENANT_REQS = 60
FLEET_CPU_N = 6000


class CapturedFleet:
    """Records every response a fleet returns, and each request's
    (tenant, kind, payload), around ``run_fleet_session``."""

    def __init__(self, fleet):
        self.fleet = fleet
        self.requests, self.responses = {}, []
        submit, poll, drain = fleet.submit, fleet.poll, fleet.drain

        def sub(req_id, tenant, kind, payload, *a, **kw):
            self.requests[req_id] = (tenant, kind, payload)
            return self._keep(submit(req_id, tenant, kind, payload, *a,
                                     **kw))
        fleet.submit = sub
        fleet.poll = lambda *a, **kw: self._keep(poll(*a, **kw))
        fleet.drain = lambda *a, **kw: self._keep(drain(*a, **kw))

    def _keep(self, rs):
        self.responses.extend(rs)
        return rs

    def query_rows(self, tenant: str, tiers=(None,)):
        """(queries, ids, d2) of the tenant's answered query requests
        served at one of ``tiers`` (None = exact, else the brownout
        rung's wire name), stacked; None if there are none."""
        qs, ids, d2 = [], [], []
        for r in self.responses:
            if (r.ok and r.ids is not None and r.tenant == tenant
                    and r.degraded in tiers):
                qs.append(self.requests[r.req_id][2])
                ids.append(r.ids)
                d2.append(r.d2)
        if not qs:
            return None
        return np.concatenate(qs), np.concatenate(ids), np.concatenate(d2)


def launches_since(before: dict) -> dict:
    now = kernel_counts()
    return {k: now[k] - before[k] for k in now if now[k] - before[k]}


def restart_counts(total: dict) -> None:
    """Add every kernel's launch count so far into ``total``, then set
    the counts to 0: a path's launches are then read from 0."""
    for key, v in kernel_counts().items():
        total[key] = total.get(key, 0) + v
    zero_kernel_counts()


def session_line(name: str, s: dict) -> str:
    per = {t: {key: pt[key] for key in ("p50_ms", "p99_ms", "p999_ms",
                                        "completion", "slo_ok")}
           for t, pt in s["per_tenant"].items()}
    return (f"  fleet {name}: {s['completed_queries']} queries in "
            f"{s['elapsed_s']:.3f} s = {s['sustained_qps']} q/s, "
            f"{s['fleet_batches']} batches, failed {s['failed_requests']}, "
            f"refused {s['refused_requests']}, recompiles "
            f"{s['recompiles']}, jain {s['jain_fairness']}, host_syncs "
            f"{s['host_syncs']}, d2h {s['d2h_bytes']} B, h2d "
            f"{s['h2d_bytes']} B; per tenant {json.dumps(per)}")


def recall_rows(what: str, pts: np.ndarray, q: np.ndarray, ids, d2,
                dk: np.ndarray) -> np.ndarray:
    """Rows of the certified-approximate rung against the exact k-th
    distances ``dk`` (squared): valid unique ids, each d2 the realized
    distance of its id, ascending.  Returns each row's hits: its ids
    within the k-th reference distance's tolerance band."""
    require(bool((ids >= 0).all()), f"{what}: a row has missing neighbours")
    srt = np.sort(ids, axis=1)
    require(not bool((np.diff(srt, axis=1) == 0).any()),
            f"{what}: a row repeats a neighbour")
    dp = ((pts[ids].astype(np.float64) - q[:, None, :].astype(np.float64))
          ** 2).sum(-1)
    require(bool(np.allclose(dp, d2, rtol=RTOL, atol=ATOL))
            and not bool((np.diff(d2, axis=1) < 0).any()),
            f"{what}: a row's d2 is not its ids' distances, ascending")
    kth = dk[:, -1:]
    return (dp <= kth + ATOL + RTOL * kth).sum(axis=1)


def fleet_rows_exact(name: str, cap, fleet, trees: dict,
                     recall_target: float = 1.0) -> dict:
    """Every ok query row of every tenant (dense, pod, sidecar) against
    cKDTree of the tenant's current cloud: rows served exact or at the
    bf16 rung (which refines to exact) tie-aware exact; rows of the
    lowered-recall rung valid, their d2 realized, and their mean recall
    at least ``recall_target`` less three standard errors.  Returns the
    rows checked by kind."""
    from scipy.spatial import cKDTree

    out = {"exact": 0, "bf16": 0, "recall": 0, "recall_mean": None}
    hits, k_recall = [], 0
    for tname, t in fleet.tenants.items():
        for tiers in ((None, "bf16"), ("recall",)):
            got = cap.query_rows(tname, tiers)
            if got is None:
                continue
            q, ids, d2 = got
            pts = t.mutated_points()
            tree = trees.get(tname)
            if tree is None:
                tree = trees[tname] = cKDTree(pts.astype(np.float64))
            k = ids.shape[1]
            dk, ik = tree.query(q.astype(np.float64), k=k)
            dk, ik = dk.reshape(q.shape[0], -1) ** 2, ik.reshape(q.shape[0],
                                                                -1)
            if tiers == ("recall",):
                hits.append(recall_rows(f"fleet {name} tenant {tname}",
                                        pts, q, ids, d2, dk))
                k_recall = k
                out["recall"] += q.shape[0]
                continue
            check_rows_exact(pts, ids, np.arange(q.shape[0]), dk, ik,
                             queries=q)
            out["exact"] += q.shape[0]
            out["bf16"] += sum(r.ids.shape[0] for r in cap.responses
                               if r.ok and r.ids is not None
                               and r.tenant == tname
                               and r.degraded == "bf16")
    if hits:
        # the rung's target is an expected recall: the sample mean of
        # n rows x k slots may fall short of it by sampling error alone,
        # so it must reach the target less three standard errors
        out["recall_mean"] = float(np.concatenate(hits).mean() / k_recall)
        floor = recall_target - 3.0 * np.sqrt(
            recall_target * (1.0 - recall_target) / (out["recall"]
                                                      * k_recall))
        require(out["recall_mean"] >= floor,
                f"fleet {name}: the lowered-recall rung's rows reach "
                f"recall {out['recall_mean']} < {floor} (target "
                f"{recall_target} less 3 standard errors)")
    print(f"  fleet {name}: {out['exact']} served query rows exact against "
          f"cKDTree ({out['bf16']} of them at the bf16 rung); "
          f"{out['recall']} at the lowered-recall rung, mean recall "
          f"{out['recall_mean']}", flush=True)
    return out


def fleet_mixed(total: dict) -> dict:
    """Phase 10f (a) and (b): the reference's ``fleet_4tenant_mix`` fleet
    at FLEET_N (three dense tenants of 1,000,000, 1,000,000 and 1,002,048
    points, one replica each, and the 48-point sidecar tenant), k=10, on
    the card.  (a) the mixed-SLO session with the throughput tenant
    flooding: every answered row exact, 0 failed, 0 recompiles, a defined
    Jain index, class-kernel launches counted from 0 over the session;
    (b) a session with 20% mutations, after which each dense tenant's
    answers equal a rebuild of its mutated cloud byte for byte, and an
    in-process failover loses no committed mutation and answers the same
    bytes."""
    import torch

    from cuda_knearests_tpu_torch.serve.fleet import (FleetDaemon,
                                                      TenantLoad,
                                                      default_fleet_builds,
                                                      run_fleet_session)

    out = {}
    t0 = time.perf_counter()
    builds = default_fleet_builds(n_tenants=4, base_n=FLEET_N, k=FLEET_K,
                                  seed=11, replicas=1)
    fleet = FleetDaemon(builds, device=DEV)
    out["build_s"] = time.perf_counter() - t0
    print(f"  fleet build: {len(builds)} tenants "
          f"({', '.join(str(t.n_points) for t in fleet.tenants.values())}"
          f" points), prepared and warmed in {out['build_s']:.1f} s",
          flush=True)
    cap = CapturedFleet(fleet)
    loads = []
    for i, (spec, _) in enumerate(builds):
        flood = spec.slo == "throughput" \
            and not fleet.tenants[spec.name].is_sidecar
        loads.append(TenantLoad(tenant=spec.name,
                                rate=900.0 if flood else 250.0,
                                requests=FLEET_REQS * 2 if flood
                                else FLEET_REQS, seed=40 + i))
    # the main path's count: every kernel from 0 just before the session
    restart_counts(total)
    s = run_fleet_session(fleet, loads)
    out["launches"] = kernel_counts()
    print(session_line("mixed SLO", s), flush=True)
    require(s["failed_requests"] == 0 and s["recompiles"] == 0
            and s["jain_fairness"] is not None
            and s["kernel_route"] == "cuda",
            f"fleet mixed session: failed {s['failed_requests']}, "
            f"recompiles {s['recompiles']}, jain {s['jain_fairness']}")
    # the dense tenants' legacy queries resolve epilogue 'auto' to
    # 'scatter': the class kernel in mode (a)
    require(out["launches"]["supercell_topk"] > 0,
            "the dense tenants launched no class kernel")
    trees: dict = {}
    out["exact_rows"] = fleet_rows_exact("mixed SLO", cap, fleet,
                                         trees)["exact"]
    out["session"] = {key: s[key] for key in (
        "completed_queries", "elapsed_s", "sustained_qps", "fleet_batches",
        "failed_requests", "recompiles", "jain_fairness", "host_syncs",
        "d2h_bytes", "h2d_bytes", "kernel_launches", "occupancy_mean")}
    out["per_tenant"] = {t: {key: pt[key] for key in (
        "slo", "served_rows", "completion", "p50_ms", "p99_ms", "p999_ms",
        "slo_ok", "sidecar")} for t, pt in s["per_tenant"].items()}
    print(f"  fleet mixed launches {json.dumps(out['launches'])}",
          flush=True)
    # (b) mutations, then the rebuild oracle and an in-process failover
    mut_loads = [dataclasses.replace(ld, requests=FLEET_MUT_REQS,
                                     mutation_ratio=0.2, seed=ld.seed + 7)
                 if not fleet.tenants[ld.tenant].is_sidecar else ld
                 for ld in loads]
    before = kernel_counts()
    s = run_fleet_session(fleet, mut_loads)
    out["mutating_launches"] = launches_since(before)
    print(session_line("mutating (20%)", s), flush=True)
    require(s["failed_requests"] == 0,
            f"fleet mutating session: {s['failed_requests']} failed")
    probe = (np.random.default_rng(71).random((FLEET_PROBE, 3)) * 980.0
             + 10.0).astype(np.float32)
    fo = {}
    for name, t in fleet.tenants.items():
        if t.daemon is None:
            continue
        cloud = t.mutated_points().copy()
        t0 = time.perf_counter()
        rebuilt = t.daemon.overlay.base.with_points(cloud, validate=False)
        ref_i, ref_d = rebuilt.query(probe, FLEET_K)
        rebuild_s = time.perf_counter() - t0
        got_i, got_d = t.daemon.overlay.query(probe, FLEET_K)
        require(np.array_equal(got_i, ref_i) and np.array_equal(got_d, ref_d),
                f"fleet tenant {name}: overlay answers differ from the "
                f"rebuild of its mutated cloud")
        seq = t.log.committed_seq
        info = fleet.failover(name)
        promoted = t.daemon.overlay.mutated_points()
        got_i, got_d = t.daemon.overlay.query(probe, FLEET_K)
        require(np.array_equal(promoted, cloud) and info["committed_seq"]
                == seq and np.array_equal(got_i, ref_i)
                and np.array_equal(got_d, ref_d),
                f"fleet tenant {name}: failover lost a mutation or "
                f"changed an answer ({info})")
        fo[name] = {"committed_seq": seq, "replayed": info["replayed"],
                    "n_points": int(cloud.shape[0]),
                    "rebuild_s": round(rebuild_s, 3)}
        del rebuilt
    out["failover"] = fo
    print(f"  fleet mutations: each dense tenant's {FLEET_PROBE} probe "
          f"rows equal a rebuild of its mutated cloud byte for byte, "
          f"before and after an in-process failover (0 lost committed "
          f"mutations): {json.dumps(fo)}", flush=True)
    del fleet, cap, trees
    torch.cuda.empty_cache()
    return out


def fleet_failover() -> dict:
    """Phase 10f (c): ``failover_drill`` at FLEET_N with both child
    replicas on the card (three CUDA contexts on one card)."""
    import torch

    from cuda_knearests_tpu_torch.serve.fleet import failover_drill

    free, total = torch.cuda.mem_get_info()
    t0 = time.perf_counter()
    drill = failover_drill(n=FLEET_N, k=FLEET_K, ops=24, seed=7,
                           device=DEV)
    drill["s"] = time.perf_counter() - t0
    drill["free_bytes_before"] = int(free)
    print(f"  fleet failover drill: {json.dumps(drill)} (card free "
          f"{free / 2**30:.1f} of {total / 2**30:.1f} GiB before the "
          f"children)", flush=True)
    require(drill["failover_ok"] and drill["device"].startswith("cuda"),
            f"fleet process failover: {drill}")
    return drill


def degraded_split(t, k: int) -> dict:
    """Where a brownout batch's time goes on one dense tenant: the host
    concatenation of its mutated cloud, the cloud's upload alone, and a
    whole rung-1 ``solve_general`` of 64 queries (which repeats both),
    each to a synchronize; medians of 3."""
    import torch

    from cuda_knearests_tpu_torch.mxu.solve import solve_general

    q = (np.random.default_rng(12).random((64, 3)) * 980.0
         + 10.0).astype(np.float32)
    parts = {"concat_ms": [], "upload_ms": [], "solve_ms": []}
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pts = t.daemon.overlay.mutated_points()
        t1 = time.perf_counter()
        torch.as_tensor(pts).to(DEV)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        solve_general(pts, k=k, recall_target=1.0, refine="brute",
                      queries=q, scorer="mxu", precision="bf16", device=DEV)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        parts["concat_ms"].append((t1 - t0) * 1e3)
        parts["upload_ms"].append((t2 - t1) * 1e3)
        parts["solve_ms"].append((t3 - t2) * 1e3)
    return {key: float(np.median(v)) for key, v in parts.items()}


def brownout_kernel_check(first_batch: dict) -> dict:
    """``mxu_select_bf16`` against ``scorer.select_plain`` on the card on
    the inputs ``solve_general`` built for the first degraded batch of
    each brownout rung (the tenant's whole cloud, the batch's queries,
    its k and the rung's recall target), to the bf16 contract
    (``bf16_contract``), with the kernel's time (3 calls after a warm-up,
    the wrapper's two prep passes included), the plain version's, a bf16
    matmul + topk over the same pairs, and the bound (2*d operations a
    pair over the dense BF16 peak, or the bytes over the HBM rate).
    Returns the first rung's numbers, with the largest score difference
    over the rungs."""
    import torch

    from cuda_knearests_tpu_torch.mxu import kernel as mk
    from cuda_knearests_tpu_torch.mxu import scorer as ms
    from cuda_knearests_tpu_torch.mxu.solve import select_inputs
    from cuda_knearests_tpu_torch.mxu.topk import BLOCK, per_block_m

    require(bool(first_batch), "fleet autoscale: no degraded batch ran")
    rungs = {}
    for tier, (pts, queries, k, rt) in sorted(first_batch.items()):
        n, d = pts.shape
        m_q = queries.shape[0]
        m = per_block_m(rt, k, -(-n // BLOCK))
        qid, pts_il, cid_il = select_inputs(pts, m_q, False)
        q, qid_t, p, cid = [torch.as_tensor(a, device=DEV)
                            for a in (queries, qid, pts_il, cid_il)]
        what = (f"fleet brownout rung {tier}: bf16 select, {m_q} queries "
                f"x {n} points, k={k} m={m}")
        want = ms.select_plain(q, qid_t, p, cid, k, m, d, False, "bf16")
        *got, dump = quiet(lambda: mk._select_bf16_with_scores(
            q, qid_t, p, cid, k, m, d, False))
        s_plain = torch.cat([ms.score_tile(q[r0:r0 + 64], p, "bf16")
                             for r0 in range(0, m_q, 64)])
        err, ratio, _ = bf16_contract(what, got, want, dump, s_plain, cid,
                                      ms.norms(q), mk.prep_plain(p, cid)[3],
                                      d, False)
        del dump, s_plain
        kernel_ms = quiet(lambda: cuda_ms(lambda: mk.select(
            q, qid_t, p, cid, k, m, d, False, "bf16"), 3))
        plain_ms = cuda_ms(lambda: ms.select_plain(
            q, qid_t, p, cid, k, m, d, False, "bf16"), 1)
        q16, p16 = q.to(torch.bfloat16), p.to(torch.bfloat16)
        qn, pn = (q * q).sum(1), (p * p).sum(1)

        def library():
            prod = (q16 @ p16.T).float()
            torch.topk(qn[:, None] + pn[None, :] - 2.0 * prod, k, dim=1,
                        largest=False)

        library_ms = cuda_ms(library, 3)
        flops = 2 * d * m_q * n
        nbytes = (4 * m_q * d + 4 * pts_il.size + 4 * m_q + 4 * cid_il.size
                  + 8 * m_q * k + m_q)
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
        rungs[tier] = {
            "shape": f"{m_q} queries x {n} points x {d}, k={k} m={m}",
            "max_abs_err": err, "max_band_ratio": ratio, "ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        print(f"  fleet brownout kernel, rung {tier}: {json.dumps(rungs[tier])}"
              f" (within the bf16 contract against select_plain)",
              flush=True)
    out = dict(next(iter(rungs.values())))
    out["max_abs_err"] = max(r["max_abs_err"] for r in rungs.values())
    out["rungs"] = sorted(rungs)
    return out


def fleet_autoscale(total: dict) -> dict:
    """Phase 10f (d): the reference's ``diurnal_autoscale`` row
    (``bench.py`` ``_diurnal_autoscale_scenario``) at base_n = FLEET_N:
    five tenants shipping lazily plus a throughput pod tenant, its
    AutoscaleConfig (the promotion floor and the pod threshold are
    relative to n, so they scale with the cloud), the warmup of the
    brownout tiers and of the promoted pod's shapes, a probe before the
    flood, the diurnal session with client backoff, the recovery ticks,
    then the checks of its row: all three actuator families, brown down
    and up, degraded stamps, 0 failed, recovery, byte-identical probe,
    the zero-lost drill, the no-drop-tail probe, and ``mxu_select_bf16``
    launched in the session (every count from 0 just before it).  Every
    answered row is checked against cKDTree of its tenant's cloud
    (``fleet_rows_exact``), and the bf16 selection against its plain
    version on the inputs of the first degraded batch of each rung
    (``brownout_kernel_check``)."""
    import torch

    from cuda_knearests_tpu_torch.config import ServeFleetConfig
    from cuda_knearests_tpu_torch.io import generate_uniform
    from cuda_knearests_tpu_torch.mxu.solve import solve_general
    from cuda_knearests_tpu_torch.pod.reshard import ElasticIndex
    from cuda_knearests_tpu_torch.serve.fleet import (AutoscaleConfig,
                                                      FleetDaemon,
                                                      TenantLoad,
                                                      TenantSpec,
                                                      default_fleet_builds,
                                                      run_fleet_session)

    n, k = FLEET_N, AUTOSCALE_K
    out = {}
    t0 = time.perf_counter()
    builds = default_fleet_builds(n_tenants=5, base_n=n, k=k, seed=17)
    builds = [(dataclasses.replace(spec, ship_mode="lazy"), pts)
              for spec, pts in builds]
    pod_threshold = n + 1024 * 5
    cfg = dataclasses.replace(ServeFleetConfig(),
                              pod_threshold=pod_threshold, pod_shards=2)
    builds.append((TenantSpec(name="pod0", k=k, slo="throughput"),
                   generate_uniform(pod_threshold + 512, seed=17 + 997)))
    as_cfg = AutoscaleConfig(period_s=0.005, promote_min_points=n + 3000,
                             promote_load_rows=192)
    fleet = FleetDaemon(builds, cfg, autoscale=as_cfg, device=DEV)
    out["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    wq = (np.random.default_rng(5).random((4, 3)) * 100.0
          + 5.0).astype(np.float32)
    for t in fleet.tenants.values():
        if t.daemon is None or t.spec.slo != "throughput":
            continue
        pts = t.daemon.overlay.mutated_points()
        for rt, refine in ((1.0, "brute"), (as_cfg.recall_target, "none")):
            solve_general(pts, k=k, recall_target=rt, refine=refine,
                          queries=wq, scorer="mxu", precision="bf16",
                          device=DEV)
    el = fleet.tenants["pod0"].elastic
    rng0 = np.random.default_rng(31)
    el.insert((rng0.random((cfg.compact_threshold + 64, 3)) * 110.0
               + 5.0).astype(np.float32))
    for m in (1, 4, 16, 64):
        el.query(np.zeros((m, 3), np.float32), k)
    warm_el = ElasticIndex(
        fleet.tenants["t3"].daemon.overlay.mutated_points(), k=k,
        nshards=cfg.pod_shards, compact_threshold=cfg.compact_threshold,
        skew_threshold=cfg.pod_skew_threshold, device=DEV)
    for m in (1, 4, 16, 64):
        warm_el.query(np.zeros((m, 3), np.float32), k)
    del warm_el
    out["warm_s"] = time.perf_counter() - t0
    probe_q = (np.random.default_rng(6).random((8, 3)) * 100.0
               + 5.0).astype(np.float32)
    cap = CapturedFleet(fleet)

    def probe(rid: int):
        now = fleet.clock()
        rs = list(fleet.submit(rid, "t1", "query", probe_q, k=k, now=now))
        rs += list(fleet.drain(now))
        return next((r for r in rs if r.req_id == rid), None)

    pre = probe(10 ** 8)
    loads = []
    for i, (spec, _) in enumerate(builds):
        t = fleet.tenants[spec.name]
        flood = spec.slo == "throughput" and t.daemon is not None
        loads.append(TenantLoad(
            tenant=spec.name, rate=AUTOSCALE_RATE if flood else 400.0,
            requests=AUTOSCALE_REQS * 2 if flood else AUTOSCALE_REQS,
            diurnal=4.0, backoff=True, seed=70 + i))
    # time the degraded batches: each one hands the whole mutated cloud
    # to solve_general (host concatenation, upload, norm prep); keep the
    # first batch of each rung's inputs for the kernel check
    degraded_ms, first_batch = [], {}
    run_degraded = fleet._execute_degraded

    def timed_degraded(t, batch):
        tier, recall = t.degraded_tier_name, t.degraded_recall
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rs = run_degraded(t, batch)
        torch.cuda.synchronize()
        degraded_ms.append((time.perf_counter() - t1) * 1e3)
        if tier not in first_batch:
            first_batch[tier] = (t.mutated_points(), np.array(batch.queries),
                                 max(r.k for r in batch.requests), recall)
        return rs
    fleet._execute_degraded = timed_degraded
    restart_counts(total)
    s = run_fleet_session(fleet, loads)
    out["launches"] = {key: v for key, v in kernel_counts().items() if v}
    print(session_line("diurnal autoscale", s), flush=True)
    sc = fleet.autoscaler
    base = time.monotonic()
    recovered = False
    for i in range(1200):
        fleet.poll(base + (i + 1) * as_cfg.period_s * 1.01)
        dense = [t for t in fleet.tenants.values() if t.daemon is not None]
        if (all(t.degraded_tier == 0 for t in dense)
                and all(st.tier == 0 for st in sc.classes.values())
                and sum(sc.added.values()) == 0):
            recovered = True
            break
    post = probe(10 ** 8 + 1)
    # every row so far, before the tail inserts below change t0's cloud
    out["rows"] = fleet_rows_exact("diurnal autoscale", cap, fleet, {},
                                   as_cfg.recall_target)
    out["brownout_kernel"] = brownout_kernel_check(first_batch)
    byte_identical = bool(
        pre is not None and post is not None and pre.ok and post.ok
        and pre.degraded is None and post.degraded is None
        and np.array_equal(pre.ids, post.ids)
        and np.array_equal(pre.d2, post.d2))
    t0t = fleet.tenants["t0"]
    rng = np.random.default_rng(9)
    before_pts = t0t.daemon.overlay.mutated_points().copy()
    zero_lost = bool(t0t.add_replica())
    tail = [(rng.random((3, 3)) * 100.0 + 5.0).astype(np.float32)
            for _ in range(2)]
    for j, pts in enumerate(tail):
        rs = fleet.submit(10 ** 8 + 2 + j, "t0", "insert", pts,
                          now=fleet.clock())
        zero_lost = zero_lost and bool(rs and rs[-1].ok)
    fo = t0t.failover() if zero_lost else {"replayed": -1}
    zero_lost = (zero_lost and fo["replayed"] == 2
                 and np.array_equal(t0t.daemon.overlay.mutated_points(),
                                    np.concatenate([before_pts] + tail)))
    drop_tail = None
    for t in fleet.tenants.values():
        if t.log is None:
            continue
        floor = min((r.applied_seq for r in t.replica_pool), default=0)
        try:
            list(t.log.since(floor))
        except RuntimeError as e:
            drop_tail = f"{t.spec.name}: {e}"
    stats = sc.stats_dict()
    degraded_stamped = sum(s["degraded_rows"].values())
    out["degraded_split"] = degraded_split(fleet.tenants["t1"], k)
    out.update({key: stats[key] for key in (
        "ticks", "scale_up", "scale_down", "widen", "narrow", "promote",
        "brown_down", "brown_up", "shed")})
    out.update(
        recovered=recovered, byte_identical=byte_identical,
        zero_lost=zero_lost, drop_tail=drop_tail,
        degraded_rows=s["degraded_rows"],
        per_tenant={t: {key: pt[key] for key in (
            "slo", "completion", "p50_ms", "p99_ms", "p999_ms", "slo_ok")}
            for t, pt in s["per_tenant"].items()},
        session={key: s[key] for key in (
            "completed_queries", "elapsed_s", "sustained_qps",
            "fleet_batches", "failed_requests", "refused_requests",
            "deferred_requests", "recompiles", "elastic_recompiles",
            "migrations_done", "host_syncs", "d2h_bytes", "h2d_bytes")},
        degraded_batches=len(degraded_ms),
        degraded_ms_median=(float(np.median(degraded_ms))
                            if degraded_ms else None),
        degraded_ms_max=max(degraded_ms) if degraded_ms else None)
    print(f"  fleet autoscale: {json.dumps(out)}", flush=True)
    require(stats["scale_up"] >= 1
            and stats["widen"] + stats["narrow"] >= 1
            and stats["promote"] >= 1,
            f"fleet autoscale: an actuator family never fired {stats}")
    require(stats["brown_down"] >= 1 and stats["brown_up"] >= 1
            and degraded_stamped > 0,
            f"fleet autoscale: no brownout episode ({stats['brown_down']} "
            f"down, {stats['brown_up']} up, {s['degraded_rows']} rows)")
    require(s["failed_requests"] == 0 and s["recompiles"] == 0,
            f"fleet autoscale: {s['failed_requests']} failed, "
            f"{s['recompiles']} recompiles")
    require(recovered and byte_identical and zero_lost and drop_tail is None,
            f"fleet autoscale: recovered {recovered}, probe byte-identical "
            f"{byte_identical}, zero lost {zero_lost}, tail {drop_tail}")
    require(out["launches"].get("mxu_select_bf16", 0) > 0,
            "the brownout tiers launched no bf16 selection")
    require(all(out["rows"][tier] >= n
                for tier, n in s["degraded_rows"].items()),
            f"fleet autoscale: degraded rows {s['degraded_rows']}, checked "
            f"{out['rows']}")
    del fleet, cap
    torch.cuda.empty_cache()
    return out


def fleet_pod_tenant() -> dict:
    """Phase 10f (e): the ``--pod-tenant`` recipe at FLEET_N: a pod tenant
    of 1,000,000 points in 2 Morton shards, 576 hot inserts past the
    compaction threshold, the batch shapes warmed, ``force_rebalance``,
    then a query session the migration rides; every answered row exact
    against cKDTree, a probe equal to the rebuild oracle byte for byte,
    at least one migration done."""
    import torch

    from cuda_knearests_tpu_torch.config import ServeFleetConfig
    from cuda_knearests_tpu_torch.io import generate_uniform
    from cuda_knearests_tpu_torch.serve.fleet import (FleetDaemon,
                                                      TenantLoad,
                                                      TenantSpec,
                                                      run_fleet_session)

    pod_threshold = FLEET_N - 512
    cfg = dataclasses.replace(ServeFleetConfig(),
                              pod_threshold=pod_threshold, pod_shards=2)
    t0 = time.perf_counter()
    fleet = FleetDaemon([(TenantSpec(name="pod0", k=FLEET_K),
                          generate_uniform(FLEET_N, seed=997))], cfg,
                        device=DEV)
    el = fleet.tenants["pod0"].elastic
    rng = np.random.default_rng(5)
    el.insert((rng.random((cfg.compact_threshold + 64, 3)) * 110.0
               + 5.0).astype(np.float32))
    for m in (1, 4, 16, 64):
        el.query(np.zeros((m, 3), np.float32), FLEET_K)
    started = bool(el.force_rebalance())
    build_s = time.perf_counter() - t0
    cap = CapturedFleet(fleet)
    before = kernel_counts()
    s = run_fleet_session(fleet, [TenantLoad(
        tenant="pod0", rate=350.0, requests=POD_TENANT_REQS, seed=50)])
    launches = launches_since(before)
    print(session_line("pod tenant", s), flush=True)
    rows = fleet_rows_exact("pod tenant", cap, fleet, {})["exact"]
    probe = (np.random.default_rng(8).random((64, 3)) * 980.0
             + 10.0).astype(np.float32)
    got = el.query(probe, FLEET_K)
    want = el.rebuild_oracle_query(probe, FLEET_K)
    require(started and s["migrations_done"] >= 1
            and s["failed_requests"] == 0 and s["recompiles"] == 0
            and np.array_equal(got[0], want[0])
            and np.array_equal(got[1], want[1]),
            f"fleet pod tenant: rebalance started {started}, migrations "
            f"{s['migrations_done']}, failed {s['failed_requests']}, "
            f"recompiles {s['recompiles']}, probe equal to the rebuild "
            f"{np.array_equal(got[0], want[0])}")
    out = {"build_s": build_s, "exact_rows": rows, "launches": launches,
           "migrations_done": s["migrations_done"],
           "elastic_recompiles": s["elastic_recompiles"],
           "p50_ms": s["per_tenant"]["pod0"]["p50_ms"],
           "p99_ms": s["per_tenant"]["pod0"]["p99_ms"],
           "p999_ms": s["per_tenant"]["pod0"]["p999_ms"]}
    print(f"  fleet pod tenant: {json.dumps(out)}", flush=True)
    del fleet, el, cap
    torch.cuda.empty_cache()
    return out


def fleet_card_equals_cpu() -> dict:
    """Phase 10f (f): a small fleet (base_n=6000, k=8, a replica each,
    20% mutations, a bf16 brownout episode on the throughput tenant) on
    the card and on the CPU under one schedule and a fake clock
    (``loadgen.card_equals_cpu``): every response equal, ids and d2 bit
    for bit, ok, tenant and tier."""
    from cuda_knearests_tpu_torch.serve.fleet import (TenantLoad,
                                                      default_fleet_builds)
    from cuda_knearests_tpu_torch.serve.fleet.loadgen import card_equals_cpu

    t0 = time.perf_counter()
    builds = default_fleet_builds(n_tenants=4, base_n=FLEET_CPU_N, k=8,
                                  seed=3, replicas=1)
    loads = [TenantLoad(tenant=spec.name, rate=300.0, requests=20,
                        mutation_ratio=0.2 if spec.name != "t3" else 0.0,
                        seed=90 + i) for i, (spec, _) in enumerate(builds)]
    out = card_equals_cpu(builds, loads, DEV)
    out["s"] = time.perf_counter() - t0
    require(out["difference"] is None,
            f"fleet card = CPU: {out['difference']}")
    require(out["degraded"] > 0, "fleet card = CPU: no degraded batch ran")
    print(f"  fleet card = CPU: {out['responses']} responses equal bit for "
          f"bit ({out['degraded']} at the bf16 rung) in {out['s']:.1f} s",
          flush=True)
    return out


def fleet_phase() -> dict:
    """Phase 10f: the serving fleet (``serve/fleet``) on the card, with
    every kernel's launches counted from 0 over the phase."""
    t_phase = time.perf_counter()
    zero_kernel_counts()
    out, total = {}, {}
    steps = (("mixed", lambda: fleet_mixed(total)),
             ("failover", fleet_failover),
             ("autoscale", lambda: fleet_autoscale(total)),
             ("pod", fleet_pod_tenant), ("card_cpu", fleet_card_equals_cpu))
    seconds = {}
    for name, run in steps:
        t0 = time.perf_counter()
        out[name] = run()
        seconds[name] = round(time.perf_counter() - t0, 1)
    # the sessions restarted the counts from 0: add back what ran before
    now = kernel_counts()
    out["launches"] = {key: total.get(key, 0) + now[key] for key in now}
    out["seconds"] = seconds
    out["s"] = time.perf_counter() - t_phase
    require(out["launches"]["supercell_topk"] > 0
            and out["launches"]["mxu_select_bf16"] > 0,
            f"fleet: a kernel of the path never launched {out['launches']}")
    print(f"  fleet phase: {out['s']:.1f} s ({json.dumps(seconds)}); "
          f"kernel launches in the phase {json.dumps(out['launches'])}",
          flush=True)
    return out


# Phase 10g: the mesh drill at the fleet's pod-tenant size, and the chaos
# and fleet campaigns at the reference's own case sizes.
MESH_N, MESH_K, MESH_OPS = 1_000_000, 10, 26
CHAOS_CASES = FLEET_CASES = 8
CARD_CPU_SPECS = 3
# the seeded faults run on the card (of fuzz.chaos.SEEDED_FAULT_CASES)
CARD_FAULTS = ("torn-migration", "lost-range", "scale-drop-tail",
               "cross-tenant")


def mesh_drill() -> dict:
    """Phase 10g (a): ``mesh_failover_drill`` at MESH_N points with the
    primary and the standby mesh both on the card (three CUDA contexts on
    one card), killed mid-migration.  Each child reports its own device
    and kernel launches: the promoted standby must have served its probe
    through ``supercell_topk`` on the card, and its rows must be exact
    against the host kd-tree."""
    import torch

    from cuda_knearests_tpu_torch.serve.fleet.elastic import \
        mesh_failover_drill

    free0, total = torch.cuda.mem_get_info()
    drill = mesh_failover_drill(n=MESH_N, k=MESH_K, ops=MESH_OPS, seed=0,
                                device=DEV)
    free1, _ = torch.cuda.mem_get_info()
    drill["free_bytes_before"], drill["free_bytes_after"] = free0, free1
    t = drill["timing"]
    print(f"  mesh drill at {MESH_N:,} points: {t['drill_s']:.1f} s "
          f"(children ready {t['spawn_s']:.1f} s; snapshot "
          f"{t['snapshot_s']:.2f} s, {t['snapshot_bytes']:,} bytes, its "
          f"prepare {t['snapshot_prepare_s']:.2f} s and cloud gather "
          f"{t['snapshot_cloud_s']:.2f} s; standby restore "
          f"{t['restore_s']:.2f} s, replay of {t['replayed']} record(s) "
          f"{t['replay_s']:.3f} s; shard shipping {t['shards_s']:.2f} s, "
          f"state_cloud {t['state_cloud_s']:.3f} s, oracle "
          f"{t['oracle_s']:.2f} s); migration at the kill "
          f"{json.dumps(drill['migration_at_kill'])}; probe latency "
          f"{json.dumps(drill['latency_decomposition'])}; kd-tree check "
          f"{t['kdtree_s']:.2f} s; card free {free0 / 2**30:.1f} GiB "
          f"before, {drill['card_free_bytes_both_meshes'] / 2**30:.1f} GiB "
          f"with both meshes up, {free1 / 2**30:.1f} GiB after, of "
          f"{total / 2**30:.1f}", flush=True)
    for who in ("primary_at_kill", "mesh_child"):
        report = drill[who]
        print(f"  {who}: device {report['device']}, "
              f"{report['cuda_allocated_bytes'] / 2**30:.2f} GiB allocated, "
              f"launches {json.dumps(report['launches'])}", flush=True)
    child = drill["mesh_child"]
    require(drill["mesh_failover_ok"] and drill["killed_mid_migration"]
            and drill["zero_lost_committed"]
            and drill["post_failover_byte_identical"]
            and drill["post_failover_exact"]
            and drill["mesh_failovers"] >= 1
            and drill["device"].startswith("cuda")
            and all(drill[who]["device"].startswith("cuda")
                    for who in ("primary_at_kill", "mesh_child"))
            and child["launches"]["supercell_topk"] > 0,
            f"mesh failover drill: {json.dumps(drill)}")
    return drill


def campaign_clean(name: str, manifest: dict, n_cases: int) -> None:
    require(manifest["ok"] and manifest["failures"] == []
            and manifest["proto_models_ok"]
            and not manifest.get("proto_trace_violations")
            and manifest["completed_cases"] >= n_cases,
            f"{name} campaign on the card: "
            f"{json.dumps(manifest)}")


def chaos_campaign_card(bank: str) -> dict:
    """Phase 10g (b): the chaos campaign on the card, the named autoscale
    schedules riding along (the brownout rungs run the bf16 selection)."""
    from cuda_knearests_tpu_torch.fuzz.chaos import run_chaos_campaign

    before = kernel_counts()
    m = run_chaos_campaign(n_cases=CHAOS_CASES, seed=0, bank_dir=bank,
                           drill=False, log=None, device=DEV)
    m["launches"] = launches_since(before)
    campaign_clean("chaos", m, CHAOS_CASES)
    require(m["launches"].get("supercell_topk", 0) > 0
            and m["launches"].get("mxu_select_bf16", 0) > 0,
            f"chaos campaign: a kernel of its path never launched "
            f"{m['launches']}")
    print(f"  chaos campaign: {m['completed_cases']} schedules clean in "
          f"{m['elapsed_s']:.1f} s, {m['proto_trace_events']} protocol "
          f"events conform; launches {json.dumps(m['launches'])}",
          flush=True)
    return {key: m[key] for key in ("completed_cases", "elapsed_s",
                                    "proto_trace_events", "launches")}


def fleet_campaign_card(bank: str) -> dict:
    """Phase 10g (c): the fleet campaign on the card."""
    from cuda_knearests_tpu_torch.fuzz.fleet import run_fleet_campaign

    before = kernel_counts()
    m = run_fleet_campaign(n_cases=FLEET_CASES, seed=0, bank_dir=bank,
                           log=None, device=DEV)
    m["launches"] = launches_since(before)
    campaign_clean("fleet", m, FLEET_CASES)
    require(m["launches"].get("supercell_topk", 0) > 0,
            f"fleet campaign: no class-kernel launch {m['launches']}")
    print(f"  fleet campaign: {m['completed_cases']} streams clean in "
          f"{m['elapsed_s']:.1f} s, {m['proto_trace_events']} protocol "
          f"events conform; launches {json.dumps(m['launches'])}",
          flush=True)
    return {key: m[key] for key in ("completed_cases", "elapsed_s",
                                    "proto_trace_events", "launches")}


def fleet_faults_card() -> dict:
    """Phase 10g (d): each seeded fleet fault on the card yields a
    failure, banked into a temporary directory although the run aims at
    ``tests/corpus_torch``."""
    from cuda_knearests_tpu_torch import fuzz
    from cuda_knearests_tpu_torch.fuzz import chaos

    corpus = os.path.abspath(fuzz.CORPUS_DIR)
    out = {}
    for fault in CARD_FAULTS:
        f, _suffix = chaos.run_seeded_fault_case(
            fault, bank_dir=fuzz.CORPUS_DIR, device=DEV)
        banked = os.path.abspath(f.banked) if f and f.banked else ""
        if banked:
            if banked.startswith(corpus + os.sep):
                os.unlink(banked)
            else:
                shutil.rmtree(os.path.dirname(banked), ignore_errors=True)
        require(f is not None and bool(banked)
                and not banked.startswith(corpus + os.sep),
                f"KNTPU_FLEET_FAULT={fault}: {f} (banked at {banked!r})")
        out[fault] = {"kind": f.kind, "reason": f.reason[:120],
                      "banked": os.path.basename(banked)}
    print(f"  seeded fleet faults caught on the card, none banked into "
          f"tests/corpus_torch: {json.dumps(out)}", flush=True)
    return out


def campaigns_card_equals_cpu() -> dict:
    """Phase 10g (e): CARD_CPU_SPECS chaos schedules and as many fleet
    streams replayed on the card and on the CPU: every checked query's
    ids and d2 equal bit for bit."""
    from cuda_knearests_tpu_torch.fuzz import chaos, fleet

    out = {"chaos_queries": 0, "fleet_queries": 0}
    for name, mod in (("chaos", chaos), ("fleet", fleet)):
        for spec in mod.draw_specs(CARD_CPU_SPECS, 1):
            got = fleet.answers_equal(mod.replay_ops, spec,
                                      mod.generate_ops(spec), DEV)
            require(got["difference"] is None
                    and got["verdicts"] == [None, None]
                    and got["queries"] > 0,
                    f"{name} card = CPU on {spec.case_id()}: {got}")
            out[f"{name}_queries"] += got["queries"]
    print(f"  campaigns card = CPU: {out['chaos_queries']} chaos and "
          f"{out['fleet_queries']} fleet query answers equal bit for bit "
          f"over {CARD_CPU_SPECS} specs each", flush=True)
    return out


def mesh_chaos_phase() -> dict:
    """Phase 10g: mesh failover and the fleet and chaos campaigns on the
    card, with every kernel's launches counted from 0 over the phase."""
    import tempfile

    import torch

    t_phase = time.perf_counter()
    zero_kernel_counts()
    bank = tempfile.mkdtemp(prefix="chip-smoke-chaos-")
    out, seconds = {}, {}
    steps = (("mesh", mesh_drill),
             ("chaos", lambda: chaos_campaign_card(bank)),
             ("fleet", lambda: fleet_campaign_card(bank)),
             ("faults", fleet_faults_card),
             ("card_cpu", campaigns_card_equals_cpu))
    try:
        for name, run in steps:
            t0 = time.perf_counter()
            out[name] = run()
            seconds[name] = round(time.perf_counter() - t0, 1)
    finally:
        shutil.rmtree(bank, ignore_errors=True)
    out["launches"] = kernel_counts()
    out["seconds"] = seconds
    out["s"] = time.perf_counter() - t_phase
    require(out["launches"]["supercell_topk"] > 0
            and out["launches"]["mxu_select_bf16"] > 0,
            f"mesh and chaos: a kernel of the path never launched "
            f"{out['launches']}")
    torch.cuda.empty_cache()
    print(f"  mesh and chaos phase: {out['s']:.1f} s "
          f"({json.dumps(seconds)}); kernel launches in the phase "
          f"{json.dumps(out['launches'])}", flush=True)
    return out


# -- phase 10h: the CLI and device observability on the card -----------------

CLI_XYZ = "data/900k_blue_cube.xyz"


def _json_tail(out: str) -> dict:
    """The last JSON object line of a command's output."""
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    require(bool(lines), f"no JSON line in: {out[-2000:]!r}")
    return json.loads(lines[-1])


def fresh_solves_ms(prob) -> list:
    """Host ms of the first four solves of a fresh problem over ``prob``'s
    points and config, each result held until the next solve returns."""
    import cuda_knearests_tpu_torch as pt

    fresh = pt.KnnProblem.prepare(prob.host_points, prob.config, device=DEV)
    times = []
    for _ in range(4):
        t0 = time.perf_counter()
        fresh.solve()   # the problem holds the last result, as in the CLI
        times.append(round((time.perf_counter() - t0) * 1e3, 3))
    return times


def _start_commands(cmds: dict, root: str) -> dict:
    """Start ``python -m cuda_knearests_tpu_torch.<module> <args>`` for
    each name of ``cmds`` ({name: (args, module, extra env)}) at once,
    from the checkout's root; {name: process}."""
    env = dict(os.environ, PYTHONPATH=root)
    return {name: subprocess.Popen(
        [sys.executable, "-m", f"cuda_knearests_tpu_torch.{mod}", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(env, **extra), cwd=root)
        for name, (argv, mod, extra) in cmds.items()}


def _finish_commands(procs: dict) -> tuple:
    """Wait for :func:`_start_commands`' processes (killing any still up
    after 300 s); ({name: output}, {name: rc}), each tail printed."""
    texts = {}
    try:
        for name, p in procs.items():
            texts[name] = p.communicate(timeout=300)[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = {name: p.returncode for name, p in procs.items()}
    for name, text in texts.items():
        keep = [ln for ln in text.strip().splitlines()
                if not ln.startswith(("{", "/", "  _warn"))]
        print(f"  {name}: rc {rcs[name]}", flush=True)
        for ln in keep[-6:]:
            print(f"    {ln[:1500]}", flush=True)
    return texts, rcs


def _check_roofline(what: str, row: dict, card: str) -> None:
    require(row.get("device_kind") == card
            and "assumed" not in row["roofline_peak_source"]
            and row["roofline_peak_source"].startswith("h100-sxm")
            and 0 < row["pct_hbm_roofline"] <= 105.0
            and 0 < row["pct_flops_roofline"] <= 105.0,
            f"roofline ({what}): {row}")


def cli_in_process(prob10, tmp: str, card: str) -> dict:
    """Phase 10h (a) and (b): ``cli.main`` on the 900k blue cube at k=10
    in this process (rc 0, 0 hard mismatches against the kd-tree,
    ``supercell_topk`` once per class per solve, the card as its
    platform), a fresh problem's first solves beside its timed one, and a
    NaN file refused rc 5."""
    import contextlib
    import io as _io

    from cuda_knearests_tpu_torch import cli

    before = kernel_counts()
    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([CLI_XYZ, "--k", "10", "--json"])
    after = kernel_counts()
    text = buf.getvalue()
    line = _json_tail(text)
    launched = {k: after[k] - before[k] for k in after}
    # one warm-up and one timed solve, one launch a class each
    m = re.search(r"adaptive schedule: (\d+) capacity classes", text)
    cli_cls = int(m.group(1)) if m else -1
    require(rc == 0 and line.get("hard") == 0
            and line.get("platform") == card and cli_cls > 0
            and launched["supercell_topk"] == 2 * cli_cls
            and sum(launched.values()) == 2 * cli_cls,
            f"CLI: rc {rc}, summary {line}, {cli_cls} classes, "
            f"launches {launched}")
    for ln in text.splitlines():
        if ln.startswith(("solve:", "oracle comparison", "[knn cpu",
                          "[prepare", "There are", "  device",
                          "adaptive schedule", "  class")):
            print(f"    {ln}", flush=True)
    # the CLI times its second solve, whose readback cannot reuse the
    # first result's host buffers: a fresh problem's first four solves
    # (each result kept until the next returns, as the CLI keeps it)
    fresh = quiet(lambda: fresh_solves_ms(prob10))
    print(f"    a fresh 900k/k=10 problem's solves, ms: {fresh}",
          flush=True)
    nan = os.path.join(tmp, "nan.xyz")
    with open(nan, "w") as f:
        f.write("3\n1 2 3\nnan 5 6\n7 8 9\n")
    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(_io.StringIO()):
        rc_nan = cli.main([nan, "--k", "2"])
    nan_line = _json_tail(buf.getvalue())
    require(rc_nan == 5 and nan_line["failure_kind"] == "invalid-input",
            f"CLI on a NaN file: rc {rc_nan}, {nan_line}")
    return {"cli": {"rc": rc, "summary": line, "launches": launched,
                    "fresh_solves_ms": fresh},
            "rc_nan": rc_nan}


def cli_obs_phase(prob10, topk_ms: float) -> dict:
    """Phase 10h, the CLI and device observability on the card.  (d) The
    900k/k=10 job through ``python -m cuda_knearests_tpu_torch.cli
    --capture --no-oracle`` in a process of its own (torch.profiler drops a
    growing share of device events in sessions long after a process's
    first, so a capture runs early in a process): rc 0, every device event
    attributed and joined to its launch, ``supercell_topk`` once per class
    and its captured ms within 10% of ``topk_ms`` (the same kernel's
    CUDA-event time in phase 11), the memory verdict from the allocator,
    and the timed solve's ``roofline_fields`` against the card's own peaks
    entry, each share at most 105%; here, the static-shape law for
    ``prob10`` beside the real-pair bounds, and the roofline of its warm
    solve and of the kernel alone.  (a) ``cli.main`` on the same cube in
    this process: rc 0, 0 hard mismatches against the kd-tree,
    ``supercell_topk`` once per class per solve, the card as its platform.
    (b) A NaN file refused rc 5.  Then at once: the CLI with no visible
    card and no ``--device`` (rc 4, ``no-device``), ``python -m
    cuda_knearests_tpu_torch.obs`` (rc 0: zero unattributed events, a
    ``supercell_topk`` event, the verdict from the allocator, the merged
    trace written) and ``python -m
    cuda_knearests_tpu_torch.runtime.dispatch`` (rc 0, every route within
    its sync budget).  This process's launches are counted from 0."""
    import tempfile

    import torch

    from cuda_knearests_tpu_torch.utils import roofline

    t_phase = time.perf_counter()
    zero_kernel_counts()
    card = torch.cuda.get_device_name(0)
    out, seconds = {}, {}
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip-smoke-10h-")
    try:
        # (d) the capture, in a process of its own, against phase 11; (a)
        # and (b) run here meanwhile (their device work is done seconds
        # before the captured solve, which follows the process's start,
        # its cloud and its first profiler session)
        t0 = time.perf_counter()
        capture = _start_commands({"cli_capture": (
            [CLI_XYZ, "--k", "10", "--no-oracle", "--json", "--capture"],
            "cli", {})}, root)
        out.update(cli_in_process(prob10, tmp, card))
        seconds["cli"] = round(time.perf_counter() - t0, 1)
        texts, rcs = _finish_commands(capture)
        text = texts["cli_capture"]
        line = _json_tail(text)
        dec = line.get("device_time_decomposition", {})
        m = re.search(r"adaptive schedule: (\d+) capacity classes", text)
        cli_cls = int(m.group(1)) if m else -1
        runs = dec.get("modules", {}).get("supercell_topk", {})
        captured_ms = dec.get("by_module", {}).get("supercell_topk", 0.0)
        rel = captured_ms / topk_ms - 1.0
        require(rcs["cli_capture"] == 0 and line.get("platform") == card
                and dec.get("unattributed") == 0 and dec.get("events", 0) > 0
                and dec["joined_by_correlation"] == dec["events"]
                and runs.get("executions") == cli_cls > 0,
                f"captured CLI: rc {rcs['cli_capture']}, {cli_cls} classes, "
                f"decomposition {dec}")
        require(abs(rel) <= 0.10,
                f"capture: supercell_topk {captured_ms:.4f} ms against "
                f"{topk_ms:.4f} ms by CUDA events ({100 * rel:+.1f}%)")
        require(line.get("hbm_model_ok") is True
                and line.get("hbm_measured_source") == "cuda_allocator",
                f"capture: memory verdict {line}")
        _check_roofline("the CLI's timed solve", line, card)
        traffic = roofline.problem_traffic(prob10)
        times = []
        for _ in range(3):
            t1 = time.perf_counter()
            prob10.solve()
            times.append(time.perf_counter() - t1)
        solve_s = float(np.median(times))
        roof = {"solve": roofline.roofline_fields(traffic, solve_s, "cuda"),
                "kernel": roofline.roofline_fields(traffic, topk_ms / 1e3,
                                                   "cuda")}
        for what, row in roof.items():
            _check_roofline(what, row, card)
        static_bytes_ms = traffic["hbm_total"] / PEAK_HBM_BYTES * 1e3
        static_ops_ms = traffic["flops"] / PEAK_F32_FLOPS * 1e3
        out["capture"] = {
            "supercell_topk_ms": round(captured_ms, 4),
            "cuda_event_ms": round(topk_ms, 4), "rel": round(rel, 4),
            "executions": runs.get("executions"), "decomposition": dec,
            "cli_solve_ms": round(line["solve_s"] * 1e3, 3),
            "hbm_window_delta_bytes": line["hbm_window_delta_bytes"],
            "hbm_model_bytes": line["hbm_model_bytes"],
            "cli_roofline": {key: line.get(key) for key in (
                "achieved_hbm_gbps", "pct_hbm_roofline", "achieved_gflops",
                "pct_flops_roofline", "roofline_peak_source")},
            "solve_ms": round(solve_s * 1e3, 3),
            "static_bound_ms": {"bytes": round(static_bytes_ms, 4),
                                "operations": round(static_ops_ms, 4)},
            "roofline": roof}
        print(f"  (d) captured 900k/k=10 solve (the CLI, its own process): "
              f"supercell_topk {captured_ms:.4f} ms in "
              f"{runs.get('executions')} event(s) for {cli_cls} class(es); "
              f"CUDA events {topk_ms:.4f} ms ({100 * rel:+.2f}%); "
              f"{dec['events']} device events, all joined by correlation "
              f"(launch to start {json.dumps(dec.get('launch_to_start_ms'))}"
              f" ms), {dec['device_total_ms']} ms, by module "
              f"{json.dumps(dec['by_module'])}; memory growth "
              f"{line['hbm_window_delta_bytes']} of model "
              f"{line['hbm_model_bytes']} bytes", flush=True)
        print(f"    static-shape law (utils/roofline.py, padded slots): "
              f"{traffic['hbm_total']} bytes -> {static_bytes_ms:.4f} ms at "
              f"3.35 TB/s, {traffic['pairs']} pairs, {traffic['flops']} "
              f"f32 ops -> {static_ops_ms:.4f} ms at 67 TFLOP/s; the CLI's "
              f"timed solve {json.dumps(out['capture']['cli_roofline'])}; "
              f"here a warm solve (median {solve_s * 1e3:.3f} ms) "
              f"{json.dumps(roof['solve'])}; the kernel alone "
              f"{json.dumps(roof['kernel'])}", flush=True)
        seconds["capture"] = round(time.perf_counter() - t0, 1)

        # the other commands, at once
        t0 = time.perf_counter()
        obs_dir = os.path.join(tmp, "obs")
        texts, rcs = _finish_commands(_start_commands({
            "cli_no_device": ([CLI_XYZ, "--k", "10", "--json"], "cli",
                              {"CUDA_VISIBLE_DEVICES": ""}),
            "obs": (["--out-dir", obs_dir], "obs", {}),
            "dispatch": ([], "runtime.dispatch", {})}, root))
        seconds["commands"] = round(time.perf_counter() - t0, 1)
        no_dev = _json_tail(texts["cli_no_device"])
        require(rcs["cli_no_device"] == 4
                and no_dev.get("failure_kind") == "no-device",
                f"CLI with no visible card: rc {rcs['cli_no_device']}, "
                f"{no_dev}")
        obs = _json_tail(texts["obs"])
        require(rcs["obs"] == 0 and obs.get("ok") is True
                and obs.get("device_unattributed") == 0
                and obs.get("device_supercell_topk_events", 0) >= 1
                and obs.get("hbm_model_ok") is True
                and obs.get("hbm_measured_source") == "cuda_allocator"
                and os.path.exists(os.path.join(obs_dir,
                                                "trace_merged.json")),
                f"obs smoke: rc {rcs['obs']}, {obs}")
        print(f"    obs: {json.dumps(obs)[:1500]}", flush=True)
        routes = [json.loads(ln) for ln in texts["dispatch"].splitlines()
                  if ln.startswith('{"route"')]
        require(rcs["dispatch"] == 0 and len(routes) == 6
                and all(r["ok"] and r["device"] == "cuda" for r in routes),
                f"dispatch smoke: rc {rcs['dispatch']}, {routes}")
        print(f"    dispatch: {json.dumps(routes)[:1500]}", flush=True)
        out.update(cli_no_device=no_dev, obs=obs, dispatch=routes, rcs=rcs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = kernel_counts()
    out["seconds"] = seconds
    out["s"] = time.perf_counter() - t_phase
    require(out["launches"]["supercell_topk"] > 0,
            f"CLI and observability: supercell_topk never launched "
            f"{out['launches']}")
    print(f"  CLI and observability phase: {out['s']:.1f} s "
          f"({json.dumps(seconds)}); kernel launches in this process "
          f"{json.dumps(out['launches'])}", flush=True)
    return out


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
    _build.load_all(_build.KERNELS)
    print(f"build: {', '.join(f'{n}.cu' for n in _build.KERNELS)} in "
          f"{time.perf_counter() - t0:.1f} s (one nvcc each, in parallel)",
          flush=True)
    for name in _build.KERNELS:
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

    phase("the legacy route and the gather epilogue")
    legacy = legacy_phase(pts900, prob10, pts_cl)

    phase("the grid route's MXU tier")
    mxu_tier = mxu_phase(pts300, prob50, pts_cl)

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

    phase("the multi-GPU z-slab solve")
    sharded, reuse = sharded_phase()

    phase("the pod: the cell-partitioned index")
    pod = pod_phase(reuse)
    del reuse

    phase("the elastic index: Morton-range shards and a live migration")
    elastic = elastic_phase()

    phase("the fuzz campaigns on the card")
    fuzzed = fuzz_phase()

    phase("the serving fleet on the card")
    fleet = fleet_phase()

    phase("mesh failover and the fleet and chaos campaigns on the card")
    mesh_chaos = mesh_chaos_phase()
    # the promoted standby's own count, from its process
    mesh_child = mesh_chaos["mesh"]["mesh_child"]["launches"]

    phase("timing at the main paths' class shapes")
    timing, err10 = class_timing("900k/k=10", prob10, cfg10)
    _, err50 = class_timing("300k/k=50", prob50, cfg50)
    blocked_timing, err_b = class_timing("900k/k=10 blocked", prob_b, cfg_b)
    blocked50, err_b50 = class_timing("300k/k=50 blocked", prob50,
                                      pt.KnnConfig(k=50, kernel="blocked"))
    blocked_crowded, err_bc = crowded_timing("900k/k=10 blocked", prob_b,
                                             cfg_b)

    phase("the CLI and device observability on the card")
    cli_obs = cli_obs_phase(prob10, timing["ms"])

    kernels = [
        dict(name="supercell_topk", route="cuda",
             source=CSRC + "supercell_topk.cu",
             replaces=REPLACES["supercell_topk"],
             launches=(launches + pod["overlay"]["launches"]
                       + elastic["launches"]
                       + fleet["mixed"]["launches"]["supercell_topk"]
                       + cli_obs["launches"]["supercell_topk"]),
             grid_main_path_launches=launches,
             max_abs_err=max(max_err["supercell_topk"], err10, err50,
                             sharded["main"]["slabs"][1]["max_abs_err"],
                             pod["main"]["chips"][1]["max_abs_err"],
                             elastic["hotspot_kernel"]["max_abs_err"],
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
             serve_launches=serve["launches"],
             sharded_launches=sharded["main"]["launches"],
             sharded_ms=sharded["main"]["kernel_ms"],
             sharded_bound_ms=sharded["main"]["bound_ms"],
             sharded_plain_ms_slab1=sharded["main"]["slabs"][1]["plain_ms"],
             sharded_query_launches=sharded["queries"]["launches"],
             pod_launches=pod["main"]["launches"],
             pod_ms=pod["main"]["kernel_ms"],
             pod_bound_ms=pod["main"]["bound_ms"],
             pod_plain_ms_chip1=pod["main"]["chips"][1]["plain_ms"],
             pod_query_launches=pod["queries"]["launches"],
             pod_overlay_launches=pod["overlay"]["launches"],
             elastic_launches=elastic["launches"],
             elastic_hotspot_ms=elastic["hotspot_kernel"]["ms"],
             elastic_hotspot_plain_ms=elastic["hotspot_kernel"]["plain_ms"],
             mxu_tier_launches=mxu_tier["launches"],
             fuzz_launches=fuzzed["launches"]["supercell_topk"],
             fleet_main_path_launches=fleet["mixed"]["launches"][
                 "supercell_topk"],
             fleet_launches=fleet["launches"]["supercell_topk"],
             mesh_chaos_launches=mesh_chaos["launches"]["supercell_topk"],
             mesh_child_launches=mesh_child["supercell_topk"],
             cli_obs_launches=cli_obs["launches"]["supercell_topk"],
             cli_launches=cli_obs["cli"]["launches"]["supercell_topk"],
             captured_ms=cli_obs["capture"]["supercell_topk_ms"]),
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
             query_bound_ms=query["blocked"]["kernel"]["bound_ms"],
             fuzz_launches=fuzzed["launches"]["blocked_topk"],
             fleet_launches=fleet["launches"]["blocked_topk"],
             mesh_chaos_launches=mesh_chaos["launches"]["blocked_topk"],
             mesh_child_launches=mesh_child["blocked_topk"]),
        dict(name="supercell_topk_mode_b", route="cuda",
             source=CSRC + "supercell_topk.cu",
             replaces="cuda_knearests_tpu/ops/pallas_solve.py:117",
             launches=legacy["launches_b"],
             max_abs_err=legacy["max_abs_err"],
             shape="900k/k=10 legacy pack", **legacy["mode_b"],
             fuzz_launches=fuzzed["launches"]["supercell_topk_mode_b"],
             fleet_launches=fleet["launches"]["supercell_topk_mode_b"],
             mesh_chaos_launches=mesh_chaos["launches"][
                 "supercell_topk_mode_b"],
             mesh_child_launches=mesh_child["supercell_topk_mode_b"]),
        dict(name="blocked_topk_mode_b", route="cuda",
             source=CSRC + "blocked_topk.cu",
             replaces=REPLACES["blocked_topk"],
             launches=legacy["blocked_launches_b"],
             max_abs_err=legacy["max_abs_err_blocked"],
             shape="900k/k=10 legacy pack", **legacy["mode_b_blocked"],
             fuzz_launches=fuzzed["launches"]["blocked_topk_mode_b"],
             fleet_launches=fleet["launches"]["blocked_topk_mode_b"],
             mesh_chaos_launches=mesh_chaos["launches"]["blocked_topk_mode_b"],
             mesh_child_launches=mesh_child["blocked_topk_mode_b"]),
        dict(name="mxu_select", route="cuda", source=CSRC + "mxu_select.cu",
             replaces=REPLACES["mxu_select"],
             launches=select_launches["f32"],
             max_abs_err=max_err["mxu_select"], shape="100k x 128 f32",
             **select_timings["100k x 128 f32"],
             fuzz_launches=fuzzed["launches"]["mxu_select"],
             fleet_launches=fleet["launches"]["mxu_select"],
             mesh_chaos_launches=mesh_chaos["launches"]["mxu_select"],
             mesh_child_launches=mesh_child["mxu_select"]),
        dict(name="mxu_select_bf16", route="cuda",
             source=CSRC + "mxu_select_bf16.cu",
             replaces=REPLACES["mxu_select_bf16"],
             launches=select_launches["bf16"],
             fleet_brownout_launches=fleet["autoscale"]["launches"][
                 "mxu_select_bf16"],
             fleet_launches=fleet["launches"]["mxu_select_bf16"],
             mesh_chaos_launches=mesh_chaos["launches"]["mxu_select_bf16"],
             mesh_child_launches=mesh_child["mxu_select_bf16"],
             **{f"fleet_brownout_{key}": v for key, v in
                fleet["autoscale"]["brownout_kernel"].items()},
             max_abs_err=max(max_err["mxu_select_bf16"],
                             fleet["autoscale"]["brownout_kernel"][
                                 "max_abs_err"]),
             max_band_ratio=band_ratio[0],
             max_band_ratio_f32=band_ratio[1], shape="100k x 128 bf16",
             **select_timings["100k x 128 bf16"],
             fuzz_launches=fuzzed["launches"]["mxu_select_bf16"]),
        dict(name="mxu_select_split", route="cuda",
             source=CSRC + "mxu_select_split.cu",
             replaces=REPLACES["mxu_select_split"],
             launches=refused["launches"],
             max_abs_err=max_err["mxu_select_split"],
             shape="20k x 3 f32 k=1800", **split_timings,
             fuzz_launches=fuzzed["launches"]["mxu_select_split"],
             fleet_launches=fleet["launches"]["mxu_select_split"],
             mesh_chaos_launches=mesh_chaos["launches"]["mxu_select_split"],
             mesh_child_launches=mesh_child["mxu_select_split"]),
    ]
    print(f"  FoF (plain torch, no kernel of its own): "
          f"{json.dumps(fof_runs)}", flush=True)
    print(f"  plane feed: {json.dumps(planes)}", flush=True)
    print(f"  serving: {json.dumps(serve)}", flush=True)
    print(f"  MXU tier: {json.dumps(mxu_tier)}", flush=True)
    print(f"  legacy route: {json.dumps(legacy)}", flush=True)
    print(f"  sharded: {json.dumps(sharded)}", flush=True)
    print(f"  pod: {json.dumps(pod)}", flush=True)
    print(f"  elastic: {json.dumps(elastic)}", flush=True)
    print(f"  fuzz: {json.dumps(fuzzed)}", flush=True)
    print(f"  fleet: {json.dumps(fleet)}", flush=True)
    print(f"  mesh and chaos: {json.dumps(mesh_chaos)}", flush=True)
    print(f"  CLI and observability: {json.dumps(cli_obs)}", flush=True)
    print(f"smoke: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
