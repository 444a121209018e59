"""The PyTorch port on an NVIDIA GPU: each CUDA kernel against its plain
version bit for bit, and GPU solves against CPU solves.

Marked ``cuda``: without a GPU each test skips.  This file imports only the
port, so on a GPU host without JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

The kernels and the plain versions round every multiply and add on its
own (the kernels are built with ``--fmad=false``), so d2, scores, ids and
certificates must be equal, not close (NaN deficit flags in the same
places).  The CPU solves run the plain versions with the same arithmetic,
so GPU and CPU results must be equal too.  The one exception is the bf16
selection (``csrc/mxu_select_bf16.cu``), whose q.p the tensor cores sum in
their own order: it is held to the contract stated in its source (equal
on exact inputs, within the certification band elsewhere).  The split
selection (``csrc/mxu_select_split.cu``) sums q.p in order on CUDA cores,
so it is equal to the plain version at both tiers.  External queries
(``KnnProblem.query``) on the card equal the same queries on the CPU, ids
and d2, through the class kernels and the streamed route; so do the
plane feed and friends-of-friends labels (``cluster.fof_labels``, plain
torch rounds whose link predicate rounds each operation on its own).
The grid route's MXU class scorer (``mxu.scorer.grid_class_topk``, plain
torch) equals its CPU run bit for bit too, NaN flags included.
"""

import json

import numpy as np
import pytest
import torch

import cuda_knearests_tpu_torch as pt
from cuda_knearests_tpu_torch.io import (generate_blue_noise,
                                         generate_clustered, generate_uniform)
from cuda_knearests_tpu_torch import mxu
from cuda_knearests_tpu_torch.mxu import kernel as mk
from cuda_knearests_tpu_torch.mxu import scorer as ms
from cuda_knearests_tpu_torch.mxu.topk import dot_error_bound, interleave_slots
from cuda_knearests_tpu_torch.ops import cuda_solve as cs


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel is built for sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, 50, 128])
def test_kernel_matches_plain_bit_for_bit(cuda_device, k):
    pts = generate_blue_noise(20_000, seed=12)
    prob = pt.KnnProblem.prepare(pts, pt.KnnConfig(k=min(k, 50)),
                                 device=cuda_device)
    cp = prob.aplan.classes[0]
    args = cp.pk.args()
    for excl in (True, False):
        before = cs.launches
        kd, ki = cs.supercell_topk(*args, k, excl)
        assert cs.launches == before + 1
        pd, pi = cs.supercell_topk_plain(*args, k, excl)
        n = prob.grid.n_points
        rows = [(torch.full((n, k), float("inf"), device=cuda_device),
                 torch.full((n, k), -1, dtype=torch.int32,
                            device=cuda_device)) for _ in range(2)]
        cs.supercell_topk(*args, k, excl, tgt=cp.tgt, out=rows[0])
        cs.supercell_topk_plain(*args, k, excl, tgt=cp.tgt, out=rows[1])
        torch.cuda.synchronize()
        assert torch.equal(ki, pi) and torch.equal(kd, pd)
        assert torch.equal(rows[0][0], rows[1][0])
        assert torch.equal(rows[0][1], rows[1][1])


@pytest.mark.cuda
def test_gpu_solve_equals_cpu_solve(cuda_device):
    pts = generate_clustered(20_000, seed=3)
    cfg = pt.KnnConfig(k=10, ring_radius=1)
    gpu = pt.KnnProblem.prepare(pts, cfg, device=cuda_device)
    cpu = pt.KnnProblem.prepare(pts, cfg, device="cpu")
    cs.launches = 0
    g, c = gpu.solve(), cpu.solve()
    assert cs.launches == len(gpu.aplan.classes)
    assert int(g.uncert_count) == int(c.uncert_count) > 0
    np.testing.assert_array_equal(g.neighbors, c.neighbors)
    np.testing.assert_array_equal(g.dists_sq, c.dists_sq)
    np.testing.assert_array_equal(gpu.get_knearests_original(),
                                  cpu.get_knearests_original())


def _equal_nan(a, b) -> bool:
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


def _select_inputs(rng, n, d, kind, device):
    """(points, (queries, q_ids, pts_il, cid_il)) of a self-solve, 300
    queries, on lattice coordinates (exact partial sums), random ones, or
    'separated' 10-point blobs of radius ~1e-3 at +-e_i (n = 20*d): a
    row's 9 nearest others are its blob and the next blob is ~sqrt(2)
    away, a gap that clears the bf16 band, so bf16 rows certify."""
    if kind == "separated":
        centers = np.concatenate([np.eye(d), -np.eye(d)])
        pts = np.repeat(centers, 10, axis=0) + rng.normal(size=(n, d)) * 1e-3
    elif kind == "lattice":
        pts = rng.integers(0, 6, (n, d)) * 2.5
    else:
        pts = rng.random((n, d)) * 100
    pts = pts.astype(np.float32)
    c_pad = -(-n // 128) * 128
    il = interleave_slots(c_pad)
    pp = np.zeros((c_pad, d), np.float32)
    pp[:n] = pts
    cid = np.where(il < n, il, -1).astype(np.int32)
    dev = lambda a: torch.as_tensor(np.ascontiguousarray(a),  # noqa: E731
                                    device=device)
    return pts, (dev(pts[:300]), dev(np.arange(min(300, n), dtype=np.int32)),
                 dev(pp[il]), dev(cid))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 17, 128])
def test_select_kernel_matches_plain_bit_for_bit(cuda_device, d):
    rng = np.random.default_rng(d)
    for n, kind in ((1000, "lattice"), (1000, "random"), (40, "random")):
        _, args = _select_inputs(rng, n, d, kind, cuda_device)
        for k in (1, 10, 50, 128):
            for m in sorted({1, 3, min(k, 128)}):
                for excl in (True, False):
                    before = mk.launches
                    got = mk.select(*args, k, m, d, excl, "f32")
                    assert mk.launches == before + 1
                    want = ms.select_plain(*args, k, m, d, excl, "f32")
                    torch.cuda.synchronize()
                    for g, w in zip(got, want):
                        assert torch.equal(g, w), (n, kind, k, m, excl)


@pytest.mark.cuda
@pytest.mark.parametrize("d,k,m,plan", [
    (64, 10, 3, (128, 32, True)),       # resident queries, two d-chunks
    (300, 10, 1, (128, 16, False)),     # queries streamed, ragged chunk
    (300, 50, 3, (128, 16, False)),
    (2048, 10, 10, (128, 16, False)),   # 128 chunks of 16 axes
    (2048, 128, 1, (128, 16, False)),
    (3, 900, 128, (16, 3, True)),       # lists past the old f32 limit
    (3, 900, 1, (16, 3, True)),
    (13, 1707, 3, (16, 8, False)),      # a 16-row block's narrower chunks
])
def test_select_kernel_wide_d_and_long_lists(cuda_device, d, k, m, plan):
    """The f32 kernel's other launch shapes (d-chunks, streamed queries,
    16-row blocks) against select_plain, bit for bit, and its prep pass
    against the plain prep."""
    assert mk.pick_launch(d, k, m) == plan
    rng = np.random.default_rng(d + k + m)
    for kind in ("lattice", "random"):
        _, args = _select_inputs(rng, 1000, d, kind, cuda_device)
        args = (args[0][:40].contiguous(), args[1][:40].contiguous(),
                *args[2:])
        for got, want in zip(mk.prep_f32(args[2], args[3]),
                             mk.prep_f32_plain(args[2], args[3])):
            assert torch.equal(got, want)
        for excl in (True, False):
            before = mk.launches, mk.prep_launches_f32
            got = mk.select(*args, k, m, d, excl, "f32")
            assert (mk.launches, mk.prep_launches_f32) == (
                before[0] + 1, before[1] + 2)
            want = ms.select_plain(*args, k, m, d, excl, "f32")
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w), (kind, excl)


def _certified_exact(pts, q, ids, cert, k, excl):
    """Every certified row's ids are a true top-k set of the f32 points in
    f64 arithmetic (ties allowed): as many as there are candidates, up to
    k, none beyond the true k-th distance."""
    p = torch.as_tensor(pts, device=q.device, dtype=torch.float64)
    rows = torch.nonzero(cert).flatten()
    d2 = ((q[rows].double()[:, None, :] - p[None]) ** 2).sum(-1)
    if excl:
        d2[torch.arange(rows.numel(), device=q.device), rows] = float("inf")
    avail = int(min(k, pts.shape[0] - (1 if excl else 0)))
    kth = torch.topk(d2, avail, dim=1, largest=False).values[:, -1]
    sel = ids[rows].long()
    assert bool((sel[:, :avail] >= 0).all())
    assert bool((sel[:, avail:] < 0).all())
    got = torch.gather(d2, 1, sel[:, :avail])
    assert bool((got <= kth[:, None]).all())


def _bf16_within_band(got, want, dump, s_plain, args, d):
    """Every selected score within the row's 2 * delta_max (measured from
    the kernel's own scores ``dump``), and 2 * delta_max within the f32
    term of B, 4 * (d + 8) * eps32 * (qn + pn_max)."""
    q, _, p, cid = args
    band = ms.score_band(dump, s_plain, cid)
    f32_term = dot_error_bound(ms.norms(q), mk.prep_plain(p, cid)[3], d,
                               "f32")
    assert bool((band <= f32_term).all())
    fin = torch.isfinite(want[1])
    assert torch.equal(torch.isfinite(got[1]), fin)
    diff = torch.where(fin, (got[1] - want[1]).abs(), 0.0)
    assert bool((diff <= band[:, None]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 17, 128])
def test_select_bf16_kernel_contract(cuda_device, d):
    """The bf16 kernel's contract: prep equal to its plain twin bit for bit;
    on lattice inputs the selection equal bit for bit; elsewhere every
    selected score within 2 * delta_max of the plain version's, with
    delta_max measured from the kernel's own scores and 2 * delta_max
    within the f32 term of B; certified rows exact, and on separated blobs
    at m = k at least 90% of the rows certified."""
    rng = np.random.default_rng(100 + d)
    for n, kind in ((1000, "lattice"), (1000, "random"), (40, "random"),
                    (20 * d, "separated")):
        pts, args = _select_inputs(rng, n, d, kind, cuda_device)
        q, _, p, cid = args
        for got, want in zip(mk.prep(p, cid), mk.prep_plain(p, cid)):
            assert torch.equal(got, want)
        s_plain = ms.score_tile(q, p, "bf16")
        kex = (((9, True), (10, False)) if kind == "separated" else
               [(k, e) for k in (1, 10, 50, 128) for e in (True, False)])
        for k, excl in kex:
            for m in sorted({1, 3, min(k, 128)}):
                before = mk.launches, mk.launches_bf16
                *got, dump = mk._select_bf16_with_scores(*args, k, m, d,
                                                         excl)
                assert (mk.launches, mk.launches_bf16) == (
                    before[0], before[1] + 1)
                want = ms.select_plain(*args, k, m, d, excl, "bf16")
                torch.cuda.synchronize()
                what = (n, kind, k, m, excl)
                if kind == "lattice":
                    for g, w in zip(got, want):
                        assert torch.equal(g, w), what
                _bf16_within_band(got, want, dump, s_plain, args, d)
                _certified_exact(pts, q, got[0], got[2], k, excl)
                if kind == "separated" and m == k:
                    assert float(got[2].float().mean()) >= 0.9, what


@pytest.mark.cuda
@pytest.mark.parametrize("d,k,m,plan", [
    (300, 10, 1, (128, 128, True)),     # three d-chunks, the last ragged
    (1000, 10, 3, (128, 64, False)),    # queries streamed with candidates
    (3, 900, 128, (16, 16, True)),      # lists that fit one 16-row warp
])
def test_select_bf16_kernel_launch_shapes(cuda_device, d, k, m, plan):
    """The bf16 kernel's other launch shapes against select_plain: on
    lattice inputs bit for bit; on random ones within the band."""
    assert mk.pick_launch_bf16(d, k, m) == plan
    rng = np.random.default_rng(d + k)
    for kind in ("lattice", "random"):
        pts, args = _select_inputs(rng, 1000, d, kind, cuda_device)
        args = (args[0][:40].contiguous(), args[1][:40].contiguous(),
                *args[2:])
        s_plain = ms.score_tile(args[0], args[2], "bf16")
        *got, dump = mk._select_bf16_with_scores(*args, k, m, d, True)
        want = ms.select_plain(*args, k, m, d, True, "bf16")
        torch.cuda.synchronize()
        if kind == "lattice":
            for g, w in zip(got, want):
                assert torch.equal(g, w)
        _bf16_within_band(got, want, dump, s_plain, args, d)
        _certified_exact(pts, args[0], got[0], got[2], k, True)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_gpu_solve_general_equals_cpu(cuda_device, precision):
    """f32: the GPU solve equals the CPU solve.  bf16 (q.p on tensor
    cores): refined rows equal up to exact distance ties; unrefined, rows
    certified on both devices agree and recall meets the fold's bound."""
    rng = np.random.default_rng(5)
    pts = (rng.random((3000, 24)) * 10).astype(np.float32)
    for rt, refine in ((1.0, "brute"), (0.6, "none")):
        mk.launches = mk.launches_bf16 = 0
        g = mxu.solve_general(pts, k=10, recall_target=rt, refine=refine,
                              precision=precision, device=cuda_device)
        assert g.backend == "cuda"
        assert (mk.launches, mk.launches_bf16) == (
            (1, 0) if precision == "f32" else (0, 1))
        c = mxu.solve_general(pts, k=10, recall_target=rt, refine=refine,
                              precision=precision, device="cpu")
        if precision == "f32":
            np.testing.assert_array_equal(g.neighbors, c.neighbors)
            np.testing.assert_array_equal(g.dists_sq, c.dists_sq)
            np.testing.assert_array_equal(g.certified, c.certified)
            continue
        if refine == "brute":
            np.testing.assert_array_equal(g.dists_sq, c.dists_sq)
            for r, col in zip(*np.nonzero(g.neighbors != c.neighbors)):
                assert int((c.dists_sq[r] == c.dists_sq[r, col]).sum()) > 1
            continue
        both = g.certified & c.certified
        np.testing.assert_array_equal(np.sort(g.neighbors[both], axis=1),
                                      np.sort(c.neighbors[both], axis=1))
        p64 = pts.astype(np.float64)
        d2 = ((p64[:, None, :] - p64[None]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        kth = np.sort(d2, axis=1)[:, 9]
        band = 2 * dot_error_bound((p64 ** 2).sum(1), (p64 ** 2).sum(1).max(),
                                   24, "bf16")
        got = np.take_along_axis(d2, g.neighbors.astype(np.int64), axis=1)
        recall = float((got <= (kth + band)[:, None]).sum()) / got.size
        assert recall >= g.bound


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 30])
def test_blocked_kernel_matches_plain_bit_for_bit(cuda_device, k):
    pts = generate_blue_noise(20_000, seed=12)
    prob = pt.KnnProblem.prepare(pts, pt.KnnConfig(k=k), device=cuda_device)
    cp = prob.aplan.classes[0]
    m = pt.config.blocked_topm(k, cp.ccap)
    assert m
    args = list(cp.pk.args())
    # the pack as packed, and with candidates in storage order (no
    # interleave), which crowds neighbours into blocks: deficit rows
    order = torch.sort(torch.where(args[7] >= 0, args[7], 2**30),
                       dim=1).indices
    crowded = args[:4] + [torch.gather(a, 1, order) for a in args[4:]]
    n = prob.grid.n_points
    for pack in (args, crowded):
        for excl in (True, False):
            before = cs.blocked_launches
            kd, ki = cs.blocked_topk(*pack, k, m, excl)
            assert cs.blocked_launches == before + 1
            pd, pi = cs.blocked_topk_plain(*pack, k, m, excl)
            rows = [(torch.full((n, k), float("inf"), device=cuda_device),
                     torch.full((n, k), -1, dtype=torch.int32,
                                device=cuda_device)) for _ in range(2)]
            cs.blocked_topk(*pack, k, m, excl, tgt=cp.tgt, out=rows[0])
            cs.blocked_topk_plain(*pack, k, m, excl, tgt=cp.tgt,
                                  out=rows[1])
            torch.cuda.synchronize()
            assert torch.equal(ki, pi) and _equal_nan(kd, pd)
            assert torch.equal(rows[0][1], rows[1][1])
            assert _equal_nan(rows[0][0], rows[1][0])
    assert bool(torch.isnan(kd).any())  # the crowded pack has deficits


@pytest.mark.cuda
def test_gpu_blocked_solve_equals_cpu_solve(cuda_device):
    pts = generate_blue_noise(20_000, seed=3)
    cfg = pt.KnnConfig(k=30, kernel="blocked")
    gpu = pt.KnnProblem.prepare(pts, cfg, device=cuda_device)
    cpu = pt.KnnProblem.prepare(pts, cfg, device="cpu")
    cs.blocked_launches = 0
    g, c = gpu.solve(), cpu.solve()
    assert cs.blocked_launches == len(gpu.aplan.classes)
    assert int(g.uncert_count) == int(c.uncert_count)
    np.testing.assert_array_equal(g.neighbors, c.neighbors)
    np.testing.assert_array_equal(g.dists_sq, c.dists_sq)


def _solve_pair(pts, cfg, cuda_device):
    gpu = pt.KnnProblem.prepare(pts, cfg, device=cuda_device)
    cpu = pt.KnnProblem.prepare(pts, cfg, device="cpu")
    cs.launches = 0
    g, c = gpu.solve(), cpu.solve()
    assert int(g.uncert_count) == int(c.uncert_count)
    np.testing.assert_array_equal(g.neighbors, c.neighbors)
    np.testing.assert_array_equal(g.dists_sq, c.dists_sq)
    return gpu, cpu


@pytest.mark.cuda
def test_gpu_k1000_solve_streams_and_equals_cpu_solve(cuda_device):
    """k >= 893 does not fit the class kernel's lists: every class takes
    the streamed route (plain torch on both devices), and the GPU solve
    equals the CPU solve."""
    pts = generate_blue_noise(6000, seed=13)
    gpu, _ = _solve_pair(pts, pt.KnnConfig(k=1000), cuda_device)
    assert {cp.route for cp in gpu.aplan.classes} == {"streamed"}
    assert cs.launches == 0
    assert gpu.get_knearests().shape == (6000, 1000)


@pytest.mark.cuda
def test_gpu_forced_budget_streams_one_class(cuda_device, monkeypatch):
    """A budget of the all-streamed plan and one class's packs: that class
    keeps the kernel (one launch), the other streams, and the GPU solve
    equals the CPU solve under the same budget."""
    from cuda_knearests_tpu_torch.ops import adaptive

    pts = generate_clustered(20_000, seed=3)
    cfg = pt.KnnConfig(k=10, ring_radius=1)
    free = pt.KnnProblem.prepare(pts, cfg, device="cpu")
    _, specs = adaptive.plan_class_specs(free.grid.cell_counts.numpy(),
                                         free.grid.dim, cfg)
    extra = [adaptive.kernel_extra_bytes(sp, cfg) for sp in specs]
    budget = (adaptive.streamed_plan_bytes(specs, cfg, free.grid.n_points)
              + min(extra))
    monkeypatch.setattr(adaptive, "hbm_budget_bytes",
                        lambda device, cfg=None: budget)
    gpu, _ = _solve_pair(pts, cfg, cuda_device)
    routes = [cp.route for cp in gpu.aplan.classes]
    assert sorted(routes) == ["kernel", "streamed"]
    assert routes[int(np.argmax(extra))] == "streamed"
    assert cs.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("cloud,n,k,ring,rows", [
    ("blue", 6000, 1000, None, None), ("blue", 30_000, 10, None, None),
    ("blue", 30_000, 10, None, 16), ("clustered", 20_000, 10, 1, 3)])
def test_streamed_step_memory_within_its_model(cuda_device, cloud, n, k,
                                               ring, rows):
    """The widest class of a cloud, streamed on the card: the peak its
    steps allocate (torch.cuda.max_memory_allocated above what was
    allocated before) stays within ``stream_step_bytes``, the model the
    plan routes by.  Prints the measured bytes per (query slot, tile + k
    slot)."""
    from cuda_knearests_tpu_torch.ops import adaptive
    from cuda_knearests_tpu_torch.ops.solve import _box_cell_ids, pack_cells

    gen = generate_blue_noise if cloud == "blue" else generate_clustered
    cfg = pt.KnnConfig(k=k, ring_radius=ring)
    prob = pt.KnnProblem.prepare(gen(n, seed=19), cfg, device=cuda_device)
    g = prob.grid
    sc, specs = adaptive.plan_class_specs(g.cell_counts.cpu().numpy(),
                                          g.dim, cfg)
    sp = max(specs, key=lambda c: c.qcap * c.ccap)
    s = cfg.supercell
    own = torch.as_tensor(_box_cell_ids(sc[sp.rows], 0, 0, s, g.dim),
                          device=cuda_device)
    cand = torch.as_tensor(_box_cell_ids(sc[sp.rows], -sp.radius, sp.radius,
                                         s, g.dim), device=cuda_device)
    q_idx, q_ok = pack_cells(own, g.cell_starts, g.cell_counts, sp.qcap)
    q = g.points[q_idx.long()]
    tile = adaptive.stream_tile(sp.ccap)
    rows = rows or adaptive.streamed_rows_chunk(sp.rows.size, sp.qcap, tile)
    slots = q_idx.numel()
    out = (torch.empty((slots, k), device=cuda_device),
           torch.empty((slots, k), dtype=torch.int32, device=cuda_device))
    tgt = torch.arange(slots, device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    adaptive.streamed_topk(g.points, g.cell_starts, g.cell_counts, cand, q,
                           q_ok, q_idx, k, sp.ccap, tile, rows, tgt=tgt,
                           out=out)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    model = adaptive.stream_step_bytes(rows, sp.qcap, sp.ccap, k)
    per_slot = peak / (rows * sp.qcap * (tile + k))
    print(f"streamed step {cloud} n={n} k={k}: rows {rows}, qcap {sp.qcap},"
          f" ccap {sp.ccap}, tile {tile}: peak {peak} bytes, model {model} "
          f"({peak / model:.3f}), {per_slot:.2f} bytes per (query, tile + k)"
          f" slot")
    assert peak <= model


def _class_pack(rng, n_sc, qcap, ccap, max_real_c, device):
    """A random class pack on a coarse lattice (many exact distance ties):
    per supercell a random number of real candidates (some below k, some
    none), its queries a subset of them (so exclude_self bites) in random
    slots, pads with garbage coordinates and sentinel ids, the last
    supercell all pads; and a forward row map over the real query slots
    (pads carry the out-of-range row n)."""
    from cuda_knearests_tpu_torch.ops.cuda_solve import _PAD_C, _PAD_Q

    lattice = lambda: rng.integers(0, 24, (n_sc, ccap)).astype(  # noqa: E731
        np.float32) * 7.5
    cx, cy, cz = lattice(), lattice(), lattice()
    cid = np.full((n_sc, ccap), _PAD_C, np.int32)
    q = [rng.random((n_sc, qcap)).astype(np.float32) * 1000 for _ in "xyz"]
    qid = np.full((n_sc, qcap), _PAD_Q, np.int32)
    for s in range(n_sc - 1):
        nc = int(rng.integers(0, max_real_c + 1))
        slots = rng.permutation(ccap)[:nc]
        cid[s, slots] = rng.permutation(1 << 20)[:nc]
        nq = min(qcap, nc, int(rng.integers(0, qcap + 1)))
        pick = slots[rng.permutation(nc)[:nq]]
        at = rng.permutation(qcap)[:nq]
        for a, c in zip(q, (cx, cy, cz)):
            a[s, at] = c[s, pick]
        qid[s, at] = cid[s, pick]
    real = (qid >= 0).reshape(-1)
    n_rows = int(real.sum())
    tgt = np.full(n_sc * qcap, n_rows, np.int32)
    tgt[real] = rng.permutation(n_rows)
    dev = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return ([dev(a) for a in (*q, qid, cx, cy, cz, cid)], dev(tgt), n_rows)


def _check_supercell_modes(args, tgt, n_rows, k, excl, device):
    """The one-stage kernel against its plain version in both modes, one
    launch each."""
    before = cs.launches
    kd, ki = cs.supercell_topk(*args, k, excl)
    rows = [(torch.full((n_rows, k), float("inf"), device=device),
             torch.full((n_rows, k), -1, dtype=torch.int32, device=device))
            for _ in range(2)]
    cs.supercell_topk(*args, k, excl, tgt=tgt, out=rows[0])
    assert cs.launches == before + 2
    pd, pi = cs.supercell_topk_plain(*args, k, excl)
    cs.supercell_topk_plain(*args, k, excl, tgt=tgt, out=rows[1])
    torch.cuda.synchronize()
    assert torch.equal(ki, pi) and torch.equal(kd, pd)
    assert torch.equal(rows[0][0], rows[1][0])
    assert torch.equal(rows[0][1], rows[1][1])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, 31, 32, 33, 50, 64, 65, 128, 500, 892])
def test_supercell_kernel_every_list_width(cuda_device, k):
    """Every list width the launcher instantiates and its edges (k = 32*E
    and one past it, k = 892 the gate's last), on packs whose qcap is not
    a multiple of 32 and whose last supercell is all pads, with rows that
    hold fewer than k candidates: equal to the plain version bit for bit
    in both modes, both exclude_self values."""
    rng = np.random.default_rng(k)
    ccap = max(384, -(-(k + 100) // 128) * 128)
    args, tgt, n_rows = _class_pack(rng, 7, 45, ccap, ccap, cuda_device)
    plan = cs.topk_plan(k, 45, ccap)
    assert 32 * plan.lane_entries >= k and plan.tile >= ccap
    for excl in (True, False):
        _check_supercell_modes(args, tgt, n_rows, k, excl, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, 50, 128])
def test_supercell_kernel_streams_wide_classes(cuda_device, k):
    """A ccap beyond the staged tile: the block streams the candidates in
    tiles, every warp in step, and still equals the plain version bit for
    bit in both modes."""
    rng = np.random.default_rng(100 + k)
    ccap = 2 * cs._TOPK_TILE + 333
    args, tgt, n_rows = _class_pack(rng, 4, 70, ccap, ccap, cuda_device)
    assert cs.topk_plan(k, 70, ccap).tile < ccap
    for excl in (True, False):
        _check_supercell_modes(args, tgt, n_rows, k, excl, cuda_device)


def _crowd(args):
    """The pack with each supercell's candidates in ascending x: spatial
    neighbours crowd into one 128-slot block, so the blocked kernel meets
    rows where a block holds more than m of the exact top-k."""
    order = torch.sort(args[4], dim=1, stable=True).indices
    return list(args[:4]) + [torch.gather(a, 1, order).contiguous()
                             for a in args[4:]]


def _check_blocked_modes(args, tgt, n_rows, k, m, excl, device):
    """The blocked kernel against its plain version in both modes, one
    launch each: ids equal, d2 equal with NaN in the same places."""
    before = cs.blocked_launches
    kd, ki = cs.blocked_topk(*args, k, m, excl)
    rows = [(torch.full((n_rows, k), float("inf"), device=device),
             torch.full((n_rows, k), -1, dtype=torch.int32, device=device))
            for _ in range(2)]
    cs.blocked_topk(*args, k, m, excl, tgt=tgt, out=rows[0])
    assert cs.blocked_launches == before + 2
    pd, pi = cs.blocked_topk_plain(*args, k, m, excl)
    cs.blocked_topk_plain(*args, k, m, excl, tgt=tgt, out=rows[1])
    torch.cuda.synchronize()
    assert torch.equal(ki, pi) and _equal_nan(kd, pd)
    assert torch.equal(rows[0][1], rows[1][1])
    assert _equal_nan(rows[0][0], rows[1][0])


def _blocked_ccap(k):
    """The narrowest ccap, a multiple of 128 of at least 384 and k + 100,
    at which ``blocked_topm`` finds k eligible."""
    ccap = max(384, -(-(k + 100) // 128) * 128)
    while not pt.config.blocked_topm(k, ccap):
        ccap += 128
    return ccap


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, 31, 32, 33, 50, 64, 65, 128, 500, 876])
def test_blocked_kernel_every_list_width(cuda_device, k):
    """Every list width the blocked kernel instantiates and its edges, up to
    the gate's (k + m = 892 at k = 876), each at the narrowest ccap where
    ``blocked_topm`` takes k (k=500 and 876 stream theirs in tiles), on
    lattice packs (exact ties; qcap 45, an all-pad supercell, rows with
    fewer than k candidates) as packed and crowded: equal to the plain
    version bit for bit in both modes, both exclude_self values."""
    rng = np.random.default_rng(1000 + k)
    ccap = _blocked_ccap(k)
    m = pt.config.blocked_topm(k, ccap)
    assert k + m <= 892 and (k != 876 or k + m == 892)
    plan = cs.topk_plan(k, 45, ccap, m)
    assert 32 * plan.lane_entries >= k
    args, tgt, n_rows = _class_pack(rng, 7, 45, ccap, ccap, cuda_device)
    for pack in (args, _crowd(args)):
        for excl in (True, False):
            _check_blocked_modes(pack, tgt, n_rows, k, m, excl, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, 500, 764])
def test_blocked_kernel_keeps_whole_blocks(cuda_device, k):
    """m = 128: every block keeps all it has, rem stays inf and no row
    carries NaN; the kernel still equals the plain version (k = 764 is the
    gate's last k at this m)."""
    rng = np.random.default_rng(2000 + k)
    ccap = max(384, -(-(k + 100) // 128) * 128)
    args, tgt, n_rows = _class_pack(rng, 5, 45, ccap, ccap, cuda_device)
    for pack in (args, _crowd(args)):
        for excl in (True, False):
            _check_blocked_modes(pack, tgt, n_rows, k, 128, excl,
                                 cuda_device)
    assert not bool(torch.isnan(cs.blocked_topk(*args, k, 128, True)[0])
                    .any())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, 50, 128])
def test_blocked_kernel_streams_wide_classes(cuda_device, k):
    """A ccap beyond the blocked kernel's staged tile: lists wait in their
    output rows between tiles as (d2, pack slot), and the kernel still
    equals the plain version bit for bit, as packed and crowded."""
    rng = np.random.default_rng(3000 + k)
    ccap = -(-(2 * cs._BLOCKED_TILE + 333) // 128) * 128
    m = pt.config.blocked_topm(k, ccap)
    assert m and cs.topk_plan(k, 70, ccap, m).tile < ccap
    args, tgt, n_rows = _class_pack(rng, 4, 70, ccap, ccap, cuda_device)
    for pack in (args, _crowd(args)):
        for excl in (True, False):
            _check_blocked_modes(pack, tgt, n_rows, k, m, excl, cuda_device)


@pytest.mark.cuda
def test_gpu_brute_gate_refused_k_equals_cpu(cuda_device):
    """k = 1,800 at d=3: no selection block holds the lists, so the GPU
    solve runs the split selection (backend 'cuda_split', its launches
    counted, no one-block kernel launched) and equals the CPU solve."""
    pts = (np.random.default_rng(6).random((6000, 3)) * 1000).astype(
        np.float32)
    before = (mk.launches, mk.launches_bf16, mk.split_launches)
    g = mxu.solve_general(pts, k=1800, device=cuda_device)
    assert g.backend == "cuda_split"
    assert (mk.launches, mk.launches_bf16) == before[:2]
    assert mk.split_launches > before[2]
    c = mxu.solve_general(pts, k=1800, device="cpu")
    assert c.backend == "plain"
    np.testing.assert_array_equal(g.neighbors, c.neighbors)
    np.testing.assert_array_equal(g.dists_sq, c.dists_sq)
    np.testing.assert_array_equal(g.certified, c.certified)
    assert g.uncert_count == c.uncert_count


# Split-selection cases that select for every query, not 40 of them.
_SPLIT_ALL_QUERIES = {(3, 3000, 1800, 128)}


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("d,n,k,m", [
    (3, 1000, 1, 1), (3, 1000, 10, 3), (3, 1000, 50, 128),
    (3, 40, 50, 1),                        # fewer candidates than k
    (17, 1000, 128, 7), (128, 1000, 10, 128),
    (3, 2000, 1800, 128), (3, 2000, 1800, 100),  # the gate refuses these
    (128, 1700, 1590, 128),
    (3, 9000, 8200, 128),                  # the sort in a scratch row
    (3, 3000, 1800, 128),                  # direct arm, 750 blocks
    (3, 4000, 1800, 128),                  # lattice buckets overflow n2
    (3, 1500, 1800, 128), (3, 1801, 1800, 128),  # n < k + 1, n = k + 1
    (mk._SPLIT_DIRECT_MAX_D, 2000, 1800, 128),   # either side of the
    (mk._SPLIT_DIRECT_MAX_D + 1, 2000, 1800, 128),  # arms' threshold
    (3, 4000, 2100, 128),                  # direct rows of 4,096 in scratch
])
def test_split_select_matches_plain_bit_for_bit(cuda_device, precision, d,
                                                n, k, m):
    """The split selection against select_plain, bit for bit at both
    tiers, through the arm split_plan picks and the other one (at m =
    128): the fold's kept-key sort (m < 128) and its pass-through (m =
    128), the two-pass selection over ties (lattice: buckets refined past
    the row's width) and spread scores, missing keys at rank k, and the
    sort in shared memory and in a device scratch row."""
    rng = np.random.default_rng(d + n + k + m)
    arms = ("direct", "pool") if m >= 128 else ("pool",)
    for kind in ("lattice", "random"):
        pts, args = _select_inputs(rng, n, d, kind, cuda_device)
        if (d, n, k, m) in _SPLIT_ALL_QUERIES:
            args = (torch.as_tensor(pts, device=cuda_device),
                    torch.arange(n, dtype=torch.int32, device=cuda_device),
                    *args[2:])
        elif k > 1000:
            args = (args[0][:40].contiguous(), args[1][:40].contiguous(),
                    *args[2:])
        for excl in (True, False):
            want = ms.select_plain(*args, k, m, d, excl, precision)
            for arm in (None,) + arms:
                before = mk.split_launches
                got = mk.select_split(*args, k, m, d, excl, precision,
                                      arm=arm)
                assert mk.split_launches > before
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (kind, excl, arm)


@pytest.mark.cuda
def test_split_direct_arm_launches_once_and_counts_passes(cuda_device):
    """The direct arm answers all queries in one launch with its rows in
    shared memory, and reports its passes: two (histogram, gather) or
    more (a bucket refined) for every block."""
    rng = np.random.default_rng(9)
    n, k = 3000, 1800
    pts, args = _select_inputs(rng, n, 3, "random", cuda_device)
    args = (torch.as_tensor(pts, device=cuda_device),
            torch.arange(n, dtype=torch.int32, device=cuda_device),
            *args[2:])
    assert mk.split_plan(n, args[2].shape[0], 3, k, 128).arm == "direct"
    passes = torch.zeros(mk.SPLIT_MAX_PASSES, dtype=torch.int32,
                         device=cuda_device)
    before = mk.split_launches
    mk.select_split(*args, k, 128, 3, True, passes=passes)
    assert mk.split_launches == before + 1
    counts = passes.cpu().numpy()
    assert counts.sum() == -(-n // mk._SPLIT_DIRECT_QUERIES)
    assert counts[:2].sum() == 0 and counts[2] > 0


def _query_pair(gpu, cpu, queries, counter, launched):
    """One query on the card, counted, and the same on the CPU: equal ids
    and d2, at most two host round trips, ``launched`` more launches of
    the class kernel ``counter`` names."""
    from cuda_knearests_tpu_torch.runtime import dispatch

    before = getattr(cs, counter)
    dispatch.reset_stats()
    g = gpu.query(queries)
    assert dispatch.stats().host_syncs <= dispatch.SYNC_BUDGET
    assert getattr(cs, counter) == before + launched
    c = cpu.query(queries)
    np.testing.assert_array_equal(g[0], c[0])
    np.testing.assert_array_equal(g[1], c[1])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,counter", [("kpass", "launches"),
                                            ("blocked", "blocked_launches")])
def test_gpu_query_equals_cpu_query(cuda_device, kernel, counter):
    """Uniform and clustered queries (the latter inflate q2cap) against a
    20k cloud: one mode (a) launch per class with queries, GPU = CPU bit
    for bit; with the clustered cloud's several classes and fallback rows
    too."""
    from cuda_knearests_tpu_torch.ops import adaptive

    for pts, kw in ((generate_blue_noise(20_000, seed=41), dict(k=10)),
                    (generate_clustered(20_000, seed=3),
                     dict(k=10, ring_radius=1))):
        cfg = pt.KnnConfig(kernel=kernel, **kw)
        gpu = pt.KnnProblem.prepare(pts, cfg, device=cuda_device)
        cpu = pt.KnnProblem.prepare(pts, cfg, device="cpu")
        for q in (generate_uniform(5000, seed=42),
                  generate_clustered(5000, seed=43), pts[:3000]):
            qcls, _ = adaptive.bucket_queries(gpu.grid, cfg, gpu.aplan, q)
            _query_pair(gpu, cpu, q, counter,
                        len(np.unique(qcls[qcls >= 0])))


@pytest.mark.cuda
def test_gpu_query_forced_streamed_equals_cpu(cuda_device, monkeypatch):
    """A class whose query pack exceeds the memory budget streams its
    queries on the card (no kernel launch) a few supercells a step, and
    answers what the CPU's kernel route answers."""
    from cuda_knearests_tpu_torch.ops import adaptive

    pts = generate_blue_noise(20_000, seed=44)
    cfg = pt.KnnConfig(k=8, supercell=1, ring_radius=1)
    gpu = pt.KnnProblem.prepare(pts, cfg, device=cuda_device)
    cpu = pt.KnnProblem.prepare(pts, cfg, device="cpu")
    q = generate_uniform(5000, seed=45)
    qcls, qrow = adaptive.bucket_queries(gpu.grid, cfg, gpu.aplan, q)
    (b,) = adaptive.plan_queries(cfg, gpu.aplan, qcls, qrow, 8, None)
    assert b.route == "kernel"
    _query_pair(gpu, cpu, q, "launches", 1)
    want = cpu.query(q)
    budget = b.pack_bytes + (q.shape[0] + 1) * 8 * 8 - 1
    monkeypatch.setattr(adaptive, "hbm_budget_bytes",
                        lambda device, cfg=None: budget)
    (r,) = adaptive.plan_queries(cfg, gpu.aplan, qcls, qrow, 8, budget)
    assert r.route == "streamed" and r.step_rows < b.n_sc
    before = cs.launches
    got = gpu.query(q)
    assert cs.launches == before
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


_SPACING_20K = 1000.0 / 20_000 ** (1.0 / 3.0)
# (name, cloud, b, density): uniform clouds at the sparse, percolating
# and dense linking lengths; the clustered cloud's densest cell at the
# default density holds 909 points (refused, as the reference refuses
# it), so it runs on a finer grid
FOF_CLOUDS = [
    ("uniform-0.4", lambda: generate_uniform(20_000, seed=51),
     0.4 * _SPACING_20K, 3.1),
    ("uniform-1.0", lambda: generate_uniform(20_000, seed=52),
     1.0 * _SPACING_20K, 3.1),
    ("uniform-2.2", lambda: generate_uniform(20_000, seed=53),
     2.2 * _SPACING_20K, 3.1),
    ("clustered", lambda: generate_clustered(20_000, seed=3), 6.0, 0.05)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,make,b,density", FOF_CLOUDS,
                         ids=[c[0] for c in FOF_CLOUDS])
def test_gpu_fof_equals_cpu_fof(cuda_device, name, make, b, density):
    """The link predicate rounds each operation on its own on both
    devices, so the card links exactly the pairs the CPU links: equal
    labels, sizes and rounds, in rounds + 1 host round trips."""
    from cuda_knearests_tpu_torch.cluster import fof_labels
    from cuda_knearests_tpu_torch.cluster.compare import check_fof_bracket

    pts = make()
    g = fof_labels(pts, b, density=density, device=cuda_device)
    c = fof_labels(pts, b, density=density, device="cpu")
    np.testing.assert_array_equal(g.labels, c.labels)
    np.testing.assert_array_equal(g.sizes, c.sizes)
    assert (g.rounds, g.n_clusters, g.dim, g.cell_max) == \
        (c.rounds, c.n_clusters, c.dim, c.cell_max)
    assert g.host_syncs == g.rounds + 1
    # labels and sizes well formed against a trivial bracket
    n = pts.shape[0]
    assert check_fof_bracket(g.labels, g.sizes, np.arange(n),
                             np.zeros(n, np.int64)) is None


@pytest.mark.cuda
def test_gpu_fof_refused_before_any_device_allocation(cuda_device,
                                                      monkeypatch):
    """A cloud over the pair-slot budget (the 900k blue cube's case, with
    the budget cut to this cloud's size) is refused before the grid is
    built on the card."""
    from cuda_knearests_tpu_torch.cluster import fof
    from cuda_knearests_tpu_torch.utils.memory import LaunchBudgetError

    pts = generate_blue_noise(20_000, seed=54)
    plan = fof.plan_fof(pts, 10.0)
    monkeypatch.setattr(fof, "MAX_PAIR_SLOTS",
                        20_000 * plan.m * 27 - 1)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda_device)
    with pytest.raises(LaunchBudgetError) as e:
        fof.fof_labels(pts, 10.0, device=cuda_device)
    assert e.value.site == "cluster.fof" and e.value.kind == "oom"
    assert torch.cuda.memory_allocated(cuda_device) == before


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,counter", [("kpass", "launches"),
                                            ("blocked", "blocked_launches")])
def test_gpu_plane_feed_equals_cpu(cuda_device, kernel, counter):
    """solve() with plane_feed=True, get_planes() and query(planes=True)
    on the card equal the CPU's bit for bit, through the class kernels,
    within two host round trips a call."""
    from cuda_knearests_tpu_torch.runtime import dispatch

    pts = generate_clustered(20_000, seed=3)
    cfg = pt.KnnConfig(k=8, ring_radius=1, plane_feed=True, kernel=kernel)
    gpu = pt.KnnProblem.prepare(pts, cfg, device=cuda_device)
    cpu = pt.KnnProblem.prepare(pts, cfg, device="cpu")
    before = getattr(cs, counter)
    dispatch.reset_stats()
    g = gpu.solve()
    assert dispatch.stats().host_syncs <= dispatch.SYNC_BUDGET
    assert getattr(cs, counter) > before
    c = cpu.solve()
    np.testing.assert_array_equal(g.planes, c.planes)
    assert gpu.get_planes() is g.planes
    q = generate_uniform(5000, seed=55)
    dispatch.reset_stats()
    gq = gpu.query(q, planes=True)
    assert dispatch.stats().host_syncs <= dispatch.SYNC_BUDGET
    cq = cpu.query(q, planes=True)
    for a, b in zip(gq, cq):
        np.testing.assert_array_equal(a, b)


def _serve_stream(n0: int):
    """A seeded mutating request stream (queries, inserts, deletes, a
    compaction at compact_threshold=64, a fof request): (t, kind, payload,
    k) per request."""
    from cuda_knearests_tpu_torch.serve import LoadSpec, build_schedule

    items = [(it["t"], it["kind"], it["payload"], it.get("k"))
             for it in build_schedule(
                 LoadSpec(rate=400.0, requests=60, mutation_ratio=0.3,
                          seed=61, batch_mix=((1, 0.4), (5, 0.3),
                                              (29, 0.3))),
                 n_current=n0)]
    items.insert(30, (items[29][0], "fof", 25.0, None))
    return items


def _serve_replay(daemon, items):
    """``items`` at their times on a synthetic clock, so two daemons form
    the same batches; responses by request id."""
    out = []
    for i, (t, kind, payload, k) in enumerate(items):
        out += daemon.poll(t)
        out += daemon.submit(req_id=i, kind=kind, payload=payload, k=k, now=t)
    out += daemon.drain(items[-1][0] + 1.0)
    return {r.req_id: r for r in out}


@pytest.mark.cuda
def test_gpu_serve_session_equals_cpu(cuda_device):
    """One seeded mutating session on the card equals the same session on
    the CPU: the same responses, ids equal and d2 bit for bit (the class
    kernels equal their plain versions, and the overlay's brute calls
    round as they do), FoF labels equal; after warmup the card's session
    builds and loads no kernel library and launches the class kernel."""
    from cuda_knearests_tpu_torch.runtime import dispatch
    from cuda_knearests_tpu_torch.serve import ServeConfig, ServeDaemon

    pts = generate_uniform(20_000, seed=60)
    cfg = ServeConfig(max_batch=32, max_delay_s=0.004, compact_threshold=64)
    items = _serve_stream(pts.shape[0])
    daemons = [ServeDaemon(pt.KnnProblem.prepare(pts, pt.KnnConfig(k=10),
                                                 device=dev), cfg)
               for dev in (cuda_device, "cpu")]
    before = dispatch.kernel_stats()
    gpu = _serve_replay(daemons[0], items)
    after = dispatch.kernel_stats()
    cpu = _serve_replay(daemons[1], items)
    assert len(gpu) == len(cpu) == len(items)
    assert after["kernel_builds"] == before["kernel_builds"]
    assert after["kernel_loads"] == before["kernel_loads"]
    assert after["kernel_launches"] > before["kernel_launches"]
    for i, (_, kind, _, _) in enumerate(items):
        g, c = gpu[i], cpu[i]
        assert (g.ok, g.failure_kind, g.n_points) == \
            (c.ok, c.failure_kind, c.n_points), (i, kind, g.error)
        assert g.ok, (i, kind, g.error)
        for name in ("ids", "d2", "labels"):
            a, b = getattr(g, name), getattr(c, name)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype
    stats = [d.overlay.stats for d in daemons]
    assert stats[0] == stats[1] and stats[0].compactions >= 1
    assert stats[0].resolved_rows > 0 and stats[0].delta_launches > 0
    assert daemons[0].overlay.base.device.type == "cuda"


@pytest.mark.cuda
def test_gpu_serve_steady_zero_recompiles(cuda_device):
    """An open-loop session on the card after warmup: zero recompiles,
    the class kernel launched, no failed request."""
    from cuda_knearests_tpu_torch.serve import (LoadSpec, ServeConfig,
                                                ServeDaemon, run_session)

    prob = pt.KnnProblem.prepare(generate_blue_noise(20_000, seed=62),
                                 pt.KnnConfig(k=10), device=cuda_device)
    daemon = ServeDaemon(prob, ServeConfig(max_batch=128, max_delay_s=0.004,
                                           compact_threshold=64))
    summary = run_session(daemon, LoadSpec(rate=400.0, requests=120,
                                           mutation_ratio=0.3, seed=63))
    assert summary["recompiles"] == 0 and summary["kernel_launches"] > 0
    assert summary["kernel_route"] == "cuda"
    assert summary["failed_requests"] == 0 and summary["refused"] == 0
    assert summary["batches"] >= 1 and summary["overlay_compactions"] >= 1


@pytest.mark.cuda
def test_gpu_serve_fof_equals_cpu(cuda_device):
    """A fof request on the card's daemon equals the CPU labels of the same
    mutated cloud, and a repeat is a memo hit."""
    from cuda_knearests_tpu_torch.cluster import fof_labels
    from cuda_knearests_tpu_torch.serve import ServeConfig, ServeDaemon

    pts = generate_uniform(20_000, seed=64)
    daemon = ServeDaemon(pt.KnnProblem.prepare(pts, pt.KnnConfig(k=10),
                                               device=cuda_device),
                         ServeConfig(max_batch=32, warmup=False))
    daemon.submit(1, "insert", generate_uniform(8, seed=65))
    daemon.submit(2, "delete", np.array([3, 77, 19_000]))
    got = daemon.submit(3, "fof", 30.0)[0]
    again = daemon.submit(4, "fof", 30.0)[0]
    want = fof_labels(daemon.overlay.mutated_points(), 30.0, device="cpu")
    assert got.ok and again.labels is got.labels
    assert daemon.fof_memo_hits == 1
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.n_clusters == want.n_clusters and got.n_points == 20_005


# -- the grid route's MXU class scorer (plain torch on the card) --------------

MXU_GRID_CLOUDS = {
    "blue-k50": (lambda: generate_blue_noise(30_000, seed=3), dict(k=50)),
    "clustered-r1": (lambda: generate_clustered(30_000, seed=5),
                     dict(k=10, ring_radius=1)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("rt", [1.0, 0.6])
@pytest.mark.parametrize("cloud", list(MXU_GRID_CLOUDS))
def test_mxu_grid_class_equals_cpu_bit_for_bit(cuda_device, cloud, rt,
                                               prec):
    """``grid_class_topk`` of the leading supercells of every 'mxu' class
    on the card equals the same call on the CPU: d2 bits (NaN flags of
    the rows the fold left open included) and ids."""
    from cuda_knearests_tpu_torch.mxu.scorer import grid_class_topk

    make, kw = MXU_GRID_CLOUDS[cloud]
    cfg = pt.KnnConfig(scorer="mxu", recall_target=rt, precision=prec, **kw)
    prob = pt.KnnProblem.prepare(make(), cfg, device=cuda_device)
    g = prob.grid
    classes = [cp for cp in prob.aplan.classes if cp.route == "mxu"]
    assert classes
    for cp in classes:
        rows = max(1, min(cp.n_sc, (1 << 24) // (cp.qcap * cp.ccap)))
        args = (g.points, g.cell_starts, g.cell_counts, cp.own[:rows],
                cp.cand[:rows])
        call = dict(qcap=cp.qcap, k=cfg.k, ccap=cp.ccap, exclude_self=True,
                    recall_target=rt, precision=prec,
                    rows_chunk=max(1, rows // 3))
        gd, gi = grid_class_topk(*args, **call)
        cd, ci = grid_class_topk(*[a.cpu() for a in args], **call)
        assert gd.is_cuda
        assert torch.equal(gd.cpu().view(torch.int32), cd.view(torch.int32))
        assert torch.equal(gi.cpu(), ci)


@pytest.mark.cuda
@pytest.mark.parametrize("cloud,kw", [
    ("blue-k50", dict(scorer="mxu")),
    ("blue-k50", dict(recall_target=0.9, precision="bf16")),
    ("clustered-r1", dict(recall_target=0.6, fallback="none"))])
def test_gpu_mxu_grid_solve_equals_cpu(cuda_device, cloud, kw):
    """The mxu-planned solve on the card equals the CPU solve (ids, d2,
    certificates), within two host round trips; with the exact fallback
    it equals the elementwise solve too; external queries against it
    equal the CPU's."""
    from cuda_knearests_tpu_torch.runtime import dispatch

    make, base = MXU_GRID_CLOUDS[cloud]
    pts = make()
    cfg = pt.KnnConfig(**base, **kw)
    gpu = pt.KnnProblem.prepare(pts, cfg, device=cuda_device)
    cpu = pt.KnnProblem.prepare(pts, cfg, device="cpu")
    assert "mxu" in {cp.route for cp in gpu.aplan.classes}
    dispatch.reset_stats()
    g = gpu.solve()
    assert dispatch.stats().host_syncs <= dispatch.SYNC_BUDGET
    c = cpu.solve()
    assert int(g.uncert_count) == int(c.uncert_count)
    np.testing.assert_array_equal(g.neighbors, c.neighbors)
    np.testing.assert_array_equal(g.dists_sq, c.dists_sq)
    np.testing.assert_array_equal(g.certified, c.certified)
    if cfg.fallback == "brute":
        e = pt.KnnProblem.prepare(pts, pt.KnnConfig(**base),
                                  device=cuda_device).solve()
        np.testing.assert_array_equal(g.neighbors, e.neighbors)
        np.testing.assert_array_equal(g.dists_sq, e.dists_sq)
    q = generate_uniform(5000, seed=66)
    for a, b in zip(gpu.query(q), cpu.query(q)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("cloud", list(MXU_GRID_CLOUDS))
def test_mxu_grid_step_memory_within_its_model(cuda_device, cloud):
    """One step of the widest 'mxu' class at its planned rows: the peak it
    allocates stays within ``adaptive.class_step_bytes``, the model the
    plan chunks by.  Prints the measured bytes per pair."""
    from cuda_knearests_tpu_torch.mxu.scorer import grid_class_topk
    from cuda_knearests_tpu_torch.ops import adaptive

    make, kw = MXU_GRID_CLOUDS[cloud]
    cfg = pt.KnnConfig(scorer="mxu", **kw)
    prob = pt.KnnProblem.prepare(make(), cfg, device=cuda_device)
    g = prob.grid
    cp = max((c for c in prob.aplan.classes if c.route == "mxu"),
             key=lambda c: c.qcap * c.ccap)
    rows = cp.step_rows
    out = (torch.empty((rows * cp.qcap, cfg.k), device=cuda_device),
           torch.empty((rows * cp.qcap, cfg.k), dtype=torch.int32,
                       device=cuda_device))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    grid_class_topk(g.points, g.cell_starts, g.cell_counts, cp.own[:rows],
                    cp.cand[:rows], cp.qcap, cfg.k, cp.ccap, True, 1.0,
                    "f32", rows, tgt=torch.arange(rows * cp.qcap,
                                                  device=cuda_device),
                    out=out)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    model = adaptive.class_step_bytes(rows, cp.qcap, cp.ccap)
    print(f"mxu step {cloud}: rows {rows}, qcap {cp.qcap}, ccap {cp.ccap}: "
          f"peak {peak} bytes, model {model} ({peak / model:.3f}), "
          f"{peak / (rows * cp.qcap * cp.ccap):.2f} bytes a pair")
    assert peak <= model


# (name, config): the legacy route and the gather epilogue; each runs the
# class kernel named by its counter.
LEGACY_GPU_CASES = {
    "legacy-scatter": (dict(adaptive=False), "launches"),
    "legacy-gather": (dict(adaptive=False, epilogue="gather"), "launches_b"),
    "legacy-blocked-gather": (dict(adaptive=False, kernel="blocked",
                                   epilogue="gather"), "blocked_launches_b"),
    "legacy-xla": (dict(adaptive=False, backend="xla"), None),
    "adaptive-gather": (dict(epilogue="gather"), "launches_b"),
    "adaptive-blocked-gather": (dict(kernel="blocked", epilogue="gather"),
                                "blocked_launches_b"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(LEGACY_GPU_CASES))
def test_gpu_legacy_and_gather_equal_cpu(cuda_device, case):
    """The legacy route and the gather epilogue on the card: the kernel
    launched in the mode its counter names (none on the 'xla' scan), the
    raw solve (before the fallback) and the final rows and queries equal
    the CPU's bit for bit, and ids equal the adaptive scatter solve's."""
    from cuda_knearests_tpu_torch.ops import adaptive, solve as psolve

    kw, counter = LEGACY_GPU_CASES[case]
    # radius 1 leaves rows for the fallback (565 of 20,000)
    pts = generate_blue_noise(20_000, seed=3)
    cfg = pt.KnnConfig(k=10, ring_radius=1, **kw)
    gpu = pt.KnnProblem.prepare(pts, cfg, device=cuda_device)
    cpu = pt.KnnProblem.prepare(pts, cfg, device="cpu")
    base = pt.KnnProblem.prepare(pts, pt.KnnConfig(k=10, ring_radius=1),
                                 device="cpu")

    def raw(p):
        if p.aplan is not None:
            return adaptive.solve_adaptive(p.grid, p.config, p.aplan)
        return psolve.solve(p.grid, p.config, p.plan, p.pack, p.backend)

    total = cs.launches + cs.blocked_launches
    before = getattr(cs, counter) if counter else 0
    g, c = raw(gpu), raw(cpu)
    if counter:
        assert getattr(cs, counter) > before
    else:
        assert cs.launches + cs.blocked_launches == total
    for name in ("neighbors", "dists_sq", "certified", "uncert_count"):
        a, b = getattr(g, name).cpu(), getattr(c, name)
        assert _equal_nan(a, b) if a.is_floating_point() else torch.equal(
            a, b), name
    assert int(c.uncert_count) > 0
    g, c = gpu.solve(), cpu.solve()
    np.testing.assert_array_equal(g.neighbors, c.neighbors)
    np.testing.assert_array_equal(g.dists_sq, c.dists_sq)
    base.solve()
    np.testing.assert_array_equal(gpu.get_knearests_original(),
                                  base.get_knearests_original())
    q = generate_uniform(5000, seed=4)
    for a, b in zip(gpu.query(q), cpu.query(q)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", ["scatter", "gather"])
def test_gpu_legacy_query_chunks_equal_single_shot(cuda_device, epilogue):
    """Legacy queries on the card at query_chunk in {1000, 2,048}: byte
    for byte the single shot's and the CPU's, one launch a chunk, at most
    two host round trips."""
    from cuda_knearests_tpu_torch.runtime import dispatch

    pts = generate_blue_noise(20_000, seed=41)
    q = generate_uniform(5000, seed=42)
    want = pt.KnnProblem.prepare(pts, pt.KnnConfig(
        k=10, adaptive=False, epilogue=epilogue), device="cpu").query(q)
    for chunk in (None, 1000, 2048):
        gpu = pt.KnnProblem.prepare(pts, pt.KnnConfig(
            k=10, adaptive=False, epilogue=epilogue, query_chunk=chunk),
            device=cuda_device)
        before = cs.launches
        dispatch.reset_stats()
        got = gpu.query(q)
        assert dispatch.stats().host_syncs <= dispatch.SYNC_BUDGET
        assert cs.launches - before == -(-5000 // (chunk or 5000))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_gpu_legacy_budget_refused_before_the_pack(cuda_device):
    """A configured budget one byte under the legacy pack's modeled bytes
    is refused in prepare before the pack is allocated; at the modeled
    bytes the pack fits and the problem solves."""
    from cuda_knearests_tpu_torch.ops import gridhash, solve as psolve
    from cuda_knearests_tpu_torch.utils.memory import LaunchBudgetError

    pts = generate_blue_noise(50_000, seed=7)
    kw = dict(k=10, adaptive=False, backend="pallas", epilogue="gather")
    grid = gridhash.build_grid(torch.as_tensor(pts, device=cuda_device))
    plan = psolve.build_plan(grid, pt.KnnConfig(**kw))
    need = cs.legacy_pack_bytes(grid.n_points, plan.n_chunks * plan.batch,
                                plan.qcap, plan.ccap, 10, "gather")
    del grid, plan
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with pytest.raises(LaunchBudgetError) as e:
        pt.KnnProblem.prepare(pts, pt.KnnConfig(hbm_budget_bytes=need - 1,
                                                **kw), device=cuda_device)
    assert e.value.requested == need and e.value.site == "prepare_pack"
    assert torch.cuda.max_memory_allocated() - base < need // 4
    prob = pt.KnnProblem.prepare(pts, pt.KnnConfig(hbm_budget_bytes=need,
                                                   **kw), device=cuda_device)
    assert prob.pack is not None
    assert bool(np.asarray(prob.solve().certified).all())


# -- the multi-GPU z-slab solve (parallel/sharded.py) --------------------------

def _slab_rows(sp):
    outs = sp.solve_device()
    return {d: [t.cpu() for t in o] for d, o in outs.items() if o is not None}


def _kernel_classes(sp):
    return sum(cp.route == "kernel" for p in sp.chip_plans
               for cp in p.classes)


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", ["scatter", "gather"])
def test_sharded_card_equals_cpu(cuda_device, epilogue):
    """Four slabs on one card against the same four slabs on the CPU: every
    slab's ids, d2 and certificates, the assembled rows and external
    queries bit for bit; one class-kernel launch per kernel class of every
    slab, one host round trip a solve."""
    from cuda_knearests_tpu_torch.parallel import ShardedKnnProblem
    from cuda_knearests_tpu_torch.runtime import dispatch

    pts = generate_uniform(60_000, seed=10)
    cfg = pt.KnnConfig(k=10, epilogue=epilogue)
    gpu = ShardedKnnProblem.prepare(pts, config=cfg,
                                    devices=[cuda_device] * 4)
    cpu = ShardedKnnProblem.prepare(pts, config=cfg,
                                    devices=[torch.device("cpu")] * 4)
    before = cs.launches + cs.blocked_launches
    g = _slab_rows(gpu)
    assert cs.launches + cs.blocked_launches - before == _kernel_classes(gpu)
    c = _slab_rows(cpu)
    assert g.keys() == c.keys()
    for d in c:
        for a, b in zip(g[d], c[d]):
            assert torch.equal(a, b), f"slab {d}"
    dispatch.reset_stats()
    got = gpu.solve()
    assert dispatch.stats().host_syncs == 1
    for a, b in zip(got, cpu.solve()):
        np.testing.assert_array_equal(a, b)
    q = generate_uniform(20_000, seed=901)
    for a, b in zip(gpu.query(q), cpu.query(q)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_sharded_blocked_and_clustered_card_equals_cpu(cuda_device):
    """Several classes a slab (a clustered cloud) and the blocked kernel:
    card = CPU bit for bit, and rows equal to the single-device solve on
    the card wherever both certify."""
    from cuda_knearests_tpu_torch.ops.adaptive import solve_adaptive
    from cuda_knearests_tpu_torch.parallel import ShardedKnnProblem

    pts = generate_clustered(20_000, seed=3)
    for cfg in (pt.KnnConfig(k=10, ring_radius=1),
                pt.KnnConfig(k=10, ring_radius=1, kernel="blocked")):
        gpu = ShardedKnnProblem.prepare(pts, config=cfg,
                                        devices=[cuda_device] * 4)
        cpu = ShardedKnnProblem.prepare(pts, config=cfg,
                                        devices=[torch.device("cpu")] * 4)
        g, c = _slab_rows(gpu), _slab_rows(cpu)
        for d in c:
            for a, b in zip(g[d], c[d]):
                assert torch.equal(a, b), f"slab {d}"
        ids, d2, _ = gpu.solve()
        single = pt.KnnProblem.prepare(pts, cfg, device=cuda_device)
        single.solve()
        perm = single.get_permutation()
        s_d2 = np.empty_like(single.get_dists_sq())
        s_d2[perm] = single.get_dists_sq()
        both = np.zeros((pts.shape[0],), bool)
        both[perm] = solve_adaptive(single.grid, cfg,
                                    single.aplan).certified.cpu().numpy()
        both[gpu.fallback_rows] = False
        np.testing.assert_array_equal(
            ids[both], single.get_knearests_original()[both])
        np.testing.assert_array_equal(d2[both], s_d2[both])


@pytest.mark.cuda
def test_sharded_default_mesh_and_distinct_cards(cuda_device):
    """With no mesh, one slab per card; more slabs than cards need
    devices=; with two or more cards, slabs on distinct cards equal the
    same slabs on the CPU (the halo blocks cross between cards)."""
    from cuda_knearests_tpu_torch.parallel import ShardedKnnProblem
    from cuda_knearests_tpu_torch.utils.memory import InvalidConfigError

    count = torch.cuda.device_count()
    pts = generate_uniform(40_000, seed=12)
    sp = ShardedKnnProblem.prepare(pts, config=pt.KnnConfig(k=10))
    assert [sl.device for sl in sp.mesh] == [torch.device("cuda", i)
                                            for i in range(count)]
    with pytest.raises(InvalidConfigError, match="devices="):
        ShardedKnnProblem.prepare(pts, n_devices=count + 1)
    if count < 2:
        pytest.skip("slabs on distinct cards need two GPUs; this host has "
                    "one")
    cpu = ShardedKnnProblem.prepare(pts, config=pt.KnnConfig(k=10),
                                    devices=[torch.device("cpu")] * count)
    g, c = _slab_rows(sp), _slab_rows(cpu)
    for d in c:
        assert g[d][0].device.type == "cpu"
        for a, b in zip(g[d], c[d]):
            assert torch.equal(a, b), f"slab {d}"


@pytest.mark.cuda
def test_fetch_waits_on_every_card(cuda_device):
    """dispatch.fetch of a tensor computed on cuda:1 while cuda:0 is
    current: the copy is queued on cuda:1's stream, which fetch must wait
    on; one round trip."""
    from cuda_knearests_tpu_torch.runtime import dispatch

    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second GPU (a tensor on cuda:1); this host has "
                    "one")
    dev1 = torch.device("cuda", 1)
    want = np.arange(1 << 24, dtype=np.float32) * 3
    with torch.cuda.device(0):
        busy = torch.randn(4096, 4096, device=dev1)
        for _ in range(20):  # keep cuda:1 busy past the copy's enqueue
            busy = busy @ busy
        a = torch.arange(1 << 24, device=dev1, dtype=torch.float32) * 3
        dispatch.reset_stats()
        got, one = dispatch.fetch(a, torch.ones(4, device="cuda:0"))
    assert dispatch.stats().host_syncs == 1
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(one, np.ones(4, np.float32))


def _pod_chip_rows(pp):
    return {d: [t.cpu() for t in o] for d, o in pp.solve_device().items()
            if o is not None}


@pytest.mark.cuda
def test_pod_card_equals_cpu(cuda_device):
    """The pod on four chips of one card against the same four chips on
    the CPU, at 200k points: every received block and window, every chip's
    ids, d2 and certificates, the assembled rows and external queries bit
    for bit; the first solve moves ``halo_bytes`` between chips and the
    second none, one host round trip each; one class-kernel launch per
    kernel class of every chip."""
    from cuda_knearests_tpu_torch.pod import PodKnnProblem
    from cuda_knearests_tpu_torch.runtime import dispatch

    pts = generate_uniform(200_000, seed=10)
    cfg = pt.KnnConfig(k=10)
    gpu = PodKnnProblem.prepare(pts, config=cfg, mesh=[cuda_device] * 4)
    cpu = PodKnnProblem.prepare(pts, config=cfg,
                                mesh=[torch.device("cpu")] * 4)
    assert gpu.meta == cpu.meta and gpu.meta.steps > 0
    # a pool without n_devices: the default budget takes the fewest chips
    auto = PodKnnProblem.prepare(pts, config=cfg, devices=[cuda_device] * 4)
    assert auto.meta.ndev == 1 and not auto.hbm["streamed_prepare"]
    dispatch.reset_stats()
    before = cs.launches + cs.blocked_launches
    got = gpu.solve()
    first = dispatch.stats()
    assert first.host_syncs == 1
    assert first.ici_bytes == gpu.meta.halo_bytes() > 0
    assert cs.launches + cs.blocked_launches - before == _kernel_classes(gpu)
    for a, b in zip(got, cpu.solve()):
        np.testing.assert_array_equal(a, b)
    dispatch.reset_stats()
    gpu.solve()
    again = dispatch.stats()
    assert again.host_syncs == 1 and again.ici_bytes == 0
    for d in range(4):
        for a, b in zip(gpu._halo[d], cpu._halo[d]):
            assert torch.equal(a.cpu(), b), f"chip {d} halo"
        gw, cw = gpu._chip_ready(d).window, cpu._chip_ready(d).window
        for name in ("points", "permutation", "cell_starts", "cell_counts"):
            assert torch.equal(getattr(gw, name).cpu(), getattr(cw, name)), \
                f"chip {d} window {name}"
    g, c = _pod_chip_rows(gpu), _pod_chip_rows(cpu)
    assert g.keys() == c.keys()
    for d in c:
        for a, b in zip(g[d], c[d]):
            assert torch.equal(a, b), f"chip {d}"
    q = generate_uniform(20_000, seed=901)
    dispatch.reset_stats()
    gq = gpu.query(q)
    assert dispatch.stats().host_syncs <= 2
    for a, b in zip(gq, cpu.query(q)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_pod_chip_memory_within_model(cuda_device):
    """Each chip's peak allocation above what the card held before it (its
    staged share counted in) stays within ``stream.chip_hbm_model``."""
    from cuda_knearests_tpu_torch.parallel.sharded import _chip_solve
    from cuda_knearests_tpu_torch.pod import PodKnnProblem
    from cuda_knearests_tpu_torch.pod.stream import chip_hbm_model

    pts = generate_uniform(400_000, seed=10)
    for cfg in (pt.KnnConfig(k=10), pt.KnnConfig(k=10, epilogue="gather")):
        pp = PodKnnProblem.prepare(pts, config=cfg, mesh=[cuda_device] * 4)
        pp._exchange()
        for d, plan in enumerate(pp.chip_plans):
            own = sum(t.untyped_storage().nbytes()
                      for t in list(pp.dev[d].values()) + list(pp._halo[d]))
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated() - own
            torch.cuda.reset_peak_memory_stats()
            out = _chip_solve(pp._chip_ready(d), cfg)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            model = chip_hbm_model(pp.meta, plan, cfg)
            assert peak <= model, (d, peak, model)
            del out
            pp.drop_ready(d)


@pytest.mark.cuda
def test_pod_on_distinct_cards(cuda_device):
    """With two or more cards, a pod with a chip on each card (the export
    blocks cross between cards) equals the same chips on the CPU.  (With
    neither n_devices nor a mesh, the default budget picks the fewest
    cards that hold the cloud.)"""
    from cuda_knearests_tpu_torch.pod import PodKnnProblem

    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip("chips on distinct cards need two GPUs; this host has "
                    "one")
    pts = generate_uniform(100_000, seed=12)
    cfg = pt.KnnConfig(k=10)
    gpu = PodKnnProblem.prepare(pts, n_devices=count, config=cfg)
    assert gpu.mesh == [torch.device("cuda", i) for i in range(count)]
    cpu = PodKnnProblem.prepare(pts, config=cfg,
                                devices=[torch.device("cpu")] * count)
    g, c = _pod_chip_rows(gpu), _pod_chip_rows(cpu)
    for d in c:
        for a, b in zip(g[d], c[d]):
            assert torch.equal(a, b), f"chip {d}"
    for a, b in zip(gpu.solve(), cpu.solve()):
        np.testing.assert_array_equal(a, b)


def _reshard_overlay_run(devices):
    """A seeded delete / insert / delete-an-insert sequence on a 4,000-point
    pod over ``devices``, then a solve and a query: every result host-side."""
    from cuda_knearests_tpu_torch.pod import PodKnnProblem, PodOverlay

    pts = generate_uniform(4_000, seed=11)
    pp = PodKnnProblem.prepare(pts, config=pt.KnnConfig(k=8), mesh=devices)
    pp.solve()
    ov = PodOverlay(pp)
    rng = np.random.default_rng(170)
    out = []
    ov.delete(rng.choice(4_000, 60, replace=False))
    out.append(ov.solve())
    ov.insert((rng.random((40, 3)) * 110.0 + 5.0).astype(np.float32))
    ov.delete(np.asarray([4_003, 4_011, 17]))
    out.append(ov.solve())
    q = (rng.random((500, 3)) * 1000.0).astype(np.float32)
    out.append(ov.query(q))
    return out, ov.stats_dict()


@pytest.mark.cuda
def test_reshard_overlay_card_equals_cpu(cuda_device):
    """The mutating pod on four chips of the card equals the same run on
    four CPU chips bit for bit: ids, d2, certificates and counters."""
    gpu, g_stats = _reshard_overlay_run(["cuda:0"] * 4)
    cpu, c_stats = _reshard_overlay_run(["cpu"] * 4)
    assert g_stats == c_stats and g_stats["reexchanges"] > 0
    for g, c in zip(gpu, cpu):
        for a, b in zip(g, c):
            np.testing.assert_array_equal(a, b)


def _reshard_elastic_run(device):
    """The live reshard of ``tests/test_pod.py`` on ``device``: the answers
    at every pump, each equal to the rebuild oracle byte for byte."""
    from cuda_knearests_tpu_torch.pod import ElasticIndex

    el = ElasticIndex(generate_uniform(420, seed=21), k=6, nshards=2,
                      compact_threshold=64, migration_chunk=8, device=device)
    el.insert((np.random.default_rng(4).random((48, 3)) * 110.0
               + 5.0).astype(np.float32))
    q = (np.random.default_rng(6).random((20, 3)) * 980.0
         + 10.0).astype(np.float32)
    assert el.force_rebalance()
    rows = []
    while True:
        got = el.query(q, 6)
        want = el.rebuild_oracle_query(q, 6)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        rows.append(got)
        if el.migration is None:
            return rows, el.stats_dict()
        el.pump()


@pytest.mark.cuda
def test_reshard_elastic_card_equals_cpu(cuda_device):
    """The elastic migration on the card answers as on the CPU at every
    pump, bit for bit, with the same shard state."""
    gpu, g_stats = _reshard_elastic_run("cuda")
    cpu, c_stats = _reshard_elastic_run("cpu")
    assert len(gpu) == len(cpu) > 2
    for g, c in zip(gpu, cpu):
        for a, b in zip(g, c):
            np.testing.assert_array_equal(a, b)
    assert g_stats["elastic_migrations_done"] == 1
    g_stats.pop("elastic_recompiles")
    c_stats.pop("elastic_recompiles")
    assert g_stats == c_stats


@pytest.mark.cuda
def test_default_budget_counts_the_allocator_cache(cuda_device):
    """The default budget counts memory torch's caching allocator holds
    unused as free: freeing a large tensor leaves the budget where it was
    with the tensor never allocated (to within the card's own churn)."""
    torch.cuda.empty_cache()
    before = cs.hbm_budget_bytes(cuda_device)
    big = torch.empty((1 << 30,), dtype=torch.uint8, device=cuda_device)
    held = cs.hbm_budget_bytes(cuda_device)
    del big
    cached = cs.hbm_budget_bytes(cuda_device)
    free, _ = torch.cuda.mem_get_info(cuda_device)
    assert held < before - (1 << 29)
    assert abs(cached - before) < (64 << 20)
    assert cached > int(free * 0.8) + (1 << 29)


@pytest.mark.cuda
def test_default_budget_leaves_out_a_pinned_segment(cuda_device):
    """A small live tensor carved from a cached 1 GiB segment pins it: the
    segment's free part is neither releasable nor one block a large pack
    could take, so the budget does not count it."""
    torch.cuda.empty_cache()
    before = cs.hbm_budget_bytes(cuda_device)
    big = torch.empty((1 << 30,), dtype=torch.uint8, device=cuda_device)
    del big
    small = torch.empty((4 << 20,), dtype=torch.uint8, device=cuda_device)
    split = torch.cuda.memory_stats(cuda_device)[
        "inactive_split_bytes.all.current"]
    assert split > (1 << 29)
    pinned = cs.hbm_budget_bytes(cuda_device)
    free, _ = torch.cuda.mem_get_info(cuda_device)
    assert pinned < before - (1 << 29)
    assert abs(pinned - int(free * 0.8)) < (64 << 20)
    del small
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_fuzz_zoo_card_rows_equal_cpu(cuda_device):
    """One case per zoo generator through the four fuzz routes, the
    blocked kernel and the gather epilogue (``campaign.check_card_rows``):
    exact against the kd-tree, and the card's rows equal the CPU's bit for
    bit."""
    from cuda_knearests_tpu_torch.fuzz.campaign import check_card_rows
    from cuda_knearests_tpu_torch.fuzz.generators import draw_cases

    cs.launches = cs.blocked_launches = 0
    for spec in draw_cases(12, 0):
        runs, problems = check_card_rows(spec, cuda_device)
        assert runs == 7 and problems == []
    assert cs.launches > 0 and cs.blocked_launches > 0


@pytest.mark.cuda
def test_fuzz_supervisor_case_on_card(cuda_device, tmp_path):
    """A fuzz case in a supervisor worker on the card: the worker builds
    nothing (the parent did), answers, and banks nothing."""
    from cuda_knearests_tpu_torch.fuzz.campaign import _run_one, \
        prepare_device
    from cuda_knearests_tpu_torch.fuzz.generators import CaseSpec
    from cuda_knearests_tpu_torch.fuzz.routes import ROUTE_NAMES
    from cuda_knearests_tpu_torch.runtime.supervisor import Supervisor

    assert prepare_device(cuda_device).type == "cuda"
    spec = CaseSpec(generator="quantized-dups", seed=3, n=257, k=10)
    sup = Supervisor(timeout_s=300)
    assert _run_one(spec, ROUTE_NAMES, str(tmp_path), True, 2, sup,
                    cuda_device) == []
    assert sup.quarantined == {} and not list(tmp_path.iterdir())


@pytest.mark.cuda
def test_fuzz_mxu_drop_block_detected_on_card(cuda_device, tmp_path,
                                              monkeypatch):
    """KNTPU_MXU_FAULT=drop-block on the card: the planted case fails as
    'certified-unsound', banked under tmp_path, with no selection kernel
    launched; without the fault the same case launches the kernel and its
    banked repro replays clean."""
    from cuda_knearests_tpu_torch.fuzz import approx
    from cuda_knearests_tpu_torch.fuzz.campaign import replay_banked

    spec = approx.ApproxCaseSpec("block-aliased", 3, 2048, 10, 0.6)
    monkeypatch.setenv("KNTPU_MXU_FAULT", "drop-block")
    before = mk.launches
    f = approx.run_approx_case(spec, bank_dir=str(tmp_path), max_probes=8,
                               device=cuda_device)
    assert f is not None and f.kind == "certified-unsound"
    assert f.banked.startswith(str(tmp_path)) and mk.launches == before
    monkeypatch.delenv("KNTPU_MXU_FAULT")
    assert approx.run_approx_case(spec, device=cuda_device) is None
    assert mk.launches > before
    assert replay_banked(f.banked, device=cuda_device) is None


# -- the serving fleet ----------------------------------------------------------

@pytest.mark.cuda
def test_gpu_fleet_session_equals_cpu(cuda_device):
    """A mixed-SLO fleet (three dense tenants with a replica each, the
    sidecar tenant, 20% mutations, a bf16 brownout episode) answers on
    the card as on the CPU (``loadgen.card_equals_cpu``): every
    response's ok, tenant and tier equal, ids and d2 bit for bit; the
    class kernel and the bf16 selection launched."""
    from cuda_knearests_tpu_torch.serve.fleet import (TenantLoad,
                                                      default_fleet_builds)
    from cuda_knearests_tpu_torch.serve.fleet.loadgen import card_equals_cpu

    builds = default_fleet_builds(n_tenants=4, base_n=6000, k=8, seed=3,
                                  replicas=1)
    loads = [TenantLoad(tenant=spec.name, rate=300.0, requests=20,
                        mutation_ratio=0.2 if i < 3 else 0.0, seed=90 + i)
             for i, (spec, _) in enumerate(builds)]
    l0, bf0 = cs.launches, mk.launches_bf16
    got = card_equals_cpu(builds, loads, cuda_device)
    assert cs.launches > l0 and mk.launches_bf16 > bf0
    assert got["difference"] is None, got
    assert got["degraded"] > 0


@pytest.mark.cuda
def test_gpu_fleet_process_failover(cuda_device):
    """The process-level failover drill with both child replicas
    preparing on the card."""
    from cuda_knearests_tpu_torch.serve.fleet import failover_drill

    drill = failover_drill(n=20_000, k=8, ops=16, seed=3,
                           device=cuda_device)
    assert drill["device"].startswith("cuda")
    assert drill["failover_ok"], drill


# -- mesh failover and the chaos campaign -----------------------------------------

@pytest.mark.cuda
def test_gpu_mesh_failover_drill(cuda_device):
    """The cross-mesh drill with the primary and the standby mesh both
    building their pod tenant on the card: killed mid-migration, zero
    committed mutations lost, answers byte-identical to the parent's
    per-shard rebuild on the card and exact against the host kd-tree,
    and the promoted standby reports its shards on the card and its own
    class-kernel launches."""
    from cuda_knearests_tpu_torch.serve.fleet.elastic import \
        mesh_failover_drill

    drill = mesh_failover_drill(n=200_000, k=8, ops=26, seed=0,
                                device=cuda_device)
    assert drill["device"].startswith("cuda")
    assert drill["killed_mid_migration"] is True
    assert drill["zero_lost_committed"] is True
    assert drill["post_failover_byte_identical"] is True
    assert drill["post_failover_exact"] is True
    assert drill["mesh_failover_ok"] is True, drill
    for report in (drill["primary_at_kill"], drill["mesh_child"]):
        assert report["device"].startswith("cuda"), drill
        assert report["cuda_allocated_bytes"] > 0, drill
    assert drill["mesh_child"]["launches"]["supercell_topk"] > 0, drill
    assert drill["card_free_bytes_both_meshes"] > 0


@pytest.mark.cuda
def test_gpu_chaos_case_equals_cpu(cuda_device):
    """One chaos schedule (migrations, chip loss, a wedge, the guaranteed
    rebalance tail) replays clean on the card and on the CPU, every
    checked query's ids and d2 equal bit for bit, the class kernel
    launched."""
    from cuda_knearests_tpu_torch.fuzz import chaos
    from cuda_knearests_tpu_torch.fuzz.fleet import answers_equal

    spec = chaos.draw_specs(1, 1)[0]
    before = cs.launches
    got = answers_equal(chaos.replay_ops, spec, chaos.generate_ops(spec),
                        cuda_device)
    assert cs.launches > before
    assert got["verdicts"] == [None, None], got
    assert got["difference"] is None and got["queries"] > 0, got


@pytest.mark.cuda
def test_gpu_cli_equals_cpu_cli_20k(cuda_device, tmp_path, capsys):
    """``python -m cuda_knearests_tpu_torch.cli`` at 20k on the card: rc 0,
    no hard mismatch against the kd-tree, the card as its platform, and
    its rows equal the same command's rows on the CPU bit for bit."""
    from cuda_knearests_tpu_torch import cli
    from cuda_knearests_tpu_torch.io import get_dataset, save_xyz

    path = str(tmp_path / "pts20K.xyz")
    save_xyz(path, get_dataset("pts20K.xyz"))
    rows, lines = {}, {}
    for dev in ("cuda", "cpu"):
        out = str(tmp_path / f"{dev}.npz")
        argv = [path, "--k", "10", "--json", "--save", out]
        before = cs.launches
        assert cli.main(argv + (["--device", "cpu"] if dev == "cpu"
                                else [])) == 0
        if dev == "cuda":
            assert cs.launches > before
        lines[dev] = json.loads(capsys.readouterr().out.strip()
                                .splitlines()[-1])
        rows[dev] = np.load(out)
    assert lines["cuda"]["platform"] == torch.cuda.get_device_name(0)
    assert lines["cuda"]["hard"] == 0 == lines["cpu"]["hard"]
    for key in ("neighbors", "dists_sq"):
        assert rows["cuda"][key].tobytes() == rows["cpu"][key].tobytes()


@pytest.mark.cuda
def test_gpu_capture_joins_every_class_kernel_by_correlation(cuda_device):
    """A captured 200k solve: every ``supercell_topk`` event attributed at
    its launch (joined by correlation id) inside the adaptive-solve scope,
    one a class, none unattributed; the memory verdict read from the
    allocator."""
    from cuda_knearests_tpu_torch.obs import device as dv

    prob = pt.KnnProblem.prepare(generate_blue_noise(200_000, seed=21),
                                 pt.KnnConfig(k=10), device=cuda_device)
    prob.solve()
    rep = dv.profile_window(prob.solve, device=cuda_device,
                            hbm_model_bytes=dv.problem_hbm_model(prob))
    assert not rep.unattributed
    topk = [a for a in rep.attributed if a.event.module == "supercell_topk"]
    assert len(topk) == len(prob.aplan.classes)
    assert all(a.joined == "correlation" for a in topk)
    assert all(a.scope == "kntpu:adaptive-solve" for a in topk)
    assert rep.decomposition["modules"]["supercell_topk"]["label"] == \
        "csrc/supercell_topk.cu"
    assert rep.hbm["hbm_measured_source"] == "cuda_allocator"
    assert rep.hbm["hbm_model_ok"] is True, rep.hbm


@pytest.mark.cuda
def test_gpu_hbm_model_dominates_300k_k50(cuda_device):
    """``obs.device.problem_hbm_model`` dominates the allocator's measured
    growth over a warm 300k/k=50 solve (the preflight's headroom)."""
    from cuda_knearests_tpu_torch.obs import device as dv

    prob = pt.KnnProblem.prepare(generate_blue_noise(300_000, seed=301),
                                 pt.KnnConfig(k=50), device=cuda_device)
    prob.solve()
    model = dv.problem_hbm_model(prob)
    rep = dv.profile_window(prob.solve, device=cuda_device,
                            hbm_model_bytes=model)
    hbm = rep.hbm
    assert hbm["hbm_measured_source"] == "cuda_allocator"
    assert 0 < hbm["hbm_window_delta_bytes"] <= model * dv.HBM_MODEL_HEADROOM
    assert hbm["hbm_model_ok"] is True


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_gpu_solve_general_query_chunk_changes_no_byte(cuda_device,
                                                       precision):
    """``solve_general(query_chunk=...)`` launches the selection a chunk
    at a time on the card and answers byte for byte as one launch does,
    certificates included, at a recall target below 1 and unrefined."""
    x = np.random.default_rng(5).random((20_000, 3)).astype(np.float32)
    kw = dict(k=10, recall_target=0.8, refine="none", precision=precision,
              device=cuda_device)
    one = mxu.solve_general(x, **kw)
    before = mk.launches + mk.launches_bf16
    got = mxu.solve_general(x, query_chunk=3000, **kw)
    assert mk.launches + mk.launches_bf16 - before == 7
    assert got.neighbors.tobytes() == one.neighbors.tobytes()
    assert got.dists_sq.tobytes() == one.dists_sq.tobytes()
    assert np.array_equal(got.certified, one.certified)
