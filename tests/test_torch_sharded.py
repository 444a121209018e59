"""PyTorch port of the sharded path against the JAX package, on the CPU.

JAX runs its z-slabs on the 8 emulated CPU devices of ``tests/conftest.py``;
the port runs the same slab counts as ``devices=[torch.device('cpu')] * S``
(slabs sharing one device).  The host partition, every slab's sorted ids,
cell counts and exchanged halo blocks, and every slab's class plan must be
equal (the routes against a JAX ``prepare`` under ``interpret=True``, which
routes as its kernel platforms do and runs no kernel: its 'pallas' is the
port's 'kernel').  Rows are held tie-aware (``fuzz/compare``, RTOL 1e-4 /
ATOL 1e-2): XLA's CPU backend contracts multiply-adds, torch does not.
Against the port's own single-device solve the rows must be equal bit for
bit wherever both certify.
"""

import dataclasses

import numpy as np
import pytest
import torch

import cuda_knearests_tpu as ck
from cuda_knearests_tpu.fuzz.compare import check_route_result
from cuda_knearests_tpu.io import generate_blue_noise, generate_uniform
from cuda_knearests_tpu.parallel import sharded as jsh
import cuda_knearests_tpu_torch as pt
from cuda_knearests_tpu_torch.ops.adaptive import solve_adaptive
from cuda_knearests_tpu_torch.parallel import (ShardedKnnProblem,
                                               load_sharded, save_sharded)
from cuda_knearests_tpu_torch.parallel import sharded as psh
from cuda_knearests_tpu_torch.runtime import dispatch
from cuda_knearests_tpu_torch.utils.memory import (InvalidConfigError,
                                                   NoDeviceError)

CPU = torch.device("cpu")
ROUTE = {"pallas": "kernel", "streamed": "streamed", "mxu": "mxu"}


def _clustered():
    rng = np.random.default_rng(5)
    cluster = 450.0 + 40.0 * rng.standard_normal((3600, 3))
    spread = rng.random((400, 3)) * 1000.0
    return np.clip(np.concatenate([cluster, spread]), 0.0,
                   1000.0).astype(np.float32)


def _blob():
    rng = np.random.default_rng(11)
    bg = rng.random((8000, 3)).astype(np.float32) * 1000.0
    blob = (np.float32([500, 500, 60])
            + 8.0 * rng.standard_normal((4000, 3)).astype(np.float32))
    return np.clip(np.concatenate([bg, blob]), 0.0, 1000.0).astype(np.float32)


# (cloud, k): the clouds of tests/test_sharded.py
CLOUDS = {
    "blue": (lambda: generate_blue_noise(8000, seed=17), 10),
    "uniform": (lambda: generate_uniform(10000, seed=42), 10),
    "clustered": (_clustered, 5),
    "blob": (_blob, 10),
}


def _port(points, S, **kw):
    return ShardedKnnProblem.prepare(points, config=pt.KnnConfig(**kw),
                                     devices=[CPU] * S)


@pytest.fixture(scope="module")
def cases():
    """Per cloud: points, k, the JAX problem prepared under interpret=True
    (4 slabs), and the port's (4 slabs)."""
    out = {}
    for name, (make, k) in CLOUDS.items():
        pts = make()
        jp = jsh.ShardedKnnProblem.prepare(
            pts, n_devices=4, config=ck.KnnConfig(k=k, interpret=True))
        out[name] = (pts, k, jp, _port(pts, 4, k=k))
    return out


@pytest.fixture(scope="module")
def jax_rows():
    """The JAX sharded solve's rows at its CPU defaults, per (cloud, S)."""
    memo = {}

    def get(name, S, **kw):
        key = (name, S, tuple(sorted(kw.items())))
        if key not in memo:
            pts, k = CLOUDS[name][0](), CLOUDS[name][1]
            kw = {"k": k, **kw}
            memo[key] = jsh.ShardedKnnProblem.prepare(
                pts, n_devices=S, config=ck.KnnConfig(**kw)).solve()
        return memo[key]
    return get


def dataclass_tuple(meta):
    return (meta.ndev, meta.dim, meta.zcap, meta.radius, meta.pcap,
            meta.hcap, meta.domain)


def _tie_aware(points, ids, d2, ref_d2, k, queries=None):
    q = points if queries is None else queries
    bad = check_route_result(points, q, ids, d2, ref_d2, k)
    assert bad is None, bad.render()


@pytest.mark.parametrize("dim,s,ndev", [(21, 4, 8), (16, 4, 4), (9, 4, 8),
                                        (32, 8, 2), (15, 3, 4), (148, 3, 4)])
def test_slab_bounds_equal_to_jax(dim, s, ndev):
    got, want = psh._slab_bounds(dim, s, ndev), jsh._slab_bounds(dim, s, ndev)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


@pytest.mark.parametrize("name", sorted(CLOUDS))
def test_meta_and_partition_equal_to_jax(cases, name):
    pts, k, jp, pp = cases[name]
    assert dataclass_tuple(pp.meta) == dataclass_tuple(jp.meta)
    m = pp.meta
    got = psh._partition_host(pts, m.dim, m.zcap, m.radius, m.ndev, m.domain)
    want = jsh._partition_host(pts, m.dim, m.zcap, m.radius, m.ndev,
                               m.domain)
    np.testing.assert_array_equal(got[1], want[1])     # bucket ids
    np.testing.assert_array_equal(got[2], want[2])     # n_local
    assert got[3:] == want[3:]                         # pcap, hcap
    real = got[1] >= 0                                 # pads differ: 0 / 1e30
    np.testing.assert_array_equal(got[0][real], want[0][real])


@pytest.mark.parametrize("name", sorted(CLOUDS))
def test_slab_build_and_halos_equal_to_jax(cases, name):
    _, _, jp, pp = cases[name]
    ndev = pp.meta.ndev
    for d in range(ndev):
        got = {key: t.numpy() for key, t in pp._chip_inputs(d).items()}
        want = {key: np.asarray(jp._chip_inputs(d)[key]) for key in got}
        # an edge slab's missing neighbour: JAX's ppermute delivers zeros
        # (ids 0), the port's empty block ids -1; both zero counts
        for side, edge in (("lo", d == 0), ("hi", d == ndev - 1)):
            if edge:
                assert (got[f"{side}_ids"] == -1).all()
                assert not got[f"{side}_counts"].any()
                want[f"{side}_ids"] = got[f"{side}_ids"]
        for key in ("sids", "counts", "lo_ids", "lo_counts", "hi_ids",
                    "hi_counts"):
            np.testing.assert_array_equal(got[key], want[key],
                                          err_msg=f"slab {d} {key}")
        for key, ids in (("spts", "sids"), ("lo_pts", "lo_ids"),
                         ("hi_pts", "hi_ids")):
            real = got[ids] >= 0
            np.testing.assert_array_equal(got[key][real], want[key][real],
                                          err_msg=f"slab {d} {key}")


@pytest.mark.parametrize("name", sorted(CLOUDS))
def test_chip_plans_equal_to_jax(cases, name):
    _, _, jp, pp = cases[name]
    assert len(pp.chip_plans) == len(jp.chip_plans)
    for d, (got, want) in enumerate(zip(pp.chip_plans, jp.chip_plans)):
        np.testing.assert_array_equal(got.class_of, want.class_of)
        np.testing.assert_array_equal(got.row_of, want.row_of)
        assert [(c.radius, c.qcap, c.ccap, c.route) for c in got.classes] \
            == [(c.radius, c.qcap, c.ccap, ROUTE[c.route])
                for c in want.classes], f"slab {d}"
        for gc, wc in zip(got.classes, want.classes):
            for key in ("own", "cand", "lo", "hi"):
                np.testing.assert_array_equal(
                    getattr(gc, key), np.asarray(getattr(wc, key)),
                    err_msg=f"slab {d} {key}")
    if name == "blob":
        # the blob on slab 0 sizes only slab 0's tiles
        ccap = [max((c.ccap for c in p.classes), default=0)
                for p in pp.chip_plans]
        assert ccap[0] > 2 * max(ccap[2], ccap[3]), ccap


@pytest.mark.parametrize("name,S", [("blue", 1), ("blue", 4),
                                    ("uniform", 4), ("clustered", 4),
                                    ("blob", 4)])
def test_solve_rows_tie_aware_equal_to_jax(cases, jax_rows, name, S):
    pts, k, _, pp = cases[name]
    sp = pp if S == 4 else _port(pts, S, k=k)
    ids, d2, cert = sp.solve()
    _, j_d2, j_cert = jax_rows(name, S)
    assert cert.all() and j_cert.all()
    _tie_aware(pts, ids, d2, j_d2, k)
    assert (sp.permutation().size == pts.shape[0]
            and np.array_equal(np.sort(sp.permutation()),
                               np.arange(pts.shape[0])))


@pytest.mark.parametrize("name", ["blue", "uniform"])
def test_sharded_equals_single_device_bit_for_bit(cases, name):
    pts, k, _, pp = cases[name]
    ids, d2, _ = pp.solve()
    cfg = pt.KnnConfig(k=k)
    single = pt.KnnProblem.prepare(pts, cfg, device="cpu")
    single.solve()
    perm = single.get_permutation()
    s_ids = single.get_knearests_original()
    s_d2 = np.empty_like(single.get_dists_sq())
    s_d2[perm] = single.get_dists_sq()
    s_cert = np.empty((pts.shape[0],), bool)
    s_cert[perm] = solve_adaptive(single.grid, cfg,
                                  single.aplan).certified.numpy()
    both = s_cert.copy()
    both[pp.fallback_rows] = False
    assert both.mean() > 0.9
    np.testing.assert_array_equal(ids[both], s_ids[both])
    np.testing.assert_array_equal(d2[both], s_d2[both])


@pytest.mark.parametrize("S", [1, 4])
def test_query_rows_tie_aware_equal_to_jax(cases, S):
    pts, k, _, pp = cases["blue"]
    sp = pp if S == 4 else _port(pts, S, k=k)
    queries = generate_uniform(300, seed=41)
    # queries on slab faces, in empty supercells and on stored points
    queries = np.concatenate([queries, pts[:40],
                              np.float32([[500.0, 500.0, 0.0],
                                          [0.0, 0.0, 999.9]])])
    jq = jsh.ShardedKnnProblem.prepare(pts, n_devices=S,
                                       config=ck.KnnConfig(k=k))
    j_ids, j_d2 = jq.query(queries, k=k)
    dispatch.reset_stats()
    ids, d2 = sp.query(queries, k=k)
    assert dispatch.stats().host_syncs == 1
    _tie_aware(pts, ids, d2, j_d2, k, queries)
    ids5, d25 = sp.query(queries, k=5)
    np.testing.assert_array_equal(d25, d2[:, :5])
    with pytest.raises(ValueError, match="exceeds the prepared k"):
        sp.query(queries, k=k + 1)
    ids_p, d2_p, planes = sp.query(queries[:20], planes=True)
    assert planes.shape == (20, k, 4)


def test_query_on_empty_slab_and_classless_supercells():
    rng = np.random.default_rng(21)
    pts = (rng.random((4000, 3)) * [1000.0, 1000.0, 180.0]).astype(np.float32)
    sp = _port(pts, 4, k=10)
    assert not sp.chip_plans[3].classes
    q = np.float32([[500.0, 500.0, 900.0], [10.0, 10.0, 50.0]])
    ids, d2 = sp.query(q, k=10)
    for j in range(2):
        dd = ((q[j] - pts) ** 2).sum(-1)
        assert set(ids[j].tolist()) == set(
            np.argsort(dd, kind="stable")[:10].tolist()), j


def test_degenerate_inputs_match_jax():
    rng = np.random.default_rng(3)
    tiny = (rng.random((5, 3)) * 1000).astype(np.float32)
    nbrs, _, cert = _port(tiny, 8, k=10).solve()
    assert nbrs.shape == (5, 10) and cert.all()
    assert (nbrs[:, :4] >= 0).all() and (nbrs[:, 4:] == -1).all()
    one = np.float32([[500.0, 500.0, 500.0]])
    nbrs, _, cert = _port(one, 4, k=3).solve()
    assert (nbrs == -1).all() and cert.all()
    same = np.full((30, 3), 777.0, np.float32)
    nbrs, d2, cert = _port(same, 4, k=4).solve()
    assert cert.all() and (d2 == 0.0).all()
    for r in range(30):
        assert r not in nbrs[r].tolist()
        assert len(set(nbrs[r].tolist())) == 4
    empty = np.zeros((0, 3), np.float32)
    nbrs, d2, cert = _port(empty, 4, k=3).solve()
    assert nbrs.shape == (0, 3) and cert.shape == (0,)
    # everything in one thin z-slab: most slabs own nothing
    slab = (rng.random((4000, 3)) * np.float32([1000, 1000, 40])).astype(
        np.float32)
    sp = _port(slab, 8, k=5)
    assert sum(bool(p.classes) for p in sp.chip_plans) < 8
    nbrs, d2, cert = sp.solve()
    j_nbrs, j_d2, j_cert = jsh.ShardedKnnProblem.prepare(
        slab, n_devices=8, config=ck.KnnConfig(k=5)).solve()
    assert cert.all() and j_cert.all() and (nbrs >= 0).all()
    _tie_aware(slab, nbrs, d2, j_d2, 5)


def test_halo_slot_goes_to_the_spare_row_and_stays_uncertified(cases):
    """Own cells never cover a halo layer; force one that does: the slots
    of the moved supercell land in the lower halo (window index < hcap),
    go to the spare row, and the local rows they should have written keep
    no slot, stay uncertified and are resolved exactly by the kd-tree."""
    pts, k, _, _ = cases["uniform"]
    for epilogue in ("scatter", "gather"):
        sp = _port(pts, 4, k=k, epilogue=epilogue)
        d, meta = 1, sp.meta
        plan = sp.chip_plans[d]
        cls0 = plan.classes[0]
        A = meta.dim ** 2
        own = cls0.own.copy()
        row = 0
        moved = own[row][own[row] >= 0]
        assert (moved >= meta.radius * A).all()   # local cells
        own[row] = np.where(own[row] >= 0, own[row] - meta.radius * A, -1)
        plans = list(sp.chip_plans)
        plans[d] = psh.ChipPlan(
            classes=(dataclasses.replace(cls0, own=own),)
            + plan.classes[1:], class_of=plan.class_of, row_of=plan.row_of)
        sp.chip_plans = plans
        ready = sp._chip_ready(d)
        tgt = ready.plan.classes[0].tgt.numpy()
        assert (tgt >= 0).all() and (tgt <= meta.pcap).all()
        sids = sp._chip_inputs(d)["sids"].numpy()
        win = sp._chip_ready(d).window
        starts = win.cell_starts.numpy()
        counts = win.cell_counts.numpy()
        # the moved supercell still covers its first local layer
        starved = np.concatenate([np.arange(starts[c], starts[c] + counts[c])
                                  for c in np.setdiff1d(moved, own[row])]
                                 ) - meta.hcap
        assert starved.size > 0
        outs = sp.solve_device()
        nbr, d2, cert = (t.numpy() for t in outs[d])
        assert not cert[starved].any()
        assert (nbr[starved] == -1).all() and np.isinf(d2[starved]).all()
        ids, dd, c = sp.solve(device_out=outs)
        assert c.all()
        assert set(sids[starved]) <= set(sp.fallback_rows.tolist())
        ref_ids, ref_d2 = jsh.ShardedKnnProblem.prepare(
            pts, n_devices=4, config=ck.KnnConfig(k=k)).solve()[:2]
        _tie_aware(pts, ids, dd, ref_d2, k)


@pytest.mark.parametrize("kw", [dict(scorer="mxu"), dict(kernel="blocked"),
                                dict(epilogue="gather"),
                                dict(backend="xla")],
                         ids=["mxu", "blocked", "gather", "xla"])
def test_knobs_at_four_slabs(cases, jax_rows, kw):
    pts, k, _, pp = cases["uniform"]
    sp = _port(pts, 4, k=k, **kw)
    routes = {c.route for p in sp.chip_plans for c in p.classes}
    if "scorer" in kw:
        assert "mxu" in routes
    if "backend" in kw:
        assert routes == {"streamed"}
    ids, d2, cert = sp.solve()
    assert cert.all()
    j_kw = {key: v for key, v in kw.items() if key != "epilogue"}
    _tie_aware(pts, ids, d2, jax_rows("uniform", 4, **j_kw)[1], k)
    base_ids, base_d2, _ = pp.solve()
    # rows both solves certified on the device equal the default knobs'
    # (the kd-tree rounds its own sums on the rest)
    dev = np.ones(pts.shape[0], bool)
    dev[sp.fallback_rows] = dev[pp.fallback_rows] = False
    if "scorer" in kw:
        assert sp.fallback_rows.size > 0   # the fold leaves rows open
    np.testing.assert_array_equal(d2[dev], base_d2[dev])
    np.testing.assert_array_equal(ids[dev], base_ids[dev])


def test_query_radius_edges_stats(cases):
    pts, k, _, pp = cases["blue"]
    queries = generate_uniform(120, seed=55)
    ids, d2, counts, trunc = pp.query_radius(queries, 45.0, max_neighbors=10)
    j_ids, j_d2, j_counts, j_trunc = jsh.ShardedKnnProblem.prepare(
        pts, n_devices=4, config=ck.KnnConfig(k=k)).query_radius(
            queries, 45.0, max_neighbors=10)
    np.testing.assert_array_equal(counts, j_counts)
    np.testing.assert_array_equal(trunc, j_trunc)
    for i in range(120):
        dd = ((queries[i] - pts) ** 2).sum(-1)
        ref = set(np.nonzero(dd <= 45.0 ** 2)[0].tolist())
        got = set(ids[i][ids[i] >= 0].tolist())
        assert got <= ref and (trunc[i] or got == ref), i
    with pytest.raises(ValueError, match="exceeds the prepared k"):
        pp.query_radius(queries, 10.0, max_neighbors=99)
    solved = pp.solve()
    e_sym = pp.get_edges(symmetric=True, solved=solved)
    single = pt.KnnProblem.prepare(pts, pt.KnnConfig(k=k), device="cpu")
    single.solve()
    np.testing.assert_array_equal(e_sym, single.get_edges(symmetric=True))
    assert pp.get_edges().shape == (pts.shape[0] * k, 2)
    s = pp.print_stats()
    assert s["n_devices"] == 4 and s["n_points"] == pts.shape[0]
    assert sum(c["n_points"] for c in s["chips"]) == pts.shape[0]
    assert all(c["margin"]["n"] for c in s["chips"] if c["classes"])
    for c in s["chips"]:
        for cl in c["classes"]:
            assert cl["route"] == "kernel" and cl["ccap"] >= k


def test_drop_ready_and_checkpoints(cases, tmp_path):
    pts, k, _, pp = cases["uniform"]
    n1, d1, _ = pp.solve()
    assert pp._ready_cache
    pp.drop_ready()
    assert not pp._ready_cache
    n2, d2, _ = pp.solve()
    np.testing.assert_array_equal(n1, n2)
    some = next(iter(pp._ready_cache))
    pp.drop_ready(some)
    assert some not in pp._ready_cache
    save_sharded(pp, str(tmp_path / "sp"))
    again = load_sharded(str(tmp_path / "sp.npz"), devices=[CPU] * 4)
    assert dataclass_tuple(again.meta) == dataclass_tuple(pp.meta)
    np.testing.assert_array_equal(again.solve()[0], n1)
    # reload at another slab count: same answers
    two = load_sharded(str(tmp_path / "sp"), devices=[CPU] * 2)
    assert two.meta.ndev == 2
    np.testing.assert_array_equal(two.solve()[1], d1)
    # a checkpoint the JAX package wrote
    jp = jsh.ShardedKnnProblem.prepare(pts, n_devices=2,
                                       config=ck.KnnConfig(k=k))
    jsh.save_sharded(jp, str(tmp_path / "jax"))
    got = load_sharded(str(tmp_path / "jax.npz"), devices=[CPU] * 2)
    assert got.config.k == k and got.meta.ndev == 2
    np.testing.assert_array_equal(got.solve()[1], d1)


def test_refusals(monkeypatch):
    pts = generate_uniform(10000, seed=42)
    with pytest.raises(ValueError, match="halo"):
        _port(pts, 8, k=10, ring_radius=30)
    with pytest.raises(InvalidConfigError, match="single-chip host engine"):
        _port(pts, 2, k=10, backend="oracle")
    with pytest.raises(InvalidConfigError, match="dist_method='diff'"):
        _port(pts, 2, k=10, scorer="mxu", dist_method="dot")
    with pytest.raises(InvalidConfigError, match="does not match"):
        ShardedKnnProblem.prepare(pts, n_devices=3, devices=[CPU] * 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoDeviceError):
        ShardedKnnProblem.prepare(pts)
    with pytest.raises(NoDeviceError):
        ShardedKnnProblem.prepare(pts, devices=["cuda"])


def test_fetch_counts_one_round_trip_off_cuda():
    dispatch.reset_stats()
    a, b = dispatch.fetch(torch.arange(3), torch.ones(2, 2))
    assert dispatch.stats().host_syncs == 1
    np.testing.assert_array_equal(a, [0, 1, 2])
    assert b.shape == (2, 2)


def test_solve_makes_one_round_trip_on_certified_clouds(cases):
    _, _, _, pp = cases["blue"]
    dispatch.reset_stats()
    pp.solve()
    assert dispatch.stats().host_syncs == 1


def test_query_streams_a_kernel_class_over_budget(monkeypatch):
    """A slab's kernel class whose query pack exceeds the memory budget
    streams its queries over the window's own cell table (the plan's
    ``cand_table``) and answers what the kernel route answers."""
    from cuda_knearests_tpu_torch.ops import adaptive

    pts = generate_blue_noise(8000, seed=17)
    sp = _port(pts, 4, k=10, supercell=1, ring_radius=1)
    q = generate_uniform(400, seed=35)
    want = sp.query(q)
    budget = 500_000
    monkeypatch.setattr(adaptive, "hbm_budget_bytes",
                        lambda device, cfg=None: budget)
    d = 1
    ready = sp._chip_ready(d)
    cc = psh.cell_coords_host(q, sp.meta.dim, sp.meta.domain)
    mine = cc[:, 2] // sp.meta.zcap == d
    scidx = ((cc[mine, 2] - d * sp.meta.zcap) * sp.meta.dim ** 2
             + cc[mine, 1] * sp.meta.dim + cc[mine, 0])
    plan = sp.chip_plans[d]
    buckets = adaptive.plan_queries(sp.config, ready.plan,
                                    plan.class_of[scidx], plan.row_of[scidx],
                                    10, budget)
    assert buckets and {b.route for b in buckets} == {"streamed"}
    assert all(cp.cand is None for cp in ready.plan.classes)
    got = sp.query(q)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
