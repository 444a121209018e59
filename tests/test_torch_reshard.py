"""PyTorch port of the mutating pod (``pod/reshard.py``), ``utils/prototrace``
and ``utils/profiling`` against the JAX package, on the CPU.

JAX runs its pod on the emulated CPU devices of ``tests/conftest.py``; the
port runs four chips as ``devices=['cpu'] * 4``.  The same seeded
mutations go through both packages' ``PodOverlay`` and ``ElasticIndex``.
Integer state must be equal exactly: Morton codes, the overlay's counters
and invalid rows, the elastic cuts, shard populations and uids, migration
records, handover summaries and the ``prototrace`` event sequence.  Rows
are held tie-aware (``fuzz/compare``, RTOL 1e-4 / ATOL 1e-2: XLA's CPU
backend contracts multiply-adds, torch does not).  The port's elastic
answers equal its own rebuild oracle byte for byte at every pump.

One counter is not compared across the packages: ``elastic_recompiles``
counts executable-cache misses in JAX and kernel builds plus library loads
in the port, which has no executable cache and builds nothing on the CPU.
"""

import numpy as np
import pytest
import torch

import cuda_knearests_tpu as ck
from cuda_knearests_tpu.io import generate_uniform
from cuda_knearests_tpu.pod import PodKnnProblem as JaxPod
from cuda_knearests_tpu.pod import reshard as jrs
from cuda_knearests_tpu.utils import prototrace as jtrace
import cuda_knearests_tpu_torch as pt
from cuda_knearests_tpu_torch.fuzz.compare import check_route_result
from cuda_knearests_tpu_torch.ops.gridhash import cell_min_d2_host
from cuda_knearests_tpu_torch.oracle import KdTreeOracle
from cuda_knearests_tpu_torch.pod import ElasticIndex, PodKnnProblem, \
    PodOverlay
from cuda_knearests_tpu_torch.pod import reshard as prs
from cuda_knearests_tpu_torch.runtime import dispatch
from cuda_knearests_tpu_torch.utils import profiling, prototrace
from cuda_knearests_tpu_torch.utils.memory import NoDeviceError

NDEV = 4
K = 8
CPU4 = ["cpu"] * NDEV
COUNTERS = ("restaged_chips", "reexchanges", "reexchanges_skipped",
            "delta_launches", "delta_skips")


# -- Morton codes -------------------------------------------------------------

def test_morton_codes_equal_jax():
    rng = np.random.default_rng(17)
    pts = (rng.random((10_000, 3)) * 1000.0).astype(np.float32)
    edges = np.array([[0.0, 0.0, 0.0], [1000.0, 1000.0, 1000.0],
                      [999.9999, 0.0, 500.0], [0.0, 1000.0, 1e-6],
                      [500.0, 500.0, 500.0], [1000.0, 0.0, 999.99994]],
                     np.float32)
    pts[:edges.shape[0]] = edges
    got = prs.morton_codes(pts)
    want = jrs.morton_codes(pts)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(prs.morton_codes(pts, 250.0),
                                  jrs.morton_codes(pts, 250.0))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_need_cells_equals_the_full_bound(seed, monkeypatch):
    """The chunked, box-filtered pruning mask equals the reference's one
    (m, c) bound matrix bit for bit, at float32 k-th distances as the
    delta merge passes them, rows of infinite k-th distance and chunks of
    a few rows included."""
    rng = np.random.default_rng(seed)
    dim = 37
    q = (rng.random((3_000, 3)) * 1000.0).astype(np.float32)
    cells = np.unique(rng.integers(0, dim ** 3, 60)).astype(np.int32)
    kth = (rng.random(3_000) * 400.0).astype(np.float32)
    kth[rng.random(3_000) < 0.01] = np.inf
    want = (cell_min_d2_host(q, cells, dim) <= kth[:, None]).any(axis=0)
    monkeypatch.setattr(prs, "_BOUND_CHUNK_PAIRS", 7 * cells.size)
    np.testing.assert_array_equal(prs.need_cells(q, kth, cells, dim, 1000.0),
                                  want)
    kth[:] = 0.5
    want = (cell_min_d2_host(q, cells, dim) <= kth[:, None]).any(axis=0)
    np.testing.assert_array_equal(prs.need_cells(q, kth, cells, dim, 1000.0),
                                  want)


# -- PodOverlay ---------------------------------------------------------------

@pytest.fixture(scope="module")
def cloud():
    return generate_uniform(4_000, seed=11)


def _stage_counter(monkeypatch):
    calls = []
    real = dispatch.stage

    def counted(array, device):
        calls.append(device)
        return real(array, device)

    monkeypatch.setattr(dispatch, "stage", counted)
    return calls


def _pick(ov, n_each, rng):
    """(exported ids, interior ids): base points whose cell lies in their
    owner chip's export block, and points whose cell does not."""
    cells = ov._cells_of(ov.pp._points_host)
    exported = np.asarray([int(c) in ov._exported[int(d)]
                           for d, c in zip(ov._chip_of, cells)])
    ex, inner = np.nonzero(exported)[0], np.nonzero(~exported)[0]
    assert ex.size >= n_each and inner.size >= n_each
    return (np.sort(rng.choice(ex, n_each, replace=False)),
            np.sort(rng.choice(inner, n_each, replace=False)))


def _stable_points(ov):
    """Coordinates by stable id: base originals, then inserts."""
    return np.concatenate([ov.pp._points_host, ov.delta])


def _rows_tie_aware(ov, queries, ids, d2, rows, k, base_rows=False):
    """Rows ``rows`` of (ids, d2) exact against a kd-tree over the mutated
    cloud, tie-aware (``base_rows``: the queries are the base points of
    those ids, each excluding itself)."""
    live = ov.mutated_points()
    excl = (np.cumsum(ov.alive)[rows] - 1).astype(np.int32) \
        if base_rows else None
    _, ref_d = KdTreeOracle(live).knn(queries[rows], k, exclude_ids=excl)
    bad = check_route_result(_stable_points(ov), queries[rows], ids[rows],
                             d2[rows], ref_d, k)
    assert bad is None, bad.render()


def _mutations(jov, pov, monkeypatch):
    """The seeded sequence through both overlays: deletes in exported
    cells, deletes in interior cells, inserts, deletes of inserts.  After
    each step the counters and n_points equal JAX's; every delete makes 0
    host round trips, at most 2 * ndev stages, and ici bytes equal to
    halo_bytes exactly when it re-exchanged."""
    rng = np.random.default_rng(170)
    ex, inner = _pick(pov, 12, rng)
    ins = (rng.random((40, 3)) * 110.0 + 5.0).astype(np.float32)
    ins = np.concatenate([ins, (rng.random((8, 3)) * 1000.0)
                          .astype(np.float32)])
    steps = ([("delete", ex[i:i + 4]) for i in range(0, 12, 4)]
             + [("delete", inner[i:i + 6]) for i in range(0, 12, 6)]
             + [("insert", ins[:30]), ("insert", ins[30:])]
             + [("delete", np.asarray([pov.n0 + 3, pov.n0 + 31,
                                       pov.n0 + 44]))]
             + [("delete", np.concatenate([ex[:2], inner[-1:]]))])
    halo = pov.pp.meta.halo_bytes()
    calls = _stage_counter(monkeypatch)
    for kind, arg in steps:
        if kind == "insert":
            np.testing.assert_array_equal(pov.insert(arg), jov.insert(arg))
        else:
            before = pov.stats["reexchanges"]
            jov.delete(arg)
            dispatch.reset_stats()
            calls.clear()
            pov.delete(arg)
            st = dispatch.stats()
            again = pov.stats["reexchanges"] - before
            assert st.host_syncs == 0
            assert st.ici_bytes == again * halo
            assert len(calls) <= 2 * NDEV
        for key in COUNTERS + ("inserts", "deletes"):
            assert pov.stats[key] == jov.stats[key], (kind, key)
        assert pov.n_points == jov.n_points
    assert pov.stats["reexchanges"] > 0
    assert pov.stats["reexchanges_skipped"] > 0
    return ex, inner


@pytest.mark.parametrize("scorer", ["diff", "mxu"])
def test_pod_overlay_equal_jax(cloud, scorer, monkeypatch):
    kw = {"k": K} if scorer == "diff" else {"k": K, "scorer": "mxu"}
    jpp = JaxPod.prepare(np.array(cloud), n_devices=NDEV,
                         config=ck.KnnConfig(**kw))
    ppp = PodKnnProblem.prepare(np.array(cloud), config=pt.KnnConfig(**kw),
                                devices=CPU4)
    jpp.solve()
    ppp.solve()                # the exchange and every ready state cached
    jov, pov = jrs.PodOverlay(jpp), PodOverlay(ppp)
    assert pov._exported == jov._exported
    np.testing.assert_array_equal(pov._bkt_ids, jov._bkt_ids)
    ex, inner = _mutations(jov, pov, monkeypatch)

    # the caller's cloud was never written
    np.testing.assert_array_equal(cloud, generate_uniform(4_000, seed=11))
    # every live bucket row's certificate, before the kd-tree fallback,
    # equals JAX's: the tombstones widen no band under 'diff', and under
    # 'mxu' they decertify the same supercells in both packages
    j_out, p_out = jpp.solve_device(), ppp.solve_device()
    opened = 0
    for d in range(NDEV):
        live = pov._bkt_ids[d] >= 0
        got = p_out[d][2].numpy()[live]
        np.testing.assert_array_equal(got, np.asarray(j_out[d][2])[live])
        opened += int((~got).sum())
    assert (opened > 0) == (scorer == "mxu")

    dispatch.reset_stats()
    nb, d2, cert = pov.solve()
    assert dispatch.stats().host_syncs <= 2
    j_nb, j_d2, j_cert = (np.asarray(a) for a in jov.solve())
    for key in COUNTERS:
        assert pov.stats[key] == jov.stats[key], key
    np.testing.assert_array_equal(nb < 0, j_nb < 0)
    np.testing.assert_array_equal(cert, j_cert)
    dead = np.nonzero(~pov.alive)[0]
    assert (nb[dead] == -1).all() and np.isinf(d2[dead]).all()
    assert not cert[dead].any()
    assert not np.isin(nb, dead).any()
    assert not np.isnan(d2).any()
    assert np.isfinite(d2[nb < 0]).sum() == 0
    rows = np.nonzero(pov.alive)[0]
    pts = pov.pp._points_host
    _rows_tie_aware(pov, pts, nb, d2, rows, K, base_rows=True)
    bad = check_route_result(_stable_points(pov), pts[rows], nb[rows],
                             d2[rows], j_d2[rows], K)
    assert bad is None, bad.render()

    q = (np.random.default_rng(901).random((600, 3)) * 1000.0) \
        .astype(np.float32)
    q[:100] = (np.random.default_rng(902).random((100, 3)) * 110.0
               + 5.0).astype(np.float32)
    dispatch.reset_stats()
    qi, qd = pov.query(q)
    assert dispatch.stats().host_syncs <= 2
    j_qi, j_qd = (np.asarray(a) for a in jov.query(q))
    for key in COUNTERS:
        assert pov.stats[key] == jov.stats[key], key
    np.testing.assert_array_equal(qi < 0, j_qi < 0)
    assert not np.isin(qi, dead).any() and not np.isnan(qd).any()
    _rows_tie_aware(pov, q, qi, qd, np.arange(q.shape[0]), K)
    bad = check_route_result(_stable_points(pov), q, qi, qd, j_qd, K)
    assert bad is None, bad.render()
    assert pov.stats_dict() == jov.stats_dict()


def test_pod_overlay_deleted_point_leaves_every_window(cloud):
    """A point of an exported cell deleted after a solve is gone from
    every row of the next solve: its own chip's and every chip that
    imports its cell (the ready states are dropped, the halo re-run).
    Its neighbours' rows change to the kd-tree's over the mutated cloud."""
    pp = PodKnnProblem.prepare(np.array(cloud), config=pt.KnnConfig(k=K),
                               devices=CPU4)
    ov = PodOverlay(pp)
    nb0, _, _ = ov.solve()
    cells = ov._cells_of(pp._points_host)
    owner = ov._chip_of
    victim = next(i for i in range(ov.n0)
                  if int(cells[i]) in ov._exported[int(owner[i])]
                  and any(int(owner[j]) != int(owner[i])
                          for j in np.nonzero((nb0 == i).any(axis=1))[0]))
    holders = np.nonzero((nb0 == victim).any(axis=1))[0]
    assert {int(owner[j]) for j in holders} - {int(owner[victim])}
    ov.delete(np.asarray([victim]))
    assert ov.stats["reexchanges"] == 1 and not pp._ready_cache
    for d in range(NDEV):        # no received block still carries it
        assert not (pp._halo[d][1] == victim).any()
    nb, d2, cert = ov.solve()
    assert not (nb == victim).any()
    assert (nb[victim] == -1).all() and not cert[victim]
    _rows_tie_aware(ov, pp._points_host, nb, d2, holders, K,
                    base_rows=True)


def test_pod_overlay_before_any_exchange(cloud):
    """Deletes before the first solve restage only: the lazy exchange then
    reads the restaged buckets (counters as JAX's)."""
    jpp = JaxPod.prepare(np.array(cloud), n_devices=NDEV,
                         config=ck.KnnConfig(k=K))
    ppp = PodKnnProblem.prepare(np.array(cloud), config=pt.KnnConfig(k=K),
                                devices=CPU4)
    jov, pov = jrs.PodOverlay(jpp), PodOverlay(ppp)
    ids = np.arange(0, 4_000, 97)
    jov.delete(ids)
    pov.delete(ids)
    assert pov.stats == jov.stats and pov.stats["reexchanges"] == 0
    nb, d2, _ = pov.solve()
    assert not np.isin(nb, ids).any()
    _rows_tie_aware(pov, ppp._points_host, nb, d2,
                    np.nonzero(pov.alive)[0], K, base_rows=True)


# -- ElasticIndex -------------------------------------------------------------

def _elastic_pair(**kw):
    pts = generate_uniform(420, seed=21)
    args = dict(k=6, nshards=2, compact_threshold=64, skew_threshold=3.0,
                migration_chunk=8)
    args.update(kw)
    return (jrs.ElasticIndex(pts, **args),
            ElasticIndex(pts, device="cpu", **args))


def _stats(el):
    out = el.stats_dict()
    out.pop("elastic_recompiles")
    return out


def _same_state(j, p):
    np.testing.assert_array_equal(p.cuts, j.cuts)
    np.testing.assert_array_equal(p.uids_canonical, j.uids_canonical)
    assert [s.n_points for s in p.shards] == [s.n_points for s in j.shards]
    for sj, sp in zip(j.shards, p.shards):
        np.testing.assert_array_equal(sp.uids, sj.uids)
        np.testing.assert_array_equal(sp.points(), sj.points())
    assert _stats(p) == _stats(j)
    assert (p.migration is None) == (j.migration is None)
    if p.migration is not None:
        assert p.migration.committed_seq == j.migration.committed_seq
        assert p.migration.acked_seq == j.migration.acked_seq
        assert list(p.migration.pending) == list(j.migration.pending)


def _rows_equal_jax(p, j, q, k):
    gi, gd = p.query(q, k)
    oi, od = p.rebuild_oracle_query(q, k)
    np.testing.assert_array_equal(gi, oi)
    np.testing.assert_array_equal(gd, od)
    ji, jd = (np.asarray(a) for a in j.query(q, k))
    bad = check_route_result(p.mutated_points(), q, gi, gd, jd, k)
    assert bad is None, bad.render()
    np.testing.assert_array_equal(gi < 0, ji < 0)


def _traced(run):
    """Run ``run()`` with both packages' recorders on; their traces."""
    jtrace.enable()
    prototrace.enable()
    try:
        out = run()
        return out, jtrace.drain(), prototrace.drain()
    finally:
        jtrace.disable()
        prototrace.disable()


def test_elastic_live_reshard_equal_jax():
    """tests/test_pod.py's live reshard on both packages: the port's
    answers equal its rebuild oracle byte for byte at every pump and
    JAX's tie-aware; the state, the records, the handover summary and the
    protocol trace equal JAX's."""
    j, p = _elastic_pair()
    _same_state(j, p)
    rng = np.random.default_rng(4)
    hot = (rng.random((48, 3)) * 110.0 + 5.0).astype(np.float32)
    q = (np.random.default_rng(6).random((20, 3)) * 980.0
         + 10.0).astype(np.float32)

    def run():
        j.insert(hot)
        p.insert(hot)
        _same_state(j, p)
        assert p.force_rebalance() and j.force_rebalance()
        _same_state(j, p)
        summaries, pumps = [], 0
        while p.migration is not None and pumps < 10_000:
            _rows_equal_jax(p, j, q, 6)
            if pumps == 3:        # mid-migration mutations, both kinds
                extra = (np.random.default_rng(8).random((6, 3)) * 110.0
                         + 5.0).astype(np.float32)
                j.insert(extra)
                p.insert(extra)
                j.delete(np.asarray([2, 17, 400]))
                p.delete(np.asarray([2, 17, 400]))
            summaries.append((p.pump(), j.pump()))
            _same_state(j, p)
            pumps += 1
        return summaries, pumps

    (summaries, pumps), j_ev, p_ev = _traced(run)
    assert p.migrations_done == j.migrations_done == 1 and pumps > 1
    for got, want in summaries:
        assert got == want
    assert summaries[-1][0]["records"] > 0
    assert p_ev == j_ev and ("migration-handover", "handover") in p_ev
    _rows_equal_jax(p, j, q, 6)
    _rows_equal_jax(p, j, q[:1], 6)
    assert p.elastic_recompiles == 0


def _chaos(el, case):
    """One seeded fault schedule on an index; its outcome: the pump
    summaries and the final summaries, or the exception type."""
    rng = np.random.default_rng(31)
    el.insert((rng.random((48, 3)) * 110.0 + 5.0).astype(np.float32))
    q = (np.random.default_rng(6).random((12, 3)) * 980.0
         + 10.0).astype(np.float32)
    el.query(q, 6)
    if case == "torn-migration" or case == "lost-range":
        el.fault = case
    assert el.force_rebalance()
    out = []
    try:
        for pump in range(40):
            if case == "wedge" and pump == 2:
                out.append(("wedge", el.wedge_migration()))
            if case == "delay" and pump == 1:
                out.append(("delay", el.delay_handover(5)))
            if case == "lose-shard" and pump == 2:
                out.append(("lose", el.lose_shard(
                    el.migration.receiver, el.mutated_points())))
            out.append(el.pump())
            if el.migration is None:
                break
        ids, d2 = el.query(q, 6)
        out.append(("rows", ids.shape, int((ids >= 0).sum())))
    except Exception as e:  # noqa: BLE001 -- the outcome is the exception type
        out.append(("raised", type(e).__name__))
    out.append(("stats", _stats(el)))
    return out


@pytest.mark.parametrize("case", ["lose-shard", "wedge", "delay",
                                  "torn-migration", "lost-range"])
def test_elastic_chaos_outcome_equal_jax(case):
    j, p = _elastic_pair(abort_after_pumps=6)
    (got, j_ev, p_ev) = _traced(lambda: (_chaos(p, case), _chaos(j, case)))
    p_out, j_out = got
    assert p_out == j_out
    assert p_ev == j_ev
    if case == "wedge":
        assert p.migrations_aborted == 1
    if case in ("torn-migration", "lost-range"):
        assert p.migrations_done == 1
        # the broken flip is visible: the index no longer holds every uid
        assert sum(s.n_points for s in p.shards) < p.n_points


def test_elastic_refuses_without_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(NoDeviceError):
        ElasticIndex(generate_uniform(50, seed=1), k=4)


# -- prototrace and profiling -------------------------------------------------

def test_prototrace_recorder_is_bounded_and_off_by_default(monkeypatch):
    assert jtrace._MAX_EVENTS == prototrace._MAX_EVENTS == 100_000
    assert not prototrace.enabled
    prototrace.record("replication-commit", "apply")  # no-op when off
    prototrace.enable()
    try:
        prototrace.record("replication-commit", "apply")
        prototrace.record("replication-commit", "append")
        assert prototrace.drain() == [("replication-commit", "apply"),
                                      ("replication-commit", "append")]
        assert prototrace.drain() == []  # drain clears
        assert prototrace.dropped() == 0
        monkeypatch.setattr(prototrace, "_MAX_EVENTS", 3)
        for _ in range(5):
            prototrace.record("migration-handover", "pump")
        assert prototrace.dropped() == 2
        assert len(prototrace.drain()) == 3
        assert prototrace.dropped() == 0
    finally:
        prototrace.disable()
    prototrace.record("migration-handover", "pump")
    assert prototrace.drain() == []


def test_profiling_trace_and_annotate(tmp_path):
    with profiling.trace(str(tmp_path / "t")):
        with profiling.annotate("kntpu:probe"):
            torch.ones(8).sum()
    files = list((tmp_path / "t").glob("*.json"))
    assert files and "kntpu:probe" in files[0].read_text()
