"""The serving daemon of the PyTorch port against the JAX package's.

The same numpy inputs go through both packages on the CPU: the JAX daemon
as ``tests/test_serve.py`` runs it (``KnnConfig(adaptive=False)``, the
legacy route its serving pins), the port's daemon with ``device='cpu'`` on
the adaptive class route (the one it has).  The host pieces
(``ServeConfig``, ``validate_request``, ``build_schedule``,
``DynamicBatcher``, the delta-grid helpers, the fault classifier, the
metrics histogram) must equal JAX's output for output.  One seeded mixed
stream -- queries, inserts, deletes, a compaction, a ``fof`` request, an
injected batch fault and a malformed request -- must get the same response
from both daemons: ``ok``, ``failure_kind`` and ``n_points`` equal, query
rows tie-aware equal with d2 within RTOL 1e-4 / ATOL 1e-2
(``fuzz/compare.check_route_result``: XLA's CPU backend contracts
multiply-adds where torch rounds each operation), FoF labels inside the
union-find oracle's bracket (``cluster/compare.check_fof_result``) and
equal where the float32 band holds no pair.  Then the port's own laws:
the overlay byte-identical to a rebuild, compaction, dirty-cell pruning,
containment, the barrier, the wire, the stdio front end and zero
recompiles after warmup.
"""

import json
import os
import select
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from cuda_knearests_tpu import KnnConfig as JKnnConfig
from cuda_knearests_tpu import KnnProblem as JKnnProblem
from cuda_knearests_tpu.config import ServeConfig as JServeConfig
from cuda_knearests_tpu.io import validate_request as jvalidate_request
from cuda_knearests_tpu.obs import metrics as jmetrics
from cuda_knearests_tpu.ops import gridhash as jgridhash
from cuda_knearests_tpu.serve import DynamicBatcher as JDynamicBatcher
from cuda_knearests_tpu.serve import LoadSpec as JLoadSpec
from cuda_knearests_tpu.serve import Request as JRequest
from cuda_knearests_tpu.serve import ServeDaemon as JServeDaemon
from cuda_knearests_tpu.serve import build_schedule as jbuild_schedule
from cuda_knearests_tpu.utils import memory as jmemory
import cuda_knearests_tpu_torch as pt
from cuda_knearests_tpu_torch import oracle
from cuda_knearests_tpu_torch.cluster import compare
from cuda_knearests_tpu_torch.cluster.fof import fof_labels
from cuda_knearests_tpu_torch.config import ServeConfig
from cuda_knearests_tpu_torch.fuzz.compare import check_route_result
from cuda_knearests_tpu_torch.io import generate_uniform, validate_request
from cuda_knearests_tpu_torch.obs import metrics, spans
from cuda_knearests_tpu_torch.ops import _build, gridhash
from cuda_knearests_tpu_torch.runtime import dispatch
from cuda_knearests_tpu_torch.runtime.supervisor import FAILURE_KINDS
from cuda_knearests_tpu_torch.serve import (DeltaOverlay, DynamicBatcher,
                                            LoadSpec, Request, ServeDaemon,
                                            build_schedule, run_session)
from cuda_knearests_tpu_torch.serve import __main__ as serve_main
from cuda_knearests_tpu_torch.serve.daemon import Response
from cuda_knearests_tpu_torch.utils import memory

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOF_B = 20.0
# request sizes within max_batch=32 (the loadgen default mix has 64)
SMALL_MIX = ((1, 0.45), (4, 0.25), (16, 0.3))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain class kernel and FoF's rounds are many small torch
    operations; beside other test processes torch's CPU thread pool
    oversubscribes the cores, so this module runs torch on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cloud():
    return generate_uniform(10_000, seed=42)


@pytest.fixture(scope="module")
def served(cloud):
    return pt.KnnProblem.prepare(cloud, pt.KnnConfig(k=10), device="cpu")


def _inserts(seed, m):
    return (np.random.default_rng(seed).random((m, 3)) * 990 + 5
            ).astype(np.float32)


# -- host pieces against JAX ----------------------------------------------------

SERVE_CONFIGS = [
    dict(max_batch=100, min_bucket=8), dict(max_batch=64),
    dict(max_batch=1, min_bucket=1), dict(max_batch=257, min_bucket=5),
    dict(max_batch=4, min_bucket=8), dict(max_delay_s=-1.0),
    dict(compact_threshold=0), dict(k=0), dict(k=None), dict(k=3),
]


@pytest.mark.parametrize("kw", SERVE_CONFIGS, ids=str)
def test_serve_config_matches_jax(kw):
    try:
        want = JServeConfig(**kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            ServeConfig(**kw)
        assert str(got.value) == str(e)
        return
    cfg = ServeConfig(**kw)
    assert cfg.buckets() == want.buckets()
    for m in range(1, cfg.max_batch + 1):
        assert cfg.bucket_for(m) == want.bucket_for(m)


REFUSALS = [
    ("query", np.zeros((4, 2), np.float32), {}),                # bad shape
    ("query", "not points", {}),
    ("query", generate_uniform(4, seed=1), {"k": 99}),          # k > serving
    ("query", generate_uniform(4, seed=1), {"k": 0}),
    ("query", generate_uniform(64, seed=1), {}),                # > max_batch
    ("query", np.full((3, 3), -42.0, np.float32), {}),          # domain
    ("insert", np.full((2, 3), np.nan, np.float32), {}),        # non-finite
    ("delete", np.array([0.5, 1.5]), {}),                       # float ids
    ("delete", np.array([10 ** 9]), {}),                        # range
    ("delete", np.array([-1]), {}),
    ("delete", np.array([1, 1]), {}),                           # duplicates
    ("delete", np.zeros((2, 2), np.int64), {}),
    ("frobnicate", np.zeros((1, 3), np.float32), {}),           # kind
    ("fof", -1.0, {}), ("fof", "12", {}), ("fof", True, {}),
    ("fof", float("nan"), {}),
    ("query", generate_uniform(2, seed=1),
     {"tenant": "c", "tenants": ("a", "b")}),                   # tenant
    ("query", generate_uniform(2, seed=1),
     {"tenant": "a", "tenants": ("a",), "quota_ok": False}),    # quota
]
ACCEPTED = [
    ("query", generate_uniform(5, seed=2), {"k": 3}),
    ("query", np.zeros((0, 3), np.float32), {}),
    ("insert", generate_uniform(3, seed=4), {}),
    ("delete", np.array([3, 0, 99]), {}),
    ("delete", np.array([], np.int64), {}),
    ("fof", 12, {}),
    ("query", generate_uniform(2, seed=1),
     {"tenant": "a", "tenants": ("a",), "quota_ok": True}),
]


def _validate(fn, kind, payload, kw):
    base = dict(k_max=10, n_current=100, max_batch=32)
    return fn(kind, payload, **{**base, **kw})


@pytest.mark.parametrize("case", range(len(REFUSALS)))
def test_validate_request_refusals_match_jax(case):
    kind, payload, kw = REFUSALS[case]
    with pytest.raises(jmemory.InputContractError) as want:
        _validate(jvalidate_request, kind, payload, kw)
    with pytest.raises(memory.InputContractError) as got:
        _validate(validate_request, kind, payload, kw)
    assert type(got.value).__name__ == type(want.value).__name__
    assert got.value.kind == want.value.kind == "invalid-input"
    assert memory.classify_fault_text(
        f"{type(got.value).__name__}: {got.value}") == "invalid-input"


@pytest.mark.parametrize("case", range(len(ACCEPTED)))
def test_validate_request_accepts_as_jax(case):
    kind, payload, kw = ACCEPTED[case]
    want = _validate(jvalidate_request, kind, payload, kw)
    got = _validate(validate_request, kind, payload, kw)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert np.asarray(got).dtype == np.asarray(want).dtype


@pytest.mark.parametrize("spec", [
    dict(rate=100.0, requests=40, mutation_ratio=0.3, seed=9),
    dict(rate=400.0, requests=160, mutation_ratio=0.2, seed=21),
    dict(rate=50.0, requests=30, k=4, seed=3,
         batch_mix=((1, 0.5), (7, 0.5))),
    dict(rate=1000.0, requests=50, mutation_ratio=0.9, mutation_size=3,
         seed=5),
], ids=lambda s: f"seed{s['seed']}")
def test_build_schedule_matches_jax(spec):
    got = build_schedule(LoadSpec(**spec), n_current=60, domain=1000.0)
    want = jbuild_schedule(JLoadSpec(**spec), n_current=60, domain=1000.0)
    assert len(got) == len(want) == spec["requests"]
    for a, b in zip(got, want):
        assert a["t"] == b["t"] and a["kind"] == b["kind"]
        assert a.get("k") == b.get("k")
        np.testing.assert_array_equal(a["payload"], b["payload"])
        assert a["payload"].dtype == b["payload"].dtype


def test_batcher_matches_jax():
    """One synthetic clock, one arrival sequence: the same batches (riders,
    capacity, reason) and flush counts from both batchers."""
    rng = np.random.default_rng(7)
    cfg = dict(max_batch=32, max_delay_s=0.5)
    got_b, want_b = DynamicBatcher(ServeConfig(**cfg)), \
        JDynamicBatcher(JServeConfig(**cfg))
    got, want = [], []
    t = 0.0
    for i in range(200):
        t += float(rng.exponential(0.2))
        m = int(rng.choice([1, 4, 16, 31, 32]))
        q = np.zeros((m, 3), np.float32)
        for batcher, req, out in ((got_b, Request, got),
                                  (want_b, JRequest, want)):
            if i % 7 == 0:
                b = batcher.flush("barrier", t)
                out.extend([b] if b is not None else [])
            b = batcher.poll(t)
            out.extend([b] if b is not None else [])
            out.extend(batcher.admit(req(req_id=i, queries=q, k=10,
                                         arrived_at=t), t))
        assert got_b.next_deadline() == want_b.next_deadline()
        assert got_b.pending_queries == want_b.pending_queries
    for batcher, out in ((got_b, got), (want_b, want)):
        b = batcher.flush("drain", t)
        out.extend([b] if b is not None else [])
    assert len(got) == len(want) > 20
    for a, b in zip(got, want):
        assert [r.req_id for r in a.requests] == \
            [r.req_id for r in b.requests]
        assert (a.capacity, a.reason, a.total, a.formed_at) == \
            (b.capacity, b.reason, b.total, b.formed_at)
    assert got_b.flushes == want_b.flushes
    assert all(got_b.flushes.values())


def test_delta_grid_helpers_match_jax():
    pts = _inserts(11, 300)
    queries = _inserts(12, 50)
    for dim in (1, 7, 15, 66):
        got = gridhash.delta_csr_host(pts, dim)
        want = jgridhash.delta_csr_host(pts, dim)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        np.testing.assert_array_equal(
            gridhash.cell_min_d2_host(queries, got[1], dim),
            jgridhash.cell_min_d2_host(queries, want[1], dim))


FAULT_TEXTS = [
    "UNAVAILABLE: socket closed", "CUDA out of memory. Tried to allocate",
    "RESOURCE_EXHAUSTED while allocating", "headroom exceeded", "zoom",
    "InvalidRequestError: x", "request contract", "over quota",
    "plain crash", "", "broken pipe and out of memory",
]


@pytest.mark.parametrize("text", FAULT_TEXTS)
def test_classify_fault_text_matches_jax(text):
    assert memory.classify_fault_text(text) == \
        jmemory.classify_fault_text(text)


def test_error_kinds_match_jax():
    for name in ("TransportError", "DeviceOOMError", "LaunchBudgetError",
                 "InvalidRequestError", "UnknownTenantError",
                 "OverQuotaError", "InvalidConfigError"):
        assert getattr(memory, name).kind == getattr(jmemory, name).kind
        assert getattr(memory, name).kind in FAILURE_KINDS
    assert issubclass(memory.OverQuotaError, memory.InvalidRequestError)
    assert issubclass(memory.DeviceOOMError, memory.DeviceMemoryError)


def test_histogram_matches_jax():
    rng = np.random.default_rng(3)
    got, want = metrics.Histogram("a"), jmetrics.Histogram("a")
    for v in np.concatenate([rng.lognormal(1.0, 2.0, 5000), [0.0, 1e9]]):
        got.observe(v)
        want.observe(v)
    assert got.snapshot() == want.snapshot()
    assert metrics.percentile_fields(got) == jmetrics.percentile_fields(want)


def test_metrics_snapshot_and_emitter(tmp_path):
    reg = metrics.REGISTRY
    reg.counter("test.serve.c").inc(3)
    reg.gauge("test.serve.g").set(1.5)
    reg.register_provider("test.serve.bad", lambda: 1 / 0)
    snap = metrics.metrics_snapshot()
    assert {"v", "ts", "pid", "counters", "gauges", "histograms",
            "providers", "dispatch", "kernels"} <= set(snap)
    assert "exec_cache" not in snap and "tuned_plans" not in snap
    assert snap["counters"]["test.serve.c"] == 3
    assert "error" in snap["providers"]["test.serve.bad"]
    assert set(snap["kernels"]) == {"kernel_builds", "kernel_loads",
                                    "kernel_launches"}
    path = tmp_path / "m.jsonl"
    em = metrics.JsonlEmitter(str(path), period_s=0.05)
    em.start()
    time.sleep(0.2)
    em.stop()
    assert not em.is_alive()
    lines = path.read_text().splitlines()
    assert len(lines) >= 2 and json.loads(lines[-1])["v"] == metrics.SCHEMA


def test_spans_capture_and_schema():
    assert spans.span("x") is spans.span("y")      # disabled: the no-op
    with spans.capture() as events:
        with spans.span("outer", trace_id="t1", a=1):
            with spans.span("inner"):
                pass
        spans.event("ping", trace_id="t2")
        spans.emit("retro", spans.now() - 0.01, spans.now(), req=3)
    assert [e["name"] for e in events] == ["inner", "outer", "ping", "retro"]
    assert all(spans.validate_event(e) is None for e in events)
    assert events[0]["parent"] == "outer" and events[0]["depth"] == 1
    assert events[1]["trace_id"] == "t1"
    forced = spans.span("forced", force=True)
    with forced:
        pass
    assert forced.dur_ms >= 0.0 and not spans.enabled()


# -- one mixed stream through both daemons ---------------------------------------

def _stream(n0: int):
    """A seeded mixed request stream with a compaction (68 mutations at
    compact_threshold=64), a fof request, a malformed request and the
    batch the injected fault hits; (t, kind, payload, k) per request."""
    items = [(it["t"], it["kind"], it["payload"], it.get("k"))
             for it in build_schedule(
                 LoadSpec(rate=300.0, requests=34, mutation_ratio=0.35,
                          mutation_size=4, seed=31,
                          batch_mix=((1, 0.4), (5, 0.3), (23, 0.3))),
                 n_current=n0)]
    t_end = items[-1][0]
    items.insert(9, (items[8][0], "query", np.full((2, 3), -1.0,
                                                   np.float32), None))
    items.insert(20, (items[19][0], "fof", FOF_B, None))
    items.insert(21, (items[20][0], "query", generate_uniform(7, seed=8), 4))
    for i in range(3):
        t_end += 0.01
        items.append((t_end, "insert", _inserts(40 + i, 12), None))
        items.append((t_end, "query", generate_uniform(9, seed=50 + i), None))
    items.append((t_end + 0.01, "fof", FOF_B, None))
    return items


def _replay(daemon, items):
    """Feed ``items`` at their times on a synthetic clock (deadline polls
    before each admission), drain at the end; responses by request id."""
    out = []
    for i, (t, kind, payload, k) in enumerate(items):
        out += daemon.poll(t)
        out += daemon.submit(req_id=i, kind=kind, payload=payload, k=k, now=t)
    out += daemon.drain(items[-1][0] + 1.0)
    assert len(out) == len(items)
    return {r.req_id: r for r in out}


def _clouds_before(cloud, items):
    """The mutated cloud each request is answered against: mutations are
    barriers, so request i sees exactly the mutations admitted before it
    (``np.delete`` then append, the canonical order)."""
    cur, out = cloud, []
    for _, kind, payload, _ in items:
        out.append(cur)
        if kind == "delete":
            cur = np.delete(cur, payload, axis=0)
        elif kind == "insert":
            cur = np.concatenate([cur, payload])
    return out


def test_daemon_stream_matches_jax(cloud, served, monkeypatch):
    monkeypatch.setenv("KNTPU_SERVE_FAULT", "batch:2:oom")
    cfg = dict(max_batch=32, max_delay_s=0.02, compact_threshold=64)
    jdaemon = JServeDaemon(JKnnProblem.prepare(
        cloud, JKnnConfig(k=10, adaptive=False)), JServeConfig(**cfg))
    daemon = ServeDaemon(served, ServeConfig(**cfg))
    items = _stream(cloud.shape[0])
    want = _replay(jdaemon, items)
    got = _replay(daemon, items)
    counted = {"query": 0, "fof": 0, "failed": 0}
    for i, (points, (t, kind, payload, k)) in enumerate(
            zip(_clouds_before(cloud, items), items)):
        g, w = got[i], want[i]
        assert (g.ok, g.failure_kind, g.n_points) == \
            (w.ok, w.failure_kind, w.n_points), (i, kind, g.error, w.error)
        if not g.ok:
            counted["failed"] += 1
        elif kind == "fof":
            counted["fof"] += 1
            # check_fof_result on both labelings, the oracle run once
            mand, allowed = oracle.fof_oracle(points, FOF_B,
                                              compare.fof_band(FOF_B))
            for res in (g, w):
                bad = compare.check_fof_bracket(res.labels, None, mand,
                                                allowed)
                assert bad is None, bad.render()
            if np.array_equal(mand, allowed):
                np.testing.assert_array_equal(g.labels, w.labels)
            assert g.n_clusters == w.n_clusters
        elif kind == "query":
            counted["query"] += 1
            kq = k or 10
            assert g.ids.shape == w.ids.shape == (payload.shape[0], kq)
            bad = check_route_result(points, payload, g.ids, g.d2,
                                     np.asarray(w.d2), kq)
            assert bad is None, (i, bad.render())
    oom = [r for r in got.values() if r.failure_kind == "oom"]
    assert counted["fof"] == 2 and counted["query"] > 15
    assert counted["failed"] == 1 + len(oom) and oom
    assert daemon.refused == jdaemon.refused == 1
    assert daemon.failure_kinds == jdaemon.failure_kinds == {"oom": 1}
    assert daemon.overlay.stats.compactions == \
        jdaemon.overlay.stats.compactions == 1
    assert daemon.overlay.stats.resolved_rows > 0
    assert daemon.overlay.stats.delta_launches > 0
    np.testing.assert_array_equal(daemon.overlay.mutated_points(),
                                  jdaemon.overlay.mutated_points())


# -- the port's own laws ----------------------------------------------------------

def _daemon(problem, **kw):
    """A daemon without the warmup pass (the laws below do not depend on
    it; ``test_steady_state_zero_recompiles`` warms)."""
    return ServeDaemon(problem, ServeConfig(
        **{"max_batch": 64, "max_delay_s": 0.001, "warmup": False, **kw}))


def test_overlay_byte_identical_to_rebuild(served):
    """After interleaved deletes and inserts the overlay's answers equal a
    full re-prepare of the mutated cloud bit for bit, in the overlay state
    and after compaction."""
    rng = np.random.default_rng(1234)
    ov = DeltaOverlay(served, compact_threshold=10 ** 6)
    n0 = served.grid.n_points
    ov.delete(np.sort(rng.choice(n0, 60, replace=False)))
    ov.insert(_inserts(5, 90))
    ov.delete(np.sort(rng.choice(ov.n_points, 10, replace=False)))
    queries = generate_uniform(400, seed=77)
    dispatch.reset_stats()
    got_i, got_d = ov.query(queries, 10)
    # the base query's fetch, tombstone resolution, the delta merge
    assert dispatch.stats().host_syncs <= dispatch.SYNC_BUDGET + 2
    rebuild = served.with_points(ov.mutated_points())
    ref_i, ref_d = rebuild.query(queries, 10)
    np.testing.assert_array_equal(got_i, ref_i)
    np.testing.assert_array_equal(got_d, ref_d)
    assert got_i.dtype == np.int32 and got_d.dtype == np.float32
    assert ov.stats.resolved_rows > 0 and ov.stats.delta_launches > 0
    ov.compact()
    assert ov.mutations_pending == 0 and ov.stats.compactions == 1
    got2_i, got2_d = ov.query(queries, 10)
    np.testing.assert_array_equal(got2_i, ref_i)
    np.testing.assert_array_equal(got2_d, ref_d)


def test_overlay_compaction_threshold_triggers(served):
    ov = DeltaOverlay(served, compact_threshold=16)
    ov.insert(_inserts(3, 15))
    assert ov.stats.compactions == 0 and ov.mutations_pending == 15
    ov.delete(np.array([7]))
    assert ov.stats.compactions == 1 and ov.mutations_pending == 0
    assert ov.n_points == 10_014 and ov.base.grid.n_points == 10_014
    assert ov.base is not served and ov.base.device == served.device


@pytest.mark.parametrize("deleted,inserted", [
    ([0, 1, 2, 3], 0), ([0, 1, 2, 3, 4, 5], 0), ([1, 3], 3),
    ([0, 1, 2, 3, 4, 5], 2)])
def test_overlay_degraded_small_cloud(deleted, inserted):
    """Fewer than k alive points: the -1/inf pad contract equals the
    rebuild's, through the far pads of the alive set and the delta."""
    p = pt.KnnProblem.prepare(generate_uniform(6, seed=2),
                              pt.KnnConfig(k=5), device="cpu")
    ov = DeltaOverlay(p, compact_threshold=10 ** 6)
    ov.delete(np.array(deleted))
    ov.insert(_inserts(9, inserted))
    queries = generate_uniform(7, seed=3)
    got_i, got_d = ov.query(queries, 5)
    ref_i, ref_d = p.with_points(ov.mutated_points()).query(queries, 5)
    np.testing.assert_array_equal(got_i, ref_i)
    np.testing.assert_array_equal(got_d, ref_d)
    alive = 6 - len(deleted) + inserted
    assert (got_i[:, alive:] == -1).all() and np.isinf(got_d[:, alive:]).all()
    assert (got_i[:, :alive] >= 0).all()


@pytest.mark.parametrize("near", [0, 2])
def test_overlay_dirty_cell_pruning(served, near):
    """A far-corner insert is pruned by the dirty-cell bound: with nothing
    near the queries the delta call is skipped; with two inserts among them
    only those two rows are scored (the CSR gathers surviving cells)."""
    ov = DeltaOverlay(served, compact_threshold=10 ** 6)
    ov.insert(np.full((32, 3), 995.0, np.float32))
    if near:
        ov.insert(np.full((near, 3), 20.0, np.float32))
    queries = (np.random.default_rng(9).random((64, 3)) * 40.0
               ).astype(np.float32)
    got_i, got_d = ov.query(queries, 4)
    assert ov.stats.delta_skips == (0 if near else 1)
    assert ov.stats.delta_launches == (1 if near else 0)
    assert ov.stats.delta_candidates == near
    ref_i, ref_d = served.with_points(ov.mutated_points()).query(queries, 4)
    np.testing.assert_array_equal(got_i, ref_i)
    np.testing.assert_array_equal(got_d, ref_d)


def test_insert_preserves_alive_caches(served):
    ov = DeltaOverlay(served, compact_threshold=10 ** 6)
    ov.delete(np.array([5]))
    ov.query(served.host_points[[5]] + np.float32(0.25), 4)  # row hits 5
    cache, o2n = ov._alive_cache, ov._old2new
    assert cache is not None and o2n is not None
    assert cache[0].device == served.device
    ov.insert(np.full((2, 3), 500.0, np.float32))
    assert ov._alive_cache is cache and ov._old2new is o2n
    ov.delete(np.array([0]))
    assert ov._alive_cache is None and ov._old2new is None


def test_mutation_is_barrier(served):
    """Queries pending at a mutation's arrival flush first and answer
    against the cloud before it."""
    daemon = _daemon(served, max_delay_s=100.0)
    daemon.submit(1, "query", generate_uniform(4, seed=14))
    n_before = daemon.overlay.n_points
    out = daemon.submit(2, "insert", _inserts(5, 6))
    assert [r.req_id for r in out] == [1, 2]
    assert out[0].ok and out[1].ok and out[1].n_points == n_before + 6
    assert daemon.batcher.flushes["barrier"] == 1
    assert (out[0].ids < n_before).all()


def test_per_request_k_truncates(served):
    daemon = _daemon(served)
    queries = generate_uniform(5, seed=15)
    full = daemon.submit(1, "query", queries) + daemon.drain()
    small = daemon.submit(2, "query", queries, k=3) + daemon.drain()
    assert full[0].ids.shape == (5, 10) and small[0].ids.shape == (5, 3)
    np.testing.assert_array_equal(small[0].ids, full[0].ids[:, :3])
    np.testing.assert_array_equal(small[0].d2, full[0].d2[:, :3])
    ref_i, ref_d = served.query(queries)
    np.testing.assert_array_equal(full[0].ids, ref_i)
    np.testing.assert_array_equal(full[0].d2, ref_d)


@pytest.mark.parametrize("spec,kind", [("batch:0", "crash"),
                                       ("batch:0:oom", "oom"),
                                       ("batch:1:oom", "oom")])
def test_batch_fault_contained_typed(served, monkeypatch, spec, kind):
    monkeypatch.setenv("KNTPU_SERVE_FAULT", spec)
    daemon = _daemon(served)
    queries = generate_uniform(8, seed=11)
    out = []
    for i in range(3):
        out += daemon.submit(i, "query", queries) + daemon.drain()
    bad = int(spec.split(":")[1])
    assert [r.ok for r in out] == [i != bad for i in range(3)]
    assert out[bad].failure_kind == kind and kind in FAILURE_KINDS
    assert daemon.failure_kinds == {kind: 1} and daemon.failed_batches == 1
    assert out[bad].to_wire()["failure_kind"] == kind
    assert all(r.ids.shape == (8, 10) for r in out if r.ok)


def test_refusal_typed_and_isolated(served):
    daemon = _daemon(served)
    good = generate_uniform(4, seed=13)
    daemon.submit(1, "query", good)
    refusals = daemon.submit(2, "query", np.full((3, 3), -42.0, np.float32))
    assert len(refusals) == 1 and not refusals[0].ok
    assert refusals[0].failure_kind == "invalid-input"
    assert "domain" in refusals[0].error.lower()
    assert daemon.refused == 1
    done = daemon.drain()
    assert len(done) == 1 and done[0].ok and done[0].req_id == 1


def test_mutation_apply_failure_contained(served, monkeypatch):
    daemon = _daemon(served)

    def boom(points):
        raise RuntimeError("synthetic re-prepare death")

    monkeypatch.setattr(daemon.overlay, "insert", boom)
    out = daemon.submit(1, "insert", _inserts(30, 2))
    assert len(out) == 1 and not out[0].ok
    assert out[0].failure_kind == "crash" and daemon.failed_mutations == 1
    ok = daemon.submit(2, "query", generate_uniform(3, seed=31)) \
        + daemon.drain()
    assert ok[-1].ok and ok[-1].ids.shape == (3, 10)
    deleted = daemon.submit(3, "delete", np.array([0, 9]))
    assert deleted[0].ok and deleted[0].n_points == 9_998


def test_fof_request_memo_and_labels(served):
    """A fof request labels the current mutated cloud (equal to
    ``fof_labels`` on it), a repeat without a mutation is a memo hit, a
    mutation invalidates the memo."""
    daemon = _daemon(served)
    first = daemon.submit(1, "fof", FOF_B)
    again = daemon.submit(2, "fof", FOF_B)
    assert first[0].ok and daemon.fof_memo_hits == 1
    assert again[0].labels is first[0].labels
    daemon.submit(3, "insert", _inserts(33, 8))
    third = daemon.submit(4, "fof", FOF_B)
    assert daemon.fof_memo_hits == 1 and third[0].n_points == 10_008
    want = fof_labels(daemon.overlay.mutated_points(), FOF_B, device="cpu")
    np.testing.assert_array_equal(third[0].labels, want.labels)
    assert third[0].n_clusters == want.n_clusters
    wire = json.loads(json.dumps(third[0].to_wire()))
    assert len(wire["labels"]) == 10_008
    refused = daemon.submit(5, "fof", -3.0)
    assert refused[0].failure_kind == "invalid-input"


def test_fof_refusal_is_a_typed_oom_and_serving_goes_on(served, monkeypatch):
    """A fof request the FoF preflight refuses (``LaunchBudgetError``)
    comes back as one typed oom failure; the next query batch is
    served."""
    from cuda_knearests_tpu_torch.cluster import fof

    monkeypatch.setattr(fof, "MAX_PAIR_SLOTS", 1 << 10)
    daemon = _daemon(served)
    out = daemon.submit(1, "fof", FOF_B)
    assert not out[0].ok and out[0].failure_kind == "oom"
    assert daemon.failure_kinds == {"oom": 1}
    nxt = daemon.submit(2, "query", generate_uniform(3, seed=2)) \
        + daemon.drain()
    assert nxt[0].ok


def test_wire_is_strict_json():
    r = Response(req_id=7, ok=True, ids=np.array([[3, -1]], np.int32),
                 d2=np.array([[1.5, np.inf]], np.float32), trace_id="t",
                 queue_ms=1.0, dispatch_ms=0.5, device_ms=2.0)
    text = json.dumps(r.to_wire())
    assert "Infinity" not in text

    def _reject(tok):
        raise AssertionError(f"non-RFC token on the wire: {tok}")

    wire = json.loads(text, parse_constant=_reject)
    assert wire["d2"] == [[1.5, None]] and wire["ids"] == [[3, -1]]
    assert wire["trace_id"] == "t" and wire["timing"]["device_ms"] == 2.0
    bad = Response(req_id=8, ok=False, error="e", failure_kind="oom")
    assert bad.to_wire() == {"id": 8, "ok": False, "error": "e",
                             "failure_kind": "oom"}


def test_steady_state_zero_recompiles(served):
    """After warmup a whole open-loop session builds and loads no kernel
    library; on the CPU the plain versions run, so no class kernel is
    launched either."""
    daemon = ServeDaemon(served, ServeConfig(max_batch=32,
                                             max_delay_s=0.003))
    summary = run_session(daemon, LoadSpec(rate=600.0, requests=30, seed=6,
                                           batch_mix=SMALL_MIX))
    assert summary["batches"] >= 1 and summary["recompiles"] == 0
    assert summary["failed_requests"] == 0 and summary["refused"] == 0
    assert summary["kernel_route"] == "plain"
    assert summary["kernel_launches"] == summary["kernel_builds"] == \
        summary["kernel_loads"] == 0
    assert summary["completed_queries"] > 0 and summary["sustained_qps"] > 0
    assert summary["p50_ms"] is not None and summary["p99_ms"] is not None
    assert summary["host_syncs"] >= summary["batches"]
    assert not any(key.startswith("exec_cache") for key in summary)
    json.dumps(summary)


def test_recompiles_count_builds_and_loads_in_the_window(served,
                                                         monkeypatch):
    """A session's recompiles are the kernel builds plus library loads
    inside its window: one of each during the session counts 2."""
    daemon = _daemon(served, max_delay_s=0.003)
    query = daemon.overlay.query

    def building_query(queries, k):
        if not getattr(building_query, "done", False):
            building_query.done = True
            _build.builds += 1
            _build.loads += 1
        return query(queries, k)

    monkeypatch.setattr(daemon.overlay, "query", building_query)
    monkeypatch.setattr(_build, "builds", _build.builds)
    monkeypatch.setattr(_build, "loads", _build.loads)
    summary = run_session(daemon, LoadSpec(rate=600.0, requests=10, seed=7))
    assert summary["recompiles"] == 2
    assert summary["kernel_builds"] == summary["kernel_loads"] == 1


def test_build_counters_count_builds_and_loads(tmp_path, monkeypatch):
    """``ops/_build`` counts an nvcc build that succeeded and a library
    load once each, and neither on a cached call: the two halves of a
    window's recompiles.  nvcc is stood in for by a script that copies a
    loadable shared library to the ``-o`` path."""
    import _ctypes

    fake = tmp_path / "nvcc.py"
    fake.write_text(
        "import shutil, sys\n"
        "argv = sys.argv\n"
        f"shutil.copy({_ctypes.__file__!r}, argv[argv.index('-o') + 1])\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!/bin/sh\nexec {sys.executable} {fake} \"$@\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "builds", 0)
    monkeypatch.setattr(_build, "loads", 0)
    before = dispatch.kernel_stats()
    _build.load_all(["supercell_topk", "blocked_topk"])
    assert (_build.builds, _build.loads) == (2, 2)
    _build.load("supercell_topk")                     # cached: no count
    assert (_build.builds, _build.loads) == (2, 2)
    monkeypatch.setattr(_build, "_LIBS", {})          # a new process
    _build.load("blocked_topk")                       # built: load only
    after = dispatch.kernel_stats()
    assert after["kernel_builds"] - before["kernel_builds"] == 2
    assert after["kernel_loads"] - before["kernel_loads"] == 3


def test_mutating_session_end_to_end(served):
    daemon = ServeDaemon(served, ServeConfig(max_batch=32, max_delay_s=0.002,
                                             compact_threshold=48))
    summary = run_session(daemon, LoadSpec(rate=500.0, requests=30,
                                           mutation_ratio=0.4, seed=10,
                                           batch_mix=SMALL_MIX))
    assert summary["responses"] == summary["requests"]
    assert summary["failed_requests"] == 0 and summary["refused"] == 0
    assert summary["recompiles"] == 0 and summary["overlay_compactions"] >= 1
    net = summary["overlay_inserts"] - summary["overlay_deletes"]
    assert summary["n_points"] == 10_000 + net
    snap = daemon.metrics_snapshot()
    assert snap["serve"]["batches"] == summary["batches"]
    assert snap["kernels"]["kernel_launches"] >= 0


def _serve_cmd(*args):
    return [sys.executable, "-m", "cuda_knearests_tpu_torch.serve",
            "--device", "cpu", *args]


def test_stdio_daemon_roundtrip():
    reqs = [
        {"id": 1, "op": "query",
         "data": generate_uniform(3, seed=21).tolist(), "k": 4},
        {"id": 2, "op": "insert", "data": generate_uniform(2, seed=22).tolist()},
        {"id": 3, "op": "delete", "data": [0, 5]},
        {"id": 4, "op": "query", "data": [[-1.0, 0.0, 0.0]]},
        {"id": 5, "op": "fof", "data": 60.0},
        {"id": 6, "op": "metrics"},
    ]
    payload = "\n".join(json.dumps(r) for r in reqs) + "\nnot json\n"
    proc = subprocess.run(
        _serve_cmd("--points", "uniform:600", "--k", "6",
                   "--max-delay-ms", "1", "--max-batch", "16"),
        input=payload, capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.strip()]
    by_id = {ln["id"]: ln for ln in lines}
    assert by_id[1]["ok"] and len(by_id[1]["ids"]) == 3
    assert len(by_id[1]["ids"][0]) == 4
    assert by_id[2]["ok"] and by_id[2]["n_points"] == 602
    assert by_id[3]["ok"] and by_id[3]["n_points"] == 600
    assert not by_id[4]["ok"] and by_id[4]["failure_kind"] == "invalid-input"
    assert by_id[5]["ok"] and len(by_id[5]["labels"]) == 600
    assert by_id[6]["metrics"]["serve"]["kernel_route"] == "plain"
    assert by_id[None]["failure_kind"] == "invalid-input"


def test_stdio_burst_on_held_open_pipe():
    """Requests written in one burst on a pipe that stays open are all
    answered without the client closing stdin."""
    reqs = [{"id": i, "op": "query",
             "data": generate_uniform(2, seed=40 + i).tolist(), "k": 4}
            for i in range(3)]
    proc = subprocess.Popen(
        _serve_cmd("--points", "uniform:500", "--k", "4",
                   "--max-delay-ms", "2", "--max-batch", "16"),
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=ROOT)
    try:
        proc.stdin.write("".join(json.dumps(r) + "\n" for r in reqs))
        proc.stdin.flush()
        got, buf = {}, b""
        fd = proc.stdout.fileno()
        t0 = time.monotonic()
        while len(got) < 3 and time.monotonic() - t0 < 180.0:
            while b"\n" in buf:
                raw, buf = buf.split(b"\n", 1)
                if raw.strip():
                    r = json.loads(raw)
                    got[r["id"]] = r
            if len(got) >= 3:
                break
            if select.select([fd], [], [], 1.0)[0]:
                chunk = os.read(fd, 1 << 16)
                if not chunk:
                    break
                buf += chunk
        assert sorted(got) == [0, 1, 2], \
            f"only {sorted(got)} answered before stdin closed"
        assert all(r["ok"] for r in got.values())
    finally:
        proc.stdin.close()
        proc.wait(timeout=60)
    assert proc.returncode == 0


def test_loadgen_cli_assert_steady(tmp_path):
    metrics_path = tmp_path / "m.jsonl"
    proc = subprocess.run(
        _serve_cmd("--points", "uniform:10000", "--k", "10", "--loadgen",
                   "--requests", "40", "--assert-steady", "--max-batch",
                   "64", "--metrics-jsonl", str(metrics_path)),
        capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]
    summary = json.loads(proc.stdout.splitlines()[-1])
    assert summary["recompiles"] == 0 and summary["batches"] >= 1
    assert summary["kernel_route"] == "plain"
    snap = json.loads(metrics_path.read_text().splitlines()[-1])
    assert snap["serve"]["batches"] == summary["batches"]


@pytest.mark.parametrize("argv,rc", [
    (["--points", "uniform:50", "--loadgen"], 4),                # no GPU
    (["--points", "uniform:50", "--device", "cpu", "--k", "0",
      "--loadgen"], 5),                                          # k
    (["--points", "no-such-dataset.xyz", "--device", "cpu"], None),
])
def test_cli_refusals(argv, rc, capsys, monkeypatch):
    """No CUDA device and no --device refuses with the device-fault code
    (4); an illegal k with the input-contract code (5); an unknown dataset
    raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if rc is None:
        with pytest.raises(FileNotFoundError):
            serve_main.main(argv)
        return
    got = serve_main.main(argv)
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert got == rc
    assert out["failure_kind"] == ("no-device" if rc == 4
                                   else "invalid-input")
