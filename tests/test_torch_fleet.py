"""The serving fleet of the PyTorch port against the JAX package's, on the CPU.

The same numpy inputs go through both packages' ``serve/fleet``: the JAX
fleet as ``tests/test_fleet.py`` runs it, the port's with ``device='cpu'``
(the kernels' plain versions).  The host pieces must equal JAX's output
for output: the SLO classes, ``ServeFleetConfig`` validation and
``serve_config_for``, the token bucket's decisions and retry hints, the
DRR scheduler's order and accounting, ``jain_index``,
``build_fleet_schedule`` and the replication log.  One seeded session
(two dense tenants, one replicated and one metered, a sidecar tenant,
mutations, typed refusals) driven by the same fake clock through both
front doors must give the same response sequence: req_id, ok, tenant,
degraded, failure_kind and retry hint equal, the tenants' clouds equal
after every call, and query rows tie-aware equal with d2 within RTOL 1e-4
/ ATOL 1e-2 (``fuzz/compare.check_route_result``: XLA's CPU backend
contracts multiply-adds, torch rounds each operation).  Then the port's
own laws: sidecar rows exact, in-process failover with zero lost
mutations and answers byte-identical to a rebuild, the pod rung, one
process-level failover drill with CPU children, the CLI, and the
observability pieces that came with the fleet (``obs.export``,
``dispatch.trace_sites`` and the byte counters, ``utils.stopwatch``).
"""

import dataclasses
import json
import os
from collections import deque

import numpy as np
import pytest
import torch

from cuda_knearests_tpu.config import SLO_CLASSES as J_SLO_CLASSES
from cuda_knearests_tpu.config import ServeFleetConfig as JFleetConfig
from cuda_knearests_tpu.obs import export as jexport
from cuda_knearests_tpu.serve.daemon import Response as JResponse
from cuda_knearests_tpu.serve.fleet import DrrScheduler as JDrr
from cuda_knearests_tpu.serve.fleet import FleetDaemon as JFleet
from cuda_knearests_tpu.serve.fleet import ReplicationLog as JLog
from cuda_knearests_tpu.serve.fleet import TenantLoad as JTenantLoad
from cuda_knearests_tpu.serve.fleet import TenantSpec as JTenantSpec
from cuda_knearests_tpu.serve.fleet import TokenBucket as JBucket
from cuda_knearests_tpu.serve.fleet import build_fleet_schedule as jschedule
from cuda_knearests_tpu.serve.fleet import jain_index as jjain
from cuda_knearests_tpu.utils.memory import \
    InvalidConfigError as JInvalidConfigError
import cuda_knearests_tpu_torch as pt
from cuda_knearests_tpu_torch import obs
from cuda_knearests_tpu_torch.config import SLO_CLASSES, ServeFleetConfig
from cuda_knearests_tpu_torch.fuzz.compare import check_route_result
from cuda_knearests_tpu_torch.io import generate_uniform
from cuda_knearests_tpu_torch.obs import export, spans
from cuda_knearests_tpu_torch.runtime import dispatch
from cuda_knearests_tpu_torch.serve.daemon import Response
from cuda_knearests_tpu_torch.serve.fleet import (CpuSidecar, DrrScheduler,
                                                  FleetDaemon, Replica,
                                                  ReplicationLog, TenantLoad,
                                                  TenantSpec, TokenBucket,
                                                  build_fleet_schedule,
                                                  failover_drill, jain_index)
from cuda_knearests_tpu_torch.serve.fleet import __main__ as fleet_main
from cuda_knearests_tpu_torch.serve.fleet.replica import DeltaRecord
from cuda_knearests_tpu_torch.utils import memory, stopwatch
from cuda_knearests_tpu_torch.utils.memory import NoDeviceError

K = 8
CFG_KW = dict(min_bucket=8, max_batch=64, compact_threshold=64,
              warmup=False, sidecar_threshold=192, drr_quantum=16)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """The legacy query's plain class kernel is many small torch ops over
    the whole pack; beside other test processes torch's thread pool
    oversubscribes the cores, so this module runs torch on two threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# -- host pieces against JAX ----------------------------------------------------

def _fields(obj) -> dict:
    return dataclasses.asdict(obj)


def test_slo_classes_equal_jax():
    assert set(SLO_CLASSES) == set(J_SLO_CLASSES)
    for name, cls in SLO_CLASSES.items():
        assert _fields(cls) == _fields(J_SLO_CLASSES[name])


FLEET_CONFIGS = [
    {}, dict(min_bucket=16, max_batch=64), dict(min_bucket=0),
    dict(min_bucket=32, max_batch=16), dict(sidecar_threshold=-1),
    dict(drr_quantum=0), dict(quota_qps=0.0), dict(quota_qps=50.0),
    dict(pod_threshold=192), dict(pod_threshold=5000), dict(pod_shards=0),
    dict(pod_skew_threshold=1.0), dict(max_batch=100, min_bucket=5),
]


@pytest.mark.parametrize("kw", FLEET_CONFIGS, ids=str)
def test_fleet_config_equal_jax(kw):
    """Validation raises the same type and message; a valid config gives
    every SLO class the same per-tenant ServeConfig."""
    try:
        want = JFleetConfig(**kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            ServeFleetConfig(**kw)
        assert str(got.value) == str(e)
        return
    cfg = ServeFleetConfig(**kw)
    assert _fields(cfg) == _fields(want)
    for name in SLO_CLASSES:
        for k in (None, 4):
            got = cfg.serve_config_for(SLO_CLASSES[name], k)
            ref = want.serve_config_for(J_SLO_CLASSES[name], k)
            assert _fields(got) == _fields(ref)
            assert got.buckets() == ref.buckets()


@pytest.mark.parametrize("kw", [
    dict(name="x", slo="gold"), dict(name="x", ship_mode="eager"),
    dict(name="x", k=0), dict(name="x", k=3, slo="latency", replicas=2)])
def test_tenant_spec_equal_jax(kw):
    try:
        want = JTenantSpec(**kw)
    except JInvalidConfigError as e:
        with pytest.raises(memory.InvalidConfigError) as got:
            TenantSpec(**kw)
        assert str(got.value) == str(e)
        return
    spec = TenantSpec(**kw)
    assert spec.to_json() == want.to_json()
    assert TenantSpec.from_json(spec.to_json()) == spec


def test_token_bucket_equal_jax():
    """A seeded stream of (rows, time) requests: the same admissions,
    refusals, retry hints and counters in both packages, metered and
    unmetered."""
    rng = np.random.default_rng(3)
    for rate, burst in ((40.0, 64.0), (None, 16.0), (500.0, 8.0)):
        got, want = TokenBucket(rate, burst, now=0.5), JBucket(rate, burst,
                                                               now=0.5)
        now = 0.5
        for _ in range(300):
            now += float(rng.exponential(0.01))
            rows = int(rng.integers(1, 40))
            assert got.try_take(rows, now) == want.try_take(rows, now)
            assert got.retry_after_s(rows, now) == want.retry_after_s(rows,
                                                                      now)
        assert got.stats_dict() == want.stats_dict()


class _B:
    """A batch stand-in: DRR reads only ``.total``."""

    def __init__(self, total):
        self.total = total


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drr_equal_jax(seed):
    """Seeded backlogs over four tenants, drained in several rounds: the
    same execution order, deficits and backlog stamps, and the same
    fairness index over the served rows."""
    rng = np.random.default_rng(seed)
    names = ["t0", "t1", "t2", "t3"]
    got, want = DrrScheduler(16), JDrr(16)
    for n in names:
        got.register(n)
        want.register(n)
    for _ in range(4):
        sizes = {n: [int(s) for s in rng.choice([1, 8, 16, 64, 256],
                                                size=rng.integers(0, 6))]
                 for n in names}
        g = got.select({n: deque(_B(s) for s in v) for n, v in sizes.items()})
        w = want.select({n: deque(_B(s) for s in v)
                         for n, v in sizes.items()})
        assert [(n, b.total, _fields(d)) for n, b, d in g] == \
            [(n, b.total, dataclasses.asdict(d)) for n, b, d in w]
    assert got.stats_dict() == want.stats_dict()
    rows = list(got.served_rows.values())
    assert jain_index(rows) == jjain(rows)
    for vals in ([], [0, 0], [5], [1.0, None, 3.0], [10, 10, 10, 0]):
        assert jain_index(vals) == jjain(vals)


def _loads(pkg_load):
    return [
        pkg_load(tenant="a", rate=300.0, requests=30, mutation_ratio=0.2,
                 seed=1),
        pkg_load(tenant="b", rate=600.0, requests=36, mutation_ratio=0.15,
                 hotspot=(0.0, 0.2), seed=2, k=5),
        pkg_load(tenant="s", rate=200.0, requests=10, seed=3),
    ]


@pytest.mark.parametrize("diurnal", [None, 4.0])
def test_fleet_schedule_equal_jax(diurnal):
    sizes = {"a": 1500, "b": 2000, "s": 48}
    got = build_fleet_schedule(
        [dataclasses.replace(ld, diurnal=diurnal) for ld in _loads(TenantLoad)],
        sizes)
    want = jschedule(
        [dataclasses.replace(ld, diurnal=diurnal)
         for ld in _loads(JTenantLoad)], sizes)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g["t"], g["tenant"], g["kind"], g.get("k")) == \
            (w["t"], w["tenant"], w["kind"], w.get("k"))
        np.testing.assert_array_equal(g["payload"], w["payload"])
        assert g["payload"].dtype == w["payload"].dtype


def test_replication_log_equal_jax():
    rng = np.random.default_rng(5)
    got, want = ReplicationLog(), JLog()
    for i in range(12):
        if i % 3 == 2:
            payload = np.sort(rng.choice(100, 3, replace=False))
            kind = "delete"
        else:
            payload = rng.random((2, 3)).astype(np.float32)
            kind = "insert"
        g, w = got.append(kind, payload), want.append(kind, payload)
        assert (g.seq, g.kind) == (w.seq, w.kind)
        assert DeltaRecord.from_json(g.to_json()).seq == g.seq
        assert g.to_json() == w.to_json()
    assert got.compact(5) == want.compact(5) == 5
    assert got.compact(3) == want.compact(3) == 0
    assert [r.seq for r in got.since(7)] == [r.seq for r in want.since(7)]
    with pytest.raises(RuntimeError, match="compacted past seq 2"):
        got.since(2)
    assert got.committed_seq == want.committed_seq == 12


def test_replica_refuses_sequence_gap():
    p = pt.KnnProblem.prepare(generate_uniform(300, seed=4),
                              pt.KnnConfig(k=4, adaptive=False),
                              device="cpu")
    rep = Replica(p, compact_threshold=64)
    pts = np.full((2, 3), 123.0, np.float32)
    assert rep.apply(DeltaRecord(seq=1, kind="insert", payload=pts)) == 1
    for seq in (3, 1):
        with pytest.raises(RuntimeError, match="sequence gap"):
            rep.apply(DeltaRecord(seq=seq, kind="insert", payload=pts))


@pytest.mark.parametrize("fields", [
    dict(tenant="acme"), dict(tenant="acme", degraded="bf16"),
    dict(ok=False, error="shed", failure_kind="invalid-input",
         tenant="b", retry_after_ms=12.5)])
def test_response_wire_equal_jax(fields):
    kw = dict(req_id=1, ok=True, ids=np.zeros((1, 2), np.int32),
              d2=np.array([[0.5, np.inf]], np.float32))
    kw.update(fields)
    assert Response(**kw).to_wire() == JResponse(**kw).to_wire()


# -- one session through both front doors ---------------------------------------

def _builds(spec_cls):
    return [
        (spec_cls(name="a", k=K, slo="latency", replicas=1),
         generate_uniform(1500, seed=21)),
        (spec_cls(name="b", k=K, slo="throughput", quota_qps=2000.0,
                  quota_burst=96.0), generate_uniform(2000, seed=22)),
        (spec_cls(name="s", k=K, slo="latency"),
         generate_uniform(48, seed=23)),
    ]


def _stream():
    """The seeded schedule plus typed refusals: an unknown tenant, a k
    above the tenant's, a malformed payload, an out-of-range delete, and
    a FoF request on the sidecar tenant."""
    items = build_fleet_schedule(
        _loads(TenantLoad), {"a": 1500, "b": 2000, "s": 48})
    t_end = items[-1]["t"]
    bad = [
        {"t": 0.011, "tenant": "nobody", "kind": "query",
         "payload": generate_uniform(2, seed=1)},
        {"t": 0.021, "tenant": "a", "kind": "query",
         "payload": generate_uniform(2, seed=2), "k": K + 3},
        {"t": 0.031, "tenant": "b", "kind": "query",
         "payload": np.full((2, 3), np.nan, np.float32)},
        {"t": 0.041, "tenant": "a", "kind": "delete",
         "payload": np.array([10 ** 6])},
        {"t": t_end / 2, "tenant": "s", "kind": "fof", "payload": 150.0},
    ]
    return sorted(items + bad, key=lambda it: it["t"])


def _drive(fleet, clock, items):
    """Submit every item at its time (a deadline poll first), drain at
    the end; returns [(response, the tenants' clouds before the call)]."""
    out = []

    def clouds():
        return {n: t.mutated_points().copy()
                for n, t in fleet.tenants.items()}

    for rid, it in enumerate(items, start=1):
        clock.t = it["t"]
        before = clouds()
        out += [(r, before) for r in fleet.poll(it["t"])]
        before = clouds()
        out += [(r, before) for r in fleet.submit(
            rid, it["tenant"], it["kind"], it["payload"], k=it.get("k"),
            now=it["t"], trace_id=f"r{rid}")]
    clock.t = items[-1]["t"] + 1.0
    before = clouds()
    out += [(r, before) for r in fleet.drain(clock.t)]
    return out


@pytest.fixture(scope="module")
def session():
    items = _stream()
    pclock, jclock = FakeClock(), FakeClock()
    pfleet = FleetDaemon(_builds(TenantSpec), ServeFleetConfig(**CFG_KW),
                         clock=pclock, device="cpu")
    jfleet = JFleet(_builds(JTenantSpec), JFleetConfig(**CFG_KW),
                    clock=jclock)
    return (items, pfleet, _drive(pfleet, pclock, items), jfleet,
            _drive(jfleet, jclock, items))


def _key(r):
    return (r.req_id, r.ok, r.tenant, r.degraded, r.failure_kind,
            r.retry_after_ms, r.n_points)


def test_session_responses_equal_jax(session):
    items, _pf, got, _jf, want = session
    assert [_key(r) for r, _ in got] == [_key(r) for r, _ in want]
    kinds = {r.failure_kind for r, _ in got if not r.ok}
    assert kinds == {"invalid-input"}
    assert sum(not r.ok for r, _ in got) >= 5       # the typed refusals
    assert any(r.retry_after_ms for r, _ in got)    # b's metered refusals
    assert sum(r.ids is not None for r, _ in got) >= 40


def test_session_rows_tie_aware_equal_jax(session):
    items, _pf, got, _jf, want = session
    for (g, before), (w, jbefore) in zip(got, want):
        for name in before:
            np.testing.assert_array_equal(before[name], jbefore[name])
        if g.ids is None:
            if g.labels is not None:
                np.testing.assert_array_equal(g.labels, w.labels)
            continue
        q = items[g.req_id - 1]["payload"]
        k = g.ids.shape[1]
        bad = check_route_result(before[g.tenant], q, g.ids, g.d2,
                                 np.asarray(w.d2), k)
        assert bad is None, (g.req_id, bad.render())


def test_session_state_equal_jax(session):
    _items, pfleet, _got, jfleet, _want = session
    assert pfleet.n_batches == jfleet.n_batches
    assert list(pfleet.batch_log) == list(jfleet.batch_log)
    assert pfleet.served_rows == jfleet.served_rows
    assert pfleet.refused == jfleet.refused
    ps, js = pfleet.stats_dict(), jfleet.stats_dict()
    for key in ("fleet_batches", "drr_quantum", "drr_dispatches",
                "served_rows"):
        assert ps[key] == js[key]
    for name in pfleet.tenants:
        pt_, jt = ps["tenants"][name], js["tenants"][name]
        for key in ("slo", "k", "n_points", "replicas", "committed_seq",
                    "sidecar", "quota_refusals", "admitted_rows", "refused",
                    "served_rows"):
            assert pt_.get(key) == jt.get(key), (name, key)
    rep = pfleet.tenants["a"].replica_pool[0]
    assert rep.applied_seq == pfleet.tenants["a"].log.committed_seq > 0


def test_sidecar_rows_exact(session):
    """The sidecar tenant answers from the host: rows equal an f32
    brute force with the lower id first on ties, and equal JAX's."""
    items, pfleet, got, _jf, want = session
    assert pfleet.tenants["s"].is_sidecar
    served = 0
    for (g, before), (w, _) in zip(got, want):
        if g.tenant != "s" or g.ids is None:
            continue
        q = items[g.req_id - 1]["payload"]
        diff = q[:, None, :] - before["s"][None, :, :]
        dd = (diff * diff).sum(axis=2)
        order = np.argsort(dd, axis=1, kind="stable")[:, :g.ids.shape[1]]
        np.testing.assert_array_equal(g.ids, order)
        np.testing.assert_array_equal(
            g.d2, np.take_along_axis(dd, order, axis=1))
        np.testing.assert_array_equal(g.ids, w.ids)
        served += 1
    assert served > 0
    small = CpuSidecar(generate_uniform(3, seed=2), k=5)
    ids, d2 = small.query(generate_uniform(2, seed=3), 5)
    assert (ids[:, 3:] == -1).all() and np.isinf(d2[:, 3:]).all()


@pytest.mark.parametrize("ship_mode", ["sync", "lazy"])
def test_in_process_failover_byte_identical(ship_mode):
    """Mutations commit through the log, the primary overlay is dropped,
    the promoted replica holds the committed cloud (zero lost) and
    answers byte-identically to a rebuild of it, and as JAX's does."""
    pts0 = generate_uniform(1500, seed=51)
    cfg = dict(CFG_KW, compact_threshold=512)
    fleets = [
        FleetDaemon([(TenantSpec(name="r", k=6, replicas=1,
                                 ship_mode=ship_mode), pts0)],
                    ServeFleetConfig(**cfg), device="cpu"),
        JFleet([(JTenantSpec(name="r", k=6, replicas=1,
                             ship_mode=ship_mode), pts0)],
               JFleetConfig(**cfg))]
    ins = generate_uniform(5, seed=52)
    info = []
    for fleet in fleets:
        [r1] = fleet.submit(1, "r", "insert", ins, now=0.001)
        [r2] = fleet.submit(2, "r", "delete", np.asarray([3, 7, 11]),
                            now=0.002)
        assert r1.ok and r2.ok
        applied = fleet.tenants["r"].replica_pool[0].applied_seq
        assert applied == (2 if ship_mode == "sync" else 0)
        info.append(fleet.failover("r"))
    assert info[0] == info[1]
    assert info[0]["replayed"] == (0 if ship_mode == "sync" else 2)
    expected = np.delete(np.concatenate([pts0, ins]), [3, 7, 11], axis=0)
    t = fleets[0].tenants["r"]
    np.testing.assert_array_equal(t.daemon.overlay.mutated_points(),
                                  expected)
    probe = generate_uniform(6, seed=53)
    got = fleets[0].submit(3, "r", "query", probe, now=0.003)
    got += fleets[0].drain(0.01)
    want = fleets[1].submit(3, "r", "query", probe, now=0.003)
    want += fleets[1].drain(0.01)
    oracle = pt.KnnProblem.prepare(expected,
                                   pt.KnnConfig(k=6, adaptive=False),
                                   device="cpu")
    ref_i, ref_d = oracle.query(probe, 6)
    np.testing.assert_array_equal(got[0].ids, ref_i)
    np.testing.assert_array_equal(got[0].d2, ref_d)
    assert check_route_result(expected, probe, got[0].ids, got[0].d2,
                              np.asarray(want[0].d2), 6) is None
    with pytest.raises(memory.TransportError):
        fleets[0].failover("r")          # the pool is empty now


POD_KW = dict(min_bucket=8, max_batch=64, compact_threshold=64,
              warmup=False, sidecar_threshold=48, pod_threshold=200,
              pod_shards=2, pod_skew_threshold=3.0)


def test_pod_tenant_and_promotion():
    """A tenant over ``pod_threshold`` serves from the elastic index
    (answers byte-identical to its rebuild oracle, fof refused typed); a
    dense tenant that grows past it is promoted and keeps its log."""
    fleet = FleetDaemon(
        [(TenantSpec(name="p0", k=6), generate_uniform(260, seed=11)),
         (TenantSpec(name="g", k=4, replicas=1),
          generate_uniform(190, seed=2))],
        ServeFleetConfig(**POD_KW), device="cpu")
    p0, g = fleet.tenants["p0"], fleet.tenants["g"]
    assert p0.is_pod and p0.log is not None and not g.is_pod
    rng = np.random.default_rng(3)
    for i in range(4):
        pts = (rng.random((6, 3)) * 110.0 + 5.0).astype(np.float32)
        [r] = fleet.submit(i, "p0", "insert", pts, now=0.001 * (i + 1))
        assert r.ok, r.error
    assert p0.log.committed_seq == 4
    q = (rng.random((12, 3)) * 980.0 + 10.0).astype(np.float32)
    [r] = fleet.submit(10, "p0", "query", q, now=0.01)
    o_i, o_d = p0.elastic.rebuild_oracle_query(q, 6)
    np.testing.assert_array_equal(r.ids, o_i)
    np.testing.assert_array_equal(r.d2, o_d)
    [r] = fleet.submit(11, "p0", "fof", 10.0, now=0.011)
    assert not r.ok and r.failure_kind == "invalid-input"
    out = fleet.submit(12, "g", "insert", generate_uniform(16, seed=3),
                       now=0.012)
    assert out[-1].ok and g.is_pod and g.promotions == 1
    assert g.log.committed_seq == 1 and g.n_points == 206
    assert g.elastic.elastic_recompiles == 0     # nothing builds on the CPU


def test_process_failover_drill_cpu_children():
    """The process-level law with real child processes
    (``python -m cuda_knearests_tpu_torch.serve.fleet.replica`` on the
    CPU): a SIGKILL mid-stream, zero lost committed mutations, answers
    byte-identical to a rebuild."""
    drill = failover_drill(n=400, k=6, ops=12, seed=1, device="cpu")
    assert drill["device"] == "cpu"
    assert drill["failovers"] >= 1
    assert drill["zero_lost_committed"], drill
    assert drill["post_failover_byte_identical"], drill
    assert drill["failover_ok"]
    assert drill["committed_mutations"] == drill["commits_acked"]


def test_fleet_without_gpu_refuses_typed():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(NoDeviceError):
        FleetDaemon([(TenantSpec(name="a"), generate_uniform(300, seed=1))])


def test_fleet_cli_assert_steady_cpu(capsys):
    rc = fleet_main.main(["--device", "cpu", "--assert-steady", "--tenants",
                          "3", "--points", "1500", "--requests", "10",
                          "--rate", "400"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0, summary
    assert summary["kernel_route"] == "plain"
    assert summary["recompiles"] == 0 and summary["failed_requests"] == 0
    assert summary["host_syncs"] == summary["fleet_batches"] > 0
    assert summary["d2h_bytes"] > 0 and summary["h2d_bytes"] > 0
    assert summary["per_tenant"]["t2"]["sidecar"]
    capsys.readouterr()
    assert fleet_main.main(["--tenants", "2", "--points", "300"]) == (
        0 if torch.cuda.is_available() else 4)


@pytest.fixture(scope="module")
def cpu_replays():
    """``loadgen.card_equals_cpu`` on the CPU against itself (a mutating
    stream over three dense tenants and the sidecar, with a brownout
    episode), and the two replays it compared."""
    from cuda_knearests_tpu_torch.serve.fleet import (default_fleet_builds,
                                                      loadgen)

    builds = default_fleet_builds(n_tenants=4, base_n=1500, k=K, seed=3,
                                  replicas=1)
    loads = [TenantLoad(tenant=spec.name, rate=300.0, requests=8,
                        mutation_ratio=0.2 if i < 3 else 0.0, seed=90 + i)
             for i, (spec, _) in enumerate(builds)]
    replay, sides = loadgen.replay_fleet, []

    def recorded(*a, **kw):
        sides.append(replay(*a, **kw))
        return sides[-1]

    loadgen.replay_fleet = recorded
    try:
        got = loadgen.card_equals_cpu(builds, loads, "cpu")
    finally:
        loadgen.replay_fleet = replay
    return builds, loads, got, sides


@pytest.mark.parametrize("perturb", [False, True])
def test_card_equals_cpu_names_the_first_difference(monkeypatch,
                                                    cpu_replays, perturb):
    """The check the card runs against the CPU agrees with itself on the
    CPU response for response, degraded rows included; given the same
    two replays with one d2 bit of the first side's first degraded row
    flipped, it names that request."""
    from cuda_knearests_tpu_torch.serve.fleet import loadgen

    builds, loads, got, sides = cpu_replays
    assert len(sides) == 2
    assert got["degraded"] > 0 and got["responses"] >= 32
    if not perturb:
        assert got["difference"] is None, got
        return
    first = [dataclasses.replace(r) for r in sides[0]]
    bad = next(r for r in first if r.degraded is not None)
    bad.d2 = bad.d2.copy()
    bad.d2.view(np.int32)[0, 0] ^= 1
    replies = iter([first, sides[1]])
    monkeypatch.setattr(loadgen, "replay_fleet",
                        lambda *a, **kw: next(replies))
    out = loadgen.card_equals_cpu(builds, loads, "cpu")
    assert out["difference"].startswith(f"request {bad.req_id} "), out


# -- observability that came with the fleet -------------------------------------

def test_obs_reexports_equal_jax_surface():
    import cuda_knearests_tpu.obs as jobs

    assert sorted(obs.__all__) == sorted(jobs.__all__)
    for name in obs.__all__:
        assert getattr(obs, name) is not None


def test_obs_export_equal_jax(tmp_path):
    """Two processes' spills (one with a torn last line) merge into the
    same Chrome trace in both packages; the CLI writes it."""
    d = tmp_path / "traces"
    sink = spans.start_file_trace(str(d / "trace_main_100.jsonl"))
    try:
        with spans.span("solve", force=True, trace_id="abc", rows=3):
            spans.event("dispatch.ici", nbytes=12)
    finally:
        sink.close()
    lines = open(d / "trace_main_100.jsonl").read().splitlines()
    other = []
    for line in lines:
        ev = json.loads(line)
        ev.update(pid=ev["pid"] + 1, job="replica:1", t0=ev["t0"] - 0.5)
        other.append(json.dumps(ev))
    (d / "trace_replica_101.jsonl").write_text(
        "\n".join(other) + "\n{\"torn\": ")
    files = export.trace_files(str(d))
    assert files == jexport.trace_files(str(d))
    assert export.to_chrome(export.merge(files)) == \
        jexport.to_chrome(jexport.merge(files))
    out = tmp_path / "merged.json"
    assert export.main(["--dir", str(d), "--out", str(out)]) == 0
    chrome = json.loads(out.read_text())
    assert len([e for e in chrome["traceEvents"] if e["ph"] == "M"]) == 2
    assert export.main(["--dir", str(tmp_path / "none")]) == 1


def test_trace_sites_and_byte_counters():
    """Every fetch and stage of a small solve and query is recorded with
    its file and line in the package; the window's byte counters equal
    the recorded transfers, and each transfer's own tensors."""
    pts = generate_uniform(2000, seed=7)
    prob = pt.KnnProblem.prepare(pts, pt.KnnConfig(k=K, adaptive=False),
                                 device="cpu")
    dispatch.reset_stats()
    with dispatch.trace_sites() as records:
        prob.solve()
        prob.query(generate_uniform(64, seed=8), K)
    st = dispatch.stats()
    fetches = [r for r in records if r.kind == "fetch"]
    stages = [r for r in records if r.kind == "stage"]
    assert fetches and stages
    assert st.host_syncs == len(fetches)
    assert st.d2h_bytes == sum(r.nbytes for r in fetches)
    assert st.h2d_bytes == sum(r.nbytes for r in stages)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for r in records:
        assert r.path.startswith("cuda_knearests_tpu_torch/"), r
        line = open(os.path.join(root, r.path)).read().splitlines()[
            r.line - 1]
        assert f"{r.kind}(" in line, (r, line)
    dispatch.reset_stats()
    with dispatch.trace_sites() as records:
        a = dispatch.stage(np.zeros((5, 3), np.float32), "cpu")
        b = dispatch.stage(np.zeros(7, np.int64), "cpu")
        dispatch.fetch(a, b)
    assert dispatch.stats_dict() == {"host_syncs": 1, "d2h_bytes": 116,
                                     "h2d_bytes": 116, "ici_bytes": 0}
    assert [(r.kind, r.nbytes, r.synced) for r in records] == [
        ("stage", 60, False), ("stage", 56, False), ("fetch", 116, True)]
    assert dispatch._SITE_TRACE is None


def test_fetch_span_nests_under_caller():
    with spans.capture() as events:
        with spans.span("outer"):
            dispatch.fetch(torch.zeros(4))
    names = [ev["name"] for ev in events]
    assert "dispatch.fetch" in names and "outer" in names
    fetch_ev = next(ev for ev in events if ev["name"] == "dispatch.fetch")
    assert fetch_ev["attrs"]["nbytes"] == 16
    assert fetch_ev["parent"] == "outer"


def test_stopwatch_times_a_solve(capsys):
    prob = pt.KnnProblem.prepare(generate_uniform(500, seed=9),
                                 pt.KnnConfig(k=4), device="cpu")
    res, t = stopwatch.timed(prob.solve, warmup=2, iters=2)
    assert set(t) == {"warmup_s", "mean_s", "min_s"}
    assert 0 < t["min_s"] <= t["mean_s"]
    assert stopwatch.block([torch.zeros(2), {"x": (torch.ones(1),)}])
    with stopwatch.Stopwatch("phase") as sw:
        assert sw.tick() >= 0.0
    assert sw.elapsed > 0
    assert capsys.readouterr().out.startswith("[phase start]")
