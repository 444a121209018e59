"""The fleet's autoscaler and brownout ladder of the PyTorch port against the
JAX package's, on the CPU.

Both packages build the same fleet (two dense throughput tenants of 1,500
and 2,000 points, lazy shipping, k=8) behind an autoscaling front door,
the port's on ``device='cpu'``.  Fed the same sensor inputs -- a forced
breach / clear pattern, or a real diurnal session under the same fake
clock -- their control loops must fire the same actuations at the same
ticks (every field of every event), the same counters and the same
``utils.prototrace`` sequence.  The actuators' laws are held on both:
the hysteresis and anti-flap gap and the faults that break them
(``flap-policy``, ``stuck-sensor``), replica scale-down compacting only
to the survivors' applied floor (``scale-drop-tail`` breaks it), the
brownout ladder stamping the wire and recovering byte-identical answers,
shedding queries typed but never mutations, and promotion resetting the
stamp.  Degraded rows are held tie-aware to JAX's at the exact rung
(RTOL 1e-4 / ATOL 1e-2, ``fuzz/compare.check_route_result``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from cuda_knearests_tpu.config import ServeFleetConfig as JFleetConfig
from cuda_knearests_tpu.serve.fleet import AutoscaleConfig as JAutoscaleConfig
from cuda_knearests_tpu.serve.fleet import FleetDaemon as JFleet
from cuda_knearests_tpu.serve.fleet import TIER_NAMES as J_TIER_NAMES
from cuda_knearests_tpu.serve.fleet import TenantLoad as JTenantLoad
from cuda_knearests_tpu.serve.fleet import TenantSpec as JTenantSpec
from cuda_knearests_tpu.serve.fleet import run_fleet_session as jrun
from cuda_knearests_tpu.utils import prototrace as jtrace
from cuda_knearests_tpu_torch.config import ServeFleetConfig
from cuda_knearests_tpu_torch.fuzz.compare import check_route_result
from cuda_knearests_tpu_torch.io import generate_uniform
from cuda_knearests_tpu_torch.serve.fleet import (TIER_NAMES,
                                                  AutoscaleConfig,
                                                  FleetDaemon, TenantLoad,
                                                  TenantSpec,
                                                  run_fleet_session)
from cuda_knearests_tpu_torch.utils import prototrace

K = 8
CFG_KW = dict(min_bucket=8, max_batch=64, compact_threshold=64,
              warmup=False, sidecar_threshold=192, drr_quantum=16)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """As ``tests/test_torch_fleet.py``: torch on two threads beside the
    other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


class FakeClock:
    """Synthetic time: ``sleep`` advances it, and so does every read, by
    one microsecond -- a session loop that polls a deadline equal to
    ``now`` within float rounding (and so does not sleep) still moves
    on."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-6
        return self.t

    def sleep(self, s):
        self.t += s


def _builds(spec_cls, lazy=True):
    mode = "lazy" if lazy else "sync"
    return [(spec_cls(name="a", k=K, slo="throughput", ship_mode=mode),
             generate_uniform(1500, seed=1)),
            (spec_cls(name="b", k=K, slo="throughput", ship_mode=mode),
             generate_uniform(2000, seed=2))]


def _pair(clock=None, **as_kw):
    """The same autoscaling fleet in both packages: (port, JAX)."""
    pclock, jclock = clock or FakeClock(), FakeClock()
    port = FleetDaemon(_builds(TenantSpec), ServeFleetConfig(**CFG_KW),
                       clock=pclock, device="cpu",
                       autoscale=AutoscaleConfig(period_s=0.01, **as_kw))
    jax = JFleet(_builds(JTenantSpec), JFleetConfig(**CFG_KW), clock=jclock,
                 autoscale=JAutoscaleConfig(period_s=0.01, **as_kw))
    return port, jax


def _traced(run):
    """``run()`` with both packages' protocol recorders on; returns
    (result, JAX trace, port trace)."""
    jtrace.enable()
    prototrace.enable()
    try:
        out = run()
        return out, jtrace.drain(), prototrace.drain()
    finally:
        jtrace.disable()
        prototrace.disable()


def _force_sense(sc, pattern):
    """Replace the sensor pass: tick i reads breach iff ``pattern[i]``."""
    seen = [0]

    def fake(now):
        b = bool(pattern[min(seen[0], len(pattern) - 1)])
        seen[0] += 1
        out = {"throughput": {
            "queue_rows": 999 if b else 0, "refused_delta": 0,
            "served_delta": 0, "p999_ms": None,
            "breach": b, "clear": not b}}
        sc.last_sensors = out
        return out
    sc._sense = fake


def _tick_all(fleet, n):
    sc = fleet.autoscaler
    sc.tick(0.0)                       # arm the period
    for i in range(n):
        sc.tick((i + 1) * sc.config.period_s * 1.01)


def _query_through(fleet, req_id, tenant, queries, now=0.0):
    out = fleet.submit(req_id, tenant, "query", queries, now=now)
    out += fleet.drain(now)
    [mine] = [r for r in out if r.req_id == req_id]
    return mine


def test_autoscale_config_equal_jax():
    assert TIER_NAMES == J_TIER_NAMES == ("exact", "bf16", "recall")
    for kw in ({}, dict(period_s=0.005, promote_min_points=4000)):
        assert dataclasses.asdict(AutoscaleConfig(**kw)) == \
            dataclasses.asdict(JAutoscaleConfig(**kw))


PATTERNS = {
    # sustained breach then a long clear: scale up, brown down twice,
    # shed, then brown up twice and scale down
    "flood-then-clear": [True] * 16 + [False] * 40,
    # the streak resets every other tick: no actuation ever
    "alternating": [True, False] * 12,
    # two short floods: hysteresis and cooldown between them
    "two-floods": [True] * 5 + [False] * 12 + [True] * 6 + [False] * 20,
}


@pytest.mark.parametrize("fault", [None, "flap-policy"])
@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_forced_actuations_equal_jax(name, fault):
    """The same breach pattern through both control loops: the same
    events (action, tenant, tier, replicas, tick, time), counters,
    added replicas and protocol trace; the anti-flap gap holds unless the
    flap-policy fault bypasses it."""
    port, jax = _pair()
    port._fault = jax._fault = fault
    pattern = PATTERNS[name]
    for fleet in (port, jax):
        _force_sense(fleet.autoscaler, pattern)
    _, _, ptrace = _traced(lambda: _tick_all(port, len(pattern)))
    _, jtr, _ = _traced(lambda: _tick_all(jax, len(pattern)))
    ps, js = port.autoscaler.stats_dict(), jax.autoscaler.stats_dict()
    for key in ("events", "added", "failures", "ticks", "scale_up",
                "scale_down", "brown_down", "brown_up", "shed",
                "promote", "widen", "narrow", "actuation_failures"):
        assert ps[key] == js[key], key
    assert ptrace == jtr
    ticks = [ev["tick"] for ev in ps["events"]]
    gaps_ok = all(b - a > port.autoscaler.config.cooldown_ticks
                  for a, b in zip(ticks, ticks[1:]))
    if name == "alternating" and fault is None:
        assert not ticks
    elif fault is None:
        assert ps["scale_up"] >= 1 and gaps_ok
    else:
        assert not gaps_ok
    if name == "flood-then-clear":
        assert ps["brown_down"] >= 2 and ps["shed"] >= 1
        assert all(t.degraded_tier == 0 for t in port.tenants.values())


def test_stuck_sensor_freezes_policy_equal_jax():
    port, jax = _pair()
    rng = np.random.default_rng(0)
    loads = [(rng.random((32, 3)) * 100.0 + 5.0).astype(np.float32)
             for _ in range(6)]
    for fleet in (port, jax):
        fleet._fault = "stuck-sensor"
        sc = fleet.autoscaler
        sc.tick(0.0)
        sc.tick(0.011)                 # the first real sample freezes
        assert sc._frozen is not None
        for i, q in enumerate(loads):
            fleet.submit(100 + i, "a", "query", q, now=0.012)
        for i in range(12):
            sc.tick(0.011 + (i + 1) * 0.0101)
        assert sc._sense(1.0) is sc._frozen
        assert not sc.events
    assert port.autoscaler._frozen == jax.autoscaler._frozen


def _scale_down_drill(fleet, unsafe):
    """Two replicas born at seq 0, a commit none of them saw (lazy
    shipping), a removal: the safe one compacts to the survivor's applied
    floor (nothing), the unsafe one past it.  Then a commit and a
    failover, which the unsafe compaction makes unrecoverable."""
    t = fleet.tenants["a"]
    out = {"baseline": t.remove_replica()}
    assert t.add_replica() and t.add_replica()
    pts = (np.random.default_rng(3).random((4, 3)) * 100.0
           + 5.0).astype(np.float32)
    assert fleet.submit(1, "a", "insert", pts, now=0.001)[-1].ok
    out["removed"] = t.remove_replica(unsafe_compact=unsafe)
    try:
        list(t.log.since(0))
        out["prefix_kept"] = True
    except RuntimeError:
        out["prefix_kept"] = False
    pts2 = (np.random.default_rng(4).random((4, 3)) * 100.0
            + 5.0).astype(np.float32)
    before = t.daemon.overlay.mutated_points().copy()
    assert fleet.submit(2, "a", "insert", pts2, now=0.002)[-1].ok
    try:
        out["failover"] = t.failover()
        out["zero_lost"] = bool(np.array_equal(
            t.daemon.overlay.mutated_points(),
            np.concatenate([before, pts2])))
    except RuntimeError as e:
        out["failover"] = str(e)
    return out


@pytest.mark.parametrize("unsafe", [False, True])
def test_scale_down_compaction_floor_equal_jax(unsafe):
    port, jax = _pair()
    got, _, ptrace = _traced(lambda: _scale_down_drill(port, unsafe))
    want, jtr, _ = _traced(lambda: _scale_down_drill(jax, unsafe))
    assert got == want
    assert want["baseline"] is None
    assert want["removed"]["victim_seq"] == 0
    if unsafe:
        assert want["removed"]["compacted"] == 1
        assert not want["prefix_kept"]
        assert "compacted past seq" in want["failover"]
    else:
        assert want["removed"]["compacted"] == 0 and want["prefix_kept"]
        assert want["failover"]["replayed"] == 2 and want["zero_lost"]
    assert ptrace == jtr


def test_brownout_ladder_equal_jax():
    """Each rung stamps the wire; rung 1 (bf16 with the exact refinement)
    keeps the ids exact; rung 2 is certified-approximate; after walking
    back up the tenant answers byte-identically to before."""
    port, jax = _pair()
    q = generate_uniform(24, seed=7)
    rows = {}
    for tag, fleet in (("port", port), ("jax", jax)):
        t = fleet.tenants["a"]
        pre = _query_through(fleet, 11, "a", q)
        assert pre.ok and pre.degraded is None
        assert "degraded" not in pre.to_wire()
        assert t.brown_down() == 1 and t.degraded_tier_name == "bf16"
        mid = _query_through(fleet, 12, "a", q)
        assert mid.ok and mid.degraded == "bf16"
        assert mid.to_wire()["degraded"] == "bf16"
        assert t.brown_down() == 2 and t.degraded_tier_name == "recall"
        deep = _query_through(fleet, 13, "a", q)
        assert deep.ok and deep.degraded == "recall"
        assert t.brown_down(max_tier=2) == 2
        assert t.brown_up() == 1 and t.brown_up() == 0
        assert t.brown_up() == 0
        post = _query_through(fleet, 14, "a", q)
        assert post.ok and post.degraded is None
        np.testing.assert_array_equal(pre.ids, post.ids)
        np.testing.assert_array_equal(pre.d2, post.d2)
        rows[tag] = (pre, mid, deep)
    pts = port.tenants["a"].mutated_points()
    for got, want in zip(rows["port"][:2], rows["jax"][:2]):
        assert check_route_result(pts, q, got.ids, got.d2,
                                  np.asarray(want.d2), K) is None
    np.testing.assert_array_equal(rows["port"][1].ids, rows["port"][0].ids)
    deep = rows["port"][2]
    assert deep.ids.shape == (24, K) and (deep.ids >= 0).all()


def test_shed_refuses_queries_typed_never_mutations():
    port, jax = _pair()
    answers = []
    for fleet in (port, jax):
        fleet.autoscaler.shed_until["throughput"] = 60.0
        q = fleet.tenants["a"].mutated_points()[:3].copy()
        [r] = fleet.submit(21, "a", "query", q, now=0.5)
        pts = (np.random.default_rng(6).random((4, 3)) * 100.0
               + 5.0).astype(np.float32)
        m = fleet.submit(22, "a", "insert", pts, now=0.6)[-1]
        answers.append((r.ok, r.failure_kind, r.retry_after_ms, m.ok,
                        fleet.refused["a"]))
    assert answers[0] == answers[1] == (False, "invalid-input", 50.0, True, 1)


def test_promotion_resets_brownout_stamp():
    port, _ = _pair()
    t = port.tenants["a"]
    assert t.brown_down() == 1
    assert port.autoscaler._promote(t, 0.0)
    assert t.is_pod and t.degraded_tier == 0 and t.degraded_recall == 1.0
    assert t.degraded_tier_name is None


def _diurnal_session(pkg):
    """The --autoscale smoke's session at a small size through one
    package, on a fake clock: sine-modulated arrivals, client backoff.
    The queue bands are scaled to the small load (breach at 16 queued
    rows, clear at 4)."""
    if pkg == "port":
        fleet_cls, spec_cls, load_cls, run = (FleetDaemon, TenantSpec,
                                              TenantLoad, run_fleet_session)
        kw = dict(device="cpu")
        cfg, as_cfg = ServeFleetConfig(**CFG_KW), AutoscaleConfig
    else:
        fleet_cls, spec_cls, load_cls, run = (JFleet, JTenantSpec,
                                              JTenantLoad, jrun)
        kw = {}
        cfg, as_cfg = JFleetConfig(**CFG_KW), JAutoscaleConfig
    clock = FakeClock()
    fleet = fleet_cls(_builds(spec_cls), cfg, clock=clock,
                      autoscale=as_cfg(period_s=0.005,
                                       promote_min_points=1 << 30,
                                       queue_high_rows=16,
                                       queue_low_rows=4), **kw)
    loads = [load_cls(tenant=name, rate=rate, requests=reqs, diurnal=4.0,
                      backoff=True, seed=70 + i)
             for i, (name, rate, reqs) in enumerate(
                 (("a", 600.0, 40), ("b", 360.0, 32)))]
    summary = run(fleet, loads, clock=clock, sleep=clock.sleep)
    return fleet, summary


def test_diurnal_session_actuations_equal_jax():
    """A real diurnal session on the same fake clock through both
    packages: batch boundaries, DRR order, the sensors' readings, every
    actuation and the protocol trace are equal, and the brownout rung
    served degraded rows."""
    (pf, ps), _, ptrace = _traced(lambda: _diurnal_session("port"))
    (jf, js), jtr, _ = _traced(lambda: _diurnal_session("jax"))
    assert list(pf.batch_log) == list(jf.batch_log)
    pa, ja = pf.autoscaler.stats_dict(), jf.autoscaler.stats_dict()
    assert pa["events"] == ja["events"]
    assert {k: v for k, v in pa.items() if k not in ("classes",)} == \
        {k: v for k, v in ja.items() if k not in ("classes",)}
    assert ptrace == jtr
    for key in ("requests", "responses", "completed_queries",
                "failed_requests", "refused_requests", "deferred_requests",
                "degraded_rows", "fleet_batches", "drr_dispatches"):
        assert ps[key] == js[key], key
    assert ps["failed_requests"] == 0 and ps["recompiles"] == 0
    for key in ("scale_up", "scale_down", "brown_down", "brown_up",
                "shed"):
        assert pa[key] >= 1, key
    assert sum(ps["degraded_rows"].values()) > 0
    assert ps["deferred_requests"] > 0
