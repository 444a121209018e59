"""The multi-tenant open-loop load harness: the fleet's measurement surface.

Counterpart of ``cuda_knearests_tpu/serve/fleet/loadgen.py``.  The open-loop
discipline of ``serve/loadgen.py`` (arrivals scheduled in advance by
seeded Poisson processes, never gated on completions) across tenants:
each tenant has its own arrival process and batch mix, the merged
schedule drives the one front door, and the summary reports per-tenant
latency percentiles, sustained queries/s, refusals, Jain's fairness index
over per-tenant completion ratios, SLO verdicts (p99 <= the class
budget), the window's host round trips and bytes each way
(``runtime/dispatch``) and its kernel counters
(``dispatch.kernel_stats``): ``recompiles`` = kernel builds + library
loads outside elastic index work, which a warmed fleet keeps at 0, and
the class-kernel launches.
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ...config import DOMAIN_SIZE, SLO_CLASSES, ServeFleetConfig
from ...runtime import dispatch as _dispatch
from ..daemon import Response
from ..loadgen import SessionAggregate, _percentiles
from .admission import jain_index
from .frontdoor import FleetDaemon
from .tenants import TenantSpec


@dataclasses.dataclass(frozen=True)
class TenantLoad:
    """One tenant's offered load (regenerable from the seed).

    ``hotspot`` concentrates this tenant's scheduled INSERTS into the
    axis-aligned sub-cube ``[lo*domain, hi*domain]^3`` -- a contiguous
    low-Morton range when ``lo`` is near 0 -- so a pod tenant's
    population skews deterministically and the live-rebalance trigger
    (pod/reshard.ElasticIndex.maybe_rebalance) fires reproducibly.
    Queries and deletes are unaffected.

    ``diurnal`` sine-modulates the Poisson
    intensity: it is the peak/trough ratio of ``rate(t) = rate * (1 + a
    sin(2 pi t / P))`` with ``a = (diurnal - 1) / (diurnal + 1)`` and
    period ``P = diurnal_period_s`` (default: the load's nominal
    duration, one full cycle).  Arrivals come from inverting the
    cumulative intensity on a unit-rate seeded Poisson stream, so the
    pattern is exactly regenerable and the MEAN rate stays ``rate``.

    ``backoff`` opts this tenant's client into honoring typed
    ``retry_after_ms`` hints: a refused request that carries one is
    RE-OFFERED after the hinted delay (up to ``max_retries`` times)
    instead of being lost -- shed load becomes measurable as
    ``deferred_requests`` in the session summary."""

    tenant: str
    rate: float = 200.0
    requests: int = 100
    batch_mix: Tuple[Tuple[int, float], ...] = (
        (1, 0.45), (4, 0.25), (16, 0.2), (64, 0.1))
    mutation_ratio: float = 0.0
    mutation_size: int = 8
    k: Optional[int] = None
    seed: int = 0
    hotspot: Optional[Tuple[float, float]] = None
    diurnal: Optional[float] = None
    diurnal_period_s: Optional[float] = None
    backoff: bool = False
    max_retries: int = 3

    def arrivals(self) -> np.ndarray:
        """This load's seeded arrival times (flat or diurnal).  The flat
        path is bit-identical to the pre-diurnal harness (same rng, same
        expression), so every existing pinned schedule is unchanged."""
        rate = max(self.rate, 1e-9)
        if self.diurnal is None or self.diurnal <= 1.0:
            return np.cumsum(np.random.default_rng(self.seed).exponential(
                1.0 / rate, self.requests))
        unit = np.cumsum(np.random.default_rng(self.seed).exponential(
            1.0, self.requests))
        a = (self.diurnal - 1.0) / (self.diurnal + 1.0)
        period = (self.diurnal_period_s if self.diurnal_period_s
                  else self.requests / rate)
        return _invert_diurnal(unit, rate, a, period)


def _invert_diurnal(unit: np.ndarray, rate: float, a: float,
                    period: float) -> np.ndarray:
    """Arrival times of an inhomogeneous Poisson process by numeric
    inversion of the cumulative intensity ``L(t) = rate * (t + a P /
    (2 pi) * (1 - cos(2 pi t / P)))`` (monotone: |a| < 1) applied to a
    unit-rate stream -- bisection, fully vectorized, deterministic."""
    u = np.asarray(unit, np.float64)
    lo = np.zeros_like(u)
    hi = np.full_like(u, float(u[-1]) / (rate * (1.0 - a)) + period)
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        val = rate * (mid + a * period / (2 * np.pi)
                      * (1.0 - np.cos(2 * np.pi * mid / period)))
        take = val < u
        lo = np.where(take, mid, lo)
        hi = np.where(take, hi, mid)
    return hi


def build_fleet_schedule(loads: List[TenantLoad],
                         n_current: Dict[str, int],
                         domain: float = DOMAIN_SIZE) -> List[dict]:
    """The merged arrival-ordered schedule: [{t, tenant, kind, payload,
    k}].  Per-tenant delete ids track that tenant's running cloud size, so
    every scheduled mutation is legal at its arrival time (hostile streams
    are the fuzz campaign's job)."""
    out: List[dict] = []
    for load in loads:
        rng = np.random.default_rng(load.seed + 1)
        arrivals = load.arrivals()
        sizes = np.asarray([s for s, _ in load.batch_mix])
        weights = np.asarray([w for _, w in load.batch_mix], np.float64)
        weights = weights / weights.sum()
        n = int(n_current[load.tenant])
        for t in arrivals:
            if load.mutation_ratio > 0 \
                    and rng.random() < load.mutation_ratio:
                if rng.random() < 0.5 or n <= load.mutation_size:
                    if load.hotspot is not None:
                        lo, hi = load.hotspot
                        span = max(hi - lo, 1e-6) * domain
                        pts = (rng.random((load.mutation_size, 3)) * span
                               + lo * domain).astype(np.float32)
                    else:
                        pts = (rng.random((load.mutation_size, 3))
                               * (domain * 0.98)
                               + domain * 0.01).astype(np.float32)
                    out.append({"t": float(t), "tenant": load.tenant,
                                "kind": "insert", "payload": pts})
                    n += load.mutation_size
                else:
                    ids = rng.choice(n, size=load.mutation_size,
                                     replace=False)
                    out.append({"t": float(t), "tenant": load.tenant,
                                "kind": "delete",
                                "payload": np.sort(ids).astype(np.int64)})
                    n -= load.mutation_size
            else:
                m = int(rng.choice(sizes, p=weights))
                qs = (rng.random((m, 3)) * (domain * 0.98)
                      + domain * 0.01).astype(np.float32)
                out.append({"t": float(t), "tenant": load.tenant,
                            "kind": "query", "payload": qs, "k": load.k})
    out.sort(key=lambda item: item["t"])
    return out


def run_fleet_session(fleet: FleetDaemon, loads: List[TenantLoad],
                      clock=time.monotonic, sleep=time.sleep) -> dict:
    """Drive one merged open-loop session; returns the fleet summary.

    ``recompiles`` is the kernel builds plus library loads inside the
    measured window, less those attributed to elastic index work
    (migration handovers, shard rebuilds, a promotion to the pod rung):
    every dense tenant warmed its buckets at construction, so a session
    must measure 0 -- the steady-state law ``--assert-steady`` checks
    across >= 2 tenants at once.  ``kernel_route`` says whether batches
    launched the CUDA kernels or ran their plain versions, and
    ``kernel_launches`` counts the class kernels launched in the
    window."""
    schedule = build_fleet_schedule(
        loads, {name: t.n_points for name, t in fleet.tenants.items()},
        domain=DOMAIN_SIZE)
    kern0 = _dispatch.kernel_stats()
    elastic0 = sum(t.elastic.elastic_recompiles
                   for t in fleet.tenants.values() if t.is_pod)
    _dispatch.reset_stats()
    # streaming per-tenant aggregation: every response is absorbed --
    # counted and binned into bounded histograms
    # (query responses only: the fleet's SLO-gate semantics) -- the
    # moment it surfaces; nothing is retained, so a sustained-QPS fleet
    # session's memory is O(1) in the request count
    aggs: Dict[str, SessionAggregate] = {
        load.tenant: SessionAggregate(query_only=True) for load in loads}
    fleet_agg = SessionAggregate(query_only=True)
    degraded_rows: Dict[str, int] = {}

    def absorb(rs: List[Response]) -> None:
        fleet_agg.absorb(rs)
        for r in rs:
            if r.tenant in aggs:
                aggs[r.tenant].absorb([r])
            if r.degraded is not None and r.ids is not None:
                degraded_rows[r.degraded] = (
                    degraded_rows.get(r.degraded, 0)
                    + int(r.ids.shape[0]))

    # client-side backoff: tenants with
    # TenantLoad.backoff re-offer a refusal that carries a typed
    # retry_after_ms hint -- shed load is DEFERRED, not lost
    backoff = {load.tenant: load for load in loads if load.backoff}
    reoffer: List[tuple] = []        # (due, seq, tries, item) min-heap
    deferred = 0
    rid = 0

    def offer(item: dict, now: float, tries: int) -> None:
        nonlocal rid, deferred
        rid += 1
        rs = fleet.submit(
            req_id=rid, tenant=item["tenant"], kind=item["kind"],
            payload=item["payload"], k=item.get("k"), now=now,
            trace_id=f"{item['tenant']}-{rid}")
        load = backoff.get(item["tenant"])
        if load is not None and tries < load.max_retries:
            mine = next((r for r in rs if r.req_id == rid), None)
            if mine is not None and not mine.ok \
                    and mine.retry_after_ms is not None:
                deferred += 1
                heapq.heappush(reoffer,
                               (now + mine.retry_after_ms / 1e3 + 1e-3,
                                rid, tries + 1, item))
        absorb(rs)

    t0 = clock()
    i = 0
    pending = (lambda: any(t.ready or (t.daemon is not None
                                       and t.daemon.batcher.pending_queries)
                           for t in fleet.tenants.values()))
    while i < len(schedule) or reoffer or pending():
        now = clock()
        if reoffer and reoffer[0][0] <= now:
            _, _, tries, item = heapq.heappop(reoffer)
            offer(item, now, tries)
            continue
        if i < len(schedule) and t0 + schedule[i]["t"] <= now:
            item = schedule[i]
            i += 1
            offer(item, t0 + item["t"], 0)
            continue
        absorb(fleet.poll(now))
        next_events = []
        if i < len(schedule):
            next_events.append(t0 + schedule[i]["t"])
        if reoffer:
            next_events.append(reoffer[0][0])
        deadline = fleet.next_deadline()
        if deadline is not None:
            next_events.append(deadline)
        if not next_events:
            break
        wait = min(next_events) - clock()
        if wait > 0:
            sleep(min(wait, 0.005))
    absorb(fleet.drain(clock()))
    # a pod tenant may still hold an in-flight migration: pump it dry so
    # the session's summary reflects the post-handover state (bounded:
    # each pump ships one chunk)
    for t in fleet.tenants.values():
        guard = 0
        while t.is_pod and t.elastic.migration is not None \
                and guard < 10_000:
            t.elastic.pump()
            guard += 1
    elapsed = max(clock() - t0, 1e-9)
    kern1 = _dispatch.kernel_stats()
    window = {key: kern1[key] - kern0[key] for key in kern1}
    # builds and loads attributed to elastic index maintenance
    # (migration handovers, shard rebuilds, mutation-side compaction) are
    # carved out of the steady-state recompile gate: a live rebalance is
    # index work, not a serving-path recompile
    elastic1 = sum(t.elastic.elastic_recompiles
                   for t in fleet.tenants.values() if t.is_pod)
    elastic_recompiles = int(elastic1 - elastic0)

    per_tenant: Dict[str, dict] = {}
    offered: Dict[str, int] = {load.tenant: 0 for load in loads}
    for item in schedule:
        if item["kind"] == "query":
            offered[item["tenant"]] += item["payload"].shape[0]
    completion = []
    for load in loads:
        name = load.tenant
        agg = aggs[name]
        served = agg.completed_queries
        # percentiles over QUERY responses only: mutation acks are
        # near-instant and would dilute the p99 the slo_ok gate checks
        slo = SLO_CLASSES[fleet.tenants[name].spec.slo]
        pct = _percentiles(agg.hist["total_ms"])
        ratio = served / offered[name] if offered[name] else None
        completion.append(ratio)
        per_tenant[name] = {
            "slo": slo.name,
            "offered_rows": offered[name],
            "served_rows": served,
            "completion": (round(ratio, 6) if ratio is not None else None),
            "refused": fleet.refused[name],
            "failed": agg.failed,
            "sustained_qps": round(served / elapsed, 1),
            "sidecar": fleet.tenants[name].is_sidecar,
            "pod": fleet.tenants[name].is_pod,
            **pct,
            "decomposition": agg.decomposition(),
            "slo_p99_budget_ms": slo.p99_budget_ms,
            "slo_ok": (pct["p99_ms"] is not None
                       and pct["p99_ms"] <= slo.p99_budget_ms),
        }
    total_served = fleet_agg.completed_queries
    occ = [b["rows"] / b["capacity"] for b in fleet.batch_log]
    summary = {
        "requests": len(schedule),
        "responses": fleet_agg.responses,
        "completed_queries": total_served,
        "failed_requests": fleet_agg.failed,
        "refused_requests": int(sum(fleet.refused.values())),
        "deferred_requests": deferred,
        "degraded_rows": dict(degraded_rows),
        "elapsed_s": round(elapsed, 4),
        "sustained_qps": round(total_served / elapsed, 1),
        "recompiles": int(window["kernel_builds"] + window["kernel_loads"]
                          - elastic_recompiles),
        "elastic_recompiles": elastic_recompiles,
        "migrations_done": sum(t.elastic.migrations_done
                               for t in fleet.tenants.values()
                               if t.is_pod),
        "kernel_route": "cuda" if fleet.device.type == "cuda" else "plain",
        "occupancy_mean": (round(float(np.mean(occ)), 4) if occ else None),
        # fleet-wide per-request latency decomposition (span-sourced:
        # queue wait -> host dispatch -> device), p50/p99
        "latency_decomposition": fleet_agg.decomposition(),
        "jain_fairness": jain_index(completion),
        "n_tenants": len(fleet.tenants),
        "slo_ok_all": all(per_tenant[n]["slo_ok"] or not offered[n]
                          for n in per_tenant),
        "per_tenant": per_tenant,
        **{k: v for k, v in fleet.stats_dict().items()
           if k != "tenants" and k not in window},
        **window,                    # the kernel counters of the window
        **_dispatch.stats_dict(),    # round trips and bytes of the window
    }
    return summary


def replay_fleet(builds, items: List[dict], device, brown_at: int,
                 up_at: int) -> List[Response]:
    """One scripted stream through a fresh fleet on ``device`` under a
    fake clock: at each item's time a deadline poll, then its submit; the
    first dense throughput tenant steps down to the bf16 rung before item
    ``brown_at`` and back up before ``up_at`` (1-based).  Returns every
    response in order."""
    clock = [0.0]
    fleet = FleetDaemon(builds, ServeFleetConfig(warmup=False),
                        clock=lambda: clock[0], device=device)
    hot = next(t for t in fleet.tenants.values()
               if t.daemon is not None and t.spec.slo == "throughput")
    out: List[Response] = []
    for rid, it in enumerate(items, start=1):
        clock[0] = it["t"]
        if rid == brown_at:
            hot.brown_down()
        if rid == up_at:
            hot.brown_up()
        out += fleet.poll(it["t"])
        out += fleet.submit(rid, it["tenant"], it["kind"], it["payload"],
                            k=it.get("k"), now=it["t"])
    clock[0] = items[-1]["t"] + 1.0
    return out + fleet.drain(clock[0])


def rows_bit_equal(a_ids, a_d2, b_ids, b_d2) -> bool:
    """Two answers agree: both absent, or ids equal and d2 equal bit for
    bit (NaN and -0.0 included)."""
    if a_ids is None or b_ids is None:
        return a_ids is None and b_ids is None
    return bool(np.array_equal(a_ids, b_ids) and np.array_equal(
        np.asarray(a_d2, np.float32).view(np.int32),
        np.asarray(b_d2, np.float32).view(np.int32)))


def card_equals_cpu(builds, loads: List[TenantLoad], device) -> dict:
    """The fleet's card-against-CPU check: the schedule of ``loads``
    through :func:`replay_fleet` on ``device`` and on the CPU, with a
    bf16 brownout episode over its middle third.  Every response must
    agree: req_id, ok, tenant, degraded tier, failure kind and n_points,
    ids and d2 bit for bit.  Returns {'responses', 'degraded' (responses
    served at a brownout rung), 'difference' (None, or what the first
    disagreeing response differs in)}."""
    items = build_fleet_schedule(
        loads, {spec.name: pts.shape[0] for spec, pts in builds})
    at = (len(items) // 3, 2 * len(items) // 3)
    got = replay_fleet(builds, items, device, *at)
    want = replay_fleet(builds, items, "cpu", *at)
    out = {"responses": len(got),
           "degraded": sum(r.degraded is not None for r in got),
           "difference": None}
    if len(got) != len(want):
        out["difference"] = (f"{len(got)} responses against the CPU's "
                             f"{len(want)}")
        return out

    def head(r: Response) -> tuple:
        return (r.req_id, r.ok, r.tenant, r.degraded, r.failure_kind,
                r.n_points)

    for a, b in zip(got, want):
        if head(a) != head(b):
            out["difference"] = (f"request {a.req_id}: {head(a)} against "
                                 f"the CPU's {head(b)}")
            return out
        if not rows_bit_equal(a.ids, a.d2, b.ids, b.d2):
            out["difference"] = (f"request {a.req_id} ({a.tenant}, tier "
                                 f"{a.degraded}): rows differ from the "
                                 f"CPU's")
            return out
    return out


def default_fleet_builds(n_tenants: int = 4, base_n: int = 6000,
                         k: int = 8, seed: int = 0,
                         sidecar_tenant: bool = True,
                         replicas: int = 0):
    """A mixed-SLO fleet build list for the smokes: tenants alternate
    latency / throughput classes; the last tenant (when
    ``sidecar_tenant``) is tiny, 48 points, so it lands on the host
    sidecar; the first two tenants share one cloud size and the others
    grow by 1,024 points a tenant."""
    from ...io import generate_uniform

    builds = []
    for i in range(n_tenants):
        tiny = sidecar_tenant and i == n_tenants - 1 and n_tenants > 1
        n = 48 if tiny else base_n  # tenants 0 and 1 share a size
        if not tiny and i >= 2:
            n = base_n + 1024 * i
        spec = TenantSpec(
            name=f"t{i}", k=k,
            slo="latency" if i % 2 == 0 else "throughput",
            replicas=replicas if not tiny else 0)
        builds.append((spec, generate_uniform(n, seed=seed + 17 * i)))
    return builds
