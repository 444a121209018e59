"""Open-loop synthetic load generator and session runner.

Counterpart of ``cuda_knearests_tpu/serve/loadgen.py``.  Open loop means
arrivals are scheduled in advance by a Poisson process and never wait for
completions: the generator models independent users, so when the daemon
falls behind, queueing delay shows up as latency instead of throttling the
offered load.  The whole schedule is drawn up front from one seeded RNG,
so a session is replayable from (spec, seed).

A request is a query burst (size drawn from ``batch_mix``) or, with
probability ``mutation_ratio``, a mutation (an insert of fresh in-domain
points or a delete of currently live ids, 50/50).  The session runner
drives the daemon's submit/poll/drain surface against real wall time and
reports the serving metrics: sustained queries/s, p50/p99/p999 latency,
batch occupancy, flush-trigger counts, the host round trips of the window
(``runtime/dispatch``), and the kernel counters of the window
(``dispatch.kernel_stats``): ``recompiles`` = kernel builds + library
loads, which a warmed daemon keeps at 0, and ``kernel_launches``, the
class-kernel launches (0 on the CPU, where the plain versions run).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np

from ..config import DOMAIN_SIZE
from ..obs import metrics as _metrics
from ..runtime import dispatch as _dispatch
from .daemon import Response, ServeDaemon


@dataclasses.dataclass(frozen=True)
class LoadSpec:
    """Regenerable identity of one open-loop load session."""

    rate: float = 200.0                 # mean arrivals per second (Poisson)
    requests: int = 200                 # total scheduled arrivals
    batch_mix: Tuple[Tuple[int, float], ...] = (
        (1, 0.45), (4, 0.25), (16, 0.2), (64, 0.1))  # (queries, weight)
    mutation_ratio: float = 0.0         # fraction of arrivals that mutate
    mutation_size: int = 8              # points per insert / ids per delete
    k: Optional[int] = None             # per-request k (None = serving k)
    seed: int = 0

    def arrivals(self) -> np.ndarray:
        """Relative arrival times: cumulative sum of Exp(1/rate) gaps --
        the Poisson process, drawn once (open loop)."""
        rng = np.random.default_rng(self.seed)
        gaps = rng.exponential(1.0 / max(self.rate, 1e-9), self.requests)
        return np.cumsum(gaps)


def build_schedule(spec: LoadSpec, n_current: int,
                   domain: float = DOMAIN_SIZE) -> List[dict]:
    """The full request schedule: [{t, kind, payload, k}] in arrival order.

    Delete ids are drawn against a TRACKED running cloud size, so every
    scheduled delete is legal at its arrival time (the fuzz layer owns
    hostile streams; the load harness offers legal load)."""
    rng = np.random.default_rng(spec.seed + 1)
    sizes = np.asarray([s for s, _ in spec.batch_mix])
    weights = np.asarray([w for _, w in spec.batch_mix], np.float64)
    weights = weights / weights.sum()
    out = []
    n = int(n_current)
    for t in spec.arrivals():
        if spec.mutation_ratio > 0 and rng.random() < spec.mutation_ratio:
            if rng.random() < 0.5 or n <= spec.mutation_size:
                pts = (rng.random((spec.mutation_size, 3))
                       * (domain * 0.98) + domain * 0.01).astype(np.float32)
                out.append({"t": float(t), "kind": "insert", "payload": pts})
                n += spec.mutation_size
            else:
                ids = rng.choice(n, size=spec.mutation_size, replace=False)
                out.append({"t": float(t), "kind": "delete",
                            "payload": np.sort(ids).astype(np.int64)})
                n -= spec.mutation_size
        else:
            m = int(rng.choice(sizes, p=weights))
            qs = (rng.random((m, 3)) * (domain * 0.98)
                  + domain * 0.01).astype(np.float32)
            out.append({"t": float(t), "kind": "query", "payload": qs,
                        "k": spec.k})
    return out


def _percentiles(hist: "_metrics.Histogram") -> dict:
    """p50/p99/p999 (ms) from a bounded histogram: O(1) memory at any
    sustained load."""
    out = {}
    for label, q in (("p50_ms", 0.5), ("p99_ms", 0.99),
                     ("p999_ms", 0.999)):
        p = hist.percentile(q)
        out[label] = round(p, 3) if p is not None else None
    return out


class SessionAggregate:
    """Streaming response accounting for one open-loop session: counts
    plus bounded latency histograms (total + the span-sourced
    queue/dispatch/device decomposition).  Responses are absorbed as they
    surface and never retained, so a sustained-QPS run's memory is O(1)
    in the request count."""

    def __init__(self, query_only: bool = False) -> None:
        # query_only: bin latency for query responses only (mutation acks
        # are near-instant and would dilute a query p99)
        self.query_only = query_only
        self.responses = 0
        self.ok_query_requests = 0
        self.completed_queries = 0
        self.failed = 0
        self.hist = {name: _metrics.Histogram(f"loadgen.{name}")
                     for name in ("total_ms", "queue_ms", "dispatch_ms",
                                  "device_ms")}

    def absorb(self, rs: List[Response]) -> None:
        for r in rs:
            self.responses += 1
            if r.ok:
                if r.ids is not None:
                    self.ok_query_requests += 1
                    self.completed_queries += int(r.ids.shape[0])
                    self.hist["total_ms"].observe(r.latency_s * 1e3)
                    if r.queue_ms is not None:
                        self.hist["queue_ms"].observe(r.queue_ms)
                        self.hist["dispatch_ms"].observe(r.dispatch_ms)
                        self.hist["device_ms"].observe(r.device_ms)
                elif not self.query_only:
                    self.hist["total_ms"].observe(r.latency_s * 1e3)
            elif r.failure_kind != "invalid-input":
                self.failed += 1

    def decomposition(self) -> dict:
        return {name: _metrics.percentile_fields(h)
                for name, h in self.hist.items()}


def run_session(daemon: ServeDaemon, spec: LoadSpec,
                clock=time.monotonic, sleep=time.sleep) -> dict:
    """Drive one open-loop session against a (warmed) daemon; returns the
    serving summary.

    ``recompiles`` is the number of kernel builds plus library loads inside
    the measured window: the daemon warmed every capacity bucket at
    construction (and re-warms after a compaction), so it must be 0.
    ``kernel_launches`` counts the class kernels launched in the window;
    ``kernel_route`` says whether they were the CUDA kernels or their plain
    versions."""
    schedule = build_schedule(spec, daemon.overlay.n_points,
                              domain=float(daemon.overlay.base.grid.domain
                                           or DOMAIN_SIZE))
    kern0 = _dispatch.kernel_stats()
    _dispatch.reset_stats()
    # streaming aggregation: responses are absorbed (counted and binned
    # into bounded histograms) as they surface, never accumulated
    agg = SessionAggregate()
    t0 = clock()
    i = 0
    while i < len(schedule) or daemon.batcher.pending_queries:
        now = clock()
        if i < len(schedule) and t0 + schedule[i]["t"] <= now:
            item = schedule[i]
            i += 1
            agg.absorb(daemon.submit(
                req_id=i, kind=item["kind"], payload=item["payload"],
                k=item.get("k"), now=t0 + item["t"],
                trace_id=f"s{spec.seed}-{i}"))
            continue
        agg.absorb(daemon.poll(now))
        next_events = []
        if i < len(schedule):
            next_events.append(t0 + schedule[i]["t"])
        deadline = daemon.next_deadline()
        if deadline is not None:
            next_events.append(deadline)
        if not next_events:
            break
        wait = min(next_events) - clock()
        if wait > 0:
            sleep(min(wait, 0.005))
    agg.absorb(daemon.drain(clock()))
    elapsed = max(clock() - t0, 1e-9)

    kern1 = _dispatch.kernel_stats()
    window = {key: kern1[key] - kern0[key] for key in kern1}
    return {
        "requests": len(schedule),
        "responses": agg.responses,
        "completed_query_requests": agg.ok_query_requests,
        "completed_queries": agg.completed_queries,
        "failed_requests": agg.failed,
        "elapsed_s": round(elapsed, 4),
        "sustained_qps": round(agg.completed_queries / elapsed, 1),
        "offered_rate": spec.rate,
        "mutation_ratio": spec.mutation_ratio,
        "seed": spec.seed,
        **_percentiles(agg.hist["total_ms"]),
        "latency_decomposition": agg.decomposition(),
        "recompiles": window["kernel_builds"] + window["kernel_loads"],
        **window,
        **_dispatch.stats_dict(),   # host_syncs of the window
        # the session-window decomposition above wins over the daemon's
        # lifetime one (identical on a fresh daemon; the window is exact)
        **{key: v for key, v in daemon.stats_dict().items()
           if key != "latency_decomposition"},
    }
