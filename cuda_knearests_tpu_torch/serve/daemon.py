"""The serving daemon: request admission, batched execution, typed failure
containment.

Counterpart of ``cuda_knearests_tpu/serve/daemon.py``.  One
``ServeDaemon`` owns a prepared problem wrapped in the mutation overlay
(``serve/delta.py``), a dynamic batcher (``serve/batching.py``) and the
execution counters, and runs on its problem's device.  The wire's error
model is the engine's typed taxonomy: a malformed request is refused at
admission with an ``InputContractError`` subclass (kind 'invalid-input'),
and a batch whose execution dies is contained -- every rider gets a typed
failure response whose ``failure_kind`` is one of
``runtime.supervisor.FAILURE_KINDS``, and the daemon keeps serving (a
crashed or refused request costs one batch, never the daemon).

Execution: every batch pads to its capacity bucket with sentinel queries
(the domain centre: legal input, rows discarded on reply) and runs at the
serving k whatever each request's own k, through
``DeltaOverlay.query`` -> ``KnnProblem.query`` -> the class kernels.  The
daemon warms every bucket when it starts and after each compaction, so a
steady session builds and loads no kernel library: its ``recompiles``
(kernel builds plus library loads inside the measured window,
``runtime/dispatch.kernel_stats``) stay 0, the port's counterpart of the
reference's zero executable-cache misses after warmup.

Fault injection: ``KNTPU_SERVE_FAULT=batch:<n>[:kind]`` raises a synthetic
failure on the n-th executed batch (kind 'oom' raises a
LaunchBudgetError, anything else a RuntimeError classified 'crash'), so
tests prove containment without a real device fault.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..api import KnnProblem
from ..config import DOMAIN_SIZE, ServeConfig
from ..io import validate_request
from ..obs import metrics as _metrics
from ..obs import spans as _spans
from ..runtime.supervisor import FAILURE_KINDS
from ..utils.memory import (InputContractError, InvalidConfigError,
                            LaunchBudgetError, classify_fault_text)
from .batching import Batch, DynamicBatcher, Request
from .delta import DeltaOverlay


@dataclasses.dataclass
class Response:
    """One request's outcome (the wire reply, minus serialization)."""

    req_id: int
    ok: bool
    ids: Optional[np.ndarray] = None      # (m, k_req) canonical CURRENT ids
    d2: Optional[np.ndarray] = None
    n_points: Optional[int] = None        # mutations: cloud size after
    error: Optional[str] = None
    failure_kind: Optional[str] = None    # FAILURE_KINDS member when not ok
    arrived_at: float = 0.0
    completed_at: float = 0.0
    # fof requests: canonical per-point cluster labels of the current
    # mutated cloud and the number of clusters
    labels: Optional[np.ndarray] = None
    n_clusters: Optional[int] = None
    # the tenant a fleet front door (serve/fleet) answered for; None on a
    # single-tenant daemon
    tenant: Optional[str] = None
    # the echoed wire trace_id and the span-sourced latency decomposition
    # -- where this request's wall time went (admission -> execution =
    # queue, host batch work = dispatch, the overlay query = device).
    # Query responses only; mutation and FoF acks leave them None.
    trace_id: Optional[str] = None
    queue_ms: Optional[float] = None
    dispatch_ms: Optional[float] = None
    device_ms: Optional[float] = None
    # the fleet's brownout rung this answer was served at ('bf16' |
    # 'recall'; None = exact), and the defer hint a shed or over-quota
    # refusal carries, so a backoff client re-offers the request
    degraded: Optional[str] = None
    retry_after_ms: Optional[float] = None

    @property
    def latency_s(self) -> float:
        return self.completed_at - self.arrived_at

    def to_wire(self) -> dict:
        out: dict = {"id": self.req_id, "ok": self.ok}
        if self.ok and self.ids is not None:
            out["ids"] = self.ids.tolist()
            # RFC 8259 has no Infinity token (json.dumps would emit one a
            # strict parser rejects): pad slots -- id -1 -- carry d2 null
            # on the wire
            out["d2"] = [[float(v) if np.isfinite(v) else None
                          for v in row] for row in self.d2]
        if self.n_points is not None:
            out["n_points"] = self.n_points
        if self.labels is not None:
            out["labels"] = np.asarray(self.labels).tolist()
            out["n_clusters"] = self.n_clusters
        if self.tenant is not None:
            out["tenant"] = self.tenant
        if self.trace_id is not None:
            out["trace_id"] = self.trace_id
        if self.queue_ms is not None:
            out["timing"] = {"queue_ms": self.queue_ms,
                             "dispatch_ms": self.dispatch_ms,
                             "device_ms": self.device_ms}
        if self.degraded is not None:
            out["degraded"] = self.degraded
        if self.retry_after_ms is not None:
            out["retry_after_ms"] = self.retry_after_ms
        if not self.ok:
            out["error"] = self.error
            out["failure_kind"] = self.failure_kind
        return out


def _parse_serve_fault() -> Optional[tuple]:
    spec = os.environ.get("KNTPU_SERVE_FAULT", "")
    if not spec.startswith("batch:"):
        return None
    parts = spec.split(":")
    return int(parts[1]), (parts[2] if len(parts) > 2 else "crash")


class ServeDaemon:
    """Single-threaded serving core: admit / poll / drain.

    The event loop lives in the CALLER (serve/loadgen.py's session runner,
    or the stdio front end in serve/__main__.py): the daemon exposes pure
    state transitions driven by an injected clock, which is what makes the
    batching law unit-testable with synthetic time.
    """

    def __init__(self, problem: KnnProblem,
                 config: Optional[ServeConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.config = config or ServeConfig()
        self.clock = clock
        k_max = int(problem.config.k)
        self.k_serve = (int(self.config.k) if self.config.k is not None
                        else k_max)
        if self.k_serve > k_max:
            raise InvalidConfigError(
                f"serving k={self.k_serve} exceeds the prepared "
                f"k={k_max} that sized the candidate dilation")
        self.overlay = DeltaOverlay(
            problem, compact_threshold=self.config.compact_threshold)
        self.batcher = DynamicBatcher(self.config)
        self.batches_executed = 0
        self.failed_batches = 0
        self.failed_mutations = 0
        self.fof_requests = 0
        self.fof_memo_hits = 0
        self._fof_cache: Optional[tuple] = None  # (version key, FofResult)
        self.refused = 0
        self.failure_kinds: Dict[str, int] = {}
        self.occupancies: List[float] = []
        # bounded latency accounting (obs.metrics.Histogram): total plus
        # the span-sourced queue/dispatch/device decomposition, O(1)
        # memory at any request count
        self.lat_hist = {name: _metrics.Histogram(f"serve.{name}")
                         for name in ("total_ms", "queue_ms",
                                      "dispatch_ms", "device_ms")}
        self._fault = _parse_serve_fault()
        self._compactions_seen = 0
        if self.config.warmup:
            self.warmup()

    @property
    def kernel_route(self) -> str:
        return "cuda" if self.overlay.device.type == "cuda" else "plain"

    # -- warmup ---------------------------------------------------------------

    def warmup(self) -> None:
        """Run one sentinel batch per capacity bucket, so every kernel
        library a batch needs is built and loaded, and every bucket's
        allocations made, before the first real request.  Re-run after
        compaction (a new plan over the mutated cloud)."""
        dom = float(self.overlay.base.grid.domain or DOMAIN_SIZE)
        for cap in self.config.buckets():
            sentinel = np.full((cap, 3), dom / 2.0, np.float32)
            self.overlay.query(sentinel, self.k_serve)

    # -- admission ------------------------------------------------------------

    def submit(self, req_id: int, kind: str, payload, k: Optional[int] = None,
               now: Optional[float] = None,
               trace_id: Optional[str] = None) -> List[Response]:
        """Admit one request.  Queries queue into the batcher (responses
        surface later via poll/drain); mutations are barriers -- the
        pending batch flushes first, then the mutation applies and answers
        immediately.  A contract violation refuses THIS request (typed,
        kind 'invalid-input') and nothing else.  ``trace_id`` is the wire-
        carried correlation id: echoed on the reply, stamped on the
        request's spans."""
        now = self.clock() if now is None else now
        t_admit = _spans.now()
        _spans.event("serve.admit", trace_id=trace_id, kind=kind,
                     req=req_id)
        try:
            payload = validate_request(
                kind, payload, k=k, k_max=self.k_serve,
                n_current=self.overlay.n_points,
                max_batch=self.config.max_batch,
                domain=float(self.overlay.base.grid.domain or DOMAIN_SIZE))
        except InputContractError as e:
            self.refused += 1
            return [Response(req_id=req_id, ok=False, error=str(e),
                             failure_kind=e.kind, arrived_at=now,
                             completed_at=self.clock(),
                             trace_id=trace_id)]
        if kind == "query":
            req = Request(req_id=req_id, queries=payload,
                          k=int(k) if k else self.k_serve, arrived_at=now,
                          trace_id=trace_id, t_perf=t_admit)
            out = []
            for batch in self.batcher.admit(req, now):
                out.extend(self._execute(batch))
            return out
        if kind == "fof":
            # the clustering query family: flush the
            # pending batch first (stream-order consistency with the
            # mutation barrier), then label the CURRENT mutated cloud.
            # Same containment law as batches: a FoF death costs THIS
            # request a typed failure, never the daemon.
            out = []
            barrier = self.batcher.flush("barrier", now)
            if barrier is not None:
                out.extend(self._execute(barrier))
            self.fof_requests += 1
            try:
                res = self._run_fof(float(payload))
            except Exception as e:  # noqa: BLE001 -- containment IS the contract: a FoF solve death becomes one typed failure response, the daemon survives
                fkind = self._classify(e)
                self.failure_kinds[fkind] = \
                    self.failure_kinds.get(fkind, 0) + 1
                out.append(Response(
                    req_id=req_id, ok=False,
                    error=f"fof failed: {type(e).__name__}: {e}",
                    failure_kind=fkind, arrived_at=now,
                    completed_at=self.clock(), trace_id=trace_id))
                return out
            out.append(Response(
                req_id=req_id, ok=True, n_points=self.overlay.n_points,
                labels=res.labels, n_clusters=res.n_clusters,
                arrived_at=now, completed_at=self.clock(),
                trace_id=trace_id))
            return out
        # mutation barrier: queries already pending answer against the
        # pre-mutation cloud (their batch formed first)
        out = []
        barrier = self.batcher.flush("barrier", now)
        if barrier is not None:
            out.extend(self._execute(barrier))
        # same containment law as batches: a mutation whose apply dies
        # (compaction's re-prepare, the post-compaction re-warm) costs THIS
        # request a typed failure, never the daemon.  Overlay state stays
        # consistent either way: compact() swaps its base atomically after
        # the re-prepare succeeds, so a failed apply leaves the previous
        # overlay intact and serving.
        try:
            if kind == "insert":
                self.overlay.insert(payload)
            else:
                self.overlay.delete(payload)
            if self.overlay.stats.compactions and self.config.warmup \
                    and self.overlay.mutations_pending == 0 \
                    and self._compactions_seen \
                    != self.overlay.stats.compactions:
                self._compactions_seen = self.overlay.stats.compactions
                self.warmup()
        except Exception as e:  # noqa: BLE001 -- containment IS the contract: a mutation-apply death becomes one typed failure response, the daemon survives
            fkind = self._classify(e)
            self.failed_mutations += 1
            self.failure_kinds[fkind] = self.failure_kinds.get(fkind, 0) + 1
            out.append(Response(
                req_id=req_id, ok=False,
                error=f"mutation failed: {type(e).__name__}: {e}",
                failure_kind=fkind, arrived_at=now,
                completed_at=self.clock(), trace_id=trace_id))
            return out
        out.append(Response(req_id=req_id, ok=True,
                            n_points=self.overlay.n_points,
                            arrived_at=now, completed_at=self.clock(),
                            trace_id=trace_id))
        return out

    def poll(self, now: Optional[float] = None) -> List[Response]:
        """Deadline-trigger check; the event loop calls this between
        arrivals."""
        now = self.clock() if now is None else now
        batch = self.batcher.poll(now)
        return self._execute(batch) if batch is not None else []

    def drain(self, now: Optional[float] = None) -> List[Response]:
        """Flush whatever is pending (end of stream / EOF)."""
        now = self.clock() if now is None else now
        batch = self.batcher.flush("drain", now)
        return self._execute(batch) if batch is not None else []

    def next_deadline(self) -> Optional[float]:
        return self.batcher.next_deadline()

    # -- execution ------------------------------------------------------------

    @staticmethod
    def _classify(e: BaseException) -> str:
        """Taxonomy kind of a contained failure: the exception's own kind
        stamp when it carries one, else text classification, else
        'crash' -- the same ladder the supervisor's workers use."""
        kind = getattr(e, "kind", None)
        if kind in FAILURE_KINDS:
            return kind
        return classify_fault_text(f"{type(e).__name__}: {e}") or "crash"

    def _run_fof(self, b: float):
        """FoF labels of the current mutated cloud (``cluster/fof.py``) on
        the problem's device, memoized until the next mutation: repeated
        fof requests at the same linking length between mutations answer
        from the memo."""
        from ..cluster.fof import fof_labels

        st = self.overlay.stats
        version = (b, st.inserts, st.deletes, st.compactions)
        # the version key is per overlay: anything that swaps the overlay
        # object itself must call invalidate_fof_memo(), because the new
        # overlay's counters can collide with the old one's
        if self._fof_cache is not None and self._fof_cache[0] == version:
            self.fof_memo_hits += 1
            return self._fof_cache[1]
        # overlay points are already inside the prepared domain (inserts
        # were validated at admission): skip the O(n) re-scan
        res = fof_labels(self.overlay.mutated_points(), b, validate=False,
                         device=self.overlay.device)
        self._fof_cache = (version, res)
        return res

    def invalidate_fof_memo(self) -> None:
        """Drop the FoF memo.  Mutations invalidate it through the
        version key; a caller that swaps the overlay object (a fleet
        failover promotes a replica's overlay) must call this, since the
        new overlay's counters can collide with the old key."""
        self._fof_cache = None

    def _run_batch(self, batch: Batch, idx: int):
        """One padded bucket-capacity launch at the serving k.  Returns
        (ids, d2, device_ms): the device span wraps ONLY the overlay
        launch, so the decomposition's device component excludes the
        host-side padding/slicing work (which lands in dispatch_ms)."""
        if self._fault is not None and idx == self._fault[0]:
            if self._fault[1] == "oom":
                raise LaunchBudgetError(
                    "injected synthetic over-budget serving batch",
                    requested=1 << 40, budget=1 << 30, site="serve-fault")
            raise RuntimeError("injected serving batch fault")
        cap = batch.capacity
        dom = float(self.overlay.base.grid.domain or DOMAIN_SIZE)
        padded = np.full((cap, 3), dom / 2.0, np.float32)
        padded[: batch.total] = batch.queries
        with _spans.span("serve.device", force=True, batch=idx) as dev:
            ids, d2 = self.overlay.query(padded, self.k_serve)
        return ids[: batch.total], d2[: batch.total], round(dev.dur_ms, 4)

    def _queue_ms(self, req: Request, t_exec0: float) -> Optional[float]:
        """Span-sourced queue-wait of one rider: admission (t_perf) to
        batch execution start, on the tracer's real clock."""
        if not req.t_perf:
            return None
        return round(max((t_exec0 - req.t_perf) * 1e3, 0.0), 4)

    def _execute(self, batch: Batch) -> List[Response]:
        """Run one batch with containment: a raise costs every rider of
        THIS batch a typed failure response (kind from the supervisor
        taxonomy) and nothing more -- the daemon's loop state stays
        consistent and the next batch runs fresh.

        Observability: the execute window and the
        device launch are ALWAYS timed (forced spans -- the decomposition
        is a product, not a debug mode); each rider's reply carries
        queue_ms (admission -> execute start), dispatch_ms (host batch
        work around the device call), and device_ms, and when tracing is
        enabled a retrospective ``serve.queue`` span per rider puts the
        wait on the timeline under its trace_id."""
        idx = self.batches_executed
        self.batches_executed += 1
        failed: Optional[BaseException] = None
        ids = d2 = None
        device_ms = 0.0
        with _spans.span("serve.execute", force=True, batch=idx,
                         capacity=batch.capacity, rows=batch.total,
                         reason=batch.reason) as ex:
            try:
                ids, d2, device_ms = self._run_batch(batch, idx)
            except Exception as e:  # noqa: BLE001 -- containment IS the contract: any batch death becomes typed per-request failures, the daemon survives
                failed = e
        dispatch_ms = round(max(ex.dur_ms - device_ms, 0.0), 4)
        if _spans.enabled():
            for r in batch.requests:
                if r.t_perf:
                    _spans.emit("serve.queue", r.t_perf, ex.t0,
                                trace_id=r.trace_id, req=r.req_id,
                                batch=idx)
        if failed is not None:
            kind = self._classify(failed)
            self.failed_batches += 1
            self.failure_kinds[kind] = self.failure_kinds.get(kind, 0) + 1
            done = self.clock()
            return [Response(req_id=r.req_id, ok=False,
                             error=f"batch {idx} failed: "
                                   f"{type(failed).__name__}: {failed}",
                             failure_kind=kind, arrived_at=r.arrived_at,
                             completed_at=done, trace_id=r.trace_id,
                             queue_ms=self._queue_ms(r, ex.t0),
                             dispatch_ms=dispatch_ms,
                             device_ms=device_ms)
                    for r in batch.requests]
        self.occupancies.append(batch.occupancy)
        done = self.clock()
        out = []
        for req, a, b in batch.slices():
            queue_ms = self._queue_ms(req, ex.t0)
            resp = Response(
                req_id=req.req_id, ok=True,
                ids=np.ascontiguousarray(ids[a:b, : req.k]),
                d2=np.ascontiguousarray(d2[a:b, : req.k]),
                arrived_at=req.arrived_at, completed_at=done,
                trace_id=req.trace_id, queue_ms=queue_ms,
                dispatch_ms=dispatch_ms, device_ms=device_ms)
            self.lat_hist["total_ms"].observe(resp.latency_s * 1e3)
            if queue_ms is not None:
                self.lat_hist["queue_ms"].observe(queue_ms)
                self.lat_hist["dispatch_ms"].observe(dispatch_ms)
                self.lat_hist["device_ms"].observe(device_ms)
            out.append(resp)
        return out

    # -- introspection --------------------------------------------------------

    def latency_decomposition(self) -> dict:
        """Per-request latency decomposition at p50/p99 (span-sourced,
        histogram-bounded): where the daemon's wall time goes."""
        return {name: _metrics.percentile_fields(hist)
                for name, hist in self.lat_hist.items()}

    def metrics_snapshot(self) -> dict:
        """The ``metrics`` wire command's document: the unified obs
        snapshot (registry, dispatch counters, kernel counters) plus this
        daemon's own serving counters and latency decomposition."""
        return {**_metrics.metrics_snapshot(),
                "serve": self.stats_dict()}

    def stats_dict(self) -> dict:
        occ = self.occupancies
        return {
            "batches": self.batches_executed,
            "failed_batches": self.failed_batches,
            "failed_mutations": self.failed_mutations,
            "fof_requests": self.fof_requests,
            "fof_memo_hits": self.fof_memo_hits,
            "refused": self.refused,
            # whether batches launch the CUDA class kernels or run their
            # plain torch versions (a CPU problem)
            "kernel_route": self.kernel_route,
            "failure_kinds": dict(self.failure_kinds),
            "flushes": dict(self.batcher.flushes),
            "occupancy_mean": (float(np.mean(occ)) if occ else None),
            "latency_decomposition": self.latency_decomposition(),
            "k_serve": self.k_serve,
            "n_points": self.overlay.n_points,
            **{f"overlay_{k}": v
               for k, v in self.overlay.stats.as_dict().items()},
        }
