"""The fleet front door: many tenants, one wire, one scheduling law.

Counterpart of ``cuda_knearests_tpu/serve/fleet/frontdoor.py``.
``FleetDaemon`` multiplexes several prepared indexes (tenants) behind one
request surface, all on one device (default: the GPU).  A request goes:

1. **Admission** -- one ``io.validate_request`` call with the tenant
   field: an unknown tenant, an over-quota request (the token bucket's
   verdict), a k above the tenant's and the whole points / ids contract
   all refuse typed here, before anything queues.
2. **Placement** -- sidecar tenants answer synchronously from the host
   brute worker; pod tenants from their elastic index; dense tenants
   enter their own dynamic batcher (SLO-class flush triggers) on the
   shared bucket ladder.
3. **Scheduling** -- flushed batches queue per tenant and execute in
   deficit-round-robin order (``admission.py``), each dispatch stamped
   with its fairness accounting.  Mutations and FoF stay barriers within
   their tenant; they do not barrier other tenants.
4. **Replication** -- a mutation the primary applied commits to the
   tenant's replication log and ships to its replicas (``tenants.py``);
   ``failover()`` promotes a caught-up replica.

A tenant on a brownout rung (``autoscale.py``) has its batches served by
``mxu.solve.solve_general(..., scorer='mxu', precision='bf16')`` on its
device: the bf16 selection kernel on the card.

Fault injection (``KNTPU_FLEET_FAULT=cross-tenant|drop-delta|
stale-replica|torn-migration|lost-range``, plus the autoscaler's
``stuck-sensor|flap-policy|scale-drop-tail``) seeds the fleet's
corruptions: answering one tenant's query against another tenant's
cloud, dropping a committed delta from the log, promoting a stale
replica without the re-ship, tearing the last committed record out of a
pod tenant's migration handover, and flipping a migration's range cut
while the receiver applies nothing (``pod/reshard.Migration.handover``).
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...config import DOMAIN_SIZE, ServeFleetConfig
from ...io import validate_request
from ...obs import metrics as _metrics
from ...obs import spans as _spans
from ...runtime import dispatch as _dispatch
from ...utils import prototrace
from ...utils.platform import resolve_device
from ...utils.memory import (InputContractError, InvalidConfigError,
                             InvalidRequestError, OverQuotaError)
from ..batching import Batch, Request
from ..daemon import Response
from .admission import DrrScheduler, TokenBucket
from .autoscale import AutoscaleConfig, Autoscaler
from .tenants import Tenant, TenantSpec

FLEET_FAULTS = ("cross-tenant", "drop-delta", "stale-replica",
                "torn-migration", "lost-range",
                # the autoscaler's (autoscale.py): a frozen sensor
                # sample, hysteresis and cooldown bypassed, an unsafe log
                # compaction on scale-down
                "stuck-sensor", "flap-policy", "scale-drop-tail")


def _parse_fleet_fault() -> Optional[str]:
    fault = os.environ.get("KNTPU_FLEET_FAULT", "")
    if not fault:
        return None
    if fault not in FLEET_FAULTS:
        raise InvalidConfigError(
            f"unknown KNTPU_FLEET_FAULT {fault!r}: expected one of "
            f"{FLEET_FAULTS}")
    return fault


def _rows_estimate(kind: str, payload) -> int:
    """Best-effort admission cost (query/mutation rows) BEFORE validation;
    malformed payloads cost one token and then refuse typed."""
    if kind == "fof":
        return 1
    try:
        return max(1, int(np.asarray(payload).shape[0]))
    except Exception:  # noqa: BLE001 -- unparseable payloads refuse typed downstream; admission just needs a nonzero cost
        return 1


class FleetDaemon:
    """Single-threaded fleet core: admit / poll / pump / drain.

    The same injected-clock design as the single-tenant daemon: the event
    loop lives in the caller (the fleet loadgen), so the scheduling and
    fairness laws are testable with synthetic time.  Every dense and pod
    tenant prepares on ``device`` (default: the GPU; no GPU and no
    ``device`` -> ``NoDeviceError``).
    """

    def __init__(self, builds: Sequence[Tuple[TenantSpec, np.ndarray]],
                 config: Optional[ServeFleetConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 autoscale: Optional[AutoscaleConfig] = None, *,
                 device=None):
        self.config = config or ServeFleetConfig()
        self.clock = clock
        self.device = resolve_device(device)
        self.tenants: Dict[str, Tenant] = {}
        self.quota: Dict[str, TokenBucket] = {}
        self.drr = DrrScheduler(self.config.drr_quantum)
        self.refused: Dict[str, int] = {}
        self.served_rows: Dict[str, int] = {}
        # recent-window batch accounting (bounded: the fleet is long-lived
        # by design, a per-batch list would grow without bound) plus the
        # forever counter the stats report
        self.batch_log: Deque[dict] = deque(maxlen=4096)
        self.n_batches = 0
        self._fault = _parse_fleet_fault()
        now = self.clock()
        for spec, points in builds:
            if spec.name in self.tenants:
                raise InvalidConfigError(
                    f"duplicate tenant name {spec.name!r} in the fleet "
                    f"build list")
            t = Tenant(spec, points, self.config, self.clock,
                       device=self.device)
            if t.is_pod and self._fault in ("torn-migration",
                                            "lost-range"):
                t.elastic.fault = self._fault
            self.tenants[spec.name] = t
            self.quota[spec.name] = TokenBucket(
                spec.quota_qps if spec.quota_qps is not None
                else self.config.quota_qps,
                spec.quota_burst if spec.quota_burst is not None
                else self.config.quota_burst, now=now)
            self.drr.register(spec.name)
            self.refused[spec.name] = 0
            self.served_rows[spec.name] = 0
        # the sensor -> policy -> actuator loop; None = no autoscaling
        self.autoscaler: Optional[Autoscaler] = (
            Autoscaler(self, autoscale) if autoscale is not None else None)
        if self.autoscaler is not None and self.config.warmup:
            # the brownout rungs run the brute route at bf16: load what it
            # launches now, so a rung taken mid-session loads nothing
            from ...mxu.solve import warm

            warm("bf16", self.device)

    # -- admission + routing --------------------------------------------------

    def _refusal(self, req_id, tenant, e: InputContractError,
                 now: float, trace_id: Optional[str] = None,
                 retry_after_s: Optional[float] = None) -> List[Response]:
        self.refused[tenant] = self.refused.get(tenant, 0) + 1
        if retry_after_s is None and isinstance(e, OverQuotaError):
            # a quota refusal is load-shaped, not malformed: tell the
            # caller WHEN the bucket will admit this cost again so a
            # backoff client defers instead of losing the request
            bucket = self.quota.get(tenant)
            if bucket is not None:
                retry_after_s = bucket.retry_after_s(
                    getattr(e, "rows", 1) or 1, now)
        return [Response(req_id=req_id, ok=False, error=str(e),
                         failure_kind=e.kind, arrived_at=now,
                         completed_at=self.clock(), tenant=tenant,
                         trace_id=trace_id,
                         retry_after_ms=(None if retry_after_s is None
                                         else round(retry_after_s * 1e3,
                                                    4)))]

    def submit(self, req_id: int, tenant: str, kind: str, payload,
               k: Optional[int] = None, now: Optional[float] = None,
               trace_id: Optional[str] = None) -> List[Response]:
        """Admit one tenant-addressed request.  Query responses may
        surface later (poll/pump) or now (size-trigger flush); sidecar
        tenants, mutations, and FoF answer synchronously.  Responses from
        OTHER requests whose batches this submission flushed ride along,
        exactly like the single-tenant daemon."""
        now = self.clock() if now is None else now
        t = self.tenants.get(tenant)
        quota_ok = None
        if t is not None:
            quota_ok = self.quota[tenant].try_take(
                _rows_estimate(kind, payload), now)
        try:
            payload = validate_request(
                kind, payload, k=k,
                k_max=t.spec.k if t is not None else None,
                n_current=t.n_points if t is not None else None,
                max_batch=self._max_batch(t),
                domain=self._domain(t),
                tenant=tenant, tenants=tuple(self.tenants),
                quota_ok=quota_ok)
        except InputContractError as e:
            retry = None
            if isinstance(e, OverQuotaError):
                retry = self.quota[tenant].retry_after_s(
                    _rows_estimate(kind, payload), now)
            return self._refusal(req_id, tenant, e, now, trace_id,
                                 retry_after_s=retry)
        if kind == "query" and self.autoscaler is not None:
            shed = self.autoscaler.shed_hint(t, now)
            if shed is not None:
                # the brownout ladder's floor: admission refuses QUERIES
                # typed with a defer hint (mutations are never shed --
                # zero lost committed mutations stays a law)
                return self._refusal(
                    req_id, tenant,
                    OverQuotaError(
                        f"tenant {tenant!r}: query shed by the autoscale "
                        f"brownout ladder (class "
                        f"{t.spec.slo!r} at ladder floor); retry after "
                        f"{shed * 1e3:.1f} ms"),
                    now, trace_id, retry_after_s=shed)
        if kind == "query" and self._fault == "cross-tenant" \
                and len(self.tenants) > 1:
            return self._cross_tenant_fault(req_id, tenant, payload, k, now)
        if t.is_sidecar:
            return self._submit_sidecar(req_id, t, kind, payload, k, now,
                                        trace_id)
        if t.is_pod:
            return self._submit_pod(req_id, t, kind, payload, k, now,
                                    trace_id)
        return self._submit_dense(req_id, t, kind, payload, k, now,
                                  trace_id)

    def _domain(self, t: Optional[Tenant]) -> float:
        if t is None or t.is_sidecar or t.daemon is None:
            return DOMAIN_SIZE
        return float(t.daemon.overlay.base.grid.domain or DOMAIN_SIZE)

    def _max_batch(self, t: Optional[Tenant]) -> int:
        """The tenant's admittable query-batch cap.  Dense tenants refuse
        at their SLO class's ladder depth -- their batcher's bucket_for
        would raise (untyped) past it -- sidecar tenants at the
        fleet-global cap."""
        if t is None or t.is_sidecar or t.daemon is None:
            return self.config.max_batch
        return int(t.daemon.config.max_batch)

    def _cross_tenant_fault(self, req_id, tenant, payload, k,
                            now) -> List[Response]:
        """Seeded fault: answer against the NEXT tenant's cloud while
        stamping the requested tenant -- the isolation violation the fleet
        fuzz campaign must catch."""
        names = list(self.tenants)
        other = self.tenants[names[(names.index(tenant) + 1) % len(names)]]
        kq = min(int(k) if k else self.tenants[tenant].spec.k,
                 other.spec.k)
        if other.is_sidecar:
            ids, d2 = other.sidecar.query(payload, kq)
        elif other.is_pod:
            ids, d2 = other.elastic.query(payload, kq)
        else:
            ids, d2 = other.daemon.overlay.query(payload, kq)
        want_k = int(k) if k else self.tenants[tenant].spec.k
        m = payload.shape[0]
        out_i = np.full((m, want_k), -1, np.int32)
        out_d = np.full((m, want_k), np.inf, np.float32)
        kk = min(want_k, ids.shape[1])
        out_i[:, :kk] = np.asarray(ids)[:, :kk]
        out_d[:, :kk] = np.asarray(d2)[:, :kk]
        return [Response(req_id=req_id, ok=True, ids=out_i, d2=out_d,
                         arrived_at=now, completed_at=self.clock(),
                         tenant=tenant)]

    def _submit_sidecar(self, req_id, t: Tenant, kind, payload, k,
                        now, trace_id=None) -> List[Response]:
        name = t.spec.name
        if kind == "query":
            kq = int(k) if k else t.spec.k
            # sidecar answers synchronously: no batcher queue and no
            # batch formation, so queue and dispatch are zero BY
            # CONSTRUCTION and the whole wall cost is the CPU worker
            # call (the 'device' of this placement)
            with _spans.span("serve.sidecar", force=True, tenant=name,
                             trace_id=trace_id) as dev_sp:
                ids, d2 = t.sidecar.query(payload, kq)
            self.served_rows[name] += payload.shape[0]
            return [Response(req_id=req_id, ok=True, ids=ids, d2=d2,
                             arrived_at=now, completed_at=self.clock(),
                             tenant=name, trace_id=trace_id,
                             queue_ms=0.0, dispatch_ms=0.0,
                             device_ms=round(dev_sp.dur_ms, 4))]
        if kind == "fof":
            res = t.sidecar.fof(float(payload))
            return [Response(req_id=req_id, ok=True,
                             n_points=t.n_points, labels=res.labels,
                             n_clusters=res.n_clusters, arrived_at=now,
                             completed_at=self.clock(), tenant=name)]
        if kind == "insert":
            t.sidecar.insert(payload)
        else:
            t.sidecar.delete(payload)
        t.maybe_promote_from_sidecar()
        return [Response(req_id=req_id, ok=True, n_points=t.n_points,
                         arrived_at=now, completed_at=self.clock(),
                         tenant=name)]

    def _submit_pod(self, req_id, t: Tenant, kind, payload, k,
                    now, trace_id=None) -> List[Response]:
        """Pod-placement request path: synchronous like the sidecar (the
        elastic index is its own scatter-gather scheduler), with a device
        span so the latency decomposition keeps working.  Mutations
        commit to the tenant's log and then give the mutation-driven
        rebalance trigger one look."""
        name = t.spec.name
        if kind == "query":
            kq = int(k) if k else t.spec.k
            with _spans.span("serve.pod", force=True, tenant=name,
                             trace_id=trace_id) as dev_sp:
                ids, d2 = t.elastic.query(payload, kq)
            self.served_rows[name] += payload.shape[0]
            # one migration step rides every query: resharding progresses
            # UNDER traffic, never as a stop-the-world drain
            t.elastic.pump()
            return [Response(req_id=req_id, ok=True, ids=ids, d2=d2,
                             arrived_at=now, completed_at=self.clock(),
                             tenant=name, trace_id=trace_id,
                             queue_ms=0.0, dispatch_ms=0.0,
                             device_ms=round(dev_sp.dur_ms, 4))]
        if kind == "fof":
            return self._refusal(
                req_id, name,
                InvalidRequestError(
                    f"tenant {name!r}: fof is not served from the pod "
                    f"placement (scatter-gather kNN only; run fof "
                    f"against a dense tenant)"),
                now, trace_id)
        with _spans.span("serve.pod.mutate", force=True, tenant=name,
                         kind=kind):
            if kind == "insert":
                t.elastic.insert(payload)
            else:
                t.elastic.delete(payload)
        t.commit_mutation(kind, payload,
                          drop_from_log=self._fault == "drop-delta")
        t.elastic.maybe_rebalance()
        t.elastic.pump()
        return [Response(req_id=req_id, ok=True, n_points=t.n_points,
                         arrived_at=now, completed_at=self.clock(),
                         tenant=name, trace_id=trace_id)]

    def _submit_dense(self, req_id, t: Tenant, kind, payload, k,
                      now, trace_id=None) -> List[Response]:
        name = t.spec.name
        if kind == "query":
            req = Request(req_id=req_id, queries=payload,
                          k=int(k) if k else t.spec.k, arrived_at=now,
                          trace_id=trace_id, t_perf=_spans.now())
            for batch in t.daemon.batcher.admit(req, now):
                t.ready.append(batch)
                prototrace.record("drr-admission", "enqueue")
            return self.pump(now)
        # mutation / fof barriers: THIS tenant's already-flushed batches
        # execute first (they formed first -- per-tenant stream order),
        # then its still-pending queries flush and execute through the
        # fleet's own accounting (otherwise the daemon's internal barrier
        # flush would run them outside batch_log/served_rows), then the
        # daemon's barrier machinery runs the request with its containment
        # law.  Other tenants are not barriered.
        out = self._execute_ready(t)
        pending = t.daemon.batcher.flush("barrier", now)
        if pending is not None:
            t.ready.append(pending)
            prototrace.record("drr-admission", "enqueue")
            out.extend(self._execute_ready(t))
        responses = t.daemon.submit(req_id, kind, payload, k=k, now=now,
                                    trace_id=trace_id)
        for r in responses:
            r.tenant = name
        out.extend(responses)
        if kind in ("insert", "delete") and responses \
                and responses[-1].ok:
            t.commit_mutation(kind, payload,
                              drop_from_log=self._fault == "drop-delta")
            # the barrier above drained this tenant's queues, so a dense
            # tenant that grew past pod_threshold can promote here
            t.maybe_promote_to_pod()
        return out

    # -- scheduling -----------------------------------------------------------

    def _run_batch(self, t: Tenant, batch: Batch,
                   accounting: Optional[dict] = None) -> List[Response]:
        if t.degraded_tier > 0:
            responses = self._execute_degraded(t, batch)
        else:
            responses = t.daemon._execute(batch)
        name = t.spec.name
        for r in responses:
            r.tenant = name
            if r.ok and r.ids is not None:
                self.served_rows[name] += r.ids.shape[0]
        self.batch_log.append({
            "tenant": name, "rows": batch.total,
            "capacity": batch.capacity, "reason": batch.reason,
            "slo": t.spec.slo,
            **(accounting or {})})
        self.n_batches += 1
        if self.autoscaler is not None:
            self.autoscaler.observe(t.spec.slo, responses)
        return responses

    def _execute_degraded(self, t: Tenant, batch: Batch) -> List[Response]:
        """Serve one batch at the tenant's brownout tier through the brute
        route on the tenant's device: tier 1 scores in bf16 with the exact
        refinement (ids still exact), tier 2 at the lowered recall target
        (certified-approximate).  On the card that is the bf16 selection
        kernel (``csrc/mxu_select_bf16.cu``); its library is loaded before
        a session by the warmup of the tiers, so degraded batches add no
        recompile.  Mutations never reach this path (they are barriers
        through the daemon), so the overlay state, and with it the
        post-recovery byte identity, does not depend on the tier.  The
        dense executor's containment law: a raise costs this batch's
        riders typed failures, nothing more."""
        from ...mxu.solve import solve_general

        tier_name = t.degraded_tier_name
        kmax = max(r.k for r in batch.requests)
        failed: Optional[BaseException] = None
        res = None
        with _spans.span("serve.degraded", force=True,
                         tenant=t.spec.name, tier=tier_name,
                         rows=batch.total) as ex:
            try:
                res = solve_general(
                    t.daemon.overlay.mutated_points(), k=kmax,
                    recall_target=t.degraded_recall,
                    refine="brute" if t.degraded_tier == 1 else "none",
                    queries=batch.queries, scorer="mxu",
                    precision="bf16", device=t.device)
            except Exception as e:  # noqa: BLE001 -- containment is the contract, as ServeDaemon._execute
                failed = e
        done = self.clock()
        if failed is not None:
            kind = t.daemon._classify(failed)
            t.daemon.failed_batches += 1
            t.daemon.failure_kinds[kind] = \
                t.daemon.failure_kinds.get(kind, 0) + 1
            return [Response(req_id=r.req_id, ok=False,
                             error=f"degraded batch failed: "
                                   f"{type(failed).__name__}: {failed}",
                             failure_kind=kind, arrived_at=r.arrived_at,
                             completed_at=done, trace_id=r.trace_id)
                    for r in batch.requests]
        t.daemon.batches_executed += 1
        t.daemon.occupancies.append(batch.occupancy)
        out = []
        for req, a, b in batch.slices():
            out.append(Response(
                req_id=req.req_id, ok=True,
                ids=np.ascontiguousarray(res.neighbors[a:b, :req.k]),
                d2=np.ascontiguousarray(res.dists_sq[a:b, :req.k]),
                arrived_at=req.arrived_at, completed_at=done,
                trace_id=req.trace_id,
                queue_ms=t.daemon._queue_ms(req, ex.t0),
                dispatch_ms=0.0, device_ms=round(ex.dur_ms, 4),
                degraded=tier_name))
        return out

    def _drain_tenant(self, t: Tenant, now: float) -> List[Response]:
        """Drain ONE dense tenant completely (ready queue + pending
        batcher work) through the fleet's own accounting -- the
        autoscaler's promotion actuator needs the dense daemon idle
        before it swaps the placement out from under it."""
        out = self._execute_ready(t)
        if t.daemon is not None:
            batch = t.daemon.batcher.flush("drain", now)
            if batch is not None:
                t.ready.append(batch)
                prototrace.record("drr-admission", "enqueue")
                out.extend(self._execute_ready(t))
        return out

    def _execute_ready(self, t: Tenant) -> List[Response]:
        """Drain ONE tenant's ready queue in FIFO order (the mutation
        barrier path -- DRR does not reorder within a tenant anyway)."""
        out: List[Response] = []
        while t.ready:
            out.extend(self._run_batch(t, t.ready.popleft(),
                                       {"barrier": True}))
        return out

    def pump(self, now: Optional[float] = None) -> List[Response]:
        """Execute every ready batch in deficit-round-robin order; each
        dispatch's fairness accounting (deficit after, backlog snapshot)
        is stamped into the per-batch stats.  The autoscaler (when
        configured) ticks here as well as in poll: a saturated open
        loop spends its passes in submit -> pump, and the policy must
        keep sensing exactly when the fleet is busiest (period-gated,
        so the extra call sites cost one comparison)."""
        if self.autoscaler is not None and now is not None:
            self.autoscaler.tick(now)
        ready = {name: t.ready for name, t in self.tenants.items()
                 if t.daemon is not None}
        if any(q for q in ready.values()):
            prototrace.record("drr-admission", "rotate")
        out: List[Response] = []
        for name, batch, disp in self.drr.select(ready):
            out.extend(self._run_batch(
                self.tenants[name], batch,
                {"deficit_after": disp.deficit_after,
                 "backlog": list(disp.backlog)}))
        for t in self.tenants.values():
            if t.is_pod:
                t.elastic.pump()
        return out

    def poll(self, now: Optional[float] = None) -> List[Response]:
        """Deadline-trigger check across every dense tenant, then pump.
        The autoscaler (when configured) ticks here -- the same injected
        clock that drives the batching law drives the policy."""
        now = self.clock() if now is None else now
        if self.autoscaler is not None:
            self.autoscaler.tick(now)
        for t in self.tenants.values():
            if t.daemon is None:
                continue
            batch = t.daemon.batcher.poll(now)
            if batch is not None:
                t.ready.append(batch)
                prototrace.record("drr-admission", "enqueue")
        return self.pump(now)

    def drain(self, now: Optional[float] = None) -> List[Response]:
        now = self.clock() if now is None else now
        for t in self.tenants.values():
            if t.daemon is None:
                continue
            batch = t.daemon.batcher.flush("drain", now)
            if batch is not None:
                t.ready.append(batch)
                prototrace.record("drr-admission", "enqueue")
        return self.pump(now)

    def next_deadline(self) -> Optional[float]:
        deadlines = [t.daemon.next_deadline()
                     for t in self.tenants.values()
                     if t.daemon is not None]
        deadlines = [d for d in deadlines if d is not None]
        return min(deadlines) if deadlines else None

    # -- failover -------------------------------------------------------------

    def failover(self, tenant: str) -> dict:
        """Kill the named tenant's primary overlay state and promote its
        most-caught-up replica (tenants.Tenant.failover; the seeded
        stale-replica fault skips the re-ship)."""
        return self.tenants[tenant].failover(
            skip_reship=self._fault == "stale-replica")

    # -- introspection --------------------------------------------------------

    def metrics_snapshot(self) -> dict:
        """The fleet's ``metrics`` document: the unified obs snapshot
        plus the fleet's own scheduling/fairness/tenant counters and the
        per-tenant latency decomposition (span-sourced)."""
        return {
            **_metrics.metrics_snapshot(),
            "fleet": self.stats_dict(),
            "latency_decomposition": {
                name: t.daemon.latency_decomposition()
                for name, t in self.tenants.items()
                if not t.is_sidecar and t.daemon is not None},
        }

    def stats_dict(self) -> dict:
        return {
            "tenants": {name: {**t.stats_dict(),
                               **self.quota[name].stats_dict(),
                               "refused": self.refused[name],
                               "served_rows": self.served_rows[name]}
                        for name, t in self.tenants.items()},
            "fleet_batches": self.n_batches,
            **self.drr.stats_dict(),
            **_dispatch.kernel_stats(),
            **({"autoscale": self.autoscaler.stats_dict()}
               if self.autoscaler is not None else {}),
        }
