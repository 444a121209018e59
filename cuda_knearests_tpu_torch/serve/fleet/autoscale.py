"""Traffic-driven autoscaling and the brownout ladder.

Counterpart of ``cuda_knearests_tpu/serve/fleet/autoscale.py``.  The
fleet's actuators (replica pools with a replication log, live Morton
resharding, the sidecar -> dense -> pod placement ladder) are driven by
:class:`Autoscaler`, a deterministic control loop ticked from
``FleetDaemon.poll`` / ``pump`` on the fleet's injected clock.  Between
"serve exactly" and "serve nothing" it adds a declared brownout ladder:
serve approximately but certified before shedding, and shed with a typed
retry-after hint before dropping.

Sensors, per SLO class, sampled once a tick: queue depth (queued batch
rows plus batcher-pending rows of the class's dense tenants); occupancy
EWMA over the batches executed since the last tick; p999 of the query
latencies observed since the last tick against the class's
``p99_budget_ms`` (windowed, so a class can clear after a flood); the
per-tick delta of typed refusals.

Policy: a class must breach ``breach_streak`` consecutive ticks before an
actuation, every actuation opens a ``cooldown_ticks`` cooldown, and at
most one actuation fires per class per tick.  The breach ladder (first
rung with headroom fires): (1) scale up -- one more in-process replica on
the busiest dense tenant; (2) widen -- a ``force_rebalance`` boundary
move on a pod tenant; (3) promote -- a measured-load dense -> pod
promotion; (4) brown down (brownout classes only) -- every dense tenant
of the class one rung: exact f32 -> bf16 scoring with the exact
refinement -> bf16 at a lowered ``recall_target``, served through the
brute route's bf16 selection kernel (replies carry the rung,
``Response.degraded``); (5) shed -- admission refuses the class's queries
with a ``retry_after_ms`` hint (mutations are never shed).  The clear
ladder recovers first: brown up to exact, then scale down (the victim is
the least caught-up replica; the log compacts only to the remaining
pool's applied floor), then a narrowing boundary move.

Seeded faults (``KNTPU_FLEET_FAULT``): ``stuck-sensor`` freezes the first
sensor sample, ``flap-policy`` bypasses hysteresis and cooldown,
``scale-drop-tail`` compacts the log to the committed head on
scale-down.  Every actuation is recorded to ``utils.prototrace`` under
the ``autoscale`` model, the per-class sensors are a metrics provider
(``fleet_autoscale``), and an actuator that raises has the flight
recorder's tail harvested into ``failures`` before the error propagates.
Pure host code.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from ...obs import metrics as _metrics
from ...obs import recorder as _recorder
from ...utils import prototrace

# wire names of the brownout rungs, in ladder order (Tenant.degraded_tier
# indexes this tuple; tier 0 answers carry no stamp)
TIER_NAMES = ("exact", "bf16", "recall")


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """Knobs of the control loop (all deterministic given the clock).

    Attributes:
      period_s: tick period on the fleet's injected clock.
      breach_streak / clear_streak: hysteresis -- consecutive agreeing
        ticks required before a breach/clear actuation.
      cooldown_ticks: ticks after ANY actuation before the next
        (bounded oscillation).
      max_extra_replicas: per-tenant cap on autoscaler-added replicas
        (scale-down only ever removes what scale-up added).
      queue_high_rows / queue_low_rows: queued-rows breach/clear bands.
      refusal_high: per-tick typed-refusal delta that counts as breach.
      occupancy_high: batch-occupancy EWMA breach threshold.
      p999_factor: budget multiplier on SloClass.p99_budget_ms.
      promote_min_points / promote_load_rows: measured-load dense->pod
        promotion gate (cloud size floor + served rows since last tick).
      brownout_classes: SLO classes allowed down the ladder.
      recall_target: the certified band of the deepest rung.
      max_tier: ladder depth (2 = exact -> bf16 -> recall).
      shed_retry_after_s / shed_window_s: the typed defer hint and how
        long a shed episode lasts.
    """

    period_s: float = 0.02
    breach_streak: int = 2
    clear_streak: int = 3
    cooldown_ticks: int = 2
    max_extra_replicas: int = 1
    queue_high_rows: int = 192
    queue_low_rows: int = 16
    refusal_high: int = 4
    occupancy_high: float = 0.97
    p999_factor: float = 1.0
    promote_min_points: int = 1024
    promote_load_rows: int = 512
    brownout_classes: Tuple[str, ...] = ("throughput",)
    recall_target: float = 0.9
    max_tier: int = 2
    shed_retry_after_s: float = 0.05
    shed_window_s: float = 0.1


class _ClassState:
    """Per-SLO-class policy state (streaks, cooldown, ladder position)."""

    __slots__ = ("breach_streak", "clear_streak", "cooldown", "tier",
                 "actions", "last_refused", "last_served", "occ_ewma")

    def __init__(self) -> None:
        self.breach_streak = 0
        self.clear_streak = 0
        self.cooldown = 0
        self.tier = 0
        self.actions = 0
        self.last_refused = 0
        self.last_served = 0
        self.occ_ewma = 0.0


class Autoscaler:
    """The control loop.  Owned by :class:`~.frontdoor.FleetDaemon` when
    constructed with an ``autoscale=`` config; ``tick(now)`` is called
    from every ``poll``/``pump`` pass and is a no-op until the period
    elapses, so existing event loops drive the policy for free."""

    def __init__(self, fleet, config: Optional[AutoscaleConfig] = None):
        self.fleet = fleet
        self.config = config or AutoscaleConfig()
        self.classes: Dict[str, _ClassState] = {}
        self.counters = {k: 0 for k in (
            "ticks", "scale_up", "scale_down", "widen", "narrow",
            "promote", "brown_down", "brown_up", "shed",
            "actuation_failures")}
        self.events: Deque[dict] = deque(maxlen=1024)
        self.failures: List[dict] = []
        self.added: Dict[str, int] = {}      # replicas added per tenant
        self.shed_until: Dict[str, float] = {}
        self.last_sensors: Dict[str, dict] = {}
        self._next_tick: Optional[float] = None
        self._log_seen = 0
        self._frozen: Optional[Dict[str, dict]] = None  # stuck-sensor
        self.class_hist: Dict[str, _metrics.Histogram] = {}
        self._window: Dict[str, List[float]] = {}  # latencies since tick
        _metrics.REGISTRY.register_provider("fleet_autoscale",
                                            self._provider)

    # -- sensors --------------------------------------------------------------

    def observe(self, slo: str, responses) -> None:
        """Front-door hook: bin every executed query response's total
        latency into the class histogram (the p999 sensor's source)."""
        hist = self.class_hist.get(slo)
        if hist is None:
            hist = self.class_hist[slo] = _metrics.Histogram(
                f"fleet.{slo}.total_ms")
        win = self._window.setdefault(slo, [])
        for r in responses:
            if r.ok and r.ids is not None:
                hist.observe(r.latency_s * 1e3)
                win.append(r.latency_s * 1e3)

    def _provider(self) -> dict:
        """The ``fleet_autoscale`` metrics provider: per-class sensor
        gauges (queue depth, occupancy EWMA, refusal rate, p999) plus
        the ladder position -- the policy's full input, inspectable over
        the ``metrics`` wire op."""
        out = {}
        for cls in sorted(self.classes):
            st = self.classes[cls]
            s = self.last_sensors.get(cls, {})
            hist = self.class_hist.get(cls)
            out[cls] = {
                "queue_rows": s.get("queue_rows", 0),
                "occupancy_ewma": round(st.occ_ewma, 4),
                "refusal_delta": s.get("refused_delta", 0),
                "p999_ms": (hist.percentile(0.999)
                            if hist is not None else None),
                "tier": st.tier,
                "tier_name": TIER_NAMES[min(st.tier,
                                            len(TIER_NAMES) - 1)],
                "breach_streak": st.breach_streak,
                "cooldown": st.cooldown,
                "actions": st.actions,
            }
        return out

    def _class_tenants(self, cls: str):
        return [t for t in self.fleet.tenants.values()
                if t.spec.slo == cls]

    def _state(self, cls: str) -> _ClassState:
        st = self.classes.get(cls)
        if st is None:
            st = self.classes[cls] = _ClassState()
        return st

    def _sense(self, now: float) -> Dict[str, dict]:
        """One sensor sample per SLO class.  The seeded ``stuck-sensor``
        fault freezes the first sample forever: the policy then reads
        stale truth and never reacts (the --autoscale smoke's liveness
        check catches it)."""
        if self.fleet._fault == "stuck-sensor" and self._frozen is not None:
            return self._frozen
        fresh = list(self.fleet.batch_log)[
            max(0, len(self.fleet.batch_log)
                - (self.fleet.n_batches - self._log_seen)):]
        self._log_seen = self.fleet.n_batches
        out: Dict[str, dict] = {}
        for cls in sorted({t.spec.slo for t in
                           self.fleet.tenants.values()}):
            st = self._state(cls)
            tenants = self._class_tenants(cls)
            queue_rows = sum(
                sum(b.total for b in t.ready)
                + t.daemon.batcher.pending_queries
                for t in tenants if t.daemon is not None)
            refused = sum(self.fleet.refused.get(t.spec.name, 0)
                          for t in tenants)
            served = sum(self.fleet.served_rows.get(t.spec.name, 0)
                         for t in tenants)
            occs = [e["rows"] / e["capacity"] for e in fresh
                    if e["slo"] == cls and e["capacity"]]
            if occs:
                st.occ_ewma = (0.8 * st.occ_ewma
                               + 0.2 * sum(occs) / len(occs))
            # windowed p999: only the latencies observed since the last
            # tick vote -- an idle/recovered class reads None and can
            # clear (recovery liveness; the cumulative class_hist keeps
            # the whole-session tail for the metrics provider)
            win = self._window.pop(cls, None)
            p999 = (sorted(win)[int(0.999 * (len(win) - 1))]
                    if win else None)
            budget = (tenants[0].spec.slo_class.p99_budget_ms
                      * self.config.p999_factor)
            refused_delta = refused - st.last_refused
            served_delta = served - st.last_served
            st.last_refused, st.last_served = refused, served
            breach = (queue_rows >= self.config.queue_high_rows
                      or refused_delta >= self.config.refusal_high
                      or st.occ_ewma >= self.config.occupancy_high
                      or (p999 is not None and p999 > budget))
            clear = (queue_rows <= self.config.queue_low_rows
                     and refused_delta == 0
                     and (p999 is None or p999 <= budget))
            out[cls] = {"queue_rows": queue_rows,
                        "refused_delta": refused_delta,
                        "served_delta": served_delta,
                        "p999_ms": p999, "breach": breach,
                        "clear": clear}
        self.last_sensors = out
        if self.fleet._fault == "stuck-sensor":
            self._frozen = out
        return out

    # -- the loop -------------------------------------------------------------

    def tick(self, now: float) -> List[dict]:
        """One pass of the control loop; returns the actuation events it
        fired (empty until the period elapses)."""
        if self._next_tick is None:
            self._next_tick = now + self.config.period_s
            return []
        if now < self._next_tick:
            return []
        self._next_tick = now + self.config.period_s
        self.counters["ticks"] += 1
        prototrace.record("autoscale", "tick")
        flap = self.fleet._fault == "flap-policy"
        need_b = 1 if flap else self.config.breach_streak
        need_c = 1 if flap else self.config.clear_streak
        fired: List[dict] = []
        sensors = self._sense(now)
        for cls, s in sensors.items():
            st = self._state(cls)
            if s["breach"]:
                st.breach_streak += 1
                st.clear_streak = 0
            elif s["clear"]:
                st.clear_streak += 1
                st.breach_streak = 0
            else:
                st.breach_streak = 0
                st.clear_streak = 0
            ready = flap or st.cooldown == 0
            ev = None
            if ready and st.breach_streak >= need_b:
                ev = self._act_breach(cls, st, s, now)
            elif ready and st.clear_streak >= need_c:
                ev = self._act_clear(cls, st, now)
            if ev is not None:
                st.cooldown = self.config.cooldown_ticks
                st.breach_streak = 0
                st.clear_streak = 0
                st.actions += 1
                ev.update({"class": cls, "at": round(now, 6),
                           "tick": self.counters["ticks"]})
                self.events.append(ev)
                fired.append(ev)
            elif st.cooldown > 0:
                st.cooldown -= 1
        return fired

    def _fire(self, action: str, cls: str, tenant: Optional[str],
              thunk) -> bool:
        """Run one actuator with the failure-forensics contract: a raise
        harvests the flight-recorder tail into ``failures`` (the
        post-mortem of a policy-actuated migration/scale failure), then
        propagates -- a policy bug must surface, never vanish."""
        try:
            ok = bool(thunk())
        except Exception as e:  # noqa: BLE001 -- harvest-and-reraise, not a swallow
            self.counters["actuation_failures"] += 1
            self.failures.append({
                "action": action, "class": cls, "tenant": tenant,
                "error": str(e),
                "flight_tail": _recorder.FLIGHT.tail(32)})
            raise
        if ok:
            self.counters[action] += 1
            if action == "shed":
                # the other actions trace at their tenant-level sites
                # (tenants.add_replica / remove_replica / brown_*);
                # widen, narrow and promote trace inside pod/reshard.py
                prototrace.record("autoscale", "shed")
        return ok

    def _act_breach(self, cls: str, st: _ClassState, sensors: dict,
                    now: float) -> Optional[dict]:
        """The breach ladder: provision first, degrade second, shed
        last.  One rung per tick."""
        cfg = self.config
        dense = [t for t in self._class_tenants(cls)
                 if t.daemon is not None]
        dense.sort(key=lambda t: self.fleet.served_rows.get(
            t.spec.name, 0), reverse=True)
        # 1. replica scale-up
        for t in dense:
            name = t.spec.name
            if self.added.get(name, 0) >= cfg.max_extra_replicas:
                continue
            if self._fire("scale_up", cls, name, t.add_replica):
                self.added[name] = self.added.get(name, 0) + 1
                return {"action": "scale_up", "tenant": name,
                        "replicas": len(t.replica_pool)}
        # 2. pod shard widening: a boundary move toward the hot range
        for t in self._class_tenants(cls):
            if not t.is_pod or t.elastic.migration is not None:
                continue
            if self._fire("widen", cls, t.spec.name,
                          t.elastic.force_rebalance):
                return {"action": "widen", "tenant": t.spec.name}
        # 3. measured-load dense -> pod promotion
        for t in dense:
            if (t.n_points >= cfg.promote_min_points
                    and sensors["served_delta"] >= cfg.promote_load_rows):
                name = t.spec.name
                if self._fire("promote", cls, name,
                              lambda t=t: self._promote(t, now)):
                    self.added.pop(name, None)
                    return {"action": "promote", "tenant": name,
                            "n_points": t.n_points}
        # 4. brownout: step the class one rung down the ladder
        if cls in cfg.brownout_classes and st.tier < cfg.max_tier \
                and dense:
            for t in dense:
                self._fire("brown_down", cls, t.spec.name,
                           lambda t=t: t.brown_down(
                               recall_target=cfg.recall_target,
                               max_tier=cfg.max_tier) > 0)
            st.tier = min(st.tier + 1, cfg.max_tier)
            return {"action": "brown_down", "tier": st.tier,
                    "tier_name": TIER_NAMES[st.tier]}
        # 5. shed with a typed retry-after hint
        self.shed_until[cls] = now + cfg.shed_window_s
        self._fire("shed", cls, None, lambda: True)
        return {"action": "shed",
                "retry_after_ms": round(cfg.shed_retry_after_s * 1e3, 3)}

    def _act_clear(self, cls: str, st: _ClassState,
                   now: float) -> Optional[dict]:
        """The clear ladder: ALWAYS recover the exact tier before
        de-provisioning."""
        self.shed_until.pop(cls, None)
        dense = [t for t in self._class_tenants(cls)
                 if t.daemon is not None]
        # 1. brown up toward exact
        if st.tier > 0:
            for t in dense:
                if t.degraded_tier > 0:
                    self._fire("brown_up", cls, t.spec.name,
                               lambda t=t: t.brown_up() >= 0)
            st.tier -= 1
            return {"action": "brown_up", "tier": st.tier,
                    "tier_name": TIER_NAMES[st.tier]}
        # 2. scale down what scale-up added (safe log compaction)
        for t in dense:
            name = t.spec.name
            if self.added.get(name, 0) <= 0:
                continue
            res: List[dict] = []
            if self._fire(
                    "scale_down", cls, name,
                    lambda t=t, res=res: res.append(
                        t.remove_replica(
                            unsafe_compact=self.fleet._fault
                            == "scale-drop-tail")) or res[-1] is not None):
                self.added[name] -= 1
                if self.added[name] <= 0:
                    self.added.pop(name, None)
                return {"action": "scale_down", "tenant": name, **res[-1]}
        # 3. narrowing boundary move on a still-skewed pod tenant
        for t in self._class_tenants(cls):
            if not t.is_pod or t.elastic.migration is not None:
                continue
            if self._fire("narrow", cls, t.spec.name,
                          t.elastic.force_rebalance):
                return {"action": "narrow", "tenant": t.spec.name}
        return None

    def _promote(self, t, now: float) -> bool:
        """Promotion actuator: drain the tenant's queued work first (the
        batches reference the dense daemon this promotion retires), then
        force the pod rung.  A promoted tenant re-provisions at the
        exact tier -- the pod placement serves exact scatter-gather, so
        carrying a stale brownout stamp would misreport it."""
        self.fleet._drain_tenant(t, now)
        ok = t.maybe_promote_to_pod(force=True)
        if ok:
            t.degraded_tier = 0
            t.degraded_recall = 1.0
        return ok

    # -- admission hook -------------------------------------------------------

    def shed_hint(self, t, now: float) -> Optional[float]:
        """None, or the retry-after seconds a QUERY for this tenant's
        class should be refused with right now (the ladder's floor)."""
        until = self.shed_until.get(t.spec.slo)
        if until is not None and now < until:
            return self.config.shed_retry_after_s
        return None

    # -- introspection --------------------------------------------------------

    def stats_dict(self) -> dict:
        return {
            **{k: v for k, v in self.counters.items()},
            "classes": self._provider(),
            "added": dict(self.added),
            "events": list(self.events),
            "failures": list(self.failures),
        }
