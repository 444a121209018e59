"""Admission control and fairness scheduling of the serving fleet.

Counterpart of ``cuda_knearests_tpu/serve/fleet/admission.py``.  Two
mechanisms, at two time scales:

* **Token-bucket admission** (:class:`TokenBucket`) refuses over-quota
  load at the front door, per tenant, before anything queues: the bucket
  refills at ``rate`` query rows per second up to ``burst``, and a request
  whose row count it cannot cover is refused typed
  (``utils.memory.OverQuotaError`` through ``io.validate_request``).
  Refusal, not queueing: queue depth would let one tenant spend the
  fleet's latency budget unseen.
* **Deficit round robin** (:class:`DrrScheduler`) orders the tenants'
  flushed batches: each round adds one ``quantum`` of query rows to every
  backlogged tenant's deficit and runs that tenant's batches while the
  deficit covers them.  Over any window in which a set of tenants stays
  backlogged, the rows served to any two of them differ by at most one
  quantum plus one batch, so a flooding tenant cannot starve the others.
  Every dispatch is stamped with its tenant, the deficit left and the
  queue depths it was scheduled against.

Pure host bookkeeping with no clock of its own (callers pass ``now``), so
it is testable with synthetic time; ``utils.prototrace`` records its
``drr-admission`` actions at the front door's call sites.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple


class TokenBucket:
    """A token bucket over query rows; ``rate=None`` is unmetered."""

    def __init__(self, rate: Optional[float], burst: float,
                 now: float = 0.0):
        self.rate = None if rate is None else float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._last = float(now)
        self.refusals = 0
        self.admitted_rows = 0

    def _refill(self, now: float) -> None:
        if self.rate is None:
            return
        dt = max(0.0, now - self._last)
        self._last = now
        self.tokens = min(self.burst, self.tokens + dt * self.rate)

    def try_take(self, rows: int, now: float) -> bool:
        """Spend ``rows`` tokens if the bucket holds them; False = over
        quota (the caller refuses typed).  An unmetered bucket admits
        everything."""
        # proto: drr-admission.enqueue -- admission is where work enters a queue
        if self.rate is None:
            self.admitted_rows += int(rows)
            return True
        self._refill(now)
        if self.tokens >= rows:
            self.tokens -= rows
            self.admitted_rows += int(rows)
            return True
        self.refusals += 1
        return False

    def retry_after_s(self, rows: int, now: float) -> Optional[float]:
        """Seconds until ``rows`` tokens are available: the defer hint a
        refusal carries on the wire.  None on an unmetered bucket (its
        refusals are not quota-shaped)."""
        if self.rate is None:
            return None
        self._refill(now)
        deficit = min(float(rows), self.burst) - self.tokens
        return max(0.0, deficit / self.rate)

    def stats_dict(self) -> dict:
        return {"quota_qps": self.rate, "quota_burst": self.burst,
                "quota_refusals": self.refusals,
                "admitted_rows": self.admitted_rows}


@dataclasses.dataclass(frozen=True)
class DrrDispatch:
    """One scheduling decision: whose batch ran, and the fairness
    accounting at that moment (stamped into the per-batch stats)."""

    tenant: str
    rows: int
    deficit_after: float
    backlog: Tuple[Tuple[str, int], ...]   # (tenant, queued rows)


RECENT_DISPATCH_CAP = 4096   # bounded window of a long-lived fleet


class DrrScheduler:
    """Deficit round robin over per-tenant queues of ready batches.

    The scheduler owns the deficits and the rotation pointer; the front
    door owns the queues (it appends flushed batches and runs what
    :meth:`select` returns, in order).  A tenant whose queue empties has
    its deficit reset to zero, so an idle tenant banks no credit.
    ``dispatches`` keeps the recent window only; ``n_dispatches`` counts
    every one.
    """

    def __init__(self, quantum: int):
        self.quantum = max(1, int(quantum))
        self.deficit: Dict[str, float] = {}
        self._order: List[str] = []
        self._next = 0
        self.dispatches: Deque[DrrDispatch] = deque(
            maxlen=RECENT_DISPATCH_CAP)
        self.n_dispatches = 0
        self.served_rows: Dict[str, int] = {}

    def register(self, tenant: str) -> None:
        if tenant not in self.deficit:
            self.deficit[tenant] = 0.0
            self.served_rows[tenant] = 0
            self._order.append(tenant)

    def select(self, ready: Dict[str, "Deque"]
               ) -> List[Tuple[str, object, DrrDispatch]]:
        """Drain the ready queues completely, in DRR order; the returned
        (tenant, batch, accounting) list is the execution order.  Each
        rotation adds one quantum to every backlogged tenant, so a head
        batch of B rows runs within ceil(B / quantum) rotations of
        reaching the head: the drain ends and no batch starves."""
        # proto: drr-admission.rotate
        out: List[Tuple[str, object, DrrDispatch]] = []
        if not self._order:
            return out
        # the rotation bound uses the biggest batch anywhere in the
        # queues: a deep batch behind a cheap head needs its own full
        # budget once it surfaces; the guard turns a broken invariant
        # into a loud error
        biggest = max((b.total for q in ready.values() for b in q),
                      default=1)
        max_rotations = 2 + sum(len(q) for q in ready.values()) * (
            1 + biggest // self.quantum + 1)
        rotations = 0
        while any(q for q in ready.values()):
            rotations += 1
            if rotations > max_rotations:
                raise RuntimeError(
                    f"DRR failed to drain in {max_rotations} rotations "
                    f"(quantum={self.quantum}): scheduler invariant broken")
            start = self._next
            for off in range(len(self._order)):
                idx = (start + off) % len(self._order)
                name = self._order[idx]
                queue = ready.get(name)
                if not queue:
                    self.deficit[name] = 0.0
                    continue
                self.deficit[name] += self.quantum
                while queue and queue[0].total <= self.deficit[name]:
                    batch = queue.popleft()
                    self.deficit[name] -= batch.total
                    self.served_rows[name] += batch.total
                    disp = DrrDispatch(
                        tenant=name, rows=batch.total,
                        deficit_after=self.deficit[name],
                        backlog=tuple(
                            (t, sum(b.total for b in q))
                            for t, q in sorted(ready.items()) if q))
                    self.dispatches.append(disp)
                    self.n_dispatches += 1
                    out.append((name, batch, disp))
                if not queue:
                    self.deficit[name] = 0.0
                self._next = (idx + 1) % len(self._order)
        return out

    def stats_dict(self) -> dict:
        return {"drr_quantum": self.quantum,
                "drr_dispatches": self.n_dispatches,
                "served_rows": dict(self.served_rows)}


def jain_index(values: List[float]) -> Optional[float]:
    """Jain's fairness index over per-tenant normalized throughput,
    (sum x)^2 / (n * sum x^2): 1.0 is perfectly fair, 1/n one tenant
    took everything.  None when there is nothing to measure."""
    xs = [float(v) for v in values if v is not None]
    if not xs or all(x == 0.0 for x in xs):
        return None
    s, s2 = sum(xs), sum(x * x for x in xs)
    return round((s * s) / (len(xs) * s2), 6)
