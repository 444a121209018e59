"""Dynamic batching: coalesce a request stream into capacity-bucketed
batches.

Counterpart of ``cuda_knearests_tpu/serve/batching.py``.  The batching law:
a flush happens when EITHER

  * admitting the next request would exceed ``max_batch`` queries (size
    trigger, the throughput side), or
  * the oldest pending request has waited ``max_delay_s`` (deadline
    trigger, the latency side),

and the flushed batch pads to the next power-of-two capacity bucket in
``[min_bucket, max_batch]``.  The bucket ladder is fixed, so the batch
shapes a serving session runs form a finite set that the daemon's warmup
covers before the first request.

Mutations are not batched: a mutation request is a barrier (the daemon
flushes pending queries first, then applies it), so every query is
answered against the cloud as it stood when its batch flushed -- a total
order the rebuild-from-scratch oracle can replay.

Pure host bookkeeping, with no clock of its own (the daemon passes
``now``), so the flush law is testable with synthetic time.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..config import ServeConfig


@dataclasses.dataclass
class Request:
    """One admitted (already validated) query request."""

    req_id: int
    queries: np.ndarray          # (m, 3) f32, validated
    k: int                       # <= serving k; columns truncate on reply
    arrived_at: float            # open-loop arrival time (latency anchor)
    # the wire-carried trace id (echoed on the reply, stamped on the
    # request's spans) and the real-clock admission timestamp
    # (obs.spans.now()) the queue-wait component of the latency
    # decomposition is measured from -- arrived_at may be synthetic
    # (injected clocks), t_perf never is
    trace_id: Optional[str] = None
    t_perf: float = 0.0


@dataclasses.dataclass
class Batch:
    """One flushed batch, ready for the executor."""

    requests: List[Request]
    queries: np.ndarray          # (total, 3) concatenated in arrival order
    capacity: int                # the bucket the executor pads to
    reason: str                  # 'size' | 'deadline' | 'barrier' | 'drain'
    formed_at: float

    @property
    def total(self) -> int:
        return int(self.queries.shape[0])

    @property
    def occupancy(self) -> float:
        return self.total / self.capacity

    def slices(self):
        """(request, row_start, row_stop) per rider, in arrival order."""
        at = 0
        for r in self.requests:
            yield r, at, at + r.queries.shape[0]
            at += r.queries.shape[0]


class DynamicBatcher:
    """Accumulates admitted requests until a flush trigger fires."""

    def __init__(self, config: ServeConfig):
        self.config = config
        self._pending: List[Request] = []
        self._total = 0
        self.flushes = {"size": 0, "deadline": 0, "barrier": 0, "drain": 0}

    @property
    def pending_queries(self) -> int:
        return self._total

    def admit(self, request: Request, now: float) -> List[Batch]:
        """Queue one request; returns the batches the size trigger flushed
        (0, 1, or -- when a max-width request lands on a non-empty queue --
        2).  A flushed batch never exceeds max_batch queries."""
        out = []
        if self._total + request.queries.shape[0] > self.config.max_batch:
            b = self.flush("size", now)
            if b is not None:
                out.append(b)
        self._pending.append(request)
        self._total += request.queries.shape[0]
        if self._total >= self.config.max_batch:
            # exactly full (or a single max-width request): flush eagerly
            b = self.flush("size", now)
            if b is not None:
                out.append(b)
        return out

    def poll(self, now: float) -> Optional[Batch]:
        """Deadline trigger: flush when the oldest rider has waited out
        max_delay_s."""
        if self._pending and \
                now - self._pending[0].arrived_at >= self.config.max_delay_s:
            return self.flush("deadline", now)
        return None

    def next_deadline(self) -> Optional[float]:
        """Absolute time the deadline trigger will fire, or None when
        empty (the daemon sleeps until min(next arrival, this))."""
        if not self._pending:
            return None
        return self._pending[0].arrived_at + self.config.max_delay_s

    def flush(self, reason: str, now: float) -> Optional[Batch]:
        """Unconditional flush (mutation barriers and final drain call this
        directly)."""
        if not self._pending:
            return None
        reqs, self._pending = self._pending, []
        total, self._total = self._total, 0
        self.flushes[reason] = self.flushes.get(reason, 0) + 1
        return Batch(requests=reqs,
                     queries=np.concatenate([r.queries for r in reqs]),
                     capacity=self.config.bucket_for(total),
                     reason=reason, formed_at=now)
