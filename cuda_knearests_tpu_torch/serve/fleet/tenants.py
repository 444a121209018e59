"""The tenant model: one prepared index and its serving state per tenant.

Counterpart of ``cuda_knearests_tpu/serve/fleet/tenants.py``.  A tenant is
the fleet's unit of isolation and accounting: its own cloud, serving k,
SLO class, quota and replication factor, multiplexed with every other
tenant onto one process (one bucket ladder, one DRR scheduler) and one
device.  Three placements:

* **Dense** (default): a ``KnnProblem`` prepared with
  ``KnnConfig(k, adaptive=False)`` on the fleet's device behind a
  ``ServeDaemon`` (mutation overlay, dynamic batcher, containment), its
  ServeConfig derived from the tenant's SLO class on the shared ladder
  (``ServeFleetConfig.serve_config_for``).  Its queries take the legacy
  query route (``ops/query.query_knn``), whose class kernel launches in
  mode (b) on the card.
* **Sidecar**: clouds under ``sidecar_threshold`` (or smaller than k) are
  served by the host brute worker (``sidecar.py``): no prepare, no
  batching, synchronous answers.  A sidecar tenant whose cloud grows past
  the threshold is promoted to a dense placement at the mutation that
  crossed it (one prepare of the same cloud).
* **Pod** (``ServeFleetConfig.pod_threshold``): clouds at or above the
  threshold serve from an elastic index (``pod/reshard.ElasticIndex``):
  Morton-range shards, scatter-gather queries, live boundary migration
  when mutations skew the shards.  The same canonical-id mutation
  contract as the dense overlay, so admission and commit are shared; a
  pod tenant always keeps a replication log.  A dense tenant that grows
  past the threshold is promoted at the mutation that crossed it.

Replication (dense tenants with ``replicas > 0``): committed mutations
append to the tenant's :class:`~.replica.ReplicationLog` and ship to
in-process :class:`~.replica.Replica` overlays over the same base
problem.  ``ship_mode='sync'`` applies each record as it commits,
``'lazy'`` defers everything to failover's re-ship; both end at the same
byte-identical state.  ``failover()`` promotes the most caught-up replica
into the primary slot and drops the daemon's FoF memo (the overlay
object changed).  The brownout ladder (``autoscale.py``) steps a dense
tenant's ``degraded_tier``.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional

import numpy as np

from ...api import KnnProblem
from ...config import SLO_CLASSES, KnnConfig, ServeFleetConfig, SloClass
from ...pod.reshard import ElasticIndex, _kernel_recompiles
from ...utils import prototrace
from ...utils.memory import InvalidConfigError, TransportError
from ..daemon import ServeDaemon
from .replica import Replica, ReplicationLog
from .sidecar import CpuSidecar


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """Regenerable identity of one tenant.

    Attributes:
      name: wire name (the request's 'tenant' field).
      k: the tenant's serving k (a request's smaller k truncates columns).
      slo: SLO class name (``config.SLO_CLASSES``): 'latency' or
        'throughput'.
      quota_qps / quota_burst: token-bucket overrides (None: the fleet's
        defaults; quota_qps None there is unmetered).
      replicas: in-process replica count (0 = unreplicated).
      ship_mode: 'sync' ships each committed record at once; 'lazy'
        defers to failover's re-ship.
    """

    name: str
    k: int = 10
    slo: str = "throughput"
    quota_qps: Optional[float] = None
    quota_burst: Optional[float] = None
    replicas: int = 0
    ship_mode: str = "sync"

    def __post_init__(self):
        if self.slo not in SLO_CLASSES:
            raise InvalidConfigError(
                f"tenant {self.name!r}: unknown SLO class {self.slo!r} "
                f"(expected one of {tuple(SLO_CLASSES)})")
        if self.ship_mode not in ("sync", "lazy"):
            raise InvalidConfigError(
                f"tenant {self.name!r}: unknown ship_mode "
                f"{self.ship_mode!r} (expected 'sync' or 'lazy')")
        if self.k < 1:
            raise InvalidConfigError(
                f"tenant {self.name!r}: serving k must be >= 1, "
                f"got {self.k}")

    @property
    def slo_class(self) -> SloClass:
        return SLO_CLASSES[self.slo]

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "TenantSpec":
        return cls(**d)


class Tenant:
    """One tenant's runtime state inside the fleet front door.  Dense and
    pod placements prepare on ``device`` (a ``torch.device``, resolved by
    the front door)."""

    def __init__(self, spec: TenantSpec, points: np.ndarray,
                 fleet: ServeFleetConfig, clock, *, device):
        self.spec = spec
        self.fleet = fleet
        self.clock = clock
        self.device = device
        self.ready: Deque = deque()      # flushed batches awaiting DRR
        self.daemon: Optional[ServeDaemon] = None
        self.sidecar: Optional[CpuSidecar] = None
        self.elastic: Optional[ElasticIndex] = None
        self.log: Optional[ReplicationLog] = None
        self.replica_pool: List[Replica] = []
        self.promotions = 0
        self.failovers = 0
        # the brownout rung (autoscale.py): 0 exact f32, 1 bf16 scoring
        # with the exact refinement (ids still exact), 2 bf16 at a lowered
        # recall_target (certified-approximate); answers above 0 carry
        # the rung's name on the wire ('degraded')
        self.degraded_tier = 0
        self.degraded_recall = 1.0
        points = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
        if self._wants_sidecar(points.shape[0]):
            self.sidecar = CpuSidecar(points, spec.k)
        elif self._wants_pod(points.shape[0]):
            self._build_elastic(points)
        else:
            self._build_dense(points)

    # -- placement ------------------------------------------------------------

    def _wants_sidecar(self, n: int) -> bool:
        return n < self.fleet.sidecar_threshold or n < self.spec.k

    def _wants_pod(self, n: int) -> bool:
        return (self.fleet.pod_threshold is not None
                and n >= self.fleet.pod_threshold)

    def _prepare(self, points: np.ndarray) -> KnnProblem:
        return KnnProblem.prepare(
            points, KnnConfig(k=self.spec.k, adaptive=False),
            device=self.device)

    def _build_dense(self, points: np.ndarray) -> None:
        problem = self._prepare(points)
        self.daemon = ServeDaemon(
            problem, self.fleet.serve_config_for(self.spec.slo_class),
            clock=self.clock)
        if self.spec.replicas > 0:
            self.log = ReplicationLog()
            self.replica_pool = [
                Replica(problem,
                        compact_threshold=self.fleet.compact_threshold)
                for _ in range(self.spec.replicas)]

    def _build_elastic(self, points: np.ndarray) -> None:
        """The pod rung.  A pod tenant always keeps a replication log.
        Every kernel build and library load of the construction counts
        as the new index's ``elastic_recompiles``: a promotion in the
        middle of a session (the autoscaler's measured-load actuator) is
        index work, not a serving-path recompile."""
        m0 = _kernel_recompiles()
        self.elastic = ElasticIndex(
            points, k=self.spec.k, nshards=self.fleet.pod_shards,
            compact_threshold=self.fleet.compact_threshold,
            skew_threshold=self.fleet.pod_skew_threshold,
            device=self.device)
        # the index counted its shard builds itself; the whole window is
        # attributable, so the counter takes the window's total
        self.elastic.elastic_recompiles = _kernel_recompiles() - m0
        self.log = ReplicationLog()

    def maybe_promote_from_sidecar(self) -> bool:
        """Promote a grown sidecar tenant to the dense (or pod) placement:
        one prepare of the same cloud; canonical ids are kept, since both
        placements index alike.  Returns True when it promoted."""
        if self.sidecar is None or self._wants_sidecar(
                self.sidecar.n_points):
            return False
        points = self.sidecar.mutated_points()
        self.sidecar = None
        if self._wants_pod(points.shape[0]):
            self._build_elastic(points)
        else:
            self._build_dense(points)
        self.promotions += 1
        return True

    def maybe_promote_to_pod(self, *, force: bool = False) -> bool:
        """Promote a dense tenant whose cloud grew past ``pod_threshold``
        to the elastic placement (the same canonical cloud and ids).  The
        replication log carries over.  ``force=True`` is the autoscaler's
        measured-load trigger; its caller drains this tenant's queued
        batches first."""
        if self.daemon is None or (not force
                                   and not self._wants_pod(self.n_points)):
            return False
        points = self.daemon.overlay.mutated_points()
        log = self.log
        self.daemon = None
        self.replica_pool = []
        self._build_elastic(points)
        if log is not None:
            self.log = log
        self.promotions += 1
        return True

    # -- state ----------------------------------------------------------------

    @property
    def is_sidecar(self) -> bool:
        return self.sidecar is not None

    @property
    def is_pod(self) -> bool:
        return self.elastic is not None

    @property
    def n_points(self) -> int:
        if self.sidecar is not None:
            return self.sidecar.n_points
        if self.elastic is not None:
            return self.elastic.n_points
        return self.daemon.overlay.n_points

    def mutated_points(self) -> np.ndarray:
        """The tenant's current cloud in canonical order (its rebuild
        oracle's input)."""
        if self.sidecar is not None:
            return self.sidecar.mutated_points()
        if self.elastic is not None:
            return self.elastic.mutated_points()
        return self.daemon.overlay.mutated_points()

    # -- replication ----------------------------------------------------------

    def commit_mutation(self, kind: str, payload, *,
                        drop_from_log: bool = False) -> None:
        """Record one mutation the primary already applied: the record
        enters the log (the commit), then ships to the replicas under
        ship_mode='sync'.  ``drop_from_log`` is the seeded drop-delta
        fault's hook: a committed delta that never reaches the log."""
        if self.log is None or drop_from_log:
            return
        prototrace.record("replication-commit", "apply")
        rec = self.log.append(kind, np.asarray(payload))
        prototrace.record("replication-commit", "append")
        if self.spec.ship_mode == "sync":
            for rep in self.replica_pool:
                rep.apply(rec)
                prototrace.record("replication-commit", "ship")

    # -- elastic replication and brownout (autoscale.py) ----------------------

    def add_replica(self) -> bool:
        """Provision one more in-process replica (the autoscaler's
        scale-up actuator).  It starts from a prepare of the current cloud
        on the tenant's device and is stamped caught up at today's
        committed seq, which holds even when the tenant never logged or
        the primary overlay compacted its base; from then on the
        committed tail ships to it as to any replica."""
        if self.daemon is None:
            return False
        if self.log is None:
            self.log = ReplicationLog()
        problem = self._prepare(self.daemon.overlay.mutated_points())
        rep = Replica(problem,
                      compact_threshold=self.fleet.compact_threshold)
        rep.applied_seq = self.log.committed_seq
        self.replica_pool.append(rep)
        prototrace.record("autoscale", "scale_up")
        return True

    def remove_replica(self, *, unsafe_compact: bool = False
                       ) -> Optional[dict]:
        """De-provision one replica (the autoscaler's scale-down
        actuator); None at or below the spec's provisioned count (the
        policy removes only what it added).  The victim is the least
        caught-up replica, and the log then compacts only to the
        remaining pool's applied floor: a compaction past a survivor's
        applied seq would make the next failover's re-ship tail
        unrecoverable.  ``unsafe_compact`` is the seeded scale-drop-tail
        fault's hook (compact to the committed head regardless)."""
        if self.daemon is None \
                or len(self.replica_pool) <= self.spec.replicas:
            return None
        target = min(self.replica_pool, key=lambda r: r.applied_seq)
        self.replica_pool.remove(target)
        floor = min((r.applied_seq for r in self.replica_pool),
                    default=0)
        dropped = 0
        if self.log is not None:
            dropped = self.log.compact(
                self.log.committed_seq if unsafe_compact else floor)
        prototrace.record("autoscale", "scale_down")
        return {"tenant": self.spec.name,
                "victim_seq": target.applied_seq,
                "compacted": dropped,
                "remaining_replicas": len(self.replica_pool)}

    @property
    def degraded_tier_name(self) -> Optional[str]:
        """Wire name of the current brownout rung (None at exact)."""
        if self.degraded_tier <= 0:
            return None
        return "bf16" if self.degraded_tier == 1 else "recall"

    def brown_down(self, *, recall_target: float = 0.9,
                   max_tier: int = 2) -> int:
        """Step one rung down the ladder: exact f32 -> bf16 scoring with
        the exact refinement -> bf16 at ``recall_target``."""
        if self.degraded_tier < max_tier:
            self.degraded_tier += 1
            self.degraded_recall = (1.0 if self.degraded_tier == 1
                                    else float(recall_target))
            prototrace.record("autoscale", "brown_down")
        return self.degraded_tier

    def brown_up(self) -> int:
        """Step one rung back up; at tier 0 the tenant serves exactly as
        one that was never degraded."""
        if self.degraded_tier > 0:
            self.degraded_tier -= 1
            self.degraded_recall = (1.0 if self.degraded_tier <= 1
                                    else self.degraded_recall)
            prototrace.record("autoscale", "brown_up")
        return self.degraded_tier

    def failover(self, *, skip_reship: bool = False) -> dict:
        """Drop the primary overlay and promote the most caught-up
        replica: re-ship its committed tail from the log, swap its
        overlay into the daemon, drop the FoF memo.  ``skip_reship`` is
        the seeded stale-replica fault's hook.  Raises TransportError
        when there is no replica to promote."""
        if self.daemon is None or not self.replica_pool:
            raise TransportError(
                f"tenant {self.spec.name!r}: failover impossible "
                f"(replicas={len(self.replica_pool)})")
        target = max(self.replica_pool, key=lambda r: r.applied_seq)
        replayed = 0
        if not skip_reship:
            for rec in self.log.since(target.applied_seq):
                target.apply(rec)
                prototrace.record("replication-commit", "ship")
                replayed += 1
        self.replica_pool.remove(target)
        self.daemon.overlay = target.overlay
        self.daemon.invalidate_fof_memo()
        self.failovers += 1
        prototrace.record("replication-commit", "failover")
        return {"tenant": self.spec.name, "replayed": replayed,
                "committed_seq": self.log.committed_seq,
                "remaining_replicas": len(self.replica_pool)}

    # -- introspection --------------------------------------------------------

    def stats_dict(self) -> dict:
        base = {"slo": self.spec.slo, "k": self.spec.k,
                "n_points": self.n_points,
                "replicas": len(self.replica_pool),
                "committed_seq": (self.log.committed_seq
                                  if self.log is not None else 0),
                "failovers": self.failovers,
                "promotions": self.promotions,
                "degraded_tier": self.degraded_tier}
        if self.sidecar is not None:
            base.update(self.sidecar.stats_dict())
        elif self.elastic is not None:
            base["sidecar"] = False
            base["pod"] = True
            base.update(self.elastic.stats_dict())
        else:
            base["sidecar"] = False
            base["batches"] = self.daemon.batches_executed
            base["failed_batches"] = self.daemon.failed_batches
            base["occupancies"] = len(self.daemon.occupancies)
        return base
