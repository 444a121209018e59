"""The serving fleet: a multi-tenant, replicated serving tier.

Counterpart of ``cuda_knearests_tpu/serve/fleet/``: many indexes behind one
front door, on one device.

* :mod:`tenants` -- the tenant model: per-tenant prepared problem, SLO
  class, quota, replication factor; dense tenants on the shared bucket
  ladder, tiny or degenerate tenants on the host sidecar, large ones on
  an elastic pod index.
* :mod:`admission` -- token-bucket admission (typed over-quota refusals)
  and deficit-round-robin scheduling with per-dispatch fairness stamps.
* :mod:`replica` -- the replication log, in-process and child-process
  replicas, and the SIGKILL-tolerant failover controller.
* :mod:`sidecar` -- the brute host worker for tiny tenants.
* :mod:`frontdoor` -- the FleetDaemon multiplexing all of it behind one
  request surface.
* :mod:`autoscale` -- the sensor -> policy -> actuator loop and the
  brownout ladder (exact -> bf16 -> lowered recall).
* :mod:`loadgen` -- the multi-tenant open-loop harness (per-tenant
  percentiles, Jain fairness, SLO verdicts, the window's kernel counters).
* :mod:`elastic` -- mesh failover for pod tenants: checksummed
  snapshots, primary and standby meshes as child processes, and the
  mid-migration SIGKILL drill (imported on its own, as in the
  reference).

``python -m cuda_knearests_tpu_torch.serve.fleet`` runs a mixed-SLO fleet
session (``--failover-smoke``: the process-level failover proof;
``--autoscale``: the autoscale and brownout smoke).
"""

from __future__ import annotations

from ...config import SLO_CLASSES, ServeFleetConfig, SloClass
from .admission import DrrScheduler, TokenBucket, jain_index
from .autoscale import TIER_NAMES, AutoscaleConfig, Autoscaler
from .frontdoor import FLEET_FAULTS, FleetDaemon
from .loadgen import (TenantLoad, build_fleet_schedule,
                      default_fleet_builds, run_fleet_session)
from .replica import (DeltaRecord, FailoverController, Replica,
                      ReplicaProcess, ReplicationLog, failover_drill,
                      replay_on_host)
from .sidecar import CpuSidecar
from .tenants import Tenant, TenantSpec

__all__ = ["SLO_CLASSES", "ServeFleetConfig", "SloClass", "DrrScheduler",
           "TokenBucket", "jain_index", "TIER_NAMES", "AutoscaleConfig",
           "Autoscaler", "FLEET_FAULTS", "FleetDaemon",
           "TenantLoad", "build_fleet_schedule", "default_fleet_builds",
           "run_fleet_session", "DeltaRecord", "FailoverController",
           "Replica", "ReplicaProcess", "ReplicationLog", "failover_drill",
           "replay_on_host", "CpuSidecar", "Tenant", "TenantSpec"]
