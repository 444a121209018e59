"""The serving daemon over the kNN engine.

Counterpart of ``cuda_knearests_tpu/serve/``:

* :mod:`batching` -- dynamic batching: requests coalesce into batches of a
  fixed power-of-two capacity ladder (size- and deadline-triggered flush).
* :mod:`delta` -- incremental insert/delete: a grid-hash delta overlay with
  a dirty-cell pruning bound and threshold-triggered compaction into a full
  re-prepare, answers byte-identical to a rebuild from scratch.
* :mod:`daemon` -- the serving core: typed admission
  (``io.validate_request``), per-batch failure containment mapped onto
  ``runtime.supervisor.FAILURE_KINDS``, an injected-clock event-loop
  surface, friends-of-friends requests.
* :mod:`loadgen` -- the open-loop Poisson load harness and its session
  summary: sustained queries/s, p50/p99/p999 latency, batch occupancy,
  recompiles (kernel builds plus library loads) and class-kernel launches.
* :mod:`fleet` -- many tenants' indexes behind one front door (SLO
  classes, admission and fair scheduling, replication and failover, the
  autoscaler and its brownout ladder); imported on its own.

Every served batch runs ``KnnProblem.query`` on the problem's device: the
class kernels on the GPU, their plain versions on the CPU.
``python -m cuda_knearests_tpu_torch.serve`` runs the daemon.
"""

from __future__ import annotations

from ..config import ServeConfig
from .batching import Batch, DynamicBatcher, Request
from .daemon import Response, ServeDaemon
from .delta import DeltaOverlay
from .loadgen import LoadSpec, build_schedule, run_session

__all__ = ["ServeConfig", "ServeDaemon", "Response", "DeltaOverlay",
           "DynamicBatcher", "Batch", "Request", "LoadSpec",
           "build_schedule", "run_session"]
