"""Measured-cost autotuner: race the launch-plan space on the device a
problem runs on, persist the winners, resolve them back into configs.

Counterpart of ``cuda_knearests_tpu/tune/``.  Two halves:

* :mod:`~cuda_knearests_tpu_torch.tune.store` -- the schema-versioned
  tuned-plan store: winners keyed by (device kind, problem signature),
  LRU-bounded (``KNTPU_TUNE_CACHE_CAP``), persisted as one JSON file
  (``KNTPU_TUNE_STORE``) that refuses a stale schema instead of silently
  diffing it.  The device kind is that of the device the problem runs on:
  ``'cpu'``, or the CUDA card's name.
* :mod:`~cuda_knearests_tpu_torch.tune.search` -- the searcher: candidate
  plans (scorer x precision x query_chunk) measured on the brute route
  against device time under a ``torch.profiler`` capture
  (``obs/device.profile_window``) and wall time otherwise, provenance
  stamped (``objective_source``), with the sync budget asserted per trial
  (``sync_bound_ok``).

Resolution happens through one seam, ``config.resolve_tuned``, which the
single-device, sharded and pod prepares call; a second search of the same
signature hits the store and races nothing.

CLI: ``python -m cuda_knearests_tpu_torch.tune --n 20000 --k 10 --rt 0.9
--store plans.json [--device cpu]``.
"""

from .search import candidate_plans, measure_plan, search  # noqa: F401
from .store import (STORE_ENV, StaleTuneStoreError, TunedPlanStore,  # noqa: F401
                    get_default_store, lookup_plan, plan_signature,
                    set_default_store)
