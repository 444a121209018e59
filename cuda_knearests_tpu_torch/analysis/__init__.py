"""The port's analysis engines: typed findings and the protocol models.

Counterpart of ``cuda_knearests_tpu/analysis/``, in part:

* :mod:`.findings` -- the typed finding record and the
  zero-findings-vs-baseline gate (this package ships no baseline yet, so
  the gate is at its strictest).
* :mod:`.models` -- the declared protocol models (replication commit,
  migration handover, mesh snapshot and replay, DRR admission, autoscale):
  exhaustive small-scope state machines, their known-violating mutants,
  and the runtime-trace conformance the fleet and chaos campaigns stamp.
* :mod:`.proto` -- the protocol engine: every model explored with a crash
  at every state, and the ``# proto:`` annotations of this package's
  fleet and pod reconciled against the models (:func:`run_proto`).

Host-only: nothing here imports torch or touches a device.
"""

from .findings import (ANALYSIS_VERSION, BASELINE_SCHEMA, Finding,
                       analysis_stamp, baseline_hash, diff_vs_baseline,
                       equivalence_hash, load_baseline, save_baseline)

__all__ = [
    "ANALYSIS_VERSION",
    "BASELINE_SCHEMA",
    "Finding",
    "analysis_stamp",
    "baseline_hash",
    "diff_vs_baseline",
    "equivalence_hash",
    "load_baseline",
    "run_proto",
    "save_baseline",
]


def run_proto(fault=None):
    from .proto import run_proto as _rp

    return _rp(fault=fault)
