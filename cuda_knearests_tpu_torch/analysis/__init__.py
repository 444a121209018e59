"""kntpu-check on the port: contracts + lint + dataflow verifier + protocol
models.

Counterpart of ``cuda_knearests_tpu/analysis/``.  Four engines gate every
solve route of the port before it touches a card:

* :mod:`.contracts` -- the contract checker: runs the adaptive, legacy-pack,
  external-query, sharded, pod and MXU routes' device halves on the CPU
  (the kernels' plain versions) over a (k, supercell) matrix and checks
  shape/dtype invariants, scatter-vs-gather byte equality, the byte models,
  shared-memory tiles and launch-record stability, with no CUDA context and
  no kernel launch (:func:`run_contracts`).
* :mod:`.lint` + :mod:`.rules` (+ :mod:`.concurrency`) -- the AST hazard
  lint (pluggable rule registry): compiled-function leaks, silent dtype
  widening, readbacks and device allocations in host loops, unmarked broad
  excepts, bare timing, and the concurrency discipline (:func:`run_lint`).
* :mod:`.verify` (+ :mod:`.syncflow`, :mod:`.equiv`) -- kntpu-verify: the
  per-route host-sync budget proven from the ``# syncflow:`` annotated
  dispatch sites and the static call graph, launch keys stable across
  data, and the cross-route equivalence certificates over the wrappers'
  launch records (the committed ``equivalence.json``; :func:`run_verify`).
* :mod:`.proto` (+ :mod:`.models`) -- kntpu-proto: the declared fleet
  protocols explored exhaustively with a crash at every state, and the
  ``# proto:`` annotations reconciled against them (:func:`run_proto`).

One command runs all four: ``python -m cuda_knearests_tpu_torch.analysis``
(:mod:`.cli`).  The gate is zero-findings-vs-baseline (:mod:`.findings`,
the committed ``baseline.json``).  Importing this package imports neither
torch nor the engines; the lint half stays usable without them.
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
    "run_contracts",
    "run_lint",
    "run_proto",
    "run_verify",
    "save_baseline",
]


def run_lint(paths=None):
    from .lint import lint_paths

    return lint_paths(paths)


def run_contracts(fault=None):
    from .contracts import run_contracts as _rc

    return _rc(fault=fault)


def run_verify(fault=None):
    from .verify import run_verify as _rv

    return _rv(fault=fault)


def run_proto(fault=None):
    from .proto import run_proto as _rp

    return _rp(fault=fault)
