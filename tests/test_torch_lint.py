"""The port's hazard lint (``cuda_knearests_tpu_torch.analysis.lint``)
against the reference's and against its own fixtures.

* The seven framework-neutral rules (``wide-dtype``, ``broad-except``,
  ``bare-valueerror``, ``bare-timing`` and the three concurrency rules)
  fire on exactly the (rule, line) pairs of the reference's engine over
  the reference's fixture corpus (``tests/fixtures/lint/``, untouched).
* The three rules re-aimed at torch (``tracer-leak``, ``host-sync-loop``,
  ``jnp-in-loop``) fire exactly where ``tests/fixtures/lint_torch/``
  plants them, and stay silent on the forms that may be numpy.
* Waiver mechanics, duplicate counting, the path scopes, and the shipped
  tree clean against the committed (empty) baseline.
"""

import glob
import os

import pytest

from cuda_knearests_tpu.analysis.lint import lint_paths as ref_lint_paths
from cuda_knearests_tpu_torch.analysis import rules as port_rules
from cuda_knearests_tpu_torch.analysis.lint import lint_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_FIXTURES = os.path.join(REPO, "tests", "fixtures", "lint")
FIXTURES = os.path.join(REPO, "tests", "fixtures", "lint_torch")
SHARED = {"wide-dtype", "broad-except", "bare-valueerror", "bare-timing",
          "unguarded-shared-mutable", "lock-order", "blocking-under-lock"}
REAIMED = {"tracer-leak", "host-sync-loop", "jnp-in-loop"}


def _pairs(findings, rules):
    return {(f.rule, f.line) for f in findings if f.rule in rules}


@pytest.mark.parametrize(
    "fixture", sorted(os.path.basename(p) for p in
                      glob.glob(os.path.join(REF_FIXTURES, "*.py"))))
def test_shared_rules_match_the_reference(fixture):
    path = os.path.join(REF_FIXTURES, fixture)
    assert _pairs(lint_paths([path]), SHARED) == \
        _pairs(ref_lint_paths([path]), SHARED)


def test_same_rule_registry_as_the_reference():
    from cuda_knearests_tpu.analysis.rules import all_rules as ref_rules

    ids = {r.rule_id for r in port_rules.all_rules()}
    assert ids == {r.rule_id for r in ref_rules()} == SHARED | REAIMED
    assert {r.rule_id: r.severity for r in port_rules.all_rules()} == \
        {r.rule_id: r.severity for r in ref_rules()}


@pytest.mark.parametrize("fixture,rule,lines", [
    ("bad_tracer_leak.py", "tracer-leak", {10, 15, 20, 25}),
    ("bad_host_sync_loop.py", "host-sync-loop", {10, 11, 12, 13, 14, 15}),
    ("bad_jnp_in_loop.py", "jnp-in-loop", {8, 9, 10}),
])
def test_reaimed_rule_fires_exactly_where_planted(fixture, rule, lines):
    findings = lint_paths([os.path.join(FIXTURES, fixture)])
    assert {f.rule for f in findings} == {rule}, findings
    assert {f.line for f in findings} == lines, findings


def test_reaimed_rules_are_silent_on_the_jax_forms():
    """The reference's JAX-aimed fixtures plant jax.jit, jnp.* and
    block_until_ready: none of them is a torch hazard."""
    for fixture in ("bad_tracer_leak.py", "bad_jnp_in_loop.py",
                    "bad_per_class_readback.py"):
        assert not _pairs(lint_paths([os.path.join(REF_FIXTURES, fixture)]),
                          REAIMED), fixture


def test_waivers_silence_every_rule():
    assert lint_paths([os.path.join(FIXTURES, "clean_waived.py")]) == []
    assert lint_paths([os.path.join(REF_FIXTURES, "clean_waived.py")]) == []


def test_unreasoned_waiver_does_not_silence(tmp_path):
    bad = tmp_path / "unreasoned.py"
    bad.write_text(
        "import numpy as np\n"
        "x = np.float64(1.0)  # kntpu-ok: wide-dtype\n"
        "for c in []:\n"
        "    c.item()  # kntpu-ok: host-sync-loop --\n"
        "try:\n"
        "    pass\n"
        "except Exception:  # noqa: BLE001\n"
        "    pass\n")
    rules = {f.rule for f in lint_paths([str(bad)])}
    assert rules == {"wide-dtype", "host-sync-loop", "broad-except"}


def test_duplicate_hazards_gate_by_count(tmp_path):
    from cuda_knearests_tpu_torch.analysis.findings import (
        diff_vs_baseline, load_baseline, save_baseline)

    dup = "for c in []:\n    c.item()\n"
    f = tmp_path / "dups.py"
    f.write_text(dup * 2)
    two = lint_paths([str(f)])
    assert len(two) == 2
    base = tmp_path / "b.json"
    save_baseline(two, str(base))
    bl = load_baseline(str(base))
    assert len(bl["fingerprints"]) == 2
    assert diff_vs_baseline(two, bl)[0] == []
    f.write_text(dup * 3)
    assert len(diff_vs_baseline(lint_paths([str(f)]), bl)[0]) == 1


def test_path_filters_name_existing_port_paths():
    for r in port_rules.all_rules():
        for sub in r.path_filter or ():
            assert sub.startswith("cuda_knearests_tpu_torch/"), (r.rule_id,
                                                                 sub)
            assert os.path.exists(os.path.join(REPO, sub)), (r.rule_id, sub)


def test_default_scope_is_the_port_and_its_scripts():
    from cuda_knearests_tpu_torch.analysis import lint

    assert lint.DEFAULT_SCOPE == ("cuda_knearests_tpu_torch",)
    paths = {f.path for f in lint_paths()}
    assert not any(p.startswith("cuda_knearests_tpu/") for p in paths)


def test_lint_clean_on_shipped_tree():
    from cuda_knearests_tpu_torch.analysis import (diff_vs_baseline,
                                                   load_baseline, run_lint)

    assert load_baseline()["fingerprints"] == []
    new, _stale = diff_vs_baseline(run_lint())
    assert new == [], "\n".join(f.render() for f in new)


def test_no_bare_timing_in_serve_or_runtime():
    """The port times serve/ and runtime/ through obs.spans, as the
    reference does: no bare-timing finding and no waiver of one."""
    for root in ("serve", "runtime"):
        for path in glob.glob(os.path.join(REPO, "cuda_knearests_tpu_torch",
                                           root, "**", "*.py"),
                              recursive=True):
            with open(path) as fh:
                assert "kntpu-ok: bare-timing" not in fh.read(), path
