"""The port's contract engine (``cuda_knearests_tpu_torch.analysis.contracts``)
against the reference's.

* The route x config matrix is the reference's: 400 points, data seeds 7
  and 19, k in {8, 50} x supercell in {2, 3}, and the brute route's
  k x d loop.
* The plans the port checks equal those the reference's host-side fixture
  twins build for the same seeds (the reference's fixtures run on the CPU
  with JAX; the reference's whole engine is not run here).
* The clean tree passes; each of the three contract faults is detected
  under its rule (``scatter-map`` -> route-shape, ``hbm-model`` ->
  hbm-model, ``tile-misalign`` -> smem-tile); the run creates no CUDA
  context and launches no kernel, and a CUDA context is an
  ``env-backend`` finding.
"""

import pytest
import torch

from cuda_knearests_tpu.analysis import contracts as ref
from cuda_knearests_tpu.analysis import equiv as ref_equiv
from cuda_knearests_tpu_torch.analysis import contracts, equiv
from cuda_knearests_tpu_torch.runtime import dispatch

MATRIX = [(k, s) for k in (8, 50) for s in (2, 3)]


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """The routes' plain versions are many small torch operations; beside
    other test processes torch's CPU thread pool oversubscribes the cores,
    so this module runs torch on two threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_matrix_census_equals_the_reference():
    assert contracts._N_POINTS == ref._N_POINTS == 400
    assert contracts._SEEDS == ref._SEEDS == (7, 19)
    assert equiv.MATRIX == ref_equiv.MATRIX == tuple(MATRIX)
    assert equiv.ROUTES == ref_equiv.ROUTES
    assert contracts.FAULTS == ref.FAULTS
    for seed in contracts._SEEDS:
        assert (contracts._points(seed) == ref._points(seed)).all()
    # the brute route's k x d loop and the query fixture
    src = open(contracts.__file__).read()
    assert "for d in (3, 6):" in src and "for k in (8, 50):" in src
    assert contracts._queries().shape == (96, 3)


@pytest.mark.parametrize("seed", (7, 19))
@pytest.mark.parametrize("k,supercell", MATRIX)
def test_plans_equal_the_reference_fixtures(seed, k, supercell):
    pts = contracts._points(seed)
    _cfg, _grid, plan, pack = ref._legacy_fixture(pts, k, supercell)
    p = contracts.legacy_fixture(pts, k, supercell).problem
    assert (p.plan.qcap, p.plan.ccap, p.plan.n_chunks, p.plan.batch) == \
        (plan.qcap, plan.ccap, plan.n_chunks, plan.batch)
    assert (p.pack.qcap, p.pack.ccap, p.pack.s_total) == \
        (pack.qcap, pack.ccap, pack.s_total)
    _cfg, _grid, aplan = ref._adaptive_fixture(pts, k, supercell)
    port = contracts.adaptive_fixture(pts, k, supercell).problem.aplan
    assert [(cp.qcap, cp.ccap, cp.radius, cp.n_sc) for cp in port.classes] \
        == [(cp.qcap, cp.ccap, cp.radius, cp.n_sc) for cp in aplan.classes]
    # every reference 'pallas' class is a kernel class here
    assert [cp.route for cp in port.classes] == [
        "kernel" if cp.route == "pallas" else cp.route
        for cp in aplan.classes]


@pytest.fixture(scope="module")
def clean_run():
    before = dispatch.kernel_launches()
    findings = contracts.run_contracts()
    return findings, before


def test_contracts_clean_on_shipped_tree(clean_run):
    findings, _ = clean_run
    errors = [f for f in findings if f.severity == "error"]
    assert errors == [], "\n".join(f.render() for f in errors)
    routes = {f.path for f in findings}
    assert "route:equivalence" in routes  # the certificate collapse ran
    waived = {f.subject for f in findings if f.subject.startswith("waived:")}
    assert waived <= {"waived:i64-key", "waived:i64-index"}


def test_no_cuda_context_and_no_kernel_launch(clean_run):
    _findings, before = clean_run
    assert not torch.cuda.is_initialized()
    assert dispatch.kernel_launches() == before


def test_cuda_context_is_an_env_finding(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    findings = contracts.run_contracts()
    assert [f.rule for f in findings] == ["env-backend"]


@pytest.mark.parametrize("fault,rule", [
    ("scatter-map", "route-shape"),
    ("hbm-model", "hbm-model"),
    ("tile-misalign", "smem-tile"),
])
def test_seeded_fault_is_detected(fault, rule):
    bad = [f for f in contracts.run_contracts(fault=fault)
           if f.severity == "error"]
    assert bad and {f.rule for f in bad} == {rule}, bad


def test_unknown_fault_refused():
    with pytest.raises(ValueError):
        contracts.run_contracts(fault="no-such-fault")
    # the other engines' faults pass through this one untouched
    assert not [f for f in contracts.run_contracts(fault="sync-leak")
                if f.severity == "error"]


def test_launch_records_are_the_same_on_a_second_run():
    pts = contracts._points(7)
    for route in ("legacy-pack", "adaptive", "external-query",
                  "sharded-chip", "pod-chip"):
        a = contracts.record_route(route, pts, 8, 3, "gather")
        assert a and a == contracts.record_route(route, pts, 8, 3, "gather")
        assert {r.mode for r in a} == {"b"}
        assert {r.mode for r in contracts.record_route(
            route, pts, 8, 3, "scatter")} == {"a"}
