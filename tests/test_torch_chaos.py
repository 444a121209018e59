"""The protocol models and the fleet and chaos campaigns of the PyTorch
port against the JAX package's, on the CPU.

* ``analysis/models.py``: ``explore_all()`` gives the reference's state
  and transition counts and verdicts for every model; every mutant in
  ``MUTANTS`` is caught by the same invariant with the same minimal
  counterexample; ``conform`` and ``proto_stamp`` agree on the same
  traces, the trace drained from one port chaos case included.
* ``analysis/proto.py``: ``check_models(fault)`` gives the reference's
  finding subjects for each fault; ``check_conformance()`` over the
  port's seven scope files has no gating finding and counts as many
  trigger calls and annotations as the reference's over its own tree;
  the seeded faults fire.
* ``fuzz/chaos.py`` and ``fuzz/fleet.py``: the generated streams,
  initial clouds and named autoscale schedules equal the reference's
  array for array; the JSON and bank round trips hold (across packages
  too); ``replay_ops`` is clean on three specs each with ``device='cpu'``
  (the kernels' plain versions); every seeded fleet fault is detected and
  diverted from ``tests/corpus_torch``; the manifests carry the
  reference's keys.
"""

import os

import numpy as np
import pytest
import torch

from cuda_knearests_tpu.analysis import models as jmodels
from cuda_knearests_tpu.analysis import proto as jproto
from cuda_knearests_tpu.fuzz import chaos as jchaos
from cuda_knearests_tpu.fuzz import fleet as jfleet
from cuda_knearests_tpu_torch import analysis
from cuda_knearests_tpu_torch import fuzz
from cuda_knearests_tpu_torch.analysis import models, proto
from cuda_knearests_tpu_torch.fuzz import chaos, fleet
from cuda_knearests_tpu_torch.utils import prototrace


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# -- the protocol models ------------------------------------------------------

def _exploration(ex):
    return (ex.model, ex.n_states, ex.n_transitions, ex.ok,
            [(v.invariant, tuple(v.trace), v.render())
             for v in ex.violations])


def test_models_explore_as_jax():
    assert models.PROTO_VERSION == jmodels.PROTO_VERSION
    got, want = models.explore_all(), jmodels.explore_all()
    assert sorted(got) == sorted(want) == sorted(models.healthy_models())
    for name in want:
        assert _exploration(got[name]) == _exploration(want[name]), name
        assert got[name].ok and got[name].n_states > 1
    for name, m in models.healthy_models().items():
        jm = jmodels.healthy_models()[name]
        assert (m.vocabulary, m.code_actions, m.prefix_laws, m.scope) == (
            jm.vocabulary, jm.code_actions, jm.prefix_laws, jm.scope)


def test_every_mutant_caught_as_in_jax():
    assert sorted(models.MUTANTS) == sorted(jmodels.MUTANTS)
    for name, (model, invariant) in models.MUTANTS.items():
        jmodel, jinvariant = jmodels.MUTANTS[name]
        assert invariant == jinvariant
        ex, jex = models.explore(model), jmodels.explore(jmodel)
        assert not ex.ok, name
        assert invariant in {v.invariant for v in ex.violations}, name
        assert _exploration(ex) == _exploration(jex), name
    v = models.explore(models.MUTANTS["torn-commit"][0]).violations[0]
    assert v.invariant == "committed-acked" and len(v.trace) == 2


_TRACES = [
    [],
    [("replication-commit", "apply"), ("replication-commit", "append"),
     ("replication-commit", "ack")],
    [("mesh-snapshot-replay", "snapshot"),
     ("mesh-snapshot-replay", "restore"),
     ("mesh-snapshot-replay", "replay")],
    [("replication-commit", "apply"), ("replication-commit", "ack")],
    [("mesh-snapshot-replay", "restore")],
    [("mesh-snapshot-replay", "snapshot"),
     ("mesh-snapshot-replay", "restore"),
     ("mesh-snapshot-replay", "replay"),
     ("mesh-snapshot-replay", "replay")],
    [("replication-commit", "frobnicate")],
    [("no-such-model", "apply")],
]


def test_conform_and_stamp_as_jax_on_a_port_chaos_trace():
    prototrace.enable()
    try:
        spec = chaos.draw_specs(1, 7)[0]
        assert chaos.replay_ops(spec, chaos.generate_ops(spec),
                                device="cpu") is None
        drained = prototrace.drain()
    finally:
        prototrace.disable()
    assert len(drained) > 10
    assert {m for m, _ in drained} >= {"migration-handover",
                                       "drr-admission"}
    for trace in _TRACES + [drained]:
        assert models.conform(trace) == jmodels.conform(trace), trace
        assert models.proto_stamp(trace) == jmodels.proto_stamp(trace)
    assert models.conform(drained) == []
    assert models.proto_stamp() == jmodels.proto_stamp()


# -- the protocol engine ------------------------------------------------------

def _subjects(findings):
    """Finding keys with the port's package path read as the reference's
    (a conformance finding names its file)."""
    return sorted((f.rule, f.severity, f.path,
                   f.subject.replace("cuda_knearests_tpu_torch/",
                                     "cuda_knearests_tpu/"))
                  for f in findings)


@pytest.mark.parametrize("fault", [None, "torn-commit",
                                   "ack-before-commit"])
def test_check_models_as_jax(fault):
    assert _subjects(proto.check_models(fault)) == _subjects(
        jproto.check_models(fault))


def test_conformance_clean_with_the_reference_counts():
    assert proto.SCOPE == tuple(
        p.replace("cuda_knearests_tpu/", "cuda_knearests_tpu_torch/")
        for p in jproto.SCOPE)
    assert proto.TRIGGERS == jproto.TRIGGERS
    findings = proto.check_conformance()
    assert [f.render() for f in findings if f.severity != "info"] == []
    _, calls, claims, errs = proto.scan_scope()
    _, jcalls, jclaims, jerrs = jproto.scan_scope()
    assert errs == jerrs == []
    # a wrong root would find no file and reconcile vacuously
    assert len(calls) == len(jcalls) == 35
    assert len(claims) == len(jclaims) == 49
    per_file = {}
    for c in claims:
        per_file[os.path.basename(c.path)] = per_file.get(
            os.path.basename(c.path), 0) + 1
    jper_file = {}
    for c in jclaims:
        jper_file[os.path.basename(c.path)] = jper_file.get(
            os.path.basename(c.path), 0) + 1
    assert per_file == jper_file
    assert sorted((c.model, c.action) for c in claims) == sorted(
        (c.model, c.action) for c in jclaims)
    assert sorted((c.dotted, c.enclosing) for c in calls) == sorted(
        (c.dotted, c.enclosing) for c in jcalls)
    summary = [f.message for f in findings
               if f.subject == "conformance-summary"]
    assert summary == [f.message for f in jproto.check_conformance()
                       if f.subject == "conformance-summary"]
    assert not [f for f in analysis.run_proto() if f.severity != "info"]
    # the stamp reads this package's own committed baseline and
    # certificates (the port ships both since its static gate landed)
    import hashlib

    here = os.path.dirname(analysis.__file__)
    for name, got in (("baseline.json", analysis.baseline_hash()),
                      ("equivalence.json", analysis.equivalence_hash())):
        with open(os.path.join(here, name), "rb") as fh:
            assert got == hashlib.sha256(fh.read()).hexdigest()[:12]


@pytest.mark.parametrize("fault,needle", [
    ("torn-commit", "committed-acked"),
    ("ack-before-commit", "committed-acked"),
    ("unclaimed-action", "proto-leak"),
])
def test_seeded_proto_fault_fires(fault, needle):
    errors = [f for f in proto.run_proto(fault=fault)
              if f.severity == "error"]
    assert errors and all(f.path.startswith("route:") for f in errors)
    assert any(needle in f.message + f.rule for f in errors)
    assert _subjects(errors) == _subjects(
        [f for f in jproto.run_proto(fault=fault) if f.severity == "error"])
    # the other engines' fault names pass through, unknown ones refuse
    assert not [f for f in proto.run_proto(fault="sync-leak")
                if f.severity != "info"]
    with pytest.raises(ValueError, match="torn-commit"):
        proto.run_proto(fault="no-such-fault")


# -- the campaigns ------------------------------------------------------------

def _ops_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for key in a:
            if isinstance(a[key], np.ndarray):
                assert a[key].dtype == np.asarray(b[key]).dtype, key
                np.testing.assert_array_equal(a[key], b[key])
            else:
                assert a[key] == b[key]


def test_chaos_streams_equal_jax():
    specs = chaos.draw_specs(4, 11)
    assert [s.to_json() for s in specs] == [
        s.to_json() for s in _jax_chaos_specs(4, 11)]
    for spec in specs:
        jspec = jchaos.ChaosSpec.from_json(spec.to_json())
        assert spec.case_id() == jspec.case_id()
        for a, b in zip(chaos.initial_clouds(spec),
                        jchaos.initial_clouds(jspec)):
            np.testing.assert_array_equal(a, b)
        _ops_equal(chaos.generate_ops(spec), jchaos.generate_ops(jspec))
    for (label, sp, ops), (jlabel, jsp, jops) in zip(
            chaos.named_autoscale_schedules(3),
            jchaos.named_autoscale_schedules(3)):
        assert label == jlabel and sp.to_json() == jsp.to_json()
        _ops_equal(ops, jops)


def _jax_chaos_specs(n, seed):
    rng = np.random.default_rng(seed)
    return [jchaos.ChaosSpec(
        seed=int(rng.integers(0, 2 ** 31)), n0=int(rng.choice([200, 280])),
        dense_n0=90, k=int(rng.choice([4, 8])),
        nshards=int(rng.choice([2, 3])),
        n_ops=int(rng.choice([8, 14, 20]))) for _ in range(n)]


def test_fleet_streams_equal_jax():
    for spec in fleet.draw_specs(5, 13):
        jspec = jfleet.FleetSpec.from_json(spec.to_json())
        assert spec.case_id() == jspec.case_id()
        for a, b in zip(fleet.initial_clouds(spec),
                        jfleet.initial_clouds(jspec)):
            np.testing.assert_array_equal(a, b)
        _ops_equal(fleet.generate_ops(spec), jfleet.generate_ops(jspec))


def test_bank_round_trips_across_packages(tmp_path):
    cspec = chaos.ChaosSpec(seed=9, n0=200, dense_n0=90, k=4, nshards=2,
                            n_ops=8)
    cops = chaos.generate_ops(cspec)
    assert any(o["op"] == "rebalance" for o in cops)
    fspec = fleet.FleetSpec(seed=7, n0s=(36, 150), ks=(4, 8), n_ops=5,
                            replicated=1, ship_mode="lazy")
    fops = fleet.generate_ops(fspec)
    for bank, load, jbank, jload, spec, ops, jspec_cls in (
            (chaos.bank_chaos_case, chaos.load_chaos_case,
             jchaos.bank_chaos_case, jchaos.load_chaos_case, cspec, cops,
             jchaos.ChaosSpec),
            (fleet.bank_fleet_case, fleet.load_fleet_case,
             jfleet.bank_fleet_case, jfleet.load_fleet_case, fspec, fops,
             jfleet.FleetSpec)):
        path = bank(str(tmp_path / "port"), spec, "mismatch", "why", ops)
        jpath = jbank(str(tmp_path / "jax"), jspec_cls.from_json(
            spec.to_json()), "mismatch", "why", ops)
        assert os.path.basename(path) == os.path.basename(jpath)
        for got in (load(path), load(jpath), jload(path)):
            assert got["spec"].to_json() == spec.to_json()
            assert got["kind"] == "mismatch" and got["reason"] == "why"
            _ops_equal(got["ops"], ops)


@pytest.mark.parametrize("mod", [chaos, fleet], ids=["chaos", "fleet"])
def test_replay_clean_on_three_specs(mod):
    for spec in mod.draw_specs(3, 2):
        answers = []
        assert mod.replay_ops(spec, mod.generate_ops(spec), device="cpu",
                              answers=answers) is None, spec.case_id()
        assert answers


@pytest.mark.parametrize("fault", chaos.SEEDED_FAULT_CASES)
def test_seeded_fleet_fault_detected_and_diverted(fault, monkeypatch):
    monkeypatch.delenv("KNTPU_FLEET_FAULT", raising=False)
    f, suffix = chaos.run_seeded_fault_case(fault, bank_dir=fuzz.CORPUS_DIR,
                                            device="cpu")
    assert "KNTPU_FLEET_FAULT" not in os.environ
    assert f is not None, f"fault {fault} went undetected"
    banked = os.path.abspath(f.banked)
    try:
        assert os.path.exists(banked) and banked.endswith(suffix)
        assert os.path.dirname(banked) != os.path.abspath(fuzz.CORPUS_DIR)
    finally:
        if os.path.dirname(banked) != os.path.abspath(fuzz.CORPUS_DIR):
            os.unlink(banked)
            os.rmdir(os.path.dirname(banked))
    if fault in ("torn-migration", "lost-range"):
        assert "lost or duplicated" in f.reason or "diverged" in f.reason


def test_manifests_carry_the_reference_keys():
    quick = dict(bank_dir=None, budget_s=0, log=None)
    jc = jchaos.run_chaos_campaign(n_cases=0, drill=False, **quick)
    jf = jfleet.run_fleet_campaign(n_cases=0, **quick)
    pc = chaos.run_chaos_campaign(n_cases=0, drill=False, device="cpu",
                                  **quick)
    pf = fleet.run_fleet_campaign(n_cases=0, device="cpu", **quick)
    assert sorted(pc) == sorted(jc) and sorted(pf) == sorted(jf)
    run = chaos.run_chaos_campaign(n_cases=1, seed=3, bank_dir=None,
                                   minimize=False, drill=False, log=None,
                                   device="cpu")
    assert sorted(run) == sorted(jc)
    assert run["ok"] is True and run["failures"] == []
    assert run["completed_cases"] == 5          # 1 drawn + 4 named
    assert run["proto_models_ok"] and run["proto_trace_violations"] == []
    assert run["flavor"] == "chaos-stream" and run["mesh_failover"] is None
    frun = fleet.run_fleet_campaign(n_cases=2, seed=3, bank_dir=None,
                                    minimize=False, log=None, device="cpu")
    assert sorted(frun) == sorted(jf) and frun["ok"] is True
    assert frun["flavor"] == "fleet-stream" and frun["fault"] is None
