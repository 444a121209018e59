"""The port's differential fuzz campaigns against the JAX package's, on
the CPU.

The same seeds give the same case lists, the same point bytes, the same
delta-debugging probes and the same campaign manifest (but its clock);
each route's rows on one case per generator are held tie-aware
(``fuzz/compare``, RTOL 1e-4 / ATOL 1e-2: XLA's CPU backend contracts
multiply-adds, torch does not) to JAX's distances and to the kd-tree, and
bit for bit on an empty cloud.  Under every seeded fault the port's
failure has JAX's kind and size, and a point case banks JAX's points.
Both corpora replay clean through the port.
"""

import os

import numpy as np
import pytest

from cuda_knearests_tpu.fuzz import approx as japprox
from cuda_knearests_tpu.fuzz import campaign as jcampaign
from cuda_knearests_tpu.fuzz import fof as jfof
from cuda_knearests_tpu.fuzz import generators as jgen
from cuda_knearests_tpu.fuzz import minimize as jmin
from cuda_knearests_tpu.fuzz import mutation as jmut
from cuda_knearests_tpu.fuzz import pod as jpod
from cuda_knearests_tpu.fuzz import routes as jroutes
from cuda_knearests_tpu_torch import fuzz as pfuzz
from cuda_knearests_tpu_torch.fuzz import approx as papprox
from cuda_knearests_tpu_torch.fuzz import campaign as pcampaign
from cuda_knearests_tpu_torch.fuzz import fof as pfof
from cuda_knearests_tpu_torch.fuzz import generators as pgen
from cuda_knearests_tpu_torch.fuzz import minimize as pmin
from cuda_knearests_tpu_torch.fuzz import mutation as pmut
from cuda_knearests_tpu_torch.fuzz import pod as ppod
from cuda_knearests_tpu_torch.fuzz import routes as proutes
from cuda_knearests_tpu_torch.fuzz.compare import check_route_result
from cuda_knearests_tpu_torch.mxu.solve import parse_fault
from cuda_knearests_tpu_torch.utils.memory import InvalidConfigError

CPU = "cpu"
CASES = {c.generator: c for c in pgen.draw_cases(12, 0)}
DEGENERATE = ("tiny-n", "all-coincident", "zero-extent-axis")
ROUTE_CASES = ([(g, r) for g in sorted(CASES) for r in ("adaptive", "query")]
               + [(g, r) for g in DEGENERATE for r in ("legacy", "sharded")])


def _corpus_entries():
    out = []
    for d in (pfuzz.REFERENCE_CORPUS_DIR, pfuzz.CORPUS_DIR):
        if os.path.isdir(d):
            out += sorted(os.path.join(d, f) for f in os.listdir(d)
                          if f.endswith(".npz"))
    return out


# -- case lists and case points -----------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
def test_case_lists_equal_jax(seed):
    assert [c.to_json() for c in pgen.draw_cases(64, seed)] == \
        [c.to_json() for c in jgen.draw_cases(64, seed)]
    assert [c.to_json() for c in papprox.draw_approx_cases(64, seed)] == \
        [c.to_json() for c in japprox.draw_approx_cases(64, seed)]
    assert [c.to_json() for c in pfof.draw_fof_cases(64, seed)] == \
        [c.to_json() for c in jfof.draw_fof_cases(64, seed)]
    assert [c.to_json() for c in ppod.draw_pod_cases(64, seed)] == \
        [c.to_json() for c in jpod.draw_pod_cases(64, seed)]
    assert pgen.zoo_names() == jgen.zoo_names()


@pytest.mark.parametrize("generator", jgen.zoo_names())
def test_generate_case_bytes_equal_jax(generator):
    assert pgen.hazard_of(generator) == jgen.hazard_of(generator)
    for n in (0, 1, 33, 257):
        spec = pgen.CaseSpec(generator=generator, seed=11, n=n, k=4)
        got = pgen.generate_case(spec)
        want = jgen.generate_case(jgen.CaseSpec(**spec.to_json()))
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape == (n, 3)
        assert got.tobytes() == want.tobytes()


def test_flavor_case_points_equal_jax():
    for spec in papprox.draw_approx_cases(14, 3):
        jspec = japprox.ApproxCaseSpec(**spec.to_json())
        assert papprox.case_points(spec).tobytes() == \
            japprox.case_points(jspec).tobytes()
    for spec in pfof.draw_fof_cases(12, 3):
        pts = pfof.case_points(spec)
        jspec = jfof.FofCaseSpec(**spec.to_json())
        assert pts.tobytes() == jfof.case_points(jspec).tobytes()
        assert pfof.case_linking_length(spec, pts) == \
            jfof.case_linking_length(jspec, pts)


@pytest.mark.parametrize("spec", [(123, 80, 12, 4), (5, 60, 8, 4),
                                  (9, 0, 16, 1), (77, 300, 32, 10)],
                         ids=lambda s: "-".join(map(str, s)))
def test_mutation_streams_equal_jax(spec):
    pspec = pmut.MutationSpec(*spec)
    jspec = jmut.MutationSpec(*spec)
    assert pmut.initial_points(pspec).tobytes() == \
        jmut.initial_points(jspec).tobytes()
    got, want = pmut.generate_ops(pspec), jmut.generate_ops(jspec)
    assert pmut._ops_to_json(got) == jmut._ops_to_json(want)


# -- the minimizers -----------------------------------------------------------

def test_ddmin_points_equal_jax():
    pts = np.random.default_rng(0).random((57, 3)).astype(np.float32)
    culprits = {round(float(pts[i, 0]), 6) for i in (7, 23, 41)}

    def fails(sub):
        return culprits <= {round(float(v[0]), 6) for v in sub}
    for budget in (5, 16, 200):
        got, got_probes = pmin.ddmin_points(pts, fails, max_probes=budget)
        want, want_probes = jmin.ddmin_points(pts, fails, max_probes=budget)
        assert got_probes == want_probes
        np.testing.assert_array_equal(got, want)
    assert pmin.ddmin_points(pts[:0], fails)[1] == 0


def test_ddmin_ops_equal_jax():
    ops = pmut.generate_ops(pmut.MutationSpec(seed=3, n0=50, n_ops=32, k=4))
    calls = {"port": 0, "jax": 0}

    def fails(who):
        def f(sub):
            calls[who] += 1
            kinds = [o["op"] for o in sub]
            return kinds.count("insert") >= 2 and "query" in kinds
        return f
    got = pmut.ddmin_ops(list(ops), fails("port"), max_probes=24)
    want = jmut.ddmin_ops(list(ops), fails("jax"), max_probes=24)
    assert calls["port"] == calls["jax"]
    assert pmut._ops_to_json(got) == jmut._ops_to_json(want)


# -- the routes ---------------------------------------------------------------

@pytest.mark.parametrize("generator,route", ROUTE_CASES,
                         ids=[f"{g}-{r}" for g, r in ROUTE_CASES])
def test_run_route_against_jax(generator, route):
    spec = CASES[generator]
    pts = pgen.generate_case(spec)
    got = proutes.run_route(route, pts, spec.k, n_devices=2, device=CPU)
    want = jroutes.run_route(route, pts, spec.k, n_devices=2)
    ids, d2 = got
    jd2 = np.asarray(want[1])
    bad = check_route_result(pts, pts, ids, d2, jd2, spec.k)
    assert bad is None, bad.render()
    ref = proutes.oracle_reference(pts, spec.k,
                                   proutes.route_excludes_self(route))
    bad = check_route_result(pts, pts, ids, d2, ref[1], spec.k)
    assert bad is None, bad.render()


@pytest.mark.parametrize("route", proutes.ROUTE_NAMES)
def test_tiny_clouds_every_route_against_jax(route):
    for n in (0, 1, 3):
        spec = pgen.CaseSpec(generator="tiny-n", seed=5, n=n, k=4)
        pts = pgen.generate_case(spec)
        ids, d2 = proutes.run_route(route, pts, 4, device=CPU)
        jids, jd2 = (np.asarray(a) for a in jroutes.run_route(route, pts, 4))
        if n == 0:
            np.testing.assert_array_equal(ids, jids)
            np.testing.assert_array_equal(d2, jd2)
        bad = check_route_result(pts, pts, ids, d2, jd2, 4)
        assert bad is None, bad.render()


def test_run_route_refuses_unknown_route():
    with pytest.raises(ValueError, match="unknown route"):
        proutes.run_route("nope", np.zeros((2, 3), np.float32), 1,
                          device=CPU)


# -- the campaign -------------------------------------------------------------

def test_campaign_manifest_equal_jax(tmp_path):
    kw = dict(n_cases=3, seed=0, routes=("adaptive", "query"),
              isolation="none", log=None)
    got = pcampaign.run_campaign(bank_dir=str(tmp_path / "p"), device=CPU,
                                 **kw)
    want = jcampaign.run_campaign(bank_dir=str(tmp_path / "j"), **kw)
    assert got.pop("elapsed_s") >= 0 and want.pop("elapsed_s") >= 0
    assert got == want
    assert got["ok"] and got["isolation"] == "none"


def test_campaign_budget_truncates(tmp_path):
    m = pcampaign.run_campaign(n_cases=20, routes=("query",),
                               bank_dir=str(tmp_path), isolation="none",
                               budget_s=0.0, log=None, device=CPU)
    assert m["ok"] and m["truncated_after"] == 0
    with pytest.raises(ValueError, match="isolation"):
        pcampaign._resolve_isolation("sometimes", None)


_FAULT_EXPECT = {"drop-neighbor": "mismatch", "perturb-d2": "mismatch",
                 "skip-route": "missing-route"}


@pytest.mark.parametrize("fault", sorted(_FAULT_EXPECT))
def test_seeded_fault_repro_equal_jax(fault, tmp_path, monkeypatch):
    monkeypatch.setenv("KNTPU_FUZZ_FAULT", fault)
    spec = pgen.CaseSpec(generator="uniform", seed=77, n=33, k=4)
    got = pcampaign.run_case(spec, routes=("adaptive",),
                             bank_dir=str(tmp_path / "p"), max_probes=16,
                             device=CPU)
    want = jcampaign.run_case(jgen.CaseSpec(**spec.to_json()),
                              routes=("adaptive",),
                              bank_dir=str(tmp_path / "j"), max_probes=16)
    assert len(got) == len(want) == 1
    g, w = got[0], want[0]
    assert g.kind == w.kind == _FAULT_EXPECT[fault]
    assert g.minimized_n == w.minimized_n < g.original_n
    gb, wb = pcampaign.load_banked(g.banked), jcampaign.load_banked(w.banked)
    np.testing.assert_array_equal(gb["points"], wb["points"])
    assert (gb["k"], gb["route"], gb["kind"], gb["hazard"]) == \
        (wb["k"], wb["route"], wb["kind"], wb["hazard"])
    monkeypatch.delenv("KNTPU_FUZZ_FAULT")
    assert pcampaign.replay_banked(g.banked, device=CPU) is None


def test_faulted_runs_never_bank_into_a_corpus(monkeypatch):
    with pytest.raises(ValueError, match="never banks"):
        pfuzz.safe_bank_dir(pfuzz.REFERENCE_CORPUS_DIR, False, "x-")
    for env, mod, value in (("KNTPU_FUZZ_FAULT", pcampaign, "skip-route"),
                            ("KNTPU_MXU_FAULT", papprox, "skip-certify"),
                            ("KNTPU_FOF_FAULT", pfof, "merge"),
                            ("KNTPU_POD_FAULT", ppod, "drop-halo"),
                            ("KNTPU_MUT_FAULT", pmut, "perturb-d2")):
        monkeypatch.setenv(env, value)
        diverted = mod._safe_bank_dir(pfuzz.CORPUS_DIR)
        assert os.path.abspath(diverted) != os.path.abspath(pfuzz.CORPUS_DIR)
        assert mod._safe_bank_dir("/tmp/explicit") == "/tmp/explicit"
        monkeypatch.delenv(env)
        assert mod._safe_bank_dir(pfuzz.CORPUS_DIR) == pfuzz.CORPUS_DIR


# -- the flavors' seeded faults -----------------------------------------------

@pytest.mark.parametrize("fault", ["drop-block", "skip-certify",
                                   "narrow-bound"])
def test_mxu_fault_equal_jax(fault, tmp_path, monkeypatch):
    monkeypatch.setenv("KNTPU_MXU_FAULT", fault)
    spec = dict(generator="block-aliased", seed=3, n=2048, k=10,
                recall_target=0.6,
                precision="bf16" if fault == "narrow-bound" else "f32")
    got = papprox.run_approx_case(papprox.ApproxCaseSpec(**spec),
                                  bank_dir=str(tmp_path), max_probes=8,
                                  device=CPU)
    want = japprox.run_approx_case(japprox.ApproxCaseSpec(**spec),
                                   bank_dir=str(tmp_path / "j"),
                                   max_probes=8)
    assert (got.kind, got.minimized_n) == (want.kind, want.minimized_n)
    monkeypatch.delenv("KNTPU_MXU_FAULT")
    assert pcampaign.replay_banked(got.banked, device=CPU) is None


def test_mxu_fault_knob_refuses_typos(monkeypatch):
    assert parse_fault("") is None and parse_fault("drop-block")
    monkeypatch.setenv("KNTPU_MXU_FAULT", "drop-blok")
    with pytest.raises(InvalidConfigError, match="KNTPU_MXU_FAULT"):
        parse_fault()


@pytest.mark.parametrize("fault", pfof.FOF_FAULT_KINDS)
def test_fof_fault_equal_jax(fault, tmp_path, monkeypatch):
    monkeypatch.setenv("KNTPU_FOF_FAULT", fault)
    spec = dict(generator="uniform", seed=3, n=96, b_mode="scaled",
                b_scale=1.0)
    got = pfof.run_fof_case(pfof.FofCaseSpec(**spec),
                            bank_dir=str(tmp_path), max_probes=12,
                            device=CPU)
    want = jfof.run_fof_case(jfof.FofCaseSpec(**spec),
                             bank_dir=str(tmp_path / "j"), max_probes=12)
    assert (got.kind, got.minimized_n) == (want.kind, want.minimized_n)
    monkeypatch.delenv("KNTPU_FOF_FAULT")
    assert pcampaign.replay_banked(got.banked, device=CPU) is None


@pytest.mark.parametrize("fault", ppod.POD_FAULT_KINDS)
def test_pod_fault_equal_jax(fault, tmp_path, monkeypatch):
    monkeypatch.setenv("KNTPU_POD_FAULT", fault)
    spec = dict(generator="uniform", seed=999983, n=257, k=8, ndev=4)
    got = ppod.run_pod_case(ppod.PodCaseSpec(**spec), bank_dir=str(tmp_path),
                            minimize=False, device=CPU)
    want = jpod.run_pod_case(jpod.PodCaseSpec(**spec),
                             bank_dir=str(tmp_path / "j"), minimize=False)
    assert got.kind == want.kind == "mismatch"
    assert str(tmp_path) in got.banked


@pytest.mark.parametrize("fault", ["drop-neighbor", "perturb-d2"])
def test_mutation_fault_equal_jax(fault, tmp_path, monkeypatch):
    monkeypatch.setenv("KNTPU_MUT_FAULT", fault)
    spec = (5, 40, 8, 4)
    got = pmut.run_mutation_case(pmut.MutationSpec(*spec),
                                 bank_dir=str(tmp_path), max_probes=8,
                                 device=CPU)
    want = jmut.run_mutation_case(jmut.MutationSpec(*spec),
                                  bank_dir=str(tmp_path / "j"), max_probes=8)
    assert (got.kind, got.minimized_ops, got.op_index) == \
        (want.kind, want.minimized_ops, want.op_index)
    monkeypatch.delenv("KNTPU_MUT_FAULT")
    assert pcampaign.replay_banked(got.banked, device=CPU) is None


# -- the flavors' campaigns, clean --------------------------------------------

def test_flavor_campaigns_clean(tmp_path):
    for run in (papprox.run_approx_campaign, pfof.run_fof_campaign,
                ppod.run_pod_campaign):
        m = run(n_cases=3, seed=1, bank_dir=str(tmp_path), log=None,
                device=CPU)
        assert m["ok"] and m["failures"] == [], m
        assert m["completed_cases"] == 3
    spec = pmut.MutationSpec(seed=123, n0=80, n_ops=12, k=4)
    assert pmut.run_mutation_case(spec, bank_dir=None, device=CPU) is None


def test_cli_usage_and_unported_flavors(tmp_path, capsys):
    """Every flavor is ported: --fleet and --chaos run their campaigns
    (rc 0 when clean; --budget 0 truncates the chaos list before its
    first case, so no mesh drill runs here); mutually exclusive flavors
    and point-only flags on them are usage errors (rc 2)."""
    import json

    from cuda_knearests_tpu_torch.fuzz.__main__ import main

    common = ["--device", "cpu", "--bank-dir", str(tmp_path)]
    assert main(["--fleet", "--cases", "1", "--seed", "4"] + common) == 0
    fleet_m = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert fleet_m["flavor"] == "fleet-stream" and fleet_m["ok"]
    assert fleet_m["completed_cases"] == 1 and fleet_m["proto_models_ok"]
    assert main(["--chaos", "--cases", "1", "--budget", "0"] + common) == 0
    chaos_m = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert chaos_m["flavor"] == "chaos-stream" and chaos_m["ok"]
    assert chaos_m["truncated_after"] == 0
    assert chaos_m["mesh_failover"] is None
    for argv in (["--pod", "--approx"], ["--fleet", "--chaos"],
                 ["--chaos", "--routes", "adaptive"],
                 ["--fleet", "--isolation", "case"]):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 2
    capsys.readouterr()


def test_cli_palettes_and_card_rows(tmp_path, capsys):
    """--ns/--ks set the point campaign's palettes, and --card-rows holds
    every case's routes and CARD_CONFIGS runs to the oracle and the CPU."""
    import json

    from cuda_knearests_tpu_torch.fuzz.__main__ import main

    path = tmp_path / "m.json"
    assert main(["--cases", "2", "--seed", "2", "--device", "cpu",
                 "--isolation", "none", "--ns", "40", "--ks", "4",
                 "--card-rows", "40", "--bank-dir", str(tmp_path / "b"),
                 "--manifest", str(path)]) == 0
    m = json.loads(path.read_text())
    assert m["ok"] and m["completed_cases"] == 2
    assert m["card_rows"]["runs"] == 2 * (len(proutes.ROUTE_NAMES)
                                          + len(pcampaign.CARD_CONFIGS))
    assert m["card_rows"]["failures"] == []
    assert m["card_rows"]["ns"] == [40] and m["card_rows"]["ks"] == [4]
    with pytest.raises(SystemExit) as e:
        main(["--pod", "--ns", "40"])
    assert e.value.code == 2
    capsys.readouterr()


def test_check_card_rows_reports_a_seeded_fault(monkeypatch):
    spec = pgen.CaseSpec(generator="uniform", seed=77, n=33, k=4)
    assert pcampaign.check_card_rows(spec, CPU) == (7, [])
    monkeypatch.setenv("KNTPU_FUZZ_FAULT", "drop-neighbor:query")
    runs, problems = pcampaign.check_card_rows(spec, CPU)
    assert runs == 7 and len(problems) == 1
    assert problems[0].startswith(f"{spec.case_id()} query: ")


# -- corpus replay ------------------------------------------------------------

@pytest.mark.parametrize("path", _corpus_entries(),
                         ids=lambda p: "/".join(p.split(os.sep)[-2:]))
def test_corpus_replays_clean(path):
    got = pcampaign.replay_banked(path, device=CPU)
    assert got is None, f"{os.path.basename(path)} regressed: {got}"


def test_corpus_size_counts_banked_cases(tmp_path):
    assert pfuzz.corpus_size(str(tmp_path / "missing")) == 0
    spec = pgen.CaseSpec(generator="uniform", seed=1, n=5, k=2)
    pcampaign.bank_case(str(tmp_path), spec, "query", "mismatch", "why",
                        pgen.generate_case(spec))
    assert pfuzz.corpus_size(str(tmp_path)) == 1
    b = pcampaign.load_banked(str(tmp_path / f"{spec.case_id()}-query.npz"))
    assert b["spec"] == spec and (b["k"], b["route"]) == (2, "query")
