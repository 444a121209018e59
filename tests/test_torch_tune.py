"""The port's measured-cost autotuner and its tuned-plan seam against the
JAX package's, on the CPU.

The store (``tune/store.py``) keys, bounds, persists and refuses as the
reference's: the same record/lookup/eviction sequence writes the same
file bytes and the same counters in both packages, and each reads the
other's file.  ``config.resolve_tuned`` fills the same knobs from one
store file.  The device key is the problem's device: 'cpu' here, as the
reference answers on the CPU, and a plan never crosses from the CPU to a
card or back.  ``tune/search.py`` races the reference's plan space and
stamps the reference's row keys; a tuned prepare at ``recall_target=1.0``
answers the untuned rows byte for byte, in the single-device, sharded and
pod prepares.  With no store active every prepare keeps its config object
and the tuner is never imported.
"""

import dataclasses
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cuda_knearests_tpu import KnnConfig as JConfig
from cuda_knearests_tpu import KnnProblem as JProblem
from cuda_knearests_tpu.config import resolve_tuned as j_resolve_tuned
from cuda_knearests_tpu.fuzz.compare import check_route_result
from cuda_knearests_tpu.io import generate_blue_noise
from cuda_knearests_tpu.obs import metrics as jmetrics
from cuda_knearests_tpu.runtime import dispatch as jdispatch
from cuda_knearests_tpu.tune import store as jstore
import cuda_knearests_tpu_torch as pt
from cuda_knearests_tpu_torch.config import resolve_tuned
from cuda_knearests_tpu_torch.obs import metrics
from cuda_knearests_tpu_torch.parallel import ShardedKnnProblem
from cuda_knearests_tpu_torch.pod import PodKnnProblem
from cuda_knearests_tpu_torch.runtime import dispatch
from cuda_knearests_tpu_torch.tune import __main__ as tune_main
from cuda_knearests_tpu_torch.tune import store
from cuda_knearests_tpu_torch.utils.memory import InvalidConfigError

# the packages export the function ``search`` under the submodule's name
search = importlib.import_module("cuda_knearests_tpu_torch.tune.search")
jsearch = importlib.import_module("cuda_knearests_tpu.tune.search")

CPU = "cpu"
H100 = "NVIDIA H100 80GB HBM3"
# KnnConfig fields the port does not honour (api._REFERENCE_RUNTIME_KNOBS)
_SKIP_FIELDS = ("interpret", "stream_tile")


@pytest.fixture(autouse=True)
def _no_ambient_store(monkeypatch):
    """Every test starts with no active store in either package and
    leaves none behind."""
    monkeypatch.delenv("KNTPU_TUNE_STORE", raising=False)
    monkeypatch.delenv("KNTPU_TUNE_CACHE_CAP", raising=False)
    store.set_default_store(None)
    jstore.set_default_store(None)
    yield
    store.set_default_store(None)
    jstore.set_default_store(None)


@pytest.fixture(scope="module")
def blue2k():
    return generate_blue_noise(2000, seed=7)


def _fields(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    for name in _SKIP_FIELDS:
        d.pop(name)
    return d


def _no_path(stats: dict) -> dict:
    return {k: v for k, v in stats.items() if k != "tune_store_path"}


# -- keys and the plan space ---------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 2, 3, 500, 512, 513, 900_000])
def test_plan_signature_equals_jax(n):
    for d, k, rt in ((3, 10, 1.0), (128, 10, 0.9), (3, 5, 0.8), (2, 1, 0.95)):
        assert store.plan_signature(n, d, k, rt) == \
            jstore.plan_signature(n, d, k, rt)


@pytest.mark.parametrize("budget", [None, 0, 2])
@pytest.mark.parametrize("rt", [1.0, 0.8])
def test_candidate_plans_equal_jax(rt, budget):
    assert search.candidate_plans(rt, budget) == \
        jsearch.candidate_plans(rt, budget)


def test_device_key_is_the_problems_device(monkeypatch):
    assert store.device_key(device=CPU) == "cpu" == jstore.device_key()
    assert store.device_key(device=torch.device("cpu")) == "cpu"
    assert store.device_key() == "cpu"  # no card here: the CPU
    assert store.device_key("TPU v4", device=CPU) == "TPU v4"  # explicit wins
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: H100)
    assert store.device_key(device="cuda") == H100
    assert store.device_key(device=torch.device("cuda", 0)) == H100


# -- the store -------------------------------------------------------------------

def _store_sequence(mod, path):
    """One record/lookup/eviction sequence under a cap of 2; the lookups'
    answers."""
    st = mod.TunedPlanStore(path=str(path))
    got = []
    st.record("n512-d3-k5-rt1", "cpu", {"precision": "bf16"})
    st.record("n1024-d3-k5-rt1", "cpu", {"scorer": "mxu",
                                         "query_chunk": 128})
    got.append(st.lookup("n512-d3-k5-rt1", "cpu"))      # refreshes it
    st.record("n2048-d3-k5-rt1", "cpu", {"epilogue": "gather"})  # evicts
    got.append(st.lookup("n1024-d3-k5-rt1", "cpu"))     # evicted: miss
    got.append(st.lookup("n512-d3-k5-rt1", H100))       # other kind: miss
    st.record("n512-d3-k5-rt1", H100, {"precision": "f32",
                                       "objective_s": 0.25})
    got.append(st.lookup("n2048-d3-k5-rt1", "cpu"))
    return st, got


def test_store_file_bytes_and_counters_equal_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("KNTPU_TUNE_CACHE_CAP", "2")
    mine, theirs = tmp_path / "port.json", tmp_path / "jax.json"
    st, got = _store_sequence(store, mine)
    jst, want = _store_sequence(jstore, theirs)
    assert got == want
    assert mine.read_bytes() == theirs.read_bytes()
    assert _no_path(st.stats_dict()) == _no_path(jst.stats_dict())
    assert st.stats_dict()["tune_store_evictions"] == 2
    # each package reads the other's file, in its LRU order
    a = store.TunedPlanStore(path=str(theirs))
    b = jstore.TunedPlanStore(path=str(mine))
    for sig, kind in (("n512-d3-k5-rt1", H100), ("n2048-d3-k5-rt1", "cpu")):
        assert a.lookup(sig, kind) == b.lookup(sig, kind) is not None
    assert a.lookup("n512-d3-k5-rt1", "cpu") is None


@pytest.mark.parametrize("body", [
    json.dumps({"schema": "kntpu-tuned-plans-v0", "plans": {}}),
    json.dumps({"plans": {}}),
    "{not json",
    json.dumps({"schema": store.SCHEMA, "plans": {"k": "not-a-dict"}}),
], ids=["stale-schema", "no-schema", "garbled", "malformed-plans"])
def test_both_packages_refuse_a_bad_store(tmp_path, body):
    p = tmp_path / "plans.json"
    p.write_text(body)
    with pytest.raises(store.StaleTuneStoreError):
        store.TunedPlanStore(path=str(p))
    with pytest.raises(jstore.StaleTuneStoreError):
        jstore.TunedPlanStore(path=str(p))


# -- the resolve_tuned seam -------------------------------------------------------

PLANS = {
    "bf16-qc128": {"precision": "bf16", "query_chunk": 128},
    "mxu-f32": {"scorer": "mxu", "precision": "f32"},
    "gather": {"epilogue": "gather", "objective_s": 0.5},
    "elementwise-qc512": {"scorer": "elementwise", "precision": "f32",
                          "query_chunk": 512},
    "empty": {},
}
CONFIGS = [dict(k=5), dict(k=5, precision="f32"),
           dict(k=5, scorer="mxu", query_chunk=64),
           dict(k=5, epilogue="scatter"), dict(k=5, recall_target=0.9),
           dict(k=5, adaptive=False)]


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_resolve_tuned_equals_jax_from_one_store_file(tmp_path, monkeypatch,
                                                      plan):
    """One store file, read by both packages through KNTPU_TUNE_STORE,
    resolves every config to the same fields; an explicit knob wins."""
    path = tmp_path / "plans.json"
    writer = store.TunedPlanStore(path=str(path))
    for rt in (1.0, 0.9):
        writer.record(store.plan_signature(500, 3, 5, rt),
                      store.device_key(device=CPU), PLANS[plan])
    monkeypatch.setenv("KNTPU_TUNE_STORE", str(path))
    for kw in CONFIGS:
        cfg, jcfg = pt.KnnConfig(**kw), JConfig(**kw)
        got = resolve_tuned(cfg, (500, 3), device=CPU)
        want = j_resolve_tuned(jcfg, (500, 3))
        assert _fields(got) == _fields(want), (plan, kw)
        assert (got is cfg) == (want is jcfg), (plan, kw)
    explicit = resolve_tuned(pt.KnnConfig(k=5, precision="f32",
                                          query_chunk=64), (500, 3),
                             device=CPU)
    assert (explicit.precision, explicit.query_chunk) == ("f32", 64)


def test_plans_never_cross_device_keys():
    st = store.TunedPlanStore()
    sig = store.plan_signature(500, 3, 5, 1.0)
    st.record(sig, "cpu", {"precision": "bf16"})
    store.set_default_store(st)
    cfg = pt.KnnConfig(k=5)
    assert resolve_tuned(cfg, sig, device=CPU).precision == "bf16"
    assert resolve_tuned(cfg, sig, H100) is cfg   # a CPU plan on the card
    st.clear()
    st.record(sig, H100, {"precision": "bf16"})
    assert resolve_tuned(cfg, sig, device=CPU) is cfg  # a card plan here
    assert resolve_tuned(cfg, sig, H100).precision == "bf16"


def test_inactive_resolve_keeps_every_config_and_never_imports_tune():
    """No store active: the seam returns each prepare's config object and
    never imports the tuner.  A fresh interpreter, since this file imports
    the tuner."""
    code = (
        "import sys\n"
        "from cuda_knearests_tpu_torch.config import KnnConfig, "
        "resolve_tuned\n"
        "from cuda_knearests_tpu_torch import KnnProblem\n"
        "from cuda_knearests_tpu_torch.parallel import ShardedKnnProblem\n"
        "from cuda_knearests_tpu_torch.pod import PodKnnProblem\n"
        "from cuda_knearests_tpu_torch.io import generate_blue_noise\n"
        "cfg = KnnConfig(k=5)\n"
        "assert resolve_tuned(cfg, (500, 3)) is cfg\n"
        "assert resolve_tuned(cfg, (500, 3), device='cpu') is cfg\n"
        "pts = generate_blue_noise(600, seed=3)\n"
        "assert KnnProblem.prepare(pts, cfg, device='cpu').config is cfg\n"
        "assert ShardedKnnProblem.prepare(pts, config=cfg, "
        "devices=['cpu'] * 2).config is cfg\n"
        "assert PodKnnProblem.prepare(pts, config=cfg, "
        "mesh=['cpu'] * 2).config is cfg\n"
        "assert 'cuda_knearests_tpu_torch.tune.store' not in sys.modules\n"
        "assert 'cuda_knearests_tpu_torch.tune' not in sys.modules\n"
    )
    env = dict(os.environ)
    env.pop("KNTPU_TUNE_STORE", None)
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_tuned_plan_stats_and_metrics_equal_jax():
    assert dispatch.tuned_plan_stats() == jdispatch.tuned_plan_stats() == {}
    assert metrics.metrics_snapshot()["tuned_plans"] == {}
    for mod in (store, jstore):
        st = mod.TunedPlanStore(cap=3)
        st.record("sig-a", "cpu", {"scorer": "mxu"})
        st.record("sig-b", "cpu", {"precision": "bf16"})
        st.lookup("sig-a", "cpu")
        st.lookup("sig-c", "cpu")
        mod.set_default_store(st)
    got = dispatch.tuned_plan_stats()
    assert got == jdispatch.tuned_plan_stats()
    assert got["tune_store_hits"] == got["tune_store_misses"] == 1
    assert metrics.metrics_snapshot()["tuned_plans"] == \
        jmetrics.metrics_snapshot()["tuned_plans"] == got


# -- the searcher -------------------------------------------------------------------

def test_measure_plan_row_equals_jax():
    pts = generate_blue_noise(600, seed=11)
    plan = {"scorer": "mxu", "precision": "f32"}
    got = search.measure_plan(pts, 5, 1.0, plan, repeats=1, device=CPU)
    want = jsearch.measure_plan(pts, 5, 1.0, plan, repeats=1)
    assert sorted(got) == sorted(want)
    for key in ("precision", "uncert_count", "bound", "scorer",
                "sync_bound_ok", "objective_source"):
        assert got[key] == want[key], key
    assert got["backend"] == "plain"  # the selection's plain version here


def test_search_twice_races_nothing_the_second_time():
    pts = generate_blue_noise(600, seed=11)
    st = store.TunedPlanStore()
    w1, rows1, meta1 = search.search(pts, k=5, recall_target=1.0, budget=2,
                                     repeats=1, store=st, device=CPU)
    assert meta1 == {"signature": "n1024-d3-k5-rt1", "device_kind": "cpu",
                     "searched": 2, "store_hit": False}
    assert len(rows1) == 2 and all(r["sync_bound_ok"] for r in rows1)
    assert all(r["objective_source"] == "wall" for r in rows1)
    assert w1["schema"] == store.SCHEMA and w1["device_kind"] == "cpu"
    w2, rows2, meta2 = search.search(pts, k=5, recall_target=1.0, budget=2,
                                     repeats=1, store=st, device=CPU)
    assert meta2["searched"] == 0 and meta2["store_hit"] is True
    assert rows2 == [] and st.hits == 1 and w2 == w1
    with pytest.raises(InvalidConfigError, match="interpret"):
        search.search(pts, k=5, store=st, interpret=True, device=CPU)
    with pytest.raises(InvalidConfigError, match="interpret"):
        search.measure_plan(pts, 5, 1.0, {"scorer": "mxu"}, interpret=True,
                            device=CPU)


_PLANTED = {
    # (the rows' (objective_source, objective_s, wall_s), the winner's
    # (plan index, objective_s, objective_source))
    "device_and_wall": ([("device", 0.01, 0.5), ("wall", 0.2, 0.2)],
                        (1, 0.2, "wall")),
    "all_device": ([("device", 0.03, 0.1), ("device", 0.02, 0.4)],
                   (1, 0.02, "device")),
    "all_wall": ([("wall", 0.3, 0.3), ("wall", 0.4, 0.4)],
                 (0, 0.3, "wall")),
}


@pytest.mark.parametrize("case", sorted(_PLANTED))
def test_search_ranks_a_mixed_race_by_wall_time(monkeypatch, case):
    """A refused capture leaves its row on wall time; a race mixing device
    and wall rows ranks every row by its wall time, and the winner says
    so.  Races of one objective rank by it, as the reference does."""
    rows, (idx, obj, source) = _PLANTED[case]
    plans = search.candidate_plans(1.0, 2)

    def planted(points, k, rt, plan, **kw):
        src, objective_s, wall_s = rows[plans.index(plan)]
        return dict(plan, objective_s=objective_s, objective_source=src,
                    wall_s=wall_s, sync_bound_ok=True)

    monkeypatch.setattr(search, "measure_plan", planted)
    st = store.TunedPlanStore()
    winner, got, _ = search.search(generate_blue_noise(600, seed=11), k=5,
                                   budget=2, store=st, device=CPU)
    assert [r["objective_source"] for r in got] == [r[0] for r in rows]
    assert {k: winner[k] for k in ("scorer", "precision")} == \
        {k: plans[idx][k] for k in ("scorer", "precision")}
    assert winner.get("query_chunk") == plans[idx].get("query_chunk")
    assert (winner["objective_s"], winner["objective_source"]) == \
        (obj, source)
    assert st.lookup(winner["signature"], "cpu") == winner


# -- tuned prepares ------------------------------------------------------------------

def _register(plan: dict, n: int, k: int = 10) -> store.TunedPlanStore:
    st = store.TunedPlanStore()
    st.record(store.plan_signature(n, 3, k, 1.0),
              store.device_key(device=CPU), plan)
    store.set_default_store(st)
    return st


def test_tuned_prepare_byte_equal_untuned_and_jax(blue2k):
    base = pt.KnnProblem.prepare(blue2k, pt.KnnConfig(k=10), device=CPU)
    base.solve()
    st = _register({"precision": "bf16", "query_chunk": 128}, 2000)
    tuned = pt.KnnProblem.prepare(blue2k, pt.KnnConfig(k=10), device=CPU)
    assert tuned.config.precision == "bf16"
    assert tuned.config.query_chunk == 128 and st.hits == 1
    tuned.solve()
    assert tuned.get_knearests().tobytes() == base.get_knearests().tobytes()
    assert tuned.get_dists_sq().tobytes() == base.get_dists_sq().tobytes()
    # an explicit choice wins; with_points keeps the resolved config
    assert pt.KnnProblem.prepare(blue2k, pt.KnnConfig(k=10, precision="f32"),
                                 device=CPU).config.precision == "f32"
    assert tuned.with_points(blue2k).config is tuned.config
    jp = JProblem.prepare(blue2k, JConfig(k=10))
    jp.solve()
    pts_sorted = tuned.get_points()
    np.testing.assert_array_equal(pts_sorted, np.asarray(jp.grid.points))
    bad = check_route_result(pts_sorted, pts_sorted, tuned.get_knearests(),
                             tuned.get_dists_sq(),
                             np.asarray(jp.get_dists_sq()), 10)
    assert bad is None, bad.render()


@pytest.mark.parametrize("plan, kw", [
    ({"scorer": "mxu"}, dict(k=5, adaptive=False)),
    ({"precision": "bf16"}, dict(k=5, scorer="elementwise")),
], ids=["mxu-on-legacy", "bf16-on-elementwise"])
def test_tuned_knob_meets_the_fail_fast_checks_as_jax(blue2k, plan, kw):
    """A tuned knob that the config cannot take is refused with the
    reference's error class (the port refuses a reduced tier on the
    elementwise scorer at prepare, the reference at its solve)."""
    pts = blue2k[:600]
    for mod in (store, jstore):
        st = mod.TunedPlanStore()
        st.record(mod.plan_signature(600, 3, 5, 1.0), "cpu", plan)
        mod.set_default_store(st)
    with pytest.raises(ValueError) as got:
        pt.KnnProblem.prepare(pts, pt.KnnConfig(**kw), device=CPU).solve()
    with pytest.raises(ValueError) as want:
        JProblem.prepare(pts, JConfig(**kw)).solve()
    assert type(got.value).__name__ == type(want.value).__name__


def test_sharded_and_pod_prepares_apply_the_plan(blue2k):
    """The plan reaches the sharded and pod prepares, keyed by the first
    slab's or chip's device.  Rows the tuned tier leaves open are resolved
    by the host kd-tree, whose d2 may sit an ulp from the grid's; every
    other row is the untuned row byte for byte."""
    cfg = pt.KnnConfig(k=10)
    sp0 = ShardedKnnProblem.prepare(blue2k, config=cfg, devices=[CPU] * 4)
    pp0 = PodKnnProblem.prepare(blue2k, config=cfg, mesh=[CPU] * 4)
    assert sp0.config is cfg and pp0.config is cfg
    want_s, want_p = sp0.solve(), pp0.solve()
    st = _register({"precision": "bf16", "query_chunk": 128}, 2000)
    sp = ShardedKnnProblem.prepare(blue2k, config=cfg, devices=[CPU] * 4)
    pp = PodKnnProblem.prepare(blue2k, config=cfg, mesh=[CPU] * 4)
    assert sp.config.precision == pp.config.precision == "bf16"
    assert sp.config.query_chunk == pp.config.query_chunk == 128
    assert st.hits == 2
    for prob, want in ((sp, want_s), (pp, want_p)):
        ids, d2, cert = prob.solve()
        assert cert.all() and ids.tobytes() == want[0].tobytes()
        kept = np.ones(len(ids), bool)
        kept[prob.fallback_rows] = False
        assert d2[kept].tobytes() == want[1][kept].tobytes()
        bad = check_route_result(blue2k, blue2k, ids, d2, want[1], 10)
        assert bad is None, bad.render()


# -- the CLI ---------------------------------------------------------------------------

def _meta(text: str) -> dict:
    lines = [json.loads(ln) for ln in text.splitlines()
             if ln.startswith("{")]
    assert lines and lines[-1]["kind"] == "tune-meta", text
    return lines[-1]


def test_tune_cli_twice_and_its_refusals(tmp_path, capsys, monkeypatch):
    argv = ["--device", CPU, "--n", "2000", "--repeats", "1",
            "--store", str(tmp_path / "plans.json")]
    assert tune_main.main(argv) == 0
    out = capsys.readouterr().out
    trials = [json.loads(ln) for ln in out.splitlines()
              if '"tune-trial"' in ln]
    meta = _meta(out)
    assert meta["searched"] == len(trials) == 7
    assert meta["device_kind"] == "cpu" and meta["tune_store_stores"] == 1
    assert all(t["sync_bound_ok"] for t in trials)
    assert tune_main.main(argv) == 0
    meta = _meta(capsys.readouterr().out)
    assert meta["searched"] == 0 and meta["tune_store_hits"] == 1
    assert tune_main.main(argv + ["--interpret"]) == 5
    assert _meta(capsys.readouterr().out)["failure_kind"] == "invalid-input"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tune_main.main(["--n", "2000"]) == 4
    assert _meta(capsys.readouterr().out)["failure_kind"] == "no-device"
