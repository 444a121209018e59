"""``BENCHMARK.json`` keeps to the benchmark's contract, and a new
configuration, mix or metric is new files and entries only."""

import json
import re
import shutil

import pytest

from knnbench import context, metrics, spec

ROOT = spec.ROOT
BENCH = spec.load_benchmark()
E2E = {m["name"] for m in BENCH["end_to_end"]}
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def name_faults(bench):
    """Every name, key of ``reduced`` and unit outside the characters the
    benchmark's contract allows."""
    out = []

    def check(value, what, regex=NAME_RE):
        if not isinstance(value, str) or not regex.match(value):
            out.append(f"{what}: {value!r}")

    for c in bench.get("configs", []):
        check(c.get("name"), "config name")
        for key in c.get("reduced", []):
            check(key, f"reduced key of {c.get('name')}")
    for w in bench.get("workloads", []):
        check(w.get("name"), "workload name")
        check(w.get("config"), f"config of {w.get('name')}")
        check(w.get("traffic"), f"traffic of {w.get('name')}")
    for section in ("end_to_end", "per_layer"):
        for m in bench.get(section, []):
            check(m.get("name"), f"{section} name")
            check(m.get("unit"), f"unit of {m.get('name')}", UNIT_RE)
    return out


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["knnbench"]
    assert BENCH["command"][:3] == ["python3", "-m", "knnbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_and_units_use_allowed_characters():
    assert name_faults(BENCH) == []
    assert name_faults({"workloads": [{"name": "a b", "config": "c/d",
                                            "traffic": "é"}]}) != []
    assert name_faults({"per_layer": [{"name": "x",
                                            "unit": "tokens per s"}]})


def test_entries_have_exactly_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("knnbench/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
        assert c["source"].startswith("https://")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        mix = spec.BENCH_DIR / "traffic" / f"{w['traffic']}.json"
        recipe = json.loads(mix.read_text())["cloud"]["recipe"]
        assert (spec.BENCH_DIR / "recipes" / f"{recipe}.py").is_file()
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in E2E
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for section in ("end_to_end", "per_layer"):
        for m in BENCH[section]:
            assert m["better"] in ("lower", "higher")
            assert (metrics.HERE / f"{m['name']}.py").is_file()
    texts = [c["why"] for c in BENCH["configs"] + BENCH["workloads"]]
    texts += [c["source"] for c in BENCH["configs"]]
    texts += [m["layer"] for m in BENCH["per_layer"]]
    assert all(0 < len(t) <= 200 and "\n" not in t and "\t" not in t
               for t in texts)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        c = spec.cell(BENCH, w["name"])
        names = {m["name"] for m in c.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert c.per_layer


def test_unknown_workload_is_refused():
    with pytest.raises(spec.SpecError, match="unknown workload"):
        spec.cell(BENCH, "nope.none")


def _ctx(**kw):
    base = dict(n=1000, k=10, d=3, device_kind="cpu", setup_s=1.5,
                latencies_s=[0.02, 0.03], solves=2, elapsed_s=0.05,
                peak_mem_bytes=None, counters={"host_syncs": 2},
                prepare_spans=[])
    base.update(kw)
    return context.RunContext(**base)


def test_a_new_metric_is_a_new_file(tmp_path):
    (tmp_path / "rows_per_sync.py").write_text(
        "def read(ctx):\n"
        "    return ctx.n * ctx.solves / ctx.counters['host_syncs']\n")
    entry = {"name": "rows_per_sync", "unit": "rows/sync"}
    out = metrics.read_metrics([entry], _ctx(),
                               dirs=[tmp_path, metrics.HERE])
    assert out == {"rows_per_sync": {"value": 1000.0, "unit": "rows/sync"}}
    with pytest.raises(FileNotFoundError):
        metrics.load_reader("nothing_here", [tmp_path])


def test_readers_report_nothing_they_cannot_read():
    ctx = _ctx(solves=0, latencies_s=[], elapsed_s=0.0)
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    out = metrics.read_metrics([{"name": n, "unit": "x"} for n in names], ctx)
    assert set(out) == {"setup_s"}
    full = metrics.read_metrics(
        [{"name": n, "unit": "x"} for n in names],
        _ctx(prepare_spans=[{"name": "knn.prepare", "dur_ms": 12.5}]))
    assert full["solve_qps"]["value"] == pytest.approx(1000 * 2 / 0.05)
    assert full["prepare_ms"]["value"] == 12.5
    assert full["host_syncs_per_solve"]["value"] == 1.0
    for name in ("kernel_ms", "kernels_roofline", "readback_ms",
                 "device_idle_pct", "peak_mem_gib"):
        assert name not in full


def test_host_launch_pairs_each_solve_with_its_first_fetch():
    ev = [{"name": "dispatch.fetch", "t0": 10.004, "dur_ms": 3.0},
          {"name": "dispatch.fetch", "t0": 10.0075, "dur_ms": 1.0},
          {"name": "knn.solve", "t0": 10.0, "dur_ms": 9.0},
          {"name": "dispatch.fetch", "t0": 10.012, "dur_ms": 3.0},
          {"name": "knn.solve", "t0": 10.010, "dur_ms": 5.0},
          {"name": "knn.solve", "t0": 10.020, "dur_ms": 1.0}]
    out = metrics.read_metrics([{"name": "host_launch_ms", "unit": "ms"}],
                               _ctx(window_spans=ev))
    # 4 ms and 2 ms; the last solve holds no fetch and counts not
    assert out["host_launch_ms"]["value"] == pytest.approx(3.0)


def test_a_new_cell_is_new_files_and_entries(tmp_path):
    bench_dir = tmp_path / "knnbench"
    shutil.copytree(spec.BENCH_DIR / "configs", bench_dir / "configs")
    (bench_dir / "traffic").mkdir()
    (bench_dir / "traffic" / "clustered.json").write_text(json.dumps(
        {"cloud": {"recipe": "clustered", "params": {"n_blobs": 12}},
         "warmup_solves": 1, "trace_solves": 2,
         "check_rows_per_solve": 4, "check_rows_max": 64}))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "ref900k_k50.clustered",
                               "config": "ref900k_k50",
                               "traffic": "clustered", "chips": 1,
                               "why": "skewed"})
    c = spec.cell(bench, "ref900k_k50.clustered", root=tmp_path,
                  bench_dir=bench_dir)
    assert c.traffic["cloud"]["recipe"] == "clustered"
    assert c.config["k"] == 50
    assert {m["name"] for m in c.end_to_end} == E2E
    # per-layer metrics that list their cells leave the new one out
    assert c.per_layer == []
