"""``python -m cuda_knearests_tpu_torch.analysis``: the port's one-command
gate, under the reference CLI's contract.

Exit codes 0 clean / 1 contract or verifier violation (or a stale-schema
baseline) / 2 new lint finding / 3 both; the ``--json`` document has the
reference's keys; ``--write-baseline`` round-trips; and the reference's
refusals hold (``--paths`` with the contract engine, missing paths, a
fault whose engine does not run).  The full gate runs once in a process of
its own; the seeded faults run in-process through ``cli.main``.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from cuda_knearests_tpu_torch.analysis import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HAZARD = "import numpy as np\nx = np.float64(1.0)\n"


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """The routes' plain versions are many small torch operations; beside
    other test processes torch's CPU thread pool oversubscribes the cores,
    so this module runs torch on two threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _run(*args, env=None, module="cuda_knearests_tpu_torch.analysis"):
    # two threads a process, as this module's own torch (few_torch_threads)
    full_env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
                    OMP_NUM_THREADS="2")
    full_env.pop("KNTPU_ANALYSIS_FAULT", None)
    full_env.update(env or {})
    return subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                          env=full_env, capture_output=True, text=True,
                          timeout=600)


@pytest.fixture(scope="module")
def shipped_json():
    r = _run("--json")
    return r.returncode, json.loads(r.stdout), r.stderr


def test_cli_zero_on_shipped_tree(shipped_json):
    rc, doc, err = shipped_json
    assert rc == 0, err
    assert doc["ok"] is True and doc["counts"]["new"] == 0
    assert doc["counts"]["error"] == doc["counts"]["warning"] == 0
    rules = {f["rule"] for f in doc["findings"]}
    # all four engines ran: 19 proven windows, certificates, protocols
    assert {"sync-budget", "route-equiv", "proto-model",
            "recompile-key"} <= rules
    assert sum(f["rule"] == "sync-budget" for f in doc["findings"]) == 19
    assert "env-backend" not in rules


def test_json_keys_equal_the_reference_document(shipped_json, tmp_path):
    _rc, doc, _err = shipped_json
    bad = tmp_path / "hazard.py"
    bad.write_text(HAZARD)
    ref = _run("--paths", str(bad), "--json",
               module="cuda_knearests_tpu.analysis")
    assert ref.returncode == 2, ref.stderr
    ref_doc = json.loads(ref.stdout)
    assert set(doc) == set(ref_doc)
    assert doc["schema"] == ref_doc["schema"] == cli.JSON_SCHEMA == 1
    assert set(doc["counts"]) == set(ref_doc["counts"])
    assert set(doc["findings"][0]) == set(ref_doc["findings"][0])
    assert doc["analysis_version"] == ref_doc["analysis_version"]


@pytest.mark.parametrize("fault,engine", [
    ("scatter-map", "contracts"), ("hbm-model", "contracts"),
    ("tile-misalign", "contracts"), ("sync-leak", "verify"),
    ("sig-data-dep", "verify"), ("route-diverge", "verify"),
])
def test_seeded_fault_exits_one(fault, engine, monkeypatch, capsys):
    monkeypatch.setenv("KNTPU_ANALYSIS_FAULT", fault)
    assert cli.main(["--engine", engine]) == 1
    out = capsys.readouterr().out
    assert "NEW " in out


def test_cli_fault_flag_exits_one(capsys):
    assert cli.main(["--engine", "verify", "--fault", "sync-leak"]) == 1
    assert "sync-leak" in capsys.readouterr().out


def test_planted_lint_hazard_exits_two(tmp_path, capsys):
    bad = tmp_path / "hazard.py"
    bad.write_text(HAZARD)
    assert cli.main(["--paths", str(bad)]) == 2
    assert "wide-dtype" in capsys.readouterr().out


def test_both_kinds_exit_three(tmp_path, capsys):
    bad = tmp_path / "hazard.py"
    bad.write_text(HAZARD)
    stale = tmp_path / "stale.json"
    stale.write_text(json.dumps({"schema": 1, "fingerprints": []}))
    assert cli.main(["--paths", str(bad), "--baseline", str(stale)]) == 3
    assert "baseline-schema" in capsys.readouterr().out


def test_stale_schema_baseline_refused(tmp_path, capsys):
    ok = tmp_path / "ok.py"
    ok.write_text("x = 1\n")
    stale = tmp_path / "stale.json"
    stale.write_text(json.dumps({"schema": 1, "fingerprints": []}))
    assert cli.main(["--paths", str(ok), "--baseline", str(stale)]) == 1
    assert "baseline-schema" in capsys.readouterr().out


def test_write_baseline_roundtrip(tmp_path, capsys):
    bad = tmp_path / "hazard.py"
    bad.write_text(HAZARD)
    base = tmp_path / "base.json"
    assert cli.main(["--paths", str(bad), "--baseline", str(base),
                     "--write-baseline"]) == 0
    assert len(json.loads(base.read_text())["fingerprints"]) == 1
    assert cli.main(["--paths", str(bad), "--baseline", str(base)]) == 0
    bad.write_text(HAZARD + "y = np.float64(2.0)\n")
    assert cli.main(["--paths", str(bad), "--baseline", str(base)]) == 2
    capsys.readouterr()


@pytest.mark.parametrize("args", [
    ["--engine", "contracts", "--paths", "tests"],
    ["--paths", "no/such/path.py"],
    ["--paths", "tests/fixtures/lint_torch", "--fault", "hbm-model"],
    ["--engine", "contracts", "--fault", "sync-leak"],
])
def test_cli_refusals(args, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(args)
    assert e.value.code == 2
    capsys.readouterr()


def test_unseedable_env_fault_warns(monkeypatch, tmp_path, capsys):
    ok = tmp_path / "ok.py"
    ok.write_text("x = 1\n")
    monkeypatch.setenv("KNTPU_ANALYSIS_FAULT", "hbm-model")
    assert cli.main(["--paths", str(ok)]) == 0
    assert "no fault was seeded" in capsys.readouterr().err
