"""The port's command line (``python -m cuda_knearests_tpu_torch.cli``)
against the JAX package's, on the CPU.

The same ``.xyz`` file (the reference's 20k fixture, regenerated from its
seed) goes through both CLIs: the JAX one once in a subprocess (its
watchdog thread would outlive an in-process call), the port's in-process
with ``--device cpu``; the summaries agree on n, k, mode and the exact
count, with no hard mismatch against the kd-tree.  The refusals keep the
reference's exit codes: rc 5 for the input contract (NaN coordinates, a
corrupt header, an illegal k), rc 4 ``no-device`` when no card exists and
no ``--device`` was given.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cuda_knearests_tpu import cli as jcli
from cuda_knearests_tpu_torch import cli
from cuda_knearests_tpu_torch import io as pio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _summary(out: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    assert lines, f"no JSON summary line in: {out!r}"
    return json.loads(lines[-1])


@pytest.fixture(scope="module")
def xyz20k(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "pts20K.xyz"
    pio.save_xyz(str(path), pio.get_dataset("pts20K.xyz"))
    return str(path)


def test_cli_matches_the_jax_cli_on_pts20k(xyz20k, tmp_path, capsys):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    ref = subprocess.run(
        [sys.executable, "-m", "cuda_knearests_tpu.cli", xyz20k, "--k", "10",
         "--json"], capture_output=True, text=True, timeout=240, cwd=REPO,
        env=env)
    assert ref.returncode == 0, ref.stdout + ref.stderr
    want = _summary(ref.stdout)
    save = tmp_path / "rows.npz"
    rc = cli.main([xyz20k, "--k", "10", "--device", "cpu", "--json",
                   "--save", str(save)])
    out = capsys.readouterr().out
    got = _summary(out)
    assert rc == 0, out
    assert "There are 0 CUDA devices" in out and "OK" in out
    for key in ("n", "k", "mode", "exact", "hard"):
        assert got[key] == want[key], key
    assert got["hard"] == 0 and got["platform"] == "cpu"
    rows = np.load(save)
    assert rows["neighbors"].shape == (want["n"], 10)
    assert np.all(np.diff(rows["dists_sq"], axis=1) >= 0)


def test_cli_sharded_on_the_cpu(xyz20k, capsys):
    rc = cli.main([xyz20k, "--k", "6", "--device", "cpu", "--sharded", "2",
                   "--json"])
    got = _summary(capsys.readouterr().out)
    assert rc == 0
    assert (got["mode"], got["hard"]) == ("sharded", 0)
    assert got["slab_devices"] == ["cpu", "cpu"]


@pytest.mark.parametrize("text, k, needle", [
    ("3\n1 2 3\nnan 5 6\n7 8 9\n", 2, "NaN"),
    ("5\n0 0 0\n1 1 1\n", 2, "header"),
    ("2\n1 2 3\n4 5 6\n", 0, "k must be"),
], ids=["nan", "corrupt-header", "illegal-k"])
def test_cli_input_contract_exits_rc5(tmp_path, capsys, text, k, needle):
    path = tmp_path / "bad.xyz"
    path.write_text(text)
    rc = cli.main([str(path), "--k", str(k), "--device", "cpu"])
    cap = capsys.readouterr()
    assert rc == 5, cap.out + cap.err
    line = _summary(cap.out)
    assert line["failure_kind"] == "invalid-input" and needle in line["error"]
    assert "REFUSED [invalid-input]" in cap.err


def test_cli_without_a_card_exits_rc4_no_device(tmp_path, monkeypatch,
                                                capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "ok.xyz"
    path.write_text("2\n1 2 3\n4 5 6\n")
    rc = cli.main([str(path), "--k", "1"])
    cap = capsys.readouterr()
    assert rc == 4
    line = _summary(cap.out)
    assert line["failure_kind"] == "no-device"
    assert "There are" not in cap.out  # refused before touching anything


def test_recall_and_tie_split_are_the_references():
    rng = np.random.default_rng(9)
    pts = rng.integers(0, 6, (300, 3)).astype(np.float32) * 10.0
    ref_ids = np.argsort(((pts[:, None] - pts[None]) ** 2).sum(-1)
                         + np.eye(300) * 1e9, axis=1, kind="stable")[:, :5]
    ref_d2 = np.take_along_axis(((pts[:, None] - pts[None]) ** 2).sum(-1),
                                ref_ids, 1)
    got = ref_ids.copy()
    got[::7, -1] = (got[::7, -1] + 1) % 300   # some ties, some hard
    assert cli.set_recall(got, ref_ids) == jcli.set_recall(got, ref_ids)
    assert cli._tie_aware_mismatches(pts, got, ref_ids, ref_d2) == \
        jcli._tie_aware_mismatches(pts, got, ref_ids, ref_d2)


def test_cli_capture_on_the_cpu(xyz20k, capsys):
    """``--capture``: one more solve under ``obs.device.profile_window``,
    every event attributed, the memory verdict and the timed solve's
    roofline in the summary; refused beside ``--sharded``."""
    rc = cli.main([xyz20k, "--k", "8", "--device", "cpu", "--no-oracle",
                   "--json", "--capture"])
    got = _summary(capsys.readouterr().out)
    assert rc == 0
    dec = got["device_time_decomposition"]
    assert dec["events"] > 0 and dec["unattributed"] == 0
    assert "kntpu:adaptive-solve" in dec["by_scope"]
    assert got["hbm_model_ok"] is True
    assert got["moved_hbm_gb"] > 0 and "pct_hbm_roofline" in got
    assert "(assumed from platform)" in got["roofline_peak_source"]
    with pytest.raises(SystemExit):
        cli.main([xyz20k, "--device", "cpu", "--sharded", "2", "--capture"])
