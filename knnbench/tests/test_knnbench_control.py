"""The control (the reference in bfloat16 in the program's place) comes
out not correct; on the card, a short run of each cell is correct and
its control is not."""

import pytest
import torch

from knnbench import control, run, spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = spec.cell(BENCH, name)
    out = control.control_checks(cell, 2 ** 31 + 1, rows=128, device="cpu",
                                 n_points=4000)
    assert out["correct"] is False
    assert out["checks"]["d2_mismatch"]["value"] > 0
    same = control.control_checks(cell, 2 ** 31 + 1, rows=128,
                                  device="cpu", n_points=4000,
                                  dtype=torch.float32)
    assert same["correct"] is True


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name):
    cell = spec.cell(BENCH, name)
    out = run.run(cell, 12345, 1.0, True, device=card, n_points=200_000,
                  log=lambda *a: None)
    assert out["correct"] is True
    assert {"kernel_ms", "readback_ms", "device_idle_pct"} <= set(
        out["metrics"])
    assert 0 < out["metrics"]["kernels_roofline"]["value"] <= 100
    ctl = control.control_checks(cell, 12345, rows=512, device=card,
                                 n_points=200_000)
    assert ctl["correct"] is False
