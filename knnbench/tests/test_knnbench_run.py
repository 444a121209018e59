"""A whole run on the CPU at a small size, with and without the trace,
and with the timed path broken underneath: each fault a cell of
all-points solves can have makes ``correct`` false."""

import dataclasses

import numpy as np
import pytest

import cuda_knearests_tpu_torch as program
from knnbench import run, spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
N = 3000


def _run(name, trace=False, seconds=0.3, seed=2 ** 31 + 3):
    return run.run(spec.cell(BENCH, name), seed, seconds, trace,
                   device="cpu", n_points=N, log=lambda *a: None)


@pytest.mark.parametrize("name", CELLS)
def test_run_is_correct(name):
    out = _run(name)
    assert out["correct"] is True
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"solve_qps", "solve_p95_ms", "setup_s"}
    assert list(out)[-1] == "checks"
    assert out["checks"]["rows_checked"]["value"] > 0
    assert out["device"]["platform"] == "cpu"


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_the_layers_it_can(name):
    out = _run(name, trace=True)
    assert out["correct"] is True
    # a CPU run has no device events: the device metrics are left out
    assert set(out["metrics"]) == {"prepare_ms", "host_launch_ms",
                                   "host_syncs_per_solve"}
    assert out["metrics"]["host_syncs_per_solve"]["value"] == 1.0
    assert out["metrics"]["host_launch_ms"]["value"] > 0
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(out["breakdown"]["idle_gaps"]) <= 10


def _broken(monkeypatch, alter):
    solve = program.KnnProblem.solve

    def faulty(self):
        return alter(self, solve(self))

    monkeypatch.setattr(program.KnnProblem, "solve", faulty)


def _replace(res, **kw):
    return dataclasses.replace(res, **kw)


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    def alter(problem, res):
        ids = res.neighbors.copy()
        ids[:, -1] = (ids[:, -1] + 1) % ids.shape[0]
        return _replace(res, neighbors=ids)

    _broken(monkeypatch, alter)
    out = _run(CELLS[0])
    assert out["correct"] is False
    assert out["checks"]["id_mismatch"]["value"] > 0


def test_half_the_rows_left_unanswered(monkeypatch):
    def alter(problem, res):
        ids, d2 = res.neighbors.copy(), res.dists_sq.copy()
        ids[ids.shape[0] // 2:] = -1
        d2[d2.shape[0] // 2:] = np.inf
        return _replace(res, neighbors=ids, dists_sq=d2)

    _broken(monkeypatch, alter)
    out = _run(CELLS[1])
    assert out["correct"] is False
    assert out["checks"]["d2_mismatch"]["value"] > 0


def test_rows_left_uncertified(monkeypatch):
    def alter(problem, res):
        return _replace(res, certified=np.zeros_like(res.certified))

    _broken(monkeypatch, alter)
    out = _run(CELLS[0])
    assert out["correct"] is False
    assert out["checks"]["uncertified"]["value"] > 0


def test_a_broken_permutation(monkeypatch):
    prepare = program.KnnProblem.prepare.__func__

    def faulty(cls, *a, **kw):
        problem = prepare(cls, *a, **kw)
        problem.grid.permutation[1] = problem.grid.permutation[0]
        return problem

    monkeypatch.setattr(program.KnnProblem, "prepare", classmethod(faulty))
    out = _run(CELLS[1])
    assert out["correct"] is False
    assert out["checks"]["perm_violations"]["value"] == 1


def test_a_solve_that_raises(monkeypatch):
    solve = program.KnnProblem.solve
    calls = []

    def faulty(self):
        calls.append(1)
        if len(calls) > 3:          # warm-up passes, the window fails
            raise RuntimeError("device fault")
        return solve(self)

    monkeypatch.setattr(program.KnnProblem, "solve", faulty)
    out = _run(CELLS[0], seconds=0.05)
    assert out["correct"] is False and out["failed"] >= 1
    assert out["checks"]["failed_solves"]["value"] == out["failed"]
