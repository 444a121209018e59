"""The port's spans on the profiler's timeline: while ``torch.profiler``
records, every live span opens a ``kntpu:<name>`` range, so a CPU
capture shows the solve's and the prepare's seams nested as the spans
nest; with neither a sink nor the profiler, ``span()`` stays the shared
no-op."""

import json
import os
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import cuda_knearests_tpu_torch as pt
from cuda_knearests_tpu_torch.io import generate_clustered
from cuda_knearests_tpu_torch.obs import device as pdevice
from cuda_knearests_tpu_torch.obs import spans
from cuda_knearests_tpu_torch.ops.adaptive import (build_adaptive_plan,
                                                  class_blocked_m)

CPU = "cpu"
PREFIX = spans.SCOPE_PREFIX


@pytest.fixture(scope="module")
def cloud():
    # a clustered cloud on a finer grid: several classes at a small size
    return generate_clustered(4000, seed=3)


def _config(**kw):
    return pt.KnnConfig(k=16, density=0.05, **kw)


def _ranges(prof, tmp_path):
    """The capture's ``kntpu:`` host ranges as (name, start, end)."""
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"][len(PREFIX):], float(e["ts"]),
             float(e["ts"]) + float(e["dur"])) for e in events
            if e.get("cat") == "user_annotation"
            and str(e.get("name", "")).startswith(PREFIX)]


def _parent(r, ranges):
    """The name of the innermost other range that encloses ``r``."""
    outer = [o for o in ranges if o is not r
             and o[1] <= r[1] and r[2] <= o[2]]
    return min(outer, key=lambda o: o[2] - o[1])[0] if outer else ""


@pytest.mark.parametrize("epilogue", ["scatter", "gather"])
def test_solve_seams_land_on_the_profiler_timeline(cloud, epilogue,
                                                   tmp_path):
    problem = pt.KnnProblem.prepare(cloud, _config(epilogue=epilogue),
                                    device=CPU)
    want = problem.solve()
    n_classes = len(problem.aplan.classes)
    assert n_classes >= 2
    col = spans.Collector()
    spans.add_sink(col)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            got = problem.solve()
    finally:
        spans.remove_sink(col)
    assert got.neighbors.tobytes() == want.neighbors.tobytes()
    ranges = _ranges(prof, str(tmp_path))
    # one range a span; the clustered cloud's uncertified rows take the
    # fallback's second fetch
    count = Counter(e["name"] for e in col.events)
    assert Counter(r[0] for r in ranges) == count
    assert count["knn.solve"] == count["solve.adaptive.launch"] == 1
    assert count["solve.adaptive.certify"] == 1
    assert count["solve.adaptive.class"] == n_classes
    assert count["dispatch.fetch"] == count["dispatch.fetch.wait"] >= 1
    # each range sits in the range of its span's parent, as the spans nest
    parent_of = {e["name"]: e["parent"] for e in col.events}
    assert parent_of["solve.adaptive.class"] == "solve.adaptive.launch"
    assert parent_of["dispatch.fetch.wait"] == "dispatch.fetch"
    for r in ranges:
        assert _parent(r, ranges) == parent_of[r[0]], r[0]
    cls = [e["attrs"] for e in col.events
           if e["name"] == "solve.adaptive.class"]
    assert [a["ci"] for a in cls] == list(range(n_classes))
    for a, cp in zip(cls, problem.aplan.classes):
        assert (a["route"], a["n_sc"], a["qcap"], a["ccap"], a["m"]) == (
            cp.route, cp.n_sc, cp.qcap, cp.ccap,
            class_blocked_m(problem.config, cp.ccap))


def test_prepare_splits_into_grid_and_plan(cloud):
    with spans.capture() as events:
        problem = pt.KnnProblem.prepare(cloud, _config(), device=CPU)
    by_name = {e["name"]: e for e in events}
    for name in ("prepare.grid", "prepare.plan"):
        assert by_name[name]["parent"] == "knn.prepare"
    assert (by_name["prepare.grid"]["dur_ms"]
            + by_name["prepare.plan"]["dur_ms"]
            <= by_name["knn.prepare"]["dur_ms"])
    # the plan from the counts read in prepare.grid equals one whose
    # counts the plan reads itself
    own = build_adaptive_plan(problem.grid, problem.config)
    got = problem.aplan
    assert len(got.classes) == len(own.classes)
    for a, b in zip(got.classes, own.classes):
        assert (a.route, a.radius, a.qcap, a.ccap, a.step_rows) == (
            b.route, b.radius, b.qcap, b.ccap, b.step_rows)
        for key in ("lo", "hi", "qid", "tgt"):
            assert torch.equal(getattr(a, key), getattr(b, key)), key
    assert torch.equal(got.inv_box, own.inv_box)
    assert np.array_equal(got.class_of_sc, own.class_of_sc)
    assert np.array_equal(got.row_of_sc, own.row_of_sc)


def test_no_sink_and_no_profiler_is_the_shared_no_op():
    assert not spans.enabled() and not spans.profiling()
    assert spans.span("probe.off") is spans.span("probe.off", a=1)
    assert type(spans.span("probe.off")).__name__ == "_NullSpan"


def test_the_profiler_alone_makes_a_span_live(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert spans.profiling() and spans.enabled()
        with spans.span("probe.on") as sp:
            pass
        with spans.span("probe.hidden", timeline=False):
            pass
    assert sp.dur_ms >= 0 and not spans.profiling()
    names = [r[0] for r in _ranges(prof, str(tmp_path))]
    assert names == ["probe.on"]


def test_a_capture_window_covers_no_scope(cloud):
    problem = pt.KnnProblem.prepare(cloud, _config(), device=CPU)
    problem.solve()
    rep = pdevice.profile_window(problem.solve, device=CPU)
    scopes = set(rep.decomposition["by_scope"])
    assert PREFIX + pdevice.WINDOW_SPAN not in scopes
    assert PREFIX + "solve.adaptive.class" in scopes
    assert not rep.unattributed
