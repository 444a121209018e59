"""The benchmark's readers of the port's in-program spans, on a hand-made
Chrome trace (device events joined to their launch calls by correlation,
the ``kntpu:`` host ranges) and on a whole traced run on the CPU."""

import pytest

from knnbench import context, metrics, run, scopes, spec, trace

NEW = ("prepare_grid_ms", "prepare_plan_ms", "select_device_ms",
       "epilogue_device_ms", "fetch_wait_ms", "program_idle_pct",
       "untracked_syncs_per_solve")
DEVICE = ("select_device_ms", "epilogue_device_ms", "program_idle_pct",
          "untracked_syncs_per_solve")


def _host(name, ts, dur):
    return {"cat": "user_annotation", "name": scopes.PREFIX + name,
            "ts": ts, "dur": dur}


def _call(name, ts, corr):
    return {"cat": "cuda_runtime", "name": name, "ts": ts, "dur": 2.0,
            "args": {"correlation": corr}}


def _dev(cat, name, ts, dur, corr):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _events():
    """Two solves in a 1,000 us window.  Solve 1's class kernel (corr 1)
    runs after its class range closed; the device lane's mirror of the
    class range covers the epilogue's launch (corr 2) and must not be
    read; one wait inside a fetch, one outside it, one between solves."""
    return [
        {"cat": "user_annotation", "name": trace.WINDOW, "ts": 0.0,
         "dur": 1000.0},
        _host("knn.solve", 10.0, 390.0), _host("knn.solve", 500.0, 400.0),
        _host("solve.adaptive.launch", 20.0, 180.0),
        _host("solve.adaptive.launch", 520.0, 100.0),
        _host("solve.adaptive.class", 30.0, 70.0),
        _host("solve.adaptive.class", 530.0, 70.0),
        _host("solve.adaptive.certify", 200.0, 20.0),
        _host("dispatch.fetch", 300.0, 90.0),
        _host("dispatch.fetch", 800.0, 90.0),
        {"cat": "gpu_user_annotation",
         "name": scopes.PREFIX + "solve.adaptive.class", "ts": 150.0,
         "dur": 110.0},
        _call("cudaLaunchKernel", 40.0, 1),
        _dev("kernel", "supercell_topk_kernel<2>", 150.0, 100.0, 1),
        _call("cudaLaunchKernel", 210.0, 2),
        _dev("kernel", "where", 260.0, 20.0, 2),
        _call("cudaMemcpyAsync", 305.0, 3),
        _dev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 300.0, 60.0, 3),
        _call("cudaStreamSynchronize", 310.0, 10),
        _call("cudaStreamSynchronize", 250.0, 11),
        _call("cudaStreamSynchronize", 450.0, 12),
        _call("cudaLaunchKernel", 540.0, 4),
        _dev("kernel", "supercell_topk_kernel<2>", 560.0, 100.0, 4),
        _call("cudaLaunchKernel", 700.0, 5),
        _dev("kernel", "fill", 720.0, 30.0, 5),
    ]


def _ctx(events, window_spans=()):
    cap = trace.Capture(events=events, t0_us=0.0, t1_us=1000.0,
                        wall0=1000.0, spans=[], solves=2)
    return context.RunContext(
        n=100, k=10, d=3, device_kind="NVIDIA H100 80GB HBM3", setup_s=1.0,
        latencies_s=[0.001], solves=1, elapsed_s=0.001, peak_mem_bytes=1,
        counters={"host_syncs": 1}, prepare_spans=[],
        window_spans=list(window_spans), capture=cap)


def _read(name, ctx):
    return metrics.load_reader(name)(ctx)


def test_a_kernel_counts_to_the_range_open_at_its_launch():
    ctx = _ctx(_events())
    # the class kernels, the first run after its range closed; the
    # epilogue's where and fill
    assert _read("select_device_ms", ctx) == pytest.approx(0.1)
    assert _read("epilogue_device_ms", ctx) == pytest.approx(0.025)
    assert (_read("select_device_ms", ctx) + _read("epilogue_device_ms", ctx)
            == pytest.approx(_read("kernel_ms", ctx)))


def test_copies_count_to_neither_kernel_metric():
    ev = _events()
    ev.append(_call("cudaMemcpyAsync", 50.0, 6))
    ev.append(_dev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 60.0,
                   500.0, 6))
    ctx = _ctx(ev)
    assert _read("select_device_ms", ctx) == pytest.approx(0.1)
    assert _read("epilogue_device_ms", ctx) == pytest.approx(0.025)


def test_only_waits_outside_the_fetch_count():
    cap = _ctx(_events()).capture
    assert scopes.untracked_syncs(cap) == [
        ("cudaStreamSynchronize", scopes.PREFIX + "knn.solve")]
    assert _read("untracked_syncs_per_solve", _ctx(_events())) == 0.5
    quiet = [e for e in _events() if (e.get("args") or {}).get(
        "correlation") != 11]
    assert _read("untracked_syncs_per_solve", _ctx(quiet)) == 0.0


def test_program_idle_is_the_solves_share_of_device_idle():
    ctx = _ctx(_events())
    prog = _read("program_idle_pct", ctx)
    dev = _read("device_idle_pct", ctx)
    # idle inside the solves: 10-150, 250-260, 280-300, 360-400, 500-560,
    # 660-720, 750-900
    assert prog == pytest.approx(100.0 * 480.0 / 1000.0)
    assert prog <= dev


def test_a_program_without_the_spans_reads_nothing():
    # the parent's trace: no kntpu: ranges (its one scope had another name)
    bare = [e for e in _events() if not str(e["name"]).startswith(
        scopes.PREFIX)]
    ctx = _ctx(bare)
    assert _read("kernel_ms", ctx) > 0
    for name in NEW:
        assert _read(name, ctx) is None, name


def test_fetch_wait_is_the_median_solve_wait():
    sp = [{"name": "knn.solve", "t0": 10.0, "dur_ms": 10.0},
          {"name": "dispatch.fetch.wait", "t0": 10.005, "dur_ms": 2.0},
          {"name": "knn.solve", "t0": 20.0, "dur_ms": 10.0},
          {"name": "dispatch.fetch.wait", "t0": 20.004, "dur_ms": 1.0},
          {"name": "dispatch.fetch.wait", "t0": 20.008, "dur_ms": 0.5},
          {"name": "knn.solve", "t0": 30.0, "dur_ms": 10.0},
          {"name": "dispatch.fetch.wait", "t0": 30.005, "dur_ms": 4.0}]
    assert _read("fetch_wait_ms", _ctx(_events(), sp)) == 2.0


@pytest.mark.parametrize("name", ["ref900k_k50.blue",
                                  "uniform10m_k10.uniform"])
def test_a_traced_cpu_run_reads_the_program_spans(name):
    out = run.run(spec.cell(spec.load_benchmark(), name), 2 ** 31 + 5, 0.2,
                  True, device="cpu", n_points=2000, log=lambda *a: None)
    got = out["metrics"]
    assert out["correct"] is True
    for key in ("prepare_grid_ms", "prepare_plan_ms", "fetch_wait_ms"):
        assert got[key]["value"] >= 0, key
    assert (got["prepare_grid_ms"]["value"] + got["prepare_plan_ms"]["value"]
            <= got["prepare_ms"]["value"])
    assert not set(got) & set(DEVICE)
