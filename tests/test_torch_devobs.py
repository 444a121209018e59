"""The port's device peaks, roofline, device-time capture and dispatch smoke
against the JAX package, on the CPU.

``solve_general`` takes the reference's arguments in the reference's order
(its three calls that raised before answer as JAX does; ``interpret=True``
is refused; ``query_chunk`` splits the selection and changes no byte);
``utils/roofline``'s counting law is the reference's, with the port's
class route 'kernel' counted by the reference's 'pallas' law and its
on-chip count under its own name; ``obs/attribution`` parses a
``torch.profiler`` trace (a kernel that runs after its launching span
closed still lands in that span, joined by correlation id);
``obs/device.hbm_fields`` follows the reference's law; ``profile_window``
and ``python -m cuda_knearests_tpu_torch.obs`` round-trip a CPU solve with
zero unattributed events; ``runtime.dispatch._smoke`` keeps every route
within the sync budget.
"""

import json

import numpy as np
import pytest
import torch

from cuda_knearests_tpu import mxu as jmxu
from cuda_knearests_tpu.obs import device as jdevice
from cuda_knearests_tpu.runtime import dispatch as jdispatch
from cuda_knearests_tpu.utils import roofline as jroof
import cuda_knearests_tpu_torch as pt
from cuda_knearests_tpu_torch import mxu as pmxu
from cuda_knearests_tpu_torch.io import get_dataset
from cuda_knearests_tpu_torch.obs import __main__ as obs_main
from cuda_knearests_tpu_torch.obs import attribution as attr
from cuda_knearests_tpu_torch.obs import device as pdevice
from cuda_knearests_tpu_torch.obs import spans
from cuda_knearests_tpu_torch.runtime import dispatch
from cuda_knearests_tpu_torch.utils import devinfo, roofline
from cuda_knearests_tpu_torch.utils.memory import InvalidConfigError

CPU = "cpu"


@pytest.fixture(scope="module")
def pts200():
    return np.random.default_rng(0).random((200, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def pts20k():
    return get_dataset("pts20K.xyz")


def _same_rows(a, b):
    assert a.neighbors.tobytes() == b.neighbors.tobytes()
    assert a.dists_sq.tobytes() == b.dists_sq.tobytes()


# -- solve_general's reference signature --------------------------------------

@pytest.mark.parametrize("call", ["query_chunk", "interpret", "positional"])
def test_solve_general_reference_calls_answer_as_jax(pts200, call):
    """The three calls that raised in the port (TypeError, TypeError, a
    ValueError from ``False`` bound to ``scorer``) answer as JAX does."""
    if call == "query_chunk":
        got = pmxu.solve_general(pts200, k=4, query_chunk=64, device=CPU)
        want = jmxu.solve_general(pts200, k=4, query_chunk=64)
        _same_rows(got, pmxu.solve_general(pts200, k=4, device=CPU))
    elif call == "interpret":
        got = pmxu.solve_general(pts200, k=4, interpret=False, device=CPU)
        want = jmxu.solve_general(pts200, k=4, interpret=False)
    else:
        got = pmxu.solve_general(pts200, 4, 1.0, True, "brute", None, False,
                                 device=CPU)
        want = jmxu.solve_general(pts200, 4, 1.0, True, "brute", None, False)
    _same_rows(got, want)
    assert np.array_equal(got.certified, want.certified)


def test_solve_general_refuses_interpret_mode(pts200):
    with pytest.raises(InvalidConfigError, match="interpret"):
        pmxu.solve_general(pts200, k=4, interpret=True, device=CPU)


@pytest.mark.parametrize("chunk", [1, 7, 64, 0])
def test_solve_general_query_chunk_changes_no_byte(chunk):
    """Chunked selections (external queries, unrefined at a recall target
    below 1, bf16) equal the one-launch answer byte for byte, certificates
    included."""
    rng = np.random.default_rng(3)
    pts = rng.random((700, 5)).astype(np.float32)
    q = rng.random((90, 5)).astype(np.float32)
    kw = dict(k=6, recall_target=0.7, refine="none", queries=q,
              precision="bf16", device=CPU)
    one = pmxu.solve_general(pts, **kw)
    got = pmxu.solve_general(pts, query_chunk=chunk, **kw)
    _same_rows(got, one)
    assert np.array_equal(got.certified, one.certified)


# -- device peaks and the roofline law ----------------------------------------

@pytest.mark.parametrize("kind, platform, entry, assumed", [
    ("NVIDIA H100 80GB HBM3", "cuda", "h100-sxm", False),
    (None, "cuda", "h100-sxm", True),
    ("NVIDIA H100 PCIe", "cuda", "h100-sxm", True),   # not the SXM entry
    ("NVIDIA H100 NVL", "cuda", "h100-sxm", True),
    (None, "cpu", "cpu", True),
    ("cpu", None, "cpu", False),
])
def test_device_peaks_resolve(kind, platform, entry, assumed):
    peaks = devinfo.device_peaks(kind, platform)
    assert peaks["entry"] == entry
    assert bool(peaks.get("assumed")) is assumed
    assert "match" not in peaks and peaks["basis"]
    if entry == "h100-sxm":
        assert (peaks["hbm_gbps"], peaks["peak_tflops_fp32"],
                peaks["peak_tflops"]) == (3350.0, 67.0, 989.0)
    assert devinfo.device_peaks("NVIDIA A100-SXM4-80GB", None) is None


def test_no_card_here_means_no_probe_and_no_properties():
    assert devinfo.current_device_kind() == (None, None)
    assert devinfo.device_properties() == []


_TUPLES = [(343, 120, 1152, "kernel", 10, "auto"),
           (343, 120, 1152, "kernel", 10, "blocked"),
           (4096, 104, 2304, "kernel", 50, "blocked"),
           (64, 40, 384, "kernel", 1, "kpass"),
           (12, 96, 4096, "streamed", 1000, "auto"),
           (9, 64, 768, "mxu", 10, "auto"),
           (20, 48, 640, "xla", 8, "kpass")]


@pytest.mark.parametrize("args", _TUPLES, ids=lambda a: f"{a[3]}-{a[5]}")
def test_class_counts_match_reference(args):
    ref_route = "pallas" if args[3] == "kernel" else args[3]
    got = roofline._class_counts(*args)
    want = jroof._class_counts(args[0], args[1], args[2], ref_route,
                               args[4], args[5])
    assert got.pop("onchip") == want.pop("vmem")
    assert got == want


def test_accumulate_matches_reference():
    rows = [roofline._class_counts(*a) for a in _TUPLES]
    got = roofline._accumulate(rows, 20_626, 10)
    jrows = [jroof._class_counts(a[0], a[1], a[2],
                                 "pallas" if a[3] == "kernel" else a[3],
                                 a[4], a[5]) for a in _TUPLES]
    want = jroof._accumulate(jrows, 20_626, 10)
    assert got.pop("onchip") == want.pop("vmem")
    assert got == want


def _law(n_sc, qcap, ccap, k, kernel_route, per_query=0):
    """The counting law spelled out from a plan's shapes."""
    pairs = n_sc * qcap * ccap
    read = n_sc * 16 * (qcap + ccap) + (0 if kernel_route else 4 * pairs)
    write = n_sc * qcap * k * 8 + (0 if kernel_route else 4 * pairs)
    return read, write, pairs, n_sc * qcap * per_query * 4


@pytest.mark.parametrize("route", ["adaptive", "legacy", "xla"])
def test_problem_traffic_counts_each_plan_from_its_shapes(pts20k, route):
    cfg = {"adaptive": pt.KnnConfig(k=10),
           "legacy": pt.KnnConfig(k=10, adaptive=False),
           "xla": pt.KnnConfig(k=10, adaptive=False, backend="xla")}[route]
    prob = pt.KnnProblem.prepare(pts20k, cfg, device=CPU)
    n, k = prob.grid.n_points, 10
    if route == "adaptive":
        parts = [_law(cp.n_sc, cp.qcap, cp.ccap, k, cp.route == "kernel",
                      k * cp.ccap if cp.route == "kernel" else 0)
                 for cp in prob.aplan.classes]
    elif route == "legacy":
        pk = prob.pack
        assert pk.qcap % 128 == 0
        parts = [_law(pk.s_total, pk.qcap, pk.ccap, k, True, k * pk.ccap)]
    else:
        pl = prob.plan
        assert prob.pack is None
        parts = [_law(pl.n_chunks * pl.batch, pl.qcap, pl.ccap, k, False)]
    got = roofline.problem_traffic(prob)
    read = sum(p[0] for p in parts) + n * k * 8
    write = sum(p[1] for p in parts) + n * k * 8
    assert got["hbm_read"] == read and got["hbm_write"] == write
    assert got["hbm_total"] == read + write
    assert got["pairs"] == sum(p[2] for p in parts)
    assert got["flops"] == 8 * got["pairs"]
    assert got["onchip"] == sum(p[3] for p in parts)


def test_roofline_fields_against_the_card_entry():
    traffic = {"hbm_total": 4_465_000_000, "flops": 10_205_000_000,
               "onchip": 5_000_000_000}
    out = roofline.roofline_fields(traffic, 0.5, "cuda",
                                   device_kind="NVIDIA H100 80GB HBM3")
    assert out["achieved_hbm_gbps"] == 8.93
    assert out["pct_hbm_roofline"] == round(100 * 8.93 / 3350.0, 2)
    assert out["pct_flops_roofline"] == round(100 * 20.41e-3 / 67.0, 4)
    assert out["roofline_flops_precision"] == "fp32"
    assert "assumed" not in out["roofline_peak_source"]
    assert out["achieved_onchip_gbps"] == 10.0
    assert "pct_onchip_roofline" not in out and "vmem" not in str(out)
    cpu = roofline.roofline_fields(traffic, 0.5, "cpu")
    assert "(assumed from platform)" in cpu["roofline_peak_source"]
    assert "pct_flops_roofline" not in cpu and "device_kind" not in cpu
    assert roofline.roofline_fields(None, 1.0, "cuda") == {}


# -- the capture parser on a synthetic torch-style trace ----------------------

_TOPK = ("void (anonymous namespace)::supercell_topk_kernel<1>(float const*, "
         "float const*, float const*, int const*, float const*, float "
         "const*, float const*, int const*, int, int, int, int, int const*, "
         "int, float*, int*, int, int)")


@pytest.mark.parametrize("name, lib", [
    (_TOPK, "supercell_topk"),
    ("void (anonymous namespace)::blocked_topk_kernel<2>(float const*, "
     "int)", "blocked_topk"),
    ("(anonymous namespace)::select_kernel(float const*, float const*)",
     "mxu_select"),
    ("void (anonymous namespace)::select_kernel<2>(__nv_bfloat16 const*, "
     "float const*)", "mxu_select_bf16"),
    ("void (anonymous namespace)::select_kernel(unsigned long const*, int)",
     "mxu_select_split"),
    ("void (anonymous namespace)::prep_kernel(float const*, int const*, "
     "int, int, int, float*, float*, float*)", "mxu_select"),
    ("void (anonymous namespace)::prep_kernel(float const*, int const*, "
     "int, int, int, __nv_bfloat16*, float*, float*, float*)",
     "mxu_select_bf16"),
    ("void (anonymous namespace)::fold_kernel<true>(void const*, int)",
     "mxu_select_split"),
    ("void (anonymous namespace)::direct_kernel<false, 3>(void const*)",
     "mxu_select_split"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "FillFunctor<float> >(int)", None),
    ("void at::native::(anonymous namespace)::select_kernel(float)", None),
])
def test_library_of(name, lib):
    assert attr.library_of(name) == lib


def _x(name, cat, ts, dur, tid=1, pid=5, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _gpu_trace():
    """Anchor at ts 1000 us for 10 ms; the solve scope closes at 3000 us,
    before the class kernel it launched (corr 7) runs at 5000 us."""
    return [
        _x("kntpu.capture:cap1", "user_annotation", 1000, 10_000),
        _x("kntpu:adaptive-solve", "user_annotation", 1100, 1900),
        _x("kntpu:adaptive-solve", "gpu_user_annotation", 4000, 3000,
           tid=7, pid=0),
        _x("aten::topk", "cpu_op", 1150, 200),
        _x("cudaLaunchKernel", "cuda_runtime", 1200, 10, correlation=7),
        _x("cudaLaunchKernel", "cuda_runtime", 1320, 10, correlation=8),
        _x(_TOPK, "kernel", 5000, 1000, tid=7, pid=0, correlation=7),
        _x("void at::native::reduce_kernel<512>(int)", "kernel", 6100, 50,
           tid=7, pid=0, correlation=8),
        _x("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 8000, 200,
           tid=7, pid=0, correlation=99),
        _x("cudaLaunchKernel", "cuda_runtime", 90_000, 10, correlation=9),
        _x(_TOPK, "kernel", 91_000, 1000, tid=7, pid=0, correlation=9),
    ]


def _host_spans(anchor_wall):
    base = {"v": spans.SCHEMA, "kind": "span", "pid": 5, "job": "t",
            "tid": "MainThread", "trace_id": None, "attrs": {}}
    return [dict(base, name=pdevice.WINDOW_SPAN, t0=anchor_wall + 1e-5,
                 dur_ms=9.9, depth=0, parent=""),
            dict(base, name="solve.adaptive.launch",
                 t0=anchor_wall + 1.2e-4, dur_ms=0.6, depth=1,
                 parent=pdevice.WINDOW_SPAN)]


def test_attribute_joins_a_late_kernel_to_its_launch():
    anchor_wall = 1000.0
    events, outside = attr.rebase(_gpu_trace(), anchor_wall, "cap1")
    assert outside == 2          # the launch and kernel of corr 9
    kinds = {e.name[:20]: e.kind for e in events}
    assert kinds["aten::topk"] == "op"
    assert sum(e.kind == "scope" for e in events) == 1  # not the GPU mirror
    got, missing = attr.attribute(events, _host_spans(anchor_wall))
    assert not missing
    by_mod = {a.event.module: a for a in got}
    topk = by_mod["supercell_topk"]
    # the kernel ran at 4-5 ms, after its span (0.12-0.72 ms) and scope
    # closed; its launch at 0.2 ms puts it there
    assert topk.event.t0 > anchor_wall + 3e-3
    assert (topk.span_name, topk.scope, topk.joined) == (
        "solve.adaptive.launch", "kntpu:adaptive-solve", "correlation")
    # a PyTorch kernel is named by the op that launched it; a copy with no
    # launch record falls back to its own midpoint (the window span)
    assert by_mod["torch:aten::topk"].span_name == "solve.adaptive.launch"
    copy = by_mod["gpu_memcpy"]
    assert (copy.span_name, copy.scope, copy.joined) == (
        pdevice.WINDOW_SPAN, None, "midpoint")
    dec = attr.decomposition(got, missing, events=events)
    assert dec["by_module"]["supercell_topk"] == 1.0
    assert dec["by_scope"]["kntpu:adaptive-solve"] == 1.05
    assert (dec["events"], dec["unattributed"],
            dec["joined_by_correlation"]) == (3, 0, 2)
    mounted = attr.mount(got, job="dev")
    assert all(spans.validate_event(ev) is None for ev in mounted)
    assert {ev["tid"] for ev in mounted} == {"device:7"}


def test_a_drifted_device_clock_keeps_launched_events():
    """The device clock, converted to the host's, can drift from it over a
    long process: a kernel stamped 200 ms after the window closed is kept
    and attributed by its launch, and the lag shows the drift."""
    trace = _gpu_trace()
    for ev in trace:
        if ev["cat"] in ("kernel", "gpu_memcpy") and ev["ts"] < 50_000:
            ev["ts"] += 200_000
    events, outside = attr.rebase(trace, 1000.0, "cap1")
    got, missing = attr.attribute(events, _host_spans(1000.0))
    assert outside == 3   # corr 9 as before, and the unlaunched copy
    assert not missing
    topk = next(a for a in got if a.event.module == "supercell_topk")
    assert topk.span_name == "solve.adaptive.launch"
    dec = attr.decomposition(got, missing)
    assert dec["launch_to_start_ms"]["min"] > 200.0


def test_attribute_reports_events_no_span_covers():
    events, _ = attr.rebase(_gpu_trace(), 1000.0, "cap1")
    got, missing = attr.attribute(events, _host_spans(1000.0)[1:])
    assert [a.event.module for a in got] == ["supercell_topk",
                                             "torch:aten::topk"]
    assert [e.module for e in missing] == ["gpu_memcpy"]


def test_cpu_only_capture_takes_top_level_ops():
    trace = [_x("kntpu.capture:c", "user_annotation", 0, 1000),
             _x("kntpu:adaptive-solve", "user_annotation", 10, 500),
             _x("aten::matmul", "cpu_op", 20, 300),
             _x("aten::mm", "cpu_op", 30, 200),
             _x("aten::topk", "cpu_op", 600, 100)]
    events, outside = attr.rebase(trace, 50.0, "c")
    execs = [e for e in events if e.kind == "exec"]
    assert outside == 0
    assert [(e.name, e.tid) for e in execs] == [("aten::matmul", "cpu:1"),
                                               ("aten::topk", "cpu:1")]
    host = [{"v": spans.SCHEMA, "kind": "span", "name": "w", "t0": 50.0,
             "dur_ms": 1.0, "depth": 0, "parent": "", "pid": 1, "job": "",
             "tid": "m", "trace_id": None, "attrs": {}}]
    got, missing = attr.attribute(events, host)
    assert not missing
    assert [a.scope for a in got] == ["kntpu:adaptive-solve", None]


def test_device_activity_and_the_host_anchor():
    trace = _gpu_trace()
    assert attr.saw_device_activity(trace)
    host = [ev for ev in trace if ev["cat"] not in ("kernel", "gpu_memcpy")]
    assert not attr.saw_device_activity(host)
    # a complete capture: every launch in the window has its device event;
    # one the profiler dropped is reported
    events, _ = attr.rebase(trace, 1000.0, "cap1")
    assert attr.unmatched_launches(events) == []
    dropped = [ev for ev in trace if ev.get("args", {}).get("correlation")
               != 8 or ev["cat"] != "kernel"]
    events, _ = attr.rebase(dropped, 1000.0, "cap1")
    assert [e.correlation for e in attr.unmatched_launches(events)] == [8]
    # the anchor's device-lane mirror (GPU time) never anchors the window
    mirror = _x("kntpu.capture:cap1", "gpu_user_annotation", 900_000, 5,
                tid=7, pid=0)
    a, _ = attr.rebase(trace, 1000.0, "cap1")
    b, _ = attr.rebase([mirror] + trace, 1000.0, "cap1")
    assert [e.t0 for e in a if e.kind != "anchor"] == \
        [e.t0 for e in b if e.kind != "anchor"]


def test_rebase_without_the_anchor_raises():
    with pytest.raises(ValueError, match="capture anchor"):
        attr.rebase(_gpu_trace()[1:], 1000.0, "cap1")
    with pytest.raises(ValueError, match="capture anchor"):
        attr.rebase(_gpu_trace(), 1000.0, "other-id")


# -- measured memory, capture windows, the smokes -----------------------------

@pytest.mark.parametrize("sample, model", [
    ({"peak": 900, "floor": 100, "samples": 5, "source": "s"}, 700),
    ({"peak": 900, "floor": 100, "samples": 5, "source": "s"}, 600),
    ({"peak": 50, "floor": 100, "samples": 2, "source": "s"}, 0),
    ({"peak": 10, "floor": 0, "samples": 1, "source": "s"}, None),
])
def test_hbm_fields_follow_the_reference_law(sample, model):
    got = pdevice.hbm_fields(sample, model)
    want = jdevice.hbm_fields(sample, model)
    assert set(got) == set(want)
    for key in want:
        if key != "hbm_model_verdict":
            assert got[key] == want[key], key
    assert pdevice.HBM_MODEL_HEADROOM == jdevice.HBM_MODEL_HEADROOM


def test_profile_window_round_trips_a_cpu_solve(pts20k):
    prob = pt.KnnProblem.prepare(pts20k, pt.KnnConfig(k=8), device=CPU)
    want = prob.solve()
    model = pdevice.problem_hbm_model(prob)
    rep = pdevice.profile_window(prob.solve, device=CPU, trace_id="t1",
                                 hbm_model_bytes=model)
    assert rep.ret.neighbors.tobytes() == want.neighbors.tobytes()
    assert rep.attributed and not rep.unattributed
    dec = rep.decomposition
    assert dec["unattributed"] == 0 and dec["events"] == len(rep.attributed)
    assert "kntpu:adaptive-solve" in dec["by_scope"]
    assert {"knn.solve", "solve.adaptive.launch"} & set(dec["by_span"])
    assert all(e.tid.startswith("cpu:") for e in rep.device_events
               if e.kind == "exec")
    assert rep.hbm["hbm_model_ok"] is True
    assert rep.hbm["hbm_measured_source"] == "live_tensors"
    assert model >= 2 * 4 * prob.grid.n_points * 8
    assert all(spans.validate_event(ev) is None for ev in rep.mounted)
    # sessions do not nest, and a failure inside the window propagates
    with pytest.raises(pdevice.CaptureError, match="nest"):
        pdevice.profile_window(
            lambda: pdevice.profile_window(lambda: None, device=CPU),
            device=CPU)
    with pytest.raises(ZeroDivisionError):
        pdevice.profile_window(lambda: 1 / 0, device=CPU)


def test_obs_main_cpu_all_stages(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("KNTPU_OBS_N", "2000")
    monkeypatch.setitem(spans._proc_tag, "job", spans._proc_tag["job"])
    rc = obs_main.main(["--device", "cpu", "--stage", "all",
                        "--out-dir", str(tmp_path)])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0, summary
    assert summary["ok"] and summary["n"] == 2000
    assert summary["device_unattributed"] == 0
    assert summary["device_events"] > 0 and summary["hbm_model_ok"]
    merged = json.loads((tmp_path / "trace_merged.json").read_text())
    tids = {str(ev.get("tid")) for ev in merged["traceEvents"]}
    assert any(t.startswith("device:cpu:") for t in tids)
    assert "MainThread" in tids


def test_dispatch_smoke_on_the_cpu(capsys):
    assert dispatch._smoke(n=2000, device=CPU) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith('{"route"')]
    assert [r["route"] for r in rows] == [
        "adaptive-solve", "legacy-pack-solve", "external-query[adaptive]",
        "external-query[chunked]", "sharded-solve", "sharded-query"]
    assert all(r["ok"] and r["host_syncs"] <= dispatch.SYNC_BUDGET
               for r in rows)
    assert set(dispatch.stats().as_dict()) == set(
        jdispatch.DispatchStats().as_dict())


@pytest.mark.parametrize("main", [obs_main.main, dispatch._main])
def test_smokes_refuse_without_a_card(main, monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["--out-dir", str(tmp_path)] if main is obs_main.main
                else []) == 4
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["failure_kind"] == "no-device"
