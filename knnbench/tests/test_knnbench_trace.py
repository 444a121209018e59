"""The profiler reduction on a hand-made capture, and one real capture on
the CPU."""

import pytest

from cuda_knearests_tpu_torch.obs import spans
from knnbench import trace


def _capture():
    ev = [
        {"cat": "user_annotation", "name": trace.WINDOW, "ts": 0.0,
         "dur": 100.0},
        {"cat": "kernel", "name": "topk", "ts": 10.0, "dur": 20.0,
         "args": {"correlation": 1}},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pinned)",
         "ts": 25.0, "dur": 15.0, "args": {"correlation": 2}},
        {"cat": "kernel", "name": "where", "ts": 60.0, "dur": 10.0,
         "args": {"correlation": 3}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 5.0,
         "dur": 1.0, "args": {"correlation": 1}},
        {"cat": "cpu_op", "name": "aten::where", "ts": 41.0, "dur": 10.0},
        {"cat": "kernel", "name": "late", "ts": 150.0, "dur": 5.0},
    ]
    sp = [{"name": "knn.solve", "t0": 1000.0, "dur_ms": 0.09, "depth": 0},
          {"name": "dispatch.fetch", "t0": 1000.00004, "dur_ms": 0.02,
           "depth": 1}]
    return trace.Capture(events=ev, t0_us=0.0, t1_us=100.0, wall0=1000.0,
                         spans=sp, solves=2)


def test_busy_gaps_and_times():
    cap = _capture()
    assert cap.window_s == pytest.approx(1e-4)
    assert cap.busy_intervals() == [(10.0, 40.0), (60.0, 70.0)]
    assert cap.busy_s() == pytest.approx(40e-6)
    assert cap.gaps() == [(0.0, 10.0), (40.0, 60.0), (70.0, 100.0)]
    assert cap.device_s(("kernel",)) == pytest.approx(30e-6)
    assert cap.device_s(("gpu_memcpy",),
                        lambda n: "DtoH" in n) == pytest.approx(15e-6)
    assert cap.dropped() == 0
    cap.events.append({"cat": "cuda_runtime", "name": "cudaMemcpyAsync",
                       "ts": 7.0, "dur": 1.0, "args": {"correlation": 9}})
    assert cap.dropped() == 1


def test_breakdown_labels_idle_time_by_the_host():
    cap = _capture()
    assert cap.host_label(45.0) == "dispatch.fetch | aten::where"
    assert cap.host_label(99.5) == "no span | " + trace.WINDOW
    b = cap.breakdown()
    assert b["device_ops"][0] == ["topk", pytest.approx(20e-6)]
    total_idle = sum(s for _, s in b["idle_gaps"])
    assert total_idle == pytest.approx(60e-6)


def test_a_cpu_capture_finds_its_window():
    cap = trace.capture(lambda: sum(range(1000)), 3, False, spans)
    assert cap.solves == 3 and cap.window_s > 0
    assert cap.device_events() == []
    assert sum(e.get("name") == trace.SOLVE for e in cap.events) == 3
