"""The port's execution supervisor, worker and flight recorder, against
the JAX package's, on the CPU.

The pure pieces -- ``classify_exit``, ``parse_result_frame``,
``backoff_schedule``, ``FailureRecord`` and ``RetryPolicy`` -- give JAX's
answers on the same tables.  Seven jobs run in spawned port workers
(``python -m cuda_knearests_tpu_torch.runtime.worker``), driven by the
env-triggered faults: a selftest, an abort (crash, with the killed
worker's flight-recorder tail), a hang (the supervisor's timeout), a
hang past the worker's stall watchdog (rc 3, 'timeout'), a transient
fault (three attempts), a synthetic oom, and one fuzz case on the CPU.
"""

import json
import os
import subprocess
import sys

import pytest

from cuda_knearests_tpu.runtime import supervisor as jsup
from cuda_knearests_tpu.utils import platform as jplatform
from cuda_knearests_tpu_torch.fuzz.campaign import _run_one
from cuda_knearests_tpu_torch.fuzz.generators import CaseSpec
from cuda_knearests_tpu_torch.obs import recorder
from cuda_knearests_tpu_torch.obs import spans
from cuda_knearests_tpu_torch.runtime import supervisor as psup
from cuda_knearests_tpu_torch.runtime import worker as pworker
from cuda_knearests_tpu_torch.utils import platform as pplatform

SELFTEST = {"job": "selftest"}

EXITS = [
    (1, None, {"failure_kind": "oom", "error": "e"}, ""),
    (1, None, {"failure_kind": "meltdown", "error": "e"}, "boom"),
    (None, 9, None, "UNAVAILABLE: socket closed"),
    (3, None, None, ""),
    (1, None, None, "stall watchdog (x): no progress"),
    (1, None, None, "UNAVAILABLE: out of memory"),
    (1, None, None, "RESOURCE_EXHAUSTED: alloc"),
    (1, None, None, "CUDA error: out of memory"),
    (1, None, None, "AssertionError: nope"),
    (1, None, None, "InvalidKError: k must be positive"),
    (1, None, None, "mystery"),
    (0, None, None, ""),
]


def _policy(tries=3):
    return psup.RetryPolicy(tries=tries, base_delay_s=0.01)


# -- the pure pieces against JAX ----------------------------------------------

def test_constants_equal_jax():
    assert psup.FAILURE_KINDS == jsup.FAILURE_KINDS
    assert psup.RESULT_PREFIX == jsup.RESULT_PREFIX


@pytest.mark.parametrize("rc,sig,frame,stderr", EXITS)
def test_classify_exit_equal_jax(rc, sig, frame, stderr):
    assert psup.classify_exit(rc, sig, frame, stderr) == \
        jsup.classify_exit(rc, sig, frame, stderr)


def test_parse_result_frame_equal_jax():
    p = psup.RESULT_PREFIX
    outs = ['{"looks": "like json but is library output"}\n'
            + p + '{"bad json\n' + p + '{"config": "x", "value": 1}\n',
            "no frames here",
            p + '{"a": 1}\n' + p + '{"b": 2}\n',
            p + '[1, 2]\n',
            ""]
    for out in outs:
        assert psup.parse_result_frame(out) == jsup.parse_result_frame(out)
    assert psup.parse_result_frame(outs[0]) == {"config": "x", "value": 1}


@pytest.mark.parametrize("args", [(3,), (1,), (0,), (5, 2.0, 3.0, 10.0),
                                  (4, 0.01), (6, -1.0)])
def test_backoff_schedule_equal_jax(args):
    assert pplatform.backoff_schedule(*args) == \
        jplatform.backoff_schedule(*args)


def test_env_knobs_equal_jax(monkeypatch):
    monkeypatch.setenv("BENCH_ROW_RETRIES", "5")
    monkeypatch.setenv("BENCH_RETRY_BASE_S", "not-a-number")
    got, want = psup.RetryPolicy.from_env(), jsup.RetryPolicy.from_env()
    assert (got.tries, got.base_delay_s, got.factor, got.retry_kinds) == \
        (want.tries, want.base_delay_s, want.factor, want.retry_kinds)
    monkeypatch.setenv("BENCH_ROW_TIMEOUT_S", "42")
    assert psup.Supervisor().timeout_s == jsup.Supervisor().timeout_s == 42


def test_failure_record_equal_jax():
    kw = dict(kind="crash", config="case-x", message="worker killed by "
              "signal 9", rc=None, signal=9, attempts=2, stderr_tail="boom",
              flight_tail=[{"name": "recorder.arm"}])
    got, want = psup.FailureRecord(**kw), jsup.FailureRecord(**kw)
    assert got.to_json() == want.to_json()
    assert json.loads(json.dumps(got.to_json())) == got.to_json()
    assert psup.FailureRecord.from_json(want.to_json()) == got
    with pytest.raises(ValueError, match="unknown failure kind"):
        psup.FailureRecord(kind="meltdown", config="x", message="m")


# -- the flight recorder, in-process ------------------------------------------

def test_recorder_spill_and_tail(tmp_path):
    path = str(tmp_path / "spill.jsonl")
    rec = recorder.FlightRecorder(capacity=4).arm(tag="t", spill_path=path)
    try:
        for i in range(6):
            with spans.span("tick", force=True, i=i):
                pass
        rec.metric_delta()
    finally:
        rec.disarm()
    dump = rec.dump()
    assert dump["recorded"] == 8 and dump["dropped"] == 4
    assert [e["name"] for e in dump["events"]] == \
        ["tick", "tick", "tick", "dispatch.delta"]
    with open(path, "a") as f:
        f.write('{"half-written')
    tail = recorder.read_spill_tail(path, n=3)
    assert [e["name"] for e in tail] == ["tick", "dispatch.delta"]
    assert recorder.read_spill_tail(str(tmp_path / "missing")) == []


def test_worker_refuses_unknown_job(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_STALL_TIMEOUT_S", "0")   # no watchdog thread
    monkeypatch.delenv("KNTPU_FLIGHT_FILE", raising=False)
    try:
        rc = pworker.main([json.dumps({"job": "bench_config",
                                       "label": "x", "attempt": 1})])
    finally:
        recorder.FLIGHT.disarm()
        spans.set_process_tag("")
    assert rc == 1
    frame = psup.parse_result_frame(capsys.readouterr().out)
    assert frame["failure_kind"] == "crash"
    assert "unknown worker job" in frame["error"]


# -- spawned workers ----------------------------------------------------------

def test_worker_selftest_round_trip(monkeypatch):
    monkeypatch.delenv("KNTPU_FAULT", raising=False)
    row, failure = psup.Supervisor(policy=_policy(), timeout_s=120).run_job(
        "selftest", SELFTEST)
    assert failure is None
    assert row == {"config": "selftest", "value": 1.0, "unit": "ok",
                   "label": "selftest"}


def test_abort_is_contained_with_flight_tail(monkeypatch, tmp_path):
    monkeypatch.setenv("KNTPU_FAULT", "abort:selftest")
    monkeypatch.setenv("KNTPU_FAILURE_DIR", str(tmp_path))
    sup = psup.Supervisor(policy=_policy(), timeout_s=120)
    row, failure = sup.run_job("selftest", SELFTEST)
    assert row is None
    assert failure.kind == "crash" and failure.signal == 9
    assert failure.attempts == 1
    assert [e["name"] for e in failure.flight_tail] == ["recorder.arm"]
    assert failure.flight_tail[0]["job"] == "worker:selftest"
    monkeypatch.delenv("KNTPU_FAULT")
    row2, failure2 = sup.run_job("selftest", SELFTEST)   # quarantined
    assert row2 is None and failure2 is failure


def test_hang_trips_row_timeout(monkeypatch):
    monkeypatch.setenv("KNTPU_FAULT", "hang:selftest:600")
    row, failure = psup.Supervisor(policy=_policy(), timeout_s=4).run_job(
        "selftest", SELFTEST)
    assert row is None and failure.kind == "timeout"
    assert failure.rc is None and failure.signal is None
    assert "4s row timeout" in failure.message


def test_stall_watchdog_trips_before_row_timeout(tmp_path):
    """A worker hung past ``BENCH_STALL_TIMEOUT_S`` exits rc 3 on its own
    watchdog, with one JSON error line and a traceback file, and the
    supervisor classifies the exit as 'timeout'."""
    env = dict(os.environ, KNTPU_FAULT="hang:stall:600",
               BENCH_STALL_TIMEOUT_S="1", KNTPU_FAILURE_DIR=str(tmp_path))
    job = json.dumps({"job": "selftest", "label": "stall"})
    proc = subprocess.run(
        [sys.executable, "-m", "cuda_knearests_tpu_torch.runtime.worker",
         job], env=env, cwd=psup._REPO_ROOT, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 3, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["failure_kind"] == "timeout"
    assert line["error"].startswith("stall watchdog (worker:stall)")
    with open(line["traceback_file"]) as f:
        assert f.read().startswith("stall watchdog trip (worker:stall)")
    assert os.path.dirname(line["traceback_file"]) == str(tmp_path)
    kind, message = psup.classify_exit(
        proc.returncode, None, psup.parse_result_frame(proc.stdout),
        proc.stderr)
    assert kind == "timeout" and "rc 3" in message


def test_transient_fault_recovers_on_third_attempt(monkeypatch):
    monkeypatch.setenv("KNTPU_FAULT", "transient:selftest:2")
    slept = []
    sup = psup.Supervisor(policy=_policy(tries=3), timeout_s=120,
                          sleep=slept.append)
    row, failure = sup.run_job("selftest", SELFTEST)
    assert failure is None and row["attempts"] == 3
    assert slept == pplatform.backoff_schedule(3, base_s=0.01)


def test_synthetic_oom_is_not_retried(monkeypatch):
    monkeypatch.setenv("KNTPU_FAULT", "oom:selftest")
    row, failure = psup.Supervisor(policy=_policy(), timeout_s=120).run_job(
        "selftest", SELFTEST)
    assert row is None and failure.kind == "oom" and failure.attempts == 1
    assert "over-budget" in failure.message


def test_fuzz_case_in_a_worker_on_the_cpu(monkeypatch, tmp_path):
    monkeypatch.delenv("KNTPU_FAULT", raising=False)
    spec = CaseSpec(generator="all-coincident", seed=2, n=9, k=4)
    sup = psup.Supervisor(timeout_s=240)
    out = _run_one(spec, ("adaptive", "query"), str(tmp_path), False, 2,
                   sup, "cpu")
    assert out == [] and sup.quarantined == {}
    assert os.listdir(tmp_path) == []
