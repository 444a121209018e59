"""Worker entry module of the execution supervisor.

Counterpart of ``cuda_knearests_tpu/runtime/worker.py``.
``python -m cuda_knearests_tpu_torch.runtime.worker '<json job spec>'``
runs ONE job and reports through the one-line framed JSON protocol
(``supervisor.RESULT_PREFIX``).  Job kinds:

  {"job": "fuzz_case", "spec": {...}, "device": "cuda", ...}
        -> ``fuzz.campaign.run_case_job``: one differential fuzz case,
           isolated so that a hostile input's crash costs only that case
  {"job": "selftest"}
        -> a trivial row, no device work (the vehicle of the
           fault-injection tests)

Any other job raises ``ValueError("unknown worker job ...")``: the
reference's bench jobs drive its JAX harness and are not ported.  Every
spec also carries ``label`` (the supervisor's quarantine key) and
``attempt`` (1-based; the transient fault keys on it).  The worker exits
0 with a result frame, or 1 with an error frame whose ``failure_kind`` is
the taxonomy class of what went wrong; deaths that emit no frame
(SIGKILL) are classified by the supervisor.  The worker arms its stall
watchdog, disabled when the job's device is the CPU, so a hang on the
card exits rc 3 (classified 'timeout') before the supervisor's row
timeout fires.

Fault injection (``KNTPU_FAULT``, comma-separated ``kind:label[:arg]``):
  abort:<label>           SIGKILL self (the crash path)
  abort-after:<label>[:n] SIGKILL self upon the n-th flight-recorder
                          event (default 32): dies mid-work
  hang:<label>[:secs]     sleep (the timeout and watchdog path)
  transient:<label>[:n]   raise TransportError while attempt <= n
  oom:<label>             raise a synthetic LaunchBudgetError
Faults fire before any device work, after the flight recorder
(``obs/recorder``, tagged ``worker:<label>``, spilling to the
supervisor's ``KNTPU_FLIGHT_FILE``) and the watchdog are armed, so an
injected death leaves the same evidence as a real one.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import time

from .supervisor import FAILURE_KINDS, RESULT_PREFIX


def _emit(obj: dict) -> None:
    print(RESULT_PREFIX + json.dumps(obj), flush=True)


def _inject_fault(label: str, attempt: int) -> None:
    spec = os.environ.get("KNTPU_FAULT", "")
    for item in filter(None, (s.strip() for s in spec.split(","))):
        parts = item.split(":")
        kind = parts[0]
        target = parts[1] if len(parts) > 1 else ""
        arg = parts[2] if len(parts) > 2 else ""
        if target and target != label:
            continue
        if kind == "abort":
            os.kill(os.getpid(), signal.SIGKILL)
        elif kind == "abort-after":
            from ..obs import recorder as _recorder

            _recorder.FLIGHT.kill_after_events(int(arg or 32))
        elif kind == "hang":
            time.sleep(float(arg or 3600.0))
        elif kind == "transient":
            if attempt <= int(arg or 1):
                from ..utils.memory import TransportError

                raise TransportError(
                    f"injected transient fault: backend UNAVAILABLE "
                    f"(attempt {attempt} <= {int(arg or 1)} forced failures)")
        elif kind == "oom":
            from ..utils.memory import LaunchBudgetError

            raise LaunchBudgetError(
                "injected synthetic over-budget launch",
                requested=1 << 40, budget=1 << 30, site="fault-injection")
        else:
            print(f"ignoring unknown KNTPU_FAULT kind {kind!r}",
                  file=sys.stderr, flush=True)


def _failure_kind(exc: BaseException) -> str:
    """Taxonomy class of an exception the worker caught: the
    DeviceMemoryError family stamps its own ``kind``, AssertionError is
    'assertion', everything else classifies by text, else 'crash'."""
    from ..utils.memory import classify_fault_text

    kind = getattr(exc, "kind", None)
    if kind in FAILURE_KINDS:
        return kind
    if isinstance(exc, AssertionError):
        return "assertion"
    return classify_fault_text(f"{type(exc).__name__}: {exc}") or "crash"


def _run_job(job: dict) -> dict:
    label = job.get("label") or job.get("name") or job.get("job", "")
    # observability first, faults second: an injected hang or SIGKILL
    # leaves the same evidence as a real one
    from ..obs import recorder as _recorder
    from ..obs import spans as _spans
    from ..utils import watchdog

    _spans.set_process_tag(f"worker:{label}")
    _spans.start_file_trace_from_env(f"worker-{label}")
    _recorder.arm(tag=f"worker:{label}")
    watchdog.start(tag=f"worker:{label}")
    _inject_fault(label, int(job.get("attempt", 1)))
    if job.get("job") == "selftest":
        # {"spans": N}: N trivial recorded spans, the vehicle of the
        # flight-recorder fault tests (abort-after kills mid-loop)
        for i in range(int(job.get("spans", 0) or 0)):
            with _spans.span("selftest.tick", force=True, i=i):
                pass
        return {"config": "selftest", "value": 1.0, "unit": "ok",
                "label": label}
    if job.get("job") != "fuzz_case":
        raise ValueError(f"unknown worker job {job.get('job')!r}")

    from ..utils.platform import resolve_device

    device = resolve_device(job.get("device"))
    if device.type == "cpu":
        watchdog.disable()  # CPU work cannot hang on the card
    from ..fuzz.campaign import run_case_job

    row = run_case_job({**job, "device": str(device)})
    row.setdefault("platform", device.type)
    return row


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        job = json.loads(argv[0]) if argv else json.load(sys.stdin)
        row = _run_job(job)
    except BaseException as e:  # noqa: BLE001 -- every failure must frame
        import traceback

        traceback.print_exc()
        _emit({"error": f"{type(e).__name__}: {e}",
               "failure_kind": _failure_kind(e)})
        return 1
    _emit(row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
