"""Fault-isolated execution supervisor: crash containment, retry, backoff.

Counterpart of ``cuda_knearests_tpu/runtime/supervisor.py``.  On the GPU a
device-side fault (an illegal address, a launch failure) leaves the
process's CUDA context unusable: every later call in that process fails.
So containment comes from process isolation.  The supervisor runs each
job in a fresh child (``runtime/worker.py``) speaking a one-line JSON
result protocol:

    parent --argv--> worker:  {"job": ..., "label": ..., "attempt": N, ...}
    worker --stdout-> parent: "@@KNTPU-RESULT@@ " + json(result row)
                              (or json({"error":..., "failure_kind":...}))

A worker death of any shape maps onto a typed :class:`FailureRecord` (kind
in :data:`FAILURE_KINDS`) through :func:`classify_exit`.  Transient kinds
(the 'transport' bucket) retry on the bounded exponential backoff of
``utils/platform.backoff_schedule``; every other failure quarantines the
job label, so nothing re-runs a job that already killed a worker.  The
serving daemon maps its contained failures onto the same taxonomy.

Fault injection (env-triggered, testable on the CPU; ``worker.py``):
``KNTPU_FAULT="abort:<label>"`` SIGKILLs the worker, ``hang:<label>``
wedges it (the timeout path), ``transient:<label>:<n>`` raises
``TransportError`` on the first n attempts (the retry path),
``oom:<label>`` raises a synthetic ``LaunchBudgetError``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional, Tuple

from ..obs import recorder as _recorder
from ..utils.memory import classify_fault_text
from ..utils.platform import _env_number, backoff_schedule

# Every failure kind a contained fault is reported as.  'invalid-input' is
# a typed input-contract refusal (``utils/memory.InputContractError``): a
# deterministic caller error, never retried.
FAILURE_KINDS = ("crash", "timeout", "oom", "transport", "assertion",
                 "invalid-input")

# Frame marker of the worker->parent result protocol: a prefix, so library
# output that happens to print a '{' line is never taken for the result.
RESULT_PREFIX = "@@KNTPU-RESULT@@ "

_TIMEOUT_ENV = "BENCH_ROW_TIMEOUT_S"
_RETRIES_ENV = "BENCH_ROW_RETRIES"
_RETRY_BASE_ENV = "BENCH_RETRY_BASE_S"

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@dataclasses.dataclass
class FailureRecord:
    """One typed account of a failed supervised job.

    kind:        one of FAILURE_KINDS.
    config:      the job label.
    message:     one-line summary (exception text, signal, ...).
    rc:          the child's exit code, None if it never exited (timeout).
    signal:      the POSIX signal that killed the child, else None.
    attempts:    child launches spent on this job (>= 1).
    stderr_tail: the last chunk of the final child's stderr.
    flight_tail: the killed worker's flight-recorder tail
                 (``obs/recorder``), read from its line-flushed spill, so
                 even a SIGKILL leaves its last events on record.
    """

    kind: str
    config: str
    message: str
    rc: Optional[int] = None
    signal: Optional[int] = None
    attempts: int = 1
    stderr_tail: str = ""
    flight_tail: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if self.kind not in FAILURE_KINDS:
            raise ValueError(f"unknown failure kind {self.kind!r}: "
                             f"expected one of {FAILURE_KINDS}")

    def to_json(self) -> dict:
        """The stable artifact schema: every key always present."""
        return {"kind": self.kind, "config": self.config,
                "message": self.message, "rc": self.rc,
                "signal": self.signal, "attempts": int(self.attempts),
                "stderr_tail": self.stderr_tail,
                "flight_tail": list(self.flight_tail)}

    @classmethod
    def from_json(cls, d: dict) -> "FailureRecord":
        return cls(kind=d["kind"], config=d["config"], message=d["message"],
                   rc=d.get("rc"), signal=d.get("signal"),
                   attempts=int(d.get("attempts", 1)),
                   stderr_tail=d.get("stderr_tail", ""),
                   flight_tail=list(d.get("flight_tail", [])))


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff, keyed on the failure kind.
    Only 'transport' retries by default: crashes, ooms and assertions are
    deterministic for a given job."""

    tries: int = 3
    base_delay_s: float = 2.0
    factor: float = 2.0
    retry_kinds: Tuple[str, ...] = ("transport",)

    @classmethod
    def from_env(cls) -> "RetryPolicy":
        return cls(tries=max(1, _env_number(_RETRIES_ENV, 3, int)),
                   base_delay_s=_env_number(_RETRY_BASE_ENV, 2.0, float))


def classify_exit(rc: Optional[int], sig: Optional[int],
                  frame: Optional[dict], stderr: str) -> Tuple[str, str]:
    """(kind, message) of a failed worker exit.

    Priority: the worker's own framed ``failure_kind``, then death by a
    signal (crash), then the stall watchdog's rc 3 (timeout), then the
    stderr text (``utils/memory.classify_fault_text``), then an
    AssertionError, then crash."""
    if frame and frame.get("failure_kind") in FAILURE_KINDS:
        return frame["failure_kind"], str(frame.get("error", ""))
    if sig is not None:
        return "crash", f"worker killed by signal {sig}"
    if rc == 3 or "stall watchdog" in stderr:
        return "timeout", f"worker stall watchdog tripped (rc {rc})"
    text_kind = classify_fault_text(stderr)
    if text_kind:
        return text_kind, f"worker exited rc {rc} ({text_kind} per stderr)"
    if "AssertionError" in stderr:
        return "assertion", f"worker assertion failed (rc {rc})"
    return "crash", f"worker exited rc {rc} with no result frame"


def parse_result_frame(stdout: str) -> Optional[dict]:
    """The last well-formed result frame in a worker's stdout, or None."""
    frame = None
    for line in stdout.splitlines():
        if line.startswith(RESULT_PREFIX):
            try:
                frame = json.loads(line[len(RESULT_PREFIX):])
            except json.JSONDecodeError:
                pass
    return frame


class Supervisor:
    """Runs jobs in isolated worker children; owns retry and quarantine.

    ``quarantined`` maps job label -> FailureRecord for every job that
    spent its attempts; a quarantined label returns its stored record
    without spawning a child."""

    def __init__(self, policy: Optional[RetryPolicy] = None,
                 timeout_s: Optional[float] = None,
                 sleep=time.sleep, stderr_tail_chars: int = 2000):
        self.policy = policy or RetryPolicy.from_env()
        # a containment bound, not a performance budget;
        # BENCH_ROW_TIMEOUT_S overrides it
        self.timeout_s = (timeout_s if timeout_s is not None
                          else _env_number(_TIMEOUT_ENV, 1800.0, float))
        self._sleep = sleep
        self._tail = stderr_tail_chars
        self.quarantined: dict[str, FailureRecord] = {}

    def run_job(self, label: str, job: dict) \
            -> Tuple[Optional[dict], Optional[FailureRecord]]:
        """Run one job to completion: (result_row, None) on success --
        stamped ``attempts`` when it took more than one -- or (None,
        FailureRecord) after containment.  Retries only the kinds the
        policy names, on the shared backoff law; the final failure
        quarantines the label."""
        if label in self.quarantined:
            return None, self.quarantined[label]
        delays = backoff_schedule(self.policy.tries,
                                  base_s=self.policy.base_delay_s,
                                  factor=self.policy.factor)
        failure: Optional[FailureRecord] = None
        for attempt in range(1, self.policy.tries + 1):
            row, failure = self._run_once(label, job, attempt)
            if failure is None:
                if attempt > 1:
                    row["attempts"] = attempt
                return row, None
            failure.attempts = attempt
            if failure.kind not in self.policy.retry_kinds:
                break
            if attempt <= len(delays):
                self._sleep(delays[attempt - 1])
        self.quarantined[label] = failure
        return None, failure

    def _worker_cmd(self, spec: str) -> list[str]:
        return [sys.executable, "-m",
                "cuda_knearests_tpu_torch.runtime.worker", spec]

    def _worker_env(self) -> dict:
        env = dict(os.environ)
        # the package must import in the child whatever the parent's cwd
        env["PYTHONPATH"] = _REPO_ROOT + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        return env

    def _flight_path(self, label: str, attempt: int) -> str:
        """The attempt's flight-recorder spill path, handed to the child
        as KNTPU_FLIGHT_FILE; on any failure the parent reads its tail."""
        d = os.environ.get("KNTPU_FAILURE_DIR") or tempfile.gettempdir()
        os.makedirs(d, exist_ok=True)
        safe = "".join(c if c.isalnum() or c in "-_." else "-"
                       for c in label)
        return os.path.join(
            d, f"flight_{safe}_{os.getpid()}_{attempt}.jsonl")

    def _run_once(self, label: str, job: dict, attempt: int) \
            -> Tuple[Optional[dict], Optional[FailureRecord]]:
        spec = json.dumps({**job, "label": label, "attempt": attempt})
        flight = self._flight_path(label, attempt)
        env = self._worker_env()
        env[_recorder.FLIGHT_FILE_ENV] = flight

        def _cleanup_flight() -> None:
            try:
                os.unlink(flight)
            except OSError:
                pass

        _cleanup_flight()   # a stale spill of an earlier same-label run
        try:
            proc = subprocess.run(
                self._worker_cmd(spec), capture_output=True, text=True,
                timeout=self.timeout_s, env=env)
        except subprocess.TimeoutExpired as e:
            # subprocess.run has already killed the child
            stderr = e.stderr if isinstance(e.stderr, str) else \
                (e.stderr or b"").decode(errors="replace")
            return None, FailureRecord(
                kind="timeout", config=label,
                message=f"worker exceeded the {self.timeout_s:.0f}s row "
                        f"timeout and was killed",
                rc=None, signal=None,
                stderr_tail=(stderr or "")[-self._tail:],
                flight_tail=_recorder.read_spill_tail(flight))
        except OSError as e:
            _cleanup_flight()
            return None, FailureRecord(
                kind="crash", config=label,
                message=f"worker failed to spawn: {e}", rc=None)
        frame = parse_result_frame(proc.stdout)
        sig = -proc.returncode if proc.returncode < 0 else None
        if proc.returncode == 0 and frame is not None \
                and "error" not in frame:
            _cleanup_flight()
            return frame, None
        kind, message = classify_exit(proc.returncode, sig, frame,
                                      proc.stderr or "")
        if proc.returncode == 0 and frame is None:
            message = "worker exited rc 0 without a result frame"
            kind = "crash"
        return None, FailureRecord(
            kind=kind, config=label, message=message,
            rc=proc.returncode if proc.returncode >= 0 else None,
            signal=sig, stderr_tail=(proc.stderr or "")[-self._tail:],
            flight_tail=_recorder.read_spill_tail(flight))
