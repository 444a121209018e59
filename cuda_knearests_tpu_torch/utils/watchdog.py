"""In-process stall watchdog for unattended device runs.

Counterpart of ``cuda_knearests_tpu/utils/watchdog.py``.  A device call
that never returns leaves a worker pinned until the supervisor's row
timeout kills it.  This watchdog lets the process notice the stall
itself: work calls :func:`heartbeat` after every completed unit, and a
daemon thread exits the process (rc 3, after printing one
machine-readable error line) when no heartbeat arrives for
``BENCH_STALL_TIMEOUT_S`` seconds (default 300; 0 disables).

Callers :func:`disable` it when their device is the CPU: CPU work cannot
hang on a device, and a slow CPU run would trip the limit.  The thread
runs only while the hung call has released the interpreter lock, as
CUDA's blocking waits do; a hang that holds it falls back to the
supervisor's timeout kill.
"""
from __future__ import annotations

import faulthandler
import json
import os
import sys
import tempfile
import threading
import time

_ENV = "BENCH_STALL_TIMEOUT_S"
_FAILURE_DIR_ENV = "KNTPU_FAILURE_DIR"


def _dump_tracebacks(tag: str) -> str | None:
    """Dump all-thread tracebacks (faulthandler) and the flight
    recorder's tail into a failure artifact, and the tracebacks to stderr
    (a supervised child's captured tail); returns the artifact path, or
    None if the write failed."""
    path = None
    try:
        d = os.environ.get(_FAILURE_DIR_ENV) or tempfile.gettempdir()
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"stall_{tag or 'bench'}_{os.getpid()}.tb")
        with open(path, "w") as f:
            f.write(f"stall watchdog trip ({tag}): all-thread tracebacks\n")
            f.flush()
            faulthandler.dump_traceback(file=f, all_threads=True)
            try:
                from ..obs.recorder import FLIGHT

                FLIGHT.metric_delta()
                f.write("\n=== flight recorder tail ===\n")
                f.write(json.dumps(FLIGHT.dump()) + "\n")
            except Exception:  # noqa: BLE001 -- the exit path must never raise; the tracebacks alone still land
                pass
    except Exception:  # noqa: BLE001 -- the exit path must never raise
        path = None
    try:
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
    except Exception:  # noqa: BLE001 -- the exit path must never raise
        pass
    return path


_lock = threading.Lock()
_state = {"t": 0.0, "enabled": False, "stall_s": 300.0, "tag": ""}
_started = False


def heartbeat() -> None:
    """Record forward progress.  Cheap; safe from any thread, and a no-op
    if the watchdog was never started."""
    with _lock:
        _state["t"] = time.monotonic()


def disable() -> None:
    """Stop stall enforcement (the thread stays parked)."""
    with _lock:
        _state["enabled"] = False


def start(tag: str = "", default_s: float = 300.0) -> None:
    """Arm the watchdog (idempotent).  ``tag`` names the process in the
    error line.  ``BENCH_STALL_TIMEOUT_S`` overrides the limit; <= 0
    disables."""
    global _started
    raw = os.environ.get(_ENV)
    stall_s = default_s
    if raw is not None:
        try:
            stall_s = float(raw)
        except ValueError:
            print(f"ignoring malformed {_ENV}={raw!r}; using {default_s}",
                  file=sys.stderr, flush=True)
    if stall_s <= 0:
        return
    with _lock:
        _state.update(t=time.monotonic(), enabled=True, stall_s=stall_s,
                      tag=tag)
    if _started:
        return
    _started = True
    threading.Thread(target=_watch, daemon=True,
                     name="bench-stall-watchdog").start()


def _watch() -> None:
    while True:
        with _lock:
            stall_s = _state["stall_s"]
        time.sleep(max(1.0, min(15.0, stall_s / 4.0)))
        with _lock:
            if not _state["enabled"]:
                continue
            dt = time.monotonic() - _state["t"]
            tag = _state["tag"]
        if dt > stall_s:
            try:
                from ..obs.metrics import watchdog_stall_tripped

                watchdog_stall_tripped(tag)
            except Exception:  # noqa: BLE001 -- the exit path must never raise
                pass
            tb_path = _dump_tracebacks(tag)
            line = {
                "error": f"stall watchdog ({tag}): no progress for "
                         f"{dt:.0f}s (limit {stall_s:.0f}s); presumed hung "
                         f"on the device",
                "failure_kind": "timeout"}
            if tb_path:
                line["traceback_file"] = tb_path
            print(json.dumps(line), flush=True)
            sys.stderr.flush()
            os._exit(3)
