"""Trace export: merge per-process span spills into one Perfetto timeline.

Counterpart of ``cuda_knearests_tpu/obs/export.py``.  Every process that
traces (the serving main, each supervised worker, each fleet replica
child) spills its events into its own ``trace_<tag>_<pid>.jsonl``
(``spans.start_file_trace_from_env``).  This module stitches them:

* :func:`load_jsonl` -- one spill file -> its valid events.
* :func:`merge` -- many files -> one list sorted by the wall-anchored
  ``t0`` (events already carry their pid and job).
* :func:`to_chrome` -- events -> a Chrome trace-event document
  (complete 'X' events and one 'M' process-name record per pid), which
  Perfetto and chrome://tracing load.

``python -m cuda_knearests_tpu_torch.obs.export --dir TRACEDIR --out
trace.json`` merges a directory and prints a one-line JSON summary (rc 1
when the directory holds no spill).  Pure host code.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, Iterable, List, Optional

from . import spans as _spans


def load_jsonl(path: str) -> List[dict]:
    """Events of one spill file.  Malformed lines (a killed writer may
    leave a torn last line) and events failing the schema are skipped; an
    unreadable file gives no events."""
    out: List[dict] = []
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(ev, dict) \
                        and _spans.validate_event(ev) is None:
                    out.append(ev)
    except OSError:
        return []
    return out


def merge(paths: Iterable[str]) -> List[dict]:
    """One event list over every file, sorted by ``t0`` (the shared,
    wall-anchored time axis)."""
    events: List[dict] = []
    for p in paths:
        events.extend(load_jsonl(p))
    events.sort(key=lambda ev: ev.get("t0", 0.0))
    return events


def trace_files(trace_dir: str) -> List[str]:
    return sorted(glob.glob(os.path.join(trace_dir, "trace_*.jsonl")))


def to_chrome(events: List[dict]) -> dict:
    """Chrome trace-event form: complete ('X') events for spans, instant
    ('i') events for the rest, on a microsecond axis rebased to the
    earliest event, and one process-name record per pid."""
    t_base = min((ev["t0"] for ev in events), default=0.0)
    out: List[dict] = []
    seen_procs: Dict[int, str] = {}
    for ev in events:
        pid = int(ev.get("pid", 0))
        job = str(ev.get("job", "") or "")
        if pid not in seen_procs:
            seen_procs[pid] = job
            out.append({"ph": "M", "name": "process_name", "pid": pid,
                        "tid": 0, "args": {"name": job or f"pid {pid}"}})
        args = dict(ev.get("attrs") or {})
        if ev.get("trace_id") is not None:
            args["trace_id"] = ev["trace_id"]
        out.append({
            "name": ev["name"],
            "ph": "X" if ev.get("kind") == "span" else "i",
            "ts": round((ev["t0"] - t_base) * 1e6, 3),
            "dur": round(float(ev.get("dur_ms", 0.0)) * 1e3, 3),
            "pid": pid,
            "tid": str(ev.get("tid", "main")),
            "args": args,
        })
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def export_dir(trace_dir: str, out_path: str) -> dict:
    """Merge every spill under ``trace_dir`` into ``out_path`` (Chrome
    JSON); returns a summary."""
    files = trace_files(trace_dir)
    events = merge(files)
    chrome = to_chrome(events)
    d = os.path.dirname(out_path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(chrome, f)
    return {"trace_dir": trace_dir, "files": len(files),
            "events": len(events),
            "pids": len({ev.get("pid") for ev in events}),
            "out": out_path}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cuda_knearests_tpu_torch.obs.export",
        description=__doc__.splitlines()[0])
    ap.add_argument("--dir", required=True,
                    help="directory of trace_*.jsonl spills "
                         "(KNTPU_TRACE_DIR)")
    ap.add_argument("--out", default=None,
                    help="merged Chrome-trace output path (default "
                         "<dir>/trace_merged.json)")
    args = ap.parse_args(argv)
    out = args.out or os.path.join(args.dir, "trace_merged.json")
    summary = export_dir(args.dir, out)
    print(json.dumps(summary), flush=True)
    return 0 if summary["files"] else 1


if __name__ == "__main__":
    sys.exit(main())
