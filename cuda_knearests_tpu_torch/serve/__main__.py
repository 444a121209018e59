"""``python -m cuda_knearests_tpu_torch.serve`` -- the daemon's front door.

Counterpart of ``cuda_knearests_tpu/serve/__main__.py``.  Two modes over
one ServeDaemon, on the GPU unless ``--device cpu`` is given (with no CUDA
device and no ``--device`` it refuses with ``NoDeviceError``, rc 4):

* ``--loadgen``: a self-driving open-loop synthetic session
  (``serve/loadgen``); prints the serving summary as one JSON line.
  ``--assert-steady`` also exits 1 unless the session flushed at least
  one batch with zero recompiles (kernel builds plus library loads) and
  no failed request, and, on a CUDA device, launched the class kernels.
* default (stdio): JSON-lines requests on stdin, JSON-lines responses on
  stdout.  Request: ``{"id": 1, "op": "query"|"insert"|"delete"|"fof",
  "data": [[x,y,z],...] | [id,...] | linking_length, "k": 8}`` (``fof``
  answers friends-of-friends labels of the current mutated cloud), or
  ``{"op": "metrics"}`` for one metrics snapshot.  Responses carry
  ``ok`` and results (pad slots -- fewer than k neighbours -- are id -1
  with d2 null: the wire is strict RFC 8259, never an Infinity token), or
  the typed refusal (``failure_kind``).  Batching is live: responses
  surface on flush (size, deadline via idle polling, mutation barrier,
  end-of-input drain).

The problem is prepared with ``KnnConfig(k=...)``: the adaptive class
route, the one the port has (the reference's serving main pins its legacy
route so that its executable cache can count recompiles).

Exit codes: 0 ok; 1 a failed ``--assert-steady``; 4 a classified device
fault (no device, device memory); 5 an input-contract violation (a
corrupt dataset file, an illegal k).
"""

from __future__ import annotations

import argparse
import json
import sys


def _load_points(spec: str):
    """'uniform:N' / 'blue:N' synthetic clouds, or an .xyz path or a
    dataset name through the standard loaders."""
    import os

    from ..io import (generate_blue_noise, generate_uniform, get_dataset,
                      load_xyz, normalize_points)

    if spec.startswith("uniform:"):
        return generate_uniform(int(spec.split(":")[1]), seed=5)
    if spec.startswith("blue:"):
        return generate_blue_noise(int(spec.split(":")[1]), seed=5)
    if os.path.exists(spec):
        return normalize_points(load_xyz(spec))
    return get_dataset(spec)


def _stdio_loop(daemon) -> int:
    """JSON-lines serving over stdin/stdout; deadline flushes ride an idle
    select() poll so a half-full batch never waits for the next request.

    stdin is consumed UNBUFFERED (os.read on the raw fd with our own line
    splitting): mixing select() with Python's buffered readline() would
    strand any requests a client wrote in one burst inside the
    TextIOWrapper buffer -- select() sees no kernel bytes and the daemon
    would block with admitted-but-unread requests pending."""
    import os
    import select

    def emit(responses):
        for r in responses:
            print(json.dumps(r.to_wire()), flush=True)

    def handle(raw: bytes):
        line = raw.strip()
        if not line:
            return
        try:
            req = json.loads(line.decode("utf-8"))
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            print(json.dumps({"id": None, "ok": False,
                              "failure_kind": "invalid-input",
                              "error": f"unparseable request line: {e}"}),
                  flush=True)
            return
        if req.get("op") == "metrics":
            # the metrics wire command: one snapshot reply -- registry,
            # dispatch and kernel counters, the daemon's serving stats and
            # latency decomposition
            print(json.dumps({"id": req.get("id"), "ok": True,
                              "metrics": daemon.metrics_snapshot()}),
                  flush=True)
            return
        emit(daemon.submit(req_id=req.get("id"),
                           kind=req.get("op", "query"),
                           payload=req.get("data"), k=req.get("k"),
                           trace_id=req.get("trace_id")))

    fd = sys.stdin.fileno()
    buf = b""
    while True:
        while b"\n" in buf:
            raw, buf = buf.split(b"\n", 1)
            handle(raw)
        timeout = daemon.config.max_delay_s / 2 if daemon.next_deadline() \
            else None
        ready, _, _ = select.select([fd], [], [], timeout)
        if not ready:
            emit(daemon.poll())
            continue
        chunk = os.read(fd, 1 << 16)
        if not chunk:
            handle(buf)          # trailing unterminated line, if any
            emit(daemon.drain())
            return 0
        buf += chunk


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cuda_knearests_tpu_torch.serve",
        description=__doc__.splitlines()[0])
    ap.add_argument("--points", default="uniform:20000",
                    help="dataset name, .xyz path, or uniform:N / blue:N "
                         "(default uniform:20000)")
    ap.add_argument("--k", type=int, default=10, help="serving k")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the GPU; "
                         "'cpu' runs the kernels' plain versions)")
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--max-delay-ms", type=float, default=10.0)
    ap.add_argument("--compact-threshold", type=int, default=512)
    ap.add_argument("--loadgen", action="store_true",
                    help="run the open-loop synthetic session instead of "
                         "serving stdin")
    ap.add_argument("--rate", type=float, default=200.0,
                    help="loadgen: mean arrivals/sec (Poisson)")
    ap.add_argument("--requests", type=int, default=200,
                    help="loadgen: scheduled arrivals")
    ap.add_argument("--mutation-ratio", type=float, default=0.0,
                    help="loadgen: fraction of arrivals that insert/delete")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--assert-steady", action="store_true",
                    help="loadgen: exit 1 unless >= 1 batch flushed with "
                         "zero recompiles and no failed request (and, on "
                         "a CUDA device, class-kernel launches)")
    ap.add_argument("--metrics-jsonl", default=None,
                    help="periodically append unified metrics snapshots "
                         "(obs.metrics) to this path, one JSON line each; "
                         "a final snapshot lands on exit")
    ap.add_argument("--metrics-period-s", type=float, default=1.0,
                    help="snapshot period for --metrics-jsonl "
                         "(default 1.0)")
    args = ap.parse_args(argv)

    from ..api import KnnProblem
    from ..config import KnnConfig, ServeConfig
    from ..utils.memory import DeviceMemoryError, InputContractError
    from .daemon import ServeDaemon
    from .loadgen import LoadSpec, run_session

    def _refuse(e, rc: int) -> int:
        print(json.dumps({"error": str(e),
                          "failure_kind": getattr(e, "kind", "crash")}),
              flush=True)
        return rc

    try:
        points = _load_points(args.points)
        problem = KnnProblem.prepare(points, KnnConfig(k=args.k),
                                     device=args.device)
        daemon = ServeDaemon(problem, ServeConfig(
            max_batch=args.max_batch,
            max_delay_s=args.max_delay_ms / 1000.0,
            compact_threshold=args.compact_threshold))
    except InputContractError as e:
        return _refuse(e, 5)
    except DeviceMemoryError as e:
        return _refuse(e, 4)

    from ..obs import spans as _spans
    from ..obs.metrics import JsonlEmitter

    trace_sink = _spans.start_file_trace_from_env("serve")
    emitter = None
    if args.metrics_jsonl:
        emitter = JsonlEmitter(args.metrics_jsonl,
                               period_s=args.metrics_period_s,
                               snapshot_fn=daemon.metrics_snapshot)
        emitter.start()
    try:
        if not args.loadgen:
            return _stdio_loop(daemon)

        spec = LoadSpec(rate=args.rate, requests=args.requests,
                        mutation_ratio=args.mutation_ratio, seed=args.seed)
        summary = run_session(daemon, spec)
        print(json.dumps(summary), flush=True)
        if args.assert_steady:
            launched = (summary["kernel_route"] != "cuda"
                        or summary["kernel_launches"] > 0)
            ok = (summary["batches"] >= 1 and summary["recompiles"] == 0
                  and summary["failed_requests"] == 0 and launched)
            if not ok:
                print(f"STEADY-STATE ASSERTION FAILED: batches="
                      f"{summary['batches']} recompiles="
                      f"{summary['recompiles']} failed="
                      f"{summary['failed_requests']} kernel_route="
                      f"{summary['kernel_route']} kernel_launches="
                      f"{summary['kernel_launches']}",
                      file=sys.stderr, flush=True)
                return 1
        return 0
    finally:
        if emitter is not None:
            emitter.stop()
        if trace_sink is not None:
            trace_sink.close()


if __name__ == "__main__":
    sys.exit(main())
