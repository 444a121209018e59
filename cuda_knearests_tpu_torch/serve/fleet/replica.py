"""Replication and failover: the delta log as the fleet's durability story.

Counterpart of ``cuda_knearests_tpu/serve/fleet/replica.py``.  The delta
overlay's mutation stream becomes a replication log:

* :class:`DeltaRecord` -- one committed mutation: a sequence number and
  the validated insert points or delete ids, the payload
  ``DeltaOverlay.insert`` / ``delete`` takes.  Replicas apply records
  through the same overlay as the primary, so the overlay's byte identity
  to a rebuild carries over to them: there is no second apply path.
* :class:`ReplicationLog` -- the ordered record of committed mutations.
  A mutation commits once the primary applied it and its record is
  appended here; only committed mutations are acknowledged.  Failover
  re-ships ``since(acked)`` from the log, which is what makes "zero lost
  committed mutations" structural rather than a race.
* :class:`Replica` -- an in-process replica: its own ``DeltaOverlay``
  over the shared, immutable base problem (no second prepare), applying
  records strictly in sequence; a gap or a replay raises.
* :class:`ReplicaProcess` -- a replica in a child process on the
  supervisor's framed transport (one JSON request line down stdin, one
  ``RESULT_PREFIX``-framed reply line up stdout): ``python -m
  cuda_knearests_tpu_torch.serve.fleet.replica <spec.npz>`` rebuilds the
  problem from a banked spec on the banked device and serves
  apply / query / seq / metrics / promote.
* :class:`FailoverController` -- a primary and replicas as child
  processes.  Mutations commit through the primary and then ship to
  every replica; ``kill_primary()`` is a real SIGKILL; ``failover()``
  promotes the most caught-up replica after re-shipping its log tail.
  ``expected_points()`` replays the log on the host with the overlay's
  indexing, so both halves of the failover law are checkable: the
  promoted cloud equals the log's cloud, and its answers equal a rebuild
  on it byte for byte.

``utils.prototrace`` records the ``replication-commit`` actions (apply,
append, ship, failover) at the sites that perform them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import select
import signal
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ...obs import metrics as _metrics
from ...obs import spans as _spans
from ...runtime.supervisor import _REPO_ROOT, RESULT_PREFIX
from ...utils import prototrace
from ...utils.memory import TransportError
from ...utils.platform import resolve_device


@dataclasses.dataclass(frozen=True)
class DeltaRecord:
    """One committed mutation of one tenant's cloud."""

    seq: int                  # 1-based, dense: record i has seq == i + 1
    kind: str                 # 'insert' | 'delete'
    payload: np.ndarray       # (m, 3) f32 points | (m,) int ids

    def to_json(self) -> dict:
        return {"seq": self.seq, "kind": self.kind,
                "payload": np.asarray(self.payload).tolist()}

    @classmethod
    def from_json(cls, d: dict) -> "DeltaRecord":
        dtype = np.float32 if d["kind"] == "insert" else np.int64
        return cls(seq=int(d["seq"]), kind=str(d["kind"]),
                   payload=np.asarray(d["payload"], dtype))


class ReplicationLog:
    """The ordered committed-mutation record of one tenant.

    ``compact(upto)`` drops the prefix every surviving consumer has
    applied (the autoscaler's scale-down calls it with the remaining
    pool's applied floor); ``base_seq`` says how much was dropped.  Asking
    for a tail that starts inside the dropped prefix raises: a silent
    empty tail would be exactly a lost committed mutation.
    """

    def __init__(self) -> None:
        self.records: List[DeltaRecord] = []
        self.base_seq = 0

    @property
    def committed_seq(self) -> int:
        return self.base_seq + len(self.records)

    def append(self, kind: str, payload: np.ndarray) -> DeltaRecord:
        rec = DeltaRecord(seq=self.committed_seq + 1, kind=kind,
                          payload=np.asarray(payload))
        self.records.append(rec)
        return rec

    def compact(self, upto: int) -> int:
        """Drop the records with seq <= ``upto``; returns how many were
        dropped.  The caller owns the safety argument (every surviving
        consumer applied past ``upto``; see ``Tenant.remove_replica``)."""
        upto = min(int(upto), self.committed_seq)
        drop = max(0, upto - self.base_seq)
        if drop:
            self.records = self.records[drop:]
            self.base_seq += drop
        return drop

    def since(self, seq: int) -> List[DeltaRecord]:
        """The records with sequence number > ``seq`` (the re-ship
        tail)."""
        seq = max(0, int(seq))
        if seq < self.base_seq:
            raise RuntimeError(
                f"replication log compacted past seq {seq}: records "
                f"<= {self.base_seq} were dropped, the re-ship tail is "
                f"unrecoverable (scale-down compacted a tail a live "
                f"consumer still needed)")
        return self.records[seq - self.base_seq:]


def replay_on_host(points: np.ndarray,
                   records: List[DeltaRecord]) -> np.ndarray:
    """The committed log's cloud, replayed with the overlay's canonical
    indexing (np.delete and np.concatenate): the zero-lost-mutations
    oracle."""
    out = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
    for rec in records:
        if rec.kind == "insert":
            out = np.concatenate(
                [out, np.asarray(rec.payload, np.float32).reshape(-1, 3)])
        else:
            out = np.delete(out, np.asarray(rec.payload).reshape(-1), axis=0)
    return np.ascontiguousarray(out, dtype=np.float32)


class Replica:
    """In-process replica: one DeltaOverlay applying records in
    sequence."""

    def __init__(self, problem, compact_threshold: int = 512):
        from ..delta import DeltaOverlay

        self.overlay = DeltaOverlay(problem,
                                    compact_threshold=compact_threshold)
        self.applied_seq = 0

    def apply(self, record: DeltaRecord) -> int:
        """Apply one record, strictly in sequence: a gap means the
        shipper lost a committed delta, and corrupting silently is the one
        unacceptable outcome."""
        if record.seq != self.applied_seq + 1:
            raise RuntimeError(
                f"replication sequence gap: replica at seq "
                f"{self.applied_seq}, record carries seq {record.seq} "
                f"(committed deltas must apply densely in order)")
        if record.kind == "insert":
            self.overlay.insert(np.asarray(record.payload, np.float32))
        else:
            self.overlay.delete(np.asarray(record.payload))
        self.applied_seq = record.seq
        return self.applied_seq

    def query(self, queries: np.ndarray, k: int):
        return self.overlay.query(np.asarray(queries, np.float32), k)


def _encode_rows(ids: np.ndarray, d2: np.ndarray) -> Tuple[list, list]:
    """Wire form of result rows: pad slots (id -1) carry d2 null, as
    ``Response.to_wire``."""
    return (np.asarray(ids).tolist(),
            [[float(v) if np.isfinite(v) else None for v in row]
             for row in np.asarray(d2)])


def _decode_d2(rows: list) -> np.ndarray:
    arr = np.asarray([[np.inf if v is None else v for v in row]
                      for row in rows], np.float32)
    return arr.reshape(len(rows), -1) if rows else arr.reshape(0, 0)


class ReplicaProcess:
    """Parent-side handle of one replica child process.

    The transport is the supervisor's framed protocol; library chatter on
    stdout is never taken for a reply.  A dead or wedged child surfaces as
    :class:`TransportError` (kind 'transport'), which the failover path
    keys on.  The handshake waits ``timeout_s`` (a child pays a torch
    import, a CUDA context and a prepare before it answers).
    """

    def __init__(self, spec_path: str, timeout_s: float = 120.0):
        self.spec_path = spec_path
        self.timeout_s = float(timeout_s)
        env = dict(os.environ)
        env["PYTHONPATH"] = _REPO_ROOT + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        self.proc = subprocess.Popen(
            [sys.executable, "-m",
             "cuda_knearests_tpu_torch.serve.fleet.replica", spec_path],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True, env=env)
        self._buf = ""      # our own stdout line buffer (see _recv)
        self.acked_seq = 0
        self.promoted = False
        self.last_timing: dict = {}
        ready = self._recv()          # startup handshake
        self.n_points = int(ready.get("n_points", 0))

    @property
    def pid(self) -> int:
        return self.proc.pid

    @property
    def alive(self) -> bool:
        return self.proc.poll() is None

    def _recv(self) -> dict:
        """Read the next RESULT_PREFIX frame.  Raw chunks go off the pipe
        into our own line buffer, never through the text wrapper's
        readline: a frame that arrived in one chunk with library chatter
        would sit in Python's buffer while select() waits on an empty
        pipe (a false 'wedged child').  timeout_s <= 0 waits forever."""
        deadline = (None if self.timeout_s <= 0
                    else time.monotonic() + self.timeout_s)
        fd = self.proc.stdout.fileno()
        while True:
            while "\n" in self._buf:
                line, self._buf = self._buf.split("\n", 1)
                if not line.startswith(RESULT_PREFIX):
                    continue          # library chatter on stdout
                frame = json.loads(line[len(RESULT_PREFIX):])
                if not frame.get("ok", False):
                    raise TransportError(
                        f"replica pid {self.pid} error frame: "
                        f"{frame.get('error')}")
                return frame
            wait = (None if deadline is None
                    else max(0.0, deadline - time.monotonic()))
            ready, _, _ = select.select([fd], [], [], wait)
            if not ready:
                raise TransportError(
                    f"replica pid {self.pid}: no reply within "
                    f"{self.timeout_s:.0f}s (wedged child)")
            chunk = os.read(fd, 65536)
            if not chunk:
                raise TransportError(
                    f"replica pid {self.pid}: stdout closed "
                    f"(child exited rc {self.proc.poll()})")
            self._buf += chunk.decode("utf-8", errors="replace")

    def _call(self, req: dict) -> dict:
        try:
            self.proc.stdin.write(json.dumps(req) + "\n")
            self.proc.stdin.flush()
        except (BrokenPipeError, OSError) as e:
            raise TransportError(
                f"replica pid {self.pid}: send failed ({e}) -- "
                f"child dead") from e
        return self._recv()

    def apply(self, record: DeltaRecord) -> int:
        frame = self._call({"op": "apply", **record.to_json()})
        self.acked_seq = int(frame["seq"])
        return self.acked_seq

    def query(self, queries: np.ndarray, k: int, trace_id=None):
        t0 = _spans.now()
        frame = self._call({"op": "query",
                            "queries": np.asarray(queries,
                                                  np.float32).tolist(),
                            "k": int(k), "trace_id": trace_id})
        e2e_ms = (_spans.now() - t0) * 1e3
        # the wire-level decomposition: the child frames its whole op and
        # its query call; queue is the transport and the child's stdin
        # wait, everything outside the child's op window
        op_ms = float(frame.get("op_ms") or 0.0)
        dev_ms = float(frame.get("device_ms") or 0.0)
        self.last_timing = {
            "total_ms": round(e2e_ms, 4),
            "queue_ms": round(max(e2e_ms - op_ms, 0.0), 4),
            "dispatch_ms": round(max(op_ms - dev_ms, 0.0), 4),
            "device_ms": round(dev_ms, 4)}
        ids = np.asarray(frame["ids"], np.int32).reshape(
            len(frame["ids"]), -1)
        return ids, _decode_d2(frame["d2"])

    def metrics(self) -> dict:
        """The child's metrics snapshot over the framed transport."""
        return self._call({"op": "metrics"})["metrics"]

    def seq(self) -> int:
        return int(self._call({"op": "seq"})["seq"])

    def promote(self) -> None:
        self._call({"op": "promote"})
        self.promoted = True

    def kill(self) -> None:
        if self.alive:
            os.kill(self.pid, signal.SIGKILL)
        self.proc.wait()

    def close(self) -> None:
        if self.alive:
            try:
                self.proc.stdin.write(json.dumps({"op": "shutdown"}) + "\n")
                self.proc.stdin.flush()
                self.proc.wait(timeout=10)
            except (BrokenPipeError, OSError,
                    subprocess.TimeoutExpired):
                self.proc.kill()
                self.proc.wait()


def bank_replica_spec(points: np.ndarray, k: int,
                      compact_threshold: int = 512,
                      path: Optional[str] = None, *, device=None) -> str:
    """Write the replica child's bootstrap spec (the base cloud, k, the
    compaction threshold and the device the child prepares on) to an .npz.
    ``device`` defaults to the GPU, so a child rebuilds on the card
    unless the caller banked 'cpu'."""
    device = resolve_device(device)
    if path is None:
        fd, path = tempfile.mkstemp(prefix="kntpu-replica-", suffix=".npz")
        os.close(fd)
    np.savez_compressed(path,
                        points=np.asarray(points, np.float32),
                        k=np.int32(k),
                        compact_threshold=np.int32(compact_threshold),
                        device=np.asarray(str(device)))
    return path


class FailoverController:
    """A primary and N replicas as child processes; the failover protocol.

    One controller serves one tenant's replicated stream.  A mutation
    commits through the primary (apply and ack) before its record enters
    the log and ships to the replicas; queries go to the primary.  When
    the primary dies (a TransportError, or :meth:`kill_primary`'s real
    SIGKILL), :meth:`failover` promotes the replica with the highest acked
    sequence after re-shipping its tail from the log: every committed
    mutation survives, and an uncommitted one was never acknowledged
    (retry after failover is the client's contract).  Every child
    prepares on ``device`` (default: the GPU)."""

    def __init__(self, points: np.ndarray, k: int, n_replicas: int = 1,
                 compact_threshold: int = 512, timeout_s: float = 120.0,
                 *, device=None):
        self.initial_points = np.ascontiguousarray(points, np.float32)
        self.k = int(k)
        self.log = ReplicationLog()
        self.spec_path = bank_replica_spec(points, k, compact_threshold,
                                           device=device)
        self.procs: List[ReplicaProcess] = []
        try:
            for _ in range(1 + max(0, int(n_replicas))):
                self.procs.append(ReplicaProcess(self.spec_path,
                                                 timeout_s=timeout_s))
            self.primary = self.procs[0]
            self.primary.promote()
        except BaseException:
            self.close()
            raise
        self.failovers = 0

    @property
    def replicas(self) -> List[ReplicaProcess]:
        return [p for p in self.procs if p is not self.primary]

    def mutate(self, kind: str, payload: np.ndarray) -> DeltaRecord:
        """One committed mutation: the primary applies it (its ack is the
        commit point), the record enters the log, then ships to every
        live replica."""
        rec = DeltaRecord(seq=self.log.committed_seq + 1, kind=kind,
                          payload=np.asarray(payload))
        self.primary.apply(rec)          # raises TransportError if dead
        prototrace.record("replication-commit", "apply")
        self.log.records.append(rec)     # the commit
        prototrace.record("replication-commit", "append")
        for rep in self.replicas:
            if not rep.alive:
                continue
            try:
                rep.apply(rec)
                prototrace.record("replication-commit", "ship")
            except TransportError:
                pass  # a dead replica just stops being a failover target
        return rec

    def query(self, queries: np.ndarray, k: Optional[int] = None):
        return self.primary.query(queries, self.k if k is None else k)

    def kill_primary(self) -> int:
        """A real SIGKILL of the primary; returns its pid."""
        pid = self.primary.pid
        self.primary.kill()
        return pid

    def failover(self) -> Dict[str, int]:
        """Promote the most caught-up replica: re-ship its committed tail,
        then route to it.  Raises TransportError when no live replica is
        left (a total loss is never absorbed silently)."""
        live = [p for p in self.replicas if p.alive]
        if not live:
            raise TransportError(
                "failover impossible: no live replica (committed log "
                f"retains {self.log.committed_seq} mutation(s) for a "
                f"future replica)")
        target = max(live, key=lambda p: p.acked_seq)
        replayed = 0
        for rec in self.log.since(target.acked_seq):
            target.apply(rec)
            prototrace.record("replication-commit", "ship")
            replayed += 1
        target.promote()
        self.primary = target
        self.failovers += 1
        prototrace.record("replication-commit", "failover")
        return {"promoted_pid": target.pid, "replayed": replayed,
                "committed_seq": self.log.committed_seq}

    def expected_points(self) -> np.ndarray:
        """The committed log's cloud (host replay): what the promoted
        primary must hold exactly."""
        return replay_on_host(self.initial_points, self.log.records)

    def close(self) -> None:
        for p in self.procs:
            p.close()
        try:
            os.unlink(self.spec_path)
        except OSError:
            pass


def failover_drill(n: int = 1500, k: int = 8, ops: int = 24,
                   seed: int = 0, log=None, *, device=None) -> dict:
    """The process-level failover proof as one summary (``python -m
    cuda_knearests_tpu_torch.serve.fleet --failover-smoke``).

    A primary and one replica run as child processes on ``device``
    (default: the GPU); a seeded mutation and query stream commits
    through the primary; half way the primary takes a real SIGKILL; the
    controller fails over and the stream finishes.  ``failover_ok``
    requires at least one failover, zero lost committed mutations (the
    promoted replica's sequence and cloud size equal the log's host
    replay) and post-failover answers byte-identical to a rebuild on that
    cloud, prepared here on the same device."""
    from ...api import KnnProblem
    from ...config import KnnConfig
    from ...io import generate_uniform

    device = resolve_device(device)
    log = log or (lambda s: None)
    rng = np.random.default_rng(seed)
    points = generate_uniform(n, seed=seed)
    ctl = FailoverController(points, k, n_replicas=1, device=device)
    killed_at = None
    killed_pid = None
    commits_acked = 0
    # the per-request decomposition across the wire, in bounded
    # histograms
    lat_hist = {name: _metrics.Histogram(f"failover.{name}")
                for name in ("total_ms", "queue_ms", "dispatch_ms",
                             "device_ms")}

    def _absorb_timing() -> None:
        for key, hist in lat_hist.items():
            v = ctl.primary.last_timing.get(key)
            if v is not None:
                hist.observe(v)

    try:
        for i in range(ops):
            if i == ops // 2:
                killed_pid = ctl.kill_primary()
                killed_at = i
            roll = rng.random()
            try:
                if roll < 0.5:
                    pts = (rng.random((4, 3)) * 980.0 + 10.0
                           ).astype(np.float32)
                    ctl.mutate("insert", pts)
                    commits_acked += 1
                elif roll < 0.7 and ctl.log.committed_seq:
                    n_now = ctl.expected_points().shape[0]
                    if n_now > 4:
                        ids = np.sort(rng.choice(n_now, size=2,
                                                 replace=False))
                        ctl.mutate("delete", ids.astype(np.int64))
                        commits_acked += 1
                else:
                    qs = (rng.random((8, 3)) * 980.0 + 10.0
                          ).astype(np.float32)
                    ctl.query(qs)
                    _absorb_timing()
            except TransportError:
                # the dead primary surfaces here; the op was never
                # acknowledged, so failing over and moving on loses
                # nothing the client was promised
                info = ctl.failover()
                log(f"failover: {info}")
        expected = ctl.expected_points()
        state = ctl.primary._call({"op": "seq"})
        probe = (np.random.default_rng(seed + 9).random((32, 3))
                 * 980.0 + 10.0).astype(np.float32)
        got_i, got_d = ctl.query(probe)
        _absorb_timing()
        oracle = KnnProblem.prepare(expected,
                                    KnnConfig(k=k, adaptive=False),
                                    device=device)
        ref_i, ref_d = oracle.query(probe, k)
        zero_lost = (int(state["seq"]) == ctl.log.committed_seq
                     and int(state["n_points"]) == expected.shape[0])
        byte_identical = (np.array_equal(got_i, np.asarray(ref_i))
                          and np.array_equal(
                              got_d, np.asarray(ref_d, np.float32)))
        return {
            "n_points0": n, "k": k, "ops": ops, "seed": seed,
            "device": str(device),
            "killed_at_op": killed_at, "killed_pid": killed_pid,
            "failovers": ctl.failovers,
            "committed_mutations": ctl.log.committed_seq,
            "commits_acked": commits_acked,
            "zero_lost_committed": bool(zero_lost),
            "post_failover_byte_identical": bool(byte_identical),
            "failover_ok": bool(zero_lost and byte_identical
                                and ctl.failovers >= 1),
            "latency_decomposition": {
                name: _metrics.percentile_fields(hist)
                for name, hist in lat_hist.items()},
        }
    finally:
        ctl.close()


# -- the child: python -m cuda_knearests_tpu_torch.serve.fleet.replica ------

def _child_emit(obj: dict) -> None:
    print(RESULT_PREFIX + json.dumps(obj), flush=True)


def _child_main(argv) -> int:
    """The replica worker loop (runs in the child process only)."""
    from ...api import KnnProblem
    from ...config import KnnConfig

    with np.load(argv[0]) as z:
        points = np.asarray(z["points"], np.float32)
        k = int(z["k"])
        compact_threshold = int(z["compact_threshold"])
        device = str(z["device"])
    problem = KnnProblem.prepare(points, KnnConfig(k=k, adaptive=False),
                                 device=device)
    replica = Replica(problem, compact_threshold=compact_threshold)
    # cross-process trace stitching: tag this process 'replica:<pid>' and
    # spill spans when KNTPU_TRACE_DIR is set
    _spans.set_process_tag(f"replica:{os.getpid()}")
    _spans.start_file_trace_from_env(f"replica-{os.getpid()}")
    _child_emit({"ok": True, "ready": True, "n_points": points.shape[0],
                 "device": device})
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
            op = req.get("op")
            if op == "shutdown":
                _child_emit({"ok": True, "seq": replica.applied_seq})
                return 0
            if op == "apply":
                seq = replica.apply(DeltaRecord.from_json(req))
                _child_emit({"ok": True, "seq": seq,
                             "n_points": replica.overlay.n_points})
            elif op == "query":
                with _spans.span("replica.query", force=True,
                                 trace_id=req.get("trace_id")) as op_sp:
                    with _spans.span("replica.device",
                                     force=True) as dev_sp:
                        ids, d2 = replica.query(
                            np.asarray(req["queries"], np.float32),
                            int(req.get("k") or k))
                    wire_ids, wire_d2 = _encode_rows(ids, d2)
                _child_emit({"ok": True, "ids": wire_ids, "d2": wire_d2,
                             "seq": replica.applied_seq,
                             "trace_id": req.get("trace_id"),
                             "op_ms": round(op_sp.dur_ms, 4),
                             "device_ms": round(dev_sp.dur_ms, 4)})
            elif op == "seq":
                _child_emit({"ok": True, "seq": replica.applied_seq,
                             "n_points": replica.overlay.n_points})
            elif op == "metrics":
                _child_emit({"ok": True,
                             "metrics": _metrics.metrics_snapshot()})
            elif op == "promote":
                _child_emit({"ok": True, "seq": replica.applied_seq})
            else:
                _child_emit({"ok": False,
                             "error": f"unknown replica op {op!r}"})
        except Exception as e:  # noqa: BLE001 -- the transport contract: a failed op becomes one typed error frame and the loop survives
            _child_emit({"ok": False,
                         "error": f"{type(e).__name__}: {e}"})
    return 0


if __name__ == "__main__":
    sys.exit(_child_main(sys.argv[1:]))
