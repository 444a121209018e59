"""Mesh failover for pod tenants: snapshot and log replay across meshes.

Counterpart of ``cuda_knearests_tpu/serve/fleet/elastic.py``.  The dense
tenants' failover law (``replica.py``: a replica process takes over after
a real SIGKILL with zero lost committed mutations and byte-identical
answers) is extended here across meshes, for the elastic pod placement
(DESIGN.md section 22):

* **Snapshot** -- one tenant's durable state is its canonical cloud, as a
  prepared legacy problem in :func:`~...api.save_problem`'s schema, plus
  the committed log sequence it reflects.  Snapshots publish atomically
  (temp file and ``os.replace``), carry a schema tag and a sha256 over
  every field, and loading refuses a torn, corrupt or stale-schema file
  with the typed :class:`~...utils.memory.CorruptInputError`.  The file
  is the reference's byte for byte: the same cloud gives the same digest
  in both packages, and each loads the other's.
* **MeshProcess** -- one mesh as a child process (``python -m
  cuda_knearests_tpu_torch.serve.fleet.elastic <spec.npz>``) hosting a
  real :class:`~.frontdoor.FleetDaemon` with a single pod tenant on the
  banked device, on the framed stdio transport of
  :class:`~.replica.ReplicaProcess`: every mutation and query enters
  through ``fleet.submit`` (admission, the commit law, live rebalance
  pumping).  The shard decomposition ships back through an ``.npz``
  beside the spec, not as JSON text: at a million points the text frame
  would take longer than the drill.
* **MeshController** -- a primary and a standby mesh under the parent's
  authoritative :class:`~.replica.ReplicationLog`.  A mutation commits
  once the primary acked it and its record entered the log; only
  committed mutations are acknowledged.  After the primary dies,
  ``failover()`` restores the latest snapshot on the standby, re-ships
  ``log.since(snapshot_seq)`` and promotes the standby.
* **mesh_oracle_query** -- the byte-identity oracle rebuilt in THIS
  process from the standby's shipped shard decomposition (fresh
  per-shard prepares on the caller's device and the deterministic uid
  merge of :meth:`~...pod.reshard.ElasticIndex.rebuild_oracle_query`).
* **mesh_failover_drill** -- the proof: a hotspot stream through the
  primary's front door, a forced live rebalance, a snapshot under the
  in-flight migration, more committed mutations, a real mid-migration
  SIGKILL, standby promotion, and the three-way verdict (zero lost,
  byte identical, killed mid-migration).

Protocol table (model ``mesh-snapshot-replay``, analysis/models.py):

========  =======================================================
action    site
========  =======================================================
snapshot  ``write_snapshot`` (atomic publish) / ``snapshot_tenant``
          / ``MeshController.snapshot``
restore   ``load_snapshot`` (checksum refusal) /
          ``MeshProcess.restore`` / the failover restore
replay    ``MeshController.failover``'s ``log.since`` re-ship loop
========  =======================================================

The ``# proto:`` annotations at those sites bind them to the model.  The
commit path here also walks ``replication-commit.apply/append``: the
commit law of replica.py, lifted across meshes.
"""

from __future__ import annotations

import hashlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
import zipfile
from typing import Dict, Optional

import numpy as np

from ...obs import metrics as _metrics
from ...obs import spans as _spans
from ...runtime.supervisor import _REPO_ROOT, RESULT_PREFIX
from ...utils import prototrace
from ...utils.memory import CorruptInputError, TransportError
from ...utils.platform import resolve_device
from .replica import (DeltaRecord, ReplicationLog, _decode_d2, _encode_rows,
                      replay_on_host)

SNAPSHOT_SCHEMA = "kntpu-mesh-snapshot-v1"


# -- snapshots (atomic, checksummed, typed refusal) ---------------------------

def _snapshot_digest(fields: Dict[str, np.ndarray]) -> str:
    """sha256 over every field but the checksum: sorted names, each
    contributing its name, dtype, shape and raw bytes, so a flipped bit
    anywhere in the payload changes the digest."""
    h = hashlib.sha256()
    for name in sorted(fields):
        if name == "sha256":
            continue
        arr = np.asarray(fields[name])  # kntpu-ok: host-sync-loop -- snapshot envelope fields (host numpy), no device array rides this loop
        h.update(name.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def _npz_path(path: str) -> str:
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def write_snapshot(path: str, points: np.ndarray, k: int,
                   committed_seq: int, nshards: int, *,
                   device=None) -> dict:
    """Publish one mesh snapshot atomically; returns {path, sha256,
    committed_seq, n_points} and its cost (``prepare_s``, ``seconds``,
    ``bytes``).

    The cloud rides the ``save_problem`` schema (grid fields and config
    JSON: the prepare is checkpointed, not just the raw points), prepared
    on ``device`` (default: the GPU), extended with the mesh envelope:
    schema tag, the committed log sequence the cloud reflects, serving k,
    shard count, and the sha256 over everything.  The write goes to a
    temp file in the same directory and lands via ``os.replace``: readers
    see the old snapshot or the new one, never a torn one."""
    # proto: mesh-snapshot-replay.snapshot
    from ...api import KnnProblem, save_problem
    from ...config import KnnConfig

    t0 = _spans.now()
    path = _npz_path(path)
    pts = np.ascontiguousarray(np.asarray(points, np.float32).reshape(-1, 3))
    problem = KnnProblem.prepare(pts, KnnConfig(k=int(k), adaptive=False),
                                 device=resolve_device(device))
    prepare_s = _spans.now() - t0
    grid_tmp = path + ".grid.tmp.npz"
    save_problem(problem, grid_tmp)
    del problem
    with np.load(grid_tmp) as z:
        fields = {name: np.asarray(z[name]) for name in z.files}
    os.unlink(grid_tmp)
    fields["schema"] = np.bytes_(SNAPSHOT_SCHEMA.encode())
    fields["committed_seq"] = np.int64(committed_seq)
    fields["snap_k"] = np.int64(k)
    fields["nshards"] = np.int64(nshards)
    digest = _snapshot_digest(fields)
    fields["sha256"] = np.bytes_(digest.encode())
    fd, tmp = tempfile.mkstemp(
        prefix=os.path.basename(path) + ".tmp.",
        suffix=".npz", dir=os.path.dirname(path) or ".")
    os.close(fd)
    try:
        np.savez_compressed(tmp, **fields)
        os.replace(tmp, path)        # the atomic publish
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return {"path": path, "sha256": digest,
            "committed_seq": int(committed_seq),
            "n_points": int(pts.shape[0]),
            "prepare_s": prepare_s,
            "seconds": _spans.now() - t0,
            "bytes": os.path.getsize(path)}


def snapshot_tenant(tenant, path: str) -> dict:
    """Snapshot one fleet tenant (any placement): canonical cloud and
    committed log seq, prepared on the tenant's device.  Works
    mid-migration: the elastic index's ``mutated_points`` is
    migration-aware, so the snapshot reflects exactly the committed state
    the log sequence promises.  ``cloud_s`` is the canonical cloud's
    gather."""
    nshards = tenant.elastic.nshards if tenant.elastic is not None else 1
    t0 = _spans.now()
    cloud = tenant.mutated_points()
    cloud_s = _spans.now() - t0
    info = write_snapshot(                # proto: mesh-snapshot-replay.snapshot
        path, cloud, tenant.spec.k,
        tenant.log.committed_seq if tenant.log is not None else 0,
        nshards, device=tenant.device)
    prototrace.record("mesh-snapshot-replay", "snapshot")
    info["cloud_s"] = cloud_s
    return info


def load_snapshot(path: str) -> dict:
    """Read and verify one snapshot; typed refusal on anything suspect.

    Refusals are :class:`CorruptInputError` (kind 'corrupt'): an
    unreadable file, a missing envelope, an unknown or stale schema tag,
    or a checksum mismatch.  A standby mesh never promotes from a
    snapshot this function refused."""
    # proto: mesh-snapshot-replay.restore
    path = _npz_path(path)
    try:
        with np.load(path) as z:
            fields = {name: np.asarray(z[name]) for name in z.files}
    except (OSError, ValueError, KeyError, EOFError,
            zipfile.BadZipFile) as e:
        raise CorruptInputError(
            f"mesh snapshot {path!r}: unreadable ({type(e).__name__}: {e})"
        ) from e
    if "schema" not in fields or "sha256" not in fields:
        raise CorruptInputError(
            f"mesh snapshot {path!r}: missing schema/checksum envelope "
            f"(fields: {sorted(fields)})")
    schema = bytes(fields["schema"]).decode(errors="replace")
    if schema != SNAPSHOT_SCHEMA:
        raise CorruptInputError(
            f"mesh snapshot {path!r}: stale or unknown schema {schema!r} "
            f"(this build reads {SNAPSHOT_SCHEMA!r}); refusing to promote "
            f"a standby from it")
    want = bytes(fields["sha256"]).decode(errors="replace")
    got = _snapshot_digest(fields)
    if got != want:
        raise CorruptInputError(
            f"mesh snapshot {path!r}: checksum mismatch (stored "
            f"{want[:12]}.., computed {got[:12]}..) -- torn or corrupted "
            f"snapshot refused")
    # canonical order back: save_problem stores Morton-sorted points and
    # the permutation, orig[perm] = sorted
    perm = np.asarray(fields["permutation"]).astype(np.int64)
    sorted_pts = np.asarray(fields["points"], np.float32)
    pts = np.empty_like(sorted_pts)
    pts[perm] = sorted_pts
    return {"points": np.ascontiguousarray(pts),
            "committed_seq": int(fields["committed_seq"]),
            "k": int(fields["snap_k"]),
            "nshards": int(fields["nshards"]),
            "sha256": want}


# -- the parent-side byte-identity oracle -------------------------------------

def mesh_oracle_query(state: dict, queries: np.ndarray, k: int, *,
                      device=None):
    """Rebuild-from-scratch oracle over a mesh's shipped shard
    decomposition, computed in THIS process on ``device`` (default: the
    GPU): a fresh legacy problem per shard over that shard's exact cloud,
    the deterministic uid merge, and uid -> canonical translation from
    the shipped canonical order.  Mirrors
    :meth:`ElasticIndex.rebuild_oracle_query`, so a promoted standby's
    answers are checked byte for byte without trusting any code in the
    child."""
    from ...api import KnnProblem
    from ...config import KnnConfig
    from ...pod.reshard import ElasticIndex

    device = resolve_device(device)
    queries = np.ascontiguousarray(queries, np.float32).reshape(-1, 3)
    m = queries.shape[0]
    uids_canonical = np.asarray(state["uids_canonical"], np.int64)
    serving_k = int(state["k"])
    if m == 0 or uids_canonical.size == 0:
        return (np.full((m, k), -1, np.int32),
                np.full((m, k), np.inf, np.float32))
    per_shard = []
    for sh in state["shards"]:
        uids = np.asarray(sh["uids"], np.int64)  # kntpu-ok: host-sync-loop -- snapshot state (host numpy), no device array rides this loop
        pts = np.asarray(sh["points"], np.float32).reshape(-1, 3)  # kntpu-ok: host-sync-loop -- snapshot state (host numpy), no device array rides this loop
        if uids.size == 0:
            per_shard.append((np.full((m, k), -1, np.int64),
                              np.full((m, k), np.inf, np.float32)))
            continue
        fresh = KnnProblem.prepare(
            pts, KnnConfig(k=serving_k, adaptive=False), device=device)
        li, ld = fresh.query(queries, k)
        li = np.asarray(li)  # kntpu-ok: host-sync-loop -- failover replay ORACLE: one bounded fetch per shard by design, never the serving route
        safe = np.clip(li, 0, max(0, uids.size - 1))
        per_shard.append((np.where(li >= 0, uids[safe], np.int64(-1)),
                          np.asarray(ld, np.float32)))  # kntpu-ok: host-sync-loop -- failover replay ORACLE: one bounded fetch per shard by design, never the serving route
    u_i, out_d = ElasticIndex._merge_uid_rows(per_shard, k)
    cmap = np.full((int(uids_canonical.max()) + 1,), -1, np.int32)
    cmap[uids_canonical] = np.arange(uids_canonical.size, dtype=np.int32)
    safe = np.clip(u_i, 0, cmap.size - 1)
    out_i = np.where(u_i >= 0, cmap[safe.astype(np.int64)],
                     np.int32(-1)).astype(np.int32)
    return out_i, out_d


def state_cloud(state: dict) -> np.ndarray:
    """The canonical cloud reconstructed from a shipped shard
    decomposition: each uid's point over the shards (the last shard
    holding a uid wins), read out in canonical uid order -- the
    parent-side half of the zero-lost check.  One sort and one search
    over the uids instead of a Python walk over every one; a uid no shard
    holds raises KeyError."""
    shards = state["shards"]
    uids = np.concatenate(
        [np.asarray(sh["uids"], np.int64).reshape(-1) for sh in shards]
        or [np.zeros(0, np.int64)])
    pts = np.concatenate(
        [np.asarray(sh["points"], np.float32).reshape(-1, 3)
         for sh in shards] or [np.zeros((0, 3), np.float32)])
    want = np.asarray(state["uids_canonical"], np.int64).reshape(-1)
    order = np.argsort(uids, kind="stable")
    held = uids[order]
    at = np.searchsorted(held, want, side="right") - 1
    found = (at >= 0) & (held[np.maximum(at, 0)] == want) if held.size \
        else np.zeros(want.shape, bool)
    if not found.all():
        raise KeyError(int(want[np.argmin(found)]))
    return np.ascontiguousarray(pts[order[at]], np.float32)


# -- mesh bootstrap spec ------------------------------------------------------

def bank_mesh_spec(points: np.ndarray, k: int, nshards: int = 2,
                   compact_threshold: int = 512,
                   skew_threshold: float = 3.0,
                   migration_chunk: int = 64,
                   path: Optional[str] = None, *, device=None) -> str:
    """Write the mesh child's bootstrap spec (the cloud, the fleet knobs
    and the device it prepares on).  ``device`` defaults to the GPU, so a
    child builds its fleet on the card unless the caller banked 'cpu'."""
    device = resolve_device(device)
    if path is None:
        fd, path = tempfile.mkstemp(prefix="kntpu-mesh-", suffix=".npz")
        os.close(fd)
    np.savez_compressed(path,
                        points=np.asarray(points, np.float32),
                        k=np.int32(k), nshards=np.int32(nshards),
                        compact_threshold=np.int32(compact_threshold),
                        skew_threshold=np.float32(skew_threshold),
                        migration_chunk=np.int32(migration_chunk),
                        device=np.asarray(str(device)))
    return path


# -- parent-side handle of one mesh child -------------------------------------

class MeshProcess:
    """One mesh (a single-pod-tenant FleetDaemon) as a child process.

    The transport of :class:`~.replica.ReplicaProcess`: one JSON request
    line down stdin, one ``RESULT_PREFIX``-framed reply up stdout, raw-fd
    select with our own line buffer, TransportError on a dead or wedged
    child.  The handshake waits ``timeout_s`` (the child pays a torch
    import, a CUDA context and the fleet's prepare first)."""

    def __init__(self, spec_path: str, timeout_s: float = 180.0):
        self.spec_path = spec_path
        self.timeout_s = float(timeout_s)
        env = dict(os.environ)
        env["PYTHONPATH"] = _REPO_ROOT + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        self.proc = subprocess.Popen(
            [sys.executable, "-m",
             "cuda_knearests_tpu_torch.serve.fleet.elastic", spec_path],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True, env=env)
        self._buf = ""
        self.acked_seq = 0
        self.last_timing: dict = {}
        self.final_state: Optional[dict] = None
        try:
            ready = self._recv()
        except BaseException:
            self.kill()
            raise
        self.n_points = int(ready.get("n_points", 0))
        self.device = ready.get("device")

    @property
    def pid(self) -> int:
        return self.proc.pid

    @property
    def alive(self) -> bool:
        return self.proc.poll() is None

    def _recv(self) -> dict:
        import select

        deadline = (None if self.timeout_s <= 0
                    else time.monotonic() + self.timeout_s)
        fd = self.proc.stdout.fileno()
        while True:
            while "\n" in self._buf:
                line, self._buf = self._buf.split("\n", 1)
                if not line.startswith(RESULT_PREFIX):
                    continue
                frame = json.loads(line[len(RESULT_PREFIX):])
                if not frame.get("ok", False):
                    raise TransportError(
                        f"mesh pid {self.pid} error frame: "
                        f"{frame.get('error')}")
                return frame
            wait = (None if deadline is None
                    else max(0.0, deadline - time.monotonic()))
            ready, _, _ = select.select([fd], [], [], wait)
            if not ready:
                raise TransportError(
                    f"mesh pid {self.pid}: no reply within "
                    f"{self.timeout_s:.0f}s (wedged mesh)")
            chunk = os.read(fd, 65536)
            if not chunk:
                raise TransportError(
                    f"mesh pid {self.pid}: stdout closed "
                    f"(child exited rc {self.proc.poll()})")
            self._buf += chunk.decode("utf-8", errors="replace")

    def _call(self, req: dict) -> dict:
        try:
            self.proc.stdin.write(json.dumps(req) + "\n")
            self.proc.stdin.flush()
        except (BrokenPipeError, OSError) as e:
            raise TransportError(
                f"mesh pid {self.pid}: send failed ({e}) -- "
                f"mesh dead") from e
        return self._recv()

    def mutate(self, record: DeltaRecord) -> int:
        frame = self._call({"op": "mutate", **record.to_json()})
        self.acked_seq = int(frame["seq"])
        return self.acked_seq

    def query(self, queries: np.ndarray, k: Optional[int] = None,
              trace_id=None):
        t0 = _spans.now()
        frame = self._call({"op": "query",
                            "queries": np.asarray(queries,
                                                  np.float32).tolist(),
                            "k": (None if k is None else int(k)),
                            "trace_id": trace_id})
        e2e_ms = (_spans.now() - t0) * 1e3
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

    def state(self) -> dict:
        """{seq, n_points, migration_active, migrations_done, migration,
        device, launches, cuda_allocated_bytes} (``migration``: the live
        move's progress, or None; ``device``: where the child's shards
        live; ``launches``: the child's kernel launches so far, by
        kernel)."""
        return self._call({"op": "state"})

    def rebalance(self) -> dict:
        return self._call({"op": "rebalance"})

    def pump(self, n: int = 1) -> dict:
        return self._call({"op": "pump", "n": int(n)})

    def snapshot(self, path: str) -> dict:
        return self._call({"op": "snapshot", "path": str(path)})

    def restore(self, path: str) -> dict:
        """Promote this standby from a snapshot: the child refuses (typed,
        surfaced as a TransportError error frame) anything
        :func:`load_snapshot` refuses."""
        # proto: mesh-snapshot-replay.restore
        return self._call({"op": "restore", "path": str(path)})

    def shards(self) -> dict:
        """The mesh's shard decomposition: {k, uids_canonical, shards:
        [{uids, points}]} as host arrays.  The child writes them to an
        ``.npz`` beside the spec; this reads it and removes it."""
        fd, path = tempfile.mkstemp(
            prefix="kntpu-mesh-shards-", suffix=".npz",
            dir=os.path.dirname(os.path.abspath(self.spec_path)))
        os.close(fd)
        try:
            frame = self._call({"op": "shards", "path": path})
            with np.load(path) as z:
                return {"ok": True, "k": int(frame["k"]),
                        "uids_canonical": np.asarray(z["uids_canonical"]),
                        "shards": [{"uids": np.asarray(z[f"uids_{j}"]),
                                    "points": np.asarray(z[f"points_{j}"])}
                                   for j in range(int(frame["nshards"]))]}
        finally:
            try:
                os.unlink(path)
            except OSError:
                pass

    def kill(self) -> None:
        if self.alive:
            os.kill(self.pid, signal.SIGKILL)
        self.proc.wait()

    def close(self) -> None:
        """Shut the child down; its last frame (seq, device, launches)
        is kept as ``final_state``."""
        if self.alive:
            self.timeout_s = min(self.timeout_s, 15.0)
            try:
                self.final_state = self._call({"op": "shutdown"})
                self.proc.wait(timeout=15)
            except (TransportError, subprocess.TimeoutExpired):
                self.proc.kill()
                self.proc.wait()


class MeshController:
    """A primary and a standby mesh under one authoritative committed log.

    The commit law of :class:`~.replica.FailoverController`, lifted across
    meshes: the parent acks a mutation only after the primary mesh acked
    it and the record entered this log.  The standby receives no live
    stream: durability is a snapshot plus the ``log.since(snapshot_seq)``
    replay, which :meth:`failover` performs after the primary dies.  Both
    children build their fleet on ``device`` (default: the GPU)."""

    def __init__(self, points: np.ndarray, k: int, nshards: int = 2,
                 compact_threshold: int = 512, skew_threshold: float = 3.0,
                 migration_chunk: int = 16, timeout_s: float = 180.0,
                 snapshot_path: Optional[str] = None, *, device=None):
        self.initial_points = np.ascontiguousarray(
            np.asarray(points, np.float32).reshape(-1, 3))
        self.k = int(k)
        self.device = resolve_device(device)
        self.log = ReplicationLog()
        self.spec_path = bank_mesh_spec(
            self.initial_points, k, nshards, compact_threshold,
            skew_threshold, migration_chunk, device=self.device)
        if snapshot_path is None:
            fd, snapshot_path = tempfile.mkstemp(
                prefix="kntpu-mesh-snap-", suffix=".npz")
            os.close(fd)
        self.snapshot_path = snapshot_path
        self.primary: Optional[MeshProcess] = None
        self.standby: Optional[MeshProcess] = None
        try:
            self.primary = MeshProcess(self.spec_path, timeout_s=timeout_s)
            self.standby = MeshProcess(self.spec_path, timeout_s=timeout_s)
        except BaseException:
            self.close()
            raise
        self.snapshot_seq: Optional[int] = None
        self.failovers = 0

    def mutate(self, kind: str, payload: np.ndarray) -> DeltaRecord:
        rec = DeltaRecord(seq=self.log.committed_seq + 1, kind=kind,
                          payload=np.asarray(payload))
        self.primary.mutate(rec)         # raises TransportError if dead
        prototrace.record("replication-commit", "apply")  # proto: replication-commit.apply
        self.log.records.append(rec)     # the commit  # proto: replication-commit.append
        prototrace.record("replication-commit", "append")
        return rec

    def query(self, queries: np.ndarray, k: Optional[int] = None):
        return self.primary.query(queries, k)

    def snapshot(self) -> dict:
        info = self.primary.snapshot(self.snapshot_path)  # proto: mesh-snapshot-replay.snapshot
        self.snapshot_seq = int(info["committed_seq"])
        prototrace.record("mesh-snapshot-replay", "snapshot")
        return info

    def kill_primary(self) -> int:
        pid = self.primary.pid
        self.primary.kill()
        return pid

    def failover(self) -> dict:
        """The standby restores the last snapshot, the committed tail
        re-ships, the standby becomes primary.  Raises TransportError
        when there is no snapshot or no live standby (a total mesh loss
        is never absorbed silently).  ``restore_s`` and ``replay_s`` time
        the two halves."""
        if self.snapshot_seq is None:
            raise TransportError(
                "mesh failover impossible: no snapshot was ever taken "
                f"(committed log retains {self.log.committed_seq} "
                f"mutation(s) for a future mesh)")
        if self.standby is None or not self.standby.alive:
            raise TransportError("mesh failover impossible: standby dead")
        t0 = _spans.now()
        restored = self.standby.restore(self.snapshot_path)  # proto: mesh-snapshot-replay.restore
        restore_s = _spans.now() - t0
        prototrace.record("mesh-snapshot-replay", "restore")
        base_seq = int(restored["seq"])
        replayed = 0
        t0 = _spans.now()
        for rec in self.log.since(base_seq):
            self.standby.mutate(rec)     # proto: mesh-snapshot-replay.replay
            replayed += 1
        replay_s = _spans.now() - t0
        # one replay event: the model's `replay` is the atomic tail
        # composition (restore + replay == committed), not per record
        prototrace.record("mesh-snapshot-replay", "replay")
        self.primary = self.standby
        self.standby = None
        self.failovers += 1
        return {"promoted_pid": self.primary.pid,
                "restored_seq": base_seq, "replayed": replayed,
                "committed_seq": self.log.committed_seq,
                "restore_s": restore_s, "replay_s": replay_s}

    def expected_points(self) -> np.ndarray:
        return replay_on_host(self.initial_points, self.log.records)

    def close(self) -> None:
        for p in (self.primary, self.standby):
            if p is not None:
                p.close()
        for path in (self.spec_path, self.snapshot_path):
            try:
                os.unlink(path)
            except OSError:
                pass


def mesh_failover_drill(n: int = 1200, k: int = 8, ops: int = 30,
                        seed: int = 0, nshards: int = 2,
                        migration_chunk: int = 4, log=None, *,
                        device=None) -> dict:
    """The cross-mesh failover proof (the chaos campaign's SIGKILL-drill
    case), with both meshes and the oracle on ``device`` (default: the
    GPU).

    A primary and a standby mesh run as child processes.  A seeded
    hotspot stream commits through the primary's front door and skews the
    Morton ranges; a live rebalance is forced; a snapshot publishes under
    the in-flight migration; more mutations commit; then the primary
    takes a real SIGKILL while the migration is still in flight.
    ``mesh_failover_ok`` requires (a) the kill interrupted a live
    migration, (b) zero lost committed mutations -- the promoted
    standby's sequence and exact canonical cloud equal the committed
    log's host replay -- and (c) answers byte-identical to the
    parent-side per-shard rebuild oracle, and (d) the probe rows exact
    against the host kd-tree over the committed cloud (tie-aware), which
    shares no code with the card's kernels.  ``timing`` splits the
    drill's seconds (spawn, snapshot, restore, replay, shard shipping,
    the cloud check, the oracles) and ``migration_at_kill`` is the live
    move's progress when the kill came.  ``primary_at_kill`` and
    ``mesh_child`` are the killed primary's and the promoted standby's
    own reports (device, kernel launches, allocated bytes), and
    ``card_free_bytes_both_meshes`` the card's free memory while both
    children hold their meshes (None off the card)."""
    from ...fuzz.compare import check_route_result
    from ...io import generate_uniform
    from ...oracle import KdTreeOracle

    t_start = _spans.now()
    device = resolve_device(device)
    log = log or (lambda s: None)
    rng = np.random.default_rng(seed)
    points = generate_uniform(n, seed=seed)
    t0 = _spans.now()
    ctl = MeshController(points, k, nshards=nshards,
                         migration_chunk=migration_chunk, device=device)
    timing = {"spawn_s": _spans.now() - t0}
    free_both = None
    if device.type == "cuda":
        import torch

        free_both = int(torch.cuda.mem_get_info(device)[0])
    lat_hist = {name: _metrics.Histogram(f"mesh_failover.{name}")
                for name in ("total_ms", "queue_ms", "dispatch_ms",
                             "device_ms")}

    def _absorb_timing() -> None:
        for key, hist in lat_hist.items():
            v = ctl.primary.last_timing.get(key)
            if v is not None:
                hist.observe(v)

    rebalance_at = max(2, ops // 2 - 3)
    snapshot_at = rebalance_at + 1
    kill_at = snapshot_at + 3        # a committed tail exists past the snap
    killed_mid_migration = False
    killed_pid = None
    migration_at_kill = None
    primary_at_kill = None
    snap: dict = {}
    failover_info: dict = {}
    try:
        for i in range(ops):
            if i == rebalance_at:
                info = ctl.primary.rebalance()
                log(f"rebalance forced: {info}")
            if i == snapshot_at:
                snap = ctl.snapshot()
                log(f"snapshot: seq {snap['committed_seq']} "
                    f"sha {snap['sha256'][:12]}")
            if i == kill_at:
                st = ctl.primary.state()
                killed_mid_migration = bool(st["migration_active"])
                migration_at_kill = st.get("migration")
                primary_at_kill = _child_report_of(st)
                killed_pid = ctl.kill_primary()
                log(f"SIGKILL pid {killed_pid} "
                    f"(mid-migration={killed_mid_migration}, "
                    f"migration {migration_at_kill})")
            roll = rng.random()
            try:
                if roll < 0.55:
                    # hotspot inserts: low-Morton corner, skews shard 0
                    pts = (rng.random((12, 3)) * 110.0 + 5.0
                           ).astype(np.float32)
                    ctl.mutate("insert", pts)
                elif roll < 0.7 and ctl.log.committed_seq:
                    n_now = ctl.expected_points().shape[0]
                    if n_now > 8:
                        ids = np.sort(rng.choice(n_now, size=2,
                                                 replace=False))
                        ctl.mutate("delete", ids.astype(np.int64))
                else:
                    qs = (rng.random((6, 3)) * 980.0 + 10.0
                          ).astype(np.float32)
                    ctl.query(qs)
                    _absorb_timing()
            except TransportError:
                # the dead primary surfaces here; the op was never acked,
                # so promoting the standby and moving on loses nothing
                failover_info = ctl.failover()
                log(f"mesh failover: {failover_info}")
        expected = ctl.expected_points()
        state = ctl.primary.state()
        zero_lost_seq = int(state["seq"]) == ctl.log.committed_seq
        t0 = _spans.now()
        shards_state = ctl.primary.shards()
        timing["shards_s"] = _spans.now() - t0
        t0 = _spans.now()
        cloud = state_cloud(shards_state)
        timing["state_cloud_s"] = _spans.now() - t0
        zero_lost_cloud = (cloud.shape == expected.shape
                           and np.array_equal(cloud, expected))
        probe = (np.random.default_rng(seed + 9).random((24, 3))
                 * 980.0 + 10.0).astype(np.float32)
        got_i, got_d = ctl.query(probe)
        _absorb_timing()
        t0 = _spans.now()
        ref_i, ref_d = mesh_oracle_query(shards_state, probe, k,
                                         device=device)
        timing["oracle_s"] = _spans.now() - t0
        byte_identical = (np.array_equal(got_i, ref_i)
                          and np.array_equal(got_d, ref_d))
        t0 = _spans.now()
        _kd_i, kd_d = KdTreeOracle(expected).knn(probe, k)
        kd_bad = check_route_result(expected, probe, got_i, got_d, kd_d, k)
        timing["kdtree_s"] = _spans.now() - t0
        mesh_child = _child_report_of(ctl.primary.state())
        zero_lost = bool(zero_lost_seq and zero_lost_cloud)
        timing.update({
            "snapshot_s": snap.get("seconds"),
            "snapshot_prepare_s": snap.get("prepare_s"),
            "snapshot_cloud_s": snap.get("cloud_s"),
            "snapshot_bytes": snap.get("bytes"),
            "restore_s": failover_info.get("restore_s"),
            "replay_s": failover_info.get("replay_s"),
            "replayed": failover_info.get("replayed"),
            "drill_s": _spans.now() - t_start})
        return {
            "n_points0": n, "k": k, "ops": ops, "seed": seed,
            "nshards": nshards, "device": str(device),
            "killed_at_op": kill_at, "killed_pid": killed_pid,
            "killed_mid_migration": bool(killed_mid_migration),
            "migration_at_kill": migration_at_kill,
            "mesh_failovers": ctl.failovers,
            "committed_mutations": ctl.log.committed_seq,
            "snapshot_seq": ctl.snapshot_seq,
            "replay_tail": (ctl.log.committed_seq
                            - (ctl.snapshot_seq or 0)),
            "zero_lost_committed": zero_lost,
            "post_failover_byte_identical": bool(byte_identical),
            "post_failover_exact": kd_bad is None,
            "kdtree_mismatch": (None if kd_bad is None
                                else kd_bad.render()),
            "mesh_failover_ok": bool(zero_lost and byte_identical
                                     and kd_bad is None
                                     and killed_mid_migration
                                     and ctl.failovers >= 1),
            "primary_at_kill": primary_at_kill,
            "mesh_child": mesh_child,
            "card_free_bytes_both_meshes": free_both,
            "latency_decomposition": {
                name: _metrics.percentile_fields(hist)
                for name, hist in lat_hist.items()},
            "timing": timing,
        }
    finally:
        ctl.close()


# -- the child: python -m cuda_knearests_tpu_torch.serve.fleet.elastic -------

def _child_emit(obj: dict) -> None:
    print(RESULT_PREFIX + json.dumps(obj), flush=True)


class _MeshState:
    """The child's mutable world: one single-pod-tenant FleetDaemon on the
    banked device and the dense-sequence ledger (the restored snapshot's
    seq plus the locally committed ones)."""

    TENANT = "mesh"

    def __init__(self, points: np.ndarray, k: int, nshards: int,
                 compact_threshold: int, skew_threshold: float,
                 migration_chunk: int, device):
        self.k = int(k)
        self.nshards = int(nshards)
        self.compact_threshold = int(compact_threshold)
        self.skew_threshold = float(skew_threshold)
        self.migration_chunk = int(migration_chunk)
        self.device = device
        self.base_seq = 0
        self.req = 0
        self.fleet = None
        self._build(points)

    def _build(self, points: np.ndarray) -> None:
        from ...config import ServeFleetConfig
        from .frontdoor import FleetDaemon
        from .tenants import TenantSpec

        cfg = ServeFleetConfig(
            min_bucket=8, max_batch=64, warmup=False,
            sidecar_threshold=1, pod_threshold=2,
            pod_shards=self.nshards,
            pod_skew_threshold=self.skew_threshold,
            compact_threshold=self.compact_threshold)
        self.fleet = None             # free the old fleet before the new
        self.fleet = FleetDaemon(
            [(TenantSpec(name=self.TENANT, k=self.k), points)], cfg,
            device=self.device)
        t = self.tenant
        if t.elastic is not None:
            t.elastic.migration_chunk = self.migration_chunk

    @property
    def tenant(self):
        return self.fleet.tenants[self.TENANT]

    @property
    def applied_seq(self) -> int:
        return self.base_seq + (self.tenant.log.committed_seq
                                if self.tenant.log is not None else 0)

    def submit(self, kind: str, payload, k=None, trace_id=None):
        self.req += 1
        rs = self.fleet.submit(
            req_id=self.req, tenant=self.TENANT, kind=kind,
            payload=payload, k=k, now=time.monotonic(),
            trace_id=trace_id)
        mine = [r for r in rs if r.req_id == self.req]
        resp = mine[-1] if mine else rs[-1]
        if not resp.ok:
            raise RuntimeError(f"front door refused {kind}: {resp.error}")
        return resp


def _child_report(state: "_MeshState") -> dict:
    """The child's own account of where it runs: the device its shards
    live on, its kernel launches so far and the bytes it holds on the
    card (0 off the card)."""
    import torch

    from ...runtime.dispatch import kernel_launches

    el = state.tenant.elastic
    device = torch.device(el.device if el is not None else state.device)
    return {"device": str(device), "launches": kernel_launches(),
            "cuda_allocated_bytes": int(
                torch.cuda.memory_allocated(device)
                if device.type == "cuda" else 0)}


def _child_report_of(frame: dict) -> dict:
    return {key: frame.get(key) for key in
            ("device", "launches", "cuda_allocated_bytes")}


def _migration_progress(el) -> Optional[dict]:
    """The live move's progress (None when no migration is in flight)."""
    mig = None if el is None else el.migration
    if mig is None:
        return None
    return {"donor": mig.donor, "receiver": mig.receiver,
            "shipped": int(mig._qpos), "queued": len(mig.queue),
            "records": int(mig.committed_seq), "pumps": int(mig.pumps)}


def _child_main(argv) -> int:
    """The mesh worker loop (runs in the child process only)."""
    with np.load(argv[0]) as z:
        points = np.asarray(z["points"], np.float32)
        state = _MeshState(
            points, k=int(z["k"]), nshards=int(z["nshards"]),
            compact_threshold=int(z["compact_threshold"]),
            skew_threshold=float(z["skew_threshold"]),
            migration_chunk=int(z["migration_chunk"]),
            device=str(z["device"]))
    _spans.set_process_tag(f"mesh:{os.getpid()}")
    _spans.start_file_trace_from_env(f"mesh-{os.getpid()}")
    _child_emit({"ok": True, "ready": True,
                 "n_points": int(points.shape[0]),
                 "device": state.device})
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
            op = req.get("op")
            if op == "shutdown":
                _child_emit({"ok": True, "seq": state.applied_seq,
                             **_child_report(state)})
                return 0
            if op == "mutate":
                rec = DeltaRecord.from_json(req)
                if rec.seq != state.applied_seq + 1:
                    raise RuntimeError(
                        f"replication sequence gap: mesh at seq "
                        f"{state.applied_seq}, record carries seq "
                        f"{rec.seq} (committed deltas must apply "
                        f"densely in order)")
                resp = state.submit(rec.kind, rec.payload)
                _child_emit({"ok": True, "seq": state.applied_seq,
                             "n_points": int(resp.n_points or 0)})
            elif op == "query":
                with _spans.span("mesh.query", force=True,
                                 trace_id=req.get("trace_id")) as op_sp:
                    resp = state.submit(
                        "query", np.asarray(req["queries"], np.float32),  # kntpu-ok: host-sync-loop -- JSON-decoded wire payload (host list), no device array rides this loop
                        k=req.get("k"), trace_id=req.get("trace_id"))
                    wire_ids, wire_d2 = _encode_rows(
                        np.asarray(resp.ids), np.asarray(resp.d2))  # kntpu-ok: host-sync-loop -- wire encode of an already-fetched Response (host numpy)
                _child_emit({"ok": True, "ids": wire_ids, "d2": wire_d2,
                             "seq": state.applied_seq,
                             "trace_id": req.get("trace_id"),
                             "op_ms": round(op_sp.dur_ms, 4),
                             "device_ms": float(
                                 getattr(resp, "device_ms", 0.0) or 0.0)})
            elif op == "state":
                el = state.tenant.elastic
                _child_emit({
                    "ok": True, "seq": state.applied_seq,
                    "n_points": int(state.tenant.n_points),
                    "migration_active": bool(
                        el is not None and el.migration is not None),
                    "migrations_done": int(
                        el.migrations_done if el is not None else 0),
                    "migration": _migration_progress(el),
                    **_child_report(state)})
            elif op == "rebalance":
                el = state.tenant.elastic
                planned = bool(el is not None and el.force_rebalance())
                _child_emit({"ok": True, "planned": planned,
                             "migration_active": bool(
                                 el is not None
                                 and el.migration is not None),
                             "migration": _migration_progress(el)})
            elif op == "pump":
                el = state.tenant.elastic
                for _ in range(max(1, int(req.get("n") or 1))):
                    if el is None or el.migration is None:
                        break
                    el.pump()
                _child_emit({"ok": True, "migration_active": bool(
                    el is not None and el.migration is not None)})
            elif op == "snapshot":
                info = snapshot_tenant(state.tenant, req["path"])
                info["committed_seq"] = state.applied_seq
                _child_emit({"ok": True, **info})
            elif op == "restore":
                snap = load_snapshot(req["path"])   # typed refusal here
                state.base_seq = snap["committed_seq"]
                state._build(snap["points"])
                _child_emit({"ok": True, "seq": state.applied_seq,
                             "n_points": int(snap["points"].shape[0]),
                             "sha256": snap["sha256"]})
            elif op == "shards":
                el = state.tenant.elastic
                if el is None:
                    raise RuntimeError("mesh tenant is not on the pod "
                                       "placement; no shard state")
                arrays = {"uids_canonical": el.uids_canonical}
                for j, s in enumerate(el.shards):
                    arrays[f"uids_{j}"] = s.uids
                    arrays[f"points_{j}"] = s.points()
                np.savez(req["path"], **arrays)
                _child_emit({"ok": True, "k": el.k,
                             "nshards": len(el.shards)})
            else:
                _child_emit({"ok": False,
                             "error": f"unknown mesh op {op!r}"})
        except Exception as e:  # noqa: BLE001 -- the transport contract: a failed op becomes one typed error frame and the loop survives
            _child_emit({"ok": False,
                         "error": f"{type(e).__name__}: {e}"})
    return 0


if __name__ == "__main__":
    sys.exit(_child_main(sys.argv[1:]))
