"""Fleet fuzzing: multi-tenant interleavings against per-tenant oracles.

Counterpart of ``cuda_knearests_tpu/fuzz/fleet.py``, on ``device``
(default: the GPU).  The fleet front door (``serve/fleet``) promises
per-tenant isolation: every tenant's answers are exactly what a
single-tenant engine over that tenant's mutated cloud would give, however
the other tenants' queries, mutations, sidecar placements and failovers
interleave.  This module attacks that promise:

* Seeded multi-tenant op streams (queries, inserts with duplicate and
  cluster hazards, deletes; each tagged with its tenant), with a
  guaranteed mutate -> failover -> query tail on the replicated tenant,
  so the replication log's re-ship path runs mid-stream under both ship
  modes ('sync' and 'lazy').
* After every query op the answering tenant is checked against its own
  independently tracked cloud (the host's np.delete / np.concatenate
  replay of the acked mutations, the overlay's and the log's indexing)
  through a fresh legacy ``KnnProblem`` on the same device and the
  tie-aware comparison (``fuzz/compare.py``): distance-multiset equality
  is the contract, index equality is wrong under the duplicate hazards.
* Failing streams ddmin-minimize and bank to
  ``tests/corpus_torch/*-fleet.npz``.
* ``KNTPU_FLEET_FAULT=cross-tenant|drop-delta|stale-replica`` seeds the
  three fleet corruptions (``serve/fleet/frontdoor.py``); each yields a
  banked failure, diverted away from the real corpus
  (``fuzz.safe_bank_dir``).

The campaign runs under the protocol-action recorder
(``utils/prototrace.py``) and stamps its manifest with
``analysis.models.proto_stamp`` of the drained trace.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import CORPUS_DIR, corpus_size, safe_bank_dir
from .compare import check_route_result
from .mutation import ddmin_ops
from ..config import DOMAIN_SIZE

# Small enough that streams compact mid-case; the sidecar threshold sits
# between the tiny and dense generator sizes so both placements fuzz.
FLEET_COMPACT_THRESHOLD = 24
FLEET_SIDECAR_THRESHOLD = 48


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """Regenerable identity of one fleet case."""

    seed: int
    n0s: Tuple[int, ...]          # per-tenant initial cloud sizes
    ks: Tuple[int, ...]           # per-tenant serving k
    n_ops: int
    replicated: int               # tenant index carrying replicas (-1=none)
    ship_mode: str                # 'sync' | 'lazy'

    @property
    def n_tenants(self) -> int:
        return len(self.n0s)

    def tenant_names(self) -> List[str]:
        return [f"t{i}" for i in range(self.n_tenants)]

    def case_id(self) -> str:
        sizes = "x".join(str(n) for n in self.n0s)
        return (f"fleet-s{self.seed}-n{sizes}-o{self.n_ops}"
                f"-r{self.replicated}-{self.ship_mode}")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "FleetSpec":
        return cls(seed=int(d["seed"]), n0s=tuple(d["n0s"]),
                   ks=tuple(d["ks"]), n_ops=int(d["n_ops"]),
                   replicated=int(d["replicated"]),
                   ship_mode=str(d["ship_mode"]))


@dataclasses.dataclass
class FleetFailure:
    """One stream's isolation violation (or crash)."""

    case_id: str
    kind: str
    reason: str
    op_index: int
    original_ops: int
    minimized_ops: Optional[int] = None
    banked: Optional[str] = None

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def initial_clouds(spec: FleetSpec) -> List[np.ndarray]:
    return [(np.random.default_rng(spec.seed + 101 * i)
             .random((n0, 3)) * (DOMAIN_SIZE * 0.98)
             + DOMAIN_SIZE * 0.01).astype(np.float32)
            for i, n0 in enumerate(spec.n0s)]


def generate_ops(spec: FleetSpec) -> List[dict]:
    """The seeded tenant-tagged op stream.  Structure guarantees: when a
    tenant is replicated, the stream holds at least one committed
    mutation on it, then a failover, then a query of it (the re-ship path
    always fuzzes); every tenant gets one final query (a pure-mutation
    tail still checks)."""
    rng = np.random.default_rng(spec.seed + 1)
    clouds = initial_clouds(spec)
    live = [int(c.shape[0]) for c in clouds]
    names = spec.tenant_names()
    ops: List[dict] = []

    def _insert(ti: int) -> dict:
        m = int(rng.integers(1, 7))
        flavor = rng.random()
        if flavor < 0.5 or live[ti] == 0:
            pts = (rng.random((m, 3)) * (DOMAIN_SIZE * 0.98)
                   + DOMAIN_SIZE * 0.01).astype(np.float32)
        elif flavor < 0.8:
            # duplicate hazard: exact copies of one initial point of THIS
            # tenant (exactly tied f32 distances through the merge)
            src = clouds[ti][int(rng.integers(0, clouds[ti].shape[0]))]
            pts = np.tile(src, (m, 1)).astype(np.float32)
        else:
            # cluster hazard: a tight blob inside one cell
            c = rng.random(3) * (DOMAIN_SIZE * 0.9) + DOMAIN_SIZE * 0.05
            pts = (c + rng.normal(0, DOMAIN_SIZE * 1e-4, (m, 3))
                   ).clip(0, np.nextafter(DOMAIN_SIZE, 0)).astype(np.float32)
        live[ti] += m
        return {"op": "insert", "tenant": names[ti], "points": pts}

    def _query(ti: int) -> dict:
        m = int(rng.integers(1, 7))
        qs = (rng.random((m, 3)) * (DOMAIN_SIZE * 0.98)
              + DOMAIN_SIZE * 0.01).astype(np.float32)
        return {"op": "query", "tenant": names[ti], "queries": qs}

    for _ in range(spec.n_ops):
        ti = int(rng.integers(0, spec.n_tenants))
        roll = rng.random()
        if roll < 0.35:
            ops.append(_insert(ti))
        elif roll < 0.55 and live[ti] > 8:
            m = int(rng.integers(1, 5))
            ids = np.sort(rng.choice(live[ti], size=m, replace=False))
            ops.append({"op": "delete", "tenant": names[ti],
                        "ids": ids.astype(np.int64)})
            live[ti] -= m
        else:
            ops.append(_query(ti))
    if 0 <= spec.replicated < spec.n_tenants:
        ti = spec.replicated
        ops.append(_insert(ti))
        ops.append({"op": "failover", "tenant": names[ti]})
        ops.append(_query(ti))
    ops.extend(_query(ti) for ti in range(spec.n_tenants))
    return ops


def _parse_fleet_fault() -> Optional[str]:
    """One validation site for KNTPU_FLEET_FAULT: the front door's
    (a typed InvalidConfigError on an unknown value); imported lazily so
    the serving stack stays off this module's import path."""
    from ..serve.fleet.frontdoor import _parse_fleet_fault as parse

    return parse()


def replay_ops(spec: FleetSpec, ops: Sequence[dict], device=None,
               answers: Optional[list] = None
               ) -> Optional[Tuple[str, str, int]]:
    """Run one stream through a fresh fleet on ``device`` (default: the
    GPU), checking every query op against the answering tenant's
    independently tracked cloud.  Returns None when clean, else (kind,
    reason, op_index).  A raise on a legal stream is the failure.
    ``answers``, when a list, receives ``(op_index, ids, d2)`` of every
    checked query (the card-against-CPU comparison reads them)."""
    from ..api import KnnProblem
    from ..config import KnnConfig, ServeFleetConfig
    from ..serve.fleet.frontdoor import FleetDaemon
    from ..serve.fleet.tenants import TenantSpec

    names = spec.tenant_names()
    try:
        clouds = initial_clouds(spec)
        tracked = {name: np.array(c) for name, c in zip(names, clouds)}
        builds = [(TenantSpec(name=names[i], k=spec.ks[i],
                              slo="latency" if i % 2 == 0
                              else "throughput",
                              replicas=1 if i == spec.replicated else 0,
                              ship_mode=spec.ship_mode), clouds[i])
                  for i in range(spec.n_tenants)]
        fleet = FleetDaemon(builds, ServeFleetConfig(
            min_bucket=8, max_batch=64,
            compact_threshold=FLEET_COMPACT_THRESHOLD, warmup=False,
            sidecar_threshold=FLEET_SIDECAR_THRESHOLD, drr_quantum=16),
            device=device)
        now = 0.0
        for i, op in enumerate(ops):
            now += 1e-3
            name = op["tenant"]
            ti = names.index(name)
            if op["op"] == "insert":
                resp = fleet.submit(i, name, "insert", op["points"],
                                    now=now)
                if resp and resp[-1].ok:
                    tracked[name] = np.concatenate(
                        [tracked[name],
                         np.asarray(op["points"], np.float32)])  # kntpu-ok: host-sync-loop -- host-resident op payload (pure numpy), no device array rides this loop
            elif op["op"] == "delete":
                ids = np.asarray(op["ids"]).reshape(-1)  # kntpu-ok: host-sync-loop -- host-resident op payload (pure numpy), no device array rides this loop
                ids = ids[ids < tracked[name].shape[0]]  # re-legalize
                if ids.size == 0:
                    continue
                resp = fleet.submit(i, name, "delete", ids, now=now)
                if resp and resp[-1].ok:
                    tracked[name] = np.delete(tracked[name], ids, axis=0)
            elif op["op"] == "failover":
                t = fleet.tenants[name]
                if t.is_sidecar or not t.replica_pool:
                    continue  # minimization may orphan the failover op
                fleet.failover(name)
            else:
                queries = np.asarray(op["queries"], np.float32)  # kntpu-ok: host-sync-loop -- host-resident op payload (pure numpy), no device array rides this loop
                k = spec.ks[ti]
                responses = fleet.submit(i, name, "query", queries,
                                         now=now)
                responses += fleet.drain(now)
                mine = [r for r in responses
                        if r.req_id == i and r.tenant == name]
                if len(mine) != 1 or not mine[0].ok:
                    err = mine[0].error if mine else "<no response>"
                    return ("mismatch",
                            f"op {i}: tenant {name} query got no clean "
                            f"response: {err}", i)
                got_i = np.asarray(mine[0].ids)  # kntpu-ok: host-sync-loop -- Response rows are host numpy (the daemon fetched them through dispatch already)
                got_d = np.asarray(mine[0].d2)  # kntpu-ok: host-sync-loop -- Response rows are host numpy (the daemon fetched them through dispatch already)
                if answers is not None:
                    answers.append((i, got_i, got_d))
                pts = tracked[name]
                ref = KnnProblem.prepare(
                    pts, KnnConfig(k=k, adaptive=False), validate=False,
                    device=fleet.device)
                _ref_i, ref_d = ref.query(queries, k)
                bad = check_route_result(pts, queries, got_i, got_d,
                                         np.asarray(ref_d), k)  # kntpu-ok: host-sync-loop -- one oracle readback per QUERY op is the differential harness's job
                if bad is not None:
                    return ("mismatch",
                            f"op {i}: tenant {name} diverged from its "
                            f"rebuild oracle: {bad.render()}", i)
    except Exception as e:  # noqa: BLE001 -- containment IS the job: any raise on a legal stream is the banked failure
        from ..utils.memory import classify_fault_text

        kind = classify_fault_text(f"{type(e).__name__}: {e}") or "crash"
        return (kind, f"op stream raised {type(e).__name__}: {e}",
                len(ops))
    return None


def answers_equal(replay, spec, ops: Sequence[dict], device) -> dict:
    """Replay one stream (``replay``: this module's or the chaos
    module's ``replay_ops``) on ``device`` and on the CPU and hold every
    checked query's ids and d2 equal bit for bit.  Returns {'queries',
    'verdicts' (the two replays' results), 'difference' (None, or the
    first disagreement)}."""
    from ..serve.fleet.loadgen import rows_bit_equal

    got: list = []
    want: list = []
    v_dev = replay(spec, ops, device=device, answers=got)
    v_cpu = replay(spec, ops, device="cpu", answers=want)
    out = {"queries": len(got), "verdicts": [v_dev, v_cpu],
           "difference": None}
    if len(got) != len(want):
        out["difference"] = (f"{len(got)} checked queries against the "
                             f"CPU's {len(want)}")
        return out
    for (i, a_i, a_d), (j, b_i, b_d) in zip(got, want):
        if i != j or not rows_bit_equal(a_i, a_d, b_i, b_d):
            out["difference"] = f"op {i}: rows differ from the CPU's"
            return out
    return out


# -- banking ------------------------------------------------------------------

def _ops_to_json(ops: Sequence[dict]) -> str:
    out = []
    for op in ops:
        item = {"op": op["op"], "tenant": op["tenant"]}
        if op["op"] == "insert":
            item["points"] = np.asarray(op["points"], np.float32).tolist()  # kntpu-ok: host-sync-loop -- host-resident op payload (pure numpy), no device array rides this loop
        elif op["op"] == "delete":
            item["ids"] = np.asarray(op["ids"]).tolist()  # kntpu-ok: host-sync-loop -- host-resident op payload (pure numpy), no device array rides this loop
        elif op["op"] == "query":
            item["queries"] = np.asarray(op["queries"],  # kntpu-ok: host-sync-loop -- host-resident op payload (pure numpy), no device array rides this loop
                                         np.float32).tolist()
        out.append(item)
    return json.dumps(out)


def ops_from_json(text: str) -> List[dict]:
    ops = []
    for op in json.loads(text):
        item = {"op": op["op"], "tenant": op["tenant"]}
        if op["op"] == "insert":
            item["points"] = np.asarray(op["points"], np.float32)  # kntpu-ok: host-sync-loop -- host-resident op payload (pure numpy), no device array rides this loop
        elif op["op"] == "delete":
            item["ids"] = np.asarray(op["ids"], np.int64)  # kntpu-ok: host-sync-loop -- host-resident op payload (pure numpy), no device array rides this loop
        elif op["op"] == "query":
            item["queries"] = np.asarray(op["queries"], np.float32)  # kntpu-ok: host-sync-loop -- host-resident op payload (pure numpy), no device array rides this loop
        ops.append(item)
    return ops


def bank_fleet_case(bank_dir: str, spec: FleetSpec, kind: str,
                    reason: str, ops: Sequence[dict]) -> str:
    os.makedirs(bank_dir, exist_ok=True)
    path = os.path.join(bank_dir, f"{spec.case_id()}-fleet.npz")
    np.savez_compressed(
        path,
        schema=np.bytes_(b"fleet-stream-v1"),
        spec_json=np.bytes_(json.dumps(spec.to_json()).encode()),
        ops_json=np.bytes_(_ops_to_json(ops).encode()),
        kind=np.bytes_(kind.encode()),
        reason=np.bytes_(reason[:2000].encode()))
    return path


def load_fleet_case(path: str) -> dict:
    with np.load(path) as z:
        return {
            "spec": FleetSpec.from_json(
                json.loads(bytes(z["spec_json"]).decode())),
            "ops": ops_from_json(bytes(z["ops_json"]).decode()),
            "kind": bytes(z["kind"]).decode(),
            "reason": bytes(z["reason"]).decode(),
        }


def _safe_bank_dir(bank_dir: Optional[str]) -> Optional[str]:
    """A ``KNTPU_FLEET_FAULT`` run never banks its synthetic repros into
    the real corpus (``fuzz.safe_bank_dir``)."""
    return safe_bank_dir(bank_dir, _parse_fleet_fault() is not None,
                         "kntpu-fleet-faulted-")


def run_fleet_case(spec: FleetSpec, bank_dir: Optional[str] = None,
                   minimize: bool = True, max_probes: int = 24,
                   device=None) -> Optional[FleetFailure]:
    """One case end to end on ``device``: generate, replay, minimize,
    bank."""
    ops = generate_ops(spec)
    got = replay_ops(spec, ops, device=device)
    if got is None:
        return None
    kind, reason, op_index = got
    failure = FleetFailure(case_id=spec.case_id(), kind=kind,
                           reason=reason, op_index=op_index,
                           original_ops=len(ops))
    repro = list(ops)
    if minimize and len(ops) > 1:
        def _still_fails(sub):
            sub_got = replay_ops(spec, sub, device=device)
            return sub_got is not None and sub_got[0] == kind
        repro = ddmin_ops(repro, _still_fails, max_probes=max_probes)
    failure.minimized_ops = len(repro)
    bank_dir = _safe_bank_dir(bank_dir)
    if bank_dir is not None:
        failure.banked = bank_fleet_case(bank_dir, spec, kind, reason,
                                         repro)
    return failure


def draw_specs(n_cases: int, seed: int) -> List[FleetSpec]:
    """The campaign's seeded case list."""
    rng = np.random.default_rng(seed)
    specs = []
    for _ in range(n_cases):
        n_tenants = int(rng.choice([2, 3]))
        # at least one dense tenant; a size under the sidecar threshold
        # lands that tenant on the host sidecar
        n0s = tuple(int(rng.choice([36, 90, 150]))
                    for _ in range(n_tenants - 1)) + (150,)
        dense = [i for i, n in enumerate(n0s)
                 if n >= FLEET_SIDECAR_THRESHOLD]
        specs.append(FleetSpec(
            seed=int(rng.integers(0, 2 ** 31)),
            n0s=n0s,
            ks=tuple(int(rng.choice([4, 8])) for _ in range(n_tenants)),
            n_ops=int(rng.choice([6, 10, 16])),
            replicated=int(rng.choice(dense)),
            ship_mode=str(rng.choice(["sync", "lazy"]))))
    return specs


def run_fleet_campaign(n_cases: int = 16, seed: int = 0,
                       bank_dir: str = CORPUS_DIR,
                       budget_s: Optional[float] = None,
                       minimize: bool = True,
                       log=print, device=None) -> dict:
    """The fleet campaign on ``device`` (default: the GPU);
    manifest['ok'] is the rc-0 bar.

    Runs under the protocol-action recorder (``utils/prototrace.py``):
    the manifest's ``proto_stamp(trace)`` fields prove the replication
    and admission action sequence the cases walked is a word in the
    declared models' language, and a trace violation fails ``ok``."""
    log = log or (lambda s: None)
    from ..analysis.models import proto_stamp
    from ..utils import prototrace
    from .campaign import prepare_device

    dev = prepare_device(device)
    prototrace.enable()
    t0 = time.monotonic()
    specs = draw_specs(n_cases, seed)
    failures: List[FleetFailure] = []
    completed = 0
    truncated_after: Optional[int] = None
    try:
        for i, spec in enumerate(specs):
            if budget_s is not None and time.monotonic() - t0 > budget_s:
                truncated_after = i
                log(f"[{i}/{len(specs)}] budget {budget_s:.0f}s "
                    f"exhausted; remaining fleet cases truncated")
                break
            f = run_fleet_case(spec, bank_dir=bank_dir, minimize=minimize,
                               device=dev)
            completed += 1
            tag = "ok" if f is None else f"FAIL {f.kind}"
            log(f"[{i + 1}/{len(specs)}] {spec.case_id()} {tag}")
            if f is not None:
                failures.append(f)
        trace = prototrace.drain()
    finally:
        prototrace.disable()
    stamp = proto_stamp(trace)
    if stamp.get("proto_trace_violations"):
        log(f"[proto] trace violations: "
            f"{stamp['proto_trace_violations']}")
    return {
        "ok": not failures and bool(stamp["proto_models_ok"]),
        **stamp,
        "flavor": "fleet-stream",
        "requested_cases": n_cases,
        "completed_cases": completed,
        "truncated_after": truncated_after,
        "seed": seed,
        "fault": _parse_fleet_fault(),
        "elapsed_s": round(time.monotonic() - t0, 3),
        "failures": [f.to_json() for f in failures],
        "corpus_size": corpus_size(bank_dir),
    }
