"""Chaos campaign: seeded fault schedules against the elastic pod fleet.

Counterpart of ``cuda_knearests_tpu/fuzz/chaos.py``, on ``device``
(default: the GPU).  The elastic placement (``pod/reshard.py``, DESIGN.md
section 22) promises that no fault it claims to survive changes an
answer: queries during a live migration come from the old owner until the
handover applied, a chip loss rebuilds from the committed replay, a
wedged migration aborts with the cuts never flipped, a delayed handover
just keeps the old owner serving.  This module attacks those promises:

* Seeded op and fault schedules: hotspot inserts that skew the Morton
  ranges, uniform and hot-corner queries, deletes, and injected faults --
  forced rebalance, migration pumps, chip loss, a wedged migration, a
  delayed handover -- through the real front door (a pod tenant and a
  dense companion behind one ``FleetDaemon``).  Every schedule ends with
  a guaranteed skew -> rebalance -> pump-to-handover -> hot-query tail,
  so a corrupted handover cannot hide from the checks.
* After every query op the answering tenant is checked against its own
  independently tracked cloud (the host replay, a fresh legacy
  ``KnnProblem`` on the same device) with the tie-aware comparison
  (``fuzz/compare.py``), and after every op the pod's shard populations
  against the canonical ledger (rows lost or duplicated across a
  handover).
* Failing schedules ddmin-minimize and bank to
  ``tests/corpus_torch/*-chaos.npz``.
* ``KNTPU_FLEET_FAULT=torn-migration|lost-range`` seeds the two migration
  corruptions; each yields a banked failure, diverted away from the real
  corpus like every faulted flavor.
* Four named autoscale schedules (DESIGN.md section 24) ride the same
  replay: a stuck sensor under ticking load, a flapping brownout ladder
  (the bf16 selection kernel on the card), a scale-down racing a live
  migration (the compaction-floor probe runs inline), and a brownout
  spanning a failover with the exact comparison re-armed after recovery.
  Their ops drive the real actuators, and
  ``KNTPU_FLEET_FAULT=scale-drop-tail`` corrupts them as it corrupts the
  policy.
* The campaign's last case is the cross-mesh SIGKILL drill
  (``serve/fleet/elastic.mesh_failover_drill``) on the campaign's device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import CORPUS_DIR, corpus_size
from .compare import check_route_result
from .fleet import _parse_fleet_fault, _safe_bank_dir
from .mutation import ddmin_ops
from ..config import DOMAIN_SIZE

# The pod tenant sits above this threshold, the dense companion below it;
# small shards and a small migration chunk keep several pumps in flight
# per schedule, so mid-migration queries happen.
CHAOS_POD_THRESHOLD = 160
CHAOS_MIGRATION_CHUNK = 8
CHAOS_ABORT_AFTER_PUMPS = 40
_HOT = 0.12          # the hotspot sub-cube: [0, _HOT*domain)^3

# op kinds that exercise the autoscale surface; a schedule holding any of
# them replays with the Autoscaler attached and the dense tenant shipping
# lazily (so the scale-down compaction floor is real)
_AUTOSCALE_OPS = frozenset({"scale-up", "scale-down", "brown-down",
                            "brown-up", "failover", "stick-sensors",
                            "tick"})


@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    """Regenerable identity of one chaos schedule."""

    seed: int
    n0: int                # pod tenant's initial cloud
    dense_n0: int          # companion dense tenant
    k: int
    nshards: int
    n_ops: int

    def case_id(self) -> str:
        return (f"chaos-s{self.seed}-n{self.n0}x{self.dense_n0}"
                f"-k{self.k}-sh{self.nshards}-o{self.n_ops}")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "ChaosSpec":
        return cls(seed=int(d["seed"]), n0=int(d["n0"]),
                   dense_n0=int(d["dense_n0"]), k=int(d["k"]),
                   nshards=int(d["nshards"]), n_ops=int(d["n_ops"]))


@dataclasses.dataclass
class ChaosFailure:
    """One schedule's survived-fault violation (or crash)."""

    case_id: str
    kind: str
    reason: str
    op_index: int
    original_ops: int
    minimized_ops: Optional[int] = None
    banked: Optional[str] = None

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def initial_clouds(spec: ChaosSpec) -> Tuple[np.ndarray, np.ndarray]:
    """(pod cloud, dense cloud), both uniform over the domain."""
    rng = np.random.default_rng(spec.seed + 101)
    pod = (rng.random((spec.n0, 3)) * (DOMAIN_SIZE * 0.98)
           + DOMAIN_SIZE * 0.01).astype(np.float32)
    dense = (rng.random((spec.dense_n0, 3)) * (DOMAIN_SIZE * 0.98)
             + DOMAIN_SIZE * 0.01).astype(np.float32)
    return pod, dense


def _hot_points(rng, m: int) -> np.ndarray:
    """Points inside the low-Morton hotspot corner."""
    return (rng.random((m, 3)) * (DOMAIN_SIZE * (_HOT - 0.005))
            + DOMAIN_SIZE * 0.005).astype(np.float32)


def generate_ops(spec: ChaosSpec) -> List[dict]:
    """The seeded op and fault schedule.  Structure guarantees: the
    stream ends with hotspot inserts -> a forced rebalance -> enough pumps
    to reach the handover -> hot-corner and uniform queries of the pod
    tenant, so a handover corrupted by a seeded migration fault is always
    within reach of the checks."""
    rng = np.random.default_rng(spec.seed + 1)
    live = {"p0": spec.n0, "d0": spec.dense_n0}
    ops: List[dict] = []

    def _query(tenant: str, hot: bool) -> dict:
        m = int(rng.integers(1, 7))
        qs = (_hot_points(rng, m) if hot
              else (rng.random((m, 3)) * (DOMAIN_SIZE * 0.98)
                    + DOMAIN_SIZE * 0.01).astype(np.float32))
        return {"op": "query", "tenant": tenant, "queries": qs}

    for _ in range(spec.n_ops):
        roll = rng.random()
        tenant = "p0" if rng.random() < 0.75 else "d0"
        if roll < 0.30:
            m = int(rng.integers(4, 13))
            pts = (_hot_points(rng, m) if rng.random() < 0.7
                   else (rng.random((m, 3)) * (DOMAIN_SIZE * 0.98)
                         + DOMAIN_SIZE * 0.01).astype(np.float32))
            ops.append({"op": "insert", "tenant": tenant, "points": pts})
            live[tenant] += m
        elif roll < 0.42 and live[tenant] > 16:
            m = int(rng.integers(1, 5))
            ids = np.sort(rng.choice(live[tenant], size=m, replace=False))
            ops.append({"op": "delete", "tenant": tenant,
                        "ids": ids.astype(np.int64)})
            live[tenant] -= m
        elif roll < 0.64:
            ops.append(_query(tenant, hot=rng.random() < 0.5))
        elif roll < 0.72:
            ops.append({"op": "rebalance", "tenant": "p0"})
        elif roll < 0.86:
            ops.append({"op": "pump", "tenant": "p0",
                        "n": int(rng.integers(2, 9))})
        elif roll < 0.92:
            ops.append({"op": "chip-loss", "tenant": "p0",
                        "shard": int(rng.integers(0, spec.nshards))})
        elif roll < 0.96:
            ops.append({"op": "wedge", "tenant": "p0"})
        else:
            ops.append({"op": "delay-handover", "tenant": "p0",
                        "pumps": int(rng.integers(1, 6))})
    # the guaranteed fault-detection tail
    for _ in range(2):
        pts = _hot_points(rng, 12)
        ops.append({"op": "insert", "tenant": "p0", "points": pts})
        live["p0"] += 12
    ops.append({"op": "rebalance", "tenant": "p0"})
    ops.append({"op": "pump", "tenant": "p0", "n": 64})
    ops.append(_query("p0", hot=True))
    ops.append(_query("p0", hot=False))
    ops.append(_query("d0", hot=False))
    return ops


def named_autoscale_schedules(seed: int = 0) \
        -> List[Tuple[str, ChaosSpec, List[dict]]]:
    """The four named autoscale schedules (DESIGN.md section 24), each a
    deterministic op stream through :func:`replay_ops`'s real front door.
    They hold the contracts of every chaos case -- answer correctness,
    shard conservation, the inline compaction-floor probe -- under the
    autoscale interleavings the random generator would rarely compose."""
    rng = np.random.default_rng(seed + 4242)

    def q(tenant: str, hot: bool = False) -> dict:
        m = int(rng.integers(2, 6))
        qs = (_hot_points(rng, m) if hot
              else (rng.random((m, 3)) * (DOMAIN_SIZE * 0.98)
                    + DOMAIN_SIZE * 0.01).astype(np.float32))
        return {"op": "query", "tenant": tenant, "queries": qs}

    def ins(tenant: str, m: int, hot: bool = False) -> dict:
        pts = (_hot_points(rng, m) if hot
               else (rng.random((m, 3)) * (DOMAIN_SIZE * 0.98)
                     + DOMAIN_SIZE * 0.01).astype(np.float32))
        return {"op": "insert", "tenant": tenant, "points": pts}

    def sp(seed_tag: int) -> ChaosSpec:
        return ChaosSpec(seed=seed_tag, n0=200, dense_n0=90, k=6,
                         nshards=2, n_ops=0)

    # 1. stuck sensor under ticking load: the policy goes blind, the
    #    answers must not
    stuck = [{"op": "stick-sensors", "tenant": "p0"},
             {"op": "tick", "tenant": "p0", "n": 2},
             ins("d0", 8), q("d0"),
             {"op": "tick", "tenant": "p0", "n": 3},
             {"op": "scale-up", "tenant": "d0"},
             ins("d0", 6), q("d0"),
             {"op": "tick", "tenant": "p0", "n": 3},
             {"op": "scale-down", "tenant": "d0"},
             q("d0"), q("p0", hot=True)]
    # 2. flapping load: the ladder walked down and up repeatedly, with
    #    the differential compare re-arming at every exact interval
    flap: List[dict] = []
    for _ in range(3):
        flap += [{"op": "brown-down", "tenant": "d0"}, q("d0"),
                 {"op": "tick", "tenant": "p0", "n": 2},
                 {"op": "brown-up", "tenant": "d0"}, q("d0")]
    flap += [q("d0"), q("p0")]
    # 3. scale-down racing a live migration: the pod tenant mid-pump
    #    while the dense tenant's replica pool shrinks over a lazy tail
    race = [ins("p0", 12, hot=True), ins("p0", 12, hot=True),
            {"op": "rebalance", "tenant": "p0"},
            {"op": "scale-up", "tenant": "d0"},
            ins("d0", 6), ins("d0", 6),
            {"op": "pump", "tenant": "p0", "n": 3},
            q("p0", hot=True),
            {"op": "scale-down", "tenant": "d0"},
            {"op": "pump", "tenant": "p0", "n": 64},
            q("p0", hot=True), q("d0")]
    # 4. brownout during failover: degrade, fail over mid-brownout (the
    #    lazy tail re-ships), recover, then the exact compare must hold
    #    again
    brown = [{"op": "scale-up", "tenant": "d0"},
             ins("d0", 8),
             {"op": "brown-down", "tenant": "d0"},
             {"op": "brown-down", "tenant": "d0"},
             q("d0"),
             {"op": "failover", "tenant": "d0"},
             q("d0"),
             {"op": "brown-up", "tenant": "d0"},
             {"op": "brown-up", "tenant": "d0"},
             q("d0"), q("p0")]
    return [("stuck-sensor-ticking-load", sp(90_001), stuck),
            ("flapping-brownout-ladder", sp(90_002), flap),
            ("scale-down-racing-migration", sp(90_003), race),
            ("brownout-during-failover", sp(90_004), brown)]


def replay_ops(spec: ChaosSpec, ops: Sequence[dict], device=None,
               answers: Optional[list] = None
               ) -> Optional[Tuple[str, str, int]]:
    """Run one schedule through a fresh two-tenant fleet on ``device``
    (default: the GPU), checking every query op against the answering
    tenant's independently tracked cloud.  Returns None when clean, else
    (kind, reason, op_index).  A raise on a legal schedule is the
    failure.  ``answers``, when a list, receives ``(op_index, ids, d2)``
    of every checked (exact) query."""
    from ..api import KnnProblem
    from ..config import KnnConfig, ServeFleetConfig
    from ..serve.fleet.autoscale import AutoscaleConfig
    from ..serve.fleet.frontdoor import FleetDaemon
    from ..serve.fleet.tenants import TenantSpec

    try:
        as_ops = any(op["op"] in _AUTOSCALE_OPS for op in ops)
        pod_cloud, dense_cloud = initial_clouds(spec)
        tracked = {"p0": np.array(pod_cloud), "d0": np.array(dense_cloud)}
        fleet = FleetDaemon(
            [(TenantSpec(name="p0", k=spec.k), pod_cloud),
             (TenantSpec(name="d0", k=spec.k,
                         ship_mode="lazy" if as_ops else "sync"),
              dense_cloud)],
            ServeFleetConfig(
                min_bucket=8, max_batch=64, compact_threshold=32,
                warmup=False, sidecar_threshold=48,
                pod_threshold=CHAOS_POD_THRESHOLD,
                pod_shards=spec.nshards, pod_skew_threshold=1.5,
                drr_quantum=16),
            autoscale=AutoscaleConfig() if as_ops else None,
            device=device)
        el = fleet.tenants["p0"].elastic
        if el is not None:
            el.migration_chunk = CHAOS_MIGRATION_CHUNK
            el.abort_after_pumps = CHAOS_ABORT_AFTER_PUMPS
        now = 0.0
        for i, op in enumerate(ops):
            now += 1e-3
            name = op["tenant"]
            kind = op["op"]
            if kind == "insert":
                resp = fleet.submit(i, name, "insert", op["points"],
                                    now=now)
                if resp and resp[-1].ok:
                    tracked[name] = np.concatenate(
                        [tracked[name],
                         np.asarray(op["points"], np.float32)])  # kntpu-ok: host-sync-loop -- host-resident op payload (pure numpy), no device array rides this loop
            elif kind == "delete":
                ids = np.asarray(op["ids"]).reshape(-1)  # kntpu-ok: host-sync-loop -- host-resident op payload (pure numpy), no device array rides this loop
                ids = ids[ids < tracked[name].shape[0]]  # re-legalize
                if ids.size == 0:
                    continue
                resp = fleet.submit(i, name, "delete", ids, now=now)
                if resp and resp[-1].ok:
                    tracked[name] = np.delete(tracked[name], ids, axis=0)
            elif kind == "rebalance":
                if el is not None:
                    el.force_rebalance()
            elif kind == "pump":
                if el is not None:
                    for _ in range(max(1, int(op.get("n") or 1))):
                        if el.migration is None:
                            break
                        el.pump()
            elif kind == "chip-loss":
                if el is not None:
                    el.lose_shard(int(op.get("shard") or 0),
                                  tracked["p0"])
            elif kind == "wedge":
                if el is not None:
                    el.wedge_migration()
            elif kind == "delay-handover":
                if el is not None:
                    el.delay_handover(int(op.get("pumps") or 1))
            elif kind == "scale-up":
                t = fleet.tenants[name]
                if t.daemon is not None:
                    t.add_replica()
            elif kind == "scale-down":
                t = fleet.tenants[name]
                res = t.remove_replica(
                    unsafe_compact=fleet._fault == "scale-drop-tail")
                if res is not None and t.log is not None:
                    # the inline compaction-floor probe: the committed
                    # tail a surviving consumer still needs must stay
                    # replayable (a raise here is the banked failure)
                    floor = min((r.applied_seq
                                 for r in t.replica_pool), default=0)
                    list(t.log.since(floor))
            elif kind == "brown-down":
                t = fleet.tenants[name]
                if t.daemon is not None:
                    t.brown_down()
            elif kind == "brown-up":
                t = fleet.tenants[name]
                if t.daemon is not None:
                    t.brown_up()
            elif kind == "failover":
                t = fleet.tenants[name]
                if t.daemon is not None and t.replica_pool:
                    t.failover()
            elif kind == "stick-sensors":
                # the stuck-sensor fault's in-schedule twin: the next
                # sensor sample freezes for good (answers must stay
                # correct; the policy just goes blind)
                fleet._fault = "stuck-sensor"
            elif kind == "tick":
                sc = fleet.autoscaler
                per = sc.config.period_s if sc is not None else 0.02
                for _ in range(max(1, int(op.get("n") or 1))):
                    now += per * 1.01
                    fleet.poll(now)
            else:
                queries = np.asarray(op["queries"], np.float32)  # kntpu-ok: host-sync-loop -- host-resident op payload (pure numpy), no device array rides this loop
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
                if mine[0].degraded is None:
                    # a browned-out answer is certified-approximate by
                    # declaration (the tier rides the wire), so the
                    # distance-multiset contract is suspended for it and
                    # re-arms the moment the tenant is exact again
                    got_i = np.asarray(mine[0].ids)  # kntpu-ok: host-sync-loop -- Response rows are host numpy (the daemon fetched them through dispatch already)
                    got_d = np.asarray(mine[0].d2)  # kntpu-ok: host-sync-loop -- Response rows are host numpy (the daemon fetched them through dispatch already)
                    if answers is not None:
                        answers.append((i, got_i, got_d))
                    pts = tracked[name]
                    ref = KnnProblem.prepare(
                        pts, KnnConfig(k=spec.k, adaptive=False),
                        validate=False, device=fleet.device)
                    _ref_i, ref_d = ref.query(queries, spec.k)
                    bad = check_route_result(pts, queries, got_i, got_d,
                                             np.asarray(ref_d), spec.k)  # kntpu-ok: host-sync-loop -- one oracle readback per QUERY op is the differential harness's job
                    if bad is not None:
                        return ("mismatch",
                                f"op {i}: tenant {name} diverged from "
                                f"its rebuild oracle under the fault "
                                f"schedule: {bad.render()}", i)
            # conservation: every canonical id lives in exactly one
            # shard, and the ledger tracks the acked mutations.  A torn
            # handover (the receiver missing a record it acked) breaks
            # this even when no probe lands near the lost row.
            if el is not None:
                held = sum(s.n_points for s in el.shards)
                if (held != el.n_points
                        or el.n_points != tracked["p0"].shape[0]):
                    return ("mismatch",
                            f"op {i}: pod shard population {held} "
                            f"diverged from canonical ledger "
                            f"{el.n_points} / tracked cloud "
                            f"{tracked['p0'].shape[0]} (rows lost or "
                            f"duplicated across a handover)", i)
    except Exception as e:  # noqa: BLE001 -- containment IS the job: any raise on a legal schedule is the banked failure
        from ..utils.memory import classify_fault_text

        kind = classify_fault_text(f"{type(e).__name__}: {e}") or "crash"
        return (kind, f"chaos schedule raised {type(e).__name__}: {e}",
                len(ops))
    return None


# -- banking ------------------------------------------------------------------

_ARRAY_KEYS = {"insert": "points", "delete": "ids", "query": "queries"}


def _ops_to_json(ops: Sequence[dict]) -> str:
    out = []
    for op in ops:
        item = {"op": op["op"], "tenant": op["tenant"]}
        key = _ARRAY_KEYS.get(op["op"])
        if key is not None:
            item[key] = np.asarray(op[key]).tolist()  # kntpu-ok: host-sync-loop -- host-resident op payload (pure numpy), no device array rides this loop
        for scalar in ("n", "shard", "pumps"):
            if scalar in op:
                item[scalar] = int(op[scalar])
        out.append(item)
    return json.dumps(out)


def ops_from_json(text: str) -> List[dict]:
    ops = []
    for op in json.loads(text):
        item = dict(op)
        key = _ARRAY_KEYS.get(op["op"])
        if key == "points" or key == "queries":
            item[key] = np.asarray(op[key], np.float32).reshape(-1, 3)  # kntpu-ok: host-sync-loop -- JSON-decoded host op payload (pure numpy), no device array rides this loop
        elif key == "ids":
            item[key] = np.asarray(op[key], np.int64)  # kntpu-ok: host-sync-loop -- JSON-decoded host op payload (pure numpy), no device array rides this loop
        ops.append(item)
    return ops


def bank_chaos_case(bank_dir: str, spec: ChaosSpec, kind: str,
                    reason: str, ops: Sequence[dict]) -> str:
    os.makedirs(bank_dir, exist_ok=True)
    path = os.path.join(bank_dir, f"{spec.case_id()}-chaos.npz")
    np.savez_compressed(
        path,
        schema=np.bytes_(b"chaos-stream-v1"),
        spec_json=np.bytes_(json.dumps(spec.to_json()).encode()),
        ops_json=np.bytes_(_ops_to_json(ops).encode()),
        kind=np.bytes_(kind.encode()),
        reason=np.bytes_(reason[:2000].encode()))
    return path


def load_chaos_case(path: str) -> dict:
    with np.load(path) as z:
        return {
            "spec": ChaosSpec.from_json(
                json.loads(bytes(z["spec_json"]).decode())),
            "ops": ops_from_json(bytes(z["ops_json"]).decode()),
            "kind": bytes(z["kind"]).decode(),
            "reason": bytes(z["reason"]).decode(),
        }


def run_chaos_case(spec: ChaosSpec, bank_dir: Optional[str] = None,
                   minimize: bool = True, max_probes: int = 24,
                   ops: Optional[List[dict]] = None, device=None
                   ) -> Optional[ChaosFailure]:
    """One schedule end to end on ``device``: generate (unless ``ops`` is
    handed in, as the named autoscale schedules are), replay, minimize,
    bank."""
    ops = generate_ops(spec) if ops is None else list(ops)
    got = replay_ops(spec, ops, device=device)
    if got is None:
        return None
    kind, reason, op_index = got
    failure = ChaosFailure(case_id=spec.case_id(), kind=kind,
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
        failure.banked = bank_chaos_case(bank_dir, spec, kind, reason,
                                         repro)
    return failure


def draw_specs(n_cases: int, seed: int) -> List[ChaosSpec]:
    """The campaign's seeded schedule list (the reference's case sizes:
    hostile shapes, not cut)."""
    rng = np.random.default_rng(seed)
    return [ChaosSpec(
        seed=int(rng.integers(0, 2 ** 31)),
        n0=int(rng.choice([200, 280])),
        dense_n0=90,
        k=int(rng.choice([4, 8])),
        nshards=int(rng.choice([2, 3])),
        n_ops=int(rng.choice([8, 14, 20]))) for _ in range(n_cases)]


# Each seeded ``KNTPU_FLEET_FAULT`` and the case that must catch it: the
# chaos faults on one small pod schedule, ``scale-drop-tail`` on the named
# scale-down that races a migration, the replication faults on one fleet
# stream.
_FAULT_CHAOS_SPEC = ChaosSpec(seed=5, n0=200, dense_n0=90, k=4, nshards=2,
                              n_ops=6)
_FAULT_FLEET_KW = {"cross-tenant": dict(replicated=-1, ship_mode="sync"),
                   "drop-delta": dict(replicated=1, ship_mode="sync"),
                   "stale-replica": dict(replicated=1, ship_mode="lazy")}
SEEDED_FAULT_CASES = ("torn-migration", "lost-range", "scale-drop-tail",
                      *_FAULT_FLEET_KW)


def run_seeded_fault_case(fault: str, bank_dir: Optional[str] = None,
                          device=None):
    """Run ``fault``'s case of :data:`SEEDED_FAULT_CASES` on ``device``
    with ``KNTPU_FLEET_FAULT`` set to it (restored after), unminimized.
    Returns (the failure or None, the banked file's suffix); a faulted
    run banks outside the committed corpus whatever ``bank_dir`` says."""
    from .fleet import FleetSpec, run_fleet_case

    prev = os.environ.get("KNTPU_FLEET_FAULT")
    os.environ["KNTPU_FLEET_FAULT"] = fault
    try:
        if fault in _FAULT_FLEET_KW:
            spec = FleetSpec(seed=5, n0s=(90, 150), ks=(4, 4), n_ops=6,
                             **_FAULT_FLEET_KW[fault])
            return (run_fleet_case(spec, bank_dir=bank_dir, minimize=False,
                                   device=device), "-fleet.npz")
        if fault == "scale-drop-tail":
            named = {label: (sp, ops) for label, sp, ops in
                     named_autoscale_schedules(0)}
            sp, ops = named["scale-down-racing-migration"]
        elif fault in ("torn-migration", "lost-range"):
            sp, ops = _FAULT_CHAOS_SPEC, None
        else:
            raise ValueError(f"no seeded case for fault {fault!r}")
        return (run_chaos_case(sp, bank_dir=bank_dir, minimize=False,
                               ops=ops, device=device), "-chaos.npz")
    finally:
        if prev is None:
            del os.environ["KNTPU_FLEET_FAULT"]
        else:
            os.environ["KNTPU_FLEET_FAULT"] = prev


def run_chaos_campaign(n_cases: int = 16, seed: int = 0,
                       bank_dir: str = CORPUS_DIR,
                       budget_s: Optional[float] = None,
                       minimize: bool = True,
                       drill: bool = True,
                       log=print, device=None) -> dict:
    """The chaos campaign on ``device`` (default: the GPU);
    manifest['ok'] is the rc-0 bar.

    The in-process fault schedules first, then the four named autoscale
    schedules, then (unless a seeded fleet fault is active, whose
    corruption would taint the child meshes too) one cross-mesh SIGKILL
    drill on the same device.

    The whole campaign runs under the protocol-action recorder
    (``utils/prototrace.py``): every ``# proto:``-annotated site of the
    fleet and the pod appends its (model, action) event, and the manifest
    carries ``proto_stamp(trace)`` -- the drained trace must be a word in
    the declared models' language, and a violation fails ``ok`` as a
    banked case would."""
    log = log or (lambda s: None)
    from ..analysis.models import proto_stamp
    from ..utils import prototrace
    from .campaign import prepare_device

    dev = prepare_device(device)
    fault = _parse_fleet_fault()
    prototrace.enable()
    t0 = time.monotonic()
    specs = draw_specs(n_cases, seed)
    failures: List[ChaosFailure] = []
    completed = 0
    truncated_after: Optional[int] = None
    mesh = None
    try:
        for i, spec in enumerate(specs):
            if budget_s is not None and time.monotonic() - t0 > budget_s:
                truncated_after = i
                log(f"[{i}/{len(specs)}] budget {budget_s:.0f}s "
                    f"exhausted; remaining chaos cases truncated")
                break
            f = run_chaos_case(spec, bank_dir=bank_dir, minimize=minimize,
                               device=dev)
            completed += 1
            tag = "ok" if f is None else f"FAIL {f.kind}"
            log(f"[{i + 1}/{len(specs)}] {spec.case_id()} {tag}")
            if f is not None:
                failures.append(f)
        # the four named autoscale schedules ride every campaign (cheap,
        # deterministic, budget-respecting)
        if truncated_after is None:
            for label, nspec, nops in named_autoscale_schedules(seed):
                if (budget_s is not None
                        and time.monotonic() - t0 > budget_s):
                    truncated_after = completed
                    log(f"[named] budget {budget_s:.0f}s exhausted "
                        f"before {label}")
                    break
                f = run_chaos_case(nspec, bank_dir=bank_dir,
                                   minimize=minimize, ops=nops, device=dev)
                completed += 1
                tag = "ok" if f is None else f"FAIL {f.kind}"
                log(f"[named] {label} {tag}")
                if f is not None:
                    failures.append(f)
        if drill and fault is None and truncated_after is None:
            from ..serve.fleet.elastic import mesh_failover_drill

            log("[drill] cross-mesh mid-migration SIGKILL ...")
            mesh = mesh_failover_drill(n=900, k=6, ops=26, seed=seed,
                                       log=log, device=dev)
            log(f"[drill] mesh_failover_ok={mesh['mesh_failover_ok']}")
        elif drill and fault is not None:
            log(f"[drill] skipped: KNTPU_FLEET_FAULT={fault} would taint "
                f"the child meshes")
        trace = prototrace.drain()
    finally:
        prototrace.disable()
    stamp = proto_stamp(trace)
    if stamp.get("proto_trace_violations"):
        log(f"[proto] trace violations: "
            f"{stamp['proto_trace_violations']}")
    return {
        "ok": not failures and (mesh is None
                                or bool(mesh["mesh_failover_ok"]))
        and bool(stamp["proto_models_ok"]),
        **stamp,
        "flavor": "chaos-stream",
        "requested_cases": n_cases,
        "completed_cases": completed,
        "truncated_after": truncated_after,
        "seed": seed,
        "fault": fault,
        "elapsed_s": round(time.monotonic() - t0, 3),
        "failures": [f.to_json() for f in failures],
        "mesh_failover": mesh,
        "corpus_size": corpus_size(bank_dir),
    }
