"""Mutation-stream fuzzing: random insert/delete/query interleavings
against a rebuild-from-scratch oracle.

Counterpart of ``cuda_knearests_tpu/fuzz/mutation.py``, the same streams,
on ``device`` (default: the GPU).  The serving delta overlay
(``serve/delta.py``) promises that a mutated cloud answers queries as a
full re-prepare would.  A case is regenerable from its
:class:`MutationSpec` (seed, n0, n_ops, k); its stream interleaves

  * inserts -- fresh uniform points, exact duplicates of initial points
    (the tie hazard) and tight clusters (the dirty-cell hazard);
  * deletes -- random live canonical ids (tombstone resolution);
  * queries -- uniform coordinates.

Replay runs the stream through a :class:`DeltaOverlay` with a small
compaction threshold, so one case covers overlay state, compaction and
the state after it; after every query op the overlay's answer is held
tie-aware (:mod:`compare`) to ``problem.with_points(mutated).query``.
Failing streams are delta-debugged over ops (replay drops delete ids
beyond the current cloud, so every op subset stays legal) and banked as
``*-mutation.npz``.  Seeded fault (``KNTPU_MUT_FAULT=drop-neighbor|
perturb-d2``) corrupts the overlay's answer before the comparison.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import List, Optional, Sequence

import numpy as np

from . import CORPUS_DIR, corpus_size, safe_bank_dir
from .compare import check_route_result
from ..config import DOMAIN_SIZE

# compaction threshold used by every replay: small enough that a default
# stream compacts mid-case (the post-compaction state is fuzzed too)
REPLAY_COMPACT_THRESHOLD = 24


@dataclasses.dataclass(frozen=True)
class MutationSpec:
    """Regenerable identity of one mutation-stream case."""

    seed: int
    n0: int
    n_ops: int
    k: int

    def case_id(self) -> str:
        return f"mut-s{self.seed}-n{self.n0}-o{self.n_ops}-k{self.k}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "MutationSpec":
        return cls(seed=int(d["seed"]), n0=int(d["n0"]),
                   n_ops=int(d["n_ops"]), k=int(d["k"]))


@dataclasses.dataclass
class MutationFailure:
    """One stream's disagreement with the rebuild oracle."""

    case_id: str
    kind: str           # 'mismatch' | exception taxonomy kind
    reason: str
    op_index: int       # which op surfaced it (pre-minimization)
    original_ops: int
    minimized_ops: Optional[int] = None
    banked: Optional[str] = None

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def initial_points(spec: MutationSpec) -> np.ndarray:
    rng = np.random.default_rng(spec.seed)
    return (rng.random((spec.n0, 3)) * (DOMAIN_SIZE * 0.98)
            + DOMAIN_SIZE * 0.01).astype(np.float32)


def generate_ops(spec: MutationSpec) -> List[dict]:
    """The seeded op stream.  Sizes are deliberately small (<= 8): the
    hazards are structural (ties, tombstones, compaction boundaries), not
    scale."""
    rng = np.random.default_rng(spec.seed + 1)
    pts0 = initial_points(spec)  # the tie-hazard flavor duplicates these
    live = spec.n0  # tracked cloud size so every delete is legal
    ops: List[dict] = []
    for _ in range(spec.n_ops):
        roll = rng.random()
        m = int(rng.integers(1, 9))
        if roll < 0.3:
            flavor = rng.random()
            if flavor < 0.5 or live == 0 or spec.n0 == 0:
                pts = (rng.random((m, 3)) * (DOMAIN_SIZE * 0.98)
                       + DOMAIN_SIZE * 0.01).astype(np.float32)
            elif flavor < 0.8:
                # m exact copies of one INITIAL-cloud point: a delta
                # candidate at bit-identical coordinates to a (usually
                # live) base point -- the exactly-tied-f32-distance hazard
                # the base-vs-delta merge tie-break must survive
                src = pts0[int(rng.integers(0, spec.n0))]
                pts = np.tile(src, (m, 1)).astype(np.float32)
            else:
                # tight cluster inside one cell: dirty-cell hazard
                c = rng.random(3) * (DOMAIN_SIZE * 0.9) + DOMAIN_SIZE * 0.05
                pts = (c + rng.normal(0, DOMAIN_SIZE * 1e-4, (m, 3))
                       ).clip(0, np.nextafter(DOMAIN_SIZE, 0)
                              ).astype(np.float32)
            ops.append({"op": "insert", "points": pts})
            live += m
        elif roll < 0.5 and live > m:
            ids = np.sort(rng.choice(live, size=m, replace=False))
            ops.append({"op": "delete", "ids": ids.astype(np.int64)})
            live -= m
        else:
            q = (rng.random((m, 3)) * (DOMAIN_SIZE * 0.98)
                 + DOMAIN_SIZE * 0.01).astype(np.float32)
            ops.append({"op": "query", "queries": q})
    # every stream ends with a query so a pure-mutation prefix still checks
    ops.append({"op": "query",
                "queries": (rng.random((4, 3)) * DOMAIN_SIZE * 0.98
                            + DOMAIN_SIZE * 0.01).astype(np.float32)})
    return ops


def _parse_mut_fault() -> Optional[str]:
    fault = os.environ.get("KNTPU_MUT_FAULT", "")
    if not fault:
        return None
    if fault not in ("drop-neighbor", "perturb-d2"):
        raise ValueError(f"unknown KNTPU_MUT_FAULT {fault!r}")
    return fault


def _corrupt(ids: np.ndarray, d2: np.ndarray, fault: str):
    ids, d2 = np.array(ids), np.array(d2)
    if fault == "drop-neighbor" and ids.shape[1]:
        ids[:, -1] = -1
        d2[:, -1] = np.inf
    elif fault == "perturb-d2":
        d2 = np.where(np.isfinite(d2), d2 * 1.01 + 1.0, d2)
    return ids, d2


def replay_ops(spec: MutationSpec, ops: Sequence[dict],
               compact_threshold: int = REPLAY_COMPACT_THRESHOLD,
               device=None):
    """Run one op stream through a fresh overlay on ``device``, checking
    every query op against the rebuild oracle.  Returns None when clean,
    else (kind, reason, op_index).  Exceptions are contained: a raise is
    the failure (a legal stream must never crash the overlay)."""
    from .. import KnnConfig, KnnProblem
    from ..serve.delta import DeltaOverlay

    fault = _parse_mut_fault()
    try:
        problem = KnnProblem.prepare(
            initial_points(spec), KnnConfig(k=spec.k, adaptive=False),
            device=device)
        overlay = DeltaOverlay(problem, compact_threshold=compact_threshold)
        for i, op in enumerate(ops):
            if op["op"] == "insert":
                overlay.insert(op["points"])
            elif op["op"] == "delete":
                # re-legalization (minimization can orphan ids): drop ids
                # beyond the current cloud, deterministically
                ids = np.asarray(op["ids"])  # kntpu-ok: host-sync-loop -- host-resident op payload (pure numpy), no device array rides this loop
                overlay.delete(ids[ids < overlay.n_points])
            else:
                queries = np.asarray(op["queries"], np.float32)  # kntpu-ok: host-sync-loop -- host-resident op payload (pure numpy), no device array rides this loop
                got_i, got_d = overlay.query(queries, spec.k)
                if fault is not None:
                    got_i, got_d = _corrupt(got_i, got_d, fault)
                mutated = overlay.mutated_points()
                ref = problem.with_points(mutated)
                _ref_i, ref_d = ref.query(queries, spec.k)
                bad = check_route_result(mutated, queries, got_i, got_d,
                                         np.asarray(ref_d), spec.k)  # kntpu-ok: host-sync-loop -- host-resident op payload (pure numpy), no device array rides this loop
                if bad is not None:
                    return ("mismatch", f"op {i}: {bad.render()}", i)
    except Exception as e:  # noqa: BLE001 -- containment IS the job: any raise on a legal stream is the banked failure
        from ..utils.memory import classify_fault_text

        kind = classify_fault_text(f"{type(e).__name__}: {e}") or "crash"
        return (kind, f"op stream raised {type(e).__name__}: {e}",
                len(ops))
    return None


def ddmin_ops(ops: List[dict], still_fails, max_probes: int = 32
              ) -> List[dict]:
    """Delta-debug the op list: repeatedly drop chunks while the failure
    (same kind) persists.  Bounded by ``max_probes`` replays."""
    probes = 0
    chunk = max(1, len(ops) // 2)
    while chunk >= 1 and probes < max_probes:
        shrunk = False
        i = 0
        while i < len(ops) and probes < max_probes:
            cand = ops[:i] + ops[i + chunk:]
            probes += 1
            if cand and still_fails(cand):
                ops = cand
                shrunk = True
            else:
                i += chunk
        if not shrunk:
            chunk //= 2
    return ops


def _ops_to_json(ops: Sequence[dict]) -> str:
    out = []
    for op in ops:
        if op["op"] == "insert":
            out.append({"op": "insert",
                        "points": np.asarray(op["points"],  # kntpu-ok: host-sync-loop -- host-resident op payload (pure numpy), no device array rides this loop
                                             np.float32).tolist()})
        elif op["op"] == "delete":
            out.append({"op": "delete",
                        "ids": np.asarray(op["ids"]).tolist()})  # kntpu-ok: host-sync-loop -- host-resident op payload (pure numpy), no device array rides this loop
        else:
            out.append({"op": "query",
                        "queries": np.asarray(op["queries"],  # kntpu-ok: host-sync-loop -- host-resident op payload (pure numpy), no device array rides this loop
                                              np.float32).tolist()})
    return json.dumps(out)


def ops_from_json(text: str) -> List[dict]:
    ops = []
    for op in json.loads(text):
        if op["op"] == "insert":
            ops.append({"op": "insert",
                        "points": np.asarray(op["points"], np.float32)})  # kntpu-ok: host-sync-loop -- host-resident op payload (pure numpy), no device array rides this loop
        elif op["op"] == "delete":
            ops.append({"op": "delete",
                        "ids": np.asarray(op["ids"], np.int64)})  # kntpu-ok: host-sync-loop -- host-resident op payload (pure numpy), no device array rides this loop
        else:
            ops.append({"op": "query",
                        "queries": np.asarray(op["queries"], np.float32)})  # kntpu-ok: host-sync-loop -- host-resident op payload (pure numpy), no device array rides this loop
    return ops


def bank_mutation_case(bank_dir: str, spec: MutationSpec, kind: str,
                       reason: str, ops: Sequence[dict]) -> str:
    """Bank one failing stream (suffix ``-mutation.npz`` keeps the schema
    distinct from the point-case corpus; each flavor replays
    through its own loader)."""
    os.makedirs(bank_dir, exist_ok=True)
    path = os.path.join(bank_dir, f"{spec.case_id()}-mutation.npz")
    np.savez_compressed(
        path,
        schema=np.bytes_(b"mutation-stream-v1"),
        spec_json=np.bytes_(json.dumps(spec.to_json()).encode()),
        ops_json=np.bytes_(_ops_to_json(ops).encode()),
        kind=np.bytes_(kind.encode()),
        reason=np.bytes_(reason[:2000].encode()))
    return path


def load_mutation_case(path: str) -> dict:
    with np.load(path) as z:
        return {
            "spec": MutationSpec.from_json(
                json.loads(bytes(z["spec_json"]).decode())),
            "ops": ops_from_json(bytes(z["ops_json"]).decode()),
            "kind": bytes(z["kind"]).decode(),
            "reason": bytes(z["reason"]).decode(),
        }


def _safe_bank_dir(bank_dir: Optional[str]) -> Optional[str]:
    """A ``KNTPU_MUT_FAULT`` run never banks into a real corpus
    (``fuzz.safe_bank_dir``)."""
    return safe_bank_dir(bank_dir, _parse_mut_fault() is not None,
                         "kntpu-mut-faulted-")


def run_mutation_case(spec: MutationSpec, bank_dir: Optional[str] = None,
                      minimize: bool = True, max_probes: int = 32,
                      device=None) -> Optional[MutationFailure]:
    """One case end to end: generate, replay, minimize, bank."""
    ops = generate_ops(spec)
    got = replay_ops(spec, ops, device=device)
    if got is None:
        return None
    kind, reason, op_index = got
    failure = MutationFailure(case_id=spec.case_id(), kind=kind,
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
        failure.banked = bank_mutation_case(bank_dir, spec, kind, reason,
                                            repro)
    return failure


def run_mutation_campaign(n_cases: int = 16, seed: int = 0,
                          bank_dir: str = CORPUS_DIR,
                          budget_s: Optional[float] = None,
                          minimize: bool = True,
                          log=print, device=None) -> dict:
    """The mutation-stream campaign on ``device``; manifest['ok'] is the
    rc-0 bar."""
    from .campaign import prepare_device

    log = log or (lambda s: None)
    t0 = time.monotonic()
    dev = prepare_device(device)
    rng = np.random.default_rng(seed)
    specs = [MutationSpec(seed=int(rng.integers(0, 2 ** 31)),
                          n0=int(rng.choice([40, 120, 300])),
                          n_ops=int(rng.choice([8, 16, 32])),
                          k=int(rng.choice([1, 4, 10])))
             for _ in range(n_cases)]
    failures: List[MutationFailure] = []
    completed = 0
    truncated_after: Optional[int] = None
    for i, spec in enumerate(specs):
        if budget_s is not None and time.monotonic() - t0 > budget_s:
            truncated_after = i
            log(f"[{i}/{len(specs)}] budget {budget_s:.0f}s exhausted; "
                f"remaining mutation cases truncated")
            break
        f = run_mutation_case(spec, bank_dir=bank_dir, minimize=minimize,
                              device=dev)
        completed += 1
        tag = "ok" if f is None else f"FAIL {f.kind}"
        log(f"[{i + 1}/{len(specs)}] {spec.case_id()} {tag}")
        if f is not None:
            failures.append(f)
    return {
        "ok": not failures,
        "flavor": "mutation-stream",
        "requested_cases": n_cases,
        "completed_cases": completed,
        "truncated_after": truncated_after,
        "seed": seed,
        "elapsed_s": round(time.monotonic() - t0, 3),
        "failures": [f.to_json() for f in failures],
        "corpus_size": corpus_size(bank_dir),
    }
