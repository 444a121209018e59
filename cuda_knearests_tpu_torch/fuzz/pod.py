"""Pod fuzzing: the cell-partitioned route against the oracle and the
single-chip adaptive route.

Counterpart of ``cuda_knearests_tpu/fuzz/pod.py``, the same cases.  The
pod (``pod/``) runs ``ndev`` chips placed on the one ``device`` (default:
the GPU; ``PodKnnProblem.prepare(mesh=[device] * ndev)``), as the
reference runs them on an emulated mesh: every range boundary and the
ring exchange are exercised on one card.  The zoo is re-weighted toward
the pod's hazards, power-law clusters and grid-plane-aligned clouds:
population-balanced Morton splits put range boundaries inside the dense
regions, so near-neighbour pairs straddle chips.

Each case runs the partitioned solve and is checked twice with the
tie-aware comparison (:mod:`compare`): against the exact kd-tree oracle,
and against the single-chip adaptive route's distances (both exact, so
their distance multisets agree row for row).  Failures ddmin-minimize
over point rows (k and ndev fixed) and bank as ``*-pod.npz``.

Seeded faults (``KNTPU_POD_FAULT=drop-halo|stale-directory``) corrupt the
route's output after the solve using the problem's own cell directory:
``drop-halo`` -- one row loses its last cross-chip neighbour;
``stale-directory`` -- one row loses every cross-chip neighbour.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import List, Optional, Tuple

import numpy as np

from . import CORPUS_DIR, corpus_size, safe_bank_dir
from .compare import check_route_result
from .generators import TINY_NS, CaseSpec, generate_case, hazard_of, \
    zoo_names
from .minimize import ddmin_points
from .routes import oracle_reference
from ..utils.memory import InputContractError, classify_fault_text

POD_FAULT_KINDS = ("drop-halo", "stale-directory")

_FAULT_ENV = "KNTPU_POD_FAULT"

#: The boundary-hazard generators the draw over-weights (see module doc).
_BOUNDARY_GENERATORS = ("power-law-clusters", "grid-plane-aligned")


@dataclasses.dataclass(frozen=True)
class PodCaseSpec:
    """Regenerable identity of one pod fuzz case."""

    generator: str
    seed: int
    n: int
    k: int
    ndev: int

    def case_id(self) -> str:
        return (f"pod-{self.generator}-s{self.seed}-n{self.n}"
                f"-k{self.k}-d{self.ndev}")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "PodCaseSpec":
        return cls(generator=str(d["generator"]), seed=int(d["seed"]),
                   n=int(d["n"]), k=int(d["k"]), ndev=int(d["ndev"]))


@dataclasses.dataclass
class PodFailure:
    """One case's disagreement with the oracle or the single-chip route."""

    case_id: str
    generator: str
    hazard: str
    kind: str
    reason: str
    ndev: int
    original_n: int
    minimized_n: Optional[int] = None
    banked: Optional[str] = None

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def parse_pod_fault(spec: Optional[str] = None) -> Optional[str]:
    spec = os.environ.get(_FAULT_ENV, "") if spec is None else spec
    spec = (spec or "").strip()
    if not spec:
        return None
    if spec not in POD_FAULT_KINDS:
        raise ValueError(f"unknown {_FAULT_ENV} {spec!r}: expected one of "
                         f"{POD_FAULT_KINDS}")
    return spec


def _apply_fault(ids: np.ndarray, d2: np.ndarray,
                 chip_of: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Corrupt (ids, d2) per the env-seeded fault (module docstring).  A
    no-op when no row has a cross-chip neighbor (single-chip cases; the
    self-test uses a uniform multi-chip case that guarantees one)."""
    fault = parse_pod_fault()
    if fault is None or ids.size == 0:
        return ids, d2
    valid = ids >= 0
    own = chip_of[np.arange(ids.shape[0])][:, None]
    cross = valid & (chip_of[np.clip(ids, 0, None)] != own)
    rows = np.nonzero(cross.any(axis=1))[0]
    if rows.size == 0:
        return ids, d2
    r = int(rows[0])
    ids = np.array(ids, copy=True)
    d2 = np.array(d2, copy=True)
    if fault == "drop-halo":
        c = int(np.nonzero(cross[r])[0][-1])
        keep = np.ones(ids.shape[1], bool)
        keep[c] = False
    else:  # stale-directory: every remote candidate invisible
        keep = ~cross[r]
    k = ids.shape[1]
    new_i = np.full((k,), -1, ids.dtype)
    new_d = np.full((k,), np.inf, d2.dtype)
    kept = int(keep.sum())
    new_i[:kept] = ids[r][keep]
    new_d[:kept] = d2[r][keep]
    ids[r], d2[r] = new_i, new_d
    return ids, d2


def run_pod_route(points: np.ndarray, k: int, ndev: int, device=None):
    """((n, k) ids in original order, (n, k) d2, chip_of (n,)) through the
    partitioned route over ``ndev`` chips on ``device``."""
    from ..config import KnnConfig
    from ..pod.solve import PodKnnProblem
    from ..utils.platform import resolve_device

    dev = resolve_device(device)
    pp = PodKnnProblem.prepare(points, config=KnnConfig(k=k),
                               mesh=[dev] * max(1, ndev))
    ids, d2, _cert = pp.solve()
    chip_of = (pp._chip_of_point if pp._chip_of_point is not None
               else np.zeros((points.shape[0],), np.int32))
    return ids, d2, chip_of


def _single_chip_d2(points: np.ndarray, k: int, device=None) -> np.ndarray:
    from .routes import run_route

    got = run_route("adaptive", points, k, device=device)
    if got is None:
        raise RuntimeError("the single-chip route produced no result")
    return got[1]


def _pod_failure(points: np.ndarray, k: int, ndev: int,
                 quick: bool = False, device=None
                 ) -> Optional[Tuple[str, str]]:
    """(kind, reason) when the pod route disagrees with the oracle or the
    single-chip route on ``points``, None when exact.  Legal input must
    never raise; any raise IS the failure.  ``quick`` skips the
    single-chip leg (corpus replay uses it: the oracle comparison already
    decides exactness, and replay only has to prove the banked input stays
    fixed)."""
    try:
        ids, d2, chip_of = run_pod_route(points, k, ndev, device=device)
    except InputContractError as e:
        return ("invalid-input",
                f"legal input refused: {type(e).__name__}: {e}")
    except Exception as e:  # noqa: BLE001 -- containment IS the job: every raise on legal input is banked as a typed campaign failure
        kind = classify_fault_text(f"{type(e).__name__}: {e}") or "crash"
        return (kind, f"pod route raised {type(e).__name__}: {e}")
    ids, d2 = _apply_fault(ids, d2, chip_of)
    _ref_ids, ref_d2 = oracle_reference(points, k, exclude_self=True)
    mm = check_route_result(points, points, ids, d2, ref_d2, k)
    if mm is not None:
        return ("mismatch", f"vs oracle: {mm.render()}")
    if quick:
        return None
    single_d2 = _single_chip_d2(points, k, device=device)
    mm = check_route_result(points, points, ids, d2, single_d2, k)
    if mm is not None:
        return ("partition-variance", f"vs single-chip: {mm.render()}")
    return None


def bank_pod_case(bank_dir: str, spec: PodCaseSpec, kind: str, reason: str,
                  points: np.ndarray) -> str:
    os.makedirs(bank_dir, exist_ok=True)
    path = os.path.join(bank_dir, f"{spec.case_id()}-pod.npz")
    np.savez_compressed(
        path,
        schema=np.bytes_(b"pod-case-v1"),
        points=np.asarray(points, np.float32),
        k=np.int32(spec.k),
        ndev=np.int32(spec.ndev),
        kind=np.bytes_(kind.encode()),
        reason=np.bytes_(reason[:2000].encode()),
        hazard=np.bytes_(hazard_of(spec.generator).encode()),
        spec_json=np.bytes_(json.dumps(spec.to_json()).encode()))
    return path


def load_pod_case(path: str) -> dict:
    with np.load(path) as z:
        return {
            "points": np.asarray(z["points"], np.float32),
            "k": int(z["k"]),
            "ndev": int(z["ndev"]),
            "kind": bytes(z["kind"]).decode(),
            "reason": bytes(z["reason"]).decode(),
            "hazard": bytes(z["hazard"]).decode(),
            "spec": PodCaseSpec.from_json(
                json.loads(bytes(z["spec_json"]).decode())),
        }


def _safe_bank_dir(bank_dir: Optional[str]) -> Optional[str]:
    """A ``KNTPU_POD_FAULT`` run never banks into a real corpus
    (``fuzz.safe_bank_dir``)."""
    return safe_bank_dir(bank_dir, parse_pod_fault() is not None,
                         "kntpu-pod-faulted-")


def run_pod_case(spec: PodCaseSpec, bank_dir: Optional[str] = None,
                 minimize: bool = True, max_probes: int = 32,
                 device=None) -> Optional[PodFailure]:
    """One case end to end: generate, solve partitioned, compare twice,
    minimize (k and ndev FIXED), bank."""
    points = generate_case(CaseSpec(generator=spec.generator,
                                    seed=spec.seed, n=spec.n, k=spec.k))
    got = _pod_failure(points, spec.k, spec.ndev, device=device)
    if got is None:
        return None
    kind, reason = got
    failure = PodFailure(
        case_id=spec.case_id(), generator=spec.generator,
        hazard=hazard_of(spec.generator), kind=kind, reason=reason,
        ndev=spec.ndev, original_n=points.shape[0])
    repro = points
    if minimize and points.shape[0] > 1:
        def _still_fails(sub):
            sub_got = _pod_failure(sub, spec.k, spec.ndev, device=device)
            return sub_got is not None and sub_got[0] == kind
        repro, _probes = ddmin_points(points, _still_fails,
                                      max_probes=max_probes)
    failure.minimized_n = int(repro.shape[0])
    bank_dir = _safe_bank_dir(bank_dir)
    if bank_dir is not None:
        failure.banked = bank_pod_case(bank_dir, spec, kind, reason, repro)
    return failure


def draw_pod_cases(n_cases: int, seed: int,
                   ndev: int = 4) -> List[PodCaseSpec]:
    """The deterministic case list: cycles the zoo with every third case
    re-drawn from the boundary-hazard generators (power-law /
    grid-aligned -- see module docstring), k from a small palette, device
    count fixed per campaign."""
    rng = np.random.default_rng(seed)
    names = zoo_names()
    cases: List[PodCaseSpec] = []
    for i in range(n_cases):
        name = names[i % len(names)]
        if i % 3 == 2:
            name = _BOUNDARY_GENERATORS[(i // 3) % len(_BOUNDARY_GENERATORS)]
        k = int(rng.choice((4, 8, 16)))
        if name == "tiny-n":
            n = int(rng.choice(TINY_NS(k)))
        else:
            n = int(rng.choice((65, 257, 1025)))
        cases.append(PodCaseSpec(generator=name, seed=seed * 100003 + i,
                                 n=n, k=k, ndev=ndev))
    return cases


def run_pod_campaign(n_cases: int = 64, seed: int = 0,
                     bank_dir: str = CORPUS_DIR,
                     budget_s: Optional[float] = None,
                     minimize: bool = True, ndev: int = 4,
                     log=print, device=None) -> dict:
    """The pod campaign on ``device`` (``ndev`` chips on it);
    manifest['ok'] is the rc-0 bar."""
    from .campaign import prepare_device

    log = log or (lambda s: None)
    t0 = time.monotonic()
    dev = prepare_device(device)
    cases = draw_pod_cases(n_cases, seed, ndev=ndev)
    if parse_pod_fault() is not None and cases:
        # self-test guarantee: the seeded faults corrupt CROSS-CHIP
        # neighbors, so a small faulted run must contain a case that
        # provably has some (a uniform multi-chip cloud: population-
        # balanced splits put near-neighbor pairs on every range
        # boundary).  Faulted runs bank to a diverted directory anyway
        # (_safe_bank_dir), so the real corpus never sees this case.
        cases = [PodCaseSpec(generator="uniform",
                             seed=seed * 100003 + 999983, n=513, k=8,
                             ndev=ndev)] + cases[: max(0, n_cases - 1)]
    failures: List[PodFailure] = []
    completed = 0
    truncated_after: Optional[int] = None
    for i, spec in enumerate(cases):
        if budget_s is not None and time.monotonic() - t0 > budget_s:
            truncated_after = i
            log(f"[{i}/{len(cases)}] budget {budget_s:.0f}s exhausted; "
                f"remaining pod cases truncated (case list is seeded -- "
                f"rerun with a larger budget to cover them)")
            break
        f = run_pod_case(spec, bank_dir=bank_dir, minimize=minimize,
                         device=dev)
        completed += 1
        tag = "ok" if f is None else f"FAIL {f.kind}"
        log(f"[{i + 1}/{len(cases)}] {spec.case_id()} "
            f"[{spec.generator}] {tag}")
        if f is not None:
            failures.append(f)
    return {
        "ok": not failures,
        "flavor": "pod",
        "requested_cases": n_cases,
        "completed_cases": completed,
        "truncated_after": truncated_after,
        "seed": seed,
        "n_devices": ndev,
        "elapsed_s": round(time.monotonic() - t0, 3),
        "failures": [f.to_json() for f in failures],
        "corpus_size": corpus_size(bank_dir),
    }
