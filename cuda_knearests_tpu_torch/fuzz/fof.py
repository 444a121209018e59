"""FoF fuzzing: friends-of-friends against the union-find oracle.

Counterpart of ``cuda_knearests_tpu/fuzz/fof.py``, the same cases, on
``device`` (default: the GPU).  The shared zoo supplies hostile clouds, a
linking length is drawn per case (regenerable from the spec), the labels
of ``cluster.fof.fof_labels`` are checked with the tie-aware partition
comparison (``cluster/compare.check_fof_result``: the mandatory/allowed
bracket around the f32 rounding band of the radius, and the canonical
min-id labels), and failures are ddmin-minimized over point rows and
banked as ``*-fof.npz``.

Linking-length modes (the spec's ``b_mode``):

  * ``scaled`` -- ``b = b_scale * domain / n^(1/3)``: fractions of the
    mean spacing (sparse, percolating and dense regimes).
  * ``tie``    -- ``b`` the exact f64 distance from point 0 to its nearest
    neighbour: a pair exactly on the linking radius.

Seeded fault (``KNTPU_FOF_FAULT=split|merge``) corrupts the labels before
the comparison -- ``split`` detaches one member of a real cluster,
``merge`` fuses two clusters -- proving the detector live.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import List, Optional, Tuple

import numpy as np

from . import CORPUS_DIR, corpus_size, safe_bank_dir
from .generators import TINY_NS, CaseSpec, generate_case, hazard_of, \
    zoo_names
from .minimize import ddmin_points
from ..config import DOMAIN_SIZE
from ..utils.memory import InputContractError, classify_fault_text

# the scaled-mode palette: fractions of the mean inter-point spacing
FOF_B_SCALES = (0.4, 1.0, 2.2)

FOF_FAULT_KINDS = ("split", "merge")

_FAULT_ENV = "KNTPU_FOF_FAULT"


@dataclasses.dataclass(frozen=True)
class FofCaseSpec:
    """Regenerable identity of one FoF fuzz case."""

    generator: str
    seed: int
    n: int
    b_mode: str        # 'scaled' | 'tie'
    b_scale: float     # used by 'scaled' (and the 'tie' fallback)

    def case_id(self) -> str:
        tag = (f"b{self.b_scale:g}" if self.b_mode == "scaled" else "btie")
        return f"fof-{self.generator}-s{self.seed}-n{self.n}-{tag}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "FofCaseSpec":
        return cls(generator=str(d["generator"]), seed=int(d["seed"]),
                   n=int(d["n"]), b_mode=str(d["b_mode"]),
                   b_scale=float(d["b_scale"]))


@dataclasses.dataclass
class FofFailure:
    """One case's disagreement with the union-find oracle."""

    case_id: str
    generator: str
    hazard: str
    kind: str          # 'mismatch' | 'invalid-input' | exception taxonomy
    reason: str
    linking_length: float
    original_n: int
    minimized_n: Optional[int] = None
    banked: Optional[str] = None

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def case_points(spec: FofCaseSpec) -> np.ndarray:
    """The case's point cloud: the SAME zoo as the point-case campaign
    (k is not a FoF parameter; the zoo's k-dependence is seeded at 1)."""
    return generate_case(CaseSpec(generator=spec.generator, seed=spec.seed,
                                  n=spec.n, k=1))


def case_linking_length(spec: FofCaseSpec, points: np.ndarray) -> float:
    """The case's b, deterministic from (spec, points)."""
    scaled = (spec.b_scale * DOMAIN_SIZE
              / max(1.0, float(spec.n)) ** (1.0 / 3.0))
    if spec.b_mode != "tie" or points.shape[0] < 2:
        return float(scaled)
    p64 = points.astype(np.float64)  # the exact tie radius, host only
    d2 = ((p64[1:] - p64[0]) ** 2).sum(-1)
    b = float(np.sqrt(d2.min()))
    # a coincident nearest neighbor gives b=0 (illegal); the tie hazard is
    # then already covered by distance-zero pairs, so fall back to scaled
    return b if b > 0.0 else float(scaled)


def parse_fof_fault(spec: Optional[str] = None) -> Optional[str]:
    spec = os.environ.get(_FAULT_ENV, "") if spec is None else spec
    spec = (spec or "").strip()
    if not spec:
        return None
    if spec not in FOF_FAULT_KINDS:
        raise ValueError(f"unknown {_FAULT_ENV} {spec!r}: expected one of "
                         f"{FOF_FAULT_KINDS}")
    return spec


def _apply_fault(labels: np.ndarray) -> np.ndarray:
    """Corrupt engine labels per the env-seeded fault: 'split' detaches
    the highest-id member of the largest multi-member cluster (its own
    canonical singleton -- undetectable by the canonicalization check, so
    only the mandatory-link check can catch it); 'merge' fuses the two
    lowest-labeled clusters.  A no-op when the case lacks the needed
    structure (the self-test uses a case that guarantees it)."""
    fault = parse_fof_fault()
    if fault is None or labels.size == 0:
        return labels
    labels = labels.copy()
    if fault == "split":
        uniq, counts = np.unique(labels, return_counts=True)
        multi = counts > 1
        if multi.any():
            lab = uniq[multi][int(np.argmax(counts[multi]))]
            victim = int(np.nonzero(labels == lab)[0][-1])
            if victim != lab:
                labels[victim] = victim
    else:  # merge
        uniq = np.unique(labels)
        if uniq.size >= 2:
            labels[labels == uniq[1]] = uniq[0]
    return labels


def _fof_failure(points: np.ndarray, b: float, device=None
                 ) -> Optional[Tuple[str, str]]:
    """(kind, reason) when the engine's FoF labels disagree with the
    oracle on ``points`` at linking length ``b``, None when exact.
    Exceptions are contained and classified -- legal input must never
    raise, so any raise IS the failure."""
    from ..cluster.compare import check_fof_result
    from ..cluster.fof import fof_labels

    try:
        res = fof_labels(points, b, device=device)
    except InputContractError as e:
        return ("invalid-input",
                f"legal input refused: {type(e).__name__}: {e}")
    except Exception as e:  # noqa: BLE001 -- containment IS the job: every raise on legal input is banked as a typed campaign failure
        kind = classify_fault_text(f"{type(e).__name__}: {e}") or "crash"
        return (kind, f"fof raised {type(e).__name__}: {e}")
    labels = _apply_fault(res.labels)
    sizes = res.sizes if labels is res.labels else None
    mismatch = check_fof_result(points, b, labels, sizes)
    if mismatch is not None:
        return ("mismatch", mismatch.render())
    return None


def bank_fof_case(bank_dir: str, spec: FofCaseSpec, kind: str, reason: str,
                  points: np.ndarray, b: float) -> str:
    """Bank one failing case (suffix ``-fof.npz``: its own replay schema,
    like the mutation corpus)."""
    os.makedirs(bank_dir, exist_ok=True)
    path = os.path.join(bank_dir, f"{spec.case_id()}-fof.npz")
    np.savez_compressed(
        path,
        schema=np.bytes_(b"fof-case-v1"),
        points=np.asarray(points, np.float32),
        linking_length=np.float64(b),  # on-disk schema: the exact b
        kind=np.bytes_(kind.encode()),
        reason=np.bytes_(reason[:2000].encode()),
        hazard=np.bytes_(hazard_of(spec.generator).encode()),
        spec_json=np.bytes_(json.dumps(spec.to_json()).encode()))
    return path


def load_fof_case(path: str) -> dict:
    with np.load(path) as z:
        return {
            "points": np.asarray(z["points"], np.float32),
            "linking_length": float(z["linking_length"]),
            "kind": bytes(z["kind"]).decode(),
            "reason": bytes(z["reason"]).decode(),
            "hazard": bytes(z["hazard"]).decode(),
            "spec": FofCaseSpec.from_json(
                json.loads(bytes(z["spec_json"]).decode())),
        }


def _safe_bank_dir(bank_dir: Optional[str]) -> Optional[str]:
    """A ``KNTPU_FOF_FAULT`` run never banks into a real corpus
    (``fuzz.safe_bank_dir``)."""
    return safe_bank_dir(bank_dir, parse_fof_fault() is not None,
                         "kntpu-fof-faulted-")


def run_fof_case(spec: FofCaseSpec, bank_dir: Optional[str] = None,
                 minimize: bool = True, max_probes: int = 48,
                 device=None) -> Optional[FofFailure]:
    """One case end to end: generate, solve, compare, minimize, bank.
    ``b`` stays FIXED during minimization (the failure is a property of
    the cloud at that radius; re-deriving it per subset would chase a
    moving target)."""
    points = case_points(spec)
    b = case_linking_length(spec, points)
    got = _fof_failure(points, b, device=device)
    if got is None:
        return None
    kind, reason = got
    failure = FofFailure(
        case_id=spec.case_id(), generator=spec.generator,
        hazard=hazard_of(spec.generator), kind=kind, reason=reason,
        linking_length=b, original_n=points.shape[0])
    repro = points
    if minimize and points.shape[0] > 1:
        def _still_fails(sub):
            sub_got = _fof_failure(sub, b, device=device)
            return sub_got is not None and sub_got[0] == kind
        repro, _probes = ddmin_points(points, _still_fails,
                                      max_probes=max_probes)
    failure.minimized_n = int(repro.shape[0])
    bank_dir = _safe_bank_dir(bank_dir)
    if bank_dir is not None:
        failure.banked = bank_fof_case(bank_dir, spec, kind, reason,
                                       repro, b)
    return failure


def draw_fof_cases(n_cases: int, seed: int) -> List[FofCaseSpec]:
    """The deterministic case list: cycles the zoo (every generator
    covered before any repeats), b_scale from the palette, every fifth
    case in tie mode (b exactly ON a pairwise distance)."""
    rng = np.random.default_rng(seed)
    names = zoo_names()
    cases: List[FofCaseSpec] = []
    for i in range(n_cases):
        name = names[i % len(names)]
        if name == "tiny-n":
            n = int(rng.choice(TINY_NS(1)))
        else:
            n = int(rng.choice((33, 96, 257)))
        cases.append(FofCaseSpec(
            generator=name, seed=seed * 100003 + i, n=n,
            b_mode="tie" if i % 5 == 4 else "scaled",
            b_scale=float(rng.choice(FOF_B_SCALES))))
    return cases


def run_fof_campaign(n_cases: int = 64, seed: int = 0,
                     bank_dir: str = CORPUS_DIR,
                     budget_s: Optional[float] = None,
                     minimize: bool = True,
                     log=print, device=None) -> dict:
    """The FoF campaign on ``device``; manifest['ok'] is the rc-0 bar."""
    from .campaign import prepare_device

    log = log or (lambda s: None)
    t0 = time.monotonic()
    dev = prepare_device(device)
    cases = draw_fof_cases(n_cases, seed)
    failures: List[FofFailure] = []
    completed = 0
    truncated_after: Optional[int] = None
    for i, spec in enumerate(cases):
        if budget_s is not None and time.monotonic() - t0 > budget_s:
            truncated_after = i
            log(f"[{i}/{len(cases)}] budget {budget_s:.0f}s exhausted; "
                f"remaining FoF cases truncated (case list is seeded -- "
                f"rerun with a larger budget to cover them)")
            break
        f = run_fof_case(spec, bank_dir=bank_dir, minimize=minimize,
                         device=dev)
        completed += 1
        tag = "ok" if f is None else f"FAIL {f.kind}"
        log(f"[{i + 1}/{len(cases)}] {spec.case_id()} "
            f"[{spec.generator}] {tag}")
        if f is not None:
            failures.append(f)
    return {
        "ok": not failures,
        "flavor": "fof",
        "requested_cases": n_cases,
        "completed_cases": completed,
        "truncated_after": truncated_after,
        "seed": seed,
        "elapsed_s": round(time.monotonic() - t0, 3),
        "failures": [f.to_json() for f in failures],
        "corpus_size": corpus_size(bank_dir),
    }
