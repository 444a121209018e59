"""Approximate-mode fuzzing: the brute route's recall bound and the
soundness of its certificates.

Counterpart of ``cuda_knearests_tpu/fuzz/approx.py``, the same cases and
claims, on ``device`` (default: the GPU, where the selection kernels of
``csrc/mxu_select*.cu`` answer).  The point campaign proves the exact
routes give the answer; this flavor attacks the claims the approximate
route makes instead:

  1. **recall bound** -- at ``recall_target < 1.0`` with ``refine='none'``
     the measured tie-aware recall@k against the exact f64 oracle meets
     the bound the solve reports (``MxuResult.bound``); a returned id is a
     hit when its exact distance is within the dot form's band 2B
     (``mxu/measure.declared_band``, at the case's scoring precision) of
     the true k-th.
  2. **certificate soundness** -- every certified row is exact at the
     exact threshold (band-free, at every precision): the refinement
     trusts the bit.
  3. **structure** -- pad contract, duplicate ids, ascending order and
     f64-realized distances, at every target.
  4. **exact tier** -- at ``recall_target = 1.0`` (refine='brute') the
     full tie-aware comparison against the oracle.

Cases cycle the shared zoo plus one planted generator, ``block-aliased``:
a tight cluster stored at indices spaced exactly G apart (G the case's
candidate block count), so the round-robin interleave puts every member
in block 0 -- a guaranteed per-block top-m overflow, whose rows must come
back uncertified.  Planted cases, and every third other case, run at
bf16.

Failures are ddmin-minimized (k, recall_target and precision fixed) and
banked as ``*-approx.npz``.  Seeded faults (``KNTPU_MXU_FAULT=drop-block|
skip-certify|narrow-bound``, ``mxu/solve.parse_fault``, which then runs
the selection's plain version) must each give a banked failure; faulted
runs never bank into a real corpus.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import List, Optional, Tuple

import numpy as np

from . import CORPUS_DIR, corpus_size, safe_bank_dir
from .compare import ATOL, RTOL, check_route_result
from .generators import TINY_NS, CaseSpec, generate_case, hazard_of, \
    zoo_names
from .minimize import ddmin_points
from .routes import oracle_reference
from ..config import DOMAIN_SIZE
from ..mxu.measure import declared_band, f64_kth, row_hits
from ..mxu.topk import BLOCK
from ..utils.memory import InputContractError, classify_fault_text

#: Sub-1.0 targets the campaign sweeps; every fourth case runs the exact
#: tier (recall_target = 1.0) through the full differential comparison.
APPROX_RTS = (0.6, 0.8, 0.95)
EXACT_RT = 1.0

#: The planted generator (see module docstring); not part of the shared
#: zoo -- its construction depends on the MXU route's interleave width.
PLANTED = "block-aliased"

#: Case sizes: the zoo palette plus one size deep enough that the fold is
#: genuinely approximate (per_block_m only drops below min(k, 128) once
#: the block count exceeds ~bins/k, i.e. n in the thousands for k=10).
APPROX_NS = (257, 2048)
APPROX_KS = (4, 10)


@dataclasses.dataclass(frozen=True)
class ApproxCaseSpec:
    """Regenerable identity of one approximate-mode fuzz case."""

    generator: str
    seed: int
    n: int
    k: int
    recall_target: float
    #: scoring tier under attack; 'f32' keeps pre-tier case ids stable
    precision: str = "f32"

    def case_id(self) -> str:
        suffix = "" if self.precision == "f32" else f"-{self.precision}"
        return (f"approx-{self.generator}-s{self.seed}-n{self.n}"
                f"-k{self.k}-r{self.recall_target:g}{suffix}")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "ApproxCaseSpec":
        return cls(generator=str(d["generator"]), seed=int(d["seed"]),
                   n=int(d["n"]), k=int(d["k"]),
                   recall_target=float(d["recall_target"]),
                   # pre-tier corpora carry no precision field: f32
                   precision=str(d.get("precision", "f32")))


@dataclasses.dataclass
class ApproxFailure:
    """One case's violated claim, ready for the manifest."""

    case_id: str
    generator: str
    hazard: str
    kind: str      # 'recall-bound' | 'certified-unsound' | 'mismatch' | ...
    reason: str
    recall_target: float
    original_n: int
    minimized_n: Optional[int] = None
    banked: Optional[str] = None

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _hazard(generator: str) -> str:
    if generator == PLANTED:
        return ("tight cluster aliased onto ONE candidate block through "
                "the round-robin interleave: guaranteed per-block top-m "
                "overflow, the recall bound's worst case")
    return hazard_of(generator)


def _planted_points(spec: ApproxCaseSpec) -> np.ndarray:
    """The block-aliased cloud: uniform background, plus a tight cluster
    stored at indices {0, G, 2G, ...} so the interleave (slot j -> block
    j mod G) concentrates it entirely in block 0."""
    n = spec.n
    if n == 0:
        return np.empty((0, 3), np.float32)
    rng = np.random.default_rng(
        np.random.SeedSequence([spec.seed, n, spec.k]))
    pts = (rng.random((n, 3)) * DOMAIN_SIZE).astype(np.float32)
    g = max(1, (-(-n // BLOCK) * BLOCK) // BLOCK)
    n_cluster = min(2 * spec.k, max(1, (n - 1) // g + 1))
    idx = np.arange(n_cluster) * g
    center = (DOMAIN_SIZE * (0.25 + 0.5 * rng.random(3))).astype(np.float32)
    blob = center + rng.normal(size=(n_cluster, 3)).astype(np.float32) * 1e-3
    pts[idx] = np.clip(blob, 0.0, DOMAIN_SIZE)
    return pts


def case_points(spec: ApproxCaseSpec) -> np.ndarray:
    if spec.generator == PLANTED:
        return _planted_points(spec)
    return generate_case(CaseSpec(generator=spec.generator, seed=spec.seed,
                                  n=spec.n, k=spec.k))


def _structural(points: np.ndarray, ids: np.ndarray,
                d2: np.ndarray, k: int) -> Optional[str]:
    """The structure checks that hold at EVERY target (compare.py checks
    1-4; the distance-multiset equality is exact-tier only)."""
    m = points.shape[0]
    if ids.shape != (m, k) or d2.shape != (m, k):
        return f"shape: ids {ids.shape} d2 {d2.shape}, want {(m, k)}"
    if m == 0:
        return None
    valid = ids >= 0
    finite = np.isfinite(d2)
    if (valid != finite).any():
        r = int(np.nonzero((valid != finite).any(axis=1))[0][0])
        return (f"pad-contract row {r}: ids>=0 {valid[r].tolist()} != "
                f"isfinite(d2) {finite[r].tolist()}")
    sentinel = m + np.arange(k)[None, :]
    srt = np.sort(np.where(valid, ids, sentinel), axis=1)
    dup = (np.diff(srt, axis=1) == 0).any(axis=1)
    if dup.any():
        r = int(np.nonzero(dup)[0][0])
        return f"duplicate-ids row {r}: {ids[r].tolist()}"
    d2a = np.where(finite, d2, np.inf)
    with np.errstate(invalid="ignore"):
        bad = (np.diff(d2a, axis=1) < -ATOL).any(axis=1)
    if bad.any():
        r = int(np.nonzero(bad)[0][0])
        return f"not-ascending row {r}: {d2[r].tolist()}"
    safe = np.clip(ids, 0, m - 1)
    real = ((points[safe].astype(np.float64)
             - points[:, None, :].astype(np.float64)) ** 2).sum(-1)
    ok = np.isclose(real, d2, rtol=RTOL, atol=ATOL) | ~valid
    if not ok.all():
        r, c = (int(x[0]) for x in np.nonzero(~ok))
        return (f"unrealized-distance row {r}: id {int(ids[r, c])} "
                f"reported {d2[r, c]:.6g} actual {real[r, c]:.6g}")
    return None


def _approx_failure(points: np.ndarray, k: int, recall_target: float,
                    precision: str = "f32",
                    res_out: Optional[list] = None, device=None
                    ) -> Optional[Tuple[str, str]]:
    """(kind, reason) when the MXU route violates a claim on ``points``,
    None when every claim holds.  Exceptions are contained and classified
    -- legal input must never raise.  ``res_out`` (when given) receives
    the MxuResult so follow-on audits need not re-solve.

    ``precision`` is the scoring tier under attack: the certificate
    soundness check is band-free at EVERY tier (a certified row claims
    exactness, full stop), only the recall hit test widens to the tier's
    own declared band."""
    from ..mxu.solve import solve_general

    exact = recall_target >= 1.0
    try:
        res = solve_general(points, k=k, recall_target=recall_target,
                            scorer="mxu", precision=precision,
                            refine="brute" if exact else "none",
                            device=device)
    except InputContractError as e:
        return ("invalid-input",
                f"legal input refused: {type(e).__name__}: {e}")
    except Exception as e:  # noqa: BLE001 -- containment IS the job: every raise on legal input is banked as a typed campaign failure
        kind = classify_fault_text(f"{type(e).__name__}: {e}") or "crash"
        return (kind, f"solve_general raised {type(e).__name__}: {e}")
    if res_out is not None:
        res_out.append(res)
    ids, d2 = res.neighbors, res.dists_sq
    if exact:
        ref_ids, ref_d2 = oracle_reference(points, k, exclude_self=True)
        mm = check_route_result(points, points, ids, d2,
                                np.asarray(ref_d2), k)
        if mm is not None:
            return ("mismatch", f"exact tier (recall_target=1.0): "
                                f"{mm.render()}")
        if not res.certified.all():
            return ("mismatch", "exact tier left rows uncertified after "
                                "refinement (the fallback must certify "
                                "every row it resolves)")
        return None
    bad = _structural(points, ids, d2, k)
    if bad is not None:
        return ("mismatch", bad)
    if points.shape[0] == 0:
        return None
    kth, avail = f64_kth(points, k)
    # certificate soundness first (band-free, mxu/measure.py's f32-tie
    # discipline at the exact threshold): it is the sharper claim, and
    # the drop-block/skip-certify self-tests key on it
    hits_exact = row_hits(points, ids, kth)
    cert = np.asarray(res.certified, bool)
    unsound = cert & (hits_exact < avail)
    if unsound.any():
        r = int(np.nonzero(unsound)[0][0])
        return ("certified-unsound",
                f"{int(unsound.sum())} certified row(s) are not exact "
                f"top-k (first: row {r}, "
                f"{int(hits_exact[r])}/{int(avail[r])} tie-aware hits): "
                f"the refinement tier would trust a wrong answer")
    # recall against the fold's binning bound (TPU-KNN), at the route's own scoring
    # precision: the hit threshold widens by the per-row dot-form error
    # band 2B the certificate itself reasons with -- bf16's wider band
    # is exactly the wider contract that tier declares
    hits = row_hits(points, ids, kth,
                    band=declared_band(points, precision=precision))
    total = int(avail.sum())
    recall = float(hits.sum()) / total if total else 1.0
    if recall < res.bound:
        return ("recall-bound",
                f"measured recall {recall:.6f} < proven bound "
                f"{res.bound:.6f} (m={res.m}, n_blocks={res.n_blocks}, "
                f"recall_target={recall_target})")
    return None


def _planted_overflow_failure(spec: ApproxCaseSpec, points: np.ndarray,
                              res=None, device=None
                              ) -> Optional[Tuple[str, str]]:
    """The planted generator's live claim (module docstring): when block
    0's fold provably overflows, the certificate must notice -- every
    cluster row must come back uncertified.  A cluster row's pool rejects at least one tiny
    co-member score (kplus ~ the cluster scatter) while its k-th selected
    score is a background distance orders of magnitude larger, so a sound
    certificate cannot fire; one that does is the drop-block shape with no
    fault seeded.  Without this check the 'rows must come back
    uncertified' guarantee is documentation-only and an interleave or
    fold edit could void the planted construction silently.  Only
    meaningful on the ORIGINAL layout (minimization reshuffles storage
    indices and dissolves the aliasing), and only when the pool genuinely
    overflows (n_cluster - 1 > m).  ``res`` is the MxuResult the standard
    audit already produced (byte-identical arguments); solving again here
    would double the planted case's cost."""
    n = points.shape[0]
    if spec.recall_target >= 1.0 or n == 0:
        return None
    if res is None:
        from ..mxu.solve import solve_general

        res = solve_general(points, k=spec.k,
                            recall_target=spec.recall_target,
                            scorer="mxu", precision=spec.precision,
                            refine="none", device=device)
    g = max(1, (-(-n // BLOCK) * BLOCK) // BLOCK)
    n_cluster = min(2 * spec.k, max(1, (n - 1) // g + 1))
    if n_cluster - 1 <= res.m:
        return None  # pool keeps every co-member: nothing overflowed
    idx = np.arange(n_cluster) * g
    cert = np.asarray(res.certified, bool)[idx]
    if cert.any():
        r = int(idx[np.nonzero(cert)[0][0]])
        return ("planted-overflow-certified",
                f"{int(cert.sum())}/{n_cluster} block-aliased cluster "
                f"row(s) came back CERTIFIED despite a provably "
                f"overflowed pool (first: row {r}; m={res.m}, "
                f"n_cluster={n_cluster}): the certificate failed to "
                f"notice a top-m overflow it must reject")
    return None


def bank_approx_case(bank_dir: str, spec: ApproxCaseSpec, kind: str,
                     reason: str, points: np.ndarray) -> str:
    """Bank one failing case (suffix ``-approx.npz``: its own replay
    schema, like the FoF and mutation corpora)."""
    os.makedirs(bank_dir, exist_ok=True)
    path = os.path.join(bank_dir, f"{spec.case_id()}-approx.npz")
    np.savez_compressed(
        path,
        schema=np.bytes_(b"approx-case-v1"),
        points=np.asarray(points, np.float32),
        k=np.int32(spec.k),
        recall_target=np.float64(spec.recall_target),  # on-disk schema
        kind=np.bytes_(kind.encode()),
        reason=np.bytes_(reason[:2000].encode()),
        hazard=np.bytes_(_hazard(spec.generator).encode()),
        spec_json=np.bytes_(json.dumps(spec.to_json()).encode()))
    return path


def load_approx_case(path: str) -> dict:
    with np.load(path) as z:
        return {
            "points": np.asarray(z["points"], np.float32),
            "k": int(z["k"]),
            "recall_target": float(z["recall_target"]),
            "kind": bytes(z["kind"]).decode(),
            "reason": bytes(z["reason"]).decode(),
            "hazard": bytes(z["hazard"]).decode(),
            "spec": ApproxCaseSpec.from_json(
                json.loads(bytes(z["spec_json"]).decode())),
        }


def _safe_bank_dir(bank_dir: Optional[str]) -> Optional[str]:
    """A ``KNTPU_MXU_FAULT`` run never banks into a real corpus
    (``fuzz.safe_bank_dir``)."""
    from ..mxu.solve import parse_fault

    return safe_bank_dir(bank_dir, parse_fault() is not None,
                         "kntpu-approx-faulted-")


def run_approx_case(spec: ApproxCaseSpec, bank_dir: Optional[str] = None,
                    minimize: bool = True, max_probes: int = 32,
                    device=None) -> Optional[ApproxFailure]:
    """One case end to end: generate, solve, audit the claims, minimize,
    bank.  ``k`` and ``recall_target`` stay FIXED during minimization
    (the violated claim is a property of the cloud at that configuration;
    n shrinking re-derives m and the bound per subset, which is exactly
    what replay does too)."""
    points = case_points(spec)
    res_box: list = []
    got = _approx_failure(points, spec.k, spec.recall_target,
                          precision=spec.precision, res_out=res_box,
                          device=device)
    if got is None and spec.generator == PLANTED:
        # the planted case's extra claim; never minimized (the aliasing
        # construction lives in the storage indices ddmin reshuffles)
        got = _planted_overflow_failure(
            spec, points, res_box[0] if res_box else None, device=device)
        if got is not None:
            minimize = False
    if got is None:
        return None
    kind, reason = got
    failure = ApproxFailure(
        case_id=spec.case_id(), generator=spec.generator,
        hazard=_hazard(spec.generator), kind=kind, reason=reason,
        recall_target=spec.recall_target, original_n=points.shape[0])
    repro = points
    if minimize and points.shape[0] > 1:
        def _still_fails(sub):
            sub_got = _approx_failure(sub, spec.k, spec.recall_target,
                                      precision=spec.precision,
                                      device=device)
            return sub_got is not None and sub_got[0] == kind
        repro, _probes = ddmin_points(points, _still_fails,
                                      max_probes=max_probes)
    failure.minimized_n = int(repro.shape[0])
    bank_dir = _safe_bank_dir(bank_dir)
    if bank_dir is not None:
        failure.banked = bank_approx_case(bank_dir, spec, kind, reason,
                                          repro)
    return failure


def draw_approx_cases(n_cases: int, seed: int) -> List[ApproxCaseSpec]:
    """The deterministic case list: the planted block-aliased generator
    leads (case 0 -- the seeded-fault self-tests need it within any small
    campaign), then the zoo cycles; every fourth case runs the exact tier
    at recall_target = 1.0, the rest sweep the sub-1.0 palette.

    Precision tiers: planted cases run at bf16 (case 0 is the
    narrow-bound seeded fault's live detector -- the fault only bites
    rows whose scoring tier is WIDER than the band the certificate
    reasons with), and every third remaining case attacks bf16 too, so a
    default campaign exercises both tiers against every zoo hazard."""
    rng = np.random.default_rng(seed)
    names = [PLANTED] + zoo_names()
    cases: List[ApproxCaseSpec] = []
    for i in range(n_cases):
        name = names[i % len(names)]
        k = int(rng.choice(APPROX_KS))
        if name == "tiny-n":
            n = int(rng.choice(TINY_NS(k)))
        elif name == PLANTED:
            n = 2048  # deep enough that per-block m < k: genuinely approximate
        else:
            n = int(rng.choice(APPROX_NS))
        rt = (EXACT_RT if i % 4 == 3
              else float(rng.choice(APPROX_RTS)))
        if name == PLANTED:
            rt = float(min(APPROX_RTS))  # the overflow probe needs approx mode
        precision = "bf16" if name == PLANTED or i % 3 == 1 else "f32"
        cases.append(ApproxCaseSpec(
            generator=name, seed=seed * 100003 + i, n=n, k=k,
            recall_target=rt, precision=precision))
    return cases


def run_approx_campaign(n_cases: int = 64, seed: int = 0,
                        bank_dir: str = CORPUS_DIR,
                        budget_s: Optional[float] = None,
                        minimize: bool = True,
                        log=print, device=None) -> dict:
    """The approximate-mode campaign on ``device``; manifest['ok'] is the
    rc-0 bar."""
    from .campaign import prepare_device

    log = log or (lambda s: None)
    t0 = time.monotonic()
    dev = prepare_device(device)
    cases = draw_approx_cases(n_cases, seed)
    failures: List[ApproxFailure] = []
    completed = 0
    truncated_after: Optional[int] = None
    for i, spec in enumerate(cases):
        if budget_s is not None and time.monotonic() - t0 > budget_s:
            truncated_after = i
            log(f"[{i}/{len(cases)}] budget {budget_s:.0f}s exhausted; "
                f"remaining approx cases truncated (case list is seeded -- "
                f"rerun with a larger budget to cover them)")
            break
        f = run_approx_case(spec, bank_dir=bank_dir, minimize=minimize,
                            device=dev)
        completed += 1
        tag = "ok" if f is None else f"FAIL {f.kind}"
        log(f"[{i + 1}/{len(cases)}] {spec.case_id()} "
            f"[{spec.generator}] {tag}")
        if f is not None:
            failures.append(f)
    return {
        "ok": not failures,
        "flavor": "approx",
        "requested_cases": n_cases,
        "completed_cases": completed,
        "truncated_after": truncated_after,
        "seed": seed,
        "elapsed_s": round(time.monotonic() - t0, 3),
        "failures": [f.to_json() for f in failures],
        "corpus_size": corpus_size(bank_dir),
    }
