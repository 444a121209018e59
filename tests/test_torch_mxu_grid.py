"""The grid route's MXU/approximate tier of the PyTorch port against the
JAX package: ``KnnConfig(scorer='mxu')``, ``recall_target < 1`` and
``precision='bf16'`` on the adaptive class schedule
(``mxu.scorer.grid_class_topk``), the recall oracle ``mxu/measure.py`` and
the brute route's smoke ``python -m cuda_knearests_tpu_torch.mxu``.

The JAX side runs as ``tests/test_mxu.py`` runs it on the CPU (its class
scorer is XLA, no Pallas).  Rows are compared with the reference's
tie-aware comparator (RTOL 1e-4, ATOL 1e-2): XLA's CPU backend contracts
multiply-adds, so d2 and the dot-form scores may differ in their last
bits.  For the same reason a row whose fold certificate ``kplus >= t +
2B`` is decided within float32 rounding may certify in one package and not
in the other; every such row must show ``|kplus - t - 2B|`` within the
float32 term of the dot form's error, ``(d + 8) * eps32 * (qn +
pn_max)``.  Within the port, the MXU tier at recall_target=1.0 (and every
tier once the exact fallback has run) must equal the elementwise solve
exactly.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_knearests_tpu as ck
from cuda_knearests_tpu.fuzz.compare import check_route_result
from cuda_knearests_tpu.io import (generate_blue_noise, generate_clustered,
                                   generate_uniform)
from cuda_knearests_tpu.mxu import measure as jmeasure
from cuda_knearests_tpu.mxu import topk as jtopk
from cuda_knearests_tpu.mxu.scorer import class_eligible as jeligible
from cuda_knearests_tpu.mxu.scorer import grid_class_topk as jgrid
from cuda_knearests_tpu.ops.adaptive import solve_adaptive as jsolve
import cuda_knearests_tpu_torch as pt
from cuda_knearests_tpu_torch.mxu import measure as pmeasure
from cuda_knearests_tpu_torch.mxu import scorer as ps
from cuda_knearests_tpu_torch.mxu import topk as ptk
from cuda_knearests_tpu_torch.ops import adaptive as padapt
from cuda_knearests_tpu_torch.ops.solve import pack_cells

ROOT = Path(__file__).resolve().parents[1]
EPS32 = float(np.finfo(np.float32).eps)


def _blob():
    """A uniform background and one dense blob inside one supercell, whose
    class's score tile fails ``class_eligible``."""
    rng = np.random.default_rng(29)
    bg = rng.random((3000, 3)) * 1000.0
    blob = 500.0 + rng.random((4500, 3)) * 10.0
    return np.concatenate([bg, blob]).astype(np.float32)


CLOUDS = {
    "blue": (lambda: generate_blue_noise(6000, seed=13), dict(k=10)),
    "clustered-r1": (lambda: generate_clustered(5000, seed=3),
                     dict(k=10, ring_radius=1)),
    "blob": (_blob, dict(k=10)),
}


@pytest.fixture(scope="module")
def clouds():
    return {name: make() for name, (make, _) in CLOUDS.items()}


def _prepare_both(pts, **kw):
    return (ck.KnnProblem.prepare(pts, ck.KnnConfig(**kw)),
            pt.KnnProblem.prepare(pts, pt.KnnConfig(**kw), device="cpu"))


def _mxu_classes(pp):
    return [cp for cp in pp.aplan.classes if cp.route == "mxu"]


def _fold_margin(pp, cp, r: int, rt: float, prec: str):
    """(kplus - t - 2B, the float32 term (d + 8) * eps32 * (qn + pn_max))
    of slot ``r`` of an 'mxu' class, from the port's scores and fold."""
    g, k = pp.grid, pp.config.k
    row, slot = divmod(r, cp.qcap)
    qid = cp.qid[row, slot]
    ci, co = pack_cells(cp.cand[row:row + 1], g.cell_starts, g.cell_counts,
                        cp.ccap)
    il = torch.as_tensor(ptk.interleave_slots(cp.ccap)).long()
    ci, co = ci[0, il], co[0, il]
    q, c = g.points[qid.long()][None], g.points[ci.long()]
    s = ps.score_tile(q, c, prec).masked_fill(~co | (ci == qid),
                                              float("inf"))
    m = ptk.per_block_m(rt, k, cp.ccap // ptk.BLOCK)
    pool, kplus = ps.fold_pool(s, ci, k, m)
    t = ps.key_score(pool[..., k - 1])
    qn = ps.norms(q)
    pn_max = torch.clamp(torch.where(co, ps.norms(c), float("-inf")).amax(),
                         min=0.0)
    b = ptk.dot_error_bound(qn, pn_max, 3, prec)
    return (float(kplus - t - 2.0 * b),
            (3 + 8) * EPS32 * float(qn + pn_max))


def _assert_borderline(pp, cp, rows, rt, prec):
    for r in rows:
        margin, f32_term = _fold_margin(pp, cp, int(r), rt, prec)
        print(f"certified on one side only: slot {int(r)} of a class of "
              f"{cp.n_sc} supercells (qcap {cp.qcap}, ccap {cp.ccap}), "
              f"{prec}, recall {rt}: kplus - t - 2B = {margin:.4f}, f32 "
              f"term {f32_term:.4f}")
        assert abs(margin) <= f32_term, (int(r), margin, f32_term)


# -- (i) the class specs ------------------------------------------------------

@pytest.mark.parametrize("name", list(CLOUDS))
def test_class_specs_match_jax(clouds, name):
    """Same partition, radii, capacities and 'mxu' classes as JAX; the
    blob's class fails ``class_eligible`` and keeps an exact route."""
    jp, pp = _prepare_both(clouds[name], scorer="mxu", **CLOUDS[name][1])
    np.testing.assert_array_equal(pp.aplan.class_of_sc, jp.aplan.class_of_sc)
    np.testing.assert_array_equal(pp.aplan.row_of_sc, jp.aplan.row_of_sc)
    assert ([(c.n_sc, c.radius, c.qcap, c.ccap, c.route == "mxu")
             for c in pp.aplan.classes]
            == [(c.n_sc, c.radius, c.qcap, c.ccap, c.route == "mxu")
                for c in jp.aplan.classes])
    for c in pp.aplan.classes:
        assert (c.route == "mxu") == ps.class_eligible(c.qcap, c.ccap) \
            == jeligible(c.qcap, c.ccap)
        assert (c.own is not None) == (c.route == "mxu")
    routes = {c.route for c in pp.aplan.classes}
    assert "mxu" in routes
    assert (routes != {"mxu"}) == (name == "blob")


def test_fold_math_matches_jax_on_grid_shapes(clouds):
    """mxu/topk.py's fold parameters on every class of the clouds above,
    at k = 10 and 50 and recall targets 1.0, 0.9 and 0.6."""
    for name, (_, kw) in CLOUDS.items():
        jp, pp = _prepare_both(clouds[name], scorer="mxu", **kw)
        for cp in pp.aplan.classes:
            g = cp.ccap // ptk.BLOCK
            np.testing.assert_array_equal(ptk.interleave_slots(cp.ccap),
                                          jtopk.interleave_slots(cp.ccap))
            for k in (10, 50):
                for rt in (1.0, 0.9, 0.6):
                    m = ptk.per_block_m(rt, k, g)
                    assert m == jtopk.per_block_m(rt, k, g)
                    assert ptk.bins_for(rt, k) == jtopk.bins_for(rt, k)
                    assert ptk.recall_bound(k, g, m) == \
                        jtopk.recall_bound(k, g, m)
    qn = (np.random.default_rng(5).random(64) * 3e6).astype(np.float32)
    for prec in ("f32", "bf16"):
        want = np.asarray(jtopk.dot_error_bound(jnp.asarray(qn),
                                                jnp.float32(2.5e6), 3, prec))
        got = ptk.dot_error_bound(torch.as_tensor(qn),
                                  torch.tensor(2.5e6), 3, prec).numpy()
        np.testing.assert_array_equal(got, want)


# -- (ii) the class function --------------------------------------------------

@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("rt", [1.0, 0.6])
@pytest.mark.parametrize("name", ["blue", "clustered-r1"])
def test_grid_class_topk_matches_jax(clouds, name, rt, prec):
    """Every 'mxu' class: the uncertified (NaN) masks equal JAX's but on
    rows decided within float32 rounding, and rows certified in both agree
    tie-aware.  At 0.6 the clustered cloud has a fold that is not
    exhaustive (m < min(k, 128))."""
    kw = dict(CLOUDS[name][1], scorer="mxu", recall_target=rt,
              precision=prec)
    pts = clouds[name]
    pp = pt.KnnProblem.prepare(pts, pt.KnnConfig(**kw), device="cpu")
    g, k = pp.grid, pp.config.k
    jargs = [jnp.asarray(a.numpy()) for a in (g.points, g.cell_starts,
                                              g.cell_counts)]
    pts_s = g.points.numpy()
    ms = []
    for cp in _mxu_classes(pp):
        ms.append(ptk.per_block_m(rt, k, cp.ccap // ptk.BLOCK))
        pd, pi = ps.grid_class_topk(g.points, g.cell_starts, g.cell_counts,
                                    cp.own, cp.cand, cp.qcap, k, cp.ccap,
                                    True, rt, prec)
        jd, _ = jgrid(*jargs, jnp.asarray(cp.own.numpy()),
                      jnp.asarray(cp.cand.numpy()), cp.qcap, k, cp.ccap,
                      True, rt, prec)
        pd, pi, jd = pd.numpy(), pi.numpy(), np.asarray(jd)
        real = (cp.qid >= 0).reshape(-1).numpy()
        pn = np.isnan(pd[:, k - 1]) & real
        jn = np.isnan(jd[:, k - 1]) & real
        _assert_borderline(pp, cp, np.nonzero(pn != jn)[0], rt, prec)
        both = real & ~pn & ~jn
        q = pts_s[cp.qid.reshape(-1).clamp(min=0).numpy()]
        bad = check_route_result(pts_s, q[both], pi[both], pd[both],
                                 jd[both], k)
        assert bad is None, bad.render()
        assert not np.isnan(pd[~real]).any()
    if name == "clustered-r1" and rt < 1.0:
        assert min(ms) < min(k, ptk.BLOCK)


# -- (iii)-(v) end to end -----------------------------------------------------

def _solve(pts, kw):
    p = pt.KnnProblem.prepare(pts, pt.KnnConfig(**kw), device="cpu")
    return p, p.solve()


@pytest.mark.parametrize("name", ["blue", "clustered-r1"])
def test_mxu_solve_equals_elementwise_and_jax(clouds, name):
    """f32 at recall_target=1.0: ids and d2 equal to the port's
    elementwise solve, and tie-aware equal to JAX's mxu solve, within two
    host round trips."""
    from cuda_knearests_tpu_torch.runtime import dispatch

    pts, kw = clouds[name], CLOUDS[name][1]
    pe, re_ = _solve(pts, kw)
    pm = pt.KnnProblem.prepare(pts, pt.KnnConfig(scorer="mxu", **kw),
                               device="cpu")
    dispatch.reset_stats()
    rm = pm.solve()
    assert dispatch.stats().host_syncs <= dispatch.SYNC_BUDGET
    assert _mxu_classes(pm)
    np.testing.assert_array_equal(rm.neighbors, re_.neighbors)
    np.testing.assert_array_equal(rm.dists_sq, re_.dists_sq)
    assert rm.certified.all()
    jp = ck.KnnProblem.prepare(pts, ck.KnnConfig(scorer="mxu", **kw))
    jr = jp.solve()
    pts_s = pm.get_points()
    bad = check_route_result(pts_s, pts_s, rm.neighbors, rm.dists_sq,
                             np.asarray(jr.dists_sq), kw["k"])
    assert bad is None, bad.render()


@pytest.mark.parametrize("rt,prec", [(0.9, "f32"), (1.0, "bf16"),
                                     (0.9, "bf16")])
@pytest.mark.parametrize("name", ["blue", "clustered-r1"])
def test_approximate_tiers_with_fallback_are_exact(clouds, name, rt, prec):
    """recall_target < 1 and bf16 with fallback='brute': the exact
    fallback closes every row the fold or the box margin leaves open, so
    the answer equals the elementwise solve."""
    pts, kw = clouds[name], CLOUDS[name][1]
    _, re_ = _solve(pts, kw)
    pm, rm = _solve(pts, dict(kw, recall_target=rt, precision=prec))
    assert _mxu_classes(pm)
    np.testing.assert_array_equal(rm.neighbors, re_.neighbors)
    np.testing.assert_array_equal(rm.dists_sq, re_.dists_sq)
    assert rm.certified.all()


@pytest.mark.parametrize("name", ["blue", "clustered-r1"])
def test_fallback_none_matches_jax(clouds, name):
    """recall_target=0.6, fallback='none': the rows the fold left
    uncertified carry (-1, inf) at column k-1 where JAX's do (but on rows
    decided within float32 rounding), and the other rows agree with
    JAX's tie-aware."""
    pts, kw = clouds[name], CLOUDS[name][1]
    kw = dict(kw, recall_target=0.6, fallback="none")
    k = kw["k"]
    jp, pp = _prepare_both(pts, **kw)
    jr = jp._finalize(jsolve(jp.grid, jp.config, jp.aplan))
    pr = pp.solve()
    p_open = np.asarray(pr.neighbors)[:, k - 1] < 0
    j_open = np.asarray(jr.neighbors)[:, k - 1] < 0
    assert p_open.any()
    assert np.isinf(np.asarray(pr.dists_sq)[p_open, k - 1]).all()
    slot_of = {}
    for cp in _mxu_classes(pp):
        qid = cp.qid.reshape(-1).numpy()
        for r in np.nonzero(qid >= 0)[0]:
            slot_of[int(qid[r])] = (cp, int(r))
    for point in np.nonzero(p_open != j_open)[0]:
        cp, r = slot_of[int(point)]
        _assert_borderline(pp, cp, [r], 0.6, "f32")
    both = ~p_open & ~j_open
    pts_s = pp.get_points()
    bad = check_route_result(pts_s, pts_s[both],
                             np.asarray(pr.neighbors)[both],
                             np.asarray(pr.dists_sq)[both],
                             np.asarray(jr.dists_sq)[both], k)
    assert bad is None, bad.render()


# -- (vi) queries -------------------------------------------------------------

@pytest.mark.parametrize("name", ["blue", "clustered-r1"])
def test_queries_on_mxu_plan_equal_elementwise(clouds, name, monkeypatch):
    """External queries of an mxu-planned problem take each class's exact
    route (the kernel on a pack built for the call, or streamed where the
    kernel's gate refuses the class) and answer what the elementwise plan
    answers."""
    pts, kw = clouds[name], CLOUDS[name][1]
    q = generate_uniform(600, seed=41)
    pe = pt.KnnProblem.prepare(pts, pt.KnnConfig(**kw), device="cpu")
    pm = pt.KnnProblem.prepare(pts, pt.KnnConfig(scorer="mxu",
                                                 recall_target=0.6, **kw),
                               device="cpu")
    want = pe.query(q)
    qcls, qrow = padapt.bucket_queries(pm.grid, pm.config, pm.aplan, q)
    buckets = padapt.plan_queries(pm.config, pm.aplan, qcls, qrow, kw["k"],
                                  None)
    assert {b.route for b in buckets} == {"kernel"}
    got = pm.query(q)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # where the class kernel's gate refuses the class, its queries stream
    monkeypatch.setattr(padapt, "class_route", lambda *a: "streamed")
    buckets = padapt.plan_queries(pm.config, pm.aplan, qcls, qrow, kw["k"],
                                  None)
    assert {b.route for b in buckets} == {"streamed"}
    got = pm.query(q)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


# -- (vii) the recall oracle --------------------------------------------------

def test_measure_matches_jax():
    """mxu/measure.py returns what the reference's returns on the same
    arrays, band-free and at the declared band of either tier."""
    rng = np.random.default_rng(11)
    pts = generate_clustered(1500, seed=9)
    q = generate_uniform(300, seed=10)
    k = 8
    nb = rng.integers(-1, pts.shape[0], (pts.shape[0], k)).astype(np.int32)
    nq = rng.integers(-1, pts.shape[0], (q.shape[0], k)).astype(np.int32)
    for prec in ("f32", "bf16"):
        for queries in (None, q):
            np.testing.assert_array_equal(
                pmeasure.declared_band(pts, queries, prec),
                jmeasure.declared_band(pts, queries, prec))
    for kw in (dict(), dict(queries=q), dict(exclude_self=False),
               dict(queries=q, exclude=np.arange(300) * 5)):
        for a, b in zip(pmeasure.f64_kth(pts, k, **kw),
                        jmeasure.f64_kth(pts, k, **kw)):
            np.testing.assert_array_equal(a, b)
    kth, _ = jmeasure.f64_kth(pts, k)
    band = jmeasure.declared_band(pts, precision="bf16")
    for b in (None, band):
        np.testing.assert_array_equal(pmeasure.row_hits(pts, nb, kth, b),
                                      jmeasure.row_hits(pts, nb, kth, b))
        assert pmeasure.measured_recall(pts, nb, k, band=b) == \
            jmeasure.measured_recall(pts, nb, k, band=b)
    assert pmeasure.measured_recall(pts, nq, k, queries=q,
                                    exclude_self=False) == \
        jmeasure.measured_recall(pts, nq, k, queries=q, exclude_self=False)
    rows = np.arange(0, pts.shape[0], 7)
    assert pmeasure.certified_recall(pts, nb, rows, k) == \
        jmeasure.certified_recall(pts, nb, rows, k)


# -- (viii) the brute route's smoke -------------------------------------------

def test_mxu_smoke_main_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT), KNTPU_MXU_SMOKE_N="2000",
               OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "cuda_knearests_tpu_torch.mxu", "--device",
         "cpu"], cwd=str(ROOT), env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rows = [json.loads(line) for line in proc.stdout.splitlines()]
    assert [r["check"] for r in rows] == ["byte-identity", "recall-bound",
                                          "general-d"]
    assert all(r["ok"] for r in rows) and rows[0]["n"] == 2000


# -- a JAX checkpoint of an mxu problem ---------------------------------------

def test_jax_checkpoint_with_mxu_config_loads_and_solves(clouds, tmp_path):
    """load_problem of a JAX checkpoint whose config carries scorer='mxu',
    recall_target and precision: the same config, an mxu plan, and the
    solve of a problem prepared here from the same cloud, tie-aware equal
    to JAX's."""
    pts = clouds["blue"]
    kw = dict(k=10, scorer="mxu", recall_target=0.9, precision="bf16")
    jp = ck.KnnProblem.prepare(pts, ck.KnnConfig(**kw))
    path = str(tmp_path / "mxu")
    ck.save_problem(jp, path)
    loaded = pt.load_problem(path, device="cpu")
    assert loaded.config == pt.KnnConfig(**kw)
    assert _mxu_classes(loaded)
    got = loaded.solve()
    _, want = _solve(pts, kw)
    np.testing.assert_array_equal(got.neighbors, want.neighbors)
    np.testing.assert_array_equal(got.dists_sq, want.dists_sq)
    jr = jp.solve()
    pts_s = loaded.get_points()
    bad = check_route_result(pts_s, pts_s, got.neighbors, got.dists_sq,
                             np.asarray(jr.dists_sq), kw["k"])
    assert bad is None, bad.render()
