"""The PyTorch port's slice end to end against the JAX package: prepare,
solve (kernel route + certificate + exact fallback), results, the state
carried across through the JAX package's checkpoint, the exact top-k
utilities, and the no-silent-CPU rule of the entry points.

The JAX side runs as its own tests run it on the CPU: the Pallas kernel in
interpret mode (``KnnConfig(interpret=True)``).  Rows are compared with the
reference's tie-aware comparator; d2 may differ by an ulp between the
packages because XLA's CPU backend contracts multiply-adds.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import cuda_knearests_tpu as ck
from cuda_knearests_tpu.fuzz.compare import ATOL, RTOL, check_route_result
from cuda_knearests_tpu.io import generate_blue_noise, generate_clustered
from cuda_knearests_tpu.ops.adaptive import solve_adaptive as jsolve
import cuda_knearests_tpu_torch as pt
from cuda_knearests_tpu_torch.ops import topk as ptopk
from cuda_knearests_tpu_torch.ops.adaptive import solve_adaptive as psolve
from cuda_knearests_tpu_torch.ops.solve import _margin_sq
from cuda_knearests_tpu_torch.runtime import dispatch
from cuda_knearests_tpu_torch.utils.memory import (InvalidConfigError,
                                                   NoDeviceError)

SLICE_CASES = {
    "blue-k10": (lambda: generate_blue_noise(3000, seed=1), dict(k=10)),
    "blue-k50": (lambda: generate_blue_noise(3000, seed=2), dict(k=50)),
    "clustered-fallback": (lambda: generate_clustered(6000, seed=3),
                           dict(k=10, ring_radius=1)),
}


@pytest.fixture(scope="module")
def solved():
    """Both packages' raw and finalized solves of every slice case."""
    out = {}
    for name, (make, kw) in SLICE_CASES.items():
        pts = make()
        jp = ck.KnnProblem.prepare(pts, ck.KnnConfig(interpret=True, **kw))
        j_raw = jsolve(jp.grid, jp.config, jp.aplan)
        j_cert = np.asarray(j_raw.certified)
        j_fin = jp._finalize(j_raw)
        pp = pt.KnnProblem.prepare(pts, pt.KnnConfig(**kw), device="cpu")
        p_cert = psolve(pp.grid, pp.config, pp.aplan).certified.numpy()
        dispatch.reset_stats()
        p_fin = pp.solve()
        syncs = dispatch.stats().host_syncs
        out[name] = dict(pts=pts, kw=kw, jp=jp, j_cert=j_cert, j_fin=j_fin,
                         pp=pp, p_cert=p_cert, p_fin=p_fin, syncs=syncs)
    return out


@pytest.mark.parametrize("case", sorted(SLICE_CASES))
def test_slice_matches_jax(solved, case):
    c = solved[case]
    k = c["kw"]["k"]
    pts_sorted = np.asarray(c["jp"].grid.points)
    np.testing.assert_array_equal(c["pp"].get_points(), pts_sorted)
    j, p = c["j_fin"], c["p_fin"]
    bad = check_route_result(pts_sorted, pts_sorted, p.neighbors, p.dists_sq,
                             np.asarray(j.dists_sq), k)
    assert bad is None, bad.render()
    assert p.certified.all()
    assert int(p.uncert_count) == int(j.uncert_count)
    assert c["syncs"] <= dispatch.SYNC_BUDGET
    if case == "clustered-fallback":
        assert len(c["pp"].aplan.classes) == 2 and int(p.uncert_count) > 0
        assert c["syncs"] == 2
    # original-indexing rows are the sorted rows un-permuted
    perm = c["pp"].get_permutation()
    orig = c["pp"].get_knearests_original()
    np.testing.assert_array_equal(orig[perm], perm[p.neighbors])


@pytest.mark.parametrize("case", sorted(SLICE_CASES))
def test_certificates_match_jax(solved, case):
    c = solved[case]
    k = c["kw"]["k"]
    differ = np.nonzero(c["p_cert"] != c["j_cert"])[0]
    if differ.size:
        # allowed only where the k-th distance sits in the comparator's
        # band around the margin (an ulp of FMA decides the certificate)
        pp = c["pp"]
        inv = pp.aplan.inv_box.long()
        lo = torch.cat([cp.lo for cp in pp.aplan.classes])[inv]
        hi = torch.cat([cp.hi for cp in pp.aplan.classes])[inv]
        margin = _margin_sq(pp.grid.points, lo, hi, pp.grid.domain).numpy()
        kth = np.asarray(c["p_fin"].dists_sq)[:, k - 1]
        assert np.allclose(kth[differ], margin[differ], rtol=RTOL, atol=ATOL)
    assert int((~c["p_cert"]).sum()) == int((~c["j_cert"]).sum())


def test_state_carried_across_from_jax_checkpoint(solved, tmp_path):
    c = solved["clustered-fallback"]
    path = str(tmp_path / "grid.npz")
    ck.save_problem(c["jp"], path)
    loaded = pt.load_problem(path, device="cpu")
    assert loaded.config == c["pp"].config
    for name in ("points", "permutation", "cell_starts", "cell_counts"):
        assert torch.equal(getattr(loaded.grid, name),
                           getattr(c["pp"].grid, name)), name
    res = loaded.solve()
    np.testing.assert_array_equal(res.neighbors, c["p_fin"].neighbors)
    np.testing.assert_array_equal(res.dists_sq, c["p_fin"].dists_sq)
    np.testing.assert_array_equal(loaded.get_knearests_original(),
                                  c["pp"].get_knearests_original())


def test_load_problem_refuses_unknown_config_fields(tmp_path):
    jp = ck.KnnProblem.prepare(generate_blue_noise(500, seed=4),
                               ck.KnnConfig(k=5))
    path = str(tmp_path / "grid")
    ck.save_problem(jp, path)
    loaded = pt.load_problem(path, device="cpu")
    assert loaded.config.k == 5
    # a field no KnnConfig has, and a value of a known field the port
    # does not know
    with np.load(path + ".npz") as z:
        arrays = dict(z)
    for extra, match in (({"warp_drive": 9}, "warp_drive"),
                         ({"backend": "tpu"}, "backend")):
        saved = dict(json.loads(bytes(arrays["config_json"]).decode()),
                     **extra)
        np.savez_compressed(path, **dict(arrays, config_json=np.bytes_(
            json.dumps(saved).encode())))
        with pytest.raises(InvalidConfigError, match=match):
            pt.load_problem(path, device="cpu")
    # backend='oracle' now reads back, on its own route
    ck.save_problem(dataclasses.replace(
        jp, config=ck.KnnConfig(k=5, backend="oracle")), path)
    assert pt.load_problem(path, device="cpu")._route_name() == "oracle"


def test_knn_and_degraded_modes_match_jax():
    pts = generate_blue_noise(400, seed=9)
    np.testing.assert_array_equal(
        pt.knn(pts, k=6, device="cpu"),
        ck.knn(pts, k=6, config=ck.KnnConfig(interpret=True)))
    # k > n pads -1/inf; n = 0 solves to empty rows
    few = pts[:4]
    prob = pt.KnnProblem.prepare(few, pt.KnnConfig(k=6), device="cpu")
    prob.solve()
    assert (prob.get_knearests()[:, 3:] == -1).all()
    assert np.isinf(prob.get_dists_sq()[:, 3:]).all()
    empty = pt.KnnProblem.prepare(np.zeros((0, 3)), pt.KnnConfig(k=3),
                                  device="cpu")
    assert empty.solve().neighbors.shape == (0, 3)
    assert empty.get_knearests_original().shape == (0, 3)


def test_brute_force_matches_jax(monkeypatch):
    from cuda_knearests_tpu_torch.ops import solve as psolve_mod

    pts = generate_clustered(3000, seed=1)
    jg = ck.build_grid(pts)
    q_idx = np.array([0, 5, 17, -1, 2999, 1500, -1, 42], np.int32)
    for excl in (True, False):
        ji, jd = ck.brute_force_by_index(jg.points, q_idx, 12, excl,
                                         tile=1024)
        pi, pd = pt.brute_force_by_index(torch.tensor(np.array(jg.points)),
                                         torch.tensor(q_idx), 12, excl,
                                         tile=1024)
        np.testing.assert_array_equal(pi.numpy() < 0, np.asarray(ji) < 0)
        ok = q_idx >= 0
        pts_s = np.asarray(jg.points)
        bad = check_route_result(pts_s, pts_s[q_idx[ok]], pi.numpy()[ok],
                                 pd.numpy()[ok], np.asarray(jd)[ok], 12)
        assert bad is None, bad.render()
        # query-row chunks of 3 rows give the same rows
        monkeypatch.setattr(psolve_mod, "_BRUTE_CHUNK_PAIRS", 3 * 1024)
        ci, cd = pt.brute_force_by_index(torch.tensor(np.array(jg.points)),
                                         torch.tensor(q_idx), 12, excl,
                                         tile=1024)
        monkeypatch.undo()
        assert torch.equal(ci, pi) and torch.equal(cd, pd)


def test_topk_keys_order_lexicographically():
    d2 = torch.tensor([[3.0, 1.0, 1.0, float("inf"), 0.0, 1.0]])
    ids = torch.tensor([[4, 9, 2, 1, 7, 5]], dtype=torch.int32)
    mask = torch.tensor([[True, True, True, True, True, False]])
    key = ptopk.smallest_keys(ptopk.pack_key(d2, ids, mask), 6)
    d, i = ptopk.unpack_key(key)
    assert i.tolist() == [[7, 2, 9, 4, -1, -1]]
    assert d.tolist() == [[0.0, 1.0, 1.0, 3.0, float("inf"), float("inf")]]


REFUSED = [dict(scorer="bogus"), dict(recall_target=1.5),
           dict(backend="tpu"), dict(kernel="fast"),
           dict(precision="bf16", scorer="elementwise"),
           dict(plane_feed="yes"), dict(adaptive="yes"),
           dict(dist_method="cosine"), dict(fallback="maybe")]
# The scorer knobs construct and are refused when a problem is prepared,
# as the reference refuses them (it refuses bf16 with the elementwise
# scorer later, at solve).
SCORER_KNOBS = ("scorer", "recall_target", "precision")


@pytest.mark.parametrize("kw", REFUSED, ids=[next(iter(r)) for r in REFUSED])
def test_unsupported_config_is_refused(kw):
    if next(iter(kw)) not in SCORER_KNOBS:
        with pytest.raises(InvalidConfigError):
            pt.KnnConfig(**kw)
        return
    pts = generate_blue_noise(200, seed=3)
    with pytest.raises(ValueError) as want:
        ck.KnnProblem.prepare(pts, ck.KnnConfig(k=4, **kw)).solve()
    cfg = pt.KnnConfig(k=4, **kw)
    with pytest.raises(ValueError) as got:
        pt.KnnProblem.prepare(pts, cfg, device="cpu")
    assert type(got.value) is type(want.value) is ValueError
    assert str(got.value) == str(want.value)


def test_entry_points_refuse_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = generate_blue_noise(200, seed=3)
    with pytest.raises(NoDeviceError):
        pt.KnnProblem.prepare(pts)
    with pytest.raises(NoDeviceError):
        pt.knn(pts, k=4)
    with pytest.raises(NoDeviceError):
        pt.KnnProblem.prepare(pts, device="cuda")
    path = str(tmp_path / "g.npz")
    ck.save_problem(ck.KnnProblem.prepare(pts, ck.KnnConfig(k=4)), path)
    with pytest.raises(NoDeviceError):
        pt.load_problem(path)


def test_plan_over_device_budget_is_refused(monkeypatch):
    from cuda_knearests_tpu_torch.ops import adaptive
    from cuda_knearests_tpu_torch.utils.memory import LaunchBudgetError

    pts = generate_blue_noise(20_000, seed=1)
    cfg = pt.KnnConfig(k=10, supercell=2)
    free = pt.KnnProblem.prepare(pts, cfg, device="cpu")
    (cp,) = free.aplan.classes
    _, specs = adaptive.plan_class_specs(free.grid.cell_counts.numpy(),
                                         free.grid.dim, cfg)
    need = adaptive.streamed_plan_bytes(specs, cfg, free.grid.n_points)
    pack = adaptive.pack_bytes(cp.n_sc, cp.qcap, cp.ccap)
    extra = adaptive.kernel_extra_bytes(specs[0], cfg)
    assert need < pack  # the streamed route holds budgets around the packs
    want = free.solve().neighbors
    # a plan whose packs and outputs exceed the budget streams its class
    # and answers, on either side of the packs; with room for both it
    # keeps the kernel
    for budget, route in ((need, "streamed"), (pack - 1, "streamed"),
                          (pack + 1, "streamed"), (need + extra, "kernel")):
        monkeypatch.setattr(adaptive, "hbm_budget_bytes",
                            lambda device, cfg=None: budget)
        p = pt.KnnProblem.prepare(pts, cfg, device="cpu")
        assert [c.route for c in p.aplan.classes] == [route], budget
        np.testing.assert_array_equal(p.solve().neighbors, want)
    # only a plan that no route can hold is refused: below what the plan
    # needs with its class streamed one supercell a step
    for budget in (need - 1, 10_000):
        monkeypatch.setattr(adaptive, "hbm_budget_bytes",
                            lambda device, cfg=None: budget)
        with pytest.raises(LaunchBudgetError,
                           match="no route can hold") as e:
            pt.KnnProblem.prepare(pts, cfg, device="cpu")
        assert e.value.kind == "oom" and e.value.requested > e.value.budget
