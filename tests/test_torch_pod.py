"""PyTorch port of the pod (cell-partitioned index) against the JAX package,
on the CPU.

JAX runs its pod on the emulated CPU devices of ``tests/conftest.py``; the
port runs the same chip counts as ``devices=['cpu'] * N`` (chips sharing
one device).  The plan -- directory, meta, every chip's window layout,
export block and class tables -- must be equal to JAX's ``build_pod_plan``
exactly.  Rows are held tie-aware (``fuzz/compare``, RTOL 1e-4 / ATOL
1e-2: XLA's CPU backend contracts multiply-adds, torch does not) to JAX's
pod and to the kd-tree, and bit for bit to the port's single-device solve
on rows both certify.  The memory budget cases are relational, as in the
reference's ``tests/test_pod.py``.
"""

import glob
import os

import numpy as np
import pytest
import torch

import cuda_knearests_tpu as ck
from cuda_knearests_tpu.config import grid_dim_for as jax_grid_dim_for
from cuda_knearests_tpu.fuzz import CORPUS_DIR
from cuda_knearests_tpu.io import generate_uniform
from cuda_knearests_tpu.pod import PodKnnProblem as JaxPod
from cuda_knearests_tpu.pod import partition as jpart
import cuda_knearests_tpu_torch as pt
from cuda_knearests_tpu_torch.fuzz.compare import check_route_result
from cuda_knearests_tpu_torch.ops.adaptive import solve_adaptive
from cuda_knearests_tpu_torch.oracle import KdTreeOracle
from cuda_knearests_tpu_torch.pod import PodKnnProblem
from cuda_knearests_tpu_torch.pod import partition as ppart
from cuda_knearests_tpu_torch.pod.stream import (chip_floor_bytes,
                                                 chip_hbm_model)
from cuda_knearests_tpu_torch.runtime import dispatch
from cuda_knearests_tpu_torch.utils.memory import (InvalidConfigError,
                                                   InvalidKError,
                                                   LaunchBudgetError,
                                                   NoDeviceError)

NDEV = 4
K = 8
CPU4 = ["cpu"] * NDEV


def _pod(points, ndev=NDEV, **kw):
    return PodKnnProblem.prepare(points, config=pt.KnnConfig(**kw),
                                 devices=["cpu"] * ndev)


def _tie_aware(points, ids, d2, ref_d2, k, queries=None):
    q = points if queries is None else queries
    bad = check_route_result(points, q, ids, d2, ref_d2, k)
    assert bad is None, bad.render()


@pytest.fixture(scope="module")
def uniform():
    return generate_uniform(2_500, seed=5)


@pytest.fixture(scope="module")
def oracle_rows(uniform):
    return KdTreeOracle(uniform).knn_all_points(K)


@pytest.fixture(scope="module")
def pod(uniform):
    return _pod(uniform, k=K)


@pytest.fixture(scope="module")
def jax_pod(uniform):
    return JaxPod.prepare(uniform, n_devices=NDEV, config=ck.KnnConfig(k=K))


def _plans(points, ndev, **kw):
    dim = jax_grid_dim_for(points.shape[0], ck.KnnConfig().density)
    return (jpart.build_pod_plan(points, ndev, ck.KnnConfig(**kw), dim,
                                 False),
            ppart.build_pod_plan(points, ndev, pt.KnnConfig(**kw), dim,
                                 True))


# -- the plan, exactly ----------------------------------------------------------

PLAN_CASES = {
    "uniform-4": (lambda: generate_uniform(2_500, seed=5), 4, {"k": K}),
    "uniform-3-ring2": (lambda: generate_uniform(2_500, seed=5), 3,
                        {"k": K, "ring_radius": 2}),
    "uniform-2-s2": (lambda: generate_uniform(1_500, seed=9), 2,
                     {"k": 4, "supercell": 2}),
    "clustered-4": (lambda: np.clip(
        450.0 + 60.0 * np.random.default_rng(5).standard_normal((2_000, 3)),
        0.0, 1000.0).astype(np.float32), 4, {"k": 6}),
}


@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_plan_equal_to_jax(name):
    make, ndev, kw = PLAN_CASES[name]
    pts = make()
    want, got = _plans(pts, ndev, **kw)
    for a in ("order", "rank_of", "bounds"):
        np.testing.assert_array_equal(getattr(got.directory, a),
                                      getattr(want.directory, a))
    for a in ("ndev", "dim", "supercell", "pcap", "hcap", "steps"):
        assert getattr(got.meta, a) == getattr(want.meta, a), a
    assert got.meta.n_ext == want.meta.n_ext
    assert got.meta.halo_bytes() == want.meta.halo_bytes()
    for d, (cj, cp) in enumerate(zip(want.chips, got.chips)):
        for a in ("sc_ids", "ext_starts", "ext_counts", "export_idx",
                  "export_cells", "class_of", "row_of"):
            np.testing.assert_array_equal(getattr(cp, a), getattr(cj, a),
                                          err_msg=f"chip {d} {a}")
        for a in ("n_local", "remote_cells", "max_owner_dist"):
            assert getattr(cp, a) == getattr(cj, a), (d, a)
        assert len(cp.classes) == len(cj.classes)
        for x, y in zip(cj.classes, cp.classes):
            assert (y.radius, y.qcap, y.ccap) == (x.radius, x.qcap, x.ccap)
            for a in ("own", "cand", "lo", "hi"):
                np.testing.assert_array_equal(getattr(y, a),
                                              np.asarray(getattr(x, a)))
    np.testing.assert_array_equal(got.bucket_ids, want.bucket_ids)
    real = want.bucket_ids >= 0
    np.testing.assert_array_equal(got.bucket_pts[real],
                                  want.bucket_pts[real])
    np.testing.assert_array_equal(got.chip_of_point, want.chip_of_point)


def test_cell_tables_and_morton_equal_to_jax():
    rng = np.random.default_rng(2)
    coords = rng.integers(0, 900, (500, 3))
    np.testing.assert_array_equal(ppart.morton3(coords),
                                  jpart.morton3(coords))
    sc = rng.integers(0, 12, (40, 3)).astype(np.int32)
    np.testing.assert_array_equal(ppart._sc_cells(sc, 3, 35),
                                  jpart._sc_cells(sc, 3, 35))
    np.testing.assert_array_equal(ppart._box_cells(sc, 2, 3, 35),
                                  jpart._box_cells(sc, 2, 3, 35))


def test_route_queries_equal_to_jax(pod, jax_pod):
    q = generate_uniform(300, seed=11)
    got = ppart.route_queries(pod.directory, pod.meta, q)
    want = jpart.route_queries(jax_pod.directory, jax_pod.meta, q)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_prepare_equals_jax_prepare(pod, jax_pod):
    assert pod.meta.steps >= 1 and pod.meta.ndev == NDEV
    for a in ("pcap", "hcap", "steps", "dim"):
        assert getattr(pod.meta, a) == getattr(jax_pod.meta, a)
    np.testing.assert_array_equal(pod._bucket_ids_host,
                                  jax_pod._bucket_ids_host)
    np.testing.assert_array_equal(pod._chip_of_point,
                                  jax_pod._chip_of_point)
    assert set(pod.stats()) == set(jax_pod.stats())
    assert ([c["n_points"] for c in pod.stats()["chips"]]
            == [c["n_points"] for c in jax_pod.stats()["chips"]])


def test_exchange_window_equals_jax(pod, jax_pod):
    """Every received block equals JAX's ppermute output on its real rows
    (JAX pads at 1e30 and hands an edge chip zeros; the port pads at 0
    with id -1)."""
    pod.solve()
    jax_pod.solve()
    for d in range(NDEV):
        h_pts, h_ids = (t.numpy() for t in pod._halo[d])
        j_pts = np.asarray(jax_pod._chip_inputs(d)["halo_pts"])
        j_ids = np.asarray(jax_pod._chip_inputs(d)["halo_ids"])
        assert h_pts.shape == j_pts.shape
        real = h_ids >= 0
        np.testing.assert_array_equal(h_ids[real], j_ids[real])
        np.testing.assert_array_equal(h_pts[real], j_pts[real])
        assert (h_pts[~real] == 0.0).all()
        window = pod._chip_ready(d).window
        assert window.n_points == pod.meta.n_ext


# -- rows -----------------------------------------------------------------------

def test_solve_tie_aware_to_jax_and_oracle(pod, jax_pod, uniform,
                                           oracle_rows):
    ids, d2, cert = pod.solve()
    assert cert.all()
    _tie_aware(uniform, ids, d2, oracle_rows[1], K)
    _j_ids, j_d2, j_cert = jax_pod.solve()
    assert j_cert.all()
    _tie_aware(uniform, ids, d2, j_d2, K)


def test_solve_equals_single_device_bit_for_bit(pod, uniform):
    ids, d2, _ = pod.solve()
    cfg = pt.KnnConfig(k=K)
    single = pt.KnnProblem.prepare(uniform, cfg, device="cpu")
    single.solve()
    perm = single.get_permutation()
    s_d2 = np.empty_like(single.get_dists_sq())
    s_d2[perm] = single.get_dists_sq()
    s_cert = np.empty((uniform.shape[0],), bool)
    s_cert[perm] = solve_adaptive(single.grid, cfg,
                                  single.aplan).certified.numpy()
    both = s_cert.copy()
    both[pod.fallback_rows] = False
    assert both.mean() > 0.9
    np.testing.assert_array_equal(d2[both], s_d2[both])
    _tie_aware(uniform, ids, d2, s_d2, K)


def test_boundary_straddling_queries(pod, jax_pod, uniform):
    rng = np.random.default_rng(3)
    q = np.clip(uniform[rng.integers(0, uniform.shape[0], 256)]
                + rng.normal(0, 2.0, (256, 3)).astype(np.float32),
                0.0, 1000.0).astype(np.float32)
    qi, qd = pod.query(q)
    _ri, rd = KdTreeOracle(uniform).knn(q, K)
    _tie_aware(uniform, qi, qd, rd, K, q)
    _ji, jd = jax_pod.query(q)
    _tie_aware(uniform, qi, qd, jd, K, q)
    qi4, qd4 = pod.query(q, k=4)
    _tie_aware(uniform, qi4, qd4, rd[:, :4], 4, q)
    with pytest.raises(InvalidKError):
        pod.query(q, k=9)


@pytest.mark.parametrize("rt", (0.9, 1.0))
def test_mxu_tier_composes(uniform, oracle_rows, rt):
    pm = _pod(uniform, k=K, scorer="mxu", recall_target=rt)
    routes = [cp.route for c in pm.chip_plans for cp in c.classes]
    assert "mxu" in routes, routes
    ids, d2, cert = pm.solve()
    assert cert.all()
    _tie_aware(uniform, ids, d2, oracle_rows[1], K)


def test_gather_equals_scatter(pod, uniform):
    pg = _pod(uniform, k=K, epilogue="gather")
    want, got = pod.solve_device(), pg.solve_device()
    for d in range(NDEV):
        for a, b in zip(got[d], want[d]):
            assert torch.equal(a, b)


def test_xla_backend_streams_every_class(uniform, oracle_rows):
    px = _pod(uniform, k=K, backend="xla")
    assert {cp.route for c in px.chip_plans for cp in c.classes} \
        == {"streamed"}
    ids, d2, _ = px.solve()
    _tie_aware(uniform, ids, d2, oracle_rows[1], K)


def test_degraded_modes():
    tiny = generate_uniform(5, seed=1)
    ids, d2, cert = _pod(tiny, k=K).solve()
    _tie_aware(tiny, ids, d2, KdTreeOracle(tiny).knn_all_points(K)[1], K)
    assert cert.all()
    pe = _pod(np.empty((0, 3), np.float32), ndev=2, k=4)
    ids0, _d0, cert0 = pe.solve()
    assert ids0.shape == (0, 4) and cert0.shape == (0,)
    qi, qd = pe.query(generate_uniform(7, seed=2))
    assert (qi == -1).all() and np.isinf(qd).all()
    i1, _d1, c1 = _pod(generate_uniform(1, seed=3), ndev=2, k=4).solve()
    assert (i1 == -1).all() and c1.all()


def test_single_chip(uniform, oracle_rows):
    p1 = _pod(uniform, ndev=1, k=K)
    assert p1.meta.steps == 0 and p1.meta.halo_bytes() == 0
    dispatch.reset_stats()
    ids, d2, _ = p1.solve()
    assert dispatch.stats().ici_bytes == 0
    _tie_aware(uniform, ids, d2, oracle_rows[1], K)


def test_refusals(uniform):
    with pytest.raises(InvalidConfigError):
        _pod(uniform, k=K, backend="oracle")
    with pytest.raises(InvalidConfigError):
        _pod(uniform, k=K, scorer="mxu", recall_target=0.9,
             dist_method="dot")


def test_no_device_without_gpu_or_devices(uniform, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoDeviceError):
        PodKnnProblem.prepare(uniform, config=pt.KnnConfig(k=K))


def test_n_devices_takes_a_prefix_of_the_pool(uniform):
    p2 = PodKnnProblem.prepare(uniform, n_devices=2,
                               config=pt.KnnConfig(k=K), devices=CPU4)
    assert p2.meta.ndev == 2 and len(p2.mesh) == 2
    pm = PodKnnProblem.prepare(uniform, config=pt.KnnConfig(k=K),
                               mesh=["cpu"] * 3)
    assert pm.meta.ndev == 3


# -- the memory budget ----------------------------------------------------------

def test_streamed_prepare_under_budget(pod, uniform, oracle_rows):
    high = pod.hbm["hbm_high_water_bytes"]
    full = pod.hbm["hbm_full_cloud_bytes"]
    cfg = pt.KnnConfig(k=K)
    assert high == max(chip_hbm_model(pod.meta, c, cfg)
                       for c in pod.chip_plans)
    budget = (high + full) // 2
    ps = _pod(uniform, k=K, hbm_budget_bytes=budget)
    assert ps.hbm["streamed_prepare"]
    assert ps.hbm["hbm_high_water_bytes"] <= budget < full
    ids, d2, _ = ps.solve()
    _tie_aware(uniform, ids, d2, oracle_rows[1], K)


def _host_high_water(points, ndev, k=K):
    cfg = pt.KnnConfig(k=k)
    plan = ppart.build_pod_plan(
        points, ndev, cfg, pt.config.grid_dim_for(points.shape[0],
                                                  cfg.density), True)
    return max(chip_hbm_model(plan.meta, c, cfg) for c in plan.chips)


def test_budget_refusal_typed(uniform):
    with pytest.raises(LaunchBudgetError) as ei:
        _pod(uniform, ndev=2, k=K, hbm_budget_bytes=max(
            1, _host_high_water(uniform, 2) // 8))
    assert ei.value.kind == "oom" and ei.value.site == "pod-prepare"


def test_chip_floor_is_the_least_budget(uniform, oracle_rows):
    """At the largest chip floor every class of that chip streams and its
    model meets the budget; one byte less is refused."""
    cfg = pt.KnnConfig(k=K)
    plan = ppart.build_pod_plan(
        uniform, 2, cfg, pt.config.grid_dim_for(uniform.shape[0],
                                                cfg.density), True)
    floor = max(chip_floor_bytes(plan.meta, c, cfg) for c in plan.chips)
    with pytest.raises(LaunchBudgetError):
        _pod(uniform, ndev=2, k=K, hbm_budget_bytes=floor - 1)
    pf = _pod(uniform, ndev=2, k=K, hbm_budget_bytes=floor)
    assert pf.hbm["hbm_high_water_bytes"] <= floor
    assert "streamed" in {cp.route for c in pf.chip_plans
                          for cp in c.classes}
    ids, d2, _ = pf.solve()
    _tie_aware(uniform, ids, d2, oracle_rows[1], K)


def test_auto_split_widens():
    """n_devices=None and a budget one chip cannot hold: the auto-splitter
    widens over the pool instead of refusing.  (At 20k points: at 2.5k the
    one-supercell streamed step that every plan reserves outweighs what a
    wider split saves.)"""
    pts = generate_uniform(20_000, seed=5)
    budget = int(_host_high_water(pts, 1) * 0.6)
    pa = PodKnnProblem.prepare(pts, config=pt.KnnConfig(
        k=K, hbm_budget_bytes=budget), devices=CPU4)
    assert pa.meta.ndev > 1
    assert pa.hbm["hbm_high_water_bytes"] <= budget


# -- counters -------------------------------------------------------------------

def test_solve_round_trips_and_ici_bytes(uniform):
    pp = _pod(uniform, k=K)
    dispatch.reset_stats()
    pp.solve()
    first = dispatch.stats()
    assert first.host_syncs == 1
    assert first.ici_bytes == pp.meta.halo_bytes() > 0
    dispatch.reset_stats()
    pp.solve()
    again = dispatch.stats()
    assert again.host_syncs == 1 and again.ici_bytes == 0


def test_query_round_trips(pod):
    q = generate_uniform(300, seed=11)
    pod.solve()
    dispatch.reset_stats()
    pod.query(q)
    assert dispatch.stats().host_syncs <= dispatch.SYNC_BUDGET


# -- the banked pod corpus, read-only ---------------------------------------------

def _corpus():
    return sorted(glob.glob(os.path.join(CORPUS_DIR, "*-pod.npz")))


@pytest.mark.parametrize("path", _corpus(),
                         ids=[os.path.basename(p) for p in _corpus()])
def test_pod_corpus_replays_clean(path):
    with np.load(path) as z:
        points = np.asarray(z["points"], np.float32)
        k, ndev = int(z["k"]), int(z["ndev"])
    pp = PodKnnProblem.prepare(points, config=pt.KnnConfig(k=k),
                               devices=["cpu"] * ndev)
    ids, d2, _cert = pp.solve()
    _ref_i, ref_d2 = KdTreeOracle(points).knn_all_points(k)
    _tie_aware(points, ids, d2, ref_d2, k)
