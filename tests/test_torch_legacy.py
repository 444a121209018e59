"""The legacy single-schedule route, the gather epilogue, the legacy
query pipeline, the memory budget knob, the oracle backend and the stats
of the PyTorch port, against the JAX package.

The same seeded inputs go through both packages.  The JAX side runs its
kernel route in interpret mode (``interpret=True``), as its own
``tests/test_epilogue.py`` and ``tests/test_dispatch.py`` do.  Integer
outputs (the global schedule, the legacy pack's maps, the adaptive
``inv_row``) must be equal; neighbour rows are compared with the
reference's tie-aware comparator (RTOL 1e-4, ATOL 1e-2), because XLA's CPU
backend contracts multiply-adds.  Within the port, gather and scatter
must be equal bit for bit, and every exact route's ids after the fallback
equal the adaptive route's.
"""

import dataclasses
import shutil
import subprocess

import numpy as np
import pytest
import torch

import cuda_knearests_tpu as ck
from cuda_knearests_tpu.fuzz.compare import check_route_result
from cuda_knearests_tpu.io import (generate_blue_noise, generate_clustered,
                                   generate_uniform)
from cuda_knearests_tpu.ops import adaptive as jadaptive
from cuda_knearests_tpu.ops import pallas_solve as jpallas
from cuda_knearests_tpu.ops import solve as jsolve
from cuda_knearests_tpu.utils import memory as jmemory
import cuda_knearests_tpu_torch as pt
from cuda_knearests_tpu_torch import oracle as poracle
from cuda_knearests_tpu_torch.ops import adaptive as padaptive
from cuda_knearests_tpu_torch.ops import cuda_solve as pcs
from cuda_knearests_tpu_torch.ops import query as pquery
from cuda_knearests_tpu_torch.ops import solve as psolve
from cuda_knearests_tpu_torch.runtime import dispatch
from cuda_knearests_tpu_torch.utils.memory import LaunchBudgetError

CLOUDS = {
    "blue-k10": (lambda: generate_blue_noise(3000, seed=11), dict(k=10)),
    "clustered-r1": (lambda: generate_clustered(4000, seed=13),
                     dict(k=8, ring_radius=1)),
    "uniform-s2": (lambda: generate_uniform(2500, seed=12),
                   dict(k=6, supercell=2, sc_batch=16)),
}

# (name, config of both packages, JAX-only extras): every legacy case the
# port answers, with the JAX run of the same route.
LEGACY_CASES = {
    "pallas-scatter": dict(backend="pallas", epilogue="scatter"),
    "pallas-gather": dict(backend="pallas", epilogue="gather"),
    "xla-scatter": dict(backend="xla", epilogue="scatter"),
    "xla-gather": dict(backend="xla", epilogue="gather"),
    "xla-dot": dict(backend="xla", dist_method="dot"),
    "blocked-gather": dict(backend="pallas", kernel="blocked",
                           epilogue="gather"),
}


def _jcfg(**kw):
    return ck.KnnConfig(interpret=True, **kw)


@pytest.fixture(scope="module")
def clouds():
    """Per cloud: the points, both packages' grids, and the port's
    adaptive ids after the fallback (the exact answer every route
    gives)."""
    out = {}
    for name, (make, kw) in CLOUDS.items():
        pts = make()
        base = pt.KnnProblem.prepare(pts, pt.KnnConfig(**kw), device="cpu")
        base.solve()
        out[name] = dict(pts=pts, kw=kw, base=base,
                         jgrid=ck.build_grid(pts),
                         ids=base.get_knearests_original())
    return out


@pytest.mark.parametrize("cloud", sorted(CLOUDS))
def test_global_schedule_equals_jax(clouds, cloud):
    c = clouds[cloud]
    kw = dict(c["kw"])
    jgot = jsolve.global_schedule(c["jgrid"], ck.KnnConfig(**kw))
    pgot = psolve.global_schedule(c["base"].grid, pt.KnnConfig(**kw))
    for name, want, got in zip(("own", "cand", "box_lo", "box_hi"),
                               jgot[:4], pgot[:4]):
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert pgot[4:] == jgot[4:]  # qcap, ccap
    jplan = jsolve.build_plan(c["jgrid"], ck.KnnConfig(**kw))
    pplan = psolve.build_plan(c["base"].grid, pt.KnnConfig(**kw))
    assert (pplan.qcap, pplan.ccap, pplan.n_chunks, pplan.batch) == (
        jplan.qcap, jplan.ccap, jplan.n_chunks, jplan.batch)
    for name in ("own_cells", "cand_cells", "box_lo", "box_hi"):
        np.testing.assert_array_equal(getattr(pplan, name).numpy(),
                                      np.asarray(getattr(jplan, name)),
                                      err_msg=name)


@pytest.mark.parametrize("cloud", sorted(CLOUDS))
def test_legacy_pack_maps_equal_jax(clouds, cloud):
    """inv_flat, inv_sc and tgt at the pack's qcap (the plan's rounded up
    to 128), and the packed slot ids, equal JAX's ``build_pack``."""
    c = clouds[cloud]
    jg, pg = c["jgrid"], c["base"].grid
    jplan = jsolve.build_plan(jg, ck.KnnConfig(**c["kw"]))
    pplan = psolve.build_plan(pg, pt.KnnConfig(**c["kw"]))
    jpack = jpallas.build_pack(jg.points, jg.cell_starts, jg.cell_counts,
                               jplan)
    ppack = pcs.build_pack(pg.points, pg.cell_starts, pg.cell_counts, pplan)
    assert (ppack.qcap, ppack.ccap, ppack.s_total) == (
        jpack.qcap, jpack.ccap, jpack.s_total)
    assert ppack.qcap % 128 == 0 and ppack.qcap >= pplan.qcap
    for name in ("inv_flat", "inv_sc", "tgt"):
        got = getattr(ppack, name).numpy()
        want = np.asarray(getattr(jpack, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for got, want in ((ppack.pk.qid, jpack.qid3), (ppack.pk.cid, jpack.cid3)):
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(want).reshape(got.shape))
    np.testing.assert_array_equal(ppack.lo.numpy(), np.asarray(jpack.lo))


@pytest.mark.parametrize("cloud", sorted(CLOUDS))
def test_adaptive_inv_row_equals_jax(clouds, cloud):
    """The adaptive plan's inv_row, inv_box and forward maps equal JAX's
    host-platform plan, whose classes lay their rows out at the same
    qcap as the port's (JAX's kernel platforms pad a kernel class to
    128).  The port keeps inv_row only under the gather epilogue."""
    c = clouds[cloud]
    jplan = jadaptive.build_adaptive_plan(c["jgrid"], ck.KnnConfig(**c["kw"]),
                                          on_kernel_platform=False)
    assert c["base"].aplan.inv_row is None
    pplan = padaptive.build_adaptive_plan(
        c["base"].grid, pt.KnnConfig(**c["kw"], epilogue="gather"))
    assert [cp.qcap for cp in pplan.classes] == [
        cp.qcap_pad for cp in jplan.classes]
    for name in ("inv_row", "inv_box"):
        got = getattr(pplan, name).numpy()
        want = np.asarray(getattr(jplan, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for pc, jc in zip(pplan.classes, jplan.classes):
        np.testing.assert_array_equal(pc.tgt.numpy(), np.asarray(jc.tgt))


def _rows_match(pts_sorted, got_ids, got_d2, want_d2, k, dot=False):
    """Tie-aware rows.  The 'dot' form |q|^2 + |c|^2 - 2 q.c rounds
    three terms of magnitude up to max |p|^2 (about 3e6 in the domain), so
    its d2 may sit a few ulps of that magnitude from the exact value in
    either package: there the absolute band is 16 eps32 max |p|^2."""
    atol = 1e-2
    if dot:
        atol = 16 * float(np.finfo(np.float32).eps) * float(
            (pts_sorted.astype(np.float64) ** 2).sum(1).max())
    bad = check_route_result(pts_sorted, pts_sorted, got_ids, got_d2,
                             want_d2, k, atol=atol)
    assert bad is None, bad.render()


@pytest.mark.parametrize("case", sorted(LEGACY_CASES))
@pytest.mark.parametrize("cloud", sorted(CLOUDS))
def test_legacy_solve_matches_jax(clouds, cloud, case):
    """Rows after the fallback tie-aware equal JAX's on the same route,
    and ids equal the port's adaptive route's.  The 'dot' form orders
    pairs whose 'diff' distances lie within its rounding band as it
    rounds them: there its rows are held to the adaptive route's
    distances within that band, and its ids equal the adaptive route's
    on every other row."""
    c = clouds[cloud]
    kw = dict(c["kw"], adaptive=False, **LEGACY_CASES[case])
    jp = ck.KnnProblem.prepare(c["pts"], _jcfg(**kw))
    pp = pt.KnnProblem.prepare(c["pts"], pt.KnnConfig(**kw), device="cpu")
    assert pp._route_name() == "legacy"
    assert pp.backend == kw["backend"]
    assert (pp.pack is not None) == (kw["backend"] == "pallas")
    jres, pres = jp.solve(), pp.solve()
    k = kw["k"]
    pts_sorted = pp.grid.points.numpy()
    dot = case == "xla-dot"
    _rows_match(pts_sorted, pres.neighbors, pres.dists_sq,
                np.asarray(jres.dists_sq), k, dot=dot)
    got = pp.get_knearests_original()
    if not dot:
        np.testing.assert_array_equal(got, c["ids"])
        return
    base = c["base"].result
    _rows_match(pts_sorted, pres.neighbors, pres.dists_sq, base.dists_sq,
                k, dot=True)
    differ = (pres.neighbors != base.neighbors).any(axis=1)
    assert differ.mean() < 0.05, differ.sum()
    band = 16 * float(np.finfo(np.float32).eps) * float(
        (pts_sorted.astype(np.float64) ** 2).sum(1).max())
    # a row differs only where two of its 'diff' distances lie in the band
    gaps = np.diff(base.dists_sq[differ], axis=1)
    assert (gaps <= band).any(axis=1).all()


@pytest.mark.parametrize("route", ["legacy-pallas", "legacy-xla",
                                   "adaptive", "adaptive-blocked",
                                   "adaptive-streamed", "adaptive-mxu"])
@pytest.mark.parametrize("cloud", sorted(CLOUDS))
def test_gather_equals_scatter_bit_for_bit(clouds, cloud, route,
                                           monkeypatch):
    """Before the fallback: ids, d2, certificates and the uncertified
    count of the gather epilogue equal the scatter epilogue's."""
    c = clouds[cloud]
    kw = dict(c["kw"])
    if route.startswith("legacy"):
        kw.update(adaptive=False, backend=route.split("-")[1])
    elif route == "adaptive-blocked":
        kw.update(kernel="blocked")
    elif route == "adaptive-mxu":
        kw.update(scorer="mxu", recall_target=0.8)
    elif route == "adaptive-streamed":
        monkeypatch.setattr(padaptive, "hbm_budget_bytes",
                            lambda device, cfg=None: 1)
        monkeypatch.setattr(padaptive, "_preflight",
                            lambda specs, cfg, n, budget: (
                                [dataclasses.replace(s, route="streamed")
                                 for s in specs], [3] * len(specs)))
    outs = []
    for epilogue in ("scatter", "gather"):
        p = pt.KnnProblem.prepare(c["pts"], pt.KnnConfig(epilogue=epilogue,
                                                         **kw), device="cpu")
        if route == "adaptive-streamed":
            assert {cp.route for cp in p.aplan.classes} == {"streamed"}
        if route == "adaptive-mxu":
            assert "mxu" in {cp.route for cp in p.aplan.classes}
        res = (padaptive.solve_adaptive(p.grid, p.config, p.aplan)
               if p.aplan is not None else
               psolve.solve(p.grid, p.config, p.plan, p.pack, p.backend))
        outs.append(res)
    s, g = outs
    for name in ("neighbors", "dists_sq", "certified", "uncert_count"):
        a, b = getattr(s, name), getattr(g, name)
        assert torch.equal(torch.isnan(a) if a.is_floating_point() else a,
                           torch.isnan(b) if b.is_floating_point() else b)
        assert torch.equal(a, b) or name == "dists_sq" and torch.equal(
            torch.nan_to_num(a), torch.nan_to_num(b)), name


def _queries(pts: np.ndarray, m: int, seed: int) -> np.ndarray:
    """Uniform queries and stored points nudged off themselves."""
    q = np.concatenate([generate_uniform(m - m // 4, seed=seed),
                        pts[:m // 4] + np.float32(0.25)])
    return np.clip(q, 0, 999.9).astype(np.float32)


@pytest.mark.parametrize("epilogue", ["scatter", "gather"])
@pytest.mark.parametrize("cloud", sorted(CLOUDS))
def test_query_knn_matches_jax(clouds, cloud, epilogue):
    """Legacy queries: tie-aware equal to JAX's legacy pipeline (interpret
    mode), ids equal to the adaptive route's, the kernel route counted,
    in at most two host round trips."""
    c = clouds[cloud]
    queries = _queries(c["pts"], 200, 31)
    k = c["kw"]["k"]
    kw = dict(c["kw"], adaptive=False, epilogue=epilogue)
    jp = ck.KnnProblem.prepare(c["pts"], _jcfg(backend="pallas", **kw))
    _, j_d2 = jp.query(queries)
    pp = pt.KnnProblem.prepare(c["pts"], pt.KnnConfig(**kw), device="cpu")
    before = pquery.route_queries["kernel"]
    dispatch.reset_stats()
    ids, d2 = pp.query(queries)
    assert dispatch.stats().host_syncs <= dispatch.SYNC_BUDGET
    assert pquery.route_queries["kernel"] == before + queries.shape[0]
    perm = pp.get_permutation()
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    bad = check_route_result(pp.grid.points.numpy(), queries,
                             np.where(ids >= 0, inv[np.clip(ids, 0, None)],
                                      -1), d2, j_d2, k)
    assert bad is None, bad.render()
    np.testing.assert_array_equal(ids, c["base"].query(queries)[0])


@pytest.mark.parametrize("epilogue", ["scatter", "gather"])
def test_query_chunks_equal_single_shot(epilogue):
    """At query_chunk in {1, 97, m} the rows are byte for byte the single
    shot's (every chunk packed at the shared q2cap), each call in at most
    two host round trips: one fetch of every chunk's rows, one for the
    fallback."""
    pts = generate_blue_noise(800, seed=41)
    queries = _queries(pts, 200, 42)
    m = queries.shape[0]
    outs = {}
    for chunk in (None, 1, 97, m):
        pp = pt.KnnProblem.prepare(pts, pt.KnnConfig(
            k=8, adaptive=False, sc_batch=8, epilogue=epilogue,
            query_chunk=chunk), device="cpu")
        dispatch.reset_stats()
        outs[chunk] = pp.query(queries)
        assert dispatch.stats().host_syncs <= dispatch.SYNC_BUDGET
    for chunk in (1, 97, m):
        for got, want in zip(outs[chunk], outs[None]):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    jp = ck.KnnProblem.prepare(pts, _jcfg(k=8, adaptive=False, sc_batch=8,
                                          backend="pallas", query_chunk=97,
                                          epilogue=epilogue))
    bad = check_route_result(pts, queries, outs[None][0], outs[None][1],
                             jp.query(queries)[1], 8)
    assert bad is None, bad.render()


def test_query_knn_without_kernel_takes_brute(clouds):
    """backend='xla' keeps no pack and a query pack the launch gate
    refuses (k past 892) has none either: every query takes the exact
    brute force, counted, as in the reference."""
    c = clouds["blue-k10"]
    queries = generate_uniform(120, seed=32)
    jp = ck.KnnProblem.prepare(c["pts"], _jcfg(k=10, adaptive=False,
                                               backend="xla"))
    j_ids, j_d2 = jp.query(queries)
    pp = pt.KnnProblem.prepare(c["pts"], pt.KnnConfig(
        k=10, adaptive=False, backend="xla", query_chunk=50), device="cpu")
    assert pp.pack is None
    before = pquery.route_queries["brute"]
    ids, d2 = pp.query(queries)
    assert pquery.route_queries["brute"] == before + 120
    np.testing.assert_array_equal(ids, j_ids)
    np.testing.assert_allclose(d2, j_d2, rtol=1e-4, atol=1e-2)
    assert not pquery._kernel_takes(900, 128, 1024)
    assert pquery._kernel_takes(892, 128, 1024)


@pytest.mark.parametrize("env,cfg_budget,want", [
    (None, None, None), ("12345", None, 12345), ("0", None, None),
    ("-5", None, None), ("1e6", None, 1_000_000), ("abc", None, None),
    ("12345", 777, 777), ("12345", 0, None), (None, -1, None),
    (None, 4096, 4096)])
def test_budget_resolution_matches_jax(monkeypatch, capsys, env,
                                       cfg_budget, want):
    """The config wins over the environment variable; <= 0 is unbounded;
    a malformed value is ignored with a stderr line; the CPU is
    unbounded."""
    if env is None:
        monkeypatch.delenv("KNTPU_HBM_BUDGET_BYTES", raising=False)
    else:
        monkeypatch.setenv("KNTPU_HBM_BUDGET_BYTES", env)
    jgot = jpallas.hbm_budget_bytes(ck.KnnConfig(hbm_budget_bytes=cfg_budget))
    j_err = capsys.readouterr().err
    pgot = pcs.hbm_budget_bytes(torch.device("cpu"),
                                pt.KnnConfig(hbm_budget_bytes=cfg_budget))
    p_err = capsys.readouterr().err
    assert pgot == jgot == want
    assert p_err == j_err


def test_one_mib_budget_refuses_the_legacy_pack_in_both():
    pts = generate_blue_noise(8000, seed=5)
    kw = dict(k=10, adaptive=False, backend="pallas",
              hbm_budget_bytes=1 << 20)
    with pytest.raises(jmemory.LaunchBudgetError):
        ck.KnnProblem.prepare(pts, _jcfg(**kw)).solve()
    with pytest.raises(LaunchBudgetError) as e:
        pt.KnnProblem.prepare(pts, pt.KnnConfig(**kw), device="cpu")
    assert e.value.kind == "oom" and e.value.requested > e.value.budget
    assert e.value.site == "prepare_pack"
    # 'auto' is refused the same way: no scan stands in for the kernel.
    # Unbounded (<= 0) keeps the kernel; the scan runs when asked for.
    with pytest.raises(LaunchBudgetError) as e:
        pt.KnnProblem.prepare(pts, pt.KnnConfig(
            k=10, adaptive=False, hbm_budget_bytes=1 << 20), device="cpu")
    assert e.value.site == "prepare_pack"
    free = pt.KnnProblem.prepare(pts, pt.KnnConfig(
        k=10, adaptive=False, hbm_budget_bytes=0), device="cpu")
    assert free.backend == "pallas" and free.pack is not None
    scan = pt.KnnProblem.prepare(pts, pt.KnnConfig(
        k=10, adaptive=False, backend="xla", hbm_budget_bytes=1 << 20),
        device="cpu")
    assert scan.pack is None
    np.testing.assert_array_equal(scan.solve().neighbors,
                                  free.solve().neighbors)


def test_config_budget_routes_adaptive_classes(clouds):
    """The configured budget reaches the adaptive preflight: at the
    streamed plan's need every class streams, one byte less is refused
    (as tests/test_torch_api.py shows with the device budget)."""
    c = clouds["blue-k10"]
    cfg = pt.KnnConfig(**c["kw"])
    _, specs = padaptive.plan_class_specs(
        c["base"].grid.cell_counts.numpy(), c["base"].grid.dim, cfg)
    need = padaptive.streamed_plan_bytes(specs, cfg, c["base"].grid.n_points)
    p = pt.KnnProblem.prepare(c["pts"], dataclasses.replace(
        cfg, hbm_budget_bytes=need), device="cpu")
    assert {cp.route for cp in p.aplan.classes} == {"streamed"}
    p.solve()
    np.testing.assert_array_equal(p.get_knearests_original(), c["ids"])
    with pytest.raises(LaunchBudgetError, match="no route can hold"):
        pt.KnnProblem.prepare(c["pts"], dataclasses.replace(
            cfg, hbm_budget_bytes=need - 1), device="cpu")


@pytest.mark.parametrize("exclude_self", [True, False])
def test_oracle_backend_equals_jax(clouds, exclude_self):
    """backend='oracle': the same kd-tree library answers both packages;
    rows equal exactly, every row certified, no device round trip."""
    c = clouds["clustered-r1"]
    kw = dict(c["kw"], backend="oracle", exclude_self=exclude_self)
    jp = ck.KnnProblem.prepare(c["pts"], ck.KnnConfig(**kw))
    pp = pt.KnnProblem.prepare(c["pts"], pt.KnnConfig(**kw), device="cpu")
    assert pp._route_name() == "oracle" and pp.aplan is None
    assert poracle.native_available()
    dispatch.reset_stats()
    res = pp.solve()
    assert dispatch.stats().host_syncs == 0
    jres = jp.solve()
    np.testing.assert_array_equal(res.neighbors, np.asarray(jres.neighbors))
    np.testing.assert_array_equal(res.dists_sq, np.asarray(jres.dists_sq))
    assert res.certified.all() and int(res.uncert_count) == 0
    queries = generate_uniform(200, seed=33)
    for got, want in zip(pp.query(queries), jp.query(queries)):
        np.testing.assert_array_equal(got, want)


def test_oracle_numpy_fallback_answers_the_same(clouds, monkeypatch):
    """Where the library cannot load, the numpy brute force answers (the
    reference's contract): the same rows, tie-aware (the two sum the
    squares in their own orders)."""
    c = clouds["blue-k10"]
    native = poracle.KdTreeOracle(c["pts"])
    monkeypatch.setattr(poracle, "_lib", False)
    assert not poracle.native_available()
    slow = poracle.KdTreeOracle(c["pts"])
    ids, d2 = slow.knn_all_points(10)
    bad = check_route_result(c["pts"], c["pts"], ids, d2,
                             native.knn_all_points(10)[1], 10)
    assert bad is None, bad.render()


def test_oracle_builds_without_openmp_where_refused(monkeypatch, tmp_path):
    """A compiler without an OpenMP runtime fails the Makefile's build;
    the loader builds again without it and says so (``build_kind``), and
    where nothing loads the numpy engine answers."""
    assert poracle.native_available()
    real = poracle._LIB_PATH
    calls = []

    def make(*args):
        calls.append(args)
        if not args:
            raise subprocess.CalledProcessError(2, "make")
        if serial_builds:
            shutil.copy(real, tmp_path / "lib.so")

    monkeypatch.setattr(poracle, "_make", make)
    monkeypatch.setattr(poracle, "_LIB_PATH", str(tmp_path / "lib.so"))
    for serial_builds in (False, True):
        monkeypatch.setattr(poracle, "_lib", None)
        monkeypatch.setattr(poracle, "build_kind", None)
        calls.clear()
        assert poracle.native_available() is serial_builds
        assert calls == [(), (poracle._SERIAL_FLAGS,)]
        assert poracle.build_kind == ("serial" if serial_builds else None)


def _same_shape(got, want, path=""):
    """Equal key sets at every level; equal ints (not bools), close
    floats; the port's device bytes and route names are its own."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for key in want:
            if key not in ("device_bytes", "route", "use_pallas"):
                _same_shape(got[key], want[key], f"{path}.{key}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _same_shape(a, b, f"{path}[{i}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-3, abs=1e-6), path
    else:
        assert got == want, path


@pytest.mark.parametrize("route", ["adaptive", "legacy", "oracle"])
def test_stats_match_jax(clouds, route, capsys):
    c = clouds["blue-k10"]
    kw = dict(c["kw"])
    if route == "legacy":
        kw.update(adaptive=False, backend="pallas")
    if route == "oracle":
        kw.update(backend="oracle")
    jp = ck.KnnProblem.prepare(c["pts"], ck.KnnConfig(
        interpret=route == "legacy", **kw))
    pp = pt.KnnProblem.prepare(c["pts"], pt.KnnConfig(**kw), device="cpu")
    _same_shape(pp.stats(), jp.stats())
    jp.solve()
    pp.solve()
    want = jp.stats()
    got = pp.print_stats()
    _same_shape(got, want)
    assert got["device_bytes"] > 0 or route == "oracle"
    assert ("margin" in got) == (route != "oracle")
    out = capsys.readouterr().out
    assert f"grid {got['grid_dim']}^3, {got['n_points']} points" in out


def test_legacy_refuses_what_the_reference_refuses(clouds):
    c = clouds["blue-k10"]
    with pytest.raises(ValueError, match="computes 'diff' distances only"):
        pt.KnnProblem.prepare(c["pts"], pt.KnnConfig(
            k=10, adaptive=False, backend="pallas", dist_method="dot"),
            device="cpu")
    with pytest.raises(pt.utils.memory.InvalidConfigError,
                       match="needs the adaptive grid route"):
        pt.KnnProblem.prepare(c["pts"], pt.KnnConfig(
            k=10, adaptive=False, scorer="mxu"), device="cpu")
    with pytest.raises(ValueError, match="no oracle route"):
        psolve.pick_backend(pt.KnnConfig(backend="oracle"), 128, 1024)
    assert psolve.pick_backend(pt.KnnConfig(k=10, dist_method="dot"), 96,
                               1024) == "xla"
    assert psolve.pick_backend(pt.KnnConfig(k=10), 96, 1024) == "pallas"
    # a shape the launch gate refuses is refused under 'auto' too, before
    # the pack: never handed to the scan
    assert psolve.pick_backend(pt.KnnConfig(k=900), 96, 1024) == "pallas"
    with pytest.raises(LaunchBudgetError, match="launch gate") as e:
        pt.KnnProblem.prepare(c["pts"], pt.KnnConfig(k=900, adaptive=False),
                              device="cpu")
    assert e.value.site == "prepare_pack"
    with pytest.raises(ValueError, match="int32 indexing"):
        pcs.check_raw_indexing(1 << 16, 1 << 8, 1 << 7)
