"""The blocked two-stage kernel's plain version against the JAX package's
``_kernel_blocked`` (Pallas, interpret mode) on its own packs, and the grid
route with ``KnnConfig(kernel='blocked')`` end to end.

d2 may differ by an ulp between the packages on the CPU (XLA contracts
multiply-adds, torch's separate ops do not), so rows are compared
tie-aware (``fuzz/compare.check_route_result``); the deficit rows (NaN at
column k-1) must be the same rows.  Within the port, a row without a
deficit holds exactly the one-stage kernel's distances: every candidate a
block rejected is at least the k-th distance.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cuda_knearests_tpu as ck
from cuda_knearests_tpu.config import blocked_topm as jblocked_topm
from cuda_knearests_tpu.config import resolve_kernel as jresolve_kernel
from cuda_knearests_tpu.fuzz.compare import check_route_result
from cuda_knearests_tpu.io import generate_blue_noise, generate_clustered
from cuda_knearests_tpu.ops.adaptive import solve_adaptive as jsolve
from cuda_knearests_tpu.ops.pallas_solve import _pack_inputs, _pallas_topk
import cuda_knearests_tpu_torch as pt
from cuda_knearests_tpu_torch import config as pconfig
from cuda_knearests_tpu_torch.ops import cuda_solve as cs
from cuda_knearests_tpu_torch.ops.adaptive import (class_blocked_m,
                                                   solve_adaptive as psolve)
from cuda_knearests_tpu_torch.ops.solve import _box_cell_ids, _boxes_grid
from cuda_knearests_tpu_torch.runtime import dispatch

QCAP, CCAP, N_SC = 128, 1152, 4


def _rows(a, k):
    return np.swapaxes(np.asarray(a), 1, 2).reshape(-1, k)


@pytest.fixture(scope="module")
def packs():
    """The JAX package's pack of 4 supercells of a 2500-point blue-noise
    grid (radius 2, interleaved candidate slots), and the same pack with
    each supercell's candidates reordered nearest-first to its first
    query, which crowds the near neighbours into one 128-slot block and
    makes deficit rows."""
    pts = generate_blue_noise(2500, seed=5)
    jg = ck.build_grid(pts)
    sc = _boxes_grid(-(-jg.dim // 3))[[0, 5, 13, 26]]
    own = _box_cell_ids(sc, 0, 0, 3, jg.dim)
    cand = _box_cell_ids(sc, -2, 2, 3, jg.dim)
    packed = _pack_inputs(jg.points, jg.cell_starts, jg.cell_counts,
                          jnp.asarray(own), jnp.asarray(cand), QCAP, CCAP)
    host = [np.array(a).reshape(N_SC, -1) for a in packed[2:]]
    qx, qy, qz, cx, cy, cz, qid, cid = host
    d0 = ((cx - qx[:, :1]) ** 2 + (cy - qy[:, :1]) ** 2
          + (cz - qz[:, :1]) ** 2)
    d0 = np.where(cid >= 0, d0, np.inf)
    order = np.argsort(d0, axis=1, kind="stable")
    crowded = [qx, qy, qz] + [np.take_along_axis(a, order, 1)
                              for a in (cx, cy, cz)] + [qid]
    crowded.append(np.take_along_axis(cid, order, 1))
    out = {}
    for name, arrays in (("interleaved", host), ("crowded", crowded)):
        qx, qy, qz, cx, cy, cz, qid, cid = arrays
        out[name] = dict(
            jargs=[jnp.asarray(a.reshape(N_SC, 1, -1)) for a in arrays],
            pargs=tuple(torch.tensor(np.ascontiguousarray(a))
                        for a in (qx, qy, qz, qid, cx, cy, cz, cid)),
            queries=np.stack([qx, qy, qz], -1).reshape(-1, 3),
            ok=(qid >= 0).reshape(-1))
    out["points"] = np.array(jg.points)
    return out


@pytest.mark.parametrize("exclude_self", [True, False])
@pytest.mark.parametrize("k", [10, 20])
@pytest.mark.parametrize("layout", ["interleaved", "crowded"])
def test_plain_matches_pallas_blocked(packs, layout, k, exclude_self):
    pk = packs[layout]
    m = jblocked_topm(k, CCAP)
    assert m == pconfig.blocked_topm(k, CCAP) > 0
    jd, ji = _pallas_topk(*pk["jargs"], QCAP, CCAP, k, exclude_self, True,
                          kernel="blocked")
    jd, ji = _rows(jd, k), _rows(ji, k)
    pd, pi = cs.blocked_topk(*pk["pargs"], k, m, exclude_self)
    assert pd.shape == (N_SC, k, QCAP) and cs.blocked_launches == 0
    pd, pi = _rows(pd, k), _rows(pi, k)
    ok = pk["ok"]
    j_def, p_def = np.isnan(jd[:, k - 1]), np.isnan(pd[:, k - 1])
    np.testing.assert_array_equal(p_def[ok], j_def[ok])
    if layout == "crowded":
        assert p_def[ok].sum() > 10  # the crowded pack makes deficits
    # rows tie-aware: full rows where certified, the first k-1 in deficit
    # rows (their k-th distance is the NaN flag)
    for rows, width in ((ok & ~p_def, k), (ok & p_def, k - 1)):
        jdr = np.where(np.isfinite(jd[rows, :width]), jd[rows, :width],
                       np.inf)
        bad = check_route_result(packs["points"], pk["queries"][rows],
                                 pi[rows, :width], pd[rows, :width], jdr,
                                 width)
        assert bad is None, bad.render()


@pytest.mark.parametrize("layout", ["interleaved", "crowded"])
def test_plain_rows_without_deficit_hold_the_true_distances(packs, layout):
    pk, k = packs[layout], 20
    m = pconfig.blocked_topm(k, CCAP)
    bd, bi = cs.blocked_topk(*pk["pargs"], k, m, True)
    kd, ki = cs.supercell_topk(*pk["pargs"], k, True)
    clean = ~torch.isnan(bd[:, k - 1, :])
    assert clean.any()
    assert torch.equal(bd.transpose(1, 2)[clean], kd.transpose(1, 2)[clean])
    # the two output modes carry the same rows
    n_rows = int(pk["ok"].sum())
    tgt = np.full(pk["ok"].size, n_rows, np.int32)
    tgt[pk["ok"]] = np.arange(n_rows)[::-1]
    out = (torch.full((n_rows, k), float("inf")),
           torch.full((n_rows, k), -1, dtype=torch.int32))
    rd, ri = cs.blocked_topk(*pk["pargs"], k, m, True,
                             tgt=torch.tensor(tgt), out=out)
    raw_d = bd.transpose(1, 2).reshape(-1, k)[pk["ok"]]
    raw_i = bi.transpose(1, 2).reshape(-1, k)[pk["ok"]]
    order = torch.tensor(tgt[pk["ok"]]).long()
    assert torch.equal(ri[order], raw_i)
    same = (rd[order] == raw_d) | (torch.isnan(rd[order])
                                   & torch.isnan(raw_d))
    assert same.all()


def test_plain_chunking_does_not_change_results(packs, monkeypatch):
    pk = packs["crowded"]
    m = pconfig.blocked_topm(10, CCAP)
    whole = cs.blocked_topk(*pk["pargs"], 10, m, True)
    for pairs in (100 * CCAP, 3 * CCAP):
        monkeypatch.setattr(cs, "_PLAIN_CHUNK_PAIRS", pairs)
        chunked = cs.blocked_topk(*pk["pargs"], 10, m, True)
        nan = torch.isnan(whole[0])
        assert torch.equal(torch.isnan(chunked[0]), nan)
        assert torch.equal(chunked[0][~nan], whole[0][~nan])
        assert torch.equal(chunked[1], whole[1])


def test_blocked_wrapper_rules(monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from cuda_knearests_tpu_torch.ops import _build

    z = torch.zeros((1, 8))
    zi = torch.zeros((1, 8), dtype=torch.int32)
    c = torch.zeros((1, 256))
    ci = torch.zeros((1, 256), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 128"):
        cs.blocked_topk(z, z, z, zi, z, z, z, zi, 2, 2, True)
    with pytest.raises(ValueError, match="m <= 128"):
        cs.blocked_topk(z, z, z, zi, c, c, c, ci, 2, 0, True)
    assert cs.pick_q_tile(10, 104, 6) == 128
    with pytest.raises(cs.LaunchBudgetError, match="m=16"):
        cs.pick_q_tile(1000, 1000, 16)

    def no_toolkit(name):
        raise _build.KernelBuildError("nvcc not found")

    monkeypatch.setattr(cs, "blocked_topk_plain", None)
    monkeypatch.setattr(_build, "load", no_toolkit)
    before = cs.blocked_launches
    with FakeTensorMode():
        f = torch.zeros((2, 16), device="cuda")
        i = torch.zeros((2, 16), dtype=torch.int32, device="cuda")
        g = torch.zeros((2, 256), device="cuda")
        j = torch.zeros((2, 256), dtype=torch.int32, device="cuda")
        with pytest.raises(_build.KernelBuildError):
            cs.blocked_topk(f, f, f, i, g, g, g, j, 4, 2, True)
    assert cs.blocked_launches == before


def test_kernel_resolution_matches_jax():
    for k in (1, 5, 10, 20, 50, 128):
        for ccap in (128, 256, 1152, 2304, 10368, 1000):
            assert pconfig.blocked_topm(k, ccap) == jblocked_topm(k, ccap)
            for kernel in ("auto", "kpass", "blocked"):
                assert (pconfig.resolve_kernel(kernel, k, ccap)
                        == jresolve_kernel(kernel, k, ccap))
    with pytest.raises(ValueError, match="unknown kernel"):
        pconfig.resolve_kernel("fast", 10, 1152)
    with pytest.raises(pt.utils.memory.InvalidConfigError):
        pt.KnnConfig(kernel="fast")
    for fallback, want in (("brute", "blocked"), ("none", "kpass")):
        cfg = pt.KnnConfig(kernel="blocked", fallback=fallback)
        assert cfg.effective_kernel() == want == ck.KnnConfig(
            kernel="blocked", fallback=fallback).effective_kernel()


# k=30 on ~3k points: blocked-eligible classes (ccap 1,920-3,072, m=6)
# whose deficit rows go through the exact fallback.
BLOCKED_CASES = {
    "blue-k30": (lambda: generate_blue_noise(3000, seed=1), dict(k=30)),
    "clustered-k30": (lambda: generate_clustered(4000, seed=3), dict(k=30)),
}


@pytest.mark.parametrize("case", sorted(BLOCKED_CASES))
def test_grid_route_with_blocked_kernel_matches_jax(case):
    make, kw = BLOCKED_CASES[case]
    pts = make()
    k = kw["k"]
    jp = ck.KnnProblem.prepare(pts, ck.KnnConfig(kernel="blocked",
                                                 interpret=True, **kw))
    j_raw = jsolve(jp.grid, jp.config, jp.aplan)
    j_fin = jp._finalize(j_raw)
    cfg = pt.KnnConfig(kernel="blocked", **kw)
    pp = pt.KnnProblem.prepare(pts, cfg, device="cpu")
    assert any(class_blocked_m(cfg, cp.ccap) for cp in pp.aplan.classes)
    p_raw = psolve(pp.grid, pp.config, pp.aplan)
    kp = pt.KnnProblem.prepare(pts, pt.KnnConfig(**kw), device="cpu")
    # deficit rows: the blocked kernel's NaN at column k-1 fails the
    # certificate and is then cleared to (-1, inf), in both packages,
    # where the one-stage kernel has a k-th neighbour
    k_raw = psolve(kp.grid, kp.config, kp.aplan)
    deficit = (p_raw.neighbors[:, k - 1] < 0) & (k_raw.neighbors[:, k - 1]
                                                 >= 0)
    assert bool(deficit.any())
    assert bool(torch.isinf(p_raw.dists_sq[deficit, k - 1]).all())
    assert not bool(p_raw.certified[deficit].any())
    assert not np.asarray(j_raw.certified)[deficit.numpy()].any()
    assert int(p_raw.uncert_count) == int(j_raw.uncert_count)
    dispatch.reset_stats()
    p_fin = pp.solve()
    assert dispatch.stats().host_syncs <= dispatch.SYNC_BUDGET
    pts_sorted = np.asarray(jp.grid.points)
    bad = check_route_result(pts_sorted, pts_sorted, p_fin.neighbors,
                             p_fin.dists_sq, np.asarray(j_fin.dists_sq), k)
    assert bad is None, bad.render()
    assert p_fin.certified.all() and np.isfinite(p_fin.dists_sq).all()
    # the finalized rows are the one-stage kernel's rows
    np.testing.assert_array_equal(p_fin.dists_sq, kp.solve().dists_sq)
