"""The grid route's streamed class route against the JAX package.

A class whose k the class kernel's lists cannot hold (k >= 893), or whose
packs exceed the device memory budget, takes the streamed route
(``ops/adaptive.streamed_topk``), the counterpart of the reference's
``_streamed_topk``: candidate tiles packed by ``pack_cells``, d2 summed x,
y, z with every op rounded on its own, and each tile folded into a running
top-k on int64 (d2, id) keys.  Held here:

  * against JAX's ``_streamed_topk`` on the same packed inputs, tie-aware
    (``fuzz/compare``: d2 may differ by an ulp because XLA's CPU backend
    contracts multiply-adds), and exactly against the port's own
    ``supercell_topk_plain`` on the same class;
  * end to end: ``KnnProblem.prepare/solve`` at k=900 and under a forced
    small budget against the JAX package's solve, with the routes the
    plan chose.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_knearests_tpu as ck
from cuda_knearests_tpu.fuzz.compare import ATOL, RTOL, check_route_result
from cuda_knearests_tpu.io import generate_blue_noise, generate_clustered
from cuda_knearests_tpu.ops.adaptive import _streamed_topk as jstreamed
from cuda_knearests_tpu.ops.adaptive import solve_adaptive as jsolve
import cuda_knearests_tpu_torch as pt
from cuda_knearests_tpu_torch.ops import adaptive as padapt
from cuda_knearests_tpu_torch.ops.cuda_solve import (pack_inputs,
                                                     supercell_topk_plain)
from cuda_knearests_tpu_torch.ops.solve import (_box_cell_ids, _margin_sq,
                                                pack_cells)
from cuda_knearests_tpu_torch.utils.memory import LaunchBudgetError


def _class_inputs(pts, k, ci=0):
    """The port's grid of ``pts`` and the cell tables, capacities and
    packed query slots of its plan's class ``ci``."""
    cfg = pt.KnnConfig(k=k)
    prob = pt.KnnProblem.prepare(pts, cfg, device="cpu")
    g = prob.grid
    sc, specs = padapt.plan_class_specs(g.cell_counts.numpy(), g.dim, cfg)
    spec = specs[ci]
    s = cfg.supercell
    own = torch.as_tensor(_box_cell_ids(sc[spec.rows], 0, 0, s, g.dim))
    cand = torch.as_tensor(_box_cell_ids(sc[spec.rows], -spec.radius,
                                         spec.radius, s, g.dim))
    q_idx, q_ok = pack_cells(own, g.cell_starts, g.cell_counts, spec.qcap)
    return g, spec, own, cand, q_idx, q_ok


@pytest.mark.parametrize("k,excl,rows", [(10, True, 3), (10, False, 64),
                                         (50, True, 5), (900, True, 2)])
def test_streamed_topk_matches_jax_and_the_kernel_plain(k, excl, rows):
    pts = generate_blue_noise(3000, seed=21)
    g, spec, own, cand, q_idx, q_ok = _class_inputs(pts, min(k, 50))
    tile = 256
    q = g.points[q_idx.long()]
    q_excl = q_idx if excl else torch.full_like(q_idx, -2)
    # a few supercells a step, so the row chunking runs too
    pd, pi = padapt.streamed_topk(g.points, g.cell_starts, g.cell_counts,
                                  cand, q, q_ok, q_excl, k, spec.ccap, tile,
                                  rows)
    jd, _ = jstreamed(jnp.asarray(g.points.numpy()),
                      jnp.asarray(g.cell_starts.numpy()),
                      jnp.asarray(g.cell_counts.numpy()),
                      jnp.asarray(cand.numpy()), jnp.asarray(q.numpy()),
                      jnp.asarray(q_ok.numpy()), jnp.asarray(q_excl.numpy()),
                      k, spec.ccap, tile)
    ok = q_ok.reshape(-1).numpy()
    pts_s = g.points.numpy()
    assert pd.shape == (q_idx.numel(), k)
    bad = check_route_result(pts_s, q.reshape(-1, 3).numpy()[ok],
                             pi.numpy()[ok], pd.numpy()[ok],
                             np.asarray(jd)[ok], k)
    assert bad is None, bad.render()
    # the kernel's plain version on the same class selects the same rows
    pk = pack_inputs(g.points, g.cell_starts, g.cell_counts, own, cand,
                     spec.qcap, spec.ccap)
    kd, ki = supercell_topk_plain(*pk.args(), k, excl)
    kd = kd.transpose(1, 2).reshape(-1, k)
    ki = ki.transpose(1, 2).reshape(-1, k)
    ok_t = torch.as_tensor(ok)
    assert torch.equal(pd[ok_t], kd[ok_t]) and torch.equal(pi[ok_t],
                                                             ki[ok_t])
    assert bool(torch.isinf(pd[~ok_t]).all()) and bool((pi[~ok_t] < 0).all())


def _solve_both(pts, kw):
    """(port problem, port pre-fallback certificates, port finalized
    result, JAX certificates, JAX finalized result) of one cloud."""
    jp = ck.KnnProblem.prepare(pts, ck.KnnConfig(**kw))
    j_raw = jsolve(jp.grid, jp.config, jp.aplan)
    j_cert = np.asarray(j_raw.certified)
    j_fin = jp._finalize(j_raw)
    pp = pt.KnnProblem.prepare(pts, pt.KnnConfig(**kw), device="cpu")
    p_cert = padapt.solve_adaptive(pp.grid, pp.config,
                                   pp.aplan).certified.numpy()
    return pp, p_cert, pp.solve(), j_cert, j_fin


def _check_against_jax(pp, p_cert, p_fin, j_cert, j_fin, k):
    """Tie-aware rows against JAX, every row certified after the fallback,
    and certificate masks equal except where the k-th distance sits in
    the comparator's band around the margin (an ulp of FMA decides)."""
    pts_s = pp.get_points()
    bad = check_route_result(pts_s, pts_s, p_fin.neighbors, p_fin.dists_sq,
                             np.asarray(j_fin.dists_sq), k)
    assert bad is None, bad.render()
    assert p_fin.certified.all()
    differ = np.nonzero(p_cert != j_cert)[0]
    if differ.size:
        inv = pp.aplan.inv_box.long()
        lo = torch.cat([cp.lo for cp in pp.aplan.classes])[inv]
        hi = torch.cat([cp.hi for cp in pp.aplan.classes])[inv]
        margin = _margin_sq(pp.grid.points, lo, hi, pp.grid.domain).numpy()
        kth = np.asarray(p_fin.dists_sq)[:, k - 1]
        assert np.allclose(kth[differ], margin[differ], rtol=RTOL, atol=ATOL)
    assert int((~p_cert).sum()) == int((~j_cert).sum())


def test_k900_solve_streams_and_matches_jax():
    pts = generate_blue_noise(2000, seed=5)
    pp, p_cert, p_fin, j_cert, j_fin = _solve_both(pts, dict(k=900))
    assert [cp.route for cp in pp.aplan.classes] == \
        ["streamed"] * len(pp.aplan.classes)
    assert all(cp.pk is None for cp in pp.aplan.classes)
    _check_against_jax(pp, p_cert, p_fin, j_cert, j_fin, 900)


def test_k900_on_a_clustered_cloud_streams_with_the_fallback():
    pts = generate_clustered(3000, seed=3)
    kw = dict(k=900, ring_radius=2)
    pp, p_cert, p_fin, j_cert, j_fin = _solve_both(pts, kw)
    assert {cp.route for cp in pp.aplan.classes} == {"streamed"}
    assert int(p_fin.uncert_count) > 0
    _check_against_jax(pp, p_cert, p_fin, j_cert, j_fin, 900)


def _budget_streaming_one_class(pts, cfg):
    """(the free problem of ``pts``, a budget under which exactly one of its
    classes streams -- the all-streamed plan plus the smaller class's pack
    surplus --, the index of the class that streams)."""
    free = pt.KnnProblem.prepare(pts, cfg, device="cpu")
    _, specs = padapt.plan_class_specs(free.grid.cell_counts.numpy(),
                                       free.grid.dim, cfg)
    extra = [padapt.kernel_extra_bytes(sp, cfg) for sp in specs]
    budget = (padapt.streamed_plan_bytes(specs, cfg, free.grid.n_points)
              + min(extra))
    return free, budget, int(np.argmax(extra))


def test_forced_small_budget_streams_one_class_and_matches_jax(monkeypatch):
    pts = generate_clustered(20000, seed=3)
    kw = dict(k=10, ring_radius=1)
    free, budget, big = _budget_streaming_one_class(pts, pt.KnnConfig(**kw))
    assert [cp.route for cp in free.aplan.classes] == ["kernel"] * 2
    # the all-streamed plan and one class's packs: that class keeps the
    # kernel, the other streams
    monkeypatch.setattr(padapt, "hbm_budget_bytes",
                        lambda device, cfg=None: budget)
    pp, p_cert, p_fin, j_cert, j_fin = _solve_both(pts, kw)
    routes = [cp.route for cp in pp.aplan.classes]
    assert sorted(routes) == ["kernel", "streamed"]
    assert routes[big] == "streamed"
    _check_against_jax(pp, p_cert, p_fin, j_cert, j_fin, 10)
    # the kernel route's plain version gives the same answer
    f_fin = free.solve()
    np.testing.assert_array_equal(p_fin.neighbors, f_fin.neighbors)
    np.testing.assert_array_equal(p_fin.dists_sq, f_fin.dists_sq)


def test_stream_rows_fit_what_the_budget_leaves():
    pts = generate_clustered(20000, seed=3)
    cfg = pt.KnnConfig(k=10, ring_radius=1)
    free, _, _ = _budget_streaming_one_class(pts, cfg)
    n = free.grid.n_points
    _, specs = padapt.plan_class_specs(free.grid.cell_counts.numpy(),
                                       free.grid.dim, cfg)
    need = padapt.streamed_plan_bytes(specs, cfg, n)
    one = max(padapt.stream_step_bytes(1, sp.qcap, sp.ccap, 10)
              for sp in specs)
    # unbounded: the kernel where the gate takes it, 64 MB of distances a
    # step otherwise
    routed, rows = padapt._preflight(specs, cfg, n, None)
    assert routed == specs and rows == [None, None]
    refused = []
    for budget in (need - 1, need, need + one, need + 10**7, need + 10**9):
        try:
            routed, rows = padapt._preflight(specs, cfg, n, budget)
        except LaunchBudgetError:
            refused.append(budget)
            continue
        held = need - one
        for sp, r in zip(routed, rows):
            if sp.route == "kernel":
                assert r is None
                held += padapt.kernel_extra_bytes(sp, cfg)
                continue
            tile = padapt.stream_tile(sp.ccap)
            assert 1 <= r <= padapt.streamed_rows_chunk(sp.rows.size,
                                                        sp.qcap, tile)
            assert held + padapt.stream_step_bytes(r, sp.qcap, sp.ccap,
                                                   10) <= budget
    # refusal is monotone in the budget: only below the all-streamed plan
    assert refused == [need - 1]


def test_a_plan_no_route_can_hold_is_refused(monkeypatch):
    monkeypatch.setattr(padapt, "hbm_budget_bytes",
                        lambda device, cfg=None: 300_000)
    with pytest.raises(LaunchBudgetError, match="no route can hold") as e:
        pt.KnnProblem.prepare(generate_blue_noise(3000, seed=1),
                              pt.KnnConfig(k=10), device="cpu")
    assert e.value.kind == "oom" and e.value.requested > e.value.budget
