"""PyTorch port against the JAX package: class partition, CSR slot packing
and the packed kernel inputs.

The partition (supercell rows, radius, qcap, ccap of every class) is host
numpy in both packages and must come out identical; only the route label
and the query padding differ (the JAX kernel pads query slots to 128
lanes, the CUDA kernel takes any qcap).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_knearests_tpu as ck
from cuda_knearests_tpu.io import (generate_blue_noise, generate_clustered,
                                   generate_uniform)
from cuda_knearests_tpu.ops.adaptive import build_adaptive_plan as jplan
from cuda_knearests_tpu.ops.pallas_solve import _pack_inputs
from cuda_knearests_tpu.ops.solve import pack_cells as jpack_cells
import cuda_knearests_tpu_torch as pt
from cuda_knearests_tpu_torch.ops import adaptive as padapt
from cuda_knearests_tpu_torch.ops.cuda_solve import pack_inputs
from cuda_knearests_tpu_torch.ops.solve import _box_cell_ids, _boxes_grid
from cuda_knearests_tpu_torch.ops.solve import pack_cells as ppack_cells

CASES = {
    "blue-k10": (lambda: generate_blue_noise(3000, seed=1), dict(k=10)),
    "blue-k50": (lambda: generate_blue_noise(3000, seed=2), dict(k=50)),
    "uniform-k20": (lambda: generate_uniform(4000, seed=6), dict(k=20)),
    "clustered-r1": (lambda: generate_clustered(6000, seed=3),
                     dict(k=10, ring_radius=1)),
    "clustered-adaptive": (lambda: generate_clustered(6000, seed=8),
                           dict(k=16, max_classes=3)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_class_partition_equal_to_jax(case):
    make, kw = CASES[case]
    pts = make()
    jg = ck.build_grid(pts)
    jp = jplan(jg, ck.KnnConfig(**kw), on_kernel_platform=True,
               abstract=True)
    cfg = pt.KnnConfig(**kw)
    prob = pt.KnnProblem.prepare(pts, cfg, device="cpu")
    _, specs = padapt.plan_class_specs(prob.grid.cell_counts.numpy(),
                                       prob.grid.dim, cfg)
    assert len(specs) == len(jp.classes)
    for ci, spec in enumerate(specs):
        # the JAX plan's supercell rows of class ci, in class-row order
        members = np.nonzero(jp.class_of_sc == ci)[0]
        rows = members[np.argsort(jp.row_of_sc[members])]
        np.testing.assert_array_equal(spec.rows, rows)
    pp = prob.aplan
    assert [(c.radius, c.qcap, c.ccap, c.n_sc) for c in pp.classes] == \
        [(s.radius, s.qcap, s.ccap, s.rows.size) for s in specs] == \
        [(c.radius, c.qcap, c.ccap, c.n_sc) for c in jp.classes]
    if case == "clustered-r1":
        assert len(pp.classes) == 2


def test_forward_maps_cover_every_point_once():
    pts = generate_clustered(6000, seed=3)
    prob = pt.KnnProblem.prepare(pts, pt.KnnConfig(k=10, ring_radius=1),
                                 device="cpu")
    n = prob.grid.n_points
    tgt = torch.cat([cp.tgt for cp in prob.aplan.classes]).numpy()
    real = tgt[tgt < n]
    np.testing.assert_array_equal(np.sort(real), np.arange(n))
    # each point's certificate box is the supercell that packs it
    offs = np.cumsum([0] + [cp.n_sc for cp in prob.aplan.classes])
    inv_box = prob.aplan.inv_box.numpy()
    for ci, cp in enumerate(prob.aplan.classes):
        t = cp.tgt.numpy().reshape(cp.n_sc, cp.qcap)
        sc, _ = np.nonzero(t < n)
        np.testing.assert_array_equal(inv_box[t[t < n]], offs[ci] + sc)


def _grid_tables(n, seed, radius):
    pts = generate_blue_noise(n, seed=seed)
    jg = ck.build_grid(pts)
    sc = _boxes_grid(-(-jg.dim // 3))
    own = _box_cell_ids(sc, 0, 0, 3, jg.dim)
    cand = _box_cell_ids(sc, -radius, radius, 3, jg.dim)
    return jg, own, cand


def test_pack_cells_equal_to_jax():
    jg, own, cand = _grid_tables(2500, 5, 2)
    for cells, cap in ((own, 96), (cand, 1152)):
        ji, jo = jpack_cells(jnp.asarray(cells), jg.cell_starts,
                             jg.cell_counts, cap)
        pi, po = ppack_cells(torch.as_tensor(cells),
                             torch.tensor(np.asarray(jg.cell_starts)),
                             torch.tensor(np.asarray(jg.cell_counts)),
                             cap)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(po.numpy(), np.asarray(jo))


def test_pack_inputs_equal_to_jax():
    jg, own, cand = _grid_tables(2500, 5, 2)
    want = _pack_inputs(jg.points, jg.cell_starts, jg.cell_counts,
                        jnp.asarray(own), jnp.asarray(cand), 128, 1152)
    got = pack_inputs(*(torch.tensor(np.asarray(a)) for a in (
        jg.points, jg.cell_starts, jg.cell_counts)), torch.as_tensor(own),
        torch.as_tensor(cand), 128, 1152)
    # the JAX tuple is (q_idx, q_ok, qx, qy, qz, cx, cy, cz, qid, cid)
    pairs = zip((got.qx, got.qy, got.qz, got.cx, got.cy, got.cz, got.qid,
                 got.cid), want[2:])
    for g, w in pairs:
        w = np.asarray(w)
        np.testing.assert_array_equal(g.numpy(), w.reshape(g.shape))
    q_idx, q_ok = np.asarray(want[0]), np.asarray(want[1])
    np.testing.assert_array_equal(
        got.qid.numpy(), np.where(q_ok, q_idx, -2).reshape(got.qid.shape))


def test_select_radii_equal_to_jax():
    from cuda_knearests_tpu.ops.adaptive import select_radii
    from cuda_knearests_tpu.ops.rings import ring_occupancy

    pts = generate_clustered(5000, seed=2)
    counts = np.asarray(ck.build_grid(pts).cell_counts)
    dim = round(len(counts) ** (1 / 3))
    sc = _boxes_grid(-(-dim // 3))
    pc, cc = ring_occupancy(counts.reshape(dim, dim, dim), sc, 3, 6)
    for k in (1, 10, 50):
        np.testing.assert_array_equal(padapt.select_radii(pc, cc, k, 6),
                                      select_radii(pc, cc, k, 6))
