"""PyTorch port against the JAX package: input front door, grid build and
ring occupancy.

The same numpy inputs go through both packages.  Integer outputs and the
gathered coordinates are exact copies, so they must be equal, not close.
"""

import numpy as np
import pytest
import torch

from cuda_knearests_tpu import io as jio
from cuda_knearests_tpu.ops import gridhash as jgrid
from cuda_knearests_tpu.ops import rings as jrings
from cuda_knearests_tpu.utils import memory as jmem
from cuda_knearests_tpu_torch import io as pio
from cuda_knearests_tpu_torch.ops import gridhash as pgrid
from cuda_knearests_tpu_torch.ops import rings as prings
from cuda_knearests_tpu_torch.utils import memory as pmem

GENERATORS = {
    "uniform": (jio.generate_uniform, pio.generate_uniform),
    "blue": (jio.generate_blue_noise, pio.generate_blue_noise),
    "clustered": (jio.generate_clustered, pio.generate_clustered),
}


@pytest.mark.parametrize("gen", sorted(GENERATORS))
@pytest.mark.parametrize("n", [0, 1, 2000, 20626])
def test_grid_equal_to_jax(gen, n):
    jgen, pgen = GENERATORS[gen]
    if n:
        pts = jgen(n, seed=11)
        np.testing.assert_array_equal(pgen(n, seed=11), pts)
    else:  # the blue-noise generator takes n >= 1; an empty cloud is legal
        pts = np.zeros((0, 3), np.float32)
    jg = jgrid.build_grid(pts)
    pg = pgrid.build_grid(torch.as_tensor(pts))
    assert pg.dim == jg.dim and pg.domain == jg.domain
    for name in ("points", "permutation", "cell_starts", "cell_counts"):
        want = np.asarray(getattr(jg, name))
        got = getattr(pg, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_cell_coords_on_cell_boundaries():
    # coordinates that land exactly on (and one ulp around) cell faces,
    # where a scale rounded differently would move points between cells
    dim = 66
    edges = np.arange(dim + 1, dtype=np.float64) * (1000.0 / dim)
    vals = np.concatenate([edges, np.nextafter(edges, 0),
                           np.nextafter(edges, 2000)]).astype(np.float32)
    vals = np.clip(vals, 0, 1000)
    pts = np.stack([vals, vals[::-1], np.roll(vals, 7)], axis=1)
    want = np.asarray(jgrid.cell_coords(pts, dim))
    got = pgrid.cell_coords(torch.as_tensor(pts), dim).numpy()
    np.testing.assert_array_equal(got, want)


def test_ring_occupancy_equal_to_jax():
    pts = jio.generate_clustered(5000, seed=4)
    counts = np.asarray(jgrid.build_grid(pts).cell_counts)
    dim = round(len(counts) ** (1 / 3))
    counts3 = counts.reshape(dim, dim, dim)
    n_sc = -(-dim // 3)
    r = np.arange(n_sc)
    sc = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    for a, b in zip(jrings.ring_occupancy(counts3, sc, 3, 5),
                    prings.ring_occupancy(counts3, sc, 3, 5)):
        np.testing.assert_array_equal(a, b)


def test_normalize_and_load_equal_to_jax(tmp_path):
    raw = np.random.default_rng(3).normal(size=(500, 3)) * 37.0 + 5.0
    np.testing.assert_array_equal(pio.normalize_points(raw),
                                  jio.normalize_points(raw))
    path = tmp_path / "p.xyz"
    jio.save_xyz(str(path), raw.astype(np.float32))
    np.testing.assert_array_equal(pio.load_xyz(str(path)),
                                  jio.load_xyz(str(path)))


BAD_INPUTS = [
    ("shape", np.zeros((5, 2), np.float32), 10, "InvalidShapeError"),
    ("ndim", np.zeros((5,), np.float32), 10, "InvalidShapeError"),
    ("nan", np.array([[1, 2, np.nan]], np.float32), 10,
     "NonFiniteInputError"),
    ("bounds", np.array([[1, 2, 1001]], np.float32), 10, "DomainBoundsError"),
    ("negative", np.array([[-1, 2, 3]], np.float32), 10, "DomainBoundsError"),
    ("k0", np.zeros((5, 3), np.float32), 0, "InvalidKError"),
    ("kbool", np.zeros((5, 3), np.float32), True, "InvalidKError"),
    ("kfloat", np.zeros((5, 3), np.float32), 2.5, "InvalidKError"),
]


@pytest.mark.parametrize("case", BAD_INPUTS, ids=[c[0] for c in BAD_INPUTS])
def test_front_door_refuses_like_jax(case):
    _, pts, k, cls = case
    with pytest.raises(getattr(jmem, cls)):
        jio.validate_or_raise(pts, k=k)
    with pytest.raises(getattr(pmem, cls)) as e:
        pio.validate_or_raise(pts, k=k)
    assert e.value.kind == "invalid-input"


def test_front_door_accepts_like_jax():
    for pts in (np.zeros((0, 3)), np.full((4, 3), 1000.0),
                jio.generate_blue_noise(100, seed=1)):
        np.testing.assert_array_equal(pio.validate_or_raise(pts, k=7),
                                      jio.validate_or_raise(pts, k=7))
