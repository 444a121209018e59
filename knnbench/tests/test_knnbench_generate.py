"""The frozen recipes give the port's ``io.py`` arrays, and the check's
row sample is drawn from the seed."""

import json
from pathlib import Path

import numpy as np
import pytest

from cuda_knearests_tpu_torch import io as port_io
from knnbench import generate

TRAFFIC = Path(generate.__file__).resolve().parent / "traffic"


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
@pytest.mark.parametrize("recipe,port", [
    ("uniform", port_io.generate_uniform),
    ("blue_noise", port_io.generate_blue_noise),
    ("clustered", port_io.generate_clustered)])
def test_recipe_equals_port(recipe, port, seed):
    ours = generate.make_cloud({"cloud": {"recipe": recipe}}, 5000, seed,
                               1000.0)
    np.testing.assert_array_equal(ours, port(5000, seed=seed, domain=1000.0))
    assert ours.dtype == np.float32 and ours.shape == (5000, 3)


def test_clustered_params_from_data():
    mix = {"cloud": {"recipe": "clustered",
                     "params": {"n_blobs": 5, "blob_fraction": 0.3}}}
    np.testing.assert_array_equal(
        generate.make_cloud(mix, 4000, 3, 1000.0),
        port_io.generate_clustered(4000, seed=3, n_blobs=5,
                                   blob_fraction=0.3))


def test_seed_900_is_the_900k_cube():
    with open(TRAFFIC / "blue.json") as f:
        blue = json.load(f)
    cube = generate.make_cloud(blue, 900_000, 900, 1000.0)
    np.testing.assert_array_equal(
        cube, port_io._GENERATORS["900k_blue_cube.xyz"]())


def test_negative_seed_wraps_and_unknown_recipe_refused():
    mix = {"cloud": {"recipe": "uniform"}}
    np.testing.assert_array_equal(
        generate.make_cloud(mix, 100, -1, 1000.0),
        generate.make_cloud(mix, 100, 2 ** 64 - 1, 1000.0))
    with pytest.raises(ValueError, match="unknown recipe"):
        generate.make_cloud({"cloud": {"recipe": "spiral"}}, 10, 0, 1.0)


def test_a_new_recipe_is_a_new_file(tmp_path):
    (tmp_path / "lattice.py").write_text(
        "import numpy as np\n\n"
        "def make_cloud(n, seed, domain, step=1.0):\n"
        "    i = np.arange(n, dtype=np.float32)\n"
        "    return np.stack([i * step, i * 0, i * 0], 1) % domain\n")
    mix = {"cloud": {"recipe": "lattice", "params": {"step": 2.0}}}
    pts = generate.make_cloud(mix, 10, 1, 1000.0,
                              dirs=[tmp_path, generate.RECIPES])
    np.testing.assert_array_equal(pts[:, 0], np.arange(10) * 2.0)
    # the shipped recipes stay reachable beside it
    generate.make_cloud({"cloud": {"recipe": "uniform"}}, 10, 1, 1000.0,
                        dirs=[tmp_path, generate.RECIPES])


def test_row_sampler_is_seeded():
    a = generate.RowSampler(2 ** 31 + 9, 10_000, 16)
    b = generate.RowSampler(2 ** 31 + 9, 10_000, 16)
    rows = [a.next() for _ in range(5)]
    for r in rows:
        assert len(np.unique(r)) == 16 and r.min() >= 0 and r.max() < 10_000
        np.testing.assert_array_equal(r, b.next())
    assert not np.array_equal(rows[0], rows[1])
    np.testing.assert_array_equal(a.subsample(50, 100), np.arange(50))
    pick = a.subsample(500, 100)
    assert len(np.unique(pick)) == 100 and pick.max() < 500
