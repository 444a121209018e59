"""The port's package surface against the JAX package's: the top-level
exports, ``ops.gridhash.unpermute_neighbors`` and ``io.save_xyz``, on the
cases of ``tests/test_gridhash.py`` and ``tests/test_io.py``; and the
public methods and positional parameters of ``pod/reshard.py``'s classes
and functions."""

import inspect

import numpy as np
import pytest
import torch

import cuda_knearests_tpu as ck
from cuda_knearests_tpu.io import load_xyz as jax_load_xyz
from cuda_knearests_tpu.io import save_xyz as jax_save_xyz
import cuda_knearests_tpu_torch as pt
from cuda_knearests_tpu_torch.io import load_xyz, save_xyz


def test_top_level_exports_cover_the_reference():
    missing = sorted(set(ck.__all__) - set(pt.__all__))
    assert not missing, missing
    for name in ("build_plan", "solve", "unpermute_neighbors"):
        assert callable(getattr(pt, name))


@pytest.mark.parametrize("fill", [-1, -7])
def test_unpermute_neighbors_equals_jax(uniform_10k, fill):
    pts = uniform_10k
    g_j = ck.build_grid(pts)
    g_p = pt.build_grid(torch.as_tensor(pts))
    np.testing.assert_array_equal(g_p.permutation.numpy(),
                                  np.asarray(g_j.permutation))
    n = g_p.n_points
    rng = np.random.default_rng(3)
    table = rng.integers(0, n, (n, 4)).astype(np.int32)
    table[rng.random((n, 4)) < 0.2] = -1
    got = pt.unpermute_neighbors(g_p, torch.as_tensor(table), fill=fill)
    want = ck.unpermute_neighbors(g_j, table, fill=fill)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_unpermute_roundtrip_and_sentinel(uniform_10k):
    """tests/test_gridhash.py::test_unpermute_roundtrip on the port: a
    table whose entries are each row's own sorted index maps to each row's
    original index, and -1 passes through."""
    g = pt.build_grid(torch.as_tensor(uniform_10k))
    n = g.n_points
    own = torch.arange(n, dtype=torch.int32)[:, None].expand(n, 4)
    out = pt.unpermute_neighbors(g, own).numpy()
    np.testing.assert_array_equal(out, np.arange(n)[:, None]
                                  * np.ones((1, 4), int))
    nbr = own.clone()
    nbr[:, 0] = -1
    assert (pt.unpermute_neighbors(g, nbr).numpy()[:, 0] == -1).all()


def test_unpermute_empty_grid_unchanged():
    g = pt.build_grid(torch.empty((0, 3)), dim=4)
    table = torch.empty((0, 3), dtype=torch.int32)
    assert pt.unpermute_neighbors(g, table) is table


def test_save_xyz_roundtrip_and_bytes_equal_jax(tmp_path, rng):
    """tests/test_io.py::test_xyz_roundtrip on the port, and the file the
    port writes equals the reference's byte for byte."""
    pts = rng.random((257, 3)).astype(np.float32) * 123.0
    mine, theirs = str(tmp_path / "port.xyz"), str(tmp_path / "jax.xyz")
    save_xyz(mine, pts)
    jax_save_xyz(theirs, pts)
    back = load_xyz(mine)
    assert back.shape == (257, 3)
    np.testing.assert_allclose(back, pts, rtol=1e-6)
    np.testing.assert_array_equal(jax_load_xyz(mine), back)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


# -- the mutating pod's surface -------------------------------------------------

def _public_methods(cls):
    return sorted(n for n, v in vars(cls).items()
                  if not n.startswith("_")
                  and (callable(v) or isinstance(v, property)))


def _positional(fn):
    """Names of the positional parameters of ``fn``, in order."""
    return [p.name for p in inspect.signature(fn).parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


RESHARD_CLASSES = ("PodOverlay", "ElasticIndex", "RangeShard", "Migration",
                   "ShipRecord")


@pytest.mark.parametrize("name", RESHARD_CLASSES)
def test_reshard_class_surface_equals_jax(name):
    """Each class of ``pod/reshard.py`` has the reference's public methods
    and properties, each with the reference's positional parameters (the
    port adds only keyword-only ones, such as ``device``)."""
    from cuda_knearests_tpu.pod import reshard as jrs
    from cuda_knearests_tpu_torch.pod import reshard as prs

    want, got = getattr(jrs, name), getattr(prs, name)
    assert _public_methods(got) == _public_methods(want)
    for meth in ["__init__"] + _public_methods(want):
        a, b = vars(want).get(meth), vars(got).get(meth)
        if a is None or isinstance(a, property):
            continue
        fa = a.__func__ if isinstance(a, staticmethod) else a
        fb = b.__func__ if isinstance(b, staticmethod) else b
        assert _positional(fb) == _positional(fa), (name, meth)


def test_reshard_functions_and_exports_equal_jax():
    from cuda_knearests_tpu import pod as jpod
    from cuda_knearests_tpu.pod import reshard as jrs
    from cuda_knearests_tpu_torch import pod as ppod
    from cuda_knearests_tpu_torch.pod import reshard as prs

    assert ppod.__all__ == jpod.__all__
    assert prs.__all__ == jrs.__all__
    assert _positional(prs.morton_codes) == _positional(jrs.morton_codes)
    assert inspect.signature(prs.morton_codes).parameters["domain"] \
        .default == 1000.0
