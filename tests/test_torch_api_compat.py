"""The port's API surface against the JAX package's, call for call:
``KnnProblem.prepare``'s positional order ``(points, config, dim,
validate)`` with ``device`` keyword-only, ``with_points(validate=)``, and
every field of the reference ``KnnConfig``: the honoured knobs give the
reference's answers, ``interpret`` and ``stream_tile`` are accepted at the
reference's default and refused otherwise with ``InvalidConfigError``
naming the field.  The JAX side runs its Pallas kernels in interpret mode,
as its own tests do on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

import cuda_knearests_tpu as ck
from cuda_knearests_tpu.io import generate_uniform
from cuda_knearests_tpu.utils import memory as jmemory
import cuda_knearests_tpu_torch as pt
from cuda_knearests_tpu_torch.utils.memory import (InvalidConfigError,
                                                   NoDeviceError)

KNOBS = ("sc_batch", "interpret", "stream_tile", "hbm_budget_bytes",
         "epilogue", "query_chunk")


@pytest.fixture(scope="module")
def cloud():
    return generate_uniform(2000, seed=1)


def test_prepare_takes_dim_positionally(cloud):
    jp = ck.KnnProblem.prepare(cloud, ck.KnnConfig(k=8, interpret=True), 12)
    pp = pt.KnnProblem.prepare(cloud, pt.KnnConfig(k=8), 12, device="cpu")
    assert jp.grid.dim == pp.grid.dim == 12
    np.testing.assert_array_equal(pp.grid.permutation.numpy(),
                                  np.asarray(jp.grid.permutation))
    pp.solve()
    jp.solve()
    # XLA's CPU backend may contract the distance's multiply-adds
    np.testing.assert_allclose(pp.get_dists_sq(), jp.get_dists_sq(),
                               rtol=1e-4, atol=1e-2)


def test_prepare_takes_validate_positionally(cloud):
    out = cloud.copy()
    out[0, 0] = 1000.5  # outside the domain: only the front door refuses
    with pytest.raises(jmemory.DomainBoundsError):
        ck.KnnProblem.prepare(out, ck.KnnConfig(k=8, interpret=True), None,
                              True)
    with pytest.raises(pt.utils.memory.DomainBoundsError):
        pt.KnnProblem.prepare(out, pt.KnnConfig(k=8), None, True,
                              device="cpu")
    jp = ck.KnnProblem.prepare(out, ck.KnnConfig(k=8, interpret=True), None,
                               False)
    pp = pt.KnnProblem.prepare(out, pt.KnnConfig(k=8), None, False,
                               device="cpu")
    np.testing.assert_array_equal(pp.grid.cell_counts.numpy(),
                                  np.asarray(jp.grid.cell_counts))
    assert pp.host_points.dtype == np.float32


def test_device_is_keyword_only(cloud):
    cfg = pt.KnnConfig(k=8)
    with pytest.raises(TypeError):
        pt.KnnProblem.prepare(cloud, cfg, None, True, "cpu")
    # a device given positionally lands in dim, which it is not, and the
    # problem stays on the default device (the GPU, absent here)
    with pytest.raises((TypeError, ValueError)):
        pt.KnnProblem.prepare(cloud, cfg, "cpu", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(NoDeviceError):
            pt.KnnProblem.prepare(cloud, cfg, "cpu")
    with pytest.raises((TypeError, ValueError)):
        ck.KnnProblem.prepare(cloud, ck.KnnConfig(k=8, interpret=True),
                              "cpu")
    pp = pt.KnnProblem.prepare(cloud, cfg, device="cpu")
    assert pp.device.type == "cpu" and pp.grid.dim == ck.KnnProblem.prepare(
        cloud, ck.KnnConfig(k=8, interpret=True)).grid.dim


@pytest.mark.parametrize("validate", [True, False])
def test_with_points_validate_matches_jax(cloud, validate):
    jp = ck.KnnProblem.prepare(cloud, ck.KnnConfig(k=8, interpret=True))
    pp = pt.KnnProblem.prepare(cloud, pt.KnnConfig(k=8), device="cpu")
    sub = cloud[:1500]
    jq = jp.with_points(sub, validate=validate)
    pq = pp.with_points(sub, validate=validate)
    assert pq.device == pp.device and pq.config == pp.config
    jq.solve()
    pq.solve()
    np.testing.assert_array_equal(pq.get_knearests_original(),
                                  jq.get_knearests_original())
    np.testing.assert_array_equal(pq.host_points, sub)


def test_config_has_every_reference_field_at_its_default():
    ref = {f.name: f.default for f in dataclasses.fields(ck.KnnConfig)}
    port = {f.name: f.default for f in dataclasses.fields(pt.KnnConfig)}
    assert set(ref) == set(port)
    assert port == ref


@pytest.mark.parametrize("name", KNOBS)
def test_runtime_knob_accepted_at_its_default(name):
    default = next(f.default for f in dataclasses.fields(ck.KnnConfig)
                   if f.name == name)
    assert getattr(ck.KnnConfig(**{name: default}), name) == default
    assert getattr(pt.KnnConfig(**{name: default}), name) == default


REFUSED_KNOBS = [("stream_tile", 1024), ("interpret", True)]


@pytest.mark.parametrize("name,value", REFUSED_KNOBS,
                         ids=[n for n, _ in REFUSED_KNOBS])
def test_runtime_knob_refused_elsewhere(name, value):
    assert getattr(ck.KnnConfig(**{name: value}), name) == value
    with pytest.raises(InvalidConfigError, match=name):
        pt.KnnConfig(**{name: value})


# Knobs the port honours, each with the rest of a config that reaches the
# route it tunes, run through both packages.
HONOURED_KNOBS = [
    ("hbm_budget_bytes", 1 << 30, {}),
    ("query_chunk", 256, dict(adaptive=False)),
    ("epilogue", "gather", {}),
    ("sc_batch", 8, dict(adaptive=False, backend="xla")),
    ("adaptive", False, {}),
    ("backend", "xla", {}),
    ("backend", "oracle", {}),
    ("dist_method", "dot", {}),
]


@pytest.mark.parametrize("name,value,rest", HONOURED_KNOBS,
                         ids=[f"{n}={v}" for n, v, _ in HONOURED_KNOBS])
def test_runtime_knob_honoured_like_jax(cloud, name, value, rest):
    """A knob the reference honours gives its answers in the port: the
    self-solve's ids and the queries' ids equal, d2 within the tie-aware
    band (the 'dot' form's within its own rounding of |p|^2 ~ 3e6)."""
    kw = dict(k=8, **{name: value}, **rest)
    jp = ck.KnnProblem.prepare(cloud, ck.KnnConfig(interpret=True, **kw))
    pp = pt.KnnProblem.prepare(cloud, pt.KnnConfig(**kw), device="cpu")
    assert getattr(pp.config, name) == value
    assert pp._route_name() == jp._route_name()
    jp.solve()
    pp.solve()
    np.testing.assert_array_equal(pp.get_knearests_original(),
                                  jp.get_knearests_original())
    # the 'dot' form rounds terms of magnitude max |p|^2: a band of 16
    # eps32 of it (as tests/test_torch_legacy.py holds it)
    atol = (16 * float(np.finfo(np.float32).eps)
            * float((cloud.astype(np.float64) ** 2).sum(1).max())
            if value == "dot" else 1e-2)
    np.testing.assert_allclose(pp.get_dists_sq(), jp.get_dists_sq(),
                               rtol=1e-4, atol=atol)
    queries = generate_uniform(300, seed=2)
    (pi, pd), (ji, jd) = pp.query(queries), jp.query(queries)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pd, jd, rtol=1e-4, atol=1e-2)


def test_epilogue_scatter_is_what_the_port_does():
    assert ck.KnnConfig(epilogue="scatter").epilogue == "scatter"
    assert pt.KnnConfig(epilogue="scatter").epilogue == "scatter"
    assert pt.KnnConfig().resolved_epilogue() == "scatter"
    assert pt.KnnConfig(epilogue="gather").resolved_epilogue() == "gather"
    with pytest.raises(InvalidConfigError, match="epilogue"):
        pt.KnnConfig(epilogue="fused")


def test_checkpoint_with_runtime_knobs_reads_back(cloud, tmp_path):
    """load_problem keeps the honoured knobs and drops ``interpret`` and
    ``stream_tile``, whatever their saved values."""
    cfg = ck.KnnConfig(k=6, interpret=True, hbm_budget_bytes=1 << 30,
                       stream_tile=1024, epilogue="gather", sc_batch=8,
                       query_chunk=256)
    jp = ck.KnnProblem.prepare(cloud, cfg)
    path = str(tmp_path / "knobs")
    ck.save_problem(jp, path)
    loaded = pt.load_problem(path, device="cpu")
    assert loaded.config == pt.KnnConfig(
        k=6, hbm_budget_bytes=1 << 30, epilogue="gather", sc_batch=8,
        query_chunk=256)
    jp.solve()
    loaded.solve()
    np.testing.assert_array_equal(loaded.get_knearests_original(),
                                  jp.get_knearests_original())
