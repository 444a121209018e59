"""Mesh failover of the PyTorch port against the JAX package's, on the CPU.

The same numpy clouds go through both packages' ``serve/fleet/elastic``:
the JAX functions as ``tests/test_fleet.py`` runs them, the port's with
``device='cpu'`` (the kernels' plain versions).

* Snapshots: for the same cloud, k, committed seq and shard count both
  ``write_snapshot``\\ s give the same field names, equal arrays and the
  same sha256; each package's ``load_snapshot`` reads the other's file
  back to the same state; a torn file, a flipped bit and a stale schema
  raise each package's ``CorruptInputError``.
* The parent-side checks on one shipped shard state: ``state_cloud``
  equal array for array, ``mesh_oracle_query`` ids equal and d2 within
  RTOL 1e-4 / ATOL 1e-2, tie-aware (``fuzz/compare.check_route_result``;
  XLA's CPU backend contracts multiply-adds, torch rounds each operation).
* The port's ``mesh_failover_drill`` at the reference test's size, with
  the reference test's assertions (the JAX drill has its own test).
"""

import os

import numpy as np
import pytest
import torch

from cuda_knearests_tpu.serve.fleet import elastic as jel
from cuda_knearests_tpu.utils.memory import \
    CorruptInputError as JCorruptInputError
from cuda_knearests_tpu_torch.fuzz.compare import check_route_result
from cuda_knearests_tpu_torch.io import generate_uniform
from cuda_knearests_tpu_torch.pod.reshard import ElasticIndex
from cuda_knearests_tpu_torch.serve.fleet import elastic as pel
from cuda_knearests_tpu_torch.utils.memory import CorruptInputError

RTOL, ATOL = 1e-4, 1e-2


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _fields(path):
    with np.load(path) as z:
        return {name: np.asarray(z[name]) for name in z.files}


@pytest.mark.parametrize("n,k,seq,nshards", [(700, 6, 5, 2), (257, 10, 0, 3)])
def test_snapshot_bytes_and_digest_equal_jax(tmp_path, n, k, seq, nshards):
    pts = generate_uniform(n, seed=n + k)
    ji = jel.write_snapshot(str(tmp_path / "jax"), pts, k, seq, nshards)
    pi = pel.write_snapshot(str(tmp_path / "port"), pts, k, seq, nshards,
                            device="cpu")
    assert pi["sha256"] == ji["sha256"]
    assert pi["path"].endswith(".npz") and ji["path"].endswith(".npz")
    for key in ("committed_seq", "n_points"):
        assert pi[key] == ji[key]
    jf, pf = _fields(ji["path"]), _fields(pi["path"])
    assert sorted(jf) == sorted(pf)
    for name in jf:
        assert jf[name].dtype == pf[name].dtype, name
        np.testing.assert_array_equal(jf[name], pf[name], err_msg=name)
    # each package reads the other's file back to the same state
    for load in (jel.load_snapshot, pel.load_snapshot):
        a, b = load(ji["path"]), load(pi["path"])
        np.testing.assert_array_equal(a["points"], pts)
        np.testing.assert_array_equal(b["points"], pts)
        for key in ("committed_seq", "k", "nshards", "sha256"):
            assert a[key] == b[key]
        assert (a["committed_seq"], a["k"], a["nshards"]) == (seq, k,
                                                               nshards)


def test_snapshot_refusals_typed_in_both(tmp_path):
    pts = generate_uniform(300, seed=3)
    info = pel.write_snapshot(str(tmp_path / "good"), pts, 8, 2, 2,
                              device="cpu")
    fields = _fields(info["path"])
    torn = tmp_path / "torn.npz"
    raw = open(info["path"], "rb").read()
    torn.write_bytes(raw[: len(raw) // 2])
    stale = dict(fields)
    stale["schema"] = np.bytes_(b"kntpu-mesh-snapshot-v0")
    np.savez_compressed(tmp_path / "stale.npz", **stale)
    flipped = dict(fields)
    p = np.array(flipped["points"])
    p.view(np.uint32)[0, 0] ^= 1
    flipped["points"] = p
    np.savez_compressed(tmp_path / "flipped.npz", **flipped)
    bare = {k: v for k, v in fields.items() if k != "sha256"}
    np.savez_compressed(tmp_path / "bare.npz", **bare)
    cases = {"torn.npz": "unreadable", "stale.npz": "stale or unknown",
             "flipped.npz": "checksum mismatch",
             "bare.npz": "missing schema", "absent.npz": "unreadable"}
    for name, needle in cases.items():
        with pytest.raises(CorruptInputError, match=needle):
            pel.load_snapshot(str(tmp_path / name))
        with pytest.raises(JCorruptInputError, match=needle):
            jel.load_snapshot(str(tmp_path / name))


def _shipped_state():
    """A pod index mid-migration with inserts and deletes, shipped as the
    reference's child ships it (JSON lists)."""
    el = ElasticIndex(generate_uniform(800, seed=21), k=6, nshards=3,
                      migration_chunk=8, device="cpu")
    rng = np.random.default_rng(5)
    el.insert((rng.random((60, 3)) * 110 + 5).astype(np.float32))
    el.delete(np.sort(rng.choice(el.n_points, size=9, replace=False)))
    assert el.force_rebalance()
    for _ in range(3):
        el.pump()
    el.insert((rng.random((7, 3)) * 980 + 10).astype(np.float32))
    assert el.migration is not None
    return el, {"k": el.k, "uids_canonical": el.uids_canonical.tolist(),
                "shards": [{"uids": s.uids.tolist(),
                            "points": s.points().tolist()}
                           for s in el.shards]}


def test_state_cloud_and_oracle_equal_jax():
    el, state = _shipped_state()
    cloud = pel.state_cloud(state)
    np.testing.assert_array_equal(cloud, jel.state_cloud(state))
    np.testing.assert_array_equal(cloud, el.mutated_points())
    q = (np.random.default_rng(9).random((40, 3)) * 980 + 10).astype(
        np.float32)
    pi, pd = pel.mesh_oracle_query(state, q, 6, device="cpu")
    ji, jd = jel.mesh_oracle_query(state, q, 6)
    ji, jd = np.asarray(ji), np.asarray(jd)
    assert pi.dtype == np.int32 and pd.dtype == np.float32
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pd, jd, rtol=RTOL, atol=ATOL)
    assert check_route_result(cloud, q, pi, pd, jd, 6) is None
    # the port's oracle is the index's own rebuild oracle, byte for byte
    ri, rd = el.rebuild_oracle_query(q, 6)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_array_equal(pd, rd)
    # arrays shipped through the child's .npz give the same answers
    arr_state = {"k": state["k"],
                 "uids_canonical": np.asarray(state["uids_canonical"]),
                 "shards": [{key: np.asarray(v) for key, v in sh.items()}
                            for sh in state["shards"]]}
    np.testing.assert_array_equal(pel.state_cloud(arr_state), cloud)
    ai, ad = pel.mesh_oracle_query(arr_state, q, 6, device="cpu")
    np.testing.assert_array_equal(ai, pi)
    np.testing.assert_array_equal(ad, pd)


def test_state_cloud_missing_uid_raises_as_jax():
    _, state = _shipped_state()
    state["uids_canonical"] = state["uids_canonical"] + [10 ** 6]
    with pytest.raises(KeyError):
        jel.state_cloud(state)
    with pytest.raises(KeyError):
        pel.state_cloud(state)


def test_mesh_failover_drill_sigkill_mid_migration():
    """The port's cross-mesh drill with both children on the CPU: the
    reference test's assertions (tests/test_fleet.py)."""
    drill = pel.mesh_failover_drill(n=900, k=6, ops=26, seed=0, log=None,
                                    device="cpu")
    assert drill["device"] == "cpu"
    assert drill["killed_mid_migration"] is True
    assert drill["mesh_failovers"] >= 1
    assert drill["zero_lost_committed"] is True
    assert drill["post_failover_byte_identical"] is True
    assert drill["post_failover_exact"] is True
    assert drill["mesh_failover_ok"] is True
    assert drill["replay_tail"] >= drill["snapshot_seq"]
    # each child reports where its shards live; on the CPU no kernel runs
    for report in (drill["primary_at_kill"], drill["mesh_child"]):
        assert report["device"] == "cpu"
        assert sum(report["launches"].values()) == 0
    assert drill["card_free_bytes_both_meshes"] is None
    assert set(drill["latency_decomposition"]) == {
        "total_ms", "queue_ms", "dispatch_ms", "device_ms"}
    mig = drill["migration_at_kill"]
    assert mig is not None and 0 < mig["shipped"] < mig["queued"]
    t = drill["timing"]
    assert t["snapshot_bytes"] > 0 and t["replayed"] >= 1
    assert 0 < t["drill_s"]


def test_mesh_controller_refuses_failover_without_snapshot():
    from cuda_knearests_tpu_torch.utils.memory import TransportError

    ctl = pel.MeshController(generate_uniform(300, seed=4), 6,
                             device="cpu")
    try:
        ctl.mutate("insert", np.full((2, 3), 50.0, np.float32))
        assert ctl.primary.state()["seq"] == 1
        with pytest.raises(TransportError, match="no snapshot"):
            ctl.failover()
        ctl.snapshot()
        ctl.kill_primary()
        info = ctl.failover()
        assert info["restored_seq"] == 1 and info["replayed"] == 0
        assert ctl.primary.state()["seq"] == ctl.log.committed_seq == 1
        np.testing.assert_array_equal(
            pel.state_cloud(ctl.primary.shards()), ctl.expected_points())
    finally:
        ctl.close()
    assert not os.path.exists(ctl.spec_path)
