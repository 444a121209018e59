"""The port's sharded path across two OS processes over gloo, on the CPU.

Two processes (``python -m cuda_knearests_tpu_torch.parallel``) join a
``torch.distributed`` group on a free localhost port, each holding two of
the four slabs of ``generate_uniform(20_000, seed=77)``: the exchange at
the process seam is point-to-point, the cell counts are gathered, each
process solves its own slabs.  Each slab's rows must equal the
single-process four-slab run's bit for bit, every row must be covered
exactly once, and the single-controller surfaces must refuse.  Each
process has a timeout and both are killed on failure, so a hung
rendezvous fails the test instead of stalling the suite.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import torch

from cuda_knearests_tpu_torch import KnnConfig
from cuda_knearests_tpu_torch.io import generate_uniform
from cuda_knearests_tpu_torch.parallel import ShardedKnnProblem

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, SEED, K = 20_000, 77, 8
TIMEOUT_S = 150


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_workers(out_dir, epilogue="auto"):
    port = _free_port()
    env = {key: v for key, v in os.environ.items()
           if key not in ("WORLD_SIZE", "RANK", "MASTER_ADDR",
                          "MASTER_PORT", "LOCAL_RANK")}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen(
        [sys.executable, "-m", "cuda_knearests_tpu_torch.parallel",
         "--rank", str(r), "--world", "2", "--address", f"localhost:{port}",
         "--out", str(out_dir), "--n", str(N), "--seed", str(SEED),
         "--k", str(K), "--slabs", "2", "--device", "cpu",
         "--backend", "gloo", "--epilogue", epilogue, "--threads", "1",
         "--timeout", "90"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} rc={p.returncode}\n{out[-4000:]}"
        assert f"WORKER_OK {r} slabs={[2 * r, 2 * r + 1]} backend=gloo" \
            in out, out[-2000:]


def test_two_processes_equal_the_single_process_mesh(tmp_path):
    _run_workers(tmp_path)
    points = generate_uniform(N, seed=SEED)
    sp = ShardedKnnProblem.prepare(points, config=KnnConfig(k=K),
                                   devices=[torch.device("cpu")] * 4)
    outs = sp.solve_device()
    seen = np.zeros((N,), np.int32)
    for d in range(4):
        got = np.load(tmp_path / f"rank{d // 2}_slab{d}.npz")
        sids = sp._chip_inputs(d)["sids"].numpy()
        real = sids >= 0
        np.testing.assert_array_equal(got["sids"], sids[real])
        for key, t in zip(("nbr", "d2", "cert"), outs[d]):
            np.testing.assert_array_equal(got[key], t.numpy()[real],
                                          err_msg=f"slab {d} {key}")
        seen[got["sids"]] += 1
        assert got["cert"].all()
    assert (seen == 1).all(), "every row is covered exactly once"
    ids, _, _ = sp.solve()
    rng = np.random.default_rng(5)
    seam = np.argsort(np.abs(points[:, 2] - 500.0))[:10]  # the process seam
    for qi in np.concatenate([rng.integers(0, N, 20), seam]):
        dd = ((points[qi] - points) ** 2).sum(-1)
        dd[qi] = np.inf
        assert set(ids[qi].tolist()) == set(
            np.argsort(dd, kind="stable")[:K].tolist()), qi


def test_two_processes_gather_epilogue(tmp_path):
    _run_workers(tmp_path, epilogue="gather")
    points = generate_uniform(N, seed=SEED)
    sp = ShardedKnnProblem.prepare(points, config=KnnConfig(k=K),
                                   devices=[torch.device("cpu")] * 4)
    outs = sp.solve_device()
    for d in range(4):
        got = np.load(tmp_path / f"rank{d // 2}_slab{d}.npz")
        real = sp._chip_inputs(d)["sids"].numpy() >= 0
        np.testing.assert_array_equal(got["nbr"], outs[d][0].numpy()[real])
        np.testing.assert_array_equal(got["d2"], outs[d][1].numpy()[real])


def test_parallel_package_imports_no_jax():
    """The sharded path imports neither JAX nor the JAX package (the
    hygiene scan of every port source covers parallel/ too)."""
    from test_torch_hygiene import _port_files

    scanned = {p.name for p in _port_files() if p.parent.name == "parallel"}
    assert {"__init__.py", "sharded.py", "distributed.py",
            "__main__.py"} <= scanned
    code = ("import sys, torch\n"
            "import cuda_knearests_tpu_torch.parallel as par\n"
            "import cuda_knearests_tpu_torch.parallel.__main__\n"
            "sp = par.ShardedKnnProblem.prepare([[1.0, 2.0, 3.0], "
            "[4.0, 5.0, 600.0]], config=par.sharded.KnnConfig(k=1), "
            "devices=[torch.device('cpu')] * 2)\n"
            "assert sp.solve()[2].all() and par.z_mesh(['cpu'])\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'cuda_knearests_tpu')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=REPO, timeout=120)


def test_init_distributed_contract_and_process_major_refusal(monkeypatch):
    """No arguments and no cluster environment: a no-op; a partial spec
    raises; a second call is a no-op; a mesh whose slabs are not
    process-major is refused with the reference's message."""
    import pytest
    import torch.distributed as dist

    from cuda_knearests_tpu_torch.parallel import distributed as pd
    from cuda_knearests_tpu_torch.parallel.sharded import Slab

    for key in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    pd.init_distributed()
    assert not dist.is_initialized() and pd.world_size() == 1
    with pytest.raises(ValueError, match="together"):
        pd.init_distributed("localhost:1", num_processes=2)
    pd.init_distributed(f"localhost:{_free_port()}", 1, 0, backend="gloo",
                        timeout_s=30)
    try:
        pd.init_distributed("localhost:1", 2, 1)  # joined already: no-op
        assert pd.world_size() == 1 and pd.rank() == 0
        cpu = torch.device("cpu")
        pd.check_process_major([Slab(0, cpu), Slab(0, cpu)])
        with pytest.raises(ValueError, match="not process-major"):
            pd.check_process_major([Slab(1, None), Slab(0, cpu)])
        assert pd.z_mesh(["cpu", "cpu"]) == [Slab(0, cpu), Slab(0, cpu)]
    finally:
        dist.destroy_process_group()
