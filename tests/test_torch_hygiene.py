"""Import hygiene of the PyTorch port: neither the package nor
``chip_smoke.py`` may import JAX or the JAX package, statically or at run
time, and ``chip_smoke.py`` refuses to run without a GPU or outside a
checkout."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "cuda_knearests_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "cuda_knearests_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_port_sources(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_import_leaves_jax_out_of_sys_modules():
    code = ("import sys, cuda_knearests_tpu_torch as pt\n"
            "import cuda_knearests_tpu_torch.api, "
            "cuda_knearests_tpu_torch.ops.adaptive, "
            "cuda_knearests_tpu_torch.mxu.kernel\n"
            "import cuda_knearests_tpu_torch.mxu as mxu\n"
            "import cuda_knearests_tpu_torch.cluster, "
            "cuda_knearests_tpu_torch.cluster.compare\n"
            "import cuda_knearests_tpu_torch.serve, "
            "cuda_knearests_tpu_torch.serve.__main__, "
            "cuda_knearests_tpu_torch.obs.metrics, "
            "cuda_knearests_tpu_torch.obs.spans, "
            "cuda_knearests_tpu_torch.runtime.supervisor, "
            "cuda_knearests_tpu_torch.runtime.worker, "
            "cuda_knearests_tpu_torch.obs.recorder, "
            "cuda_knearests_tpu_torch.utils.watchdog, "
            "cuda_knearests_tpu_torch.fuzz.__main__, "
            "cuda_knearests_tpu_torch.fuzz.approx, "
            "cuda_knearests_tpu_torch.fuzz.fof, "
            "cuda_knearests_tpu_torch.fuzz.mutation, "
            "cuda_knearests_tpu_torch.fuzz.pod, "
            "cuda_knearests_tpu_torch.fuzz.fleet, "
            "cuda_knearests_tpu_torch.fuzz.chaos, "
            "cuda_knearests_tpu_torch.serve.fleet.elastic, "
            "cuda_knearests_tpu_torch.analysis, "
            "cuda_knearests_tpu_torch.analysis.findings, "
            "cuda_knearests_tpu_torch.analysis.models, "
            "cuda_knearests_tpu_torch.analysis.proto, "
            "cuda_knearests_tpu_torch.analysis.rules, "
            "cuda_knearests_tpu_torch.analysis.concurrency, "
            "cuda_knearests_tpu_torch.analysis.lint, "
            "cuda_knearests_tpu_torch.analysis.syncflow, "
            "cuda_knearests_tpu_torch.analysis.equiv, "
            "cuda_knearests_tpu_torch.analysis.verify, "
            "cuda_knearests_tpu_torch.analysis.contracts, "
            "cuda_knearests_tpu_torch.analysis.cli\n"
            "from cuda_knearests_tpu_torch.analysis import (run_lint, "
            "run_proto)\n"
            "assert not [f for f in run_proto() if f.severity != 'info']\n"
            "assert not [f for f in run_lint() if f.severity != 'info']\n"
            "from cuda_knearests_tpu_torch.fuzz.campaign import run_campaign\n"
            "assert run_campaign(n_cases=2, routes=('adaptive',), "
            "bank_dir=None, log=None, device='cpu')['ok']\n"
            "d = pt.serve.ServeDaemon(pt.KnnProblem.prepare("
            "[[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]], pt.KnnConfig(k=1), "
            "device='cpu'))\n"
            "d.submit(1, 'fof', 5.0); d.submit(2, 'query', [[1.0, 2.0, 3.0]])\n"
            "assert all(r.ok for r in d.drain()); d.metrics_snapshot()\n"
            "mxu.solve_general([[1.0, 2.0], [3.0, 4.0]], k=1, "
            "device='cpu')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(ROOT), timeout=120)


def test_chip_smoke_refuses_without_gpu_or_checkout(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, alone)):
        proc = subprocess.run([sys.executable, str(script)], cwd=str(cwd),
                              env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
