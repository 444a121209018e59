"""Nothing the benchmark runs imports JAX or the JAX package, and the
yardstick imports nothing of the port."""

import ast
import json
import os
import shutil
import subprocess
import sys

from knnbench import run, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "cuda_knearests_tpu"}
PROGRAM = "cuda_knearests_tpu_torch"
# the one module that reaches the program (the tests may too)
MAY_IMPORT_PROGRAM = {"run.py"}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _sources():
    return sorted(spec.BENCH_DIR.rglob("*.py"))


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not _imports(path) & FORBIDDEN, path


def test_the_yardstick_imports_nothing_of_the_port():
    for path in _sources():
        if path.parent.name == "tests" or path.name in MAY_IMPORT_PROGRAM:
            continue
        assert PROGRAM not in _imports(path), path


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "cuda_knearests_tpu_torch_x", sys)
    assert "cuda_knearests_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "cuda_knearests_tpu.api", sys)
    assert "cuda_knearests_tpu" in run.forbidden_modules()


def _bench(cwd, *extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "-m", "knnbench", "--workload", "ref900k_k50.blue",
         "--seed", "1", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def _no_result(p):
    return not any(line.lstrip().startswith("{")
                   for line in p.stdout.splitlines())


def test_no_card_no_result():
    p = _bench(spec.ROOT)
    assert p.returncode != 0 and _no_result(p)
    assert "CUDA device" in p.stderr


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "knnbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _bench(tmp_path)
    assert p.returncode != 0 and _no_result(p)


def test_a_run_loads_no_jax():
    code = ("from knnbench import run, spec\n"
            "c = spec.cell(spec.load_benchmark(), 'uniform10m_k10.uniform')\n"
            "out = run.run(c, 3, 0.2, True, device='cpu', n_points=2000,"
            " log=lambda *a: None)\n"
            "import json, sys\n"
            "print(json.dumps([out['correct'], run.forbidden_modules()]))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == [True, []]
