"""``BENCHMARK.json`` and the files it names: a cell's configuration,
traffic mix and metrics, found by name.

A configuration is ``file`` of its ``configs`` entry; a traffic mix is
``traffic/<name>.json``, whose cloud is made by ``recipes/<recipe>.py``; a
metric is read by ``metrics/<name>.py``.  A new cell, mix, recipe or
metric is a new file and a new entry: nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Any, Iterable, List

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


class SpecError(ValueError):
    """``BENCHMARK.json`` or a file it names is missing or malformed."""


@dataclasses.dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` with everything it names loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_benchmark(root: Path = ROOT) -> dict:
    return _json(Path(root) / "BENCHMARK.json")


def _json(path: Path) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise SpecError(f"cannot read {path}: {e}") from e


def load_from_file(name: str, dirs: Iterable[Path], attr: str) -> Any:
    """``attr`` of the first ``<dir>/<name>.py`` found in ``dirs``."""
    for d in dirs:
        path = Path(d) / f"{name}.py"
        if path.is_file():
            mod_name = f"knnbench_{Path(d).name}_" + name.replace(".", "_")
            spec = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return getattr(mod, attr)
    raise FileNotFoundError(f"no {name}.py in {[str(d) for d in dirs]}")


def applies(metric: dict, cell: str) -> bool:
    """A metric is reported in a cell unless its ``workloads`` leave the
    cell out."""
    return "workloads" not in metric or cell in metric["workloads"]


def cell(spec: dict, name: str, root: Path = ROOT,
         bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``spec`` with its files loaded."""
    work = next((w for w in spec.get("workloads", []) if w["name"] == name),
                None)
    if work is None:
        known = [w["name"] for w in spec.get("workloads", [])]
        raise SpecError(f"unknown workload {name!r}; BENCHMARK.json has "
                        f"{known}")
    conf = next((c for c in spec.get("configs", [])
                 if c["name"] == work["config"]), None)
    if conf is None:
        raise SpecError(f"workload {name!r} names config "
                        f"{work['config']!r}, which BENCHMARK.json lacks")
    return Cell(
        name=name, chips=int(work["chips"]),
        config=_json(Path(root) / conf["file"]),
        traffic=_json(Path(bench_dir) / "traffic" / f"{work['traffic']}.json"),
        end_to_end=[m for m in spec.get("end_to_end", [])
                    if applies(m, name)],
        per_layer=[m for m in spec.get("per_layer", []) if applies(m, name)])
