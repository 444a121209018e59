"""One reader a metric: ``metrics/<name>.py`` defines ``read(ctx)``, which
takes the metric from a :class:`knnbench.context.RunContext` and returns
a number, or None where the run holds nothing to read.  A reader never
returns 0 for a share of a peak or a roofline it could not measure."""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional

from ..spec import load_from_file

HERE = Path(__file__).resolve().parent


def load_reader(name: str, dirs: Iterable[Path] = (HERE,)
                ) -> Callable[[object], Optional[float]]:
    """The ``read`` function of the first ``<dir>/<name>.py`` found."""
    return load_from_file(name, dirs, "read")


def read_metrics(entries: List[dict], ctx,
                 dirs: Iterable[Path] = (HERE,)) -> Dict[str, dict]:
    """``{name: {"value", "unit"}}`` of every metric entry whose reader
    found something to read."""
    out = {}
    for m in entries:
        value = load_reader(m["name"], dirs)(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
