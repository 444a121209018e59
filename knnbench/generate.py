"""The one generator of the benchmark's traffic: a point cloud from a
traffic mix's data file and the seed, and the rows the check samples.

A mix names its recipe and the recipe's parameters::

    {"cloud": {"recipe": "clustered", "params": {"n_blobs": 12}}, ...}

A recipe is ``recipes/<name>.py``, found by name, whose
``make_cloud(n, seed, domain, **params)`` returns the (n, 3) float32
cloud; a new kind of cloud is a new file.  The recipes there are frozen
copies of the port's ``io.py`` generators (themselves copies of the JAX
package's), so a cloud named by recipe, size and seed is the same array
in all three and the yardstick does not move when the program does.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable

import numpy as np

from .spec import load_from_file

RECIPES = Path(__file__).resolve().parent / "recipes"

#: Seeds are whole numbers of any size; numpy's generators take any
#: non-negative integer, so a negative seed wraps into 64 bits.
_SEED_MOD = 2 ** 64
#: Second word of the seed sequence of the check's row sample: a stream
#: apart from the cloud's.
_SAMPLE_STREAM = 0x6B6E6E


def norm_seed(seed: int) -> int:
    return int(seed) % _SEED_MOD


def make_cloud(traffic: dict, n: int, seed: int, domain: float,
               dirs: Iterable[Path] = (RECIPES,)) -> np.ndarray:
    """The (n, 3) float32 cloud of a traffic mix for ``seed``."""
    cloud = traffic["cloud"]
    try:
        recipe = load_from_file(cloud["recipe"], dirs, "make_cloud")
    except FileNotFoundError as e:
        raise ValueError(f"unknown recipe {cloud['recipe']!r}: {e}") from e
    return recipe(int(n), norm_seed(seed), float(domain),
                  **cloud.get("params", {}))


class RowSampler:
    """The rows of each solve that the check keeps, drawn from the seed:
    ``per_solve`` distinct rows of [0, n) a solve."""

    def __init__(self, seed: int, n: int, per_solve: int):
        self._rng = np.random.default_rng((norm_seed(seed), _SAMPLE_STREAM))
        self.n = int(n)
        self.per_solve = min(int(per_solve), self.n)

    def next(self) -> np.ndarray:
        return np.sort(self._rng.choice(self.n, self.per_solve,
                                        replace=False))

    def subsample(self, total: int, cap: int) -> np.ndarray:
        """Which of ``total`` kept rows the check judges: all of them, or
        ``cap`` drawn from the seed."""
        if total <= cap:
            return np.arange(total)
        return np.sort(self._rng.choice(total, cap, replace=False))
