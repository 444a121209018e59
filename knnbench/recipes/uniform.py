"""The ``uniform`` recipe: i.i.d. uniform points from the seed, a frozen
copy of the port's ``io.generate_uniform``."""

import numpy as np


def make_cloud(n: int, seed: int, domain: float) -> np.ndarray:
    """n i.i.d. uniform points in [0, domain]^3."""
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 3), dtype=np.float64) * domain
    return pts.astype(np.float32)
