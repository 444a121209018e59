"""The ``blue_noise`` recipe: grid-jitter blue noise from the seed, a
frozen copy of the port's ``io.generate_blue_noise`` (seed 900 at
n = 900,000 is the recipe's ``900k_blue_cube.xyz``)."""

import numpy as np


def make_cloud(n: int, seed: int, domain: float) -> np.ndarray:
    """n blue-noise points by grid-jitter stratified sampling: one
    uniformly jittered sample per cell of an m^3 grid (m = ceil(n^(1/3))),
    then a random subset of exactly n."""
    rng = np.random.default_rng(seed)
    m = int(np.ceil(n ** (1.0 / 3.0)))
    cells = m * m * m
    ijk = np.stack(np.meshgrid(np.arange(m), np.arange(m), np.arange(m),
                               indexing="ij"), axis=-1)
    ijk = ijk.reshape(cells, 3).astype(np.float64)
    jitter = rng.random((cells, 3))
    pts = (ijk + jitter) * (domain / m)
    keep = rng.permutation(cells)[:n]
    keep.sort()
    return pts[keep].astype(np.float32)
