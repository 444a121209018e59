"""The ``clustered`` recipe: tight gaussian blobs over a uniform
background, a frozen copy of the port's ``io.generate_clustered``."""

import numpy as np


def make_cloud(n: int, seed: int, domain: float,
               blob_fraction: float = 0.6, n_blobs: int = 12,
               sigma_fraction: float = 0.012) -> np.ndarray:
    """n points: tight gaussian blobs over a uniform background."""
    rng = np.random.default_rng(seed)
    n_blob_pts = int(n * blob_fraction)
    n_bg = n - n_blob_pts
    centers = rng.uniform(0.15 * domain, 0.85 * domain, (n_blobs, 3))
    sizes = np.full(n_blobs, n_blob_pts // n_blobs, np.int64)
    sizes[: n_blob_pts - int(sizes.sum())] += 1
    blobs = [rng.normal(c, sigma_fraction * domain, (int(m), 3))
             for c, m in zip(centers, sizes)]
    bg = rng.uniform(0, domain, (n_bg, 3))
    pts = np.concatenate(blobs + [bg])
    return np.clip(pts, 0, np.nextafter(domain, 0)).astype(np.float32)
