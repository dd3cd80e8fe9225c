"""Hand-made packed tables for K8 (ops/grid_knn.py's (G^3 * C, 4) layout),
shared by the CPU parity tests and the card tests (no JAX here).

Coordinates are multiples of 2^-6 and the radius is a quarter; up to G = 8
they lie below 2, so every difference, product and sum of K8 is exact in
float32 (at most 27 * 32 candidates): any order of additions gives the same
moments, bit for bit.
"""
import numpy as np

EDGE = 0.25  # cell edge; the radius
R2 = EDGE * EDGE


def table(G, C, kind, seed=0):
    """(G^3 * C, 4) float32 [x, y, z, occupancy]; each slot's point lies in
    its cell. kind: "holes" (each slot occupied with probability 1/2, so
    occupied slots sit between empty ones, and empty slots carry stray
    coordinates that must be ignored), "empty" (all zeros) or "full"."""
    if kind == "empty":
        return np.zeros((G ** 3 * C, 4), np.float32)
    rng = np.random.RandomState(seed)
    cell = np.stack(np.meshgrid(*(np.arange(G),) * 3, indexing="ij"), -1).reshape(-1, 1, 3)
    xyz = (cell + rng.randint(0, 16, (G ** 3, C, 3)) / 16.0) * EDGE
    occ = rng.rand(G ** 3, C) < 0.5 if kind == "holes" else np.ones((G ** 3, C), bool)
    return np.concatenate([xyz, occ[..., None]], -1).reshape(-1, 4).astype(np.float32)


def sparse_table(G, C, n_cells, seed=0):
    """A scan-like table: n_cells random cells hold a few points (holes
    included), every other slot is zero, as K7 packs a sparse scan."""
    rng = np.random.RandomState(seed)
    pk = np.zeros((G ** 3, C, 4), np.float32)
    cells = rng.choice(G ** 3, n_cells, replace=False)
    xyz = np.stack(np.unravel_index(cells, (G,) * 3), -1)[:, None, :]
    pk[cells, :, :3] = (xyz + rng.randint(0, 16, (n_cells, C, 3)) / 16.0) * EDGE
    pk[cells, :, 3] = rng.rand(n_cells, C) < 0.6
    pk[..., :3] *= pk[..., 3:]
    return pk.reshape(-1, 4)
