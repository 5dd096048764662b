"""Graph generators (grid family) and degree Laplacians.

Counterpart of ``gncde_tpu/data/graph_gen.py`` for the flagship ``grid``
family: an N x N grid with 8-neighbour connectivity (reference
data_tools.py:8-29), in pure numpy. The networkx families (random,
power_law, small_world, community, mixed) are not ported yet (ROADMAP);
the port does not import networkx.
"""

from __future__ import annotations

import typing as tp

import numpy as np


def grid_8_neighbor_graph(N: int) -> np.ndarray:
    """N x N grid, 8-neighbour connectivity; dense (N^2, N^2) floats."""
    N = int(N)
    n = N * N
    xs, ys = np.divmod(np.arange(n), N)
    A = np.zeros((n, n), dtype=float)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            nxs, nys = xs + dx, ys + dy
            ok = (nxs >= 0) & (nxs < N) & (nys >= 0) & (nys < N)
            A[np.arange(n)[ok], (nxs * N + nys)[ok]] = 1.0
    return A


def generate_graphs(graph_type: str, num_nodes: int, batch_size: int, seed: int,
                    layout: str = "community") -> np.ndarray:
    """Batch of adjacency matrices, (batch_size, N^2, N^2) for ``grid``."""
    if graph_type != "grid":
        raise NotImplementedError(
            f"graph family {graph_type!r} is not ported yet (only 'grid'; "
            "see ROADMAP)")
    N = int(np.ceil(np.sqrt(num_nodes)))
    return np.tile(grid_8_neighbor_graph(N)[None], (batch_size, 1, 1))


def degree_laplacian(A: np.ndarray) -> tp.Tuple[np.ndarray, np.ndarray]:
    """Batched (D, L) for an adjacency batch A: (B, n, n)."""
    deg = A.sum(axis=-1)
    D = np.zeros_like(A)
    idx = np.arange(A.shape[-1])
    D[..., idx, idx] = deg
    return D, D - A
