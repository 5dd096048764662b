"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; JAX
parameters are copied into the port by leaf path (gncde_tpu_torch/nn/convert.py).
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from gncde_tpu.nn.module import _leaf_key
from gncde_tpu_torch.nn import convert

# The suite runs in several pytest-xdist workers on one CPU. By default torch
# gives each of them one OpenMP thread per core, and those threads spin
# against each other and against the JAX workers: a port test then runs ten
# times slower or more than alone. One intra-op thread a process keeps each
# worker on its own core. Every worker imports this module while it collects
# the port's tests, so the setting holds for all of them.
torch.set_num_threads(1)


def jax_leaves(tree) -> dict:
    """{leaf path: numpy array} of a gncde_tpu module (module.py _leaf_key)."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {_leaf_key(kp): np.asarray(leaf) for kp, leaf in flat
            if hasattr(leaf, "shape")}


def copy_jax_to_torch(jax_module, torch_module) -> None:
    """Load a JAX module's parameters into its port (strict: every name)."""
    torch_module.load_state_dict(convert.to_state_dict(jax_leaves(jax_module)),
                                 strict=True)


def t32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float32))


def hermite_path(rng: np.random.Generator, B: int, T: int, n: int, scale=0.3):
    """Per-element irregular knots (B, T) and adjacency samples (B, T, n, n)."""
    steps = rng.uniform(0.1, 0.3, (B, T - 1))
    ts = np.concatenate([np.zeros((B, 1)), np.cumsum(steps, axis=1)], axis=1)
    A = rng.uniform(0.0, scale, (B, T, n, n))
    return ts.astype(np.float32), A.astype(np.float32)
