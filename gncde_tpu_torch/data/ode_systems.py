"""Ground-truth dynamical systems for synthetic data generation.

Counterpart of ``gncde_tpu/data/ode_systems.py`` for the heat system
(reference heat_diffusion_model.py:6-33): ``dX/dt = -k L X``, batched over
a leading dim. The other systems are not ported yet (ROADMAP).
"""

from __future__ import annotations

import torch


def heat_diffusion(L: torch.Tensor, k: float = 1.0):
    """``L``: (B, n, n); the vf maps x (B, n, C) to -k L x."""

    def vf(t, x, args=None):
        return -k * (L @ x)

    return vf


def make_system(name: str, A: torch.Tensor, L: torch.Tensor,
                beta: float = 0.0, gamma: float = 0.0):
    if name.lower() == "heat":
        return heat_diffusion(L, 1.0)
    raise NotImplementedError(
        f"ODE system {name!r} is not ported yet (only 'heat'; see ROADMAP)")


def state_channels(name: str) -> int:
    return 3 if name.lower() == "sir" else 1
