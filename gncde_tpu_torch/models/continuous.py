"""Dynamical-systems GNCDE model shell.

Counterpart of ``gncde_tpu/models/continuous.py`` (``make_control`` in its
slim form and ``GraphNeuralCDE``). Forward = control path -> batched latent
CDE solve -> per-node decode, with the batch as a leading dim.
"""

from __future__ import annotations

import typing as tp

import torch
from torch import nn

from .. import ops as ops_config
from ..interp import CubicInterpolation, LinearInterpolation, MatrixControl
from ..nn import Linear
from ..ops import megakernel as _mk
from ..ops import tiled as _tiled
from ..solve import ODETerm, SaveAt, PIDController, diffeqsolve


def with_reductions(ctrl: MatrixControl) -> MatrixControl:
    """Under the megakernel backend with ``MEGAKERNEL_MAX_N < n <=
    TILED_MAX_N`` (the tiled regime), attach the per-trajectory plane
    reductions once, so each vf eval's rank terms are O(n) reads."""
    path = ctrl.path
    if (isinstance(path, CubicInterpolation)
            and ops_config.get_fusion_backend(path.coeffs[0].device) == "megakernel"
            and _mk.MEGAKERNEL_MAX_N < path.coeffs[0].shape[-1] <= _tiled.TILED_MAX_N):
        ctrl.red = _tiled.cubic_plane_reductions(path.coeffs)
    return ctrl


def make_control(interpolation: str, ts: torch.Tensor, coeffs):
    """Slim control from reference-layout stacked ``[time, value]``
    coefficients: only the adjacency channel is kept, stored in bfloat16
    under ``fusion_precision: bf16`` (the hot loop's only O(n^2) reads, and
    bf16 matmul operands anyway; ``gncde_tpu/models/continuous.py:41-56``).
    The tiled regime's reductions are taken after that cast. A pre-built
    control (anything exposing ``adj``: the sparse ELL and BCSR controls of
    the ``sparse_control`` knob) passes through unchanged."""
    if hasattr(coeffs, "adj"):
        return coeffs
    ctrl = MatrixControl.from_stacked(interpolation, ts, coeffs)
    if ops_config.bf16_precision():
        path = ctrl.path
        if isinstance(path, CubicInterpolation):
            path = CubicInterpolation(path.ts, tuple(c.to(torch.bfloat16) for c in path.coeffs))
        else:
            path = LinearInterpolation(path.ts, path.ys.to(torch.bfloat16))
        ctrl = MatrixControl(path)
    return with_reductions(ctrl)


class GraphNeuralCDE(nn.Module):
    """Latent graph-CDE over a dynamic-adjacency control path
    (reference graph_neural_cde.py:12-113)."""

    def __init__(self, vector_field: nn.Module, hidden_dim: int,
                 interpolation: str, method: str = "Tsit5",
                 return_sequence: bool = True, max_steps: int = 1024,
                 adjoint: str = "checkpointed", *, generator: torch.Generator,
                 device=None):
        super().__init__()
        self.initial_linear = Linear(1, hidden_dim, generator=generator, device=device)
        self.final_linear = Linear(hidden_dim, 1, generator=generator, device=device)
        self.vector_field = vector_field
        self.hidden_dim = hidden_dim
        self.method = method
        self.interpolation = interpolation
        self.return_sequence = return_sequence
        self.max_steps = max_steps
        self.adjoint = adjoint
        #: Per-element accepted / rejected step counts of the last solve.
        self.last_stats: tp.Dict[str, torch.Tensor] = {}

    def forward(self, ts: torch.Tensor, coeffs_adj, x0: torch.Tensor,
                evolving_out: bool = True, adjoint: tp.Optional[str] = None):
        """ts (B, T), x0 (B, n, 1) -> (B, T, n, 1) (or (B, n, 1))."""
        control_adj = make_control(self.interpolation, ts, coeffs_adj)
        y0 = self.initial_linear(x0)
        saveat = SaveAt(ts=ts) if evolving_out else SaveAt(t1=True)
        sol = diffeqsolve(
            ODETerm(self.vector_field), self.method,
            t0=ts[:, 0], t1=ts[:, -1], dt0=None, y0=y0, args=control_adj,
            stepsize_controller=PIDController(rtol=1e-3, atol=1e-6),
            saveat=saveat, max_steps=self.max_steps,
            adjoint=adjoint or self.adjoint,
        )
        self.last_stats = sol.stats
        if self.return_sequence:
            return self.final_linear(sol.ys)
        ys = sol.ys[:, -1] if evolving_out else sol.ys
        return self.final_linear(ys)
