"""TGB node-property model shell.

Counterpart of ``TGBGraphNeuralCDE`` in ``gncde_tpu/models/tgb.py``
(reference tgb_graph_neural_cde.py:13-171), batch-first: node features are
encoded per snapshot, the data control path (time channel stacked on the
encoded features) is built inside the forward, and a constant-step latent
solve is driven by :class:`CDEWrapperVectorField`.
"""

from __future__ import annotations

import typing as tp

import torch
from torch import nn

from .. import ops as ops_config
from ..interp import (
    CubicInterpolation,
    LinearInterpolation,
    MatrixControl,
    backward_hermite_coefficients,
    linear_interpolation,
)
from ..nn import Linear
from ..solve import ConstantStepSize, ODETerm, SaveAt, diffeqsolve
from .continuous import with_reductions
from .vector_fields import CDEWrapperVectorField


def adjacency_control(interpolation: str, ts, coeffs) -> MatrixControl:
    """Slim control from value-channel coefficients (``data/windows.py``):
    ``(d, c, b, a)`` each ``(B, T-1, n, n)`` (cubic) or knots ``(B, T, n, n)``
    (linear), stored in bfloat16 under ``fusion_precision: bf16`` as the JAX
    model's ``make_control(slim=True)`` stores them."""
    bf16 = ops_config.bf16_precision()
    if interpolation == "linear":
        return MatrixControl(LinearInterpolation(ts, coeffs.to(torch.bfloat16) if bf16
                                                 else coeffs))
    if bf16:
        coeffs = tuple(c.to(torch.bfloat16) for c in coeffs)
    return with_reductions(MatrixControl(CubicInterpolation(ts, tuple(coeffs))))


class TGBGraphNeuralCDE(nn.Module):
    """Constant-step latent CDE over TGB snapshot windows (dt0 = 0.01)."""

    #: The JAX model's field order (``nn/convert.py``).
    JAX_FIELDS = ("encoder", "decoder", "data_encoder", "vector_field",
                  "wrapped_vector_field", "persistence_alpha", "residual_gate")

    def __init__(self, vector_field: nn.Module, hidden_dim: int, interpolation: str,
                 method: str = "Tsit5", return_sequence: bool = True,
                 dt0: float = 0.01, persistence_head: bool = False,
                 adjoint: str = "checkpointed", *, generator: torch.Generator,
                 device=None):
        super().__init__()
        n = vector_field.num_nodes
        start = generator.get_state()
        self.encoder = Linear(n, hidden_dim, generator=generator, device=device)
        self.decoder = Linear(hidden_dim, n, generator=generator, device=device)
        after = generator.get_state()
        # Reference quirk (tgb_graph_neural_cde.py:86-90): data_encoder
        # reuses the encoder's key, so it starts from the encoder's draws.
        generator.set_state(start)
        self.data_encoder = Linear(n, vector_field.data_embed_dim,
                                   generator=generator, device=device)
        generator.set_state(after)
        self.vector_field = vector_field
        self.wrapped_vector_field = CDEWrapperVectorField(vector_field, hidden_dim)
        # Opt-in persistence-residual head (not in the reference):
        # scores = gate * decoder(z) + alpha * rownorm(last snapshot), with
        # the gate initialised to 0, so the initial model is copy-last.
        if persistence_head:
            self.persistence_alpha = nn.Parameter(torch.ones((), device=device))
            self.residual_gate = nn.Parameter(torch.zeros((), device=device))
        else:
            self.persistence_alpha = None
            self.residual_gate = None
        self.hidden_dim = hidden_dim
        self.method = method
        self.interpolation = interpolation
        self.adjoint = adjoint
        self.return_sequence = return_sequence
        self.dt0 = dt0

    def _persist(self, snapshot):
        rowmax = snapshot.abs().amax(-1, keepdim=True)
        return self.persistence_alpha * snapshot / (rowmax + 1e-8)

    def forward(self, ts: torch.Tensor, coeffs_adj, x_data: torch.Tensor,
                x0: torch.Tensor, start_time: tp.Optional[torch.Tensor] = None,
                evolving_out: bool = False, adjoint: tp.Optional[str] = None):
        """ts (B, T), x_data (B, T, n, n), x0 (B, n, n) -> scores (B, n, n)."""
        x_raw = x_data
        x_data = self.data_encoder(x_data)  # (B, T, n, E)
        t_index = ts[:, :, None, None].expand(x_data.shape)
        X = torch.stack([t_index, x_data], -1)
        if self.interpolation == "linear":
            control_data = LinearInterpolation(ts, linear_interpolation(ts, X))
        else:
            control_data = CubicInterpolation(ts, backward_hermite_coefficients(ts, X))
        control_adj = adjacency_control(self.interpolation, ts, coeffs_adj)

        y0 = self.encoder(x0)
        saveat = SaveAt(ts=ts) if evolving_out else SaveAt(t1=True)
        # Window knots are 0..T-1, so the constant-step count follows from
        # the shape: (T-1)/dt0, plus slack for float accumulation.
        num_steps = int(round((ts.shape[-1] - 1) / self.dt0)) + 2
        sol = diffeqsolve(
            ODETerm(self.wrapped_vector_field), self.method,
            t0=ts[:, 0], t1=ts[:, -1], dt0=self.dt0, y0=y0,
            args=(control_adj, control_data),
            stepsize_controller=ConstantStepSize(), saveat=saveat,
            max_steps=num_steps, adjoint=adjoint or self.adjoint,
        )
        if self.return_sequence and evolving_out:
            out = self.decoder(sol.ys)
            if self.persistence_alpha is not None:
                out = self.residual_gate * out + self._persist(x_raw)
            return out
        ys_last = sol.ys[:, -1] if evolving_out else sol.ys
        out = self.decoder(ys_last)
        if self.persistence_alpha is not None:
            out = self.residual_gate * out + self._persist(x_raw[:, -1])
        return out
