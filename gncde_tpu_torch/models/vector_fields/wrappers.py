"""CDE wrapper vector field: contract an inner vf's output with the data
control path's derivative, turning a graph ODE field into a genuine CDE.

Counterpart of ``CDEWrapperVectorField`` in
``gncde_tpu/models/vector_fields/wrappers.py`` (reference
cde_wrapper_vector_field.py:19-26), batch-first: ``y`` is ``(B, n, H)``.
"""

from __future__ import annotations

import torch
from torch import nn


class CDEWrapperVectorField(nn.Module):
    """``dy = reshape(vf(t, y, A_path), (B, n, H, E, 2)) . dX(t)``."""

    def __init__(self, vector_field: nn.Module, hidden_dim: int):
        super().__init__()
        self.vector_field = vector_field
        self.hidden_dim = hidden_dim

    def forward(self, t, y, args):
        control_adj, control_data = args
        B, n = y.shape[:2]
        out = self.vector_field(t, y, control_adj).reshape(
            B, n, self.hidden_dim, self.vector_field.data_embed_dim, 2)
        return torch.einsum("bnmlk,bnlk->bnm", out, control_data.derivative(t))
