"""Graph vector fields (the functions the CDE solver integrates).

Counterpart of ``gncde_tpu/models/vector_fields/fields.py`` for the
undirected permutation-equivariant field with ``enc_idx=False``. Call
signature ``vf(t, y, control) -> dy/dt`` with a leading batch dim written
out: ``t`` is ``(B,)``, ``y`` is ``(B, n, H)`` and the control's path holds
per-element knots ``(B, T)`` and planes ``(B, T-1, n, n)``.
"""

from __future__ import annotations

import torch
from torch import nn

from ... import ops as ops_config
from ...interp import CubicInterpolation
from ...ops import megakernel as _mk
from ...ops import tiled as _tiled
from .layers import ConvEquivFusionLayer


def control_terms(control_adj, t):
    """(A(t), dA(t), time-gradient matrix or None)."""
    if getattr(control_adj, "tgrad_is_unit", False):
        return control_adj.adj(t), control_adj.dadj(t), None
    deriv = control_adj.derivative(t)
    return control_adj.evaluate(t)[..., -1], deriv[..., -1], deriv[..., 0]


def _pallas_plane_dispatch_ok(control_adj, device) -> bool:
    """The gate for the vf-level kernels: the megakernel backend is selected
    (or ``auto`` on a CUDA device), the control's time gradient is the
    implicit unit channel, and the path is cubic Hermite, whose interval
    planes the kernels read."""
    return (
        ops_config.get_fusion_backend(device) == "megakernel"
        and getattr(control_adj, "tgrad_is_unit", False)
        and isinstance(control_adj.path, CubicInterpolation)
    )


def _make_stack(input_dim, hidden_dim, output_dim, num_layers, generator, device):
    """num_layers-1 hidden layers + one output layer."""
    layers = []
    for _ in range(num_layers - 1):
        layers.append(ConvEquivFusionLayer(input_dim, hidden_dim,
                                           generator=generator, device=device))
        input_dim = hidden_dim
    layers.append(ConvEquivFusionLayer(input_dim, output_dim,
                                       generator=generator, device=device))
    return nn.ModuleList(layers)


class PermEquivGraphVectorField(nn.Module):
    """Undirected permutation-equivariant vf (perm_equiv_graph_vector_field.py)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int, data_embed_dim: int, num_nodes: int,
                 enc_idx: bool = False, *, generator: torch.Generator,
                 device=None, **_unused):
        super().__init__()
        if enc_idx:
            raise NotImplementedError(
                "enc_idx is not ported yet (ROADMAP slice 4)")
        self.gnn_layers = _make_stack(input_dim, hidden_dim, output_dim,
                                      num_layers, generator, device)
        self.data_embed_dim = data_embed_dim
        self.num_nodes = num_nodes
        self.enc_idx = enc_idx

    def forward(self, t: torch.Tensor, y: torch.Tensor, control_adj) -> torch.Tensor:
        t = t.expand(y.shape[0]) if t.dim() == 0 else t
        if _pallas_plane_dispatch_ok(control_adj, y.device):
            n = y.shape[-2]
            path = control_adj.path
            if n <= _mk.MEGAKERNEL_MAX_N:
                return _mk.megakernel_vf(path.coeffs, path.ts, t, y, self)
            if n <= _tiled.TILED_MAX_N:
                # K1/K2 serve n <= 640; above it the tiled kernels (twitter
                # n=1000, tgbn-genre n=1505 and beyond).
                return _tiled.tiled_vf_eval(path.coeffs, path.ts, t, y, self,
                                            red=getattr(control_adj, "red", None))
            # Beyond the tiled cap the dense layer stack below runs.

        adj, adj_derivative, tgrad = control_terms(control_adj, t)
        out = y
        for i, layer in enumerate(self.gnn_layers):
            out = layer(out, adj, adj_derivative)
            if i < len(self.gnn_layers) - 1:
                out = torch.relu(out)
        if tgrad is not None:
            out = tgrad.mean(-2)[..., :, None] * out
        return out
