"""Graph-convolution layers with equivariant fusion.

Counterpart of ``gncde_tpu/models/vector_fields/layers.py`` (undirected
subset). Node features are ``(..., n, H)`` with any leading batch dims;
``A``/``dA`` are ``(..., n, n)``, or the values of a sparse control
(:class:`~gncde_tpu_torch.ops.sparse.ELL`,
:class:`~gncde_tpu_torch.ops.bcsr.BCSRVal`). Attribute names match the JAX fields so
``nn/convert.py`` maps parameters by name.
"""

from __future__ import annotations

import torch
from torch import nn

from ... import ops as ops_config
from ...nn import Linear, RMSNorm
from ...ops import bcsr as ops_bcsr
from ...ops import equiv_basis
from ...ops import fused_basis
from ...ops import pipeline
from ...ops import sparse as ops_sparse


class ConvLayer(nn.Module):
    """RMSNorm -> per-node Linear -> ``m + A @ m`` (reference layers.py:11-48)."""

    def __init__(self, input_dim: int, output_dim: int, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.linear = Linear(input_dim, output_dim, generator=generator, device=device)
        self.norm = RMSNorm(input_dim, device=device)

    def transform(self, node_feats: torch.Tensor) -> torch.Tensor:
        """The pre-aggregation part: per-node norm + linear."""
        return self.linear(self.norm(node_feats))

    def forward(self, node_feats: torch.Tensor, adj_matrix: torch.Tensor) -> torch.Tensor:
        m = self.transform(node_feats)
        return m + adj_matrix @ m


class ConvEquivFusionLayer(nn.Module):
    """Undirected 8-term Maron-basis fusion + graph conv (layers.py:51-177).

    Basis parameters ``param1 .. param8`` are 2-vectors drawn from
    ``U(-1/15, 1/15)``.
    """

    def __init__(self, input_dim: int, output_dim: int, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        for k in range(1, 9):
            p = torch.empty(2, device=device).uniform_(-1.0, 1.0, generator=generator)
            setattr(self, f"param{k}", nn.Parameter(p / 15))
        self.conv_layer = ConvLayer(input_dim, output_dim, generator=generator,
                                    device=device)

    @property
    def params(self):
        return tuple(getattr(self, f"param{k}") for k in range(1, 9))

    def fusion_matrix(self, adjacency, control_gradient):
        return equiv_basis.fusion_matrix_dense(adjacency, control_gradient, self.params)

    def forward(self, node_feats, adj_matrix, control_gradient) -> torch.Tensor:
        m = self.conv_layer.transform(node_feats)
        # Sparse controls bypass the dense backends: O(nnz H) message passing
        # through K10 (ELL) or K8/K9 (BCSR), no n x n operator.
        if isinstance(adj_matrix, ops_sparse.ELL):
            return ops_sparse.sparse_fused_apply(adj_matrix, control_gradient, m,
                                                 self.params, add_identity=True)
        if isinstance(adj_matrix, ops_bcsr.BCSRVal):
            return ops_bcsr.bcsr_fused_apply(adj_matrix, control_gradient, m,
                                             self.params, add_identity=True)
        backend = ops_config.get_fusion_backend(node_feats.device)
        if backend in ("dense", "megakernel"):
            # "megakernel" is a vector-field-level backend; a layer reached
            # directly takes the dense formulation.
            return m + self.fusion_matrix(adj_matrix, control_gradient) @ m
        if backend == "pipeline":  # K13 per layer (ops/pipeline.py)
            return pipeline.pipeline_fused_apply(adj_matrix, control_gradient, m,
                                                 self.params, False, True)
        if backend == "pallas":  # K12 per layer (ops/fused_basis.py)
            return fused_basis.fused_apply_pallas(adj_matrix, control_gradient, m,
                                                  self.params, False, True)
        return equiv_basis.fused_apply(adj_matrix, control_gradient, m,
                                       self.params, add_identity=True)
