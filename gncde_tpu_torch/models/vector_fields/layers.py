"""Graph-convolution layers with equivariant fusion.

Counterpart of ``gncde_tpu/models/vector_fields/layers.py``: the graph
convolution, the undirected 8-term fusion layer and the directed 11-term
one. Node features are ``(..., n, H)`` with any leading batch dims;
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
from ...ops.megakernel import rbf
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

    #: The basis the layer's applies take (the directed layer sets True).
    DIRECTED = False

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
        directed = self.DIRECTED
        # Sparse controls bypass the dense backends: O(nnz H) message passing
        # through K10 (ELL) or K8/K9 (BCSR), no n x n operator.
        if isinstance(adj_matrix, ops_sparse.ELL):
            apply = (ops_sparse.sparse_fused_apply_directed if directed
                     else ops_sparse.sparse_fused_apply)
            return apply(adj_matrix, control_gradient, m, self.params, add_identity=True)
        if isinstance(adj_matrix, ops_bcsr.BCSRVal):
            apply = (ops_bcsr.bcsr_fused_apply_directed if directed
                     else ops_bcsr.bcsr_fused_apply)
            return apply(adj_matrix, control_gradient, m, self.params, add_identity=True)
        backend = ops_config.get_fusion_backend(node_feats.device)
        if backend in ("dense", "megakernel"):
            # "megakernel" is a vector-field-level backend; a layer reached
            # directly takes the dense formulation.
            if ops_config.bf16_precision():
                # JAX layers.py:147-155 / :273-281: the fused operator formed
                # on bf16 planes (f32, its reductions bf16 sums), times M
                # rounded to bf16: exact products summed in f32.
                fused = self.fusion_matrix(adj_matrix.to(torch.bfloat16),
                                           control_gradient.to(torch.bfloat16))
                return m + fused @ rbf(m)
            return m + self.fusion_matrix(adj_matrix, control_gradient) @ m
        if backend == "pipeline":  # K13 per layer (ops/pipeline.py)
            return pipeline.pipeline_fused_apply(adj_matrix, control_gradient, m,
                                                 self.params, directed, True)
        if backend == "pallas":  # K12 per layer (ops/fused_basis.py)
            return fused_basis.fused_apply_pallas(adj_matrix, control_gradient, m,
                                                  self.params, directed, True)
        return equiv_basis.fused_apply(adj_matrix, control_gradient, m, self.params,
                                       directed=directed, add_identity=True)


class ConvEquivFusionDirectedLayer(nn.Module):
    """Directed 11-term basis fusion + graph conv (layers.py:176-300).

    Basis parameters ``param1 .. param8`` with ``param4_prime``,
    ``param5_prime`` and ``param6_prime``, 2-vectors from ``U(-1/15, 1/15)``;
    ``params`` stacks them in the JAX order ``[p1, p2, p3, p4, p4', p5, p5',
    p6, p6', p7, p8]``. Keeps the reference's init quirk: ``param6_prime``
    starts equal to ``param5_prime`` (the JAX layer draws both from one
    key). Its forward is the undirected layer's on the directed basis (JAX
    ``layers.py:255-300``): BCSR and ELL values go to their directed sparse
    applies; ``dense`` and ``megakernel`` take the dense directed fusion
    matrix (the vector-field-level kernels serve the field, not a layer);
    ``pipeline`` and ``pallas`` run K13 and K12 on the directed operands;
    anything else the decomposed apply.
    """

    DIRECTED = True
    _BASIS = ("param1", "param2", "param3", "param4", "param4_prime", "param5",
              "param5_prime", "param6", "param6_prime", "param7", "param8")
    #: The JAX layer's field order (``nn/convert.py``).
    JAX_FIELDS = _BASIS + ("conv_layer",)

    def __init__(self, input_dim: int, output_dim: int, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        for name in self._BASIS:
            if name == "param6_prime":
                p = self.param5_prime.detach().clone()
            else:
                p = torch.empty(2, device=device).uniform_(
                    -1.0, 1.0, generator=generator) / 15
            setattr(self, name, nn.Parameter(p))
        self.conv_layer = ConvLayer(input_dim, output_dim, generator=generator,
                                    device=device)

    @property
    def params(self):
        return tuple(getattr(self, name) for name in self._BASIS)

    def fusion_matrix(self, adjacency, control_gradient):
        return equiv_basis.fusion_matrix_dense_directed(adjacency, control_gradient,
                                                        self.params)

    forward = ConvEquivFusionLayer.forward
