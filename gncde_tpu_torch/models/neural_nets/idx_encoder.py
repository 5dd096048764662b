"""Node-index encoder (counterpart of
``gncde_tpu/models/neural_nets/idx_encoder.py``; reference
src/models/neural_nets/idx_encoder.py): per-node embeddings of the node
index, by a lookup table (``emb``), a Linear of the index (``linear``) or an
MLP of it (``mlp``)."""

from __future__ import annotations

import torch
from torch import nn

from ...nn import MLP, Embedding, Linear


class IdxEncoder(nn.Module):
    def __init__(self, num_nodes: int, out_channels: int, *, generator: torch.Generator,
                 type: str = "mlp", device=None):
        super().__init__()
        kw = dict(generator=generator, device=device)
        if type == "linear":
            self.module = Linear(1, out_channels, **kw)
        elif type == "mlp":
            self.module = MLP(1, out_channels, width_size=8, depth=2, **kw)
        elif type == "emb":
            self.module = Embedding(num_nodes, out_channels, **kw)
        else:
            raise ValueError(f"Unknown idx encoder type {type!r}")
        self.type = type
        self.num_nodes = num_nodes

    def node_embedding(self) -> torch.Tensor:
        """Per-node embeddings ``(n, d)``: the factored form the modulation
        uses, so the ``(n, n, 2d)`` pairwise concat never materialises."""
        dev = next(self.parameters()).device
        if self.type == "emb":
            return self.module(torch.arange(self.num_nodes, device=dev))
        return self.module(torch.arange(self.num_nodes, device=dev,
                                        dtype=torch.float32)[:, None])

    def forward(self) -> torch.Tensor:
        """The reference's all-pairs concat ``(n, n, 2d)`` (O(n^2 d) memory;
        kept for parity tests, the model uses :meth:`node_embedding`)."""
        emb = self.node_embedding()
        n = self.num_nodes
        return torch.cat([emb[:, None, :].expand(n, n, -1),
                          emb[None, :, :].expand(n, n, -1)], -1)
