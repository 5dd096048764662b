"""Core layers with the JAX package's init and forward semantics.

Counterpart of ``gncde_tpu/nn/layers.py``: ``Linear`` keeps the equinox
fan-in uniform init ``U(-1/sqrt(in), 1/sqrt(in))`` for weight and bias, and
``RMSNorm`` is written by hand because this one has a bias and eps 1e-6
(``torch.nn.RMSNorm`` has no bias). ``MLP`` and ``Embedding`` serve the
enc_idx modulation. All act on the last dim, so a leading batch or node dim
needs no vmap.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class Linear(nn.Module):
    """``y = x W^T + b`` with weight ``(out, in)`` (same layout as JAX)."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True,
                 *, generator: torch.Generator, device=None):
        super().__init__()
        lim = 1.0 / math.sqrt(in_features)
        w = torch.empty((out_features, in_features), device=device)
        w.uniform_(-lim, lim, generator=generator)
        self.weight = nn.Parameter(w)
        if use_bias:
            b = torch.empty((out_features,), device=device)
            b.uniform_(-lim, lim, generator=generator)
            self.bias = nn.Parameter(b)
        else:
            self.register_parameter("bias", None)
        self.in_features = in_features
        self.out_features = out_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x @ self.weight.T
        if self.bias is not None:
            out = out + self.bias
        return out


ACTIVATIONS = {"relu": torch.relu, "identity": lambda x: x}


class MLP(nn.Module):
    """equinox-style MLP: ``depth`` hidden layers of ``width_size`` (depth 0
    is one Linear), ``activation`` between layers and ``final_activation``
    after the last (``gncde_tpu/nn/layers.py`` ``MLP``). The layers are
    built in equinox's key order: first, hidden, last."""

    def __init__(self, in_size: int, out_size: int, width_size: int, depth: int,
                 activation: str = "relu", final_activation: str = "identity",
                 use_bias: bool = True, use_final_bias: bool = True, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        for act in (activation, final_activation):
            if act not in ACTIVATIONS:
                raise ValueError(f"activation {act!r} is not ported (have {list(ACTIVATIONS)})")
        kw = dict(generator=generator, device=device)
        if depth == 0:
            layers = [Linear(in_size, out_size, use_final_bias, **kw)]
        else:
            layers = [Linear(in_size, width_size, use_bias, **kw)]
            layers += [Linear(width_size, width_size, use_bias, **kw)
                       for _ in range(depth - 1)]
            layers.append(Linear(width_size, out_size, use_final_bias, **kw))
        self.layers = nn.ModuleList(layers)
        self.activation = activation
        self.final_activation = final_activation
        self.in_size, self.out_size = in_size, out_size
        self.width_size, self.depth = width_size, depth

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = ACTIVATIONS[self.activation]
        for layer in self.layers[:-1]:
            x = act(layer(x))
        return ACTIVATIONS[self.final_activation](self.layers[-1](x))


class Embedding(nn.Module):
    """Lookup table ``(num_embeddings, embedding_size)``, N(0, 1) init."""

    def __init__(self, num_embeddings: int, embedding_size: int, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        w = torch.empty((num_embeddings, embedding_size), device=device)
        w.normal_(generator=generator)
        self.weight = nn.Parameter(w)
        self.num_embeddings = num_embeddings
        self.embedding_size = embedding_size

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return self.weight[idx]


class RMSNorm(nn.Module):
    """``y = x / sqrt(mean(x^2) + eps) * weight + bias`` over the last dim."""

    def __init__(self, shape: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(shape, device=device))
        self.bias = nn.Parameter(torch.zeros(shape, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv_rms = torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps)
        return x * inv_rms * self.weight + self.bias
