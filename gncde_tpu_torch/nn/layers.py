"""Core layers with the JAX package's init and forward semantics.

Counterpart of ``gncde_tpu/nn/layers.py``: ``Linear`` keeps the equinox
fan-in uniform init ``U(-1/sqrt(in), 1/sqrt(in))`` for weight and bias, and
``RMSNorm`` is written by hand because this one has a bias and eps 1e-6
(``torch.nn.RMSNorm`` has no bias). Both act on the last dim, so a leading
batch or node dim needs no vmap.
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
