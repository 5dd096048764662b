"""Graph operator normalisation applied before adjacencies become the
control path.

Counterpart of ``gncde_tpu/data/operators.py`` for the flagship operator
``norm_lap`` (reference misc.py:58-78); batched over leading dims.
"""

from __future__ import annotations

import torch


def normalized_laplacian(A: torch.Tensor) -> torch.Tensor:
    """``I - D^{-1/2} (A+I) D^{-1/2}``; no zero guard, as the reference
    (self-loops make every degree positive)."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    A = A + eye
    out_inv = A.sum(-1) ** -0.5
    in_inv = A.sum(-2) ** -0.5
    return eye - out_inv[..., :, None] * A * in_inv[..., None, :]


def get_graph_operator(operator_type: str, A: torch.Tensor, L: torch.Tensor):
    """Dispatcher (reference misc.py:102-113); the default is norm_lap."""
    operator_type = operator_type.lower()
    if operator_type == "lap":
        return L
    if operator_type in ("kipf", "norm_adj"):
        raise NotImplementedError(
            f"operator {operator_type!r} is not ported yet (see ROADMAP)")
    return normalized_laplacian(A)
