"""Evaluation metrics (counterpart of ``gncde_tpu/train/metrics.py``).

``ndcg_at_k`` is TGB's node-property NDCG@10 on the device: per source row,
classes ranked by predicted score (a stable sort, as ``jnp.argsort``),
relevance = true label weights, normalised by the ideal DCG.
"""

from __future__ import annotations

import torch


def ndcg_at_k(y_true: torch.Tensor, y_pred: torch.Tensor, k: int = 10) -> torch.Tensor:
    """NDCG@k per row; ``y_true``/``y_pred``: (..., rows, classes)."""
    k = min(k, y_pred.shape[-1])
    top_idx = torch.sort(-y_pred, dim=-1, stable=True).indices[..., :k]
    rel = y_true.gather(-1, top_idx)
    discounts = 1.0 / torch.log2(torch.arange(2, k + 2, dtype=y_pred.dtype,
                                              device=y_pred.device))
    dcg = (rel * discounts).sum(-1)
    ideal = torch.sort(y_true, dim=-1, descending=True).values[..., :k]
    idcg = (ideal * discounts).sum(-1)
    return torch.where(idcg > 0, dcg / torch.where(idcg > 0, idcg, torch.ones_like(idcg)),
                       torch.zeros_like(dcg))


def masked_mean_ndcg(y_true, y_pred, mask, k: int = 10) -> torch.Tensor:
    """Mean NDCG@k over the rows where ``mask`` holds (per leading batch)."""
    ndcg = ndcg_at_k(y_true, y_pred, k)
    return (torch.where(mask, ndcg, torch.zeros_like(ndcg)).sum(-1)
            / mask.sum(-1).clamp(min=1))
