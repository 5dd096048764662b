"""Sparse (ELL) control paths for scaled-n graphs.

Counterpart of ``gncde_tpu/interp/sparse_paths.py``. The adjacency signal
A(t) is interpolated entrywise only at its time-union sparsity pattern: one
ELL index pattern ``indices (n, K)`` shared by every knot and coefficient
plane (interpolation is entrywise-linear in the knot values, so gathering at
the union pattern is exact), cubic Hermite planes ``(T-1, n, K)`` or linear
knots ``(T, n, K)``. ``adj(t)`` / ``dadj(t)`` return
:class:`~gncde_tpu_torch.ops.sparse.ELL` values, which the fusion layers
dispatch to ``sparse_fused_apply``.

Batch-first like the rest of the port: a control built from batched
coefficients holds ``ts (B, T)``, ``indices (B, n, K)`` and planes
``(B, T-1, n, K)`` and is evaluated at a per-element ``t (B,)``. An
unbatched control evaluated at ``t (B,)`` returns batched values on its one
shared pattern.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from ..ops.sparse import ELL, transpose_pattern
from .paths import _bcast, backward_hermite_coefficients, interval_index


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def union_mask(planes: tp.Sequence[np.ndarray]) -> np.ndarray:
    """``(n, n)`` bool: entries nonzero in any plane at any leading index."""
    mask = None
    for p in planes:
        p = np.asarray(p)
        pm = np.any(p != 0.0, axis=tuple(range(p.ndim - 2)))
        mask = pm if mask is None else (mask | pm)
    return mask


def union_ell_pattern(planes: tp.Sequence[np.ndarray],
                      max_degree: tp.Optional[int] = None) -> np.ndarray:
    """ELL ``indices (n, K)`` covering every entry nonzero in ANY plane (host
    side); rows are truncated to ``max_degree``. Padding slots hold ``n``."""
    mask = union_mask(planes)
    n = mask.shape[0]
    degs = mask.sum(axis=1)
    K = int(max_degree or max(int(degs.max()) if n else 1, 1))
    indices = np.full((n, K), n, dtype=np.int32)
    for r in range(n):
        cols = np.nonzero(mask[r])[0][:K]
        indices[r, :len(cols)] = cols
    return indices


def _gather_pattern(plane: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """``plane[..., i, indices[i, k]]`` with zero at padding slots."""
    plane = np.asarray(plane)
    n, K = indices.shape
    safe = np.minimum(indices, n - 1)
    rows = np.arange(n)[:, None]
    out = plane[..., rows, safe]
    out[..., indices == n] = 0.0
    return out


def take_interval(x: torch.Tensor, i: torch.Tensor, batched: bool) -> torch.Tensor:
    """Interval ``i`` of a coefficient stack: ``x[i]`` for an unbatched stack
    (batched values when ``i`` is ``(B,)``), ``x[b, i[b]]`` for a batched one."""
    if batched:
        return x[torch.arange(x.shape[0], device=x.device), i]
    return x[i]


def interval_at(ts: torch.Tensor, t):
    """``(i, ts[i], ts[i + 1])`` of the interval holding ``t``, per element."""
    t = torch.as_tensor(t, dtype=ts.dtype, device=ts.device)
    i = interval_index(ts, t)
    if ts.dim() == 1:
        return i, ts[i], ts[i + 1]
    return i, ts.gather(-1, i[:, None])[:, 0], ts.gather(-1, i[:, None] + 1)[:, 0]


class SparseCubicMatrixPath:
    """Hermite-cubic path over ELL values: planes ``(d, c, b, a)``, each
    ``([B,] T-1, n, K)``; ``transpose`` is the pattern's transposed pattern
    (built here when not given), which every value it returns carries."""

    def __init__(self, ts, coeffs, indices, n: int, transpose=None):
        self.ts = ts
        self.coeffs = tuple(coeffs)
        self.indices = indices
        self.n = n
        self.transpose = transpose or transpose_pattern(indices, n)

    @property
    def batched(self) -> bool:
        return self.ts.dim() == 2

    def to(self, device) -> "SparseCubicMatrixPath":
        return SparseCubicMatrixPath(self.ts.to(device), [c.to(device) for c in self.coeffs],
                                     self.indices.to(device), self.n,
                                     tuple(x.to(device) for x in self.transpose))

    def _at(self, t):
        i, t0, _ = interval_at(self.ts, t)
        planes = [take_interval(c, i, self.batched) for c in self.coeffs]
        return _bcast(t - t0, planes[0]), planes

    def evaluate(self, t) -> ELL:
        tau, (d, c, b, a) = self._at(t)
        return ELL(self.indices, ((d * tau + c) * tau + b) * tau + a, self.n,
                   self.transpose)

    def derivative(self, t) -> ELL:
        tau, (d, c, b, _) = self._at(t)
        return ELL(self.indices, (3.0 * d * tau + 2.0 * c) * tau + b, self.n,
                   self.transpose)


class SparseLinearMatrixPath:
    """Piecewise-linear path over ELL values: knots ``([B,] T, n, K)``;
    ``transpose`` as for :class:`SparseCubicMatrixPath`."""

    def __init__(self, ts, ys, indices, n: int, transpose=None):
        self.ts = ts
        self.ys = ys
        self.indices = indices
        self.n = n
        self.transpose = transpose or transpose_pattern(indices, n)

    @property
    def batched(self) -> bool:
        return self.ts.dim() == 2

    def to(self, device) -> "SparseLinearMatrixPath":
        return SparseLinearMatrixPath(self.ts.to(device), self.ys.to(device),
                                      self.indices.to(device), self.n,
                                      tuple(x.to(device) for x in self.transpose))

    def _ends(self, t):
        i, t0, t1 = interval_at(self.ts, t)
        y0 = take_interval(self.ys, i, self.batched)
        y1 = take_interval(self.ys, i + 1, self.batched)
        return y0, y1, t0, t1

    def evaluate(self, t) -> ELL:
        y0, y1, t0, t1 = self._ends(t)
        w = _bcast((t - t0) / (t1 - t0), y0)
        return ELL(self.indices, y0 + w * (y1 - y0), self.n, self.transpose)

    def derivative(self, t) -> ELL:
        y0, y1, t0, t1 = self._ends(t)
        return ELL(self.indices, (y1 - y0) / _bcast(t1 - t0, y0), self.n, self.transpose)


def _value_planes(interpolation: str, coeffs) -> tp.List[np.ndarray]:
    """The value channel of reference-layout stacked ``[time, value]``
    coefficients: one knots plane (linear) or the four Hermite planes."""
    if interpolation == "linear":
        return [to_numpy(coeffs)[..., -1]]
    return [to_numpy(c)[..., -1] for c in coeffs]


def stacked(xs) -> torch.Tensor:
    """Per-element tensors stacked on a new leading batch axis."""
    return torch.stack(list(xs))


class SparseMatrixControl:
    """Sparse adjacency control with an implicit unit time channel; the
    contract of :class:`~gncde_tpu_torch.interp.MatrixControl` with ELL
    values. Built on the host by :meth:`from_knots` (dense snapshots) or
    :meth:`from_stacked` (the trainer's stacked coefficients)."""

    tgrad_is_unit = True

    def __init__(self, path):
        self.path = path

    def to(self, device) -> "SparseMatrixControl":
        return SparseMatrixControl(self.path.to(device))

    @classmethod
    def from_knots(cls, ts, A_knots, interpolation: str = "cubic",
                   max_degree: tp.Optional[int] = None) -> "SparseMatrixControl":
        """From dense adjacency snapshots ``A_knots (T, n, n)``."""
        A_knots = to_numpy(A_knots)
        n = A_knots.shape[-1]
        indices = union_ell_pattern([A_knots], max_degree)
        vals = torch.from_numpy(_gather_pattern(A_knots, indices))  # (T, n, K)
        ts = torch.as_tensor(to_numpy(ts))
        idx = torch.from_numpy(indices)
        if interpolation == "linear":
            return cls(SparseLinearMatrixPath(ts, vals, idx, n))
        coeffs = backward_hermite_coefficients(ts, vals)
        return cls(SparseCubicMatrixPath(ts, coeffs, idx, n))

    @classmethod
    def from_stacked(cls, interpolation: str, ts, coeffs,
                     max_degree: tp.Optional[int] = None) -> "SparseMatrixControl":
        """From reference-layout stacked ``[time, value]`` dense coefficients:
        the value channel, its nonzero pattern unioned over planes and time,
        gathered (exact at every queried t).

        Batched coefficients (value planes ``(B, T[-1], n, n)``, as the dyn
        trainer's) give each element its own pattern, widened to one shared
        K: the batch's largest degree, or ``max_degree`` if that is larger.
        Unbatched ones truncate rows to ``max_degree``.
        """
        ts = torch.as_tensor(to_numpy(ts))
        planes = _value_planes(interpolation, coeffs)
        if planes[0].ndim == 4:
            B = planes[0].shape[0]
            K = max(union_ell_pattern([p[b] for p in planes]).shape[1] for b in range(B))
            if max_degree is not None:
                K = max(K, max_degree)
            elems = [cls._build(interpolation, ts[b], [p[b] for p in planes], K).path
                     for b in range(B)]
            ts_b, idx_b = stacked(e.ts for e in elems), stacked(e.indices for e in elems)
            if interpolation == "linear":
                return cls(SparseLinearMatrixPath(ts_b, stacked(e.ys for e in elems),
                                                  idx_b, elems[0].n))
            coeffs = [stacked(e.coeffs[j] for e in elems) for j in range(4)]
            return cls(SparseCubicMatrixPath(ts_b, coeffs, idx_b, elems[0].n))
        return cls._build(interpolation, ts, planes, max_degree)

    @classmethod
    def _build(cls, interpolation, ts, planes, max_degree):
        n = planes[0].shape[-1]
        indices = union_ell_pattern(planes, max_degree)
        idx = torch.from_numpy(indices)
        if interpolation == "linear":
            vals = torch.from_numpy(_gather_pattern(planes[0], indices))
            return cls(SparseLinearMatrixPath(ts, vals, idx, n))
        gathered = [torch.from_numpy(_gather_pattern(p, indices)) for p in planes]
        return cls(SparseCubicMatrixPath(ts, gathered, idx, n))

    def adj(self, t) -> ELL:
        return self.path.evaluate(t)

    def dadj(self, t) -> ELL:
        return self.path.derivative(t)

    evaluate = adj
    derivative = dadj
