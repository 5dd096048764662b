"""Sparse graph operators in ELL form and the sparse fused equivariant apply.

Counterpart of ``gncde_tpu/ops/sparse.py`` (undirected subset). An
:class:`ELL` matrix holds ``indices (..., n, K)`` int32 (padding slots
``== n``) and ``values (..., n, K)``; a leading batch axis is optional on
either, and an unbatched one is shared by the batch. The fused operator
``A_bar`` is dense even when A is sparse (its rank-1 basis terms touch every
entry), so :func:`sparse_fused_apply` uses the rank-structured
decomposition: one gather SpMM (K10, :mod:`.ell_spmm`) for the identity
pair, one for the transpose pair, and O(nH) vector terms.

``A^T @ M`` is a scatter in the JAX package (``segment_sum``). On the card a
scatter adds with atomics in no fixed order, so two evaluations of one
vector field differ in their last bits; under the checkpointed adjoint the
recomputed forward then takes other adaptive-step decisions than the
original and the backward fails. Every ELL therefore carries its transposed
pattern (:func:`transpose_pattern`, built once on the host), and ``A^T @ M``
is K10 on it: a gather of the values into that pattern, then the same
gather SpMM, bitwise repeatable. Column sums are the transposed values'
row sums.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from .ell_spmm import ELLSpMM, ell_sddmm  # noqa: F401
from .equiv_basis import directed_rank_terms


class ELL:
    """Padded-neighbour-list sparse matrix (``n`` is the logical size).
    ``transpose`` holds the transposed pattern ``(indices_T, src_T)`` of
    :func:`transpose_pattern`."""

    def __init__(self, indices: torch.Tensor, values: torch.Tensor, n: int, transpose):
        self.indices = indices
        self.values = values
        self.n = n
        self.transpose = transpose

    @property
    def max_degree(self) -> int:
        return self.indices.shape[-1]

    def astype(self, dtype) -> "ELL":
        return ELL(self.indices, self.values.to(dtype), self.n, self.transpose)

    def scale(self, c) -> "ELL":
        return ELL(self.indices, c * self.values, self.n, self.transpose)

    def combine(self, other: "ELL", ca=1.0, cb=1.0) -> "ELL":
        """``ca * self + cb * other`` for ELLs sharing one index pattern."""
        return ELL(self.indices, ca * self.values + cb * other.values, self.n,
                   self.transpose)


def _transpose_one(indices: np.ndarray, n: int):
    K = indices.shape[1]
    r, k = np.nonzero(indices < n)
    c = indices[r, k].astype(np.int64)
    order = np.argsort(c, kind="stable")  # rows ascend within a column
    r, c, src = r[order], c[order], (r * K + k)[order]
    counts = np.bincount(c, minlength=n)
    slot = np.arange(len(c)) - np.concatenate([[0], np.cumsum(counts)[:-1]])[c]
    return r, c, src, slot, max(int(counts.max()) if len(c) else 1, 1)


def transpose_pattern(indices, n: int):
    """The transposed ELL pattern of ``indices ([B,] n, K)`` (host side):
    ``indices_T ([B,] n, K_T)`` int32, the rows of A that hold each column
    (padding ``n``), and ``src_T ([B,] n, K_T)`` int64, the flat slot
    ``r * K + k`` of each entry in A's values (padding ``n * K``, a zero
    appended to them). A batch shares one ``K_T``, the largest."""
    idx = np.asarray(indices.cpu() if isinstance(indices, torch.Tensor) else indices)
    elems = [_transpose_one(e, n) for e in (idx if idx.ndim == 3 else idx[None])]
    K, K_T = idx.shape[-1], max(e[4] for e in elems)
    ind_T = np.full((len(elems), n, K_T), n, np.int32)
    src_T = np.full((len(elems), n, K_T), n * K, np.int64)
    for b, (r, c, src, slot, _) in enumerate(elems):
        ind_T[b, c, slot] = r
        src_T[b, c, slot] = src
    if idx.ndim == 2:
        ind_T, src_T = ind_T[0], src_T[0]
    return torch.from_numpy(ind_T), torch.from_numpy(src_T)


def _ell(indices: np.ndarray, values: np.ndarray, n: int) -> ELL:
    return ELL(torch.from_numpy(indices), torch.from_numpy(values), n,
               transpose_pattern(indices, n))


def ell_from_dense(A, max_degree: tp.Optional[int] = None) -> ELL:
    """Build ELL from a dense ``(n, n)`` matrix (host side)."""
    A = np.asarray(A)
    n = A.shape[0]
    rows, cols = np.nonzero(A)
    degs = np.bincount(rows, minlength=n)
    K = int(max_degree or (degs.max() if len(rows) else 1))
    indices = np.full((n, K), n, dtype=np.int32)
    values = np.zeros((n, K), dtype=np.float32)
    slot = np.zeros(n, dtype=np.int64)
    for r, c in zip(rows, cols):
        if slot[r] < K:
            indices[r, slot[r]] = c
            values[r, slot[r]] = A[r, c]
            slot[r] += 1
    return _ell(indices, values, n)


def ell_from_edges(src, dst, w, n: int, max_degree: tp.Optional[int] = None) -> ELL:
    """Build ELL from an edge list ``(src, dst, w)`` (host side; rows past
    ``max_degree`` entries are truncated, as in the JAX package)."""
    src, dst, w = np.asarray(src), np.asarray(dst), np.asarray(w)
    degs = np.bincount(src, minlength=n)
    K = int(max_degree or (degs.max() if len(src) else 1))
    indices = np.full((n, K), n, dtype=np.int32)
    values = np.zeros((n, K), dtype=np.float32)
    slot = np.zeros(n, dtype=np.int64)
    for s, d, wi in zip(src, dst, w):
        if slot[s] < K:
            indices[s, slot[s]] = d
            values[s, slot[s]] = wi
            slot[s] += 1
    return _ell(indices, values, n)


def ell_spmm(ell: ELL, M: torch.Tensor) -> torch.Tensor:
    """``A @ M`` (differentiable in values and M): K10 on CUDA tensors, its
    plain version on CPU ones; ``d_M = A^T G`` is K10 on the transposed
    pattern (its values are gathered only when M needs a gradient)."""
    t_values = transposed_values(ell) if M.requires_grad and torch.is_grad_enabled() else None
    return ELLSpMM.apply(ell.values, M, ell.indices, ell.transpose[0], t_values)


def transposed_values(ell: ELL) -> torch.Tensor:
    """A's values gathered into the transposed pattern, ``([B,] n, K_T)``.

    Its gradient scatters back onto distinct slots of A's values (each entry
    of A sits in one slot of the transposed pattern; every padding slot reads
    the appended zero, whose gradient is dropped), so each slot receives at
    most one term: exact and repeatable, atomics or not."""
    _, src_T = ell.transpose
    vals = ell.values.flatten(-2)
    vals = torch.cat([vals, vals.new_zeros(vals.shape[:-1] + (1,))], -1)
    if src_T.dim() == 2:
        return vals[..., src_T]
    return vals.gather(-1, src_T.flatten(-2)).reshape(src_T.shape)


def ell_spmm_t(ell: ELL, M: torch.Tensor) -> torch.Tensor:
    """``A^T @ M`` (differentiable): K10 on the transposed pattern; its
    ``d_M = A G`` is K10 on the original pattern."""
    return ELLSpMM.apply(transposed_values(ell), M, ell.transpose[0], ell.indices,
                         ell.values)


def ell_row_sums(ell: ELL) -> torch.Tensor:
    return ell.values.sum(-1)


def ell_col_sums(ell: ELL) -> torch.Tensor:
    return transposed_values(ell).sum(-1)


def ell_diag(ell: ELL) -> torch.Tensor:
    """diag(A): the entries whose index is their own row."""
    rows = torch.arange(ell.n, device=ell.indices.device)[:, None]
    mask = ell.indices.long() == rows
    return torch.where(mask, ell.values, torch.zeros_like(ell.values)).sum(-1)


def sparse_fused_apply(ell_A: ELL, ell_dA: ELL, M: torch.Tensor, params,
                       add_identity: bool = False) -> torch.Tensor:
    """Undirected 8-term fused basis apply with sparse A, dA.

    A and dA share one index pattern whenever they come from one
    :class:`~gncde_tpu_torch.interp.SparseMatrixControl`, and then each basis
    pair combines VALUES first: one gather SpMM for the identity pair (B1)
    and one on the transposed pattern for the transpose pair (B2). Matches
    ``ops.equiv_basis.fused_apply``, the term_7 ``sum(A)`` quirk included.
    """
    p1, p2, p3, p4, p5, p6, p7, p8 = params
    n = ell_A.n
    rA, rdA = ell_row_sums(ell_A), ell_row_sums(ell_dA)
    sA, sdA = rA.sum(-1), rdA.sum(-1)

    if ell_A.indices is ell_dA.indices:
        rowpart = ell_spmm(ell_A.combine(ell_dA, 1.0 + p1[0], 1.0 + p1[1]), M)
        colpart = ell_spmm_t(ell_A.combine(ell_dA, p2[0], p2[1]), M)
    else:
        rowpart = ((1.0 + p1[0]) * ell_spmm(ell_A, M)
                   + (1.0 + p1[1]) * ell_spmm(ell_dA, M))
        colpart = p2[0] * ell_spmm_t(ell_A, M) + p2[1] * ell_spmm_t(ell_dA, M)

    dvec = (
        p3[0] * ell_diag(ell_A)
        + p3[1] * ell_diag(ell_dA)
        + (p6[0] * rA + p6[1] * rdA) / n
        + ((p8[0] * sA + p8[1] * sdA) / n**2)[..., None]
    )
    if add_identity:
        dvec = dvec + 1.0
    return _rank_terms(rowpart + colpart, dvec, rA, rdA, sA, M, (p4, p5, p7), n)


def sparse_fused_apply_directed(ell_A: ELL, ell_dA: ELL, M: torch.Tensor, params,
                                add_identity: bool = False) -> torch.Tensor:
    """Directed 11-term fused basis apply with sparse A, dA: the pairs as in
    :func:`sparse_fused_apply`, and the column sums ``cA``, ``cdA`` from the
    transposed pattern every ELL carries (:func:`ell_col_sums`). Matches
    ``ops.equiv_basis.fused_apply(directed=True)``, the term_4' row/column
    mix and the term_7 ``sum(A)`` quirks included."""
    p1, p2 = params[0], params[1]
    n = ell_A.n
    rA, rdA = ell_row_sums(ell_A), ell_row_sums(ell_dA)
    dvec, u, v, c7 = directed_rank_terms(
        params, n, rA, rdA, ell_col_sums(ell_A), ell_col_sums(ell_dA), ell_diag(ell_A),
        ell_diag(ell_dA), rA.sum(-1), rdA.sum(-1))

    if ell_A.indices is ell_dA.indices:
        rowpart = ell_spmm(ell_A.combine(ell_dA, 1.0 + p1[0], 1.0 + p1[1]), M)
        colpart = ell_spmm_t(ell_A.combine(ell_dA, p2[0], p2[1]), M)
    else:
        rowpart = ((1.0 + p1[0]) * ell_spmm(ell_A, M)
                   + (1.0 + p1[1]) * ell_spmm(ell_dA, M))
        colpart = p2[0] * ell_spmm_t(ell_A, M) + p2[1] * ell_spmm_t(ell_dA, M)
    if add_identity:
        dvec = dvec + 1.0
    return _uv_terms(rowpart + colpart, dvec, u, v, c7, M)


def _rank_terms(pairs, dvec, rA, rdA, sA, M, p457, n):
    """``pairs + dvec M + u s^T + 1 (v^T M + c7 s)^T`` with ``s`` the column
    sums of M, for the undirected basis (shared by the ELL and BCSR
    applies)."""
    p4, p5, p7 = p457
    u = (p4[0] * rA + p4[1] * rdA) / n
    v = (p5[0] * rA + p5[1] * rdA) / n
    c7 = (p7[0] + p7[1]) * sA / n**2  # quirk: both use sum(A)
    return _uv_terms(pairs, dvec, u, v, c7, M)


def _uv_terms(pairs, dvec, u, v, c7, M):
    """``pairs + dvec M + u s^T + 1 (v^T M + c7 s)^T`` for given ``u``, ``v``,
    ``c7`` (either basis)."""
    s = M.sum(-2)
    w = (v.unsqueeze(-1) * M).sum(-2)
    return (
        pairs
        + dvec.unsqueeze(-1) * M
        + u.unsqueeze(-1) * s.unsqueeze(-2)
        + (w + c7.unsqueeze(-1) * s).unsqueeze(-2)
    )
