"""Permutation-equivariant basis fusion operators (the dense oracle).

Counterpart of ``gncde_tpu/ops/equiv_basis.py``. Every function takes
``A``/``dA`` of shape ``(..., n, n)`` and parameters whose leading dims
broadcast against the ``...`` batch dims (each basis parameter is a
``(..., 2)`` vector). ``A_bar @ M`` decomposes as

    B1 @ M + B2^T @ M + dvec * M + u (x) colsum(M) + 1 (x) (v @ M + c7 colsum(M))

with ``B1 = (1+p1_0) A + (1+p1_1) dA`` and ``B2 = p2_0 A + p2_1 dA``.

Reference quirks kept on purpose (reference layers.py:144-148, 288-292):
  * ``term_7`` scales both operands by ``sum(A)``;
  * the directed ``term_4'`` mixes ``sum(A, axis=1)`` with ``sum(dA, axis=0)``.
"""

from __future__ import annotations

import typing as tp

import torch


class FusedCoeffs(tp.NamedTuple):
    """The O(n) data defining ``A_bar`` on top of the (B1, B2) dense pair."""

    B1: torch.Tensor  # (..., n, n)
    B2: torch.Tensor  # (..., n, n), applied as B2^T @ M
    dvec: torch.Tensor  # (..., n)
    u: torch.Tensor  # (..., n)
    v: torch.Tensor  # (..., n)
    c7: torch.Tensor  # (...)


def _s(p: torch.Tensor, k: int) -> torch.Tensor:
    """Component ``k`` of a ``(..., 2)`` parameter as a ``(..., 1, 1)`` scalar."""
    return p[..., k, None, None]


def _v(p: torch.Tensor, k: int) -> torch.Tensor:
    """Component ``k`` as a ``(..., 1)`` scalar for ``(..., n)`` vectors."""
    return p[..., k, None]


def _diag(x: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(x, dim1=-2, dim2=-1)


def _eye_like(A: torch.Tensor) -> torch.Tensor:
    return torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)


def _wide(*xs):
    """The reductions of bf16 planes (rounded to bf16, as ``jnp.sum`` of a
    bf16 array is) in f32, so that the f32 basis parameters promote them as
    they do in JAX (torch keeps a 0-dim f32 times a bf16 tensor in bf16);
    f32 and f64 pass unchanged."""
    return tuple(x.to(torch.promote_types(x.dtype, torch.float32)) for x in xs)


def fusion_matrix_dense(A, dA, params) -> torch.Tensor:
    """Materialise the undirected 8-term fused operator (layers.py:102-160).
    On bf16 planes the result is f32, as JAX's is."""
    p1, p2, p3, p4, p5, p6, p7, p8 = params
    n = A.shape[-1]
    rA, rdA, sA, sdA = _wide(A.sum(-1), dA.sum(-1), A.sum((-2, -1)), dA.sum((-2, -1)))
    At, dAt = A.transpose(-2, -1), dA.transpose(-2, -1)

    out = (1.0 + _s(p1, 0)) * A + (1.0 + _s(p1, 1)) * dA
    out = out + _s(p2, 0) * At + _s(p2, 1) * dAt
    out = out + torch.diag_embed(_v(p3, 0) * _diag(A) + _v(p3, 1) * _diag(dA))
    out = out + (_v(p4, 0) / n * rA + _v(p4, 1) / n * rdA)[..., :, None]
    out = out + (_v(p5, 0) / n * rA + _v(p5, 1) / n * rdA)[..., None, :]
    out = out + torch.diag_embed(_v(p6, 0) / n * rA + _v(p6, 1) / n * rdA)
    # Reference quirk: both summands of term_7 use sum(A).
    c7 = p7[..., 0] / n**2 * sA + p7[..., 1] / n**2 * sA
    out = out + c7[..., None, None]
    c8 = (p8[..., 0] * sA + p8[..., 1] * sdA) / n**2
    out = out + c8[..., None, None] * _eye_like(A)
    return out


def fusion_matrix_dense_directed(A, dA, params) -> torch.Tensor:
    """Dense oracle for the directed 11-term basis (layers.py:256-345); f32
    on bf16 planes, as :func:`fusion_matrix_dense`."""
    p1, p2, p3, p4, p4p, p5, p5p, p6, p6p, p7, p8 = params
    n = A.shape[-1]
    rA, rdA, cA, cdA, sA, sdA = _wide(A.sum(-1), dA.sum(-1), A.sum(-2), dA.sum(-2),
                                      A.sum((-2, -1)), dA.sum((-2, -1)))
    At, dAt = A.transpose(-2, -1), dA.transpose(-2, -1)

    out = (1.0 + _s(p1, 0)) * A + (1.0 + _s(p1, 1)) * dA
    out = out + _s(p2, 0) * At + _s(p2, 1) * dAt
    out = out + torch.diag_embed(_v(p3, 0) * _diag(A) + _v(p3, 1) * _diag(dA))
    # term_4: column sums broadcast over rows (entry (i,j) = colsum[i]).
    out = out + (_v(p4, 0) / n * cA + _v(p4, 1) / n * cdA)[..., :, None]
    # term_4_prime quirk: row-sum of A but column-sum of dA, broadcast as cols.
    out = out + (_v(p4p, 0) / n * rA + _v(p4p, 1) / n * cdA)[..., None, :]
    out = out + (_v(p5, 0) / n * cA + _v(p5, 1) / n * cdA)[..., None, :]
    out = out + (_v(p5p, 0) / n * rA + _v(p5p, 1) / n * rdA)[..., None, :]
    out = out + torch.diag_embed(_v(p6, 0) / n * cA + _v(p6, 1) / n * cdA)
    out = out + torch.diag_embed(_v(p6p, 0) / n * rA + _v(p6p, 1) / n * rdA)
    c7 = p7[..., 0] / n**2 * sA + p7[..., 1] / n**2 * sA
    out = out + c7[..., None, None]
    c8 = (p8[..., 0] * sA + p8[..., 1] * sdA) / n**2
    out = out + c8[..., None, None] * _eye_like(A)
    return out


def fused_coeffs(A, dA, params) -> FusedCoeffs:
    """Undirected 8-term basis -> rank-structured coefficients."""
    p1, p2, p3, p4, p5, p6, p7, p8 = params
    n = A.shape[-1]
    rA, rdA = A.sum(-1), dA.sum(-1)
    sA, sdA = A.sum((-2, -1)), dA.sum((-2, -1))

    B1 = (1.0 + _s(p1, 0)) * A + (1.0 + _s(p1, 1)) * dA
    B2 = _s(p2, 0) * A + _s(p2, 1) * dA
    dvec = (
        _v(p3, 0) * _diag(A)
        + _v(p3, 1) * _diag(dA)
        + (_v(p6, 0) * rA + _v(p6, 1) * rdA) / n
        + ((p8[..., 0] * sA + p8[..., 1] * sdA) / n**2)[..., None]
    )
    u = (_v(p4, 0) * rA + _v(p4, 1) * rdA) / n
    v = (_v(p5, 0) * rA + _v(p5, 1) * rdA) / n
    c7 = (p7[..., 0] + p7[..., 1]) * sA / n**2  # quirk: both use sum(A)
    return FusedCoeffs(B1, B2, dvec, u, v, c7)


def directed_rank_terms(params, n, rA, rdA, cA, cdA, dgA, dgdA, sA, sdA):
    """The O(n) terms ``(dvec, u, v, c7)`` of the directed 11-term basis
    (dvec without the residual identity) from the row sums ``rA``, ``rdA``,
    column sums ``cA``, ``cdA``, diagonals ``dgA``, ``dgdA`` (each
    ``(..., n)``) and totals ``sA``, ``sdA`` (``(...)``) of A and dA, with
    the reference's term_4' quirk (row sums of A, column sums of dA) and
    term_7 quirk (sum(A) for both operands). Every directed apply of the
    port -- dense, tiled, per-layer and sparse -- takes its terms here."""
    _, _, p3, p4, p4p, p5, p5p, p6, p6p, p7, p8 = params
    dvec = (
        _v(p3, 0) * dgA
        + _v(p3, 1) * dgdA
        + (_v(p6, 0) * cA + _v(p6, 1) * cdA) / n
        + (_v(p6p, 0) * rA + _v(p6p, 1) * rdA) / n
        + ((p8[..., 0] * sA + p8[..., 1] * sdA) / n**2)[..., None]
    )
    u = (_v(p4, 0) * cA + _v(p4, 1) * cdA) / n
    v = (
        (_v(p4p, 0) * rA + _v(p4p, 1) * cdA)  # term_4_prime quirk
        + (_v(p5, 0) * cA + _v(p5, 1) * cdA)
        + (_v(p5p, 0) * rA + _v(p5p, 1) * rdA)
    ) / n
    c7 = (p7[..., 0] + p7[..., 1]) * sA / n**2
    return dvec, u, v, c7


def fused_coeffs_directed(A, dA, params) -> FusedCoeffs:
    """Directed 11-term basis -> rank-structured coefficients."""
    p1, p2 = params[0], params[1]
    B1 = (1.0 + _s(p1, 0)) * A + (1.0 + _s(p1, 1)) * dA
    B2 = _s(p2, 0) * A + _s(p2, 1) * dA
    terms = directed_rank_terms(params, A.shape[-1], A.sum(-1), dA.sum(-1), A.sum(-2),
                                dA.sum(-2), _diag(A), _diag(dA), A.sum((-2, -1)),
                                dA.sum((-2, -1)))
    return FusedCoeffs(B1, B2, *terms)


def fused_matvec(coeffs: FusedCoeffs, M: torch.Tensor,
                 add_identity: bool = False) -> torch.Tensor:
    """``A_bar @ M`` (plus ``M`` when ``add_identity``) for ``M`` of shape
    ``(..., n, H)``: two matmuls and O(nH) vector work."""
    B1, B2, dvec, u, v, c7 = coeffs
    s = M.sum(-2)  # (..., H)
    w = (v[..., None] * M).sum(-2)  # (..., H)
    d = dvec + 1.0 if add_identity else dvec
    return (
        B1 @ M
        + B2.transpose(-2, -1) @ M
        + d[..., :, None] * M
        + u[..., :, None] * s[..., None, :]
        + (w + c7[..., None] * s)[..., None, :]
    )


def fused_apply(A, dA, M, params, directed: bool = False,
                add_identity: bool = False) -> torch.Tensor:
    """One-call fused ``(A, dA, M) -> A_bar @ M`` (never materialises A_bar)."""
    mk = fused_coeffs_directed if directed else fused_coeffs
    return fused_matvec(mk(A, dA, params), M, add_identity=add_identity)
