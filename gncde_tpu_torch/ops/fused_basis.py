"""K12: the fused equivariant-basis message passing (backend ``"pallas"``).

Counterpart of ``gncde_tpu/ops/pallas/fused_basis.py``. Computes
``out = A_bar @ M (+ M)`` for the undirected or the directed Maron-basis
operator without materialising ``A_bar`` or B1/B2: per row tile the kernel forms
``a1 A + a2 dA`` and ``b1 A + b2 dA`` on the fly, multiplies, and adds the
diagonal and rank-1 corrections. The backward is autograd of the plain
``equiv_basis.fused_apply``, as JAX's ``_bwd`` takes ``jax.vjp`` of it.

* :func:`_pallas_forward` is K12 (``csrc/fused_apply.cu``, the kernel K13
  shares: the function is the same) for CUDA tensors and
  :func:`plain_pallas_forward` for CPU ones.
* :func:`fused_apply_pallas` is the differentiable drop-in for
  ``equiv_basis.fused_apply``.

The JAX wrapper searches a row tile that divides n and otherwise falls back
to the decomposed XLA path, because the TPU kernel's blocks must tile n.
The Hopper kernel bound-checks its rows and columns and serves every n, so
there is no tile search and no fallback here. The operands come from
``pipeline._prep``, the O(n) terms without ``fused_coeffs``: torch, unlike
XLA, would not drop the unused B1/B2 planes. The directed basis changes
only those operands (``_prep(directed=True)``, from the directed rank
structure, as JAX builds them from ``fused_coeffs_directed``) and the
backward's autograd, which runs ``fused_apply(directed=True)``.
"""

from __future__ import annotations

import torch

from . import equiv_basis
from .pipeline import _prep, launch_apply


def plain_pallas_forward(A, dA, M, scalars, dvec, u, svec, wvec):
    """K12's plain version (f32)."""
    b1_row = scalars[0, 0] * A + scalars[0, 1] * dA
    b2_col = scalars[1, 0] * A + scalars[1, 1] * dA
    return (b1_row @ M + b2_col.transpose(-2, -1) @ M + dvec[..., None] * M
            + u[..., None] * svec[..., None, :] + wvec[..., None, :])


def _pallas_forward(A, dA, M, scalars, dvec, u, svec, wvec):
    """K12: the kernel for CUDA tensors, the plain version for CPU ones."""
    if not M.is_cuda:
        return plain_pallas_forward(A, dA, M, scalars, dvec, u, svec, wvec)
    out = launch_apply(A, dA, M, dvec, u, svec, wvec, scalars, "K12 fused_apply_pallas")
    _pallas_forward.launches += 1
    return out


_pallas_forward.launches = 0


class FusedApplyPallas(torch.autograd.Function):
    """Inputs ``(directed, add_identity, A, dA, M, *params)``."""

    @staticmethod
    def forward(ctx, directed, add_identity, A, dA, M, *params):
        with torch.no_grad():
            ops = _prep(A, dA, M, params, add_identity, directed=directed)
            out = _pallas_forward(A.float(), dA.float(), M.float(), *ops)
        ctx.directed, ctx.add_identity = directed, add_identity
        ctx.save_for_backward(A, dA, M, *params)
        return out

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(need)
                      for x, need in zip(ctx.saved_tensors, needs)]
            A, dA, M, *params = leaves
            out = equiv_basis.fused_apply(A, dA, M, params, directed=ctx.directed,
                                          add_identity=ctx.add_identity)
            wrt = [x for x, need in zip(leaves, needs) if need]
            grads = iter(torch.autograd.grad(out, wrt, g, allow_unused=True))
        return (None, None, *[next(grads) if need else None for need in needs])


def fused_apply_pallas(A, dA, M, params, directed: bool = False,
                       add_identity: bool = False):
    """``A_bar @ M`` (+ ``M``) through K12, same semantics as
    ``equiv_basis.fused_apply`` on the undirected or ``directed`` basis."""
    return FusedApplyPallas.apply(bool(directed), add_identity, A, dA, M, *params)
