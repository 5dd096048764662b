"""K10: the ELL SpMM ``out[r] = sum_k values[r, k] * M[indices[r, k]]``.

Counterpart of ``gncde_tpu/ops/pallas/sparse_spmm.py`` (``_spmm_kernel``,
``_spmm_pallas``). On the TPU that kernel stayed a seed and XLA's gather
served ``ell_spmm``; on Hopper a gather is native, so K10
(``csrc/ell_spmm.cu``) serves ``ell_spmm`` itself.

Shapes are batch-first and broadcast: ``indices`` ``(n, K)`` or
``(B, n, K)`` int32 with padding slots ``== n``, ``values`` ``(n, K)`` or
``(B, n, K)`` f32, ``M`` ``(n, H)`` or ``(B, n, H)`` f32; the output is
batched when any operand is. An operand shared by the batch reaches the
kernel with batch stride 0 (an ``expand`` view, never a copy).

:func:`ell_spmm_call` launches K10 for CUDA tensors, counts the launch and
raises on what the kernel does not take; on CPU tensors it runs
:func:`plain_ell_spmm`. :class:`ELLSpMM` is the differentiable product:
forward K10; backward ``ell_sddmm(G, M)`` for the values (0 at padding
slots, plain torch) and, for ``M``, ``A^T G`` as K10 on the other pattern
the caller passes (``ops/sparse.py``: the transposed pattern for
``A @ M``, the original for ``A^T @ M``). JAX derives both from the XLA
gather, whose ``A^T G`` is a scatter-add; on the card a scatter adds with
atomics in no fixed order, which would leave the stepped parameters
unrepeatable, so no scatter runs in either direction.
:func:`plain_ell_spmm_t` (that scatter) stays as the plain version of
``A^T @ M`` the tests compare with.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

F32 = torch.float32
I32 = torch.int32


def batch_of(*xs_core):
    """The common batch size of ``(tensor, core_ndim)`` pairs (None when no
    tensor has a leading batch axis); raises on two different sizes."""
    B = None
    for x, core in xs_core:
        if x.dim() == core + 1:
            if B is not None and x.shape[0] != B:
                raise ValueError(f"batch sizes differ: {B} and {x.shape[0]}")
            B = x.shape[0]
        elif x.dim() != core:
            raise ValueError(f"expected {core} or {core + 1} dims, got {tuple(x.shape)}")
    return B


def take_rows(X, idx, x_batched: bool, idx_batched: bool):
    """``X[..., idx, ...]`` along X's row axis (axis 0 unbatched, 1 batched)
    with the batch axes matched: ``(R, *rest)`` or ``(B, R, *rest)`` rows,
    ``idx`` of any shape with an optional leading batch axis."""
    idx = idx.long()
    if not x_batched:
        return X[idx]
    if not idx_batched:
        return X[:, idx]
    ar = torch.arange(X.shape[0], device=X.device).reshape((-1,) + (1,) * (idx.dim() - 1))
    return X[ar, idx]


def _pad_row(X):
    """X with one zero row appended (the row that padding indices read)."""
    return torch.cat([X, X.new_zeros(X.shape[:-2] + (1, X.shape[-1]))], -2)


def plain_ell_spmm(indices, values, M):
    """K10's plain version: gather ``M`` padded with a zero row, then a
    weighted sum over the K slots (``ops/sparse.py`` ``ell_spmm`` in JAX)."""
    g = take_rows(_pad_row(M), indices, M.dim() == 3, indices.dim() == 3)
    return torch.einsum("...nk,...nkh->...nh", values, g)


def ell_sddmm(indices, X, Y):
    """``out[..., i, k] = X[..., i, :] . Y[..., indices[i, k], :]``, 0 at
    padding slots: the sampled product at the ELL pattern, which is the
    gradient of :func:`plain_ell_spmm` with respect to ``values``."""
    g = take_rows(_pad_row(Y), indices, Y.dim() == 3, indices.dim() == 3)
    return torch.einsum("...nh,...nkh->...nk", X, g)


def plain_ell_spmm_t(indices, values, M):
    """``A^T @ M``: ``values[r, k] * M[r]`` scatter-added into row
    ``indices[r, k]``; padding slots land in a dropped row ``n``."""
    n, H = M.shape[-2:]
    contrib = values.unsqueeze(-1) * M.unsqueeze(-2)  # (..., n, K, H)
    lead = contrib.shape[:-3]
    idx = indices.long().expand(contrib.shape[:-1])
    nb = 1
    for d in lead:
        nb *= d
    if lead:
        off = torch.arange(nb, device=idx.device) * (n + 1)
        idx = idx.reshape(nb, -1) + off[:, None]
    out = contrib.new_zeros(nb * (n + 1), H).index_add(
        0, idx.reshape(-1), contrib.reshape(-1, H))
    return out.reshape(lead + (n + 1, H))[..., :n, :]


def operand(x, core: int, B):
    """``(x, batch stride)`` of a kernel operand: inner dims contiguous, a
    batch stride of 0 for an operand shared by the batch. Read off the
    strides (no view is made); copied only where its inner dims are not
    contiguous (an ``expand`` view over the batch is not copied)."""
    if x.dim() == core:
        return x.contiguous(), 0
    if not x.is_contiguous():
        expect = 1
        for size, stride in zip(reversed(x.shape[1:]), reversed(x.stride()[1:])):
            if size != 1 and stride != expect:
                x = x.contiguous()
                break
            expect *= size
    return x, (x.stride(0) if B > 1 else 0)


_ARGTYPES = [_build.P, _build.L, _build.P, _build.L, _build.P, _build.L, _build.P,
             _build.I, _build.I, _build.I, _build.I, _build.I, _build.P]
_FN = None


def _fn():
    global _FN
    if _FN is None:
        _FN = _build.load("ell_spmm").gncde_ell_spmm
        _FN.argtypes = _ARGTYPES
        _FN.restype = ctypes.c_int
    return _FN


def ell_spmm_call(indices, values, M):
    """K10: ``A @ M`` for A in ELL form (shapes in the module docstring).

    The host work per call is what the launch needs: the checks below read
    shapes, strides, dtypes and device indices only (no view is made), the
    entry point is bound once, and pointers and the raw stream go to it as
    integers."""
    if not M.is_cuda:
        return plain_ell_spmm(indices, values, M)
    if indices.dtype != I32 or values.dtype != F32 or M.dtype != F32:
        raise ValueError(f"K10: indices must be int32 and values, M float32; got "
                         f"{indices.dtype}, {values.dtype}, {M.dtype}")
    dev = M.get_device()
    if indices.get_device() != dev or values.get_device() != dev:
        raise ValueError("K10: indices, values and M must be on one CUDA device")
    B = batch_of((indices, 2), (values, 2), (M, 2))
    ish, vsh, (n, H) = indices.shape, values.shape, M.shape[-2:]
    K = ish[-1]
    if ish[-2] != n or vsh[-2] != n or vsh[-1] != K:
        raise ValueError(f"K10: indices {tuple(ish)} and values {tuple(vsh)} must be "
                         f"(n={n}, K) like M's rows")
    Bk = B or 1
    idx, idx_bs = operand(indices, 2, Bk)
    val, val_bs = operand(values, 2, Bk)
    Mc, m_bs = operand(M, 2, Bk)
    out = M.new_empty((Bk, n, H))
    err = _fn()(idx.data_ptr(), idx_bs, val.data_ptr(), val_bs, Mc.data_ptr(), m_bs,
                out.data_ptr(), Bk, n, K, H, _build.SMS, _build.stream(dev))
    if err:
        _build.check(err, "K10 ell_spmm")
    ell_spmm_call.launches += 1
    return out if B is not None else out[0]


ell_spmm_call.launches = 0


def sum_to(g, shape):
    """Sum a gradient over the leading batch axis its input did not have."""
    return g.sum(0) if g.dim() > len(shape) else g


class ELLSpMM(torch.autograd.Function):
    """Differentiable ``A @ M`` for A in ELL form. Inputs ``(values, M,
    indices, t_indices, t_values)``: ``(t_indices, t_values)`` is ``A^T`` in
    ELL form (A's transposed pattern and its values), which the backward
    multiplies by ``G`` for ``d_M`` through K10. ``t_values`` may be None
    when ``M`` needs no gradient. Neither pattern gets a gradient, and
    ``t_values`` none through this function (it is a copy of the values
    laid out for the product)."""

    @staticmethod
    def forward(ctx, values, M, indices, t_indices, t_values):
        ctx.save_for_backward(indices, values, M, t_indices, t_values)
        return ell_spmm_call(indices, values, M)

    @staticmethod
    def backward(ctx, G):
        indices, values, M, t_indices, t_values = ctx.saved_tensors
        d_values = d_M = None
        if ctx.needs_input_grad[0]:
            d_values = sum_to(ell_sddmm(indices, G, M), values.shape)
        if ctx.needs_input_grad[1]:
            d_M = sum_to(ell_spmm_call(t_indices, t_values, G.contiguous()), M.shape)
        return d_values, d_M, None, None, None
