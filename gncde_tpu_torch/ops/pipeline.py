"""K13: the streamed fused equivariant layer apply (backend ``"pipeline"``).

Counterpart of ``gncde_tpu/ops/pallas/pipeline.py``. Per layer, on the
materialised planes ``A = A(t)``, ``dA = dA(t)``:

    out = (q00 A + q01 dA) M + (q10 A + q11 dA)^T M + dvec * M + u (x) s + 1 (x) wrow

* :func:`fused_conv_stream` is that function: K13 (``csrc/fused_apply.cu``,
  one launch) for CUDA tensors, :func:`plain_conv_stream` for CPU ones.
  A and dA may be any float dtype; the kernel computes in f32, as in JAX.
* :func:`_rank_structure` gives the O(n) parts of the undirected basis
  (``q``, ``dvec``, ``u``, ``v``, ``c7``) without forming B1/B2, and
  :func:`_prep` the kernel's operands from them (K12 uses it too).
* :func:`pipeline_fused_apply` is the differentiable drop-in for
  ``equiv_basis.fused_apply``: forward K13; backward (``_pfa_bwd``) ``dM``
  by K13 on the transposed operator (the rows of ``q`` swapped, ``u`` and
  ``v + c7`` exchanged), ``dB1 = g M^T`` and ``dB2 = M g^T`` as plain
  matmuls (JAX leaves them to XLA), and the O(n) chain by autograd of
  ``equiv_basis.fused_coeffs``.

The TPU kernel's ``block_n`` is its row-tile size; the Hopper kernel fixes
its own tiles and bound-checks n, so no size is passed. Shapes are
batch-first ``(B, n, n)``, ``(B, n, H)``, ``(B, n)``, ``(B, H)`` (the plain
versions also take unbatched ones). The directed basis comes with ROADMAP
Queue 1 item 4.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import equiv_basis

F32 = torch.float32


def plain_conv_stream(A, dA, M, dvec, u, s, wrow, q):
    """K13's plain version (f32)."""
    A, dA = A.float(), dA.float()
    R = q[0, 0] * A + q[0, 1] * dA
    C = q[1, 0] * A + q[1, 1] * dA
    return (R @ M + C.transpose(-2, -1) @ M + dvec[..., None] * M
            + u[..., None] * s[..., None, :] + wrow[..., None, :])


def _fn():
    fn = _build.load("fused_apply").gncde_fused_apply
    if fn.argtypes is None:
        P, I = _build.P, _build.I
        fn.argtypes = [P, P, I, I, P, P, I, P, P, P, P, P, P]
        fn.restype = ctypes.c_int
    return fn


def launch_apply(A, dA, M, dvec, u, s, w, q, what):
    """Launch ``csrc/fused_apply.cu`` (the kernel of K12 and K13) on CUDA
    tensors; raises on what it does not take. Counting is the caller's."""
    if M.dim() != 3:
        raise ValueError(f"{what}: batch-first operands expected; M is {tuple(M.shape)}")
    B, n, H = M.shape
    dev = M.device
    A = A.to(F32).contiguous()
    dA = dA.to(F32).contiguous()
    vecs = [x.to(F32).contiguous() for x in (M, dvec, u, s, w)]
    want = [(B, n, H), (B, n), (B, n), (B, H), (B, H)]
    if A.shape != (B, n, n) or dA.shape != (B, n, n) or any(
            x.shape != shape for x, shape in zip(vecs, want)):
        raise ValueError(f"{what}: A, dA (B, n, n), M (B, n, H), dvec, u (B, n) and "
                         f"s, w (B, H) expected; got A {tuple(A.shape)}, M {tuple(M.shape)}")
    if any(x.device != dev for x in (A, dA, *vecs)) or not M.is_cuda:
        raise ValueError(f"{what}: every operand must be on the same CUDA device")
    q4 = q.to(F32).reshape(4).contiguous()
    if q4.device != dev:
        raise ValueError(f"{what}: q must be on the operands' device")
    out = torch.empty((B, n, H), device=dev, dtype=F32)
    err = _fn()(_build.ptr(A), _build.ptr(dA), B, n, _build.ptr(q4), _build.ptr(vecs[0]), H,
                *[_build.ptr(x) for x in vecs[1:]], _build.ptr(out), _build.stream())
    _build.check(err, what)
    return out


def fused_conv_stream(A, dA, M, dvec, u, s, wrow, q):
    """K13: one pass ``(q00 A + q01 dA) M + (q10 A + q11 dA)^T M + dvec * M
    + u (x) s + 1 (x) wrow``. A, dA: ``(B, n, n)`` any float dtype (f32
    compute); M ``(B, n, H)``; dvec, u ``(B, n)``; s, wrow ``(B, H)``;
    q ``(2, 2)``."""
    if not M.is_cuda:
        return plain_conv_stream(A, dA, M, dvec, u, s, wrow, q)
    out = launch_apply(A, dA, M, dvec, u, s, wrow, q, "K13 fused_conv_stream")
    fused_conv_stream.launches += 1
    return out


fused_conv_stream.launches = 0


def _rank_structure(A, dA, params, directed: bool):
    """The O(n) parts of the fused operator, ``(q, dvec, u, v, c7)``, without
    forming B1/B2 (mirrors ``equiv_basis.fused_coeffs``, the reference's
    term_7 ``sum(A)`` quirk included)."""
    if directed:
        raise NotImplementedError(
            "the directed basis of the pipeline and pallas backends comes with the "
            "directed field (ROADMAP Queue 1 item 4)")
    p1, p2, p3, p4, p5, p6, p7, p8 = params
    n = A.shape[-1]
    rA, rdA = A.sum(-1), dA.sum(-1)
    sA, sdA = rA.sum(-1), rdA.sum(-1)
    dvec = (p3[0] * torch.diagonal(A, dim1=-2, dim2=-1)
            + p3[1] * torch.diagonal(dA, dim1=-2, dim2=-1)
            + (p6[0] * rA + p6[1] * rdA) / n
            + ((p8[0] * sA + p8[1] * sdA) / n**2)[..., None])
    u = (p4[0] * rA + p4[1] * rdA) / n
    v = (p5[0] * rA + p5[1] * rdA) / n
    c7 = (p7[0] + p7[1]) * sA / n**2
    q = torch.stack([torch.stack([1.0 + p1[0], 1.0 + p1[1]]), torch.stack([p2[0], p2[1]])])
    return q, dvec, u, v, c7


def _colvec(v, M):
    """``v @ M`` per element: ``(..., n)`` against ``(..., n, H)`` -> ``(..., H)``."""
    return (v[..., None] * M).sum(-2)


def _prep(A, dA, M, params, add_identity, transpose=False):
    """The kernel's operands ``(q, dvec, u, s, w)`` for ``A_bar @ M`` (+ ``M``
    with the identity): ``s = colsum(M)``, ``w = v M + c7 s``. With
    ``transpose`` they are those of ``A_bar^T @ M``, which is in the same
    family: the rows of ``q`` swap, and so do ``u`` and ``v + c7``."""
    q, dvec, u, v, c7 = _rank_structure(A, dA, params, False)
    if add_identity:
        dvec = dvec + 1.0
    s = M.sum(-2)
    if transpose:
        return q.flip(0), dvec, v + c7[..., None], s, _colvec(u, M)
    return q, dvec, u, s, _colvec(v, M) + c7[..., None] * s


def coeff_grads(A, dA, M, g, params, needs):
    """Cotangents of ``A``, ``dA`` and the basis parameters (where ``needs``)
    of ``fused_apply(A, dA, M, params)`` under output cotangent ``g``: the
    dense pair ``dB1 = g M^T``, ``dB2 = M g^T`` and the O(n) reduction
    cotangents, chained through autograd of ``equiv_basis.fused_coeffs``."""
    s, colsum_g = M.sum(-2), g.sum(-2)
    cots = (g @ M.transpose(-2, -1), M @ g.transpose(-2, -1), (g * M).sum(-1),
            (g * s[..., None, :]).sum(-1), (M * colsum_g[..., None, :]).sum(-1),
            (colsum_g * s).sum(-1))
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(need) for x, need in zip((A, dA, *params), needs)]
        outs = equiv_basis.fused_coeffs(leaves[0], leaves[1], leaves[2:])
        wrt = [x for x, need in zip(leaves, needs) if need]
        grads = iter(torch.autograd.grad(outs, wrt, cots, allow_unused=True))
    return [next(grads) if need else None for need in needs]


class PipelineFusedApply(torch.autograd.Function):
    """Inputs ``(add_identity, A, dA, M, *params)``."""

    @staticmethod
    def forward(ctx, add_identity, A, dA, M, *params):
        with torch.no_grad():
            q, dvec, u, s, wrow = _prep(A, dA, M, params, add_identity)
            out = fused_conv_stream(A, dA, M, dvec, u, s, wrow, q)
        ctx.add_identity = add_identity
        ctx.save_for_backward(A, dA, M, *params)
        return out

    @staticmethod
    def backward(ctx, g):
        A, dA, M, *params = ctx.saved_tensors
        need_A, need_dA, need_M, *need_p = ctx.needs_input_grad[1:]
        g = g.contiguous()
        dM = None
        if need_M:
            with torch.no_grad():
                q, dvec, u, s, wrow = _prep(A, dA, g, params, ctx.add_identity,
                                            transpose=True)
                dM = fused_conv_stream(A, dA, g, dvec, u, s, wrow, q)
        grads = [None] * (2 + len(params))
        if need_A or need_dA or any(need_p):
            grads = coeff_grads(A, dA, M, g, params, [need_A, need_dA, *need_p])
        dA_, ddA_, *dp = grads
        return (None, None if dA_ is None else dA_.to(A.dtype),
                None if ddA_ is None else ddA_.to(dA.dtype), dM, *dp)


def pipeline_fused_apply(A, dA, M, params, directed: bool = False,
                         add_identity: bool = False):
    """``A_bar @ M`` (+ ``M`` when ``add_identity``) through K13: the drop-in
    for ``equiv_basis.fused_apply`` with the same semantics."""
    if directed:
        _rank_structure(A, dA, params, True)  # raises
    return PipelineFusedApply.apply(add_identity, A, dA, M, *params)
