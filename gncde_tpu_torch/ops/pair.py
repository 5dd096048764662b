"""The plane-pair primitive (K6a, K6b) and the enc_idx layer stack.

Counterpart of the rectangular pair section of
``gncde_tpu/ops/pallas/tiled.py``: ``_pair_call`` (K6a), ``_pair_dw_call``
(K6b), ``plane_pair_apply`` with ``_ppa_fwd``/``_ppa_bwd``, and
``tiled_vf_eval_planes``. Unlike the tiled regime's :class:`TiledFused2`,
the planes here are genuine differentiable inputs: the enc_idx path feeds
the modulated ``A(t)``, ``dA(t)``, functions of the modulation MLPs and the
node embedding, so their cotangents flow back through the rank-H products
``c . (g_r Mk^T, Mi g_c^T)``.

Each kernel wrapper (:func:`pair_call`, :func:`pair_dw_call`) launches
``csrc/plane_mma.cu`` (K6a, K6b) for CUDA tensors, counts the launch, and
raises on what the kernel does not take; on CPU tensors it runs its plain
version (``plain_pair``, ``plain_pair_dw``). Precision follows the planes, as in
the JAX package: f32 planes (``fusion_precision: f32``) form B1/B2 in f32
with f32 vectors; bf16 planes (``bf16``: K7bf's output) form B1/B2 in
bf16 (K6a-bf, the coefficients and every product and sum rounded to bf16)
and multiply them with the forward's f32 vectors or the backward's bf16
cotangents, and K6b-bf takes bf16 vectors; every sum is f32.

Shapes are batch-first: planes ``(B, nr, nc)``, ``Mk`` ``(B, nc, H)``,
``Mi`` ``(B, nr, H)``, unpadded (the kernels bound-check nr and nc). The
``c`` coefficients are shared by the batch, so their cotangents are summed
over it.
"""

from __future__ import annotations

import ctypes
import types
import typing as tp

import torch

from . import _build, tiled
from .tiled import MAX_H, TILED_MAX_N, aligned_planes, rank_terms

F32 = torch.float32
BF16 = torch.bfloat16


def plain_pair(A, dA, cvec, Mk, Mi):
    """K6a's plain version: ``(B1 @ Mk, B2^T @ Mi)`` f32 with B1 = cvec[0] A
    + cvec[1] dA and B2 = cvec[2] A + cvec[3] dA, formed in the planes'
    dtype (bf16: the coefficients rounded first, then each product and the
    sum, as ``_pair_kernel``), the products of their values with the
    vectors' in f32."""
    c = cvec.to(A.dtype)
    B1 = (c[0] * A + c[1] * dA).float()
    B2 = (c[2] * A + c[3] * dA).float()
    return B1 @ Mk.float(), B2.transpose(-2, -1) @ Mi.float()


def plain_pair_dw(A, dA, Gr, Mk, Mi, Gc):
    """K6b's plain version: ``(B, 4)`` = (<A, Gr Mk^T>, <dA, Gr Mk^T>,
    <A, Mi Gc^T>, <dA, Mi Gc^T>), the products of the operands' values and
    the sums in f32."""
    P = Gr.float() @ Mk.float().transpose(-2, -1)
    Q = Mi.float() @ Gc.float().transpose(-2, -1)
    return torch.stack([(X.float() * Y).sum((1, 2)) for Y in (P, Q) for X in (A, dA)], -1)


#: K6b's plane tile (rows and columns a CTA owns) and the columns of H one
#: stage of its ring holds (``csrc/plane_mma.cuh`` ``pk::DT``, ``pk::DHK``;
#: a card test holds them to the library's ``gncde_pair_dw_dims``).
DW_TILE = 64
DW_HK = 32


class PairDwPlan(tp.NamedTuple):
    """K6b's launch plan: ``tiles`` DW_TILE x DW_TILE plane tiles an element,
    the H extent's ``ceil(H / DW_HK)`` column chunks in ``splits`` parts (one
    CTA a tile and part), and ``parts = tiles * splits`` partial sums an
    element."""

    tiles: int
    splits: int
    parts: int


def pair_dw_plan(B: int, nr: int, nc: int, H: int) -> PairDwPlan:
    """K6b's plan for ``B`` elements of (nr, nc) planes and width H: one CTA
    a plane tile, and where those are fewer than two CTAs for each of the
    card's SMs (``_build.SMS``), H split across CTAs into as many parts as
    make up the difference (at most one a column chunk). The four inner
    products are linear in P and Q, so the parts' sums add."""
    tiles = -(-nr // DW_TILE) * -(-nc // DW_TILE)
    chunks = -(-H // DW_HK)
    splits = min(chunks, -(-2 * _build.SMS // (tiles * B)))
    return PairDwPlan(tiles, splits, tiles * splits)


_P, _I = _build.P, _build.I
_ARGTYPES = {
    "gncde_pair": [_P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _P],
    "gncde_pair_dw": [_P, _P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
}


def _fn(name: str):
    # Both run on the tensor cores (csrc/plane_mma.cu).
    fn = getattr(_build.load("plane_mma"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _check(what, A, dA, row_vecs, col_vecs, vec_dtypes) -> tuple[int, int, int, int]:
    """(B, nr, nc, H) of contiguous float32 or bfloat16 CUDA planes ``(B, nr,
    nc)`` of one dtype, row-side vectors ``(B, nr, H)`` and column-side
    vectors ``(B, nc, H)`` of one dtype in ``vec_dtypes`` on one device;
    raises otherwise."""
    shape = A.shape
    for P in (A, dA):
        if (P.dim() != 3 or P.shape != shape or P.dtype not in (F32, BF16)
                or P.dtype != A.dtype or not P.is_cuda or not P.is_contiguous()):
            raise ValueError(f"{what}: planes must be contiguous float32 or bfloat16 CUDA "
                             f"tensors of one (B, nr, nc) shape and dtype; got "
                             f"{tuple(P.shape)} {P.dtype}")
    B, nr, nc = shape
    if max(nr, nc) > TILED_MAX_N:
        raise ValueError(f"{what}: extent {max(nr, nc)} above TILED_MAX_N={TILED_MAX_N}")
    H = row_vecs[0].shape[-1]
    vdt = row_vecs[0].dtype
    if vdt not in vec_dtypes:
        raise ValueError(f"{what}: vectors of dtype {vdt} on {A.dtype} planes; the kernel "
                         f"takes {vec_dtypes}")
    for V, rows in [(V, nr) for V in row_vecs] + [(V, nc) for V in col_vecs]:
        if (V.shape != (B, rows, H) or V.dtype != vdt or V.device != A.device
                or not V.is_contiguous()):
            raise ValueError(f"{what}: vectors must be contiguous {vdt} (B={B}, {rows}, "
                             f"H={H}) tensors on the planes' device; got "
                             f"{tuple(V.shape)} {V.dtype}")
    if not 1 <= H <= MAX_H:
        raise ValueError(f"{what}: width H={H} outside [1, {MAX_H}]")
    return B, nr, nc, H


def pair_call(A, dA, cvec, Mk, Mi):
    """K6a: ``(rowpart (B, nr, H), colpart (B, nc, H))`` f32 for planes
    ``(B, nr, nc)``, ``cvec`` = (c_row0, c_row1, c_col0, c_col1), ``Mk``
    ``(B, nc, H)`` and ``Mi`` ``(B, nr, H)``: f32 planes with f32 vectors,
    or (K6a-bf) bf16 planes with f32 or bf16 vectors. The reduce extents go
    in :func:`~gncde_tpu_torch.ops.tiled.mma_splits` parts; a split call
    (one count in ``launches``) is two CUDA launches, the sweep and the
    parts' sum."""
    if not A.is_cuda:
        return plain_pair(A, dA, cvec, Mk, Mi)
    bf16 = A.dtype == BF16
    what = "K6a-bf" if bf16 else "K6a"
    B, nr, nc, H = _check(what, A, dA, (Mi,), (Mk,), (F32, BF16) if bf16 else (F32,))
    if cvec.shape != (4,) or cvec.dtype != F32 or cvec.device != A.device:
        raise ValueError(f"{what}: cvec must be a float32 (4,) tensor on the planes' device")
    A, dA = aligned_planes(A, dA)
    S = tiled.mma_splits(B, nr, nc, H)
    # One allocation: rowpart, colpart and, when split, the parts' slabs.
    buf = torch.empty((1 + (S if S > 1 else 0)) * B * (nr + nc) * H, device=A.device,
                      dtype=F32)
    row = buf[:B * nr * H].view(B, nr, H)
    col = buf[B * nr * H:B * (nr + nc) * H].view(B, nc, H)
    err = _fn("gncde_pair")(
        _build.ptr(A), _build.ptr(dA), nr, nc, _build.ptr(cvec), _build.ptr(Mk),
        _build.ptr(Mi), B, H, int(bf16), int(Mk.dtype == BF16), _build.ptr(row),
        _build.ptr(col), buf[B * (nr + nc) * H:].data_ptr() if S > 1 else None, S,
        _build.stream())
    _build.check(err, f"{what} pair")
    (pair_call.bf16 if bf16 else pair_call).launches += 1
    return row, col


def pair_dw_call(A, dA, Gr, Mk, Mi, Gc):
    """K6b: per-element ``(B, 4)`` f32 = (<A, Gr Mk^T>, <dA, Gr Mk^T>,
    <A, Mi Gc^T>, <dA, Mi Gc^T>) for planes ``(B, nr, nc)``, ``Gr``, ``Mi``
    ``(B, nr, H)`` and ``Mk``, ``Gc`` ``(B, nc, H)``, all f32 or (K6b-bf)
    all bf16, on :func:`pair_dw_plan`'s plan."""
    if not A.is_cuda:
        return plain_pair_dw(A, dA, Gr, Mk, Mi, Gc)
    bf16 = A.dtype == BF16
    what = "K6b-bf" if bf16 else "K6b"
    B, nr, nc, H = _check(what, A, dA, (Gr, Mi), (Mk, Gc), (A.dtype,))
    plan = pair_dw_plan(B, nr, nc, H)
    part = torch.empty((B, plan.parts, 4), device=A.device, dtype=F32)
    dw = torch.empty((B, 4), device=A.device, dtype=F32)
    err = _fn("gncde_pair_dw")(
        _build.ptr(A), _build.ptr(dA), nr, nc, _build.ptr(Gr), _build.ptr(Mk),
        _build.ptr(Mi), _build.ptr(Gc), B, H, int(bf16), plan.splits, _build.ptr(part),
        _build.ptr(dw), _build.stream())
    _build.check(err, f"{what} pair_dw")
    (pair_dw_call.bf16 if bf16 else pair_dw_call).launches += 1
    return dw


#: Launches of the f32 kernels; ``.bf16.launches`` those of K6a-bf, K6b-bf.
for _f in (pair_call, pair_dw_call):
    _f.launches = 0
    _f.bf16 = types.SimpleNamespace(launches=0)


class PlanePairApply(torch.autograd.Function):
    """``(B1 @ Mk, B2^T @ Mi)`` with B1 = c_row . (A, dA), B2 = c_col .
    (A, dA); every input differentiable. Backward (``_ppa_bwd``), its
    operands in the planes' dtype (``mm_dtype``: the cotangents, and for
    K6b ``Mk`` and ``Mi``, rounded to bf16 under bf16 planes): ``d_Mi`` and
    ``d_Mk`` from one K6a with the coefficient pairs swapped, the ``c``
    cotangents from K6b, the plane cotangents as the rank-H products
    ``c_row . g_r Mk^T + c_col . Mi g_c^T`` (f32 ``torch.matmul``, as the
    JAX package leaves them to XLA), cast to the planes' dtype. Inputs:
    ``(A, dA, c_row, c_col, Mk, Mi)``.
    """

    @staticmethod
    def forward(ctx, A, dA, c_row, c_col, Mk, Mi):
        cvec = torch.cat([c_row, c_col])
        out = pair_call(A, dA, cvec, Mk, Mi)
        ctx.save_for_backward(A, dA, c_row, c_col, Mk, Mi)
        return out

    @staticmethod
    def backward(ctx, g_r, g_c):
        A, dA, c_row, c_col, Mk, Mi = ctx.saved_tensors
        need_A, need_dA, need_cr, need_cc, need_Mk, need_Mi = ctx.needs_input_grad
        mm = A.dtype
        grb, gcb = g_r.to(mm).contiguous(), g_c.to(mm).contiguous()
        d_A = d_dA = d_cr = d_cc = d_Mk = d_Mi = None
        if need_Mk or need_Mi:
            # d_Mi = B2 g_c (row pass, pair c_col); d_Mk = B1^T g_r (column
            # pass, pair c_row): one sweep.
            d_Mi, d_Mk = pair_call(A, dA, torch.cat([c_col, c_row]), gcb, grb)
        if need_cr or need_cc:
            dw = pair_dw_call(A, dA, grb, Mk.to(mm).contiguous(), Mi.to(mm).contiguous(),
                              gcb).sum(0)
            d_cr, d_cc = dw[:2], dw[2:]
        if need_A or need_dA:
            GMt = g_r.float() @ Mk.float().transpose(-2, -1)
            MGt = Mi.float() @ g_c.float().transpose(-2, -1)
            d_A = (c_row[0] * GMt + c_col[0] * MGt).to(A.dtype)
            d_dA = (c_row[1] * GMt + c_col[1] * MGt).to(dA.dtype)
        return (d_A if need_A else None, d_dA if need_dA else None,
                d_cr if need_cr else None, d_cc if need_cc else None,
                d_Mk if need_Mk else None, d_Mi if need_Mi else None)


def plane_pair_apply(A, dA, c_row, c_col, Mk, Mi):
    """``(rowpart, colpart)``: see :class:`PlanePairApply`."""
    return PlanePairApply.apply(A.contiguous(), dA.contiguous(), c_row, c_col,
                                Mk.contiguous(), Mi.contiguous())


def tiled_vf_eval_planes(A, dA, Z, vf):
    """Evaluate a :class:`PermEquivGraphVectorField` or
    :class:`PermEquivDirGraphVectorField` on materialised planes ``A``,
    ``dA`` ``(B, n, n)`` (the enc_idx path's modulated planes: f32, or bf16
    under ``fusion_precision: bf16``) through K6a per layer, differentiable
    in the planes, ``Z`` ``(B, n, H)`` and the field's parameters.

    The reductions -- row sums, diagonals and totals, and for the directed
    basis the column sums -- come from the planes cast to f32, so their
    cotangents reach bf16 planes as bf16, as in the JAX package; plane
    gradients flow through them as well as through K6's rank-H cotangents.
    The undirected rank terms read row sums only, also on the modulated (no
    longer symmetric) planes, as the JAX package's ``_rank_terms`` does.
    """
    n = Z.shape[1]
    if A.shape[-2:] != (n, n):
        raise ValueError(f"planes of shape {tuple(A.shape)} do not match n={n}")
    Af, dAf = A.float(), dA.float()
    rA, rdA = Af.sum(-1), dAf.sum(-1)
    cA = cdA = None
    if len(vf.gnn_layers[0].params) == 11:
        cA, cdA = Af.sum(-2), dAf.sum(-2)
    dgA = torch.diagonal(Af, dim1=-2, dim2=-1)
    dgdA = torch.diagonal(dAf, dim1=-2, dim2=-1)
    sA, sdA = rA.sum(-1), rdA.sum(-1)
    feats = Z
    L = len(vf.gnn_layers)
    for l, layer in enumerate(vf.gnn_layers):
        M = layer.conv_layer.transform(feats)  # (B, n, H)
        p = layer.params
        rowp, colp = plane_pair_apply(A, dA, 1.0 + p[0], p[1], M, M)
        dvec, u, v, c7 = rank_terms(p, n, rA, rdA, dgA, dgdA, sA, sdA, cA, cdA)
        s = M.sum(1)  # (B, H)
        w = torch.einsum("bn,bnh->bh", v, M)
        feats = (rowp + colp + dvec[..., None] * M + u[..., None] * s[:, None, :]
                 + (w + c7[:, None] * s)[:, None, :])
        if l < L - 1:
            feats = torch.relu(feats)
    return feats
