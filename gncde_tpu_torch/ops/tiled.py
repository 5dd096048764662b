"""The tiled regime (n > 640): per-layer plane sweeps K3, K4, K5a, K5b,
and the 4-slab apply K5c behind :func:`tiled_abar_apply`.

Counterpart of ``gncde_tpu/ops/pallas/tiled.py`` for the materialised-plane
path (``tiled_fused2`` and ``tiled_vf_eval``). Per vf eval the interval's
``A(t)`` and ``dA(t)`` are materialised once in bf16; every layer then runs

    heavy = B1 @ M + B2^T @ M,   B1 = c_row . (A, dA),  B2 = c_col . (A, dA)

through K3 and adds the O(n) rank-structured terms of the fused basis in
plain torch (as XLA does around the TPU kernel). Gradients flow through the
``autograd.Function`` :class:`TiledFused2`, whose backward has the four
branches of ``_tf2_bwd``: the training step's merged sweep K4 (dM and the
``c`` cotangents), K3 with the coefficient pairs swapped (dM alone), K5a
(the ``c`` cotangents alone) and K5b (the per-slab products a time
gradient needs).

Each kernel wrapper (:func:`fwd2_call`, :func:`bwd2_call`, :func:`dw2_call`,
:func:`dw_call`) launches ``csrc/tiled.cu`` (K4: ``csrc/plane_mma.cu``) for
CUDA tensors, counts the launch, and raises on what the kernel does not
take; on CPU tensors it runs its plain PyTorch version (``plain_*``), which
keeps the TPU kernels' rounding points: bf16 planes and vectors, B1/B2
formed in bf16 from coefficients rounded to bf16, and f32 accumulation.

Shapes are batch-first: planes ``(B, n, n)``, vectors ``(B, n, H)``,
per-element ``tau`` and Hermite weights ``(B, 4)``; the ``c`` coefficients
are shared by the batch, so their cotangents are summed over it. The kernels
bound-check every row and column against n, so nothing is padded (the TPU
kernels' padding to their tile is not needed on the card).

:func:`tiled_abar_apply` (``B(w_row) M + B(w_col)^T M`` straight from the
four Hermite slabs, ``B(w) = sum_j w_j slab_j``) keeps the JAX contract:
``M`` has ``NP = ceil(n / tile) tile`` rows whose tail is zero, and the
result has NP rows, zero beyond n. Its forward is K5c (:func:`abar_call`),
its backward K5c with the weight pairs swapped for ``dM``, K5b for the
weights and plain outer products for the slabs.
"""

from __future__ import annotations

import ctypes
import typing as tp

import torch

from . import _build
from .equiv_basis import directed_rank_terms
from .megakernel import interval, select_planes

#: Largest n the tiled regime serves (the JAX package's cap).
TILED_MAX_N = 32768
#: The JAX package's tile, which sets the padded row count NP of
#: :func:`tiled_abar_apply`'s M and output (the kernels need no tile).
DEFAULT_TILE = 256
#: Widest layer the wrappers take; the kernels sweep 128 columns at a time,
#: so any width works. The widest vf output of the repo's configs is 2048
#: (configs/pgt/twitter_perm_equiv_gncde.yaml: 64 * 16 * 2).
MAX_H = 4096

BF16 = torch.bfloat16


def hermite_weights(tau: torch.Tensor):
    """(wA, wdA), each ``(B, 4)``: weights of A(t0 + tau) and dA/dt over the
    (d, c, b, a) planes."""
    one = torch.ones_like(tau)
    zero = torch.zeros_like(tau)
    wA = torch.stack([tau * tau * tau, tau * tau, tau, one], -1)
    wdA = torch.stack([3.0 * tau * tau, 2.0 * tau, one, zero], -1)
    return wA, wdA


class PlaneReductions(tp.NamedTuple):
    """Per-plane sums over rows / columns and the diagonals, each
    ``(..., T-1, n, 4)`` float32 with the last axis ordered (d, c, b, a)."""

    rs: torch.Tensor
    cs: torch.Tensor
    dg: torch.Tensor


def cubic_plane_reductions(coeffs) -> PlaneReductions:
    """Reduce the four Hermite stacks once per trajectory."""
    rs = torch.stack([c.float().sum(-1) for c in coeffs], -1)
    cs = torch.stack([c.float().sum(-2) for c in coeffs], -1)
    dg = torch.stack([torch.diagonal(c, dim1=-2, dim2=-1).float() for c in coeffs], -1)
    return PlaneReductions(rs, cs, dg)


def reductions_from_slabs(slabs, wA, wdA):
    """(rA, rdA, cA, cdA, diagA, diagdA), each ``(B, n)``, straight from the
    interval slabs (used when the control carries no reductions)."""
    stack = torch.stack([s.float() for s in slabs], 1)  # (B, 4, n, n)
    A = torch.einsum("bp,bpij->bij", wA, stack)
    dA = torch.einsum("bp,bpij->bij", wdA, stack)
    return (A.sum(-1), dA.sum(-1), A.sum(-2), dA.sum(-2),
            torch.diagonal(A, dim1=-2, dim2=-1), torch.diagonal(dA, dim1=-2, dim2=-1))


def reductions_at(red: PlaneReductions, idx, wA, wdA):
    """(rA, rdA, cA, cdA, diagA, diagdA) at each element's interval, O(n)."""

    def at(x):
        if x.dim() == 4:  # per-element stacks (B, T-1, n, 4)
            return x[torch.arange(idx.shape[0], device=idx.device), idx]
        return x[idx]

    return tuple(torch.einsum("bnj,bj->bn", at(r), w)
                 for r in (red.rs, red.cs, red.dg) for w in (wA, wdA))


def rank_terms(p, n, rA, rdA, dgA, dgdA, sA, sdA, cA=None, cdA=None):
    """O(n) tail of the fused basis apply: (dvec, u, v, c7) with the residual
    identity folded into dvec, keeping the reference's term_7 quirk (both
    operands scaled by sum(A)). ``p`` is the undirected 8-term basis or the
    directed 11-term one (JAX ``tiled.py`` ``_rank_terms``), whose terms
    also read the column sums ``cA``, ``cdA``."""
    if len(p) == 11:
        dvec, u, v, c7 = directed_rank_terms(p, n, rA, rdA, cA, cdA, dgA, dgdA, sA, sdA)
        return dvec + 1.0, u, v, c7
    _, _, p3, p4, p5, p6, p7, p8 = p
    dvec = (p3[0] * dgA + p3[1] * dgdA
            + (p6[0] * rA + p6[1] * rdA) / n
            + ((p8[0] * sA + p8[1] * sdA) / n**2)[:, None] + 1.0)
    u = (p4[0] * rA + p4[1] * rdA) / n
    v = (p5[0] * rA + p5[1] * rdA) / n
    c7 = (p7[0] + p7[1]) * sA / n**2
    return dvec, u, v, c7


# ---------------------------------------------------------------------------
# Plain versions of the kernels
# ---------------------------------------------------------------------------


def plain_fwd2(A, dA, cvec, M):
    """K3's plain version: ``(B1 @ M, B2^T @ M)``, each ``(B, n, H)`` f32.
    B1/B2 are formed in bf16 with the coefficients rounded to bf16 (each
    product and the sum rounded, as a bf16 op does)."""
    c = cvec.to(BF16)
    B1 = (c[0] * A + c[1] * dA).float()
    B2 = (c[2] * A + c[3] * dA).float()
    m = M.float()
    return B1 @ m, B2.transpose(-2, -1) @ m


def plain_bwd2(A, dA, cvec, G, M):
    """K4's plain version: ``(rowp, colp, dw4)`` with
    rowp = c_col . (A g, dA g), colp = c_row . (A^T g, dA^T g) and
    dw4 = (<A, G M^T>, <dA, G M^T>, <A, M G^T>, <dA, M G^T>) per element."""
    Af, dAf = A.float(), dA.float()
    g, m = G.float(), M.float()
    AG, dAG = Af @ g, dAf @ g
    ATG, dATG = Af.transpose(-2, -1) @ g, dAf.transpose(-2, -1) @ g
    cv = cvec.float()
    dw = torch.stack([(x * m).sum((1, 2)) for x in (ATG, dATG, AG, dAG)], -1)
    return cv[0] * AG + cv[1] * dAG, cv[2] * ATG + cv[3] * dATG, dw


def plain_dw2(A, dA, G, M):
    """K5a's plain version: ``(B, 4)`` = (<A, G M^T>, <dA, G M^T>,
    <A, M G^T>, <dA, M G^T>)."""
    Af, dAf = A.float(), dA.float()
    g, m = G.float(), M.float()
    P = g @ m.transpose(-2, -1)
    Q = m @ g.transpose(-2, -1)
    return torch.stack([(X * Y).sum((1, 2)) for Y in (P, Q) for X in (Af, dAf)], -1)


def plain_dw(slabs, G, M):
    """K5b's plain version: ``(B, 8)`` = <slab_j, G M^T> (j < 4) and
    <slab_j, M G^T> (4 + j) over the f32 slabs (d, c, b, a)."""
    g, m = G.float(), M.float()
    P = g @ m.transpose(-2, -1)
    Q = m @ g.transpose(-2, -1)
    return torch.stack([(s.float() * Y).sum((1, 2)) for Y in (P, Q) for s in slabs], -1)


def plain_abar(slabs, wvec, M):
    """K5c's plain version: ``(B(w_row) @ M, B(w_col)^T @ M)``, each
    ``(B, n, H)`` f32, for slabs ``(B, n, n)`` (f32 or bf16), ``wvec``
    ``(B, 8)`` = (w_row, w_col) and bf16 ``M`` ``(B, n, H)``. B(w) is formed
    in f32 in _fwd_kernel's order and rounded to bf16."""
    st = [x.float() for x in slabs]

    def combo(w):
        x = w[:, 0, None, None] * st[0]
        for j in range(1, 4):
            x = x + w[:, j, None, None] * st[j]
        return x.to(BF16).float()

    m = M.float()
    return combo(wvec[:, :4]) @ m, combo(wvec[:, 4:]).transpose(-2, -1) @ m


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P, _I = _build.P, _build.I
_ARGTYPES = {
    "gncde_tiled_fwd2": [_P, _P, _I, _P, _P, _I, _I, _P, _P, _P, _I, _P],
    "gncde_tiled_bwd2": [_P, _P, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _P],
    "gncde_tiled_dw2": [_P, _P, _I, _P, _P, _I, _I, _P, _P, _P],
    "gncde_tiled_dw": [_P, _P, _P, _P, _I, _P, _P, _I, _I, _P, _P, _P],
    "gncde_tiled_abar": [_P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _P, _P, _P],
}


_FNS: tp.Dict[str, tp.Any] = {}
#: The library of each entry point: K4 (and K6a, ops/pair.py) run on the
#: tensor cores in csrc/plane_mma.cu, the rest in csrc/tiled.cu.
_LIB = {"gncde_tiled_bwd2": "plane_mma"}


def _fn(name: str):
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load(_LIB.get(name, "tiled")), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _check(what, planes, vecs, dtype=BF16) -> tuple[int, int, int]:
    """(B, n, H) of contiguous CUDA planes ``(B, n, n)`` of ``dtype`` and
    bf16 vectors ``(B, n, H)`` on the same device; raises otherwise."""
    shape = planes[0].shape
    for P in planes:
        if (P.dim() != 3 or P.shape != shape or shape[1] != shape[2] or P.dtype != dtype
                or not P.is_cuda or not P.is_contiguous()):
            raise ValueError(f"{what}: planes must be contiguous CUDA {dtype} tensors of "
                             f"one (B, n, n) shape; got {tuple(P.shape)} {P.dtype}")
    B, n, _ = shape
    if n > TILED_MAX_N:
        raise ValueError(f"{what}: n={n} above TILED_MAX_N={TILED_MAX_N}")
    H = vecs[0].shape[-1]
    for V in vecs:
        if (V.shape != (B, n, H) or V.dtype != BF16 or V.device != planes[0].device
                or not V.is_contiguous()):
            raise ValueError(f"{what}: vectors must be contiguous bf16 (B={B}, n={n}, H) "
                             f"tensors on the planes' device; got {tuple(V.shape)} "
                             f"{V.dtype}")
    if not 1 <= H <= MAX_H:
        raise ValueError(f"{what}: width H={H} outside [1, {MAX_H}]")
    return B, n, H


def _check_cvec(what, cvec, dev):
    if cvec.shape != (4,) or cvec.dtype != torch.float32 or cvec.device != dev:
        raise ValueError(f"{what}: cvec must be a float32 (4,) tensor on the planes' device")


def _f32(dev, *shape):
    return torch.empty(shape, device=dev, dtype=torch.float32)


#: csrc/tiled.cu K3: owned indices per CTA, depth of one reduce tile.
FWD2_BO, FWD2_BK = 64, 32


def fwd2_chunk(H: int) -> int:
    """K3's column chunk for width H: the least of 8, 32, 128 that holds H
    (wider H in chunks of 128)."""
    return 8 if H <= 8 else 32 if H <= 32 else 128


def _fill_splits(B: int, blocks: int, chunks: int, tiles: int) -> int:
    """Parts of a reduce extent of ``tiles`` 32-deep tiles for a grid of 2
    passes x ``blocks`` owned blocks x ``chunks`` column chunks x B: as many
    as keep it within two CTAs per SM, and at least 4 tiles a part; 1 when
    the grid fills the card without a split."""
    return max(1, min((2 * _build.SMS) // (2 * B * blocks * chunks), tiles // 4))


def fwd2_splits(B: int, n: int, H: int) -> int:
    """How many parts K3 splits the reduce extent into (:func:`_fill_splits`
    for its 64-index blocks and column chunks)."""
    return _fill_splits(B, -(-n // FWD2_BO), -(-H // fwd2_chunk(H)), -(-n // FWD2_BK))


#: csrc/plane_mma.cu (K4, K6a): owned indices per CTA, depth of one reduce tile.
MMA_BO, MMA_BK = 64, 32


def mma_chunk(H: int) -> int:
    """K4's and K6a's column chunk for width H: the least of 8, 32, 64 that
    holds H (wider H in chunks of 64, each its own CTAs)."""
    return 8 if H <= 8 else 32 if H <= 32 else 64


def mma_splits(B: int, nr: int, nc: int, H: int) -> int:
    """How many parts K4 and K6a split their reduce extents into, on planes
    ``(B, nr, nc)`` (:func:`_fill_splits` for blocks of the longer extent and
    tiles of the shorter)."""
    return _fill_splits(B, -(-max(nr, nc) // MMA_BO), -(-H // mma_chunk(H)),
                        -(-min(nr, nc) // MMA_BK))


def aligned_planes(A, dA):
    """The planes, each copied where its base is not 16-byte aligned (the
    tensor-core sweeps read them by 16-byte granules from an aligned base)."""
    if (A.data_ptr() | dA.data_ptr()) & 15:
        return tuple(x if x.data_ptr() % 16 == 0 else x.clone() for x in (A, dA))
    return A, dA


def fwd2_call(A, dA, cvec, M):
    """K3: ``(rowpart, colpart)``, each ``(B, n, H)`` f32, for bf16 planes
    ``A``/``dA`` (B, n, n), ``cvec`` = (c_row0, c_row1, c_col0, c_col1) and
    bf16 ``M`` (B, n, H). The reduce extent goes in :func:`fwd2_splits`
    parts; with more than one, the kernel sums them in a second launch, so
    one call (one count in ``launches``) is then two kernel launches."""
    if not A.is_cuda:
        return plain_fwd2(A, dA, cvec, M)
    B, n, H = _check("K3", (A, dA), (M,))
    _check_cvec("K3", cvec, A.device)
    S = fwd2_splits(B, n, H)
    if not 1 <= S <= -(-n // FWD2_BK):
        raise ValueError(f"K3: splits={S} outside [1, ceil(n / {FWD2_BK})]")
    A, dA = aligned_planes(A, dA)
    # One allocation: rowpart, colpart and, when split, the parts' slabs.
    buf = A.new_empty((2 + (2 * S if S > 1 else 0), B, n, H), dtype=torch.float32)
    row, col = buf[0], buf[1]
    err = _fn("gncde_tiled_fwd2")(
        A.data_ptr(), dA.data_ptr(), n, cvec.data_ptr(), M.data_ptr(), B, H,
        row.data_ptr(), col.data_ptr(), buf[2].data_ptr() if S > 1 else None, S,
        _build.stream(A.get_device()))
    if err:
        _build.check(err, "K3 tiled fwd2")
    fwd2_call.launches += 1
    return row, col


def bwd2_call(A, dA, cvec, G, M):
    """K4: ``(rowp, colp, dw4)`` -- the dM parts ``(B, n, H)`` f32 and the
    per-element ``(B, 4)`` inner products, for ``cvec`` = (c_col0, c_col1,
    c_row0, c_row1) and bf16 ``G``, ``M`` (B, n, H). The reduce extent goes
    in :func:`mma_splits` parts; one call (one count in ``launches``) is two
    CUDA launches, three when split: the sweep, the parts' sum, the inner
    products' sum."""
    if not A.is_cuda:
        return plain_bwd2(A, dA, cvec, G, M)
    B, n, H = _check("K4", (A, dA), (G, M))
    _check_cvec("K4", cvec, A.device)
    A, dA = aligned_planes(A, dA)
    S = mma_splits(B, n, n, H)
    chunks = -(-H // mma_chunk(H))
    # One allocation: rowp, colp and, when split, the parts' slabs.
    buf = _f32(A.device, 2 + (2 * S if S > 1 else 0), B, n, H)
    dwpart = _f32(A.device, B, -(-n // MMA_BO) * 2 * S * chunks, 4)
    dw = _f32(A.device, B, 4)
    err = _fn("gncde_tiled_bwd2")(
        A.data_ptr(), dA.data_ptr(), n, cvec.data_ptr(), G.data_ptr(), M.data_ptr(), B, H,
        buf[0].data_ptr(), buf[1].data_ptr(), buf[2].data_ptr() if S > 1 else None,
        dwpart.data_ptr(), dw.data_ptr(), S, _build.stream(A.get_device()))
    if err:
        _build.check(err, "K4 tiled bwd2")
    bwd2_call.launches += 1
    return buf[0], buf[1], dw


def dw2_call(A, dA, G, M):
    """K5a: per-element ``(B, 4)`` = (<A, G M^T>, <dA, G M^T>, <A, M G^T>,
    <dA, M G^T>) for bf16 planes (B, n, n) and bf16 ``G``, ``M`` (B, n, H)."""
    if not A.is_cuda:
        return plain_dw2(A, dA, G, M)
    B, n, H = _check("K5a", (A, dA), (G, M))
    part = _f32(A.device, B, -(-n // 8), 4)  # tiled.cu: the least BO of K5a is 8
    dw = _f32(A.device, B, 4)
    err = _fn("gncde_tiled_dw2")(
        _build.ptr(A), _build.ptr(dA), n, _build.ptr(G), _build.ptr(M), B, H,
        _build.ptr(part), _build.ptr(dw), _build.stream())
    _build.check(err, "K5a tiled dw2")
    dw2_call.launches += 1
    return dw


def dw_call(slabs, G, M):
    """K5b: per-element ``(B, 8)`` = <slab_j, G M^T> (j < 4) and
    <slab_j, M G^T> (4 + j) for the four f32 interval slabs (B, n, n)."""
    if not G.is_cuda:
        return plain_dw(slabs, G, M)
    B, n, H = _check("K5b", slabs, (G, M), dtype=torch.float32)
    part = _f32(G.device, B, -(-n // 4), 8)  # tiled.cu: the least BO of K5b is 4
    dw = _f32(G.device, B, 8)
    err = _fn("gncde_tiled_dw")(
        *[_build.ptr(s) for s in slabs], n, _build.ptr(G), _build.ptr(M), B, H,
        _build.ptr(part), _build.ptr(dw), _build.stream())
    _build.check(err, "K5b tiled dw")
    dw_call.launches += 1
    return dw


def abar_call(slabs, wvec, M):
    """K5c: ``(rowpart, colpart)``, each ``(B, n, H)`` f32, for four slabs
    ``(B, n, n)`` (all f32 or all bf16), ``wvec`` ``(B, 8)`` f32 = (w_row,
    w_col) per element and bf16 ``M`` ``(B, n, H)``."""
    if not M.is_cuda:
        return plain_abar(slabs, wvec, M)
    dtype = slabs[0].dtype
    if dtype not in (torch.float32, BF16):
        raise ValueError(f"K5c: slabs must be float32 or bfloat16; got {dtype}")
    B, n, H = _check("K5c", slabs, (M,), dtype=dtype)
    if wvec.shape != (B, 8) or wvec.dtype != torch.float32 or wvec.device != M.device:
        raise ValueError("K5c: wvec must be a float32 (B, 8) tensor on the planes' device")
    row, col = _f32(M.device, B, n, H), _f32(M.device, B, n, H)
    err = _fn("gncde_tiled_abar")(
        *[_build.ptr(x) for x in slabs], int(dtype == BF16), n,
        _build.ptr(wvec.contiguous()), _build.ptr(M), B, H, _build.ptr(row),
        _build.ptr(col), _build.stream())
    _build.check(err, "K5c tiled abar")
    abar_call.launches += 1
    return row, col


for _f in (fwd2_call, bwd2_call, dw2_call, dw_call, abar_call):
    _f.launches = 0


# ---------------------------------------------------------------------------
# The differentiable per-layer primitive
# ---------------------------------------------------------------------------


class TiledFused2(torch.autograd.Function):
    """``B1 @ M + B2^T @ M`` with B1 = c_row . (A, dA), B2 = c_col . (A, dA).

    ``A``/``dA`` are the materialised bf16 interval planes, cache inputs
    that must not require grad: the derivative flows through the slabs,
    ``wA``/``wdA`` (the tau chain), ``c_row``/``c_col`` and ``M``.
    Inputs: ``(A, dA, d, c, b, a, wA, wdA, c_row, c_col, M)``.
    """

    @staticmethod
    def forward(ctx, A, dA, d, c, b, a, wA, wdA, c_row, c_col, M):
        if A.requires_grad or dA.requires_grad:
            raise ValueError("tiled_fused2: A/dA are cache inputs; pass detached "
                             "planes, gradients flow through (slabs, wA, wdA, c)")
        needs = ctx.needs_input_grad
        ctx.need_slabs = any(needs[2:6])
        ctx.need_w = needs[6] or needs[7]
        # The slabs are kept only for the branches that read them.
        slabs = (d, c, b, a) if (ctx.need_slabs or ctx.need_w) else ()
        cvec = torch.cat([c_row, c_col]).float()
        rowpart, colpart = fwd2_call(A, dA, cvec, M.to(BF16).contiguous())
        ctx.save_for_backward(A, dA, wA, wdA, c_row, c_col, M, *slabs)
        return rowpart + colpart

    @staticmethod
    def backward(ctx, g):
        A, dA, wA, wdA, c_row, c_col, M, *slabs = ctx.saved_tensors
        need_slabs, need_w = ctx.need_slabs, ctx.need_w
        need_cr, need_cc, need_M = ctx.needs_input_grad[8:11]
        gb, Mb = g.to(BF16).contiguous(), M.to(BF16).contiguous()
        d_M = d_wA = d_wdA = d_cr = d_cc = None
        d_slabs = [None] * 4
        # The training hot path: one merged sweep gives dM and the c cotangents.
        use_merged = need_M and (need_cr or need_cc) and not (need_slabs or need_w)
        if need_M and not use_merged:
            # Transposing the operator swaps the row/col coefficient pairs.
            rowp, colp = fwd2_call(A, dA, torch.cat([c_col, c_row]).float(), gb)
            d_M = rowp + colp
        if need_slabs or need_w:
            dw8 = dw_call(tuple(s.contiguous() for s in slabs), gb, Mb)
            r8, c8 = dw8[:, :4], dw8[:, 4:]
            if need_w:
                d_wA = c_row[0] * r8 + c_col[0] * c8
                d_wdA = c_row[1] * r8 + c_col[1] * c8
            d_cr = torch.stack([(r8 * wA).sum(-1), (r8 * wdA).sum(-1)], -1).sum(0)
            d_cc = torch.stack([(c8 * wA).sum(-1), (c8 * wdA).sum(-1)], -1).sum(0)
            if need_slabs:
                GMt = g.float() @ M.float().transpose(-2, -1)
                MGt = GMt.transpose(-2, -1)
                w_row = c_row[0] * wA + c_row[1] * wdA
                w_col = c_col[0] * wA + c_col[1] * wdA
                d_slabs = [(w_row[:, j, None, None] * GMt + w_col[:, j, None, None] * MGt)
                           .to(slabs[j].dtype) for j in range(4)]
        elif use_merged:
            rowp, colp, dw4 = bwd2_call(A, dA, torch.cat([c_col, c_row]).float(), gb, Mb)
            d_M = rowp + colp
            d_cr, d_cc = dw4[:, :2].sum(0), dw4[:, 2:].sum(0)
        elif need_cr or need_cc:
            dw4 = dw2_call(A, dA, gb, Mb)
            d_cr, d_cc = dw4[:, :2].sum(0), dw4[:, 2:].sum(0)
        return (None, None, *d_slabs, d_wA, d_wdA,
                d_cr if need_cr else None, d_cc if need_cc else None, d_M)


def tiled_fused2(A, dA, slabs, wA, wdA, c_row, c_col, M):
    """``(B, n, H)`` f32: see :class:`TiledFused2`."""
    return TiledFused2.apply(A, dA, *slabs, wA, wdA, c_row, c_col, M)


# ---------------------------------------------------------------------------
# The 4-slab apply
# ---------------------------------------------------------------------------


class TiledAbarApply(torch.autograd.Function):
    """Inputs ``(tile, d, c, b, a, w_row, w_col, M)``, batch-first; see
    :func:`tiled_abar_apply`."""

    @staticmethod
    def forward(ctx, tile, d, c, b, a, w_row, w_col, M):
        B, n = d.shape[0], d.shape[-1]
        NP, H = M.shape[-2:]
        if NP != -(-n // tile) * tile:
            raise ValueError(f"M rows {NP} != padded n {-(-n // tile) * tile} "
                             f"(n={n}, tile={tile})")
        if M.shape[0] != B or w_row.shape != (B, 4) or w_col.shape != (B, 4):
            raise ValueError("tiled_abar_apply: slabs, weights and M must share a batch")
        slabs = tuple(x.contiguous() for x in (d, c, b, a))
        w = torch.cat([w_row, w_col], -1).float().contiguous()
        Mb = M[:, :n].to(BF16).contiguous()
        row, col = abar_call(slabs, w, Mb)
        out = row.new_zeros((B, NP, H))
        out[:, :n] = row + col
        ctx.n = n
        ctx.save_for_backward(*slabs, w, Mb, M)
        return out

    @staticmethod
    def backward(ctx, g):
        d, c, b, a, w, Mb, M = ctx.saved_tensors
        slabs = (d, c, b, a)
        need = ctx.needs_input_grad
        n = ctx.n
        gb = g[:, :n].to(BF16).contiguous()
        d_M = d_wr = d_wc = None
        d_slabs = [None] * 4
        if need[7]:
            # Transposing the operator swaps the row and column weights.
            row, col = abar_call(slabs, torch.cat([w[:, 4:], w[:, :4]], -1).contiguous(), gb)
            d_M = torch.zeros_like(g, dtype=torch.float32)
            d_M[:, :n] = row + col
        if need[5] or need[6]:
            dw = dw_call(tuple(x.float().contiguous() for x in slabs), gb, Mb)
            d_wr = dw[:, :4] if need[5] else None
            d_wc = dw[:, 4:] if need[6] else None
        if any(need[1:5]):
            # Rare (the planes are data in every trainer): dense outer products.
            GMt = g[:, :n].float() @ M[:, :n].float().transpose(-2, -1)
            MGt = GMt.transpose(-2, -1)
            d_slabs = [(w[:, j, None, None] * GMt + w[:, 4 + j, None, None] * MGt).to(x.dtype)
                       for j, x in enumerate(slabs)]
        return (None, *d_slabs, d_wr, d_wc, d_M)


def tiled_abar_apply(slabs, w_row, w_col, M, tile: int = DEFAULT_TILE):
    """``B(w_row) @ M + B(w_col)^T @ M`` over the four Hermite interval slabs
    ``(d, c, b, a)``, ``B(w) = sum_j w_j slab_j``, through K5c.

    slabs: four ``(n, n)`` planes (f32 or bf16; consumed as bf16 matmul
    operands with f32 sums). w_row, w_col: ``(4,)``. M: ``(NP, H)`` with
    ``NP = ceil(n / tile) tile`` and rows >= n zero. Returns ``(NP, H)`` f32
    whose first n rows hold the result and the rest are zero (the JAX
    contract). With a leading batch axis on every input (slabs ``(B, n,
    n)``, weights ``(B, 4)``, M ``(B, NP, H)``) each element is its own
    apply. Differentiable in every input.
    """
    if M.dim() == 3:
        return TiledAbarApply.apply(tile, *slabs, w_row, w_col, M)
    out = TiledAbarApply.apply(tile, *(x[None] for x in slabs), w_row[None], w_col[None],
                               M[None])
    return out[0]


# ---------------------------------------------------------------------------
# Full vector-field evaluation
# ---------------------------------------------------------------------------


def tiled_vf_eval(coeffs, ts, t, Z, vf, red: tp.Optional[PlaneReductions] = None):
    """Evaluate a perm-equiv field (undirected or directed) at ``(t, Z)``
    through the tiled kernels.

    ``coeffs``: the slim Hermite stacks (d, c, b, a), each ``(B, T-1, n, n)``
    (or shared ``(T-1, n, n)``); ``ts`` ``(B, T)`` or ``(T,)``; ``t`` ``(B,)``;
    ``Z`` ``(B, n, H)``; ``red``: the control's cached reductions (computed
    from the slabs when absent). Differentiable in ``Z``, the field's
    parameters and ``t``; the planes are data. Matches the dense chain
    ``fused_apply(A(t), dA(t), transform(.), params, add_identity=True)``
    per layer with ReLU between layers, in bf16 matmul precision.
    """
    B, n, _ = Z.shape
    if ts.dim() == 1:
        ts = ts.unsqueeze(0).expand(B, -1)
    idx, tau = interval(ts, t)
    slabs = select_planes(tuple(coeffs), idx)
    wA, wdA = hermite_weights(tau)
    if red is not None:
        rA, rdA, cA, cdA, dgA, dgdA = reductions_at(red, idx, wA, wdA)
    else:
        rA, rdA, cA, cdA, dgA, dgdA = reductions_from_slabs(slabs, wA, wdA)
    sA, sdA = rA.sum(-1), rdA.sum(-1)

    # Materialise the bf16 interval planes once per eval; every layer's
    # sweep then reads two planes instead of four.
    with torch.no_grad():
        df, cf, bf, af = (s.float() for s in slabs)
        tt = tau.detach()[:, None, None]
        A_h = (((df * tt + cf) * tt + bf) * tt + af).to(BF16)
        dA_h = ((3.0 * df * tt + 2.0 * cf) * tt + bf).to(BF16)

    feats = Z
    L = len(vf.gnn_layers)
    for l, layer in enumerate(vf.gnn_layers):
        M = layer.conv_layer.transform(feats)  # (B, n, H)
        p = layer.params
        heavy = tiled_fused2(A_h, dA_h, slabs, wA, wdA, 1.0 + p[0], p[1], M)
        dvec, u, v, c7 = rank_terms(p, n, rA, rdA, dgA, dgdA, sA, sdA, cA, cdA)
        s = M.sum(1)  # (B, H)
        w = torch.einsum("bn,bnh->bh", v, M)
        feats = (heavy + dvec[..., None] * M + u[..., None] * s[:, None, :]
                 + (w + c7[:, None] * s)[:, None, :])
        if l < L - 1:
            feats = torch.relu(feats)
    return feats
