"""Block-sparse (BCSR / blocked-ELL) graph operators: K8 (SpMM) and K9 (SDDMM).

Counterpart of ``gncde_tpu/ops/bcsr.py`` (undirected subset). The matrix is
a grid of dense ``bs x bs`` tiles of which only the stored ones are kept:
``block_idx (..., nb, kb)`` int32 column-block ids per block row (padding
slots hold 0 and all-zero tiles) and ``blocks (..., nb, kb, bs, bs)``. A
leading batch axis is optional on every operand; an unbatched operand is
shared by the batch and reaches the kernels with batch stride 0, never as a
broadcast copy. ``A^T @ M`` does not scatter: the transposed layout is
built once on the host and ``A^T @ M`` is K8 on it.

:func:`bcsr_spmm` (K8, ``csrc/bcsr.cu``) and :func:`bcsr_sddmm` (K9) launch
their kernels for CUDA tensors, count the launch and raise on what the
kernels do not take (``bs`` above 128); on CPU tensors they run
:func:`bcsr_spmm_plain` / :func:`bcsr_sddmm_plain`, the counterparts of
``bcsr_spmm_xla`` / ``bcsr_sddmm_xla``. :func:`bcsr_spmm_grad` is the
differentiable product (``_bsg_bwd``'s rules): d_blocks = K9(G, M) masked
by the valid slots, d_M = K8 on the transposed layout, and zero gradient
for the transposed blocks by design.

The host-side builders (patterns from masks or edge lists, tile gathers,
diagonal slots, fill ratio) are numpy, as the JAX package's numpy branches.
"""

from __future__ import annotations

import ctypes
import typing as tp

import numpy as np
import torch

from . import _build
from .ell_spmm import batch_of, operand, sum_to, take_rows
from .equiv_basis import directed_rank_terms
from .sparse import _rank_terms, _uv_terms

F32 = torch.float32
#: Largest block size the kernels take.
MAX_BS = 128


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class BCSR:
    """Blocked-ELL sparse matrix. ``nblocks (..., nb)`` counts the valid
    slots per block row (slots at or past it are zero padding); it is
    needed by the differentiable path to mask padded slots."""

    def __init__(self, block_idx, blocks, n: int, nblocks=None):
        self.block_idx = block_idx
        self.blocks = blocks
        self.n = n
        self.nblocks = nblocks

    @property
    def block_size(self) -> int:
        return self.blocks.shape[-1]

    @property
    def nb(self) -> int:
        return self.block_idx.shape[-2]

    @property
    def kb(self) -> int:
        return self.block_idx.shape[-1]


def slot_mask(block_idx, nblocks) -> torch.Tensor:
    """``(..., nb, kb)`` float32: 1 on valid slots, 0 on zero padding."""
    kb = block_idx.shape[-1]
    ar = torch.arange(kb, device=block_idx.device)
    return (ar < nblocks.unsqueeze(-1)).to(F32)


def _np_bcsr_from_dense(A: np.ndarray, bs: int, max_blocks_per_row=None):
    n = A.shape[0]
    nb = _cdiv(n, bs)
    Ap = np.zeros((nb * bs, nb * bs), A.dtype)
    Ap[:n, :n] = A
    tiles = Ap.reshape(nb, bs, nb, bs).transpose(0, 2, 1, 3)  # (nb, nb, bs, bs)
    nz = [np.nonzero(np.any(tiles[i] != 0, axis=(1, 2)))[0] for i in range(nb)]
    kb = max((len(z) for z in nz), default=1) or 1
    if max_blocks_per_row is not None:
        if any(len(z) > max_blocks_per_row for z in nz):
            raise ValueError("max_blocks_per_row too small for this pattern")
        kb = max_blocks_per_row
    block_idx = np.zeros((nb, kb), np.int32)
    blocks = np.zeros((nb, kb, bs, bs), np.float32)
    nblocks = np.zeros((nb,), np.int32)
    for i, z in enumerate(nz):
        block_idx[i, :len(z)] = z
        blocks[i, :len(z)] = tiles[i, z]
        nblocks[i] = len(z)
    return block_idx, blocks, nblocks


def bcsr_from_dense(A, block_size: int = 128,
                    max_blocks_per_row: tp.Optional[int] = None) -> BCSR:
    """Build the blocked-ELL layout from a dense ``(n, n)`` matrix (host)."""
    A = np.asarray(A)
    block_idx, blocks, nblocks = _np_bcsr_from_dense(A, block_size, max_blocks_per_row)
    return BCSR(torch.from_numpy(block_idx), torch.from_numpy(blocks), A.shape[0],
                torch.from_numpy(nblocks))


def bcsr_to_dense(b: BCSR) -> torch.Tensor:
    """The represented ``(n, n)`` matrix (unbatched)."""
    bs, nb, kb = b.block_size, b.nb, b.kb
    out = b.blocks.new_zeros(nb, nb, bs, bs)
    rows = torch.arange(nb, device=b.blocks.device).repeat_interleave(kb)
    cols = b.block_idx.reshape(-1).long()
    out = out.index_put((rows, cols), b.blocks.reshape(-1, bs, bs), accumulate=True)
    return out.permute(0, 2, 1, 3).reshape(nb * bs, nb * bs)[:b.n, :b.n]


def bcsr_transpose(b: BCSR) -> BCSR:
    """Transposed layout (host-side rebuild; padded blocks are all-zero)."""
    dense = bcsr_to_dense(b).detach().cpu().numpy()
    return bcsr_from_dense(dense.T.copy(), b.block_size, None)


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the reference the kernels are held to)
# ---------------------------------------------------------------------------


def _pad_rows(M, rows: int):
    if M.shape[-2] == rows:
        return M
    return torch.cat([M, M.new_zeros(M.shape[:-2] + (rows - M.shape[-2], M.shape[-1]))], -2)


def _row_blocks(M, nb: int, bs: int):
    """``M (..., n, H)`` zero-padded to ``nb * bs`` rows, as ``(..., nb, bs, H)``."""
    Mp = _pad_rows(M, nb * bs)
    return Mp.reshape(Mp.shape[:-2] + (nb, bs, Mp.shape[-1]))


def bcsr_spmm_plain(b: BCSR, M: torch.Tensor) -> torch.Tensor:
    """K8's plain version: gather M's row blocks, batched block products."""
    bs, nb = b.block_size, b.nb
    g = take_rows(_row_blocks(M, nb, bs), b.block_idx, M.dim() == 3,
                  b.block_idx.dim() == 3)  # (..., nb, kb, bs, H)
    out = torch.einsum("...rkab,...rkbh->...rah", b.blocks.to(F32), g.to(F32))
    return out.reshape(out.shape[:-3] + (nb * bs, out.shape[-1]))[..., :M.shape[-2], :]


def bcsr_sddmm_plain(block_idx, X, Y, block_size: int) -> torch.Tensor:
    """K9's plain version: ``blocks[r, k] = X_r @ Y_{idx[r, k]}^T``."""
    nb = block_idx.shape[-2]
    Xp = _row_blocks(X, nb, block_size)
    Yg = take_rows(_row_blocks(Y, nb, block_size), block_idx, Y.dim() == 3,
                   block_idx.dim() == 3)
    return torch.einsum("...rah,...rkbh->...rkab", Xp.to(F32), Yg.to(F32))


# ---------------------------------------------------------------------------
# K8 / K9 wrappers
# ---------------------------------------------------------------------------

_P, _L, _I = _build.P, _build.L, _build.I
_ARGTYPES = {"gncde_bcsr_spmm": [_P, _L, _P, _L, _P, _L, _P] + [_I] * 7 + [_P],
             "gncde_bcsr_sddmm": [_P, _L, _P, _L, _P, _L, _P] + [_I] * 6 + [_P]}


def _fn(name: str):
    fn = getattr(_build.load("bcsr"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


#: K8's ring stages (``csrc/bcsr.cu`` NSTAGE).
SPMM_STAGES = 3


class SpmmPlan(tp.NamedTuple):
    """K8's launch plan: ``rb`` rows of a block row per CTA (the one figure
    the kernel takes), ``hc`` columns of H per CTA (the kernel derives it
    from H), the grid's CTAs and each CTA's dynamic shared memory."""

    rb: int
    hc: int
    ctas: int
    smem_bytes: int


def spmm_plan(B: int, nb: int, bs: int, H: int) -> SpmmPlan:
    """The strip height ``rb`` in {32, 16, 8}: the largest whose grid (one
    CTA per element, strip of a block row and column chunk) still fills the
    card's SMs (``_build.SMS``), else 8; columns in chunks of 16 for H <= 16,
    else 32. Shared memory: three stages of the strip's block rows and the
    gathered M tile (``csrc/bcsr.cu`` ``spmm_stage_floats``)."""
    hc = 16 if H <= 16 else 32
    chunks = _cdiv(H, hc)
    for rb in (32, 16, 8):
        if rb <= max(8, bs) and B * nb * chunks * _cdiv(bs, rb) >= _build.SMS:
            break
    bsr = _cdiv(bs, 4) * 4
    smem = SPMM_STAGES * (rb * (bsr + 4) + bsr * hc) * 4
    return SpmmPlan(rb, hc, B * nb * chunks * _cdiv(bs, rb), smem)


def _check(what, block_idx, bs, tensors, n):
    """Raise on operands the kernels do not take."""
    if not 1 <= bs <= MAX_BS:
        raise ValueError(f"{what}: block size {bs} outside [1, {MAX_BS}]")
    if block_idx.dtype != torch.int32:
        raise ValueError(f"{what}: block_idx must be int32, got {block_idx.dtype}")
    for x in tensors:
        if x.dtype != F32:
            raise ValueError(f"{what}: operands must be float32, got {x.dtype}")
        if x.device != block_idx.device:
            raise ValueError(f"{what}: operands must be on one CUDA device")
    nb = block_idx.shape[-2]
    if nb * bs < n:
        raise ValueError(f"{what}: nb={nb} blocks of {bs} do not cover n={n}")


def bcsr_spmm(b: BCSR, M: torch.Tensor) -> torch.Tensor:
    """K8: ``A @ M`` for ``M (..., n, H)``; the Hopper kernel on CUDA
    tensors, the plain version on CPU ones."""
    if not M.is_cuda:
        return bcsr_spmm_plain(b, M)
    bs, nb, kb = b.block_size, b.nb, b.kb
    n, H = M.shape[-2:]
    B = batch_of((b.block_idx, 2), (b.blocks, 4), (M, 2))
    _check("K8", b.block_idx, bs, (b.blocks, M), n)
    if b.blocks.shape[-4:] != (nb, kb, bs, bs):
        raise ValueError(f"K8: blocks {tuple(b.blocks.shape)} do not match block_idx "
                         f"{tuple(b.block_idx.shape)}")
    Bk = B or 1
    idx, idx_bs = operand(b.block_idx, 2, Bk)
    blk, blk_bs = operand(b.blocks, 4, Bk)
    Mc, m_bs = operand(M, 2, Bk)
    out = torch.empty((Bk, n, H), device=M.device, dtype=F32)
    plan = spmm_plan(Bk, nb, bs, H)
    err = _fn("gncde_bcsr_spmm")(
        _build.ptr(idx), idx_bs, _build.ptr(blk), blk_bs, _build.ptr(Mc), m_bs,
        _build.ptr(out), Bk, nb, kb, bs, n, H, plan.rb, _build.stream())
    _build.check(err, "K8 bcsr_spmm")
    bcsr_spmm.launches += 1
    return out if B is not None else out[0]


def bcsr_sddmm(block_idx, X, Y, block_size: int) -> torch.Tensor:
    """K9: sampled ``X @ Y^T`` at a blocked-ELL pattern, ``(..., nb, kb, bs,
    bs)``: the gradient of :func:`bcsr_spmm` with respect to ``blocks``
    (cotangent in X's slot, M in Y's)."""
    if not X.is_cuda:
        return bcsr_sddmm_plain(block_idx, X, Y, block_size)
    bs = block_size
    nb, kb = block_idx.shape[-2:]
    n, H = X.shape[-2:]
    B = batch_of((block_idx, 2), (X, 2), (Y, 2))
    _check("K9", block_idx, bs, (X, Y), n)
    if Y.shape[-2:] != (n, H):
        raise ValueError(f"K9: X {tuple(X.shape)} and Y {tuple(Y.shape)} differ")
    Bk = B or 1
    idx, idx_bs = operand(block_idx, 2, Bk)
    Xc, x_bs = operand(X, 2, Bk)
    Yc, y_bs = operand(Y, 2, Bk)
    out = torch.empty((Bk, nb, kb, bs, bs), device=X.device, dtype=F32)
    err = _fn("gncde_bcsr_sddmm")(
        _build.ptr(idx), idx_bs, _build.ptr(Xc), x_bs, _build.ptr(Yc), y_bs,
        _build.ptr(out), Bk, nb, kb, bs, n, H, _build.stream())
    _build.check(err, "K9 bcsr_sddmm")
    bcsr_sddmm.launches += 1
    return out if B is not None else out[0]


for _f in (bcsr_spmm, bcsr_sddmm):
    _f.launches = 0


class BCSRSpMMGrad(torch.autograd.Function):
    """Differentiable ``A @ M`` with an explicit transposed layout. Inputs
    ``(blocks, M, block_idx, blocks_T, block_idx_T, valid, n)``; only
    ``blocks`` and ``M`` get gradients: ``blocks_T`` gets zero by design
    (the adjacency values are data; see :func:`bcsr_spmm_grad`)."""

    @staticmethod
    def forward(ctx, blocks, M, block_idx, blocks_T, block_idx_T, valid, n):
        ctx.save_for_backward(blocks, M, block_idx, blocks_T, block_idx_T, valid)
        ctx.n = n
        return bcsr_spmm(BCSR(block_idx, blocks, n), M)

    @staticmethod
    def backward(ctx, G):
        blocks, M, block_idx, blocks_T, block_idx_T, valid = ctx.saved_tensors
        d_blocks = d_M = None
        if ctx.needs_input_grad[0]:
            d = bcsr_sddmm(block_idx, G, M, blocks.shape[-1])
            d_blocks = sum_to(d * valid[..., None, None], blocks.shape).to(blocks.dtype)
        if ctx.needs_input_grad[1]:
            d_M = sum_to(bcsr_spmm(BCSR(block_idx_T, blocks_T, ctx.n), G), M.shape)
            d_M = d_M.to(M.dtype)
        return d_blocks, d_M, None, None, None, None, None


def bcsr_spmm_grad(blocks, block_idx, blocks_T, block_idx_T, valid, M, n: int):
    """Differentiable ``A @ M`` (JAX ``bcsr_spmm_grad``): d/dM = A^T G rides
    K8 on the transposed layout; d/dblocks = K9(G, M) at A's pattern with
    ``valid`` (the :func:`slot_mask` of the forward layout) zeroing padded
    slots, whose block_idx is 0: unmasked, K9 would deposit ``G_i M_0^T``
    there and an optimiser would corrupt the forward. ``blocks_T`` gets ZERO
    gradient by design (the values are data in every control-path use)."""
    return BCSRSpMMGrad.apply(blocks, M, block_idx, blocks_T, block_idx_T, valid, n)


# ---------------------------------------------------------------------------
# Model-path consumer: BCSR-valued adjacency controls
# ---------------------------------------------------------------------------


class BCSRLayout:
    """The static pattern shared by every plane of a BCSR control path: the
    forward and transposed blocked-ELL patterns (built once on the host) and
    the per-block-row diagonal slot (``kb`` where absent)."""

    def __init__(self, block_idx, nblocks, block_idx_T, nblocks_T, diag_slot,
                 n: int, bs: int):
        self.block_idx = block_idx
        self.nblocks = nblocks
        self.block_idx_T = block_idx_T
        self.nblocks_T = nblocks_T
        self.diag_slot = diag_slot
        self.n = n
        self.bs = bs
        self._valid = self._valid_T = None

    @property
    def valid(self) -> torch.Tensor:
        if self._valid is None:
            self._valid = slot_mask(self.block_idx, self.nblocks)
        return self._valid

    @property
    def valid_T(self) -> torch.Tensor:
        if self._valid_T is None:
            self._valid_T = slot_mask(self.block_idx_T, self.nblocks_T)
        return self._valid_T

    def tensors(self):
        return (self.block_idx, self.nblocks, self.block_idx_T, self.nblocks_T,
                self.diag_slot)

    def to(self, device) -> "BCSRLayout":
        return BCSRLayout(*(x.to(device) for x in self.tensors()), self.n, self.bs)


class BCSRVal:
    """A BCSR-valued matrix A(t) (or dA/dt) from a BCSR control path:
    forward-layout and transposed-layout blocks at one :class:`BCSRLayout`.
    The fusion layers dispatch on this type."""

    def __init__(self, blocks, blocks_T, layout: BCSRLayout):
        self.blocks = blocks
        self.blocks_T = blocks_T
        self.layout = layout

    def combine(self, other: "BCSRVal", ca, cb) -> "BCSRVal":
        return BCSRVal(ca * self.blocks + cb * other.blocks,
                       ca * self.blocks_T + cb * other.blocks_T, self.layout)


def bcsr_pattern_from_mask(mask: np.ndarray, block_size: int):
    """(block_idx, nblocks) numpy of the blocked-ELL pattern covering ``mask``."""
    block_idx, _, nblocks = _np_bcsr_from_dense(np.asarray(mask).astype(np.float32),
                                                block_size)
    return block_idx, nblocks


def bcsr_gather_blocks(plane, block_idx: np.ndarray, nblocks: np.ndarray,
                       bs: int) -> np.ndarray:
    """``plane``'s ``(bs, bs)`` tiles at a blocked-ELL pattern (host side;
    padding slots zero). ``plane`` may carry leading axes."""
    plane = np.asarray(plane)
    n = plane.shape[-1]
    nb, kb = block_idx.shape
    lead = plane.shape[:-2]
    padded = np.zeros(lead + (nb * bs, nb * bs), plane.dtype)
    padded[..., :n, :n] = plane
    tiles = np.moveaxis(padded.reshape(lead + (nb, bs, nb, bs)), -2, -3)
    rows = np.arange(nb)[:, None]
    out = tiles[..., rows, block_idx, :, :]  # (..., nb, kb, bs, bs)
    invalid = np.arange(kb)[None, :] >= nblocks[:, None]
    out[..., invalid, :, :] = 0.0
    return out


def bcsr_diag_slots(block_idx: np.ndarray, nblocks: np.ndarray) -> np.ndarray:
    """Per-block-row slot holding the diagonal block (kb where absent)."""
    nb, kb = block_idx.shape
    slots = np.full((nb,), kb, np.int32)
    for i in range(nb):
        hits = np.nonzero(block_idx[i, :nblocks[i]] == i)[0]
        if len(hits):
            slots[i] = hits[0]
    return slots


def bcsr_row_sums(blocks, n: int) -> torch.Tensor:
    """Row sums of the represented matrix, ``(..., n)`` (padding blocks are
    zero, so a plain reduction over slots and block columns is exact)."""
    rs = blocks.to(F32).sum((-3, -1))  # (..., nb, bs)
    return rs.reshape(rs.shape[:-2] + (-1,))[..., :n]


def bcsr_diag(blocks, diag_slot, n: int) -> torch.Tensor:
    """Diagonal of the represented matrix via the precomputed slot index."""
    nb, kb = blocks.shape[-4:-2]
    safe = diag_slot.long().clamp(max=kb - 1)
    rows = torch.arange(nb, device=blocks.device)
    if blocks.dim() == 5:
        ar = torch.arange(blocks.shape[0], device=blocks.device)[:, None]
        dblocks = blocks[ar, rows, safe.expand(blocks.shape[0], nb)]
    else:
        dblocks = blocks[rows, safe]
    dvals = torch.diagonal(dblocks, dim1=-2, dim2=-1).to(F32)  # (..., nb, bs)
    dvals = torch.where((diag_slot < kb).unsqueeze(-1), dvals, torch.zeros_like(dvals))
    return dvals.reshape(dvals.shape[:-2] + (-1,))[..., :n]


def _bcsr_apply_pair(val: BCSRVal, M, transpose: bool):
    """Differentiable SpMM of a combined BCSRVal (or its transpose) with M."""
    lay = val.layout
    if transpose:
        return bcsr_spmm_grad(val.blocks_T, lay.block_idx_T, val.blocks, lay.block_idx,
                              lay.valid_T, M, lay.n)
    return bcsr_spmm_grad(val.blocks, lay.block_idx, val.blocks_T, lay.block_idx_T,
                          lay.valid, M, lay.n)


def bcsr_fused_apply(bA: BCSRVal, bdA: BCSRVal, M, params,
                     add_identity: bool = False) -> torch.Tensor:
    """Undirected 8-term fused basis apply over BCSR values: the blocked
    mirror of :func:`~gncde_tpu_torch.ops.sparse.sparse_fused_apply`. A and
    dA share one layout, so each basis pair combines VALUES first: one K8
    for the identity pair and one K8 on the transposed layout for the
    transpose pair."""
    p1, p2, p3, p4, p5, p6, p7, p8 = params
    lay = bA.layout
    n = lay.n
    rA, rdA = bcsr_row_sums(bA.blocks, n), bcsr_row_sums(bdA.blocks, n)
    sA, sdA = rA.sum(-1), rdA.sum(-1)

    rowpart = _bcsr_apply_pair(bA.combine(bdA, 1.0 + p1[0], 1.0 + p1[1]), M,
                               transpose=False)
    colpart = _bcsr_apply_pair(bA.combine(bdA, p2[0], p2[1]), M, transpose=True)

    dvec = (
        p3[0] * bcsr_diag(bA.blocks, lay.diag_slot, n)
        + p3[1] * bcsr_diag(bdA.blocks, lay.diag_slot, n)
        + (p6[0] * rA + p6[1] * rdA) / n
        + ((p8[0] * sA + p8[1] * sdA) / n**2)[..., None]
    )
    if add_identity:
        dvec = dvec + 1.0
    return _rank_terms(rowpart + colpart, dvec, rA, rdA, sA, M, (p4, p5, p7), n)


def bcsr_fused_apply_directed(bA: BCSRVal, bdA: BCSRVal, M, params,
                              add_identity: bool = False) -> torch.Tensor:
    """Directed 11-term fused basis apply over BCSR values: the blocked
    mirror of :func:`~gncde_tpu_torch.ops.sparse.sparse_fused_apply_directed`.
    The pairs as in :func:`bcsr_fused_apply`; the column sums are the row
    sums of the transposed-layout blocks (JAX ``bcsr.py:755-758``)."""
    p1, p2 = params[0], params[1]
    lay = bA.layout
    n = lay.n
    rA, rdA = bcsr_row_sums(bA.blocks, n), bcsr_row_sums(bdA.blocks, n)
    dvec, u, v, c7 = directed_rank_terms(
        params, n, rA, rdA, bcsr_row_sums(bA.blocks_T, n), bcsr_row_sums(bdA.blocks_T, n),
        bcsr_diag(bA.blocks, lay.diag_slot, n), bcsr_diag(bdA.blocks, lay.diag_slot, n),
        rA.sum(-1), rdA.sum(-1))
    rowpart = _bcsr_apply_pair(bA.combine(bdA, 1.0 + p1[0], 1.0 + p1[1]), M,
                               transpose=False)
    colpart = _bcsr_apply_pair(bA.combine(bdA, p2[0], p2[1]), M, transpose=True)
    if add_identity:
        dvec = dvec + 1.0
    return _uv_terms(rowpart + colpart, dvec, u, v, c7, M)


def blocked_fill_ratio(mask, block_size: int) -> float:
    """nnz over the stored-block capacity of the blocked-ELL layout covering
    ``mask``: the statistic the ``auto`` sparse format routes on."""
    mask = np.asarray(mask).astype(bool)
    n = mask.shape[0]
    bs = block_size
    nb = _cdiv(n, bs)
    padded = np.zeros((nb * bs, nb * bs), bool)
    padded[:n, :n] = mask
    tiles = padded.reshape(nb, bs, nb, bs).transpose(0, 2, 1, 3)
    stored = np.any(tiles, axis=(2, 3)).sum()
    if stored == 0:
        return 0.0
    return float(mask.sum() / (stored * bs * bs))


# ---------------------------------------------------------------------------
# O(nnz) edge-list construction (no n x n object on the host)
# ---------------------------------------------------------------------------


def _edges_block_mark(src, dst, n: int, bs: int) -> np.ndarray:
    """(nb, nb) uint8 touched-block bitmap from an edge list."""
    nb = _cdiv(n, bs)
    mark = np.zeros((nb, nb), np.uint8)
    mark[np.asarray(src) // bs, np.asarray(dst) // bs] = 1
    return mark


def bcsr_pattern_from_edges(src, dst, n: int, block_size: int,
                            max_blocks_per_row: tp.Optional[int] = None):
    """(block_idx, nblocks, slot_lut) of the blocked-ELL pattern covering an
    edge list; ``slot_lut (nb, nb)`` int32 is the slot of each (row block,
    column block), -1 where unstored."""
    bs = block_size
    nb = _cdiv(n, bs)
    mark = _edges_block_mark(src, dst, n, bs)
    counts = mark.sum(axis=1).astype(np.int64)
    kb = int(max(counts.max() if nb else 1, 1))
    if max_blocks_per_row is not None:
        if kb > max_blocks_per_row:
            raise ValueError("max_blocks_per_row too small for this pattern")
        kb = max_blocks_per_row
    block_idx = np.zeros((nb, kb), np.int32)
    nblocks = counts.astype(np.int32)
    slot_lut = np.full((nb, nb), -1, np.int32)
    for rb in range(nb):
        cols = np.nonzero(mark[rb])[0]
        block_idx[rb, :len(cols)] = cols
        slot_lut[rb, cols] = np.arange(len(cols), dtype=np.int32)
    return block_idx, nblocks, slot_lut


def bcsr_values_from_edges(src, dst, w, n: int, block_size: int, kb: int,
                           slot_lut: np.ndarray) -> np.ndarray:
    """(nb, kb, bs, bs) tile values at a fixed pattern, O(nnz); duplicate
    edges accumulate."""
    bs = block_size
    nb = _cdiv(n, bs)
    blocks = np.zeros((nb, kb, bs, bs), np.float32)
    src, dst = np.asarray(src), np.asarray(dst)
    wf = np.ones(len(src), np.float32) if w is None else np.asarray(w, np.float32)
    slots = slot_lut[src // bs, dst // bs]
    ok = slots >= 0
    np.add.at(blocks, (src[ok] // bs, slots[ok], src[ok] % bs, dst[ok] % bs), wf[ok])
    return blocks


def bcsr_from_edges(src, dst, w, n: int, block_size: int = 128) -> BCSR:
    """Edge list -> BCSR without an (n, n) matrix: equal to
    ``bcsr_from_dense`` of the summed dense adjacency."""
    block_idx, nblocks, slot_lut = bcsr_pattern_from_edges(src, dst, n, block_size)
    blocks = bcsr_values_from_edges(src, dst, w, n, block_size, block_idx.shape[1], slot_lut)
    return BCSR(torch.from_numpy(block_idx), torch.from_numpy(blocks), n,
                torch.from_numpy(nblocks))
