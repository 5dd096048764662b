"""Block-sparse (BCSR) control paths: the blocked mirror of ``sparse_paths``.

Counterpart of ``gncde_tpu/interp/bcsr_paths.py``. For banded or clustered
adjacency the Hermite coefficient planes are stored as blocked-ELL tiles at
the union block pattern (exact, as for ELL: interpolation is entrywise), in
both the forward and the transposed layout, built once on the host.
``adj(t)`` / ``dadj(t)`` return :class:`~gncde_tpu_torch.ops.bcsr.BCSRVal`
values, which the fusion layers dispatch to ``bcsr_fused_apply`` (K8, K9).

Batch-first: a control built from batched coefficients holds ``ts (B, T)``,
a layout with ``block_idx (B, nb, kb)`` (each element's pattern widened to
the batch's largest slot counts; padding slots hold block 0 and zero tiles)
and tiles ``(B, T-1, nb, kb, bs, bs)``.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from ..ops.bcsr import (
    BCSRLayout,
    BCSRVal,
    bcsr_diag_slots,
    bcsr_gather_blocks,
    bcsr_pattern_from_edges,
    bcsr_pattern_from_mask,
    bcsr_values_from_edges,
    blocked_fill_ratio,
)
from .paths import _bcast, backward_hermite_coefficients
from .sparse_paths import (
    _value_planes,
    interval_at,
    stacked,
    take_interval,
    to_numpy,
    union_mask,
)


def _pad_slots(block_idx: np.ndarray, nblocks: np.ndarray, kb: int):
    """Widen a pattern to ``kb`` slots (zero padding; shared-width batching)."""
    nb, k0 = block_idx.shape
    if k0 == kb:
        return block_idx, nblocks
    out = np.zeros((nb, kb), np.int32)
    out[:, :k0] = block_idx
    return out, nblocks


def _patterns(planes: tp.Sequence[np.ndarray], block_size: int):
    """``((block_idx, nblocks), (block_idx_T, nblocks_T))`` of the union
    block pattern over every plane and time."""
    mask = union_mask(planes)
    return (bcsr_pattern_from_mask(mask, block_size),
            bcsr_pattern_from_mask(mask.T, block_size))


def _build_layout(planes, block_size: int, kb=None, kb_T=None, pats=None):
    """numpy ``(block_idx, nblocks, block_idx_T, nblocks_T, diag_slot)`` of
    the union pattern, slot counts optionally widened to ``kb`` / ``kb_T``."""
    if pats is None:
        pats = _patterns(planes, block_size)
    (block_idx, nblocks), (block_idx_T, nblocks_T) = pats
    if kb is not None:
        block_idx, nblocks = _pad_slots(block_idx, nblocks, kb)
    if kb_T is not None:
        block_idx_T, nblocks_T = _pad_slots(block_idx_T, nblocks_T, kb_T)
    return (block_idx, nblocks, block_idx_T, nblocks_T,
            bcsr_diag_slots(block_idx, nblocks))


def _layout(arrays, n: int, bs: int) -> BCSRLayout:
    return BCSRLayout(*(torch.as_tensor(a) for a in arrays), n, bs)


class BCSRCubicMatrixPath:
    """Hermite-cubic path over blocked values: planes ``(d, c, b, a)``, each
    ``([B,] T-1, nb, kb, bs, bs)``, in both layouts."""

    def __init__(self, ts, coeffs, coeffs_T, layout: BCSRLayout):
        self.ts = ts
        self.coeffs = tuple(coeffs)
        self.coeffs_T = tuple(coeffs_T)
        self.layout = layout

    @property
    def batched(self) -> bool:
        return self.ts.dim() == 2

    def to(self, device) -> "BCSRCubicMatrixPath":
        return BCSRCubicMatrixPath(self.ts.to(device), [c.to(device) for c in self.coeffs],
                                   [c.to(device) for c in self.coeffs_T],
                                   self.layout.to(device))

    def _at(self, t):
        i, t0, _ = interval_at(self.ts, t)
        take = [take_interval(c, i, self.batched) for c in self.coeffs]
        take_T = [take_interval(c, i, self.batched) for c in self.coeffs_T]
        return _bcast(t - t0, take[0]), take, take_T

    def evaluate(self, t) -> BCSRVal:
        tau, (d, c, b, a), (dT, cT, bT, aT) = self._at(t)
        return BCSRVal(((d * tau + c) * tau + b) * tau + a,
                       ((dT * tau + cT) * tau + bT) * tau + aT, self.layout)

    def derivative(self, t) -> BCSRVal:
        tau, (d, c, b, _), (dT, cT, bT, _) = self._at(t)
        return BCSRVal((3.0 * d * tau + 2.0 * c) * tau + b,
                       (3.0 * dT * tau + 2.0 * cT) * tau + bT, self.layout)


class BCSRLinearMatrixPath:
    """Piecewise-linear path over blocked values: knots
    ``([B,] T, nb, kb, bs, bs)`` in both layouts."""

    def __init__(self, ts, knots, knots_T, layout: BCSRLayout):
        self.ts = ts
        self.knots = knots
        self.knots_T = knots_T
        self.layout = layout

    @property
    def batched(self) -> bool:
        return self.ts.dim() == 2

    def to(self, device) -> "BCSRLinearMatrixPath":
        return BCSRLinearMatrixPath(self.ts.to(device), self.knots.to(device),
                                    self.knots_T.to(device), self.layout.to(device))

    def _at(self, t):
        i, t0, t1 = interval_at(self.ts, t)
        ends = [take_interval(k, j, self.batched)
                for k in (self.knots, self.knots_T) for j in (i, i + 1)]
        dt = _bcast(t1 - t0, ends[0])
        return _bcast(t - t0, ends[0]) / dt, dt, ends

    def evaluate(self, t) -> BCSRVal:
        tau, _, (k0, k1, kT0, kT1) = self._at(t)
        return BCSRVal((1 - tau) * k0 + tau * k1, (1 - tau) * kT0 + tau * kT1, self.layout)

    def derivative(self, t) -> BCSRVal:
        _, dt, (k0, k1, kT0, kT1) = self._at(t)
        return BCSRVal((k1 - k0) / dt, (kT1 - kT0) / dt, self.layout)


class BCSRMatrixControl:
    """The contract of :class:`~gncde_tpu_torch.interp.MatrixControl` with
    BCSRVal values; ``tgrad_is_unit`` is True."""

    tgrad_is_unit = True

    def __init__(self, path):
        self.path = path

    def to(self, device) -> "BCSRMatrixControl":
        return BCSRMatrixControl(self.path.to(device))

    @classmethod
    def from_knots(cls, ts, A_path, interpolation: str = "cubic",
                   block_size: int = 128) -> "BCSRMatrixControl":
        """From dense ``(T, n, n)`` adjacency knots (host side)."""
        ts = torch.as_tensor(to_numpy(ts))
        if interpolation == "linear":
            return cls._build_one_linear(ts, to_numpy(A_path), block_size, None, None)
        coeffs = backward_hermite_coefficients(ts, torch.as_tensor(to_numpy(A_path)))
        return cls._build_one(ts, [c.numpy() for c in coeffs], block_size, None, None)

    @classmethod
    def from_stacked(cls, interpolation: str, ts, coeffs,
                     block_size: int = 128) -> "BCSRMatrixControl":
        """From reference-layout stacked ``[time, value]`` dense coefficients:
        each Hermite plane (or the knots) gathered at the union block
        pattern, exact at every queried t. Batched coefficients (value planes
        ``(B, T[-1], n, n)``) give per-element patterns widened to one shared
        slot count."""
        ts = torch.as_tensor(to_numpy(ts))
        planes = _value_planes(interpolation, coeffs)
        batched = planes[0].ndim == 4
        if interpolation == "linear":
            if batched:
                return cls._build_batched(ts, planes, block_size, cubic=False)
            return cls._build_one_linear(ts, planes[0], block_size, None, None)
        if batched:
            return cls._build_batched(ts, planes, block_size, cubic=True)
        return cls._build_one(ts, planes, block_size, None, None)

    @classmethod
    def _build_batched(cls, ts, planes, block_size: int, cubic: bool):
        """Per-element patterns computed once, widened to the batch's largest
        ``kb`` / ``kb_T``, and the elements stacked on axis 0. ``cubic``
        picks the layout explicitly (the JAX package once compared bound
        classmethods with ``is``, which is always False, and sent every
        batched cubic build down the linear branch)."""
        B = planes[0].shape[0]
        pats = [_patterns([p[b] for p in planes], block_size) for b in range(B)]
        kb = max(p[0][0].shape[1] for p in pats)
        kb_T = max(p[1][0].shape[1] for p in pats)
        elems = []
        for b in range(B):
            ts_b = ts[b] if ts.dim() == 2 else ts
            if cubic:
                elems.append(cls._build_one(ts_b, [p[b] for p in planes], block_size,
                                            kb, kb_T, pats=pats[b]).path)
            else:
                elems.append(cls._build_one_linear(ts_b, planes[0][b], block_size, kb,
                                                   kb_T, pats=pats[b]).path)
        lay0 = elems[0].layout
        layout = BCSRLayout(*(stacked(getattr(e.layout, f) for e in elems) for f in
                              ("block_idx", "nblocks", "block_idx_T", "nblocks_T",
                               "diag_slot")), lay0.n, lay0.bs)
        ts_b = stacked(e.ts for e in elems)
        if cubic:
            return cls(BCSRCubicMatrixPath(
                ts_b, [stacked(e.coeffs[j] for e in elems) for j in range(4)],
                [stacked(e.coeffs_T[j] for e in elems) for j in range(4)], layout))
        return cls(BCSRLinearMatrixPath(ts_b, stacked(e.knots for e in elems),
                                        stacked(e.knots_T for e in elems), layout))

    @staticmethod
    def _gathered(plane, arrays, bs):
        bi, nb_, biT, nbT, _ = arrays
        return (torch.from_numpy(bcsr_gather_blocks(plane, bi, nb_, bs)),
                torch.from_numpy(bcsr_gather_blocks(np.swapaxes(plane, -1, -2), biT, nbT,
                                                    bs)))

    @classmethod
    def _build_one(cls, ts, planes, block_size, kb, kb_T, pats=None):
        arrays = _build_layout(planes, block_size, kb, kb_T, pats)
        pairs = [cls._gathered(p, arrays, block_size) for p in planes]
        layout = _layout(arrays, planes[0].shape[-1], block_size)
        return cls(BCSRCubicMatrixPath(ts, [f for f, _ in pairs], [t for _, t in pairs],
                                       layout))

    @classmethod
    def _build_one_linear(cls, ts, knots_plane, block_size, kb, kb_T, pats=None):
        arrays = _build_layout([knots_plane], block_size, kb, kb_T, pats)
        knots, knots_T = cls._gathered(knots_plane, arrays, block_size)
        layout = _layout(arrays, knots_plane.shape[-1], block_size)
        return cls(BCSRLinearMatrixPath(ts, knots, knots_T, layout))

    def adj(self, t) -> BCSRVal:
        return self.path.evaluate(t)

    def dadj(self, t) -> BCSRVal:
        return self.path.derivative(t)

    evaluate = adj
    derivative = dadj


def build_sparse_control(interpolation: str, ts, coeffs, sparse_format: str = "ell",
                         max_degree: tp.Optional[int] = None, block_size: int = 128):
    """Route dense stacked coefficients to a sparse control.

    ``sparse_format``: ``"ell"`` (element-sparse, the default), ``"bcsr"``
    (blocked-ELL, K8/K9) or ``"auto"``: BCSR when the union pattern keeps
    its stored tiles usefully full (``blocked_fill_ratio >= 0.1``) on a
    graph of ``n >= 2048``, decided on element 0 of a batch. The threshold
    is the JAX package's, chosen on the TPU; one for the H100 is open
    (ROADMAP).
    """
    from .sparse_paths import SparseMatrixControl

    if sparse_format not in ("ell", "bcsr", "auto"):
        raise ValueError(f"sparse_format must be ell, bcsr or auto; got {sparse_format!r}")
    if sparse_format == "auto":
        # Decide on the union-over-planes mask the layout uses: a cubic d
        # plane alone is zero wherever an edge weight is constant in time.
        planes = _value_planes(interpolation, coeffs)
        if planes[0].ndim == 4:
            planes = [p[0] for p in planes]
        mask = union_mask(planes)
        ratio = blocked_fill_ratio(mask, block_size)
        sparse_format = "bcsr" if (ratio >= 0.1 and mask.shape[0] >= 2048) else "ell"
    if sparse_format == "bcsr":
        return BCSRMatrixControl.from_stacked(interpolation, ts, coeffs,
                                              block_size=block_size)
    return SparseMatrixControl.from_stacked(interpolation, ts, coeffs,
                                            max_degree=max_degree)


def bcsr_control_from_edge_snapshots(ts, snapshots, n: int, block_size: int = 128,
                                     interpolation: str = "cubic",
                                     dtype=None) -> BCSRMatrixControl:
    """A :class:`BCSRMatrixControl` straight from per-knot edge lists
    (``snapshots``: one ``(src, dst, weights-or-None)`` per knot), O(nnz): no
    ``(n, n)`` object exists on the host or the device. The union block
    pattern comes from the touched-block bitmaps, each knot's tiles are
    scattered at it (and, with src and dst swapped, at the transposed one),
    and the Hermite coefficients are taken over the knot axis of the
    ``(T, nb, kb, bs, bs)`` stacks. ``dtype`` optionally casts the tiles."""
    ts = torch.as_tensor(to_numpy(ts))
    bs = block_size
    all_src = np.concatenate([np.asarray(s[0]) for s in snapshots])
    all_dst = np.concatenate([np.asarray(s[1]) for s in snapshots])
    block_idx, nblocks, lut = bcsr_pattern_from_edges(all_src, all_dst, n, bs)
    block_idx_T, nblocks_T, lut_T = bcsr_pattern_from_edges(all_dst, all_src, n, bs)
    layout = _layout((block_idx, nblocks, block_idx_T, nblocks_T,
                      bcsr_diag_slots(block_idx, nblocks)), n, bs)
    kb, kb_T = block_idx.shape[1], block_idx_T.shape[1]
    knots = torch.from_numpy(np.stack([
        bcsr_values_from_edges(s, d, w, n, bs, kb, lut) for (s, d, w) in snapshots]))
    knots_T = torch.from_numpy(np.stack([
        bcsr_values_from_edges(d, s, w, n, bs, kb_T, lut_T) for (s, d, w) in snapshots]))

    def cast(x):
        return x.to(dtype) if dtype is not None else x

    if interpolation == "linear":
        return BCSRMatrixControl(BCSRLinearMatrixPath(ts, cast(knots), cast(knots_T), layout))
    coeffs = [cast(c) for c in backward_hermite_coefficients(ts, knots)]
    coeffs_T = [cast(c) for c in backward_hermite_coefficients(ts, knots_T)]
    return BCSRMatrixControl(BCSRCubicMatrixPath(ts, coeffs, coeffs_T, layout))
