"""The sparse controls of the port against the JAX package, on the CPU: the
ELL ops and apply (``ops/sparse.py``, K10's plain version), the BCSR ops and
apply (``ops/bcsr.py``, K8's and K9's plain versions), the ELL and BCSR
controls, ``build_sparse_control``'s routing, the edge-list control and the
vector field through both controls. Synced dyn-trainer steps with
``sparse_control`` are in ``tests/test_torch_sparse_trainer.py`` (each
JAX trainer step takes about 20 s to compile on the CPU; apart, the two
files can run on two workers).

Inputs are made with numpy from a seed and handed to both packages; on the
CPU the JAX package's public sparse ops take their XLA reference, which is
the JAX function itself. Tolerances: ops and controls rtol 1e-5, atol 1e-6
(the gathers are exact; only the order of the f32 sums differs); the
vector field and every gradient rtol 1e-4.
"""

import os
import sys

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from gncde_tpu import interp as jinterp
from gncde_tpu.ops import bcsr as jb
from gncde_tpu.ops import sparse as jsp
from gncde_tpu_torch import interp as tinterp
from gncde_tpu_torch.interp import bcsr_paths as tbp
from gncde_tpu_torch.ops import bcsr as tb
from gncde_tpu_torch.ops import ell_spmm as tell
from gncde_tpu_torch.ops import sparse as tsp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_parity_utils import copy_jax_to_torch  # noqa: E402

RT, AT = 1e-5, 1e-6
GRT = 1e-4


def close(got, ref, rtol=RT, atol=AT):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol)


def t32(x):
    return torch.tensor(np.asarray(x, np.float32))


def sparse_matrix(rng, n, density):
    A = np.where(rng.random((n, n)) < density, rng.normal(size=(n, n)), 0.0)
    A[np.arange(0, n, 3), np.arange(0, n, 3)] = 1.5  # some diagonal entries
    return A.astype(np.float32)


def banded(rng, n, bw, lead=()):
    i, j = np.indices((n, n))
    return np.where(np.abs(i - j) <= bw, 0.1 * rng.random(lead + (n, n)), 0.0).astype(
        np.float32)


def params8(rng):
    return [rng.uniform(-1 / 15, 1 / 15, 2).astype(np.float32) for _ in range(8)]


# ---------------------------------------------------------------------------
# (a) ELL ops and the ELL fused apply
# ---------------------------------------------------------------------------


def _ell_pair(rng, n, B):
    """A torch ELL (batched when B) and the per-element JAX ELLs."""
    dense = [sparse_matrix(rng, n, 0.2) for _ in range(B or 1)]
    j_ells = [jsp.ell_from_dense(d) for d in dense]
    K = max(e.max_degree for e in j_ells)
    j_ells = [jsp.ell_from_dense(d, max_degree=K) for d in dense]
    t_ells = [tsp.ell_from_dense(d, max_degree=K) for d in dense]
    if B is None:
        return t_ells[0], j_ells
    indices = torch.stack([e.indices for e in t_ells])
    return tsp.ELL(indices, torch.stack([e.values for e in t_ells]), n,
                   tsp.transpose_pattern(indices, n)), j_ells


@pytest.mark.parametrize("B", [None, 3], ids=["unbatched", "batched"])
def test_ell_ops_match_jax(B):
    rng = np.random.default_rng(0)
    n, H = 13, 5
    ell, j_ells = _ell_pair(rng, n, B)
    M = rng.normal(size=(B or 1, n, H)).astype(np.float32)
    X = rng.normal(size=(B or 1, n, H)).astype(np.float32)
    Mt, Xt = (t32(M), t32(X)) if B else (t32(M[0]), t32(X[0]))
    got = {
        # A^T M: the gather SpMM on the transposed pattern (K10's plain
        # version here).
        "spmm": tsp.ell_spmm(ell, Mt), "spmm_t": tsp.ell_spmm_t(ell, Mt),
        "sddmm": tsp.ell_sddmm(ell.indices, Xt, Mt), "rows": tsp.ell_row_sums(ell),
        "cols": tsp.ell_col_sums(ell), "diag": tsp.ell_diag(ell),
    }
    for b, je in enumerate(j_ells):
        ref = {
            "spmm": jsp.ell_spmm(je, M[b]), "spmm_t": jsp.ell_spmm_t(je, M[b]),
            "sddmm": jsp.ell_sddmm(je.indices, X[b], M[b]), "rows": jsp.ell_row_sums(je),
            "cols": jsp.ell_col_sums(je), "diag": jsp.ell_diag(je),
        }
        for k, v in got.items():
            close(v[b] if B else v, ref[k])
        np.testing.assert_array_equal((ell.indices[b] if B else ell.indices).numpy(),
                                      np.asarray(je.indices))


def test_kernel_operands_are_read_off_their_strides():
    """The K8-K10 wrappers hand each operand over as ``(tensor, batch
    stride)`` without a copy where its inner dims are contiguous: a shared
    operand (unbatched, or an ``expand`` view) gets batch stride 0, a
    batched one its own, a batch of one 0; only an operand whose inner dims
    are not contiguous is copied (2-d cores as K10's, a 4-d one as K8's
    blocks)."""
    op = tell.operand
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    assert op(x, 2, 2) == (x, 12)
    assert op(x[:1], 2, 1)[1] == 0
    shared = x[0].expand(5, 3, 4)
    got, bs = op(shared, 2, 5)
    assert bs == 0 and got.data_ptr() == shared.data_ptr()
    got, bs = op(x[0], 2, 2)
    assert bs == 0 and torch.equal(got, x[0])
    every_other = torch.arange(48, dtype=torch.float32).reshape(4, 3, 4)[::2]
    got, bs = op(every_other, 2, 2)
    assert got.data_ptr() == every_other.data_ptr() and bs == 24
    cols = x.transpose(1, 2)  # (2, 4, 3) with strided rows: copied
    got, bs = op(cols, 2, 2)
    assert got.is_contiguous() and torch.equal(got, cols) and bs == 12
    blocks = torch.arange(2 * 3 * 2 * 4 * 4, dtype=torch.float32).reshape(2, 3, 2, 4, 4)
    got, bs = op(blocks, 4, 2)
    assert got.data_ptr() == blocks.data_ptr() and bs == 96
    got, bs = op(blocks.transpose(3, 4), 4, 2)
    assert got.is_contiguous() and bs == 96


def test_ell_from_edges_matches_jax():
    rng = np.random.default_rng(1)
    n = 17
    src, dst = rng.integers(0, n, 60), rng.integers(0, n, 60)
    w = rng.uniform(0.1, 1.0, 60).astype(np.float32)
    for K in (None, 2):
        got = tsp.ell_from_edges(src, dst, w, n, K)
        ref = jsp.ell_from_edges(src, dst, w, n, K)
        np.testing.assert_array_equal(got.indices.numpy(), np.asarray(ref.indices))
        close(got.values, ref.values)


def _apply_grads_jax(fn, A, dA, M, params, W):
    """Value and gradients (M, params) of ``sum(fn(A, dA, M, params) * W)``."""
    def loss(M_, ps):
        out = fn(A, dA, M_, ps, add_identity=True)
        return jnp.sum(out * W), out
    (_, out), (gM, gp) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(M), [jnp.asarray(p) for p in params])
    return out, gM, gp


def _apply_grads_torch(fn, A, dA, M, params, W):
    Mt = t32(M).requires_grad_(True)
    ps = [t32(p).requires_grad_(True) for p in params]
    out = fn(A, dA, Mt, ps, add_identity=True)
    (out * t32(W)).sum().backward()
    return out, Mt.grad, [p.grad for p in ps]


def test_sparse_fused_apply_and_grads_match_jax():
    rng = np.random.default_rng(2)
    n, H = 21, 6
    A = sparse_matrix(rng, n, 0.15)
    dA = np.where(A != 0, rng.normal(size=(n, n)), 0.0).astype(np.float32)
    M = rng.normal(size=(n, H)).astype(np.float32)
    W = rng.normal(size=(n, H)).astype(np.float32)
    params = params8(rng)
    jA, jdA = jsp.ell_from_dense(A), jsp.ell_from_dense(dA)
    jdA = jsp.ELL(jA.indices, jdA.values, n)  # one pattern: the combine branch
    tA, tdA = tsp.ell_from_dense(A), tsp.ell_from_dense(dA)
    tdA = tsp.ELL(tA.indices, tdA.values, n, tA.transpose)
    ref = _apply_grads_jax(jsp.sparse_fused_apply, jA, jdA, M, params, W)
    got = _apply_grads_torch(tsp.sparse_fused_apply, tA, tdA, M, params, W)
    close(got[0], ref[0])
    close(got[1], ref[1], rtol=GRT, atol=1e-6)
    for a, b in zip(got[2], ref[2]):
        close(a, b, rtol=GRT, atol=1e-6)


# ---------------------------------------------------------------------------
# (b) BCSR ops and the BCSR fused apply
# ---------------------------------------------------------------------------


def _padded_pattern(rng, n, bs):
    """A banded matrix with one far block, so most block rows have padded slots."""
    A = banded(rng, n, 3)
    A[1, n - 2] = 0.7
    return A


def test_bcsr_from_dense_and_transpose_match_jax():
    rng = np.random.default_rng(3)
    n, bs = 22, 4
    A = _padded_pattern(rng, n, bs)
    for got, ref in ((tb.bcsr_from_dense(A, bs), jb.bcsr_from_dense(A, bs)),
                     (tb.bcsr_transpose(tb.bcsr_from_dense(A, bs)),
                      jb.bcsr_transpose(jb.bcsr_from_dense(A, bs)))):
        np.testing.assert_array_equal(got.block_idx.numpy(), np.asarray(ref.block_idx))
        np.testing.assert_array_equal(got.nblocks.numpy(), np.asarray(ref.nblocks))
        close(got.blocks, ref.blocks)
    close(tb.bcsr_to_dense(tb.bcsr_from_dense(A, bs)), A)


@pytest.mark.parametrize("which", ["unbatched", "batched", "shared-matrix"])
def test_bcsr_plain_spmm_sddmm_match_jax(which):
    """K8's and K9's plain versions (what the CPU wrappers run) against the
    JAX XLA references, per element; "shared-matrix" is one unbatched
    matrix against batched features (the zero-stride case on the card)."""
    rng = np.random.default_rng(4)
    n, bs, H, B = 26, 8, 5, 2
    nmat = B if which == "batched" else 1
    mats = [jb.bcsr_from_dense(_padded_pattern(rng, n, bs), bs) for _ in range(nmat)]
    X = rng.normal(size=(B, n, H)).astype(np.float32)
    M = rng.normal(size=(B, n, H)).astype(np.float32)
    if which == "unbatched":
        tm = tb.BCSR(t32(mats[0].block_idx).int(), t32(mats[0].blocks), n)
        got_mm = tb.bcsr_spmm(tm, t32(M[0]))[None]
        got_dd = tb.bcsr_sddmm(tm.block_idx, t32(X[0]), t32(M[0]), bs)[None]
        B = 1
    else:
        stack = (lambda f: torch.stack([f(m) for m in mats])) if nmat > 1 else (
            lambda f: f(mats[0]))
        tm = tb.BCSR(stack(lambda m: t32(m.block_idx).int()), stack(lambda m: t32(m.blocks)), n)
        got_mm = tb.bcsr_spmm(tm, t32(M))
        got_dd = tb.bcsr_sddmm(tm.block_idx, t32(X), t32(M), bs)
    for b in range(B):
        jm = mats[b if nmat > 1 else 0]
        close(got_mm[b], jb.bcsr_spmm_xla(jm, M[b]))
        close(got_dd[b], jb.bcsr_sddmm_xla(jm.block_idx, X[b], M[b], bs))


def test_bcsr_spmm_grad_matches_jax_and_zeroes_padded_slots():
    rng = np.random.default_rng(5)
    n, bs, H = 22, 4, 3
    A = _padded_pattern(rng, n, bs)
    jf, jt = jb.bcsr_from_dense(A, bs), jb.bcsr_transpose(jb.bcsr_from_dense(A, bs))
    valid = jb.slot_mask(jf.block_idx, jf.nblocks)
    assert float(valid.min()) == 0.0  # the pattern has padded slots
    M = rng.normal(size=(n, H)).astype(np.float32)
    W = rng.normal(size=(n, H)).astype(np.float32)

    def jloss(blocks, M_):
        out = jb.bcsr_spmm_grad(blocks, jf.block_idx, jt.blocks, jt.block_idx, valid, M_, n)
        return jnp.sum(out * W)
    gb_ref, gM_ref = jax.grad(jloss, argnums=(0, 1))(jf.blocks, jnp.asarray(M))

    tf, tt = tb.bcsr_from_dense(A, bs), tb.bcsr_transpose(tb.bcsr_from_dense(A, bs))
    blocks = tf.blocks.clone().requires_grad_(True)
    blocks_T = tt.blocks.clone().requires_grad_(True)
    Mt = t32(M).requires_grad_(True)
    tvalid = tb.slot_mask(tf.block_idx, tf.nblocks)
    out = tb.bcsr_spmm_grad(blocks, tf.block_idx, blocks_T, tt.block_idx, tvalid, Mt, n)
    (out * t32(W)).sum().backward()
    close(out, A @ M, rtol=GRT, atol=1e-5)
    close(blocks.grad, gb_ref, rtol=GRT, atol=1e-6)
    close(Mt.grad, gM_ref, rtol=GRT, atol=1e-6)
    assert blocks_T.grad is None  # zero by design
    pad = (tvalid == 0)
    assert float(blocks.grad[pad].abs().max()) == 0.0


def _bcsr_val(pkg, A, dA, bs):
    """``(A, dA)`` as BCSRVals on A's layout (dA shares A's pattern)."""
    f, t = pkg.bcsr_from_dense(A, bs), pkg.bcsr_transpose(pkg.bcsr_from_dense(A, bs))
    df, dt = pkg.bcsr_from_dense(dA, bs, f.kb), pkg.bcsr_transpose(pkg.bcsr_from_dense(dA, bs))
    diag = jb.bcsr_diag_slots(np.asarray(f.block_idx), np.asarray(f.nblocks))
    lay = pkg.BCSRLayout(f.block_idx, f.nblocks, t.block_idx, t.nblocks,
                         torch.tensor(diag) if pkg is tb else jnp.asarray(diag), A.shape[0], bs)
    return pkg.BCSRVal(f.blocks, t.blocks, lay), pkg.BCSRVal(df.blocks, dt.blocks, lay)


def test_bcsr_fused_apply_and_grads_match_jax():
    rng = np.random.default_rng(6)
    n, bs, H = 30, 8, 4
    A = banded(rng, n, 5)
    A[3, 3] = 0.0  # a zero on the diagonal
    dA = np.where(A != 0, rng.normal(size=(n, n)), 0.0).astype(np.float32)
    M = rng.normal(size=(n, H)).astype(np.float32)
    W = rng.normal(size=(n, H)).astype(np.float32)
    params = params8(rng)
    ref = _apply_grads_jax(jb.bcsr_fused_apply, *_bcsr_val(jb, A, dA, bs), M, params, W)
    got = _apply_grads_torch(tb.bcsr_fused_apply, *_bcsr_val(tb, A, dA, bs), M, params, W)
    close(got[0], ref[0], rtol=GRT, atol=1e-6)
    close(got[1], ref[1], rtol=GRT, atol=1e-6)
    for a, b in zip(got[2], ref[2]):
        close(a, b, rtol=GRT, atol=1e-6)


# ---------------------------------------------------------------------------
# (c) the controls; (d) routing and the edge-list control
# ---------------------------------------------------------------------------


def _stacked(rng, B, T, n, interpolation, hetero=True):
    """Per-element knots (B, T), value knots with per-element band widths,
    and reference-layout stacked [time, value] coefficients (numpy; the
    time channel by the port's own Hermite/linear construction)."""
    steps = rng.uniform(0.1, 0.3, (B, T - 1))
    ts = np.concatenate([np.zeros((B, 1)), np.cumsum(steps, 1)], 1).astype(np.float32)
    A = np.stack([banded(rng, n, 1 + (3 * b if hetero else 0), (T,)) for b in range(B)])
    A[0, :, 0, n - 1] = 0.3  # a far entry in element 0
    X = np.stack([np.broadcast_to(ts[..., None, None], A.shape), A], -1)
    if interpolation == "linear":
        return ts, X
    coeffs = tinterp.backward_hermite_coefficients(torch.tensor(ts), torch.tensor(X))
    return ts, tuple(c.numpy() for c in coeffs)


def _elem(ctrl, b):
    return jax.tree_util.tree_map(lambda x: x[b], ctrl)


@pytest.mark.parametrize("interpolation", ["cubic", "linear"])
@pytest.mark.parametrize("batched", [True, False], ids=["batched", "unbatched"])
def test_ell_control_matches_jax(interpolation, batched):
    rng = np.random.default_rng(7)
    B, T, n = 3, 5, 11
    ts, coeffs = _stacked(rng, B, T, n, interpolation)
    if not batched:
        ts, coeffs = ts[0], (coeffs[0] if interpolation == "linear"
                             else tuple(c[0] for c in coeffs))
    kw = dict(max_degree=2) if not batched else dict(max_degree=13)
    got = tinterp.SparseMatrixControl.from_stacked(interpolation, ts, coeffs, **kw)
    ref = jinterp.SparseMatrixControl.from_stacked(
        interpolation, jnp.asarray(ts), tuple(map(jnp.asarray, coeffs))
        if interpolation == "cubic" else jnp.asarray(coeffs), **kw)
    tq = np.array([0.13, 0.41, 0.05], np.float32)
    if batched:
        assert got.path.indices.shape[-1] == 13  # widened to max_degree
        vals = (got.adj(torch.tensor(tq)), got.dadj(torch.tensor(tq)))
        for b in range(B):
            e = _elem(ref, b)
            for v, r in zip(vals, (e.adj(tq[b]), e.dadj(tq[b]))):
                np.testing.assert_array_equal(v.indices[b].numpy(), np.asarray(r.indices))
                close(v.values[b], r.values)
    else:
        assert got.path.indices.shape[-1] == 2  # truncated to max_degree
        for tt in tq:
            for v, r in zip((got.adj(float(tt)), got.dadj(float(tt))),
                            (ref.adj(tt), ref.dadj(tt))):
                np.testing.assert_array_equal(v.indices.numpy(), np.asarray(r.indices))
                close(v.values, r.values)


def _same_layout(got, ref):
    for f in ("block_idx", "nblocks", "block_idx_T", "nblocks_T", "diag_slot"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)))


@pytest.mark.parametrize("interpolation", ["cubic", "linear"])
@pytest.mark.parametrize("batched", [True, False], ids=["batched", "unbatched"])
def test_bcsr_control_matches_jax(interpolation, batched):
    """Batched elements have different block patterns (padded slots), and the
    batched cubic build takes the cubic branch."""
    rng = np.random.default_rng(8)
    B, T, n, bs = 2, 4, 19, 4
    ts, coeffs = _stacked(rng, B, T, n, interpolation)
    if not batched:
        ts, coeffs = ts[0], (coeffs[0] if interpolation == "linear"
                             else tuple(c[0] for c in coeffs))
    got = tinterp.BCSRMatrixControl.from_stacked(interpolation, ts, coeffs, block_size=bs)
    ref = jinterp.BCSRMatrixControl.from_stacked(
        interpolation, jnp.asarray(ts), tuple(map(jnp.asarray, coeffs))
        if interpolation == "cubic" else jnp.asarray(coeffs), block_size=bs)
    cls = tbp.BCSRCubicMatrixPath if interpolation == "cubic" else tbp.BCSRLinearMatrixPath
    assert isinstance(got.path, cls)
    tq = np.array([0.22, 0.5], np.float32)
    if batched:
        assert float(got.path.layout.valid.min()) == 0.0
        vals = (got.adj(torch.tensor(tq)), got.dadj(torch.tensor(tq)))
        for b in range(B):
            e = _elem(ref, b)
            lay = got.path.layout
            _same_layout(tb.BCSRLayout(*(x[b] for x in lay.tensors()), n, bs), e.path.layout)
            for v, r in zip(vals, (e.adj(tq[b]), e.dadj(tq[b]))):
                close(v.blocks[b], r.blocks)
                close(v.blocks_T[b], r.blocks_T)
    else:
        _same_layout(got.path.layout, ref.path.layout)
        for tt in tq:
            for v, r in zip((got.adj(float(tt)), got.dadj(float(tt))),
                            (ref.adj(tt), ref.dadj(tt))):
                close(v.blocks, r.blocks)
                close(v.blocks_T, r.blocks_T)


@pytest.mark.parametrize("n,want", [(40, "ell"), (2048, "bcsr")])
def test_build_sparse_control_auto_routing_matches_jax(n, want):
    """``auto`` keeps the JAX threshold (fill >= 0.1 and n >= 2048): a
    banded graph goes to BCSR at n=2048 and to ELL below it."""
    T = 2
    ts = np.linspace(0.0, 1.0, T).astype(np.float32)
    i, j = np.indices((n, n))
    A = np.where(np.abs(i - j) <= 24, 0.5, 0.0).astype(np.float32)
    X = np.stack([np.broadcast_to(ts[:, None, None], (T, n, n)),
                  np.broadcast_to(A, (T, n, n))], -1)
    got = tinterp.build_sparse_control("linear", ts, X, sparse_format="auto", block_size=128)
    ref = jinterp.build_sparse_control("linear", jnp.asarray(ts), jnp.asarray(X),
                                       sparse_format="auto", block_size=128)
    want_t = tinterp.BCSRMatrixControl if want == "bcsr" else tinterp.SparseMatrixControl
    want_j = jinterp.BCSRMatrixControl if want == "bcsr" else jinterp.SparseMatrixControl
    assert isinstance(got, want_t) and isinstance(ref, want_j)
    if want == "bcsr":
        _same_layout(got.path.layout, ref.path.layout)
        close(got.adj(0.3).blocks, ref.adj(0.3).blocks)
    else:
        close(got.adj(0.3).values, ref.adj(0.3).values)


@pytest.mark.parametrize("interpolation", ["cubic", "linear"])
def test_bcsr_control_from_edge_snapshots_matches_jax(interpolation):
    rng = np.random.default_rng(9)
    n, bs, T = 60, 16, 4
    snaps = []
    for k in range(T):
        nnz = 150 + 40 * k
        snaps.append((rng.integers(0, n, nnz), rng.integers(0, n, nnz),
                      rng.uniform(0.1, 1.0, nnz).astype(np.float32)))
    ts = np.linspace(0.0, 1.0, T).astype(np.float32)
    got = tinterp.bcsr_control_from_edge_snapshots(ts, snaps, n, bs, interpolation)
    ref = jinterp.bcsr_control_from_edge_snapshots(jnp.asarray(ts), snaps, n, bs,
                                                   interpolation)
    _same_layout(got.path.layout, ref.path.layout)
    for tt in (0.15, 0.6, 0.95):
        for v, r in zip((got.adj(tt), got.dadj(tt)), (ref.adj(tt), ref.dadj(tt))):
            close(v.blocks, r.blocks, atol=1e-5)
            close(v.blocks_T, r.blocks_T, atol=1e-5)


# ---------------------------------------------------------------------------
# (e) the vector field through both controls; the dispatch gate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["ell", "bcsr"])
def test_field_through_sparse_control_matches_jax_dense(fmt):
    """The port's field through a batched ELL / BCSR control at per-element
    t, against the JAX field through its dense control, per element, with
    copied weights: values and parameter gradients."""
    from gncde_tpu.interp import CubicInterpolation as JCubic
    from gncde_tpu.interp import MatrixControl as JMatrixControl
    from gncde_tpu.models.vector_fields import PermEquivGraphVectorField as JVF
    from gncde_tpu_torch.models.vector_fields import PermEquivGraphVectorField as TVF
    from gncde_tpu_torch.models.vector_fields import fields as tfields

    rng = np.random.default_rng(10)
    B, T, n, H = 2, 4, 14, 6
    ts, coeffs = _stacked(rng, B, T, n, "cubic")
    ctrl = tinterp.build_sparse_control("cubic", ts, coeffs, sparse_format=fmt,
                                        block_size=4)
    assert not tfields._pallas_plane_dispatch_ok(ctrl, torch.device("cpu"))
    vf_j = JVF(input_dim=H, hidden_dim=H, output_dim=H, num_layers=2, data_embed_dim=1,
               num_nodes=n, key=jr.PRNGKey(3))
    vf_t = TVF(H, H, H, 2, 1, n, generator=torch.Generator().manual_seed(0))
    copy_jax_to_torch(vf_j, vf_t)
    tq = np.array([0.21, 0.48], np.float32)
    Z = rng.normal(size=(B, n, H)).astype(np.float32)
    W = rng.normal(size=(B, n, H)).astype(np.float32)

    out = vf_t(torch.tensor(tq), t32(Z), ctrl)
    (out * t32(W)).sum().backward()
    grads_t = {k: p.grad.numpy() for k, p in vf_t.named_parameters()}

    @jax.jit
    def value_and_grad(v, t, Z_, W_, ts_, planes):
        dense = JMatrixControl(JCubic(ts_, planes))
        return jax.value_and_grad(lambda v_: jnp.sum(v_(t, Z_, dense) * W_), has_aux=False)(
            v), v(t, Z_, dense)

    grads_j = None
    for b in range(B):
        (_, g), ref = value_and_grad(vf_j, tq[b], Z[b], W[b], ts[b],
                                     tuple(c[b, ..., -1] for c in coeffs))
        close(out[b], ref, rtol=GRT, atol=1e-5)
        grads_j = g if grads_j is None else jax.tree_util.tree_map(jnp.add, grads_j, g)
    vf_g = TVF(H, H, H, 2, 1, n, generator=torch.Generator().manual_seed(0))
    copy_jax_to_torch(grads_j, vf_g)
    for k, p in vf_g.named_parameters():
        close(grads_t[k], p.detach(), rtol=GRT, atol=1e-5)


def test_sparse_controls_bypass_the_kernels_and_give_their_values():
    """The vf-level kernel gate refuses sparse controls even under the
    megakernel backend, ``control_terms`` returns their own A(t), dA(t) (ELL
    or BCSRVal) with no time gradient, and an enc_idx field refuses them."""
    from gncde_tpu_torch import ops
    from gncde_tpu_torch.models.vector_fields import PermEquivGraphVectorField as TVF
    from gncde_tpu_torch.models.vector_fields import fields as tfields

    rng = np.random.default_rng(11)
    ts, coeffs = _stacked(rng, 2, 4, 9, "cubic")
    tq = torch.tensor([0.1, 0.3])
    for fmt, typ in (("ell", tsp.ELL), ("bcsr", tb.BCSRVal)):
        ctrl = tinterp.build_sparse_control("cubic", ts, coeffs, sparse_format=fmt,
                                            block_size=4)
        ops.set_fusion_backend("megakernel")
        try:
            assert not tfields._pallas_plane_dispatch_ok(ctrl, torch.device("cuda"))
        finally:
            ops.set_fusion_backend("auto")
        A, dA, tgrad = tfields.control_terms(ctrl, tq)
        assert isinstance(A, typ) and isinstance(dA, typ) and tgrad is None
        # enc_idx modulates dense planes only (the JAX field fails there too).
        vf = TVF(4, 4, 4, 1, 1, 9, enc_idx=True, idx_dim=4,
                 generator=torch.Generator().manual_seed(0))
        with pytest.raises(NotImplementedError, match="sparse control"):
            vf(tq, torch.zeros(2, 9, 4), ctrl)


# ---------------------------------------------------------------------------
# The trainer's knobs
# ---------------------------------------------------------------------------


FLAGSHIP_ARGS = ["epochs=1", "min_epochs=0", "dataset.num_nodes=16", "dataset.batch_size=2",
                 "dataset.time_tick=10", "model.max_steps=64", "device=cpu",
                 "wandb.mode=disabled", "sparse_control=true", "sparse_block_size=4"]


def _flagship_config(overrides):
    from gncde_tpu_torch.run import common

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "configs",
                        "dyn", "perm_equiv_gncde.yaml")
    with open(path) as f:
        return path, common.apply_overrides(common.safe_load(f.read()), overrides)


@pytest.mark.parametrize("fmt", ["ell", "bcsr", "auto"])
def test_trainer_config_takes_the_sparse_knobs(fmt):
    """``sparse_control=true sparse_format=<fmt>`` (with ``sparse_block_size``
    and ``sparse_max_degree``) passes the config reader on the flagship
    config; another format is refused."""
    from gncde_tpu_torch.configs import ConfigError
    from gncde_tpu_torch.train.trainer import Trainer

    _, cfg = _flagship_config(FLAGSHIP_ARGS + [f"sparse_format={fmt}",
                                               "sparse_max_degree=6"])
    tr = Trainer.from_dict(cfg)
    assert (tr.sparse_control, tr.sparse_format, tr.sparse_block_size,
            tr.sparse_max_degree) == (True, fmt, 4, 6)
    cfg["sparse_format"] = "csr"
    with pytest.raises(ConfigError, match="sparse_format"):
        Trainer.from_dict(cfg)


def test_dyn_cli_trains_through_a_bcsr_control(tmp_path, caplog):
    """One training step of ``python -m gncde_tpu_torch.run.dyn
    --config configs/dyn/perm_equiv_gncde.yaml sparse_control=true
    sparse_format=bcsr`` on the CPU (n=16; no evaluation)."""
    import logging

    from gncde_tpu_torch.run import dyn

    path, _ = _flagship_config([])
    with caplog.at_level(logging.INFO):
        res = dyn.main(["--config", path, *FLAGSHIP_ARGS, "sparse_format=bcsr",
                        "eval_freq=2", f"dataset.cache_dir={tmp_path}/cache",
                        f"checkpoint_dir={tmp_path}/ckpt/"])
    assert "Sparse control conversion done (format=bcsr)" in caplog.text
    assert len(res["train_losses"]) == 1 and np.isfinite(res["train_losses"]).all()
    assert res["control_bytes"] > 0


@pytest.mark.parametrize("fmt", ["ell", "bcsr"])
def test_chip_smoke_route_check_holds_the_sparse_field_and_grads(tmp_path, fmt):
    """``chip_smoke.route_errors``, the check of phases 11 and 12, on the
    CPU at n=25 (block size 8: padded slots in some block rows): the field
    at the trainer's init through the sparse control and its gradients
    (state and every field parameter) against the dense control's, within
    the script's own bounds (1e-4 and 1e-3 of max|ref|)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir))
    import chip_smoke

    from gncde_tpu_torch.models.continuous import make_control
    from gncde_tpu_torch.train.trainer import Trainer

    _, cfg = _flagship_config([f"dataset.cache_dir={tmp_path}", "dataset.num_nodes=25",
                               "device=cpu"])
    tr = Trainer.from_dict(cfg)
    d = tr.dataset.get_training_data()
    model = tr.model.build(torch.Generator().manual_seed(tr.seed))
    ts, coeffs = d["train_t"], d["train_graph_path_coeffs"]
    sparse = tinterp.build_sparse_control(tr.model.interpolation, ts, coeffs, fmt,
                                          block_size=8)
    if fmt == "bcsr":
        assert bool((sparse.path.layout.nblocks < sparse.path.layout.block_idx.shape[-1]).any())
    with torch.no_grad():
        y = model.initial_linear(d["true_y0"])
    vf_err, grad_errs = chip_smoke.route_errors(
        torch, model.vector_field, y, ts, make_control(tr.model.interpolation, ts, coeffs),
        sparse)
    assert len(grad_errs) == 1 + len(list(model.vector_field.parameters()))
    assert vf_err <= chip_smoke.SPARSE_VF_TOL
    assert max(grad_errs.values()) <= chip_smoke.SPARSE_GRAD_TOL, grad_errs
