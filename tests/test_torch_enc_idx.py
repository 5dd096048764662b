"""Port parity of the enc_idx path against the JAX package, on the CPU: the
modules it adds (MLP, Embedding, IdxEncoder), the decomposed modulation, the
plain versions of K7 (modulate_pair), K6a (_pair_call) and K6b
(_pair_dw_call) against the Pallas kernels in interpret mode, the plane-pair
autograd Function against the custom VJP, ``tiled_vf_eval_planes``, the
enc_idx field, one TGB train step, and the configs. Inputs are made with
numpy from a seed and given to both sides; JAX parameters are copied into
the port by leaf path.

Tolerances, each against the largest magnitude of the reference array:
* 1e-6 for MLP, Embedding and IdxEncoder (the same f32 products);
* 1e-5 for the modulation (a short chain of f32 products and sums, summed
  in another order) and for the K6 kernels (f32 planes and vectors on both
  sides, only the order of the sums differs);
* 1e-4 for cotangents, the layer stack, the field and its gradients (f32
  sums over n and the chain through layers and the modulation MLPs);
* rtol 1e-4 for the TGB step's loss and gradient norm (f32 forward and
  backward through a constant-step solve).
"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from gncde_tpu import ops as jops
from gncde_tpu.configs import OptimiserCfg as JOpt
from gncde_tpu.configs.dataset_configs import TGBDataSetCfg as JDataCfg
from gncde_tpu.interp import (
    CubicInterpolation as JCubic,
    MatrixControl as JMatrixControl,
    backward_hermite_coefficients as j_bhc,
)
from gncde_tpu.models.neural_nets import IdxEncoder as JIdxEncoder
from gncde_tpu.models.tgb import TGBGraphNeuralCDE as JTGBModel
from gncde_tpu.models.vector_fields import PermEquivGraphVectorField as JVF
from gncde_tpu.models.vector_fields import fields as jfields
from gncde_tpu.nn import MLP as JMLP
from gncde_tpu.nn import Embedding as JEmbedding
from gncde_tpu.nn import is_inexact_array, partition, tree_serialise_leaves
from gncde_tpu.ops.pallas import modulate as jmod
from gncde_tpu.ops.pallas import tiled as jt
from gncde_tpu.train.windowed import TGBTrainer as JTrainer, make_window_step_fn
from gncde_tpu_torch import ops
from gncde_tpu_torch.configs import OptimiserCfg, TGBDataSetCfg, TGBGraphNeuralCDECfg
from gncde_tpu_torch.interp import CubicInterpolation, MatrixControl
from gncde_tpu_torch.models.neural_nets import IdxEncoder
from gncde_tpu_torch.models.vector_fields import PermEquivGraphVectorField as TVF
from gncde_tpu_torch.models.vector_fields import fields as tfields
from gncde_tpu_torch.nn import MLP, Embedding, convert
from gncde_tpu_torch.ops import modulate as tmod
from gncde_tpu_torch.ops import pair as tp
from gncde_tpu_torch.run import common
from gncde_tpu_torch.train import windowed
from gncde_tpu_torch.train.trainer import make_step_fn

from torch_parity_utils import copy_jax_to_torch, hermite_path, jax_leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]
GEN = dict(generator=torch.Generator().manual_seed(0))


def _close(got, ref, tol, what=""):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err, scale = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    assert err <= tol * max(scale, 1e-30), f"{what}: max abs err {err:.3e} > {tol} x {scale:.3e}"


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


@pytest.fixture
def backends():
    """Restores both packages' fusion backends."""
    prev = jops._BACKEND
    yield
    jops.set_fusion_backend(prev)
    ops.set_fusion_backend("auto")


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

MODULES = {
    "mlp-depth2": lambda k: (JMLP(in_size=9, out_size=1, width_size=8, depth=2, key=k),
                             MLP(9, 1, 8, 2, **GEN)),
    "mlp-depth0": lambda k: (JMLP(in_size=9, out_size=3, width_size=8, depth=0, key=k),
                             MLP(9, 3, 8, 0, **GEN)),
    "embedding": lambda k: (JEmbedding(11, 5, key=k), Embedding(11, 5, **GEN)),
}


@pytest.mark.parametrize("name", list(MODULES))
def test_modules_match_jax(name):
    mj, mt = MODULES[name](jr.PRNGKey(1))
    copy_jax_to_torch(mj, mt)
    rng = np.random.default_rng(0)
    if name == "embedding":
        idx = rng.integers(0, 11, 7)
        ref, got = jax.vmap(mj)(jnp.asarray(idx)), mt(torch.tensor(idx))
    else:
        x = rng.normal(size=(6, 9)).astype(np.float32)
        ref, got = jax.vmap(mj)(jnp.asarray(x)), mt(_t(x))
    _close(got, ref, 1e-6, name)


@pytest.mark.parametrize("enc_type", ["emb", "linear", "mlp"])
def test_idx_encoder_matches_jax(enc_type):
    ej = JIdxEncoder(10, 6, key=jr.PRNGKey(2), type=enc_type)
    et = IdxEncoder(10, 6, type=enc_type, **GEN)
    copy_jax_to_torch(ej, et)
    _close(et.node_embedding(), ej.node_embedding(), 1e-6, "node_embedding")
    _close(et(), ej(), 1e-6, "pairwise concat")


# ---------------------------------------------------------------------------
# Modulation and K7
# ---------------------------------------------------------------------------


def _mlps(d, key=3):
    k1, k2 = jr.split(jr.PRNGKey(key))
    pair_j = [JMLP(in_size=2 * d + 1, out_size=1, width_size=8, depth=2, key=k)
              for k in (k1, k2)]
    pair_t = [MLP(2 * d + 1, 1, 8, 2, **GEN) for _ in range(2)]
    for a, b in zip(pair_j, pair_t):
        copy_jax_to_torch(a, b)
    return pair_j, pair_t


def test_modulate_matrix_matches_jax():
    n, d, B = 14, 6, 2
    rng = np.random.default_rng(4)
    mats = rng.normal(0.0, 0.5, (B, n, n)).astype(np.float32)
    emb = rng.normal(size=(n, d)).astype(np.float32)
    (mj, _), (mt, _) = _mlps(d)
    got = tfields._modulate_matrix(_t(mats), mt, _t(emb))
    ref = np.stack([jfields._modulate_matrix(jnp.asarray(m), mj, jnp.asarray(emb))
                    for m in mats])
    _close(got, ref, 1e-5)


def test_plain_modulate_pair_matches_pallas():
    """K7's plain version (through the wrapper, on CPU tensors) against the
    Pallas kernel in interpret mode, ragged: n=20 with tile 8."""
    n, d, B, tile = 20, 5, 2, 8
    rng = np.random.default_rng(5)
    A = rng.uniform(-0.2, 1.0, (B, n, n)).astype(np.float32)
    dA = rng.normal(0.0, 0.5, (B, n, n)).astype(np.float32)
    emb = rng.normal(size=(n, d)).astype(np.float32)
    (ma, md), (ta, td) = _mlps(d, key=6)
    got = tmod.modulate_pair(_t(A), _t(dA), ta, td, _t(emb))
    for b in range(B):
        ref = jmod.modulate_pair(jnp.asarray(A[b]), jnp.asarray(dA[b]), ma, md,
                                 jnp.asarray(emb), tile=tile)
        for g, r in zip(got, ref):
            assert r.shape == (24, 24)
            _close(g[b], np.asarray(r)[:n, :n], 1e-5, "modulated plane")
            assert not np.asarray(r)[n:].any() and not np.asarray(r)[:, n:].any()


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_k7_kernel_inputs_reproduce_plain_chain(depth):
    """K7's packed inputs, read at the offsets ``csrc/modulate.cu`` uses,
    give the plain chain built from the MLPs (the kernel's input preparation
    checked on CPU)."""
    n, d, B, w = 9, 5, 2, tmod.WIDTH
    rng = np.random.default_rng(depth)
    A, dA = (_t(rng.normal(0.2, 0.5, (B, n, n))) for _ in range(2))
    emb = _t(rng.normal(size=(n, d)))
    mlps = [MLP(2 * d + 1, 1, w, depth, **GEN) for _ in range(2)]
    assert all(tmod.modulate_supported(m) for m in mlps)
    got_depth, wts, Ei, Ej = tmod.kernel_inputs(*mlps, emb)
    ws = 3 * w + 1 + (depth - 1) * (w * w + w)
    assert got_depth == depth and wts.shape == (2 * ws,)
    assert Ei.shape == (n, 2 * w) and Ej.shape == (2 * w, n)
    for plane, (X, ref) in enumerate(zip((A, dA), tmod.plain_modulate_pair(A, dA, *mlps, emb))):
        p = wts[plane * ws:(plane + 1) * ws]
        ei, ej = Ei[:, plane * w:(plane + 1) * w], Ej[plane * w:(plane + 1) * w]
        r = torch.relu(p[:w][None, :, None, None] * X[:, None] + ei.T[None, :, :, None]
                       + ej[None, :, None, :] + p[w:2 * w][None, :, None, None])
        off = 2 * w
        for _ in range(depth - 1):
            hw, hb = p[off:off + w * w].reshape(w, w), p[off + w * w:off + w * w + w]
            r = torch.relu(torch.einsum("vc,bcij->bvij", hw, r) + hb[None, :, None, None])
            off += w * w + w
        out = torch.einsum("c,bcij->bij", p[off:off + w], r) + p[off + w]
        _close(out, ref.detach().numpy(), 1e-6, f"plane {plane}")


# ---------------------------------------------------------------------------
# K6 and the plane-pair primitive
# ---------------------------------------------------------------------------


def _pair_inputs(nr, nc, H, B, tile, seed=7):
    """f32 planes (B, nr, nc) and vectors for both sides; the JAX vectors
    zero-padded to the tile."""
    rng = np.random.default_rng(seed)
    A = rng.normal(0.1, 0.3, (B, nr, nc)).astype(np.float32)
    dA = rng.normal(0.0, 0.5, (B, nr, nc)).astype(np.float32)
    Mk, Gc = (rng.normal(size=(B, nc, H)).astype(np.float32) for _ in range(2))
    Mi, Gr = (rng.normal(size=(B, nr, H)).astype(np.float32) for _ in range(2))
    cvec = np.array([1.03, 0.071, -0.044, 0.052], np.float32)
    NPr, NPc = jt._cdiv(nr, tile) * tile, jt._cdiv(nc, tile) * tile

    def pad(x, rows):
        return jnp.zeros((rows, H), jnp.float32).at[:x.shape[0]].set(jnp.asarray(x))

    return dict(A=A, dA=dA, Mk=Mk, Mi=Mi, Gr=Gr, Gc=Gc, cvec=cvec,
                pad_c=lambda x: pad(x, NPc), pad_r=lambda x: pad(x, NPr))


PAIR_SHAPES = [(20, 20), (20, 13)]
PAIR_IDS = ["square-n20", "rect-20x13"]


@pytest.mark.parametrize("nr,nc", PAIR_SHAPES, ids=PAIR_IDS)
@pytest.mark.parametrize("kernel", ["K6a", "K6b"])
def test_plain_pair_kernels_match_pallas(kernel, nr, nc):
    H, B, tile = 5, 2, 8
    x = _pair_inputs(nr, nc, H, B, tile)
    kw = dict(nr=nr, nc=nc, tile=tile, interpret=True)
    if kernel == "K6a":
        got = tp.pair_call(_t(x["A"]), _t(x["dA"]), _t(x["cvec"]), _t(x["Mk"]), _t(x["Mi"]))
    else:
        got = tp.pair_dw_call(*(_t(x[k]) for k in ("A", "dA", "Gr", "Mk", "Mi", "Gc")))
    for b in range(B):
        A, dA = jnp.asarray(x["A"][b]), jnp.asarray(x["dA"][b])
        if kernel == "K6a":
            row, col = jt._pair_call(A, dA, jnp.asarray(x["cvec"]).reshape(1, 4),
                                     x["pad_c"](x["Mk"][b]), x["pad_r"](x["Mi"][b]), **kw)
            _close(got[0][b], np.asarray(row)[:nr], 1e-5, "rowpart")
            _close(got[1][b], np.asarray(col)[:nc], 1e-5, "colpart")
        else:
            dw = jt._pair_dw_call(A, dA, x["pad_r"](x["Gr"][b]), x["pad_c"](x["Mk"][b]),
                                  x["pad_r"](x["Mi"][b]), x["pad_c"](x["Gc"][b]), **kw)
            _close(got[b], np.asarray(dw)[0], 1e-5, "dw")


def _dw_ctas(plan, nr, nc, H):
    """K6b's CTAs as csrc/plane_mma.cuh ``pair_dw_kernel`` walks them: per
    (tile, part) its rows [i0, i1), columns [k0, k1), H columns [h0, h1) and
    the slot its sums take in an element's parts."""
    T, HK = tp.DW_TILE, tp.DW_HK
    ntk, chunks = -(-nc // T), -(-H // HK)
    for tile in range(plan.tiles):
        i0, k0 = tile // ntk * T, tile % ntk * T
        for s in range(plan.splits):
            c0, c1 = s * chunks // plan.splits, (s + 1) * chunks // plan.splits
            yield ((i0, min(i0 + T, nr)), (k0, min(k0 + T, nc)),
                   (c0 * HK, min(c1 * HK, H)), tile * plan.splits + s)


@pytest.mark.parametrize("B,nr,nc,H", [(1, 1505, 1505, 128), (1, 255, 255, 512),
                                       (2, 300, 300, 5), (2, 300, 211, 13)],
                         ids=["genre-H128", "trade-H512", "ragged-n300-H5-B2", "rect-300x211"])
def test_k6b_plan_covers_every_plane_entry_and_column_once(B, nr, nc, H):
    """K6b's plan (``pair_dw_plan``, plain Python): its CTAs' row, column
    and H ranges are non-empty and tile the (nr, nc, H) box exactly once;
    each CTA's sums take their own slot of the (B, parts, 4) buffer the
    wrapper allocates; the grid splits H only where the plane tiles are
    fewer than two CTAs an SM, and then fills about two of them."""
    plan = tp.pair_dw_plan(B, nr, nc, H)
    ctas = list(_dw_ctas(plan, nr, nc, H))
    assert len(ctas) == plan.parts == plan.tiles * plan.splits
    assert sorted(slot for *_, slot in ctas) == list(range(plan.parts))
    rows, cols, hs = (sorted({c[j] for c in ctas}) for j in range(3))
    for ranges, extent in ((rows, nr), (cols, nc), (hs, H)):
        assert all(a < b for a, b in ranges)
        assert [a for a, _ in ranges] == [0] + [b for _, b in ranges[:-1]]
        assert ranges[-1][1] == extent
    assert len(ctas) == len(rows) * len(cols) * len(hs)  # every (rows, cols, H) box once
    assert sum((i1 - i0) * (k1 - k0) * (h1 - h0) for (i0, i1), (k0, k1), (h0, h1), _ in ctas) \
        == nr * nc * H
    tiles, chunks = plan.tiles * B, -(-H // tp.DW_HK)
    if tiles >= 2 * 132:
        assert plan.splits == 1
    else:  # as many parts as make two CTAs an SM, at most one a ring stage
        assert plan.splits == min(chunks, -(-2 * 132 // tiles))


@pytest.mark.parametrize("nr,nc,H,B", [(20, 20, 5, 2), (20, 13, 40, 1)], ids=["square", "rect"])
def test_k6b_library_call_is_k6b_function(nr, nc, H, B):
    """The one PyTorch call that chip_smoke.py times as K6b's library_ms
    (``k6b_library``: one einsum on stacked operands) computes K6b's
    function: plain_pair_dw's four sums, in its order when flattened,
    within 1e-5 of their scale (f32, another summation order)."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import chip_smoke

    x = _pair_inputs(nr, nc, H, B, 8)
    args = tuple(torch.tensor(x[k]) for k in ("A", "dA", "Gr", "Mk", "Mi", "Gc"))
    got = chip_smoke.k6b_library(torch, *args)().reshape(B, 4)
    ref = tp.plain_pair_dw(*args)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6a_wrapper_on_cpu_runs_its_plain_version(dtype, monkeypatch):
    """On CPU tensors pair_call is plain_pair, on rectangular planes of
    either dtype, whatever the split plan (``ops.tiled.mma_splits``) says,
    and counts no launch."""
    from gncde_tpu_torch.ops import tiled as tt

    x = _pair_inputs(20, 13, 5, 2, 8)
    A, dA = _t(x["A"]).to(dtype), _t(x["dA"]).to(dtype)
    args = (A, dA, _t(x["cvec"]), _t(x["Mk"]), _t(x["Mi"]))
    monkeypatch.setattr(tt, "mma_splits", lambda B, nr, nc, H: 3)
    before = (tp.pair_call.launches, tp.pair_call.bf16.launches)
    for got, ref in zip(tp.pair_call(*args), tp.plain_pair(*args)):
        assert torch.equal(got, ref)
    assert (tp.pair_call.launches, tp.pair_call.bf16.launches) == before


@pytest.mark.parametrize("nr,nc", PAIR_SHAPES, ids=PAIR_IDS)
def test_plane_pair_apply_cotangents_match_jax(nr, nc, monkeypatch):
    """The six cotangents of PlanePairApply against jax.vjp of
    plane_pair_apply, per element; the shared c cotangents summed over the
    batch. The backward runs K6a once and K6b once."""
    H, B, tile = 5, 2, 8
    x = _pair_inputs(nr, nc, H, B, tile, seed=8)
    c_row = np.array([1.1, -0.06], np.float32)
    c_col = np.array([0.05, 0.08], np.float32)
    ref = {k: [] for k in ("A", "dA", "cr", "cc", "Mk", "Mi")}
    for b in range(B):
        def f(A, dA, cr, cc, Mk, Mi):
            return jt.plane_pair_apply(A, dA, cr, cc, Mk, Mi, nr, nc, tile)

        _, vjp = jax.vjp(f, jnp.asarray(x["A"][b]), jnp.asarray(x["dA"][b]),
                         jnp.asarray(c_row), jnp.asarray(c_col),
                         x["pad_c"](x["Mk"][b]), x["pad_r"](x["Mi"][b]))
        cots = vjp((x["pad_r"](x["Gr"][b]), x["pad_c"](x["Gc"][b])))
        for k, v in zip(ref, cots):
            ref[k].append(np.asarray(v))
    ins = [_t(x["A"]), _t(x["dA"]), _t(c_row), _t(c_col), _t(x["Mk"]), _t(x["Mi"])]
    for v in ins:
        v.requires_grad_(True)
    calls = []
    for name in ("plain_pair", "plain_pair_dw"):
        real = getattr(tp, name)
        monkeypatch.setattr(tp, name, lambda *a, k=name, f=real: calls.append(k) or f(*a))
    row, col = tp.plane_pair_apply(*ins)
    torch.autograd.backward((row, col), (_t(x["Gr"]), _t(x["Gc"])))
    assert sorted(calls) == ["plain_pair", "plain_pair", "plain_pair_dw"]
    _close(ins[0].grad, np.stack(ref["A"]), 1e-4, "d_A")
    _close(ins[1].grad, np.stack(ref["dA"]), 1e-4, "d_dA")
    _close(ins[2].grad, np.sum(ref["cr"], 0), 1e-4, "d_c_row")
    _close(ins[3].grad, np.sum(ref["cc"], 0), 1e-4, "d_c_col")
    _close(ins[4].grad, np.stack(ref["Mk"])[:, :nc], 1e-4, "d_Mk")
    _close(ins[5].grad, np.stack(ref["Mi"])[:, :nr], 1e-4, "d_Mi")


def _vf_pair(n, H, L, d, out=None, seed=4):
    kw = dict(input_dim=H, hidden_dim=H, output_dim=out or H, num_layers=L,
              data_embed_dim=1, num_nodes=n, enc_idx=True, enc_type="emb", idx_dim=d)
    vf_j = JVF(**kw, key=jr.PRNGKey(seed))
    vf_t = TVF(**kw, **GEN)
    copy_jax_to_torch(vf_j, vf_t)
    return vf_j, vf_t


def test_tiled_vf_eval_planes_matches_jax():
    """Values and the gradients with respect to the planes, Z and every
    layer parameter, with ragged planes (n=20, tile 8)."""
    n, H, L, B, tile = 20, 5, 2, 2, 8
    rng = np.random.default_rng(9)
    A = rng.normal(0.05, 0.1, (B, n, n)).astype(np.float32)
    dA = rng.normal(0.0, 0.1, (B, n, n)).astype(np.float32)
    Z = rng.normal(size=(B, n, H)).astype(np.float32)
    W = rng.normal(size=(B, n, H)).astype(np.float32)
    vf_j, vf_t = _vf_pair(n, H, L, d=4)

    def jloss(vf, A_, dA_, Z_):
        out = jax.vmap(lambda a, da, z: jt.tiled_vf_eval_planes(a, da, z, vf, tile=tile))(
            A_, dA_, Z_)
        return jnp.sum(out * W), out

    (_, ref), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True))(
        vf_j, jnp.asarray(A), jnp.asarray(dA), jnp.asarray(Z))
    ins = [_t(A).requires_grad_(True), _t(dA).requires_grad_(True), _t(Z).requires_grad_(True)]
    out = tp.tiled_vf_eval_planes(*ins, vf_t)
    (out * _t(W)).sum().backward()
    _close(out, ref, 1e-4, "value")
    for v, g, name in zip(ins, jg[1:], ("dA_plane", "ddA_plane", "dZ")):
        _close(v.grad, g, 1e-4, name)
    jl = jax_leaves(jg[0])
    for name, p in vf_t.gnn_layers.named_parameters(prefix="gnn_layers"):
        _close(p.grad, jl[name.replace(".", "/")], 1e-4, name)


# ---------------------------------------------------------------------------
# The field
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("jax_backend", ["megakernel", "dense"],
                         ids=["jax-pallas-interpret", "jax-dense"])
def test_enc_idx_field_matches_jax(jax_backend, backends, monkeypatch):
    """The port's field under the megakernel backend on CPU (K7, K6a, K6b as
    plain versions, through _enc_idx_pallas_eval) against the JAX field,
    either on its Pallas path in interpret mode or on its dense backend:
    values and the gradients of Z, every layer, idx_enc and both MLPs."""
    n, H, L, B, T, d = 20, 4, 2, 2, 5, 6
    rng = np.random.default_rng(10)
    ts, A = hermite_path(rng, B, T, n)
    t = (ts[:, 1] + np.array([0.03, 0.11])).astype(np.float32)
    Z = rng.normal(size=(B, n, H)).astype(np.float32)
    W = rng.normal(size=(B, n, H)).astype(np.float32)
    coeffs = jax.vmap(j_bhc)(jnp.asarray(ts), jnp.asarray(A))
    vf_j, vf_t = _vf_pair(n, H, L, d, seed=11)
    jops.set_fusion_backend(jax_backend)
    monkeypatch.setattr(jt, "pick_tile", lambda n_: 8)  # ragged: n=20, tile 8

    def jloss(vf, Z_):
        out = jax.vmap(lambda ts_, c_, t_, z_: vf(t_, z_, JMatrixControl(JCubic(ts_, c_))))(
            jnp.asarray(ts), coeffs, jnp.asarray(t), Z_)
        return jnp.sum(out * W), out

    (_, ref), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        vf_j, jnp.asarray(Z))

    ops.set_fusion_backend("megakernel")
    planes = tuple(torch.tensor(np.asarray(c)) for c in coeffs)
    ctrl = MatrixControl(CubicInterpolation(torch.tensor(ts), planes))
    calls = []
    for mod, name in ((tmod, "plain_modulate_pair"), (tp, "plain_pair"), (tp, "plain_pair_dw")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, k=name, f=real: calls.append(k) or f(*a))
    Zt = _t(Z).requires_grad_(True)
    out = vf_t(torch.tensor(t), Zt, ctrl)
    (out * _t(W)).sum().backward()
    # One K7 per eval; per layer one K6a forward, one K6a + one K6b backward.
    assert sorted(calls) == sorted(["plain_modulate_pair"] + ["plain_pair"] * 2 * L
                                   + ["plain_pair_dw"] * L)
    _close(out, ref, 1e-4, "value")
    _close(Zt.grad, jg[1], 1e-4, "dZ")
    jl = jax_leaves(jg[0])
    names = [k for k, _ in vf_t.named_parameters()]
    assert {"idx_enc.module.weight", "msg_func_adj.layers.0.weight",
            "msg_func_adj_deriv.layers.2.bias"} <= set(names)
    for name, p in vf_t.named_parameters():
        _close(p.grad, jl[name.replace(".", "/")], 1e-4, name)


# ---------------------------------------------------------------------------
# TGB: one train step, the configs and the CLI
# ---------------------------------------------------------------------------

N, HID, E = 12, 4, 2
OPT = dict(name="adamw", weight_decay=1e-4, gradient_clipping=True,
           schedule=dict(name="constant_schedule", value=1e-2))


def _write_tgb_csv(root, n_snap=10, seed=0):
    rng = np.random.default_rng(seed)
    rows = ["timestamp,source,destination,weight"]
    for t in range(n_snap):
        for _ in range(30):
            s, d = rng.integers(0, N, 2)
            rows.append(f"{t},{s},{d},{rng.uniform(0.1, 2.0):.4f}")
    (root / "tgbn-trade").mkdir(parents=True, exist_ok=True)
    (root / "tgbn-trade" / "tgbn-trade_edgelist.csv").write_text("\n".join(rows) + "\n")
    return root


def _tgb_model_cfg():
    return dict(name="tgb_graph_neural_cde", hidden_dim=HID, interpolation="cubic",
                method="Tsit5", return_sequence=False, dt0=0.25,
                vector_field=dict(name="PermEquivGraphVectorField", hidden_dim=HID,
                                  num_layers=2, data_embed_dim=E, num_nodes=N,
                                  enc_idx=True, enc_type="emb", idx_dim=4))


def test_tgb_enc_idx_train_step_matches_jax(tmp_path, backends):
    """One TGBTrainer step of the enc_idx model against the JAX window step
    on its dense path, from copied weights: the port's dense path at rtol
    1e-4, its kernel path (K7, K6a, K6b as plain versions on CPU) at rtol
    1e-4 for the loss and 5e-4 for the gradient norm. The kernel path's
    rank-structured sums round otherwise than the dense basis matrices, and
    the RMSNorms of the solve amplify it: the two paths agree to 1e-13 in
    float64, and the norm differs by about 1e-4 in float32. Also
    the JAX save_weights leaves load into the port in flatten order
    (idx_enc, msg_func_adj, msg_func_adj_deriv after the layer stack, the
    field listed twice).

    The JAX model is built by hand: the JAX config gives a controlled
    enc_idx field H outputs, which its CDE wrapper cannot reshape to
    (H, E, 2); the port's config gives it H * E * 2, as every controlled
    field."""
    root = _write_tgb_csv(tmp_path / "data")
    kw = dict(name="tgbn-trade", window_size=3, stride=3, frequency="None",
              data_dir=str(root), interpolation="cubic")
    jwin = list(JDataCfg(**kw, cache_dir=str(tmp_path / "jcache")).get_training_data())[0]
    twin = list(TGBDataSetCfg.from_dict(dict(kw, cache_dir=str(tmp_path / "tcache")))
                .get_training_data())[0]
    vf_j = JVF(input_dim=HID, hidden_dim=HID, output_dim=HID * E * 2, num_layers=2,
               data_embed_dim=E, num_nodes=N, enc_idx=True, enc_type="emb", idx_dim=4,
               key=jr.PRNGKey(12))
    model_j = JTGBModel(vf_j, HID, "cubic", method="Tsit5", return_sequence=False,
                        dt0=0.25, key=jr.PRNGKey(13))

    def port_model(seed=0):
        return TGBGraphNeuralCDECfg.from_dict(_tgb_model_cfg()).build(
            torch.Generator().manual_seed(seed))

    path = str(tmp_path / "w.npz")
    tree_serialise_leaves(path, model_j)
    fresh = port_model(1)
    assert fresh.vector_field.gnn_layers[-1].conv_layer.linear.out_features == HID * E * 2
    convert.load_jax_npz(fresh, path)
    copied = port_model()
    copy_jax_to_torch(model_j, copied)
    for (k, a), (_, b) in zip(fresh.state_dict().items(), copied.state_dict().items()):
        assert torch.equal(a, b), k

    jops.set_fusion_backend("dense")
    jtrainer = JTrainer(model=_tgb_model_cfg(), optimiser=OPT,
                        dataset=dict(name="tgbn-trade", data_dir=str(tmp_path)))
    jopt, _ = JOpt(**OPT).build()
    jstep = make_window_step_fn(jopt, jtrainer._loss)
    opt_state = jopt.init(partition(model_j, is_inexact_array)[0])
    jdata = tuple(jnp.asarray(jwin[k]) if k != "graph_path_coeffs" else jwin[k]
                  for k in ("start_time", "t", "graph_path_coeffs", "x_t", "true_y0",
                            "true_y", "source_mask"))
    loss_j, *_, grad_j, _ = jstep(model_j, opt_state, jdata)

    ttrainer = windowed.TGBTrainer.from_dict(dict(
        model=_tgb_model_cfg(), dataset=dict(name="tgbn-trade"), optimiser=OPT, device="cpu"))
    for backend, grad_rtol in (("dense", 1e-4), ("megakernel", 5e-4)):
        ops.set_fusion_backend(backend)
        model_t = port_model()
        copy_jax_to_torch(model_j, model_t)
        optimiser, schedule = OptimiserCfg.from_dict(OPT).build(model_t.parameters())
        tstep = make_step_fn(optimiser, schedule, ttrainer._loss, True)
        calls = tmod.modulate_pair.launches, tp.pair_call.launches
        loss_t, grad_t, _ = tstep(model_t, ttrainer._data_tuple(
            windowed._to_device(twin, "cpu")))
        assert (tmod.modulate_pair.launches, tp.pair_call.launches) == calls  # CPU: plain
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4, err_msg=backend)
        np.testing.assert_allclose(float(grad_t), float(grad_j), rtol=grad_rtol,
                                   err_msg=backend)


def _cfg(name):
    return common.safe_load((ROOT / "configs" / "tgb" / name).read_text())


def test_genre_enc_idx_config_builds_and_directed_is_refused():
    """configs/tgb/genre_perm_equiv_enc_idx_gncde.yaml builds at full width
    (n=1505, vf 8 -> 8 -> 8 -> 128, emb idx encoder of width 8, two
    modulation MLPs of width 8 and depth 2); the directed enc_idx config,
    which refused until the directed enc_idx field was ported, builds as
    well, at the same widths on the directed basis (the name is kept from
    then; its parity: tests/test_torch_dir_enc_idx.py)."""
    cfg = _cfg("genre_perm_equiv_enc_idx_gncde.yaml")
    model = TGBGraphNeuralCDECfg.from_dict(cfg["model"]).build(torch.Generator().manual_seed(0))
    vf = model.vector_field
    assert vf.enc_idx and vf.num_nodes == 1505
    assert [l.conv_layer.linear.out_features for l in vf.gnn_layers] == [8, 8, 128]
    assert tuple(vf.idx_enc.module.weight.shape) == (1505, 8)
    for mlp in (vf.msg_func_adj, vf.msg_func_adj_deriv):
        assert (mlp.in_size, mlp.width_size, mlp.depth) == (17, 8, 2)
        assert tmod.modulate_supported(mlp)
    dcfg = _cfg("genre_perm_equiv_dir_enc_idx_gncde.yaml")["model"]
    dvf = TGBGraphNeuralCDECfg.from_dict(dcfg).build(torch.Generator().manual_seed(0)).vector_field
    assert type(dvf).__name__ == "PermEquivDirGraphVectorField" and dvf.enc_idx
    assert [l.conv_layer.linear.out_features for l in dvf.gnn_layers] == [8, 8, 128]
    assert all(len(l.params) == 11 for l in dvf.gnn_layers)


def test_tgb_enc_idx_cli_runs_on_cpu(tmp_path):
    """python -m gncde_tpu_torch.run.tgb on the enc_idx genre config cut to
    n=12, on the CPU, with the JAX package, pyyaml and networkx blocked."""
    _write_tgb_csv(tmp_path / "data")
    code = """
import runpy, sys
for _name in ("jax", "jaxlib", "gncde_tpu", "yaml", "networkx"):
    sys.modules[_name] = None
sys.argv = ["tgb", "--config", {cfg!r}, "epochs=1", "eval_freq=1", "log_freq=1",
            "min_epochs=0", "dataset.name=tgbn-trade", "dataset.frequency=None",
            "dataset.window_size=3", "dataset.stride=3", "dataset.data_dir={tmp}/data",
            "dataset.cache_dir={tmp}/cache", "checkpoint_dir={tmp}/ckpt/",
            "model.dt0=0.25", "model.vector_field.num_nodes=12",
            "device=cpu", "wandb.mode=disabled"]
runpy.run_module("gncde_tpu_torch.run.tgb", run_name="__main__")
""".format(cfg=str(ROOT / "configs" / "tgb" / "genre_perm_equiv_enc_idx_gncde.yaml"),
           tmp=str(tmp_path))
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")  # one torch thread
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    for line in ("Data loading done: 1/0/2 windows", "Train Loss", "Final:"):
        assert line in res.stderr, line


def test_controlled_enc_idx_field_width_is_h_e_2_by_ruling():
    """The port gives a controlled enc_idx field H * E * 2 outputs, as every
    controlled field, so the CDE wrapper can reshape them to (n, H, E, 2).
    This departs from the JAX rule (gncde_tpu/configs/vector_field_configs.py
    ``_output_dim``: ``enc_idx -> hidden_dim``), whose width that wrapper
    cannot reshape; the ruling closed ROADMAP Queue 3 item 3 in favour of
    H * E * 2 (the genre enc_idx config: H 8, E 8 -> 128)."""
    from gncde_tpu.configs.vector_field_configs import VectorFieldCfg as JVFCfg
    from gncde_tpu_torch.configs.vector_field_configs import VectorFieldCfg

    kw = dict(name="PermEquivGraphVectorField", hidden_dim=8, data_embed_dim=8,
              num_layers=3, use_control=True, num_nodes=12, idx_dim=8)
    port = VectorFieldCfg.from_dict(dict(kw, enc_idx=True))
    assert port._output_dim() == 8 * 8 * 2
    vf = port.build(torch.Generator().manual_seed(0))
    assert vf.gnn_layers[-1].conv_layer.linear.weight.shape[0] == 8 * 8 * 2
    # The same as the port's and the JAX package's non-enc_idx controlled rule
    # and different from the JAX enc_idx rule.
    assert port._output_dim() == VectorFieldCfg.from_dict(kw)._output_dim()
    assert JVFCfg(**kw, enc_idx=False)._output_dim(None) == 8 * 8 * 2
    assert JVFCfg(**kw, enc_idx=True)._output_dim(None) == 8
