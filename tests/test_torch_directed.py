"""Port parity of the directed 11-term basis against the JAX package, on the
CPU: the dense oracles, ``ConvEquivFusionDirectedLayer`` under every branch
(dense, pipeline, pallas, ELL and BCSR values), its golden, the plain
versions of K1, K2 and K11 on the directed basis against the JAX kernels in
Pallas interpret mode, the directed tiled eval, the field's and the TGB
model's parameter order, the directed enc_idx configs' build (their parity:
tests/test_torch_dir_enc_idx.py) and chip_smoke.py's phase 17 route check
at n=25.

Every plane is asymmetric (independent uniform entries), so row and column
sums differ and a row/column swap in any directed term shows. Inputs are
made with numpy from a seed and given to both sides; JAX parameters are
copied into the port by leaf path.

Tolerances, each against the largest magnitude of the reference array:
* 1e-10 in float64 for the oracles and the layer's dense and decomposed
  branches (the same arithmetic), and 1e-5 in float32 for its pipeline and
  pallas branches (the plain versions of K13 and K12, float32 as the
  kernels) and its ELL and BCSR branches, values and gradients (sums over
  n in another order);
* 1e-5 for the plain K1, and the golden at its own rtol 1e-4;
* 1e-5 for K11's y1 and f1, 1e-4 for its err (a difference of nearly
  equal stage sums) and its gradients;
* 1e-4 for K2's cotangents and the tiled eval
  (f32 sums over n and the layer and stage chains in another order; the
  tiled path's bf16 operands are the same on both sides, the JAX K3 on its
  ragged path as in tests/test_torch_tiled.py).
The CUDA kernels are held against these plain versions on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py phase 17).
"""

import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gncde_tpu import ops as jops
from gncde_tpu.configs import TGBGraphNeuralCDECfg as JModelCfg
from gncde_tpu.interp import (
    CubicInterpolation as JCubic,
    MatrixControl as JMatrixControl,
    backward_hermite_coefficients as j_bhc,
)
from gncde_tpu.models.vector_fields import PermEquivDirGraphVectorField as JDVF
from gncde_tpu.models.vector_fields.layers import ConvEquivFusionDirectedLayer as JLayer
from gncde_tpu.nn import tree_serialise_leaves
from gncde_tpu.ops import bcsr as jb
from gncde_tpu.ops import equiv_basis as jeb
from gncde_tpu.ops import sparse as jsp
from gncde_tpu.ops.pallas import fused_step as jfs
from gncde_tpu.ops.pallas import megakernel as jmk
from gncde_tpu.ops.pallas import megakernel_bwd as jmkb
from gncde_tpu.ops.pallas import tiled as jt
from gncde_tpu.solve import tableaus as jtab
from gncde_tpu_torch import ops
from gncde_tpu_torch.configs import TGBGraphNeuralCDECfg, VectorFieldCfg
from gncde_tpu_torch.interp import CubicInterpolation, MatrixControl
from gncde_tpu_torch.models.vector_fields import PermEquivDirGraphVectorField as TDVF
from gncde_tpu_torch.models.vector_fields.layers import ConvEquivFusionDirectedLayer as TLayer
from gncde_tpu_torch.nn import convert
from gncde_tpu_torch.ops import bcsr as tb
from gncde_tpu_torch.ops import equiv_basis as teb
from gncde_tpu_torch.ops import fused_step as tfs
from gncde_tpu_torch.ops import megakernel as mk
from gncde_tpu_torch.ops import megakernel_bwd as mkb
from gncde_tpu_torch.ops import sparse as tsp
from gncde_tpu_torch.ops import tiled as tt
from gncde_tpu_torch.run import common
from gncde_tpu_torch.solve.solve import _rk_step
from gncde_tpu_torch.solve.tableaus import get_tableau

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_parity_utils import copy_jax_to_torch, hermite_path, jax_leaves  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "goldens" / "conv_equiv_fusion_directed_layer.npz"


def _close(got, ref, tol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err, scale = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    assert err <= tol * max(scale, 1e-30), f"{what}: max abs err {err:.3e} > {tol} x {scale:.3e}"


def _asymmetric(A):
    """Row and column sums of each plane differ by more than a tenth of the
    row sums' scale (the check phase 17 makes on the card)."""
    A = np.asarray(A)
    rA, cA = A.sum(-1), A.sum(-2)
    return np.abs(cA - rA).max() > 0.1 * np.abs(rA).max()


@pytest.fixture
def backends():
    yield
    ops.set_fusion_backend("auto")
    ops.set_fused_step(False)
    jops.set_fusion_backend("auto")


# ---------------------------------------------------------------------------
# 1. The dense oracles
# ---------------------------------------------------------------------------


def test_directed_oracles_match_jax():
    """fusion_matrix_dense_directed and fused_coeffs_directed (float64),
    batched planes with per-element parameters."""
    rng = np.random.default_rng(0)
    B, n = 3, 11
    A, dA = rng.uniform(0.0, 1.0, (B, n, n)), rng.normal(size=(B, n, n))
    assert _asymmetric(A) and _asymmetric(dA)
    params = [rng.uniform(-0.5, 0.5, (B, 2)) for _ in range(11)]
    with jax.enable_x64(True):
        for b in range(B):
            pj = [jnp.asarray(p[b]) for p in params]
            pt = [torch.tensor(p[b]) for p in params]
            Aj, dAj = jnp.asarray(A[b]), jnp.asarray(dA[b])
            At, dAt = torch.tensor(A[b]), torch.tensor(dA[b])
            _close(teb.fusion_matrix_dense_directed(At, dAt, pt),
                   jeb.fusion_matrix_dense_directed(Aj, dAj, pj), 1e-12, "dense")
            for name, a, r in zip(teb.FusedCoeffs._fields,
                                  teb.fused_coeffs_directed(At, dAt, pt),
                                  jeb.fused_coeffs_directed(Aj, dAj, pj)):
                _close(a, r, 1e-12, name)
        # Batched parameters broadcast against batched planes.
        got = teb.fusion_matrix_dense_directed(torch.tensor(A), torch.tensor(dA),
                                               [torch.tensor(p) for p in params])
        ref = jax.vmap(jeb.fusion_matrix_dense_directed)(
            jnp.asarray(A), jnp.asarray(dA), [jnp.asarray(p) for p in params])
        _close(got, ref, 1e-12, "batched")


# ---------------------------------------------------------------------------
# 2-3. The layer under every branch, and its golden
# ---------------------------------------------------------------------------


def _layer_pair(H_in, H_out, seed, dtype):
    lj = JLayer(input_dim=H_in, output_dim=H_out, key=jr.PRNGKey(seed))
    lt = TLayer(H_in, H_out, generator=torch.Generator().manual_seed(0))
    copy_jax_to_torch(lj, lt)
    return lj, lt.to(dtype)


def _jax_layer_grads(layer, feats, A, dA, W):
    def loss(lyr, f):
        out = jax.vmap(lambda fb, a, da: lyr(fb, a, da))(f, A, dA)
        return jnp.sum(out * W), out

    (_, out), (g_layer, g_feats) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        layer, feats)
    return out, g_feats, jax_leaves(g_layer)


def _port_layer_grads(layer, feats, A, dA, W):
    f = torch.tensor(np.asarray(feats), requires_grad=True)
    out = layer(f, A, dA)
    (out * torch.tensor(np.asarray(W))).sum().backward()
    return out, f.grad, {k: p.grad for k, p in layer.named_parameters()}


def _check_layer(got, ref, vtol, gtol):
    out, g_feats, grads = got
    _close(out, ref[0], vtol, "value")
    _close(g_feats, ref[1], gtol, "feats grad")
    for name, g in grads.items():
        _close(g, ref[2][name.replace(".", "/")], gtol, name)


# The dense and decomposed branches in float64; pipeline and pallas feed
# K13's and K12's plain versions, which compute in float32 as the kernels do.
LAYER_BACKENDS = {"dense": (torch.float64, 1e-10), "decomposed": (torch.float64, 1e-10),
                  "pipeline": (torch.float32, 1e-5), "pallas": (torch.float32, 1e-5)}


@pytest.mark.parametrize("backend", list(LAYER_BACKENDS))
def test_layer_dense_backends_match_jax(backends, backend):
    """Each dense branch of the port against the JAX layer's dense branch
    (the same function), value and every gradient; the pipeline and pallas
    branches run K13's and K12's plain versions on the directed operands."""
    dtype, tol = LAYER_BACKENDS[backend]
    n, H, B = 13, 5, 2
    rng = np.random.default_rng(1)
    A, dA = rng.uniform(0.0, 0.3, (B, n, n)), rng.normal(0.0, 0.3, (B, n, n))
    feats, W = rng.normal(size=(B, n, H)), rng.normal(size=(B, n, H))
    assert _asymmetric(A) and _asymmetric(dA)
    lj, lt = _layer_pair(H, H, 3, dtype)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jops.set_fusion_backend("dense")
    with jax.enable_x64(dtype == torch.float64):
        ljd = jax.tree_util.tree_map(lambda x: x.astype(jdt) if hasattr(x, "dtype") else x, lj)
        ref = _jax_layer_grads(ljd, *(jnp.asarray(x, jdt) for x in (feats, A, dA, W)))
    ops.set_fusion_backend(backend)
    npdt = np.float64 if dtype == torch.float64 else np.float32
    got = _port_layer_grads(lt, feats.astype(npdt), torch.tensor(A, dtype=dtype),
                            torch.tensor(dA, dtype=dtype), W.astype(npdt))
    _check_layer(got, ref, tol, tol)


def _ell_pair(rng, n, B):
    """Per-element sparse A, dA (dA on A's pattern) as one batched port ELL
    pair and the per-element JAX ELLs."""
    dense_A, dense_dA = [], []
    for _ in range(B):
        A = np.where(rng.random((n, n)) < 0.3, rng.uniform(0.1, 1.0, (n, n)), 0.0)
        A[np.arange(0, n, 3), np.arange(0, n, 3)] = 0.7
        dense_A.append(A.astype(np.float32))
        dense_dA.append(np.where(A != 0, rng.normal(size=(n, n)), 0.0).astype(np.float32))
    K = max(jsp.ell_from_dense(a).max_degree for a in dense_A)
    jA = [jsp.ell_from_dense(a, max_degree=K) for a in dense_A]
    jdA = [jsp.ELL(e.indices, jsp.ell_from_dense(d, max_degree=K).values, n)
           for e, d in zip(jA, dense_dA)]
    tA = [tsp.ell_from_dense(a, max_degree=K) for a in dense_A]
    tdA = [tsp.ell_from_dense(d, max_degree=K) for d in dense_dA]
    idx = torch.stack([e.indices for e in tA])
    tr = tsp.transpose_pattern(idx, n)
    # dA's values at A's pattern: entries where A is zero are zero in dA too.
    dvals = torch.stack([torch.tensor(np.take_along_axis(
        d, np.minimum(e.indices.numpy(), n - 1).astype(np.int64), 1)
        * (e.indices.numpy() < n)) for d, e in zip(dense_dA, tA)]).float()
    del tdA
    return (tsp.ELL(idx, torch.stack([e.values for e in tA]), n, tr),
            tsp.ELL(idx, dvals, n, tr)), list(zip(jA, jdA)), (dense_A, dense_dA)


def _bcsr_vals(pkg, A, dA, bs):
    f, t = pkg.bcsr_from_dense(A, bs), pkg.bcsr_transpose(pkg.bcsr_from_dense(A, bs))
    df = pkg.bcsr_from_dense(dA, bs, f.kb)
    dt = pkg.bcsr_transpose(pkg.bcsr_from_dense(dA, bs))
    diag = jb.bcsr_diag_slots(np.asarray(f.block_idx), np.asarray(f.nblocks))
    lay = pkg.BCSRLayout(f.block_idx, f.nblocks, t.block_idx, t.nblocks,
                         torch.tensor(diag) if pkg is tb else jnp.asarray(diag), A.shape[0], bs)
    return pkg.BCSRVal(f.blocks, t.blocks, lay), pkg.BCSRVal(df.blocks, dt.blocks, lay)


@pytest.mark.parametrize("fmt", ["ell", "bcsr"])
def test_layer_sparse_branches_match_jax(fmt):
    """The layer on ELL (batched, per-element patterns) and BCSR values
    (a band with padded slots and a zero on the diagonal) against the JAX
    layer on its own sparse values, value and gradients, float32."""
    rng = np.random.default_rng(2)
    H = 4
    lj, lt = _layer_pair(H, H, 4, torch.float32)
    if fmt == "ell":
        n, B = 14, 2
        (tA, tdA), jpairs, (dense_A, _) = _ell_pair(rng, n, B)
        assert all(_asymmetric(a) for a in dense_A)
        feats, W = rng.normal(size=(B, n, H)), rng.normal(size=(B, n, H))
        outs, gfs, gls = [], [], []
        for b, (ja, jda) in enumerate(jpairs):
            def loss(lyr, f, ja=ja, jda=jda, b=b):
                out = lyr(f, ja, jda)
                return jnp.sum(out * W[b]), out
            (_, o), (gl, gf) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
                lj, jnp.asarray(feats[b], jnp.float32))
            outs.append(np.asarray(o))
            gfs.append(np.asarray(gf))
            gls.append(jax_leaves(gl))
        ref = (np.stack(outs), np.stack(gfs), {k: sum(g[k] for g in gls) for k in gls[0]})
        got = _port_layer_grads(lt, feats.astype(np.float32), tA, tdA, W.astype(np.float32))
    else:
        n, bs = 30, 8
        i, j = np.indices((n, n))
        A = np.where((np.abs(i - j) <= 4) | ((i == 2) & (j == 27)),
                     rng.uniform(0.1, 1.0, (n, n)), 0.0).astype(np.float32)
        A[3, 3] = 0.0
        dA = np.where(A != 0, rng.normal(size=(n, n)), 0.0).astype(np.float32)
        assert _asymmetric(A)
        feats, W = rng.normal(size=(n, H)), rng.normal(size=(n, H))

        def loss(lyr, f):
            out = lyr(f, *_bcsr_vals(jb, A, dA, bs))
            return jnp.sum(out * W), out

        (_, o), (gl, gf) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            lj, jnp.asarray(feats, jnp.float32))
        ref = (o, gf, jax_leaves(gl))
        got = _port_layer_grads(lt, feats.astype(np.float32), *_bcsr_vals(tb, A, dA, bs),
                                W.astype(np.float32))
    _check_layer(got, ref, 1e-5, 1e-5)


def test_layer_golden_through_copied_probe_weights():
    """tests/goldens/conv_equiv_fusion_directed_layer.npz: the JAX layer
    from the golden's key seed, its weights copied into the port; the
    probe weights (p6' drawn from p5''s key, the reference quirk) and the
    output at the golden's tolerance (rtol 1e-4, atol 1e-5)."""
    d = np.load(GOLDEN)
    H = int(d["hidden"])
    lj = JLayer(input_dim=H, output_dim=H, key=jr.PRNGKey(int(d["key_seed"])))
    lt = TLayer(H, H, generator=torch.Generator().manual_seed(0))
    copy_jax_to_torch(lj, lt)
    for key, p in (("param6_prime", lt.param6_prime), ("param5_prime", lt.param5_prime),
                   ("linear_w", lt.conv_layer.linear.weight)):
        np.testing.assert_allclose(p.detach().numpy(), d[f"probe_{key}"], rtol=5e-5,
                                   atol=1e-6)
    with torch.no_grad():
        out = lt(torch.tensor(d["feats"]), torch.tensor(d["A"]), torch.tensor(d["dA"]))
    np.testing.assert_allclose(out.numpy(), d["out"], rtol=1e-4, atol=1e-5)
    # The port's own init keeps the quirk: p6' starts equal to p5'.
    fresh = TLayer(H, H, generator=torch.Generator().manual_seed(1))
    assert torch.equal(fresh.param6_prime, fresh.param5_prime)
    assert not torch.equal(fresh.param5_prime, fresh.param5)


# ---------------------------------------------------------------------------
# 4-6. K1, K2 and K11 on the directed basis
# ---------------------------------------------------------------------------

N, B, T = 16, 3, 6


def _field_pair(widths, seed, n=N):
    """JAX and port directed fields of the given widths (input, hidden...,
    output), copied weights; small idx_dim for the unused modules."""
    H = widths[0]
    L = len(widths) - 1
    kw = dict(input_dim=H, hidden_dim=widths[1], output_dim=widths[-1], num_layers=L,
              data_embed_dim=1, num_nodes=n)
    vf_j = JDVF(**kw, idx_dim=4, key=jr.PRNGKey(seed))
    vf_t = TDVF(H, widths[1], widths[-1], L, 1, n, idx_dim=4,
                generator=torch.Generator().manual_seed(0))
    copy_jax_to_torch(vf_j, vf_t)
    return vf_j, vf_t


def _mk_setup(widths, seed):
    rng = np.random.default_rng(seed)
    ts, A = hermite_path(rng, B, T, N)
    assert _asymmetric(A)
    coeffs_j = jax.vmap(j_bhc)(jnp.asarray(ts), jnp.asarray(A))
    t = np.array([ts[b, 1 + b] + 0.37 * (ts[b, 2 + b] - ts[b, 1 + b]) for b in range(B)],
                 np.float32)
    Z = rng.normal(size=(B, N, widths[0])).astype(np.float32)
    G = rng.normal(size=(B, N, widths[-1])).astype(np.float32)
    vf_j, vf_t = _field_pair(widths, seed + 8)
    planes = tuple(torch.tensor(np.asarray(c)) for c in coeffs_j)
    idx, tau = mk.interval(torch.as_tensor(ts), torch.as_tensor(t))
    return dict(ts=ts, t=t, Z=Z, G=G, coeffs_j=coeffs_j, vf_j=vf_j, vf_t=vf_t,
                planes=planes, idx=idx, tau=tau)


WIDTHS = {"square": (8, 8, 8), "trade-like": (8, 8, 8, 8, 96)}


@pytest.mark.parametrize("shape", list(WIDTHS))
def test_plain_k1_directed_matches_jax_megakernel_interpret(shape):
    s = _mk_setup(WIDTHS[shape], seed=0)
    with pltpu.force_tpu_interpret_mode():
        ref = jax.vmap(lambda c, ts_, t_, z: jmk.megakernel_vf_eval(c, ts_, t_, z, s["vf_j"]))(
            s["coeffs_j"], jnp.asarray(s["ts"]), jnp.asarray(s["t"]), jnp.asarray(s["Z"]))
    layers = mk.layer_params(s["vf_t"])
    assert all(lp["basis"].shape == (11, 2) for lp in layers)
    before = mk.megakernel_vf_eval.launches
    got = mk.megakernel_vf_eval(s["planes"], s["idx"], s["tau"], torch.as_tensor(s["Z"]),
                                layers)
    assert mk.megakernel_vf_eval.launches == before  # CPU: plain version
    _close(got, ref, 1e-5, "K1d")


@pytest.mark.parametrize("need_t", [False, True], ids=["no-dtau", "dtau"])
def test_plain_k2_directed_matches_jax_megakernel_bwd_interpret(need_t):
    s = _mk_setup(WIDTHS["square"], seed=1)
    with pltpu.force_tpu_interpret_mode():
        d_t, d_Z, d_vf = jax.vmap(
            lambda c, ts_, t_, z, g: jmkb.megakernel_vf_bwd(c, ts_, t_, z, s["vf_j"], g,
                                                            need_t=need_t))(
            s["coeffs_j"], jnp.asarray(s["ts"]), jnp.asarray(s["t"]), jnp.asarray(s["Z"]),
            jnp.asarray(s["G"]))
    dtau, dZ, per_layer = mkb.megakernel_vf_bwd(
        s["planes"], s["idx"], s["tau"], torch.as_tensor(s["Z"]),
        mk.layer_params(s["vf_t"]), torch.as_tensor(s["G"]), need_tau=need_t)
    _close(dZ, d_Z, 1e-4, "dZ")
    if need_t:
        _close(dtau, d_t, 1e-4, "dtau")
    else:
        assert float(dtau.abs().max()) == 0.0
    for l, (dnw, dnb, dW, dlb, dbasis) in enumerate(per_layer):
        jl = d_vf.gnn_layers[l]
        assert dbasis.shape == (B, 11, 2)
        _close(dnw, jl.conv_layer.norm.weight, 1e-4, f"dnorm_w{l}")
        _close(dnb, jl.conv_layer.norm.bias, 1e-4, f"dnorm_b{l}")
        _close(dW, jl.conv_layer.linear.weight, 1e-4, f"dW{l}")
        _close(dlb, jl.conv_layer.linear.bias, 1e-4, f"dlin_b{l}")
        _close(dbasis, jnp.stack(jl.params, axis=1), 1e-4, f"dbasis{l}")


def test_plain_k11_directed_step_and_grads_match_jax_interpret(backends):
    """The step through the solver's hook (the flag on, the megakernel
    backend: K11's plain version forward, one plain K2 per stage backward)
    against the JAX fused step in interpret mode on one element (Tsit5):
    y1, err, f1 and the gradients of sum(y1 W0 + err W1 + f1 W2) with
    respect to y, f0 and every field parameter."""
    n, H = 12, 8
    rng = np.random.default_rng(5)
    ts, A = hermite_path(rng, 1, T, n)
    assert _asymmetric(A)
    coeffs_j = jax.vmap(j_bhc)(jnp.asarray(ts), jnp.asarray(A))
    t = (ts[:, 1] + 0.05).astype(np.float32)
    h = np.array([0.17], np.float32)
    y = rng.normal(size=(1, n, H)).astype(np.float32)
    f0 = (0.1 * rng.normal(size=(1, n, H))).astype(np.float32)
    W = [rng.normal(size=(1, n, H)).astype(np.float32) for _ in range(3)]
    vf_j, vf_t = _field_pair((H, H, H), 6, n=n)

    ops.set_fusion_backend("megakernel")
    ops.set_fused_step(True)
    ctrl = MatrixControl(CubicInterpolation(
        torch.as_tensor(ts), tuple(torch.tensor(np.asarray(c)) for c in coeffs_j)))
    yt, f0t = torch.tensor(y, requires_grad=True), torch.tensor(f0, requires_grad=True)
    before = tfs.fused_step_call.launches
    outs = _rk_step(get_tableau("tsit5"), vf_t, torch.tensor(t), yt, torch.tensor(h), ctrl,
                    f0t)
    assert tfs.fused_step_call.launches == before  # CPU: the plain version
    loss = sum((o * torch.tensor(w)).sum() for o, w in zip(outs, W))
    names = [k for k, _ in vf_t.named_parameters()]
    grads = torch.autograd.grad(loss, [yt, f0t] + [p for _, p in vf_t.named_parameters()],
                                allow_unused=True)
    got = dict(zip(["y", "f0"] + names, grads))

    tab = jtab.get_tableau("Tsit5")
    jctrl = JMatrixControl(JCubic(jnp.asarray(ts[0]), tuple(c[0] for c in coeffs_j)))

    def f(y_, f0_, vf):
        return jfs.fused_rk_step(tab, tuple(jctrl.path.coeffs), jctrl.path.ts,
                                 jnp.asarray(t[0]), y_, jnp.asarray(h[0]), f0_, vf)

    def jloss(y_, f0_, vf):
        o = f(y_, f0_, vf)
        return sum(jnp.sum(a * w[0]) for a, w in zip(o, W)), o

    with pltpu.force_tpu_interpret_mode():
        (_, ref), (gy, gf0, gvf) = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(y[0]), jnp.asarray(f0[0]), vf_j)
    # err is h times a sum of stage derivatives whose weights cancel (the
    # embedded pair's difference), so its own scale is small: 1e-4 there.
    for name, a, r, tol in zip(("y1", "err", "f1"), outs, ref, (1e-5, 1e-4, 1e-5)):
        _close(a[0], r, tol, name)
    _close(got["y"][0], gy, 1e-4, "dy")
    _close(got["f0"][0], gf0, 1e-4, "df0")
    jl = jax_leaves(gvf)
    for name in names:
        ref_g = jl[name.replace(".", "/")]
        if got[name] is None:  # idx_enc and the MLPs: unused, zero in JAX
            assert not np.abs(ref_g).any(), name
        else:
            _close(got[name], ref_g, 1e-4, name)


@pytest.mark.parametrize("stack", ["undirected", "directed", "seven", "mixed"])
def test_kernel_input_check_takes_one_basis_per_stack(stack):
    """The check K1, K2 and K11 run before every launch on the card: an
    (8, 2) or an (11, 2) basis, one size for the whole stack (it gives the
    kernels' ``directed`` flag); another shape, or a stack that mixes the
    two, raises. The check alone runs here; no kernel is built or called."""
    n, b, H = 8, 2, 4
    planes = tuple(torch.zeros((b, T - 1, n, n)) for _ in range(4))
    idx, tau = torch.zeros(b, dtype=torch.long), torch.zeros(b)
    Z = torch.zeros((b, n, H))
    sizes = {"undirected": (8, 8), "directed": (11, 11), "seven": (7, 7),
             "mixed": (8, 11)}[stack]
    layers = [dict(norm_w=torch.ones(H), norm_b=torch.zeros(H), W=torch.zeros((H, H)),
                   lin_b=torch.zeros(H), basis=torch.zeros((p, 2))) for p in sizes]
    if stack in ("undirected", "directed"):
        assert mk._check_inputs(planes, idx, tau, Z, layers) == sizes[0]
    else:
        with pytest.raises(ValueError, match=r"\(8, 2\) or \(11, 2\)"):
            mk._check_inputs(planes, idx, tau, Z, layers)


# ---------------------------------------------------------------------------
# 7. The directed tiled eval
# ---------------------------------------------------------------------------


def test_directed_tiled_vf_eval_matches_jax(monkeypatch):
    """tiled_vf_eval of the directed field (its column-sum rank terms from
    the cached reductions) against the JAX eval, values and the parameter
    and Z gradients, with the JAX K3 on its ragged path."""
    n, H, L, Bt, tile = 90, 4, 2, 2, 64
    real = jt._fwd2_call
    monkeypatch.setattr(jt, "_fwd2_call", lambda A, dA, cvec, M, **kw: real(
        A[:n, :n], dA[:n, :n], cvec, M, **kw))
    rng = np.random.default_rng(7)
    ts, A = hermite_path(rng, Bt, 5, n)
    assert _asymmetric(A)
    t = (ts[:, 1] + np.array([0.03, 0.11])).astype(np.float32)
    Z = rng.normal(size=(Bt, n, H)).astype(np.float32)
    W = rng.normal(size=(Bt, n, H)).astype(np.float32)
    coeffs = [j_bhc(jnp.asarray(ts[b]), jnp.asarray(A[b])) for b in range(Bt)]
    vf_j, vf_t = _field_pair((H,) * (L + 1), 9, n=n)

    def jloss(vf, Zb):
        outs = [jt.tiled_vf_eval(tuple(coeffs[b]), jnp.asarray(ts[b]), jnp.asarray(t[b]),
                                 Zb[b], vf, red=jt.cubic_plane_reductions(coeffs[b]),
                                 tile=tile) for b in range(Bt)]
        return sum(jnp.sum(o * W[b]) for b, o in enumerate(outs)), jnp.stack(outs)

    (_, ref), (g_vf, g_Z) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        vf_j, jnp.asarray(Z))
    planes = tuple(torch.tensor(np.stack([np.asarray(c[k]) for c in coeffs])) for k in range(4))
    Zt = torch.tensor(Z).requires_grad_(True)
    out = tt.tiled_vf_eval(planes, torch.tensor(ts), torch.tensor(t), Zt, vf_t,
                           red=tt.cubic_plane_reductions(planes))
    (out * torch.tensor(W)).sum().backward()
    _close(out, ref, 1e-4, "value")
    _close(Zt.grad, g_Z, 1e-4, "dZ")
    jl = jax_leaves(g_vf)
    for name, p in vf_t.named_parameters():
        if p.grad is None:
            assert not np.abs(jl[name.replace(".", "/")]).any(), name
        else:
            _close(p.grad, jl[name.replace(".", "/")], 1e-4, name)


# ---------------------------------------------------------------------------
# 8-9. Parameter order, save_weights, configs and the enc_idx build
# ---------------------------------------------------------------------------


def _cfg(name):
    return common.safe_load((ROOT / "configs" / "tgb" / name).read_text())


def _tgb_model_cfg(n=6):
    return dict(name="tgb_graph_neural_cde", hidden_dim=4, interpolation="cubic",
                method="Tsit5", return_sequence=False, dt0=0.1,
                vector_field=dict(name="PermEquivDirGraphVectorField", hidden_dim=4,
                                  num_layers=2, data_embed_dim=2, num_nodes=n))


def test_field_and_tgb_model_follow_jax_flatten_order(tmp_path):
    """jax_leaf_names of the directed field and of the TGB model list the
    parameters in JAX flatten order (the primed basis parameters between
    the unprimed ones; the unused idx_enc and both MLPs after the layers,
    at the field's default idx_dim 512, as the JAX config builds them
    without enc_idx), so a JAX save_weights file loads into the port and
    the port writes the same file back."""
    vf_j, vf_t = _field_pair((4, 4, 4), 1, n=6)
    names = convert.jax_leaf_names(vf_t)
    assert names == [k.replace("/", ".") for k in jax_leaves(vf_j)]
    assert names[:12] == [f"gnn_layers.0.{p}" for p in TLayer.JAX_FIELDS[:11]] + [
        "gnn_layers.0.conv_layer.linear.weight"]
    assert any(k.startswith("idx_enc.") for k in names)
    assert any(k.startswith("msg_func_adj_deriv.") for k in names)

    model_j = JModelCfg(**_tgb_model_cfg()).build(jr.PRNGKey(2))
    path = str(tmp_path / "w.npz")
    tree_serialise_leaves(path, model_j)
    model_t = TGBGraphNeuralCDECfg.from_dict(_tgb_model_cfg()).build(
        torch.Generator().manual_seed(0))
    assert model_t.vector_field.idx_enc.module.layers[-1].weight.shape == (512, 8)
    convert.load_jax_npz(model_t, path)
    ref = TGBGraphNeuralCDECfg.from_dict(_tgb_model_cfg()).build(
        torch.Generator().manual_seed(1))
    copy_jax_to_torch(model_j, ref)
    for (k, a), (_, b) in zip(model_t.state_dict().items(), ref.state_dict().items()):
        assert torch.equal(a, b), k
    convert.save_jax_npz(model_t, str(tmp_path / "w2.npz"))
    j, t = np.load(path), np.load(str(tmp_path / "w2.npz"))
    assert sorted(j.files) == sorted(t.files)
    for k in j.files:
        np.testing.assert_array_equal(j[k], t[k])


def test_directed_configs_build_and_enc_idx_is_refused():
    """trade_perm_equiv_dir_gncde.yaml (n=255, 32 x 4 -> 512) and
    genre_perm_equiv_dir_gncde.yaml (n=1505, 8 -> 8 -> 8 -> 128) build at
    full width; the three *_dir_enc_idx* configs, which refused until the
    directed enc_idx field was ported, now build too (enc_idx set, the same
    layer widths under the H * E * 2 rule), and so do ``VectorFieldCfg``
    and the field constructor with enc_idx. The name is kept from when the
    enc_idx configs refused."""
    for name, n, outs in (("trade_perm_equiv_dir_gncde.yaml", 255, [32, 32, 32, 512]),
                          ("genre_perm_equiv_dir_gncde.yaml", 1505, [8, 8, 128])):
        for enc in (False, True):
            if enc:
                name = name.replace("_dir_", "_dir_enc_idx_")
            model = TGBGraphNeuralCDECfg.from_dict(_cfg(name)["model"]).build(
                torch.Generator().manual_seed(0))
            vf = model.vector_field
            assert isinstance(vf, TDVF) and vf.num_nodes == n and vf.enc_idx == enc
            assert [l.conv_layer.linear.out_features for l in vf.gnn_layers] == outs
            assert all(len(l.params) == 11 for l in vf.gnn_layers)
    cfg = _cfg("genre_synth_perm_equiv_dir_enc_idx_gncde.yaml")["model"]
    assert TGBGraphNeuralCDECfg.from_dict(cfg).build(
        torch.Generator().manual_seed(0)).vector_field.enc_idx
    vcfg = VectorFieldCfg.from_dict(dict(name="PermEquivDirGraphVectorField", enc_idx=True,
                                         hidden_dim=4, data_embed_dim=2, num_layers=2,
                                         num_nodes=6, idx_dim=4))
    assert vcfg.build(torch.Generator().manual_seed(0)).enc_idx
    vf = TDVF(4, 4, 4, 2, 1, 6, enc_idx=True, generator=torch.Generator())
    assert vf.enc_idx and vf.idx_enc.type == "mlp"


# ---------------------------------------------------------------------------
# 10. chip_smoke.py's phase 17 route check
# ---------------------------------------------------------------------------


def test_chip_smoke_directed_route_check_at_n25(tmp_path):
    """``chip_smoke.directed_route_errors`` on the CPU at n=25 (BCSR block
    size 8): the directed flagship field at the trainer's init through the
    pipeline and pallas backends and the BCSR and ELL controls against the
    default route, value and gradients (state and every field parameter),
    within the script's own bounds (1e-4 and 1e-3 of max|ref|). The
    flagship's graph events are drawn per entry, so its A is asymmetric."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    from gncde_tpu_torch.train.trainer import Trainer

    with open(ROOT / chip_smoke.FLAGSHIP) as f:
        cfg = common.apply_overrides(common.safe_load(f.read()), [
            f"dataset.cache_dir={tmp_path}", "dataset.num_nodes=25", "device=cpu",
            *chip_smoke.DIRECTED_FIELD])
    tr = Trainer.from_dict(cfg)
    d = tr.dataset.get_training_data()
    model = tr.model.build(torch.Generator().manual_seed(tr.seed))
    assert isinstance(model.vector_field, TDVF)
    A = d["train_graph_path_coeffs"][3][..., -1]  # the planes' constant terms
    assert _asymmetric(A.numpy())
    with torch.no_grad():
        y = model.initial_linear(d["true_y0"])
    errs = chip_smoke.directed_route_errors(
        torch, model, y, d["train_t"], d["train_graph_path_coeffs"], tr.model.interpolation,
        block_size=8)
    assert set(errs) == set(chip_smoke.DIRECTED_ROUTES)
    for route, (vf_err, grad_errs) in errs.items():
        # y and every layer parameter (idx_enc and the MLPs get none).
        assert len(grad_errs) == 1 + len(list(model.vector_field.gnn_layers.parameters()))
        assert vf_err <= chip_smoke.SPARSE_VF_TOL, (route, vf_err)
        assert max(grad_errs.values()) <= chip_smoke.SPARSE_GRAD_TOL, (route, grad_errs)
