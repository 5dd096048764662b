"""Port parity of the tiled regime (gncde_tpu_torch/ops/tiled.py) against
the JAX package's gncde_tpu/ops/pallas/tiled.py, on the CPU: the plain
versions of K3 (fwd2), K4 (bwd2), K5a (dw2) and K5b (dw) against the Pallas
kernels in interpret mode, the autograd Function's four backward branches
against the custom VJP, and ``tiled_vf_eval`` (values and the parameter, Z
and t gradients) against the JAX eval. Inputs are made with numpy from a
seed and given to both sides.

The JAX side always runs K3 on its ragged path (planes cut to n, the
overhang masked in the kernel; ``_jax_k3_ragged``). In interpret mode on
XLA's CPU backend, K3's non-ragged path (the one the JAX ``tiled_vf_eval``
takes on its zero-padded planes) returns a colpart ``B2^T M`` up to 2.5e-3 off the
f32 product of the bf16-rounded operands (measured at n=128), while the
ragged path and the port agree to 1e-7. On the TPU both paths are one MXU
product; the interpret-mode difference is XLA's, so the tests avoid it.

Tolerances, each against the largest magnitude of the reference array:
* 1e-5 for the kernels: bf16 inputs on both sides and B1/B2 formed with the
  same bf16 roundings, so only the order of the f32 sums differs;
* 1e-4 for the primitive's gradients and for the vf eval's values and
  gradients, which add the f32 rank terms and the chain through layers;
* 2e-2 (values) and 5e-2 (gradients) against the port's own dense f32 path
  at n=648, as the JAX package's tests hold its tiled path against its
  dense one: the tiled path's bf16 operands (2^-9 relative each) sum over n.
"""

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from gncde_tpu.interp import backward_hermite_coefficients as j_bhc
from gncde_tpu.models.vector_fields import PermEquivGraphVectorField as JVF
from gncde_tpu.ops.pallas import tiled as jt
from gncde_tpu_torch import ops
from gncde_tpu_torch.interp import CubicInterpolation, MatrixControl
from gncde_tpu_torch.models.vector_fields import PermEquivGraphVectorField as TVF
from gncde_tpu_torch.ops import _build
from gncde_tpu_torch.ops import megakernel as mk
from gncde_tpu_torch.ops import tiled as tt

from torch_parity_utils import copy_jax_to_torch, hermite_path, jax_leaves

KERNEL_TOL = 1e-5
VF_TOL = 1e-4


@pytest.fixture
def _jax_k3_ragged(monkeypatch):
    """Run the JAX package's K3 on its ragged path: ``fn(n)`` makes every
    ``_fwd2_call`` see the planes cut back to the logical n."""
    real = jt._fwd2_call

    def use(n):
        monkeypatch.setattr(jt, "_fwd2_call", lambda A, dA, cvec, M, **kw: real(
            A[:n, :n], dA[:n, :n], cvec, M, **kw))

    return use


def _close(got, ref, tol, what=""):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err, scale = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    assert err <= tol * max(scale, 1e-30), f"{what}: max abs err {err:.3e} > {tol} x {scale:.3e}"


def _kernel_inputs(n, tile, H, seed=0):
    """bf16 planes and vectors, JAX-padded (to the JAX tile) and unpadded
    for the port, and four f32 slabs."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(-0.05, 0.3, (n, n)).astype(np.float32)
    dA = rng.normal(0.0, 0.2, (n, n)).astype(np.float32)
    M = rng.normal(size=(n, H)).astype(np.float32)
    G = rng.normal(size=(n, H)).astype(np.float32)
    slabs = [rng.normal(0.0, 0.1, (n, n)).astype(np.float32) for _ in range(4)]
    cvec = np.array([1.03, 0.071, -0.044, 0.052], np.float32)
    NPj = jt._cdiv(n, tile) * tile

    def jvec(x):
        return jnp.zeros((NPj, H), jnp.bfloat16).at[:n].set(jnp.asarray(x).astype(jnp.bfloat16))

    def bf16(x):
        return torch.tensor(x)[None].to(torch.bfloat16)

    j = dict(A=jnp.asarray(A).astype(jnp.bfloat16), dA=jnp.asarray(dA).astype(jnp.bfloat16),
             M=jvec(M), G=jvec(G), slabs=tuple(jnp.asarray(s) for s in slabs),
             cvec=jnp.asarray(cvec).reshape(1, 4))
    t = dict(A=bf16(A), dA=bf16(dA), M=bf16(M), G=bf16(G),
             slabs=tuple(torch.tensor(s)[None] for s in slabs), cvec=torch.tensor(cvec))
    return j, t


SHAPES = [(100, 32, 4), (130, 64, 16)]
SHAPE_IDS = ["n100-tile32-H4", "n130-tile64-H16"]


@pytest.mark.parametrize("n,tile,H", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("kernel", ["K3", "K4", "K5a", "K5b"])
def test_plain_kernel_matches_pallas(kernel, n, tile, H):
    j, t = _kernel_inputs(n, tile, H)
    kw = dict(tile=tile, interpret=True)
    if kernel == "K3":
        ref = jt._fwd2_call(j["A"], j["dA"], j["cvec"], j["M"], **kw)
        got = tt.fwd2_call(t["A"], t["dA"], t["cvec"], t["M"])
        pairs = [(got[0][0], ref[0][:n]), (got[1][0], ref[1][:n])]
    elif kernel == "K4":
        ref = jt._bwd2_call(j["A"], j["dA"], j["cvec"], j["G"], j["M"], **kw)
        got = tt.bwd2_call(t["A"], t["dA"], t["cvec"], t["G"], t["M"])
        pairs = [(got[0][0], ref[0][:n]), (got[1][0], ref[1][:n]),
                 (got[2][0], ref[2][0])]
    elif kernel == "K5a":
        ref = jt._dw2_call(j["A"], j["dA"], j["G"], j["M"], **kw)
        pairs = [(tt.dw2_call(t["A"], t["dA"], t["G"], t["M"])[0], ref[0])]
    else:
        ref = jt._dw_call(j["slabs"], j["G"], j["M"], **kw)
        pairs = [(tt.dw_call(t["slabs"], t["G"], t["M"])[0], ref[0])]
    for got_, ref_ in pairs:
        _close(got_.detach(), ref_, KERNEL_TOL)


BRANCHES = {
    # branch: (inputs that need a gradient, plain kernel the backward runs)
    "merged-K4": (("c_row", "c_col", "M"), "plain_bwd2"),
    "dM-K3": (("M",), "plain_fwd2"),
    "c-K5a": (("c_row", "c_col"), "plain_dw2"),
    "tau-K5b": (("w", "c_row", "M"), "plain_dw"),
}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_tiled_fused2_backward_branches_match_jax(branch, monkeypatch, _jax_k3_ragged):
    """Each branch of TiledFused2.backward against the JAX custom VJP, and
    the plain kernel it dispatches to."""
    n, H, tile = 70, 5, 64
    need, kernel = BRANCHES[branch]
    _jax_k3_ragged(n)
    rng = np.random.default_rng(1)
    slabs = [rng.normal(0.0, 0.2, (n, n)).astype(np.float32) for _ in range(4)]
    tau = np.float32(0.37)
    M = rng.normal(size=(n, H)).astype(np.float32)
    c_row = np.array([1.1, -0.06], np.float32)
    c_col = np.array([0.05, 0.08], np.float32)
    W = rng.normal(size=(n, H)).astype(np.float32)  # loss weights

    wA_j, wdA_j = jt.hermite_weights(jnp.float32(tau))
    A = sum(w * s for w, s in zip(np.asarray(wA_j), slabs))
    dA = sum(w * s for w, s in zip(np.asarray(wdA_j), slabs))
    NPj = tile * -(-n // tile)

    def jloss(w_pair, cr, cc, Mp):
        wA_, wdA_ = w_pair
        out = jt.tiled_fused2(
            jnp.zeros((NPj, NPj), jnp.bfloat16).at[:n, :n].set(jnp.asarray(A).astype(jnp.bfloat16)),
            jnp.zeros((NPj, NPj), jnp.bfloat16).at[:n, :n].set(jnp.asarray(dA).astype(jnp.bfloat16)),
            tuple(jnp.asarray(s) for s in slabs), wA_, wdA_, cr, cc, Mp, tile)
        return jnp.sum(out[:n] * jnp.asarray(W))

    argn = {"w": 0, "c_row": 1, "c_col": 2, "M": 3}
    Mp_j = jnp.zeros((NPj, H)).at[:n].set(jnp.asarray(M))
    jgrads = jax.grad(jloss, argnums=tuple(argn[k] for k in need))(
        (wA_j, wdA_j), jnp.asarray(c_row), jnp.asarray(c_col), Mp_j)

    def plane(x):
        return torch.tensor(x)[None].to(torch.bfloat16)

    ins = {"w": [torch.tensor(np.asarray(wA_j))[None], torch.tensor(np.asarray(wdA_j))[None]],
           "c_row": torch.tensor(c_row), "c_col": torch.tensor(c_col),
           "M": torch.tensor(M)[None]}
    leaves = []
    for k in need:
        for x in (ins[k] if k == "w" else [ins[k]]):
            x.requires_grad_(True)
            leaves.append(x)
    out = tt.tiled_fused2(plane(A), plane(dA), tuple(torch.tensor(s)[None] for s in slabs),
                          ins["w"][0], ins["w"][1], ins["c_row"], ins["c_col"], ins["M"])
    calls = []
    real = getattr(tt, kernel)
    monkeypatch.setattr(tt, kernel, lambda *a: calls.append(kernel) or real(*a))
    (out[0] * torch.tensor(W)).sum().backward()
    assert calls == [kernel]

    got = iter(leaves)
    for k, g in zip(need, jgrads):
        if k == "w":
            _close(next(got).grad[0], g[0], VF_TOL, "dwA")
            _close(next(got).grad[0], g[1], VF_TOL, "dwdA")
        elif k == "M":
            _close(next(got).grad[0], g[:n], VF_TOL, "dM")
        else:
            _close(next(got).grad, g, VF_TOL, k)


def _vf_pair(n, H, L, seed):
    vf_j = JVF(input_dim=H, hidden_dim=H, output_dim=H, num_layers=L,
               data_embed_dim=1, num_nodes=n, key=jr.PRNGKey(seed))
    vf_t = TVF(H, H, H, L, 1, n, generator=torch.Generator().manual_seed(0))
    copy_jax_to_torch(vf_j, vf_t)
    return vf_j, vf_t


@pytest.mark.parametrize("time_grad", [False, True], ids=["train-grads", "with-t-grad"])
@pytest.mark.parametrize("with_red", [False, True], ids=["no-red", "red"])
def test_tiled_vf_eval_matches_jax(with_red, time_grad, monkeypatch, _jax_k3_ragged):
    """Values, parameter and Z gradients (the training backward: merged K4)
    and, with ``time_grad``, the t gradient too (the K5b branch)."""
    n, H, L, B, T, tile = 100, 4, 2, 2, 5, 64
    _jax_k3_ragged(n)
    rng = np.random.default_rng(2)
    ts, A = hermite_path(rng, B, T, n)
    t = (ts[:, 1] + np.array([0.03, 0.11])).astype(np.float32)
    Z = rng.normal(size=(B, n, H)).astype(np.float32)
    W = rng.normal(size=(B, n, H)).astype(np.float32)
    coeffs = [j_bhc(jnp.asarray(ts[b]), jnp.asarray(A[b])) for b in range(B)]
    vf_j, vf_t = _vf_pair(n, H, L, seed=4)

    def jloss(vf, Zb, tb):
        total = 0.0
        for b in range(B):
            red = jt.cubic_plane_reductions(coeffs[b]) if with_red else None
            out = jt.tiled_vf_eval(tuple(coeffs[b]), jnp.asarray(ts[b]), tb[b], Zb[b], vf,
                                   red=red, tile=tile)
            total = total + jnp.sum(out * W[b])
        return total

    argnums = (0, 1, 2) if time_grad else (0, 1)
    jgrads = jax.grad(jloss, argnums=argnums)(vf_j, jnp.asarray(Z), jnp.asarray(t))
    ref = [jt.tiled_vf_eval(tuple(coeffs[b]), jnp.asarray(ts[b]), jnp.asarray(t[b]),
                            jnp.asarray(Z[b]), vf_j, tile=tile) for b in range(B)]

    planes = tuple(torch.tensor(np.stack([np.asarray(c[k]) for c in coeffs])) for k in range(4))
    red = tt.cubic_plane_reductions(planes) if with_red else None
    Zt = torch.tensor(Z).requires_grad_(True)
    tt_ = torch.tensor(t).requires_grad_(time_grad)
    calls = []
    for kernel in ("plain_bwd2", "plain_dw"):
        real = getattr(tt, kernel)
        monkeypatch.setattr(tt, kernel,
                            lambda *a, k=kernel, f=real: calls.append(k) or f(*a))
    out = tt.tiled_vf_eval(planes, torch.tensor(ts), tt_, Zt, vf_t, red=red)
    (out * torch.tensor(W)).sum().backward()
    # One backward sweep per layer: merged K4 when training, K5b with dt.
    assert calls == ["plain_dw" if time_grad else "plain_bwd2"] * L

    _close(out.detach(), np.stack([np.asarray(r) for r in ref]), VF_TOL, "value")
    _close(Zt.grad, jgrads[1], VF_TOL, "dZ")
    jl = jax_leaves(jgrads[0])
    for name, p in vf_t.named_parameters():
        _close(p.grad, jl[name.replace(".", "/")], VF_TOL, name)
    if time_grad:
        _close(tt_.grad, jgrads[2], VF_TOL, "dt")


def test_megakernel_backend_dispatches_n648_to_the_tiled_path(monkeypatch):
    """The field at n=648 (> MEGAKERNEL_MAX_N) under the megakernel backend
    goes through tiled_vf_eval (here its plain kernels) and agrees with the
    port's dense path, value and gradients.

    Width 8, not 4: with 4 features a row that the first ReLU zeroes (about
    one row in 16) reaches the second layer's RMSNorm with an rms near
    sqrt(eps), which multiplies the bf16 rounding of that row by about 1e3;
    the gradients of both paths then differ by more than 100% (measured), a
    property of the network, not of the port."""
    n, H, L, T = 648, 8, 2, 4
    rng = np.random.default_rng(3)
    ts, A = hermite_path(rng, 1, T, n)
    coeffs = j_bhc(jnp.asarray(ts[0]), jnp.asarray(A[0]))
    ctrl = MatrixControl(CubicInterpolation(
        torch.tensor(ts), tuple(torch.tensor(np.asarray(c))[None] for c in coeffs)))
    vf = TVF(H, H, H, L, 1, n, generator=torch.Generator().manual_seed(3))
    Z = torch.tensor(rng.normal(size=(1, n, H)).astype(np.float32))
    t = torch.tensor(ts[:, 1] + 0.05)
    calls = []
    real = tt.tiled_vf_eval
    monkeypatch.setattr(tt, "tiled_vf_eval", lambda *a, **k: calls.append(1) or real(*a, **k))
    results = {}
    try:
        for name in ("dense", "megakernel"):
            ops.set_fusion_backend(name)
            vf.zero_grad()
            Zr = Z.clone().requires_grad_(True)
            out = vf(t, Zr, ctrl)
            (out * out).sum().backward()
            results[name] = [out.detach(), Zr.grad] + [p.grad.clone() for p in vf.parameters()]
    finally:
        ops.set_fusion_backend("auto")
    assert calls == [1]
    assert n > mk.MEGAKERNEL_MAX_N
    _close(results["megakernel"][0], results["dense"][0], 2e-2)
    for a, b in zip(results["megakernel"][1:], results["dense"][1:]):
        _close(a, b, 5e-2)


@pytest.mark.parametrize("B,n,H,want", [
    (1, 1505, 128, 5), (1, 1505, 8, 5), (2, 300, 5, 2), (1, 17, 1, 1),
    (3, 641, 136, 2), (1, 641, 8, 5), (4, 2048, 128, 1)])
def test_k3_split_plan(B, n, H, want):
    """K3's launch plan (``fwd2_splits``): the genre layer (B = 1, 24 row
    blocks a pass) splits its reduce extent to fill two CTAs per SM of the
    132; a grid that fills the card alone, or a short reduce extent (at
    least four 32-deep tiles a part), is not split."""
    S = tt.fwd2_splits(B, n, H)
    assert S == want
    ctas = 2 * B * -(-n // tt.FWD2_BO) * -(-H // tt.fwd2_chunk(H)) * S
    assert S == 1 or ctas <= 2 * _build.SMS
    assert 1 <= S <= max(1, -(-n // tt.FWD2_BK) // 4)
    assert [tt.fwd2_chunk(h) for h in (1, 8, 9, 32, 33, 128, 136)] == [8, 8, 32, 32, 128,
                                                                     128, 128]


def test_k3_wrapper_on_cpu_runs_its_plain_version(monkeypatch):
    """On CPU tensors fwd2_call is plain_fwd2 (whatever the split plan says)
    and counts no launch."""
    rng = np.random.default_rng(0)
    A, dA = (torch.tensor(rng.normal(size=(1, 20, 20)).astype(np.float32)).to(torch.bfloat16)
             for _ in range(2))
    M = torch.tensor(rng.normal(size=(1, 20, 3)).astype(np.float32)).to(torch.bfloat16)
    cvec = torch.tensor([1.0, 0.1, -0.2, 0.3])
    monkeypatch.setattr(tt, "fwd2_splits", lambda B, n, H: 3)
    before = tt.fwd2_call.launches
    for got, ref in zip(tt.fwd2_call(A, dA, cvec, M), tt.plain_fwd2(A, dA, cvec, M)):
        assert torch.equal(got, ref)
    assert tt.fwd2_call.launches == before
