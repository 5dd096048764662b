"""The port's CUDA kernels against their plain PyTorch versions: K1 and K2
(the vector-field kernels, n <= 640), K3, K4, K5a, K5b, K5c (the tiled
regime's plane sweeps and the 4-slab apply, ``csrc/tiled.cu``), the enc_idx
path's K7 (modulation, ``csrc/modulate.cu``), K6a and K6b (plane pair,
``csrc/tiled.cu``), the sparse controls' K8 and K9 (BCSR SpMM and SDDMM,
``csrc/bcsr.cu``) and K10 (ELL SpMM, ``csrc/ell_spmm.cu``), the fused RK
step K11 (``csrc/fused_step.cu``) and the per-layer fused applies K12 and
K13 (``csrc/fused_apply.cu``).

These tests need a CUDA card (marker ``requires_cuda``) and skip without
one. The file imports neither jax nor the JAX package, so it runs on a GPU
machine that has only torch:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which pins JAX to the CPU.)
The parity of the plain versions with the JAX megakernels is held on the
CPU by ``tests/test_torch_megakernel.py``.

Tolerances: f32 on both sides; the kernels sum over n (forward) and over
n and the batch (cotangents) in another order than the dense version, so
the forward is held to 1e-4 and every cotangent to 1e-3 of its own scale.
The tiled kernels and their plain versions take the same bf16 operands and
form B1/B2 with the same roundings; only the order of the f32 sums differs,
so they are held to 1e-4 of each output's scale, and the field's tiled path
(kernels on the card against the plain versions on the CPU) to 1e-3. K7 has
no reductions (1e-5); K6a/K6b take f32 planes and vectors on both sides and
sum in another order (1e-4); the enc_idx field on its kernels against its
dense path 1e-4 for values and 1e-3 for gradients, as K1/K2. K8, K9 and
K10 are f32 on both sides and sum in another order (1e-4); their autograd
functions against autograd of the plain versions 1e-4. K11 against its plain
version 1e-4 of max|ref| per output (K1's sums in another order, compounded
over the stages), its backward 1e-3 (K2's); K12, K13 and K5c 1e-4 (f32 or
the same bf16 operands; summation order).
"""

import numpy as np
import pytest
import torch

from gncde_tpu_torch import ops
from gncde_tpu_torch.interp import CubicInterpolation, MatrixControl
from gncde_tpu_torch.models.vector_fields import PermEquivGraphVectorField as TVF
from gncde_tpu_torch.ops import bcsr as tb
from gncde_tpu_torch.ops import ell_spmm as tell
from gncde_tpu_torch.ops import megakernel as mk
from gncde_tpu_torch.ops import megakernel_bwd as mkb
from gncde_tpu_torch.ops import modulate as tmod
from gncde_tpu_torch.ops import fused_basis as tfb
from gncde_tpu_torch.ops import fused_step as tfs
from gncde_tpu_torch.ops import pair as tp
from gncde_tpu_torch.ops import pipeline as tpl
from gncde_tpu_torch.ops import sparse as tsp
from gncde_tpu_torch.ops import tiled as tt
from gncde_tpu_torch.nn import MLP

# n = 40 is neither a multiple of the 16-row CTA block nor of the 32-wide
# k-tile, so every edge tile is exercised.
N, B, T = 40, 3, 6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1/K2 kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, widths, per_element=True, seed=0):
    """Planes, per-element (idx, tau), node state, layer params and an
    output cotangent, made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    lead = (B, T - 1) if per_element else (T - 1,)
    planes = tuple(t(rng.uniform(-0.05, 0.1, lead + (N, N))) for _ in range(4))
    idx = torch.tensor(rng.permutation(T - 1)[:B], device=dev)
    tau = t(rng.uniform(0.0, 0.2, B))
    Z = t(rng.normal(size=(B, N, widths[0])))
    layers = []
    for hin, hout in zip(widths[:-1], widths[1:]):
        lim = 1.0 / np.sqrt(hin)
        layers.append(dict(
            norm_w=t(1.0 + 0.1 * rng.normal(size=hin)),
            norm_b=t(0.1 * rng.normal(size=hin)),
            W=t(rng.uniform(-lim, lim, (hout, hin))),
            lin_b=t(rng.uniform(-lim, lim, hout)),
            basis=t(rng.uniform(-1 / 15, 1 / 15, (8, 2))),
        ))
    G = t(rng.normal(size=(B, N, widths[-1])))
    return planes, idx, tau, Z, layers, G


def _assert_close(got, ref, tol):
    scale = float(ref.abs().max())
    assert got.shape == ref.shape
    assert float((got - ref).abs().max()) <= tol * scale


# trade-widths: the CDE-wrapper field of configs/tgb/trade_*perm_equiv_gncde*
# (32 -> 32 -> 32 -> 32 -> 32 * 8 * 2), whose last layer is swept in 8
# chunks of 64 columns.
CASES = [((8, 8, 8), True), ((5, 8, 3), True), ((8, 8, 8), False),
         ((32, 32, 32, 32, 512), True)]
IDS = ["square-per-element", "widths-5-8-3", "shared-planes", "trade-widths"]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("widths,per_element", CASES, ids=IDS)
def test_cuda_k1_matches_plain(cuda, widths, per_element):
    planes, idx, tau, Z, layers, _ = _inputs(cuda, widths, per_element)
    before = mk.megakernel_vf_eval.launches
    got = mk.megakernel_vf_eval(planes, idx, tau, Z, layers)
    ref = mk.plain_vf_eval(planes, idx, tau, Z, layers)
    torch.cuda.synchronize()
    assert mk.megakernel_vf_eval.launches == before + 1
    _assert_close(got, ref, 1e-4)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("need_tau", [False, True])
@pytest.mark.parametrize("widths,per_element", CASES, ids=IDS)
def test_cuda_k2_matches_plain(cuda, widths, per_element, need_tau):
    planes, idx, tau, Z, layers, G = _inputs(cuda, widths, per_element, seed=1)
    before = mkb.megakernel_vf_bwd.launches
    got = mkb.megakernel_vf_bwd(planes, idx, tau, Z, layers, G, need_tau)
    ref = mkb.plain_vf_bwd(planes, idx, tau, Z, layers, G, need_tau)
    torch.cuda.synchronize()
    assert mkb.megakernel_vf_bwd.launches == before + 1
    _assert_close(got[1], ref[1], 1e-3)
    if need_tau:
        _assert_close(got[0], ref[0], 1e-3)
    for gl, rl in zip(got[2], ref[2]):
        for a, b in zip(gl, rl):
            _assert_close(a, b, 1e-3)


@pytest.mark.requires_cuda
def test_cuda_field_megakernel_matches_dense(cuda):
    """The vector field on the card: K1 forward + K2 backward through the
    autograd Function against the dense backend, value and every gradient,
    with a per-element query time that needs its own gradient (dtau)."""
    H = 8
    planes, _, _, Z, _, _ = _inputs(cuda, (H, H), seed=2)
    ts = torch.linspace(0.0, 1.0, T, device=cuda).repeat(B, 1)
    ts[1] *= 1.3  # per-element knots
    ctrl = MatrixControl(CubicInterpolation(ts, planes))
    vf = TVF(H, H, H, 2, 1, N, generator=torch.Generator().manual_seed(0)).to(cuda)
    t0 = torch.tensor([0.1, 0.55, 0.93], device=cuda)
    results = {}
    try:
        for name in ("dense", "megakernel"):
            ops.set_fusion_backend(name)
            vf.zero_grad()
            t = t0.clone().requires_grad_(True)
            Zr = Z.clone().requires_grad_(True)
            launches = mk.megakernel_vf_eval.launches, mkb.megakernel_vf_bwd.launches
            out = vf(t, Zr, ctrl)
            (out * out).sum().backward()
            torch.cuda.synchronize()
            ran = (mk.megakernel_vf_eval.launches - launches[0],
                   mkb.megakernel_vf_bwd.launches - launches[1])
            assert ran == ((1, 1) if name == "megakernel" else (0, 0))
            results[name] = [out.detach(), Zr.grad, t.grad] + [
                p.grad.clone() for p in vf.parameters()]
    finally:
        ops.set_fusion_backend("auto")
    _assert_close(results["megakernel"][0], results["dense"][0], 1e-4)
    for a, b in zip(results["megakernel"][1:], results["dense"][1:]):
        _assert_close(a, b, 1e-3)


@pytest.mark.requires_cuda
def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    """On CUDA tensors a wrapper launches its kernel or raises; it never runs
    the plain version in its place."""
    planes, idx, tau, Z, layers, G = _inputs(cuda, (8, 8))
    with pytest.raises(ValueError):
        mk.megakernel_vf_eval(planes, idx, tau, Z.double(), layers)
    with pytest.raises(ValueError):
        mkb.megakernel_vf_bwd(planes, idx, tau, Z, layers, G[..., :4], True)


# n = 70, 130 and 100 are ragged against the owned blocks and the 32-deep
# reduce tiles; the widths reach each compiled chunk width of csrc/tiled.cu:
# H = 5 (8, not a multiple of 8), H = 16 (32) and H = 130 (128, two sweeps).
TILED_CASES = [(70, 5, 2), (130, 16, 1), (100, 130, 1)]
TILED_IDS = ["n70-H5-B2", "n130-H16", "n100-H130"]


def _tiled_inputs(dev, n, H, B, seed=0):
    """bf16 planes (B, n, n) and vectors (B, n, H), f32 slabs, cvec."""
    rng = np.random.default_rng(seed)

    def bf16(x):
        return torch.tensor(x.astype(np.float32), device=dev).to(torch.bfloat16)

    def plane(scale, loc=0.0):
        return bf16(rng.normal(loc, scale, (B, n, n)))

    def vec():
        return bf16(rng.normal(size=(B, n, H)))

    A, dA, M, G = plane(0.1, 0.05), plane(0.5), vec(), vec()
    slabs = tuple(torch.tensor(rng.normal(0.0, 0.1, (B, n, n)).astype(np.float32),
                               device=dev) for _ in range(4))
    cvec = torch.tensor([1.03, 0.071, -0.044, 0.052], device=dev)
    return A, dA, M, G, slabs, cvec


def _tiled_pair(kernel, A, dA, M, G, slabs, cvec):
    """(kernel outputs, plain outputs) as tuples of tensors."""
    if kernel == "K3":
        return tt.fwd2_call(A, dA, cvec, M), tt.plain_fwd2(A, dA, cvec, M)
    if kernel == "K4":
        return tt.bwd2_call(A, dA, cvec, G, M), tt.plain_bwd2(A, dA, cvec, G, M)
    if kernel == "K5a":
        return (tt.dw2_call(A, dA, G, M),), (tt.plain_dw2(A, dA, G, M),)
    return (tt.dw_call(slabs, G, M),), (tt.plain_dw(slabs, G, M),)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n,H,B", TILED_CASES, ids=TILED_IDS)
@pytest.mark.parametrize("kernel", ["K3", "K4", "K5a", "K5b"])
def test_cuda_tiled_kernel_matches_plain(cuda, kernel, n, H, B):
    ins = _tiled_inputs(cuda, n, H, B)
    wrapper = {"K3": tt.fwd2_call, "K4": tt.bwd2_call, "K5a": tt.dw2_call,
               "K5b": tt.dw_call}[kernel]
    before = wrapper.launches
    got, ref = _tiled_pair(kernel, *ins)
    again, _ = _tiled_pair(kernel, *ins)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    for a, b, c in zip(got, ref, again):
        assert torch.isfinite(a).all()
        _assert_close(a, b, 1e-4)
        assert torch.equal(a, c)  # no atomics: bitwise repeatable


@pytest.mark.requires_cuda
@pytest.mark.parametrize("time_grad", [False, True], ids=["train-grads", "with-t-grad"])
def test_cuda_tiled_vf_eval_matches_plain(cuda, time_grad):
    """tiled_vf_eval through the autograd Function: the kernels on the card
    (K3 forward; K4, or K3 + K5b with a time gradient, backward) against the
    plain versions on the CPU from the same inputs, value and gradients."""
    n, H, L, B, T = 200, 5, 2, 2, 5
    rng = np.random.default_rng(4)
    ts = np.cumsum(rng.uniform(0.1, 0.3, (B, T)), axis=1).astype(np.float32)
    planes = [rng.normal(0.0, 0.05, (B, T - 1, n, n)).astype(np.float32) for _ in range(4)]
    Z = rng.normal(size=(B, n, H)).astype(np.float32)
    t = (ts[:, 1] + 0.07).astype(np.float32)
    vf = TVF(H, H, H, L, 1, n, generator=torch.Generator().manual_seed(0))
    res = {}
    for dev in ("cpu", cuda):
        vf_d = vf.to(dev)
        vf_d.zero_grad()
        Zd = torch.tensor(Z, device=dev).requires_grad_(True)
        td = torch.tensor(t, device=dev).requires_grad_(time_grad)
        launches = tt.fwd2_call.launches, tt.bwd2_call.launches, tt.dw_call.launches
        out = tt.tiled_vf_eval(tuple(torch.tensor(p, device=dev) for p in planes),
                               torch.tensor(ts, device=dev), td, Zd, vf_d)
        (out * out).sum().backward()
        ran = tuple(c.launches - b for c, b in zip(
            (tt.fwd2_call, tt.bwd2_call, tt.dw_call), launches))
        if dev == cuda:
            torch.cuda.synchronize()
            assert ran == ((2 * L, 0, L) if time_grad else (L, L, 0))
        else:
            assert ran == (0, 0, 0)
        res[str(dev)] = [out.detach().cpu(), Zd.grad.cpu()] + [
            p.grad.cpu().clone() for p in vf_d.parameters()] + (
            [td.grad.cpu()] if time_grad else [])
    for a, b in zip(res["cuda"], res["cpu"]):
        _assert_close(a, b, 1e-3)


@pytest.mark.requires_cuda
def test_cuda_field_tiled_regime_matches_dense(cuda):
    """The field at n=648 on the card (the auto backend): K3 forward and K4
    backward against the dense backend, at the tolerances the JAX package
    holds its tiled path to its dense one (bf16 operands)."""
    n, H, L, T = 648, 8, 2, 4
    rng = np.random.default_rng(3)
    ts = torch.tensor(np.cumsum(rng.uniform(0.1, 0.3, (1, T)), axis=1).astype(np.float32),
                      device=cuda)
    planes = tuple(torch.tensor(rng.uniform(0.0, 0.3, (1, T - 1, n, n)).astype(np.float32),
                                device=cuda) for _ in range(4))
    ctrl = MatrixControl(CubicInterpolation(ts, planes))
    vf = TVF(H, H, H, L, 1, n, generator=torch.Generator().manual_seed(3)).to(cuda)
    Z = torch.tensor(rng.normal(size=(1, n, H)).astype(np.float32), device=cuda)
    t = ts[:, 1] + 0.05
    results = {}
    try:
        for name in ("dense", "auto"):
            ops.set_fusion_backend(name)
            vf.zero_grad()
            Zr = Z.clone().requires_grad_(True)
            launches = tt.fwd2_call.launches, tt.bwd2_call.launches
            out = vf(t, Zr, ctrl)
            (out * out).sum().backward()
            torch.cuda.synchronize()
            ran = (tt.fwd2_call.launches - launches[0], tt.bwd2_call.launches - launches[1])
            assert ran == ((L, L) if name == "auto" else (0, 0))
            results[name] = [out.detach(), Zr.grad] + [p.grad.clone() for p in vf.parameters()]
    finally:
        ops.set_fusion_backend("auto")
    _assert_close(results["auto"][0], results["dense"][0], 2e-2)
    for a, b in zip(results["auto"][1:], results["dense"][1:]):
        _assert_close(a, b, 5e-2)


@pytest.mark.requires_cuda
def test_cuda_tiled_wrappers_raise_instead_of_falling_back(cuda):
    A, dA, M, G, slabs, cvec = _tiled_inputs(cuda, 70, 5, 1)
    with pytest.raises(ValueError):
        tt.fwd2_call(A.float(), dA, cvec, M)  # f32 planes
    with pytest.raises(ValueError):
        tt.bwd2_call(A, dA, cvec, G[..., :4].contiguous(), M)  # widths differ
    with pytest.raises(ValueError):
        tt.dw2_call(A, dA, G[:, :60].contiguous(), M[:, :60].contiguous())  # n differs
    with pytest.raises(ValueError):
        tt.dw_call(tuple(s.to(torch.bfloat16) for s in slabs), G, M)  # bf16 slabs


# ---------------------------------------------------------------------------
# The enc_idx path: K7, K6a, K6b
# ---------------------------------------------------------------------------

# Ragged against K6's owned blocks and reduce tiles and K7's 256-column
# CTAs; H reaches each compiled chunk width of csrc/tiled.cu (8, 32, 128
# with two sweeps at 130); (n70, n45) is a rectangular pair.
PAIR_CASES = [(70, 70, 5, 2), (300, 300, 16, 1), (100, 100, 130, 1), (70, 45, 8, 2)]
PAIR_IDS = ["n70-H5-B2", "n300-H16", "n100-H130", "rect-70x45-H8-B2"]


def _pair_inputs(dev, nr, nc, H, B, seed=0):
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0, loc=0.0):
        return torch.tensor(rng.normal(loc, scale, shape).astype(np.float32), device=dev)

    return dict(A=f(B, nr, nc, scale=0.3, loc=0.1), dA=f(B, nr, nc, scale=0.5),
                Mk=f(B, nc, H), Mi=f(B, nr, H), Gr=f(B, nr, H), Gc=f(B, nc, H),
                cvec=torch.tensor([1.03, 0.071, -0.044, 0.052], device=dev))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("nr,nc,H,B", PAIR_CASES, ids=PAIR_IDS)
@pytest.mark.parametrize("kernel", ["K6a", "K6b"])
def test_cuda_pair_kernel_matches_plain(cuda, kernel, nr, nc, H, B):
    x = _pair_inputs(cuda, nr, nc, H, B)
    if kernel == "K6a":
        args = (x["A"], x["dA"], x["cvec"], x["Mk"], x["Mi"])
        wrapper, plain = tp.pair_call, tp.plain_pair
    else:
        args = tuple(x[k] for k in ("A", "dA", "Gr", "Mk", "Mi", "Gc"))
        wrapper, plain = tp.pair_dw_call, tp.plain_pair_dw
    before = wrapper.launches
    got, again, ref = wrapper(*args), wrapper(*args), plain(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    if kernel == "K6b":
        got, again, ref = (got,), (again,), (ref,)
    for a, b, c in zip(got, ref, again):
        assert torch.isfinite(a).all()
        _assert_close(a, b, 1e-4)
        assert torch.equal(a, c)  # no atomics: bitwise repeatable


def _mlp_pair(width, depth, d, dev):
    gen = torch.Generator().manual_seed(width + depth)
    return [MLP(2 * d + 1, 1, width, depth, generator=gen).to(dev) for _ in range(2)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n,B,depth", [(300, 2, 2), (37, 1, 1), (90, 1, 3)],
                         ids=["n300-d2-B2", "n37-d1", "n90-d3"])
def test_cuda_modulate_matches_plain(cuda, n, B, depth):
    """K7 at the reference's width 8 and depth 2, with no hidden layer, and
    with two hidden layers, against the plain chain built from the MLPs."""
    rng = np.random.default_rng(1)
    A = torch.tensor(rng.uniform(0.0, 1.0, (B, n, n)).astype(np.float32), device=cuda)
    dA = torch.tensor(rng.normal(0.0, 0.5, (B, n, n)).astype(np.float32), device=cuda)
    emb = torch.tensor(rng.normal(size=(n, 6)).astype(np.float32), device=cuda)
    ma, md = _mlp_pair(8, depth, 6, cuda)
    with torch.no_grad():
        ref = tmod.plain_modulate_pair(A, dA, ma, md, emb)
    before = tmod.modulate_pair.launches
    got, again = tmod.modulate_pair(A, dA, ma, md, emb), tmod.modulate_pair(A, dA, ma, md, emb)
    torch.cuda.synchronize()
    assert tmod.modulate_pair.launches == before + 2
    for a, b, c in zip(got, ref, again):
        _assert_close(a, b, 1e-5)
        assert torch.equal(a, c)


@pytest.mark.requires_cuda
def test_cuda_enc_idx_field_matches_dense(cuda):
    """The enc_idx field on the card (the auto backend: K7 forward, K6a per
    layer forward, K6a + K6b per layer backward) against the dense backend,
    value and every gradient (layers, idx_enc, both modulation MLPs, Z)."""
    n, H, L, B, T = 150, 8, 3, 2, 5
    rng = np.random.default_rng(5)
    ts = torch.tensor(np.cumsum(rng.uniform(0.1, 0.3, (B, T)), axis=1).astype(np.float32),
                      device=cuda)
    planes = tuple(torch.tensor(rng.uniform(0.0, 0.3, (B, T - 1, n, n)).astype(np.float32),
                                device=cuda) for _ in range(4))
    ctrl = MatrixControl(CubicInterpolation(ts, planes))
    vf = TVF(H, H, H, L, 1, n, enc_idx=True, enc_type="emb", idx_dim=8,
             generator=torch.Generator().manual_seed(2)).to(cuda)
    Z = torch.tensor(rng.normal(size=(B, n, H)).astype(np.float32), device=cuda)
    t = ts[:, 1] + 0.05
    wrappers = (tmod.modulate_pair, tp.pair_call, tp.pair_dw_call, mk.megakernel_vf_eval)
    results = {}
    try:
        for name in ("dense", "auto"):
            ops.set_fusion_backend(name)
            vf.zero_grad()
            Zr = Z.clone().requires_grad_(True)
            before = [w.launches for w in wrappers]
            out = vf(t, Zr, ctrl)
            (out * out).sum().backward()
            torch.cuda.synchronize()
            ran = tuple(w.launches - b for w, b in zip(wrappers, before))
            assert ran == ((1, 2 * L, L, 0) if name == "auto" else (0, 0, 0, 0))
            results[name] = [out.detach(), Zr.grad] + [p.grad.clone() for p in vf.parameters()]
    finally:
        ops.set_fusion_backend("auto")
    _assert_close(results["auto"][0], results["dense"][0], 1e-4)
    for a, b in zip(results["auto"][1:], results["dense"][1:]):
        _assert_close(a, b, 1e-3)


@pytest.mark.requires_cuda
def test_cuda_enc_idx_wrappers_raise_instead_of_falling_back(cuda):
    x = _pair_inputs(cuda, 70, 70, 5, 1)
    with pytest.raises(ValueError):
        tp.pair_call(x["A"].double(), x["dA"], x["cvec"], x["Mk"], x["Mi"])  # f64 planes
    with pytest.raises(ValueError):
        tp.pair_call(x["A"], x["dA"], x["cvec"], x["Mk"][:, :60].contiguous(), x["Mi"])
    with pytest.raises(ValueError):
        tp.pair_dw_call(x["A"], x["dA"], x["Gr"], x["Mk"], x["Mi"].to(torch.bfloat16), x["Gc"])
    ma, md = _mlp_pair(8, 2, 6, cuda)
    emb = torch.zeros((70, 6), device=cuda)
    with pytest.raises(ValueError):
        tmod.modulate_pair(x["A"].to(torch.bfloat16), x["dA"], ma, md, emb)  # bf16 plane
    with pytest.raises(ValueError):
        tmod.modulate_pair(x["A"], x["dA"], ma, md, emb[:60])  # emb rows != n
    wide = _mlp_pair(16, 2, 6, cuda)  # the kernel is compiled for width 8 only
    with pytest.raises(ValueError):
        tmod.modulate_pair(x["A"], x["dA"], *wide, emb)
    with pytest.raises(ValueError):  # the two MLPs' depths differ
        tmod.modulate_pair(x["A"], x["dA"], ma, _mlp_pair(8, 3, 6, cuda)[0], emb)


# K8 / K9: n is not a multiple of any block size; the block sizes 4, 16, 32 and
# 128, H = 5 (the 16-wide column chunk) and H = 40 (two 32-wide chunks).
BCSR_CASES = [(4, 5), (16, 40), (32, 5), (128, 40)]
BCSR_IDS = [f"bs{bs}-H{H}" for bs, H in BCSR_CASES]
BCSR_MODES = ["unbatched", "batched", "shared-matrix", "shared-pattern"]


def _bcsr_batch(dev, n, bs, B, seed=0):
    """B matrices with different block patterns (a band of its own width
    and one far entry each), widened to one slot count: padded slots."""
    rng = np.random.default_rng(seed)
    i, j = np.indices((n, n))
    dense = []
    for b in range(B):
        A = np.where(np.abs(i - j) <= 2 + 3 * b, rng.normal(size=(n, n)), 0.0)
        A[b, n - 1 - b] = 0.5
        dense.append(A.astype(np.float32))
    kb = max(tb.bcsr_from_dense(A, bs).kb for A in dense)
    mats = [tb.bcsr_from_dense(A, bs, kb) for A in dense]
    idx = torch.stack([m.block_idx for m in mats]).to(dev)
    blocks = torch.stack([m.blocks for m in mats]).to(dev)
    nblocks = torch.stack([m.nblocks for m in mats]).to(dev)
    return idx, blocks, nblocks, rng


def _bcsr_operands(mode, idx, blocks, M):
    """(block_idx, blocks, M) for a batching mode: every operand batched,
    all unbatched, one matrix for batched M ("shared-matrix"), or one
    pattern with batched values ("shared-pattern"); shared operands reach
    the kernel with batch stride 0."""
    if mode == "unbatched":
        return idx[0], blocks[0], M[0]
    if mode == "shared-matrix":
        return idx[0], blocks[0], M
    if mode == "shared-pattern":
        return idx[0], blocks[:1].expand(M.shape[0], *blocks.shape[1:]), M
    return idx, blocks, M


@pytest.mark.requires_cuda
@pytest.mark.parametrize("mode", BCSR_MODES)
@pytest.mark.parametrize("bs,H", BCSR_CASES, ids=BCSR_IDS)
def test_cuda_bcsr_kernels_match_plain(cuda, bs, H, mode):
    n, B = 3 * bs + bs // 2 + 1, 3
    idx, blocks, nblocks, rng = _bcsr_batch(cuda, n, bs, B)
    assert float(tb.slot_mask(idx, nblocks).min()) == 0.0  # padded slots exist
    M = torch.tensor(rng.normal(size=(B, n, H)).astype(np.float32), device=cuda)
    X = torch.tensor(rng.normal(size=(B, n, H)).astype(np.float32), device=cuda)
    bi, bl, Mo = _bcsr_operands(mode, idx, blocks, M)
    Xo = X[0] if mode == "unbatched" else X
    launches = (tb.bcsr_spmm.launches, tb.bcsr_sddmm.launches)
    got = tb.bcsr_spmm(tb.BCSR(bi, bl, n), Mo)
    ref = tb.bcsr_spmm_plain(tb.BCSR(bi, bl, n), Mo)
    got_s = tb.bcsr_sddmm(bi, Xo, Mo, bs)
    ref_s = tb.bcsr_sddmm_plain(bi, Xo, Mo, bs)
    torch.cuda.synchronize()
    assert (tb.bcsr_spmm.launches, tb.bcsr_sddmm.launches) == (launches[0] + 1,
                                                               launches[1] + 1)
    _assert_close(got, ref, 1e-4)
    _assert_close(got_s, ref_s, 1e-4)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("mode", ["unbatched", "batched", "shared-pattern"])
@pytest.mark.parametrize("n,K,H", [(37, 5, 5), (101, 9, 70)], ids=["n37-K5-H5", "n101-K9-H70"])
def test_cuda_ell_spmm_matches_plain(cuda, n, K, H, mode):
    """K10 with padding slots (index n) in every row and n not a multiple
    of anything; "shared-pattern" is one index array for batched values."""
    rng = np.random.default_rng(1)
    B = 2
    idx = rng.integers(0, n, (B, n, K)).astype(np.int32)
    idx[rng.random((B, n, K)) < 0.3] = n
    indices = torch.tensor(idx, device=cuda)
    values = torch.tensor(rng.normal(size=(B, n, K)).astype(np.float32), device=cuda)
    M = torch.tensor(rng.normal(size=(B, n, H)).astype(np.float32), device=cuda)
    if mode == "unbatched":
        indices, values, M = indices[0], values[0], M[0]
    elif mode == "shared-pattern":
        indices = indices[0]
    before = tell.ell_spmm_call.launches
    got = tell.ell_spmm_call(indices, values, M)
    ref = tell.plain_ell_spmm(indices, values, M)
    torch.cuda.synchronize()
    assert tell.ell_spmm_call.launches == before + 1
    _assert_close(got, ref, 1e-4)


@pytest.mark.requires_cuda
def test_cuda_sparse_autograd_matches_plain(cuda):
    """ELLSpMM and bcsr_spmm_grad (kernels forward and backward) against
    autograd of the plain versions; the BCSR blocks' gradient is the plain
    one masked by the valid slots."""
    rng = np.random.default_rng(2)
    n, K, H, B, bs = 45, 6, 7, 2, 16
    idx = rng.integers(0, n, (B, n, K)).astype(np.int32)
    idx[:, :, -1] = n
    indices = torch.tensor(idx, device=cuda)
    G = torch.tensor(rng.normal(size=(B, n, H)).astype(np.float32), device=cuda)

    def grads(fn, *xs):
        leaves = [x.detach().clone().requires_grad_(True) for x in xs]
        (fn(*leaves) * G).sum().backward()
        return [x.grad for x in leaves]

    values = torch.tensor(rng.normal(size=(B, n, K)).astype(np.float32), device=cuda)
    M = torch.tensor(rng.normal(size=(B, n, H)).astype(np.float32), device=cuda)
    ell = tsp.ELL(indices, values, n, tuple(x.to(cuda) for x in
                                            tsp.transpose_pattern(indices, n)))
    t_values = tsp.transposed_values(ell)
    got = grads(lambda v, m: tell.ELLSpMM.apply(v, m, indices, ell.transpose[0], t_values),
                values, M)
    ref = grads(lambda v, m: tell.plain_ell_spmm(indices, v, m), values, M)
    for a, b in zip(got, ref):
        _assert_close(a, b, 1e-4)

    bidx, blocks, nblocks, _ = _bcsr_batch(cuda, n, bs, B)
    dense = [tb.bcsr_to_dense(tb.BCSR(bidx[b].cpu(), blocks[b].cpu(), n)) for b in range(B)]
    kbT = max(tb.bcsr_from_dense(d.numpy().T, bs).kb for d in dense)
    mT = [tb.bcsr_from_dense(d.numpy().T.copy(), bs, kbT) for d in dense]
    idx_T = torch.stack([m.block_idx for m in mT]).to(cuda)
    blocks_T = torch.stack([m.blocks for m in mT]).to(cuda)
    valid = tb.slot_mask(bidx, nblocks)
    got = grads(lambda bl, m: tb.bcsr_spmm_grad(bl, bidx, blocks_T, idx_T, valid, m, n),
                blocks, M)
    ref = grads(lambda bl, m: tb.bcsr_spmm_plain(tb.BCSR(bidx, bl, n), m), blocks, M)
    _assert_close(got[0], ref[0] * valid[..., None, None], 1e-4)
    _assert_close(got[1], ref[1], 1e-4)


@pytest.mark.requires_cuda
def test_cuda_sparse_field_matches_cpu(cuda):
    """The field through an ELL and a BCSR control on the card (K10, K8,
    K9) against the same field and controls on the CPU (plain versions):
    values 1e-4, parameter gradients 1e-3, as K1/K2; two forward passes on
    the card are bitwise equal."""
    from gncde_tpu_torch.interp import backward_hermite_coefficients, build_sparse_control

    rng = np.random.default_rng(3)
    Bn, T, n, H = 2, 4, 70, 8
    ts = np.cumsum(rng.uniform(0.1, 0.3, (Bn, T)), 1).astype(np.float32) - 0.1
    i, j = np.indices((n, n))
    A = np.where(np.abs(i - j) <= 3, rng.random((Bn, T, n, n)), 0.0).astype(np.float32)
    X = np.stack([np.broadcast_to(ts[..., None, None], A.shape), A], -1)
    coeffs = tuple(c.numpy() for c in backward_hermite_coefficients(
        torch.tensor(ts), torch.tensor(X)))
    vf = TVF(H, H, H, 2, 1, n, generator=torch.Generator().manual_seed(0))
    Z = torch.tensor(rng.normal(size=(Bn, n, H)).astype(np.float32))
    t = torch.tensor(ts[:, 1] + 0.05)
    for fmt in ("ell", "bcsr"):
        ctrl = build_sparse_control("cubic", ts, coeffs, sparse_format=fmt, block_size=16)
        outs = []
        for dev in ("cpu", cuda):
            vf.to(dev).zero_grad()
            out = vf(t.to(dev), Z.to(dev), ctrl.to(dev))
            out.square().sum().backward()
            outs.append([out.detach().cpu()] + [p.grad.detach().cpu().clone() for p in vf.parameters()])
        _assert_close(outs[1][0], outs[0][0], 1e-4)
        for a, b in zip(outs[1][1:], outs[0][1:]):
            _assert_close(a, b, 1e-3)
        # Bitwise repeatable on the card (no atomics in the forward), as the
        # checkpointed adjoint's recomputation needs.
        with torch.no_grad():
            again = vf(t.to(cuda), Z.to(cuda), ctrl.to(cuda)).cpu()
        assert torch.equal(again, outs[1][0])


@pytest.mark.requires_cuda
def test_cuda_sparse_wrappers_raise_instead_of_falling_back(cuda):
    """A CUDA tensor reaching K8, K9 or K10 runs the kernel or raises: a
    block size above 128, float64 or int64 operands are refused."""
    n, H = 300, 4
    big = tb.bcsr_from_dense(np.eye(n, dtype=np.float32), 256)  # bs 256: no kernel
    M = torch.ones((n, H), device=cuda)
    with pytest.raises(ValueError):
        tb.bcsr_spmm(tb.BCSR(big.block_idx.to(cuda), big.blocks.to(cuda), n), M)
    with pytest.raises(ValueError):
        tb.bcsr_sddmm(big.block_idx.to(cuda), M, M, 256)
    ok = tb.bcsr_from_dense(np.eye(n, dtype=np.float32), 32)
    with pytest.raises(ValueError):
        tb.bcsr_spmm(tb.BCSR(ok.block_idx.to(cuda), ok.blocks.to(cuda), n), M.double())
    with pytest.raises(ValueError):
        tb.bcsr_spmm(tb.BCSR(ok.block_idx.long().to(cuda), ok.blocks.to(cuda), n), M)
    idx = torch.zeros((n, 3), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        tell.ell_spmm_call(idx, torch.ones((n, 3), device=cuda), M)
    with pytest.raises(ValueError):
        tell.ell_spmm_call(idx.int(), torch.ones((n, 3), device=cuda), M.double())


# ---- K11, K12, K13, K5c and the ELL repair -------------------------------

#: The phase-14 shapes of K11: the flagship (Tsit5) and the bench widths.
STEP_CASES = [(400, 4, (16, 16, 16), "tsit5"), (400, 4, (32, 32, 32, 32), "tsit5"),
              (70, 3, (8, 8, 8), "dopri5"), (70, 3, (8, 8), "bosh3")]
STEP_IDS = ["flagship-tsit5", "bench-tsit5", "n70-dopri5", "n70-bosh3"]


def _step_inputs(dev, n, B, widths, seed=0, T=8):
    """Per-element planes and knots, y, f0, h (one finished element: h = 1
    past the last knot) and layer params, from ``seed``."""
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    planes = tuple(t(rng.uniform(-0.05, 0.1, (B, T - 1, n, n))) for _ in range(4))
    ts = t(np.cumsum(rng.uniform(0.1, 0.3, (B, T)), 1))
    tq = ts[:, 2] + 0.01
    tq[-1] = ts[-1, -1] + 0.1  # finished: nodes past the last knot
    h = t(rng.uniform(0.02, 0.2, B))
    h[-1] = 1.0
    y = t(rng.normal(size=(B, n, widths[0])))
    f0 = t(0.1 * rng.normal(size=(B, n, widths[0])))
    layers = []
    for hin, hout in zip(widths[:-1], widths[1:]):
        lim = 1.0 / np.sqrt(hin)
        layers.append(dict(
            norm_w=t(1.0 + 0.1 * rng.normal(size=hin)), norm_b=t(0.1 * rng.normal(size=hin)),
            W=t(rng.uniform(-lim, lim, (hout, hin))), lin_b=t(rng.uniform(-lim, lim, hout)),
            basis=t(rng.uniform(-1 / 15, 1 / 15, (8, 2)))))
    return planes, ts, tq, y, h, f0, layers


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n,B,widths,method", STEP_CASES, ids=STEP_IDS)
def test_cuda_fused_step_matches_plain_and_repeats(cuda, n, B, widths, method):
    """K11 against its plain version (1e-4 of each output's scale, every
    output finite, a finished element included); a second launch is bitwise
    equal, as the checkpointed adjoint's recomputation needs."""
    from gncde_tpu_torch.solve.tableaus import get_tableau

    tab = get_tableau(method)
    planes, ts, tq, y, h, f0, layers = _step_inputs(cuda, n, B, widths)
    before = tfs.fused_step_call.launches
    got = tfs.fused_step_call(planes, ts, tq, y, h, f0, layers, tab)
    again = tfs.fused_step_call(planes, ts, tq, y, h, f0, layers, tab)
    ref = tfs._step_reference(planes, ts, tq, y, h, f0, layers, tab)
    torch.cuda.synchronize()
    assert tfs.fused_step_call.launches == before + 2
    for a, b, c in zip(got, ref, again):
        assert torch.isfinite(a).all()
        assert torch.equal(a, c)
        _assert_close(a, b, 1e-4)


@pytest.mark.requires_cuda
def test_cuda_fused_step_chunked_launch_equals_one_launch(cuda):
    """A batch whose CTAs exceed one wave of the card is launched in chunks;
    the elements are independent, so each equals its own one-element launch
    to the bit."""
    from gncde_tpu_torch.solve.tableaus import get_tableau

    tab = get_tableau("tsit5")
    big = 2 * tfs.capacity(cuda) // 13 + 1  # n = 200: 13 CTAs per element
    planes, ts, tq, y, h, f0, layers = _step_inputs(cuda, 200, big, (8, 8), seed=4, T=4)
    before = tfs.fused_step_call.launches
    out = tfs.fused_step_call(planes, ts, tq, y, h, f0, layers, tab)
    torch.cuda.synchronize()
    assert tfs.fused_step_call.launches - before >= 3
    for b in (0, big // 2, big - 1):
        sl = slice(b, b + 1)
        one = tfs.fused_step_call(tuple(p[sl] for p in planes), ts[sl], tq[sl], y[sl],
                                  h[sl], f0[sl], layers, tab)
        for a, o in zip(out, one):
            assert torch.equal(a[sl], o)


@pytest.mark.requires_cuda
def test_cuda_fused_step_backward_matches_autograd_of_plain(cuda):
    """The manual chain rule (one K2 per stage) against autograd of the
    plain step: y, f0, t, h and every layer parameter, 1e-3 of each scale."""
    from gncde_tpu_torch.solve.tableaus import get_tableau

    tab = get_tableau("tsit5")
    planes, ts, tq, y, h, f0, layers = _step_inputs(cuda, 400, 4, (16, 16, 16), seed=5)
    flat = [p for lp in layers for p in
            (lp["norm_w"], lp["norm_b"], lp["W"], lp["lin_b"], *lp["basis"])]
    rng = np.random.default_rng(6)
    W = [torch.tensor(rng.normal(size=y.shape).astype(np.float32), device=cuda)
         for _ in range(3)]

    def grads(fn):
        leaves = [x.detach().clone().requires_grad_(True) for x in (tq, y, h, f0, *flat)]
        tq_, y_, h_, f0_, *fl = leaves
        outs = fn(tq_, y_, h_, f0_, fl)
        sum((o * w).sum() for o, w in zip(outs, W)).backward()
        return [x.grad for x in leaves]

    got = grads(lambda tq_, y_, h_, f0_, fl: tfs.FusedRKStep.apply(
        tab, ts, tq_, y_, h_, f0_, *planes, *fl))
    ref = grads(lambda tq_, y_, h_, f0_, fl: tfs._step_reference(
        planes, ts, tq_, y_, h_, f0_, mk._unflatten(fl), tab)[:3])
    for a, b in zip(got, ref):
        _assert_close(a, b, 1e-3)


APPLY_CASES = [(400, 16, 4), (300, 5, 2)]
APPLY_IDS = ["flagship-layer", "odd-n300-H5"]


def _apply_inputs(dev, n, H, B, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.tensor((scale * rng.normal(size=shape)).astype(np.float32), device=dev)

    return (t(B, n, n, scale=0.1), t(B, n, n, scale=0.1), t(B, n, H), t(B, n), t(B, n),
            t(B, H), t(B, H), t(2, 2))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n,H,B", APPLY_CASES, ids=APPLY_IDS)
@pytest.mark.parametrize("kernel", ["K12", "K13"])
def test_cuda_fused_apply_matches_plain(cuda, kernel, n, H, B):
    """K12 (``fused_basis._pallas_forward``) and K13 (``fused_conv_stream``)
    against their plain versions, 1e-4 of the scale; bitwise repeatable."""
    A, dA, M, dvec, u, s, w, q = _apply_inputs(cuda, n, H, B)
    if kernel == "K12":
        fn, plain, counter = (lambda: tfb._pallas_forward(A, dA, M, q, dvec, u, s, w),
                              lambda: tfb.plain_pallas_forward(A, dA, M, q, dvec, u, s, w),
                              tfb._pallas_forward)
    else:
        fn, plain, counter = (lambda: tpl.fused_conv_stream(A, dA, M, dvec, u, s, w, q),
                              lambda: tpl.plain_conv_stream(A, dA, M, dvec, u, s, w, q),
                              tpl.fused_conv_stream)
    before = counter.launches
    got, again, ref = fn(), fn(), plain()
    torch.cuda.synchronize()
    assert counter.launches == before + 2
    assert torch.equal(got, again)
    _assert_close(got, ref, 1e-4)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("backend", ["pipeline", "pallas"])
def test_cuda_fused_apply_autograd_matches_fused_apply(cuda, backend):
    """pipeline_fused_apply and fused_apply_pallas on the card against
    autograd of equiv_basis.fused_apply: values 1e-4, the gradients of A,
    dA, M and the eight basis parameters 1e-3."""
    from gncde_tpu_torch.ops import equiv_basis

    rng = np.random.default_rng(7)
    n, H, B = 300, 5, 2
    A, dA, M, _, _, _, _, _ = _apply_inputs(cuda, n, H, B, seed=7)
    params = [torch.tensor(rng.uniform(-1 / 15, 1 / 15, 2).astype(np.float32), device=cuda)
              for _ in range(8)]
    G = torch.tensor(rng.normal(size=(B, n, H)).astype(np.float32), device=cuda)
    fn = tpl.pipeline_fused_apply if backend == "pipeline" else tfb.fused_apply_pallas

    def run(f):
        leaves = [x.detach().clone().requires_grad_(True) for x in (A, dA, M, *params)]
        out = f(leaves[0], leaves[1], leaves[2], leaves[3:])
        (out * G).sum().backward()
        return out.detach(), [x.grad for x in leaves]

    got, got_g = run(lambda a, da, m, p: fn(a, da, m, p, False, True))
    ref, ref_g = run(lambda a, da, m, p: equiv_basis.fused_apply(a, da, m, p,
                                                                 add_identity=True))
    _assert_close(got, ref, 1e-4)
    for a, b in zip(got_g, ref_g):
        _assert_close(a, b, 1e-3)


ABAR_CASES = [(1505, 8, 1, torch.float32), (1505, 128, 1, torch.float32),
              (300, 5, 2, torch.float32), (300, 5, 2, torch.bfloat16)]
ABAR_IDS = ["genre-H8", "genre-H128", "odd", "odd-bf16-slabs"]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n,H,B,dtype", ABAR_CASES, ids=ABAR_IDS)
def test_cuda_abar_matches_plain(cuda, n, H, B, dtype):
    """K5c against its plain version on the same bf16 operands, 1e-4 of
    each output's scale; bitwise repeatable; tiled_abar_apply's padded
    rows are zero."""
    rng = np.random.default_rng(8)
    slabs = tuple(torch.tensor(rng.normal(0.0, 0.1, (B, n, n)).astype(np.float32),
                               device=cuda).to(dtype) for _ in range(4))
    wvec = torch.tensor(rng.normal(size=(B, 8)).astype(np.float32), device=cuda)
    M = torch.tensor(rng.normal(size=(B, n, H)).astype(np.float32), device=cuda).to(
        torch.bfloat16)
    before = tt.abar_call.launches
    got, again, ref = tt.abar_call(slabs, wvec, M), tt.abar_call(slabs, wvec, M), \
        tt.plain_abar(slabs, wvec, M)
    torch.cuda.synchronize()
    assert tt.abar_call.launches == before + 2
    for a, b, c in zip(got, ref, again):
        assert torch.equal(a, c)
        _assert_close(a, b, 1e-4)
    NP = -(-n // tt.DEFAULT_TILE) * tt.DEFAULT_TILE
    Mp = torch.zeros((B, NP, H), device=cuda)
    Mp[:, :n] = M.float()
    out = tt.tiled_abar_apply(slabs, wvec[:, :4], wvec[:, 4:], Mp)
    assert out.shape == (B, NP, H) and not out[:, n:].any()
    _assert_close(out[:, :n], ref[0] + ref[1], 1e-4)


@pytest.mark.requires_cuda
def test_cuda_ell_backward_repeats_bitwise(cuda):
    """The ELL control's backward has no scatter: d_M of A @ M is K10 on the
    transposed pattern and d_M of A^T @ M K10 on the original, so two
    backward passes give bitwise-equal gradients, within 1e-4 of the plain
    scatter plain_ell_spmm_t."""
    rng = np.random.default_rng(9)
    n, K, H, B = 400, 20, 16, 4
    idx = rng.integers(0, n, (B, n, K)).astype(np.int32)
    idx[rng.random((B, n, K)) < 0.2] = n
    indices = torch.tensor(idx, device=cuda)
    values = torch.tensor(rng.normal(size=(B, n, K)).astype(np.float32), device=cuda)
    ell = tsp.ELL(indices, values, n, tuple(x.to(cuda) for x in
                                            tsp.transpose_pattern(indices, n)))
    M = torch.tensor(rng.normal(size=(B, n, H)).astype(np.float32), device=cuda)
    G = torch.tensor(rng.normal(size=(B, n, H)).astype(np.float32), device=cuda)
    for op, plain in ((tsp.ell_spmm, tell.plain_ell_spmm_t),
                      (tsp.ell_spmm_t, tell.plain_ell_spmm)):
        runs = []
        for _ in range(2):
            v = values.detach().clone().requires_grad_(True)
            m = M.detach().clone().requires_grad_(True)
            (op(tsp.ELL(indices, v, n, ell.transpose), m) * G).sum().backward()
            runs.append((v.grad, m.grad))
        for a, b in zip(*runs):
            assert torch.equal(a, b)
        _assert_close(runs[0][1], plain(indices, values, G), 1e-4)

