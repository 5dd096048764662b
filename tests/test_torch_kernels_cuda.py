"""The port's CUDA kernels against their plain PyTorch versions: K1 and K2
(the vector-field kernels, n <= 640), K3, K4, K5a, K5b, K5c (the tiled
regime's plane sweeps and the 4-slab apply, ``csrc/tiled.cu``; K4 on the
tensor cores, ``csrc/plane_mma.cu``), the enc_idx path's K7 (modulation,
``csrc/modulate.cu``), K6a and K6b (plane pair, ``csrc/plane_mma.cu``),
the sparse controls' K8 and K9 (BCSR SpMM and SDDMM,
``csrc/bcsr.cu``) and K10 (ELL SpMM, ``csrc/ell_spmm.cu``), the fused RK
step K11 (``csrc/fused_step.cu``), the per-layer fused applies K12 and
K13 (``csrc/fused_apply.cu``), K1, K2 and K11 on the directed 11-term
basis (K1d, K2d, K11d: the same sources, the basis a template parameter),
their fusion_precision bf16 instantiations on bf16 planes (K1bf, K2bf,
K11bf, either basis: the precision a second template parameter), and the
bf16 enc_idx route's K7bf (bf16 output), K6a-bf and K6b-bf (bf16 planes),
and the megakernel design probes' kernels (``csrc/mk_probe.cu``: K1-4mm
and K1bf's probe flags; ``ops/mk_probe.py``).

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
sum in another order (1e-4; both multiply as 3xTF32, whose split leaves
about 2^-21 of each product, far inside that bound); the enc_idx field on its kernels against its
dense path 1e-4 for values and 1e-3 for gradients, as K1/K2. K8, K9 and
K10 are f32 on both sides and sum in another order (1e-4); their autograd
functions against autograd of the plain versions 1e-4. K11 against its plain
version 1e-4 of max|ref| per output (K1's sums in another order, compounded
over the stages), its backward 1e-3 (K2's); K12, K13 and K5c 1e-4 (f32 or
the same bf16 operands; summation order). K1d, K2d and K11d as K1, K2 and
K11, on planes whose column sums differ from their row sums. K1bf and
K2bf as K1 and K2 against their plain bf16 versions run layer by layer
from the kernel's own intermediates (the same bf16 operands on both
sides); K11bf stage by stage as K11, its backward's K2bf launches as
K2bf (see the bf16 section).
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

from gncde_tpu_torch import ops
from gncde_tpu_torch.interp import CubicInterpolation, MatrixControl
from gncde_tpu_torch.models.vector_fields import PermEquivDirGraphVectorField as TDVF
from gncde_tpu_torch.models.vector_fields import PermEquivGraphVectorField as TVF
from gncde_tpu_torch.ops import _build
from gncde_tpu_torch.ops import bcsr as tb
from gncde_tpu_torch.ops import ell_spmm as tell
from gncde_tpu_torch.ops import megakernel as mk
from gncde_tpu_torch.ops import megakernel_bwd as mkb
from gncde_tpu_torch.ops import mk_probe as mp
from gncde_tpu_torch.ops import modulate as tmod
from gncde_tpu_torch.ops import fused_basis as tfb
from gncde_tpu_torch.ops import fused_step as tfs
from gncde_tpu_torch.ops import pair as tp
from gncde_tpu_torch.ops import pipeline as tpl
from gncde_tpu_torch.ops import sparse as tsp
from gncde_tpu_torch.ops import tiled as tt
from gncde_tpu_torch.nn import MLP

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the bf16 kernels' layer-by-layer checks)

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


def _inputs(dev, widths, per_element=True, seed=0, nbasis=8):
    """Planes, per-element (idx, tau), node state, layer params (basis
    ``(nbasis, 2)``) and an output cotangent, made with numpy from ``seed``."""
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
            basis=t(rng.uniform(-1 / 15, 1 / 15, (nbasis, 2))),
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


# K2's reverse sweep at the main paths' shapes beside CASES: the trade field
# (n=255, last layer 512: four or eight column groups and the finish pass),
# the largest n (640, 64-wide layers), england's widths (n=129, last layer
# 1024) and an odd shape (n=77, widths 13 -> 37 -> 70: a partial group, rows
# not a multiple of 4 floats, so 4-byte copies of the last layer's g).
K2_WIDE = [(255, 2, (32, 32, 32, 32, 512)), (640, 1, (64, 64, 64)),
           (129, 2, (64, 64, 64, 1024)), (77, 3, (13, 37, 70))]
K2_WIDE_IDS = ["trade-n255", "n640-64x3", "england-n129", "odd-n77"]


def _k2_case(dev, case, seed, nbasis=8):
    """K2's inputs for a CASES entry ``(widths, per_element)`` (n = N) or a
    K2_WIDE one ``(n, B, widths)``."""
    if len(case) == 2:
        return _inputs(dev, case[0], case[1], seed=seed, nbasis=nbasis)
    n, nb, widths = case
    return chip_smoke.make_inputs(torch, n, nb, widths, seed=seed, nbasis=nbasis)


def _check_k2(inputs, need_tau, nbasis):
    """K2 within 1e-3 of every cotangent's scale of the plain version, one
    launch counted, and a second launch bitwise equal."""
    planes, idx, tau, Z, layers, G = inputs
    before = mkb.megakernel_vf_bwd.launches
    got = mkb.megakernel_vf_bwd(planes, idx, tau, Z, layers, G, need_tau)
    again = mkb.megakernel_vf_bwd(planes, idx, tau, Z, layers, G, need_tau)
    ref = mkb.plain_vf_bwd(planes, idx, tau, Z, layers, G, need_tau)
    torch.cuda.synchronize()
    assert mkb.megakernel_vf_bwd.launches == before + 2
    _assert_close(got[1], ref[1], 1e-3)
    assert torch.equal(got[1], again[1]) and torch.equal(got[0], again[0])
    if need_tau:
        _assert_close(got[0], ref[0], 1e-3)
    for gl, rl, al in zip(got[2], ref[2], again[2]):
        assert gl[4].shape == (Z.shape[0], nbasis, 2)
        for a, b, c in zip(gl, rl, al):
            _assert_close(a, b, 1e-3)
            assert torch.equal(a, c)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("need_tau", [False, True])
@pytest.mark.parametrize("case", [*CASES, *K2_WIDE], ids=[*IDS, *K2_WIDE_IDS])
def test_cuda_k2_matches_plain(cuda, case, need_tau):
    _check_k2(_k2_case(cuda, case, seed=1), need_tau, 8)


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
# reduce tiles; the widths reach each compiled chunk width of csrc/tiled.cu
# (K4: csrc/plane_mma.cu, chunks of 8, 32, 64): H = 5 (8, not a multiple of
# 8), H = 16 (32) and H = 130 (128, two sweeps; K4 three chunks).
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


# K3 on the tensor cores: n = 17 (one partial row block and reduce tile), 300,
# 641 (ragged against the 64-index blocks and 32-deep tiles) and 1505 (the
# genre n, odd: plane rows start on 2-byte boundaries); H through each
# column chunk (8, 32, 128), not multiples of 8 (scalar M tiles: 1, 5, 13)
# and past one chunk (136 = 128 + 8); one and three batch elements.
K3_NS = [17, 300, 641, 1505]
K3_HS = [1, 5, 8, 13, 32, 128, 136]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("H", K3_HS)
@pytest.mark.parametrize("n", K3_NS)
def test_cuda_k3_tensor_cores_match_plain(cuda, n, H, B):
    A, dA, M, _, _, cvec = _tiled_inputs(cuda, n, H, B, seed=n + H)
    before = tt.fwd2_call.launches
    got, again = tt.fwd2_call(A, dA, cvec, M), tt.fwd2_call(A, dA, cvec, M)
    ref = tt.plain_fwd2(A, dA, cvec, M)
    torch.cuda.synchronize()
    assert tt.fwd2_call.launches == before + 2
    for a, b, c in zip(got, ref, again):
        assert torch.isfinite(a).all()
        _assert_close(a, b, 1e-4)
        assert torch.equal(a, c)  # no atomics: bitwise repeatable


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n,H", [(641, 8), (1505, 128), (300, 13)])
def test_cuda_k3_every_split_matches_plain(cuda, n, H, monkeypatch):
    """The reduce extent in 1, 2, 5 and ceil(n / 32) parts (one tile each;
    ``fwd2_call`` looks its plan up in the module): each within 1e-4 and
    bitwise repeatable."""
    A, dA, M, _, _, cvec = _tiled_inputs(cuda, n, H, 1, seed=7)
    ref = tt.plain_fwd2(A, dA, cvec, M)
    for S in (1, 2, 5, -(-n // tt.FWD2_BK)):
        monkeypatch.setattr(tt, "fwd2_splits", lambda B, n, H, S=S: S)
        got, again = (tt.fwd2_call(A, dA, cvec, M) for _ in range(2))
        torch.cuda.synchronize()
        for a, b, c in zip(got, ref, again):
            _assert_close(a, b, 1e-4)
            assert torch.equal(a, c)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("offset", [1, 3, 8])
@pytest.mark.parametrize("n,H", [(300, 8), (67, 128)])
def test_cuda_k3_planes_at_any_alignment_match_plain(cuda, n, H, offset):
    """Planes and M that start ``offset`` elements into their buffers: K3
    copies each plane row as the aligned 16-byte granules that hold it, from
    planes whose base is 16-byte aligned (the wrapper copies those that are
    not) and only up to the planes' end, and takes M by scalar loads when M
    is not 16-byte aligned."""
    A, dA, M, _, _, cvec = _tiled_inputs(cuda, n, H, 2, seed=offset)

    def shifted(x):
        buf = torch.empty(x.numel() + offset, device=cuda, dtype=x.dtype)
        return buf[offset:].view(x.shape).copy_(x)

    As, dAs, Ms = shifted(A), shifted(dA), shifted(M)
    ref = tt.plain_fwd2(A, dA, cvec, M)
    got, again = tt.fwd2_call(As, dAs, cvec, Ms), tt.fwd2_call(As, dAs, cvec, Ms)
    torch.cuda.synchronize()
    for a, b, c in zip(got, ref, again):
        _assert_close(a, b, 1e-4)
        assert torch.equal(a, c)
    if offset % 8:  # the entry point itself refuses planes it cannot copy
        out = torch.empty((2,) + tuple(M.shape), device=cuda, dtype=torch.float32)
        err = tt._fn("gncde_tiled_fwd2")(
            As.data_ptr(), dAs.data_ptr(), n, cvec.data_ptr(), Ms.data_ptr(), 2, H,
            out[0].data_ptr(), out[1].data_ptr(), None, 1, _build.stream())
        assert err != 0


@pytest.mark.requires_cuda
def test_cuda_k3_raises_on_what_it_does_not_take(cuda, monkeypatch):
    A, dA, M, _, _, cvec = _tiled_inputs(cuda, 70, 5, 1)

    def split(S):
        monkeypatch.setattr(tt, "fwd2_splits", lambda B, n, H: S)
        return tt.fwd2_call(A, dA, cvec, M)

    before = tt.fwd2_call.launches
    bad = [
        lambda: tt.fwd2_call(A.float(), dA, cvec, M),  # f32 planes
        lambda: tt.fwd2_call(A, dA, cvec, M.float()),  # f32 vectors
        lambda: tt.fwd2_call(A, dA[:, :60, :60].contiguous(), cvec, M),  # shapes differ
        lambda: tt.fwd2_call(A, dA, cvec, M[:, :60].contiguous()),  # n differs
        lambda: tt.fwd2_call(A.transpose(1, 2), dA, cvec, M),  # not contiguous
        lambda: tt.fwd2_call(A, dA, cvec.double(), M),  # f64 coefficients
        lambda: tt.fwd2_call(A, dA, cvec.cpu(), M),  # coefficients on the CPU
        lambda: split(0),
        lambda: split(4),  # more parts than tiles
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()
    assert tt.fwd2_call.launches == before


# K4 and K6a on the tensor cores (csrc/plane_mma.cu): the main path's shapes
# (genre n = 1505 at H = 8 and 128, trade n = 255 at H = 32 and 512, the odd
# n = 300, H = 5, B = 2), rectangular planes (K6a), and H = 1, 5, 129, 512
# (scalar vector tiles where H is not a multiple of a granule, chunks of 64
# past one). K4 takes square bf16 planes only; K6a its three forms: f32
# planes (3xTF32), bf16 planes with the forward's f32 vectors (bf16 B
# against split f32 vectors) and with the backward's bf16 vectors (bf16
# MMA).
MMA_SHAPES = [(1505, 1505, 8, 1), (1505, 1505, 128, 1), (255, 255, 32, 1), (255, 255, 512, 1),
              (300, 300, 5, 2), (300, 200, 13, 2), (45, 70, 1, 1), (100, 100, 129, 1),
              (64, 64, 512, 1), (17, 17, 5, 3)]
MMA_IDS = [f"{nr}x{nc}-H{H}-B{B}" for nr, nc, H, B in MMA_SHAPES]
MMA_KERNELS = ["K4", "K6a", "K6a-bf-f32-vectors", "K6a-bf-bf16-vectors"]


def _mma_case(dev, kernel, nr, nc, H, B, seed=0, shift=lambda x: x):
    """(wrapper, counter, kernel args, plain args) for one kernel at one
    shape; ``shift`` places the planes and vectors the kernel gets."""
    if kernel == "K4":
        A, dA, M, G, _, cvec = _tiled_inputs(dev, nr, H, B, seed=seed)
        plain = (A, dA, cvec, G, M)
        return tt.bwd2_call, tt.bwd2_call, (shift(A), shift(dA), cvec, shift(G), shift(M)), plain
    x = _pair_inputs(dev, nr, nc, H, B, seed=seed)
    bf, vdt = torch.bfloat16, torch.bfloat16 if kernel.endswith("bf16-vectors") else None
    A, dA = (x["A"], x["dA"]) if kernel == "K6a" else (x["A"].to(bf), x["dA"].to(bf))
    Mk, Mi = (x["Mk"], x["Mi"]) if vdt is None else (x["Mk"].to(vdt), x["Mi"].to(vdt))
    plain = (A, dA, x["cvec"], Mk, Mi)
    counter = tp.pair_call if kernel == "K6a" else tp.pair_call.bf16
    return tp.pair_call, counter, (shift(A), shift(dA), x["cvec"], shift(Mk), shift(Mi)), plain


def _mma_plain(kernel, args):
    return tt.plain_bwd2(*args) if kernel == "K4" else tp.plain_pair(*args)


def _check_mma(kernel, wrapper, counter, args, plain_args):
    """Two launches against the plain version: within 1e-4 of each output's
    scale, bitwise equal, two counts."""
    before = counter.launches
    got, again = wrapper(*args), wrapper(*args)
    ref = _mma_plain(kernel, plain_args)
    torch.cuda.synchronize()
    assert counter.launches == before + 2
    for a, b, c in zip(got, ref, again):
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
        _assert_close(a, b, 1e-4)
        assert torch.equal(a, c)  # no atomics: bitwise repeatable


@pytest.mark.requires_cuda
@pytest.mark.parametrize("nr,nc,H,B", MMA_SHAPES, ids=MMA_IDS)
@pytest.mark.parametrize("kernel", MMA_KERNELS)
def test_cuda_mma_sweeps_match_plain(cuda, kernel, nr, nc, H, B):
    if kernel == "K4" and nr != nc:
        pytest.skip("K4 sweeps square planes only")
    _check_mma(kernel, *_mma_case(cuda, kernel, nr, nc, H, B, seed=nr + H))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("nr,nc,H", [(1505, 1505, 128), (300, 200, 13), (641, 641, 8)])
@pytest.mark.parametrize("kernel", MMA_KERNELS)
def test_cuda_mma_sweeps_every_split_match_plain(cuda, kernel, nr, nc, H, monkeypatch):
    """The reduce extents in 1, 2, 5 and ceil(min(nr, nc) / 32) parts (the
    wrappers look their plan up in ops.tiled): each within 1e-4 and bitwise
    repeatable."""
    if kernel == "K4" and nr != nc:
        pytest.skip("K4 sweeps square planes only")
    case = _mma_case(cuda, kernel, nr, nc, H, 1, seed=5)
    for S in (1, 2, 5, -(-min(nr, nc) // tt.MMA_BK)):
        monkeypatch.setattr(tt, "mma_splits", lambda B, nr, nc, H, S=S: S)
        _check_mma(kernel, *case)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("kernel", MMA_KERNELS)
def test_cuda_mma_sweeps_at_any_alignment_match_plain(cuda, kernel, offset):
    """Planes and vectors that start ``offset`` elements into their buffers:
    the wrappers copy planes whose base is not 16-byte aligned, the kernels
    take such vectors by scalar loads, and the entry points themselves
    refuse planes they cannot read by granules."""
    def shifted(x):
        buf = torch.empty(x.numel() + offset, device=cuda, dtype=x.dtype)
        return buf[offset:].view(x.shape).copy_(x)

    nr, nc, H = (300, 300, 16) if kernel == "K4" else (300, 210, 16)
    wrapper, counter, args, plain = _mma_case(cuda, kernel, nr, nc, H, 2, seed=offset,
                                              shift=shifted)
    _check_mma(kernel, wrapper, counter, args, plain)
    out = torch.empty(2 * 2 * max(nr, nc) * H, device=cuda)
    if kernel == "K4":
        A, dA, cvec, G, M = args
        dwpart = torch.empty(2 * 64 * 4, device=cuda)
        err = tt._fn("gncde_tiled_bwd2")(
            A.data_ptr(), dA.data_ptr(), nr, cvec.data_ptr(), G.data_ptr(), M.data_ptr(), 2, H,
            out.data_ptr(), out.data_ptr(), None, dwpart.data_ptr(), out.data_ptr(), 1,
            _build.stream())
    else:
        A, dA, cvec, Mk, Mi = args
        err = tp._fn("gncde_pair")(
            A.data_ptr(), dA.data_ptr(), nr, nc, cvec.data_ptr(), Mk.data_ptr(), Mi.data_ptr(),
            2, H, int(A.dtype == torch.bfloat16), int(Mk.dtype == torch.bfloat16),
            out.data_ptr(), out.data_ptr(), None, 1, _build.stream())
    assert err != 0


@pytest.mark.requires_cuda
def test_cuda_mma_sweeps_raise_on_what_they_do_not_take(cuda, monkeypatch):
    A, dA, M, G, _, cvec = _tiled_inputs(cuda, 70, 5, 1)
    x = _pair_inputs(cuda, 70, 45, 8, 1)
    before = (tt.bwd2_call.launches, tp.pair_call.launches, tp.pair_call.bf16.launches)

    def split(S):
        monkeypatch.setattr(tt, "mma_splits", lambda B, nr, nc, H: S)
        return tt.bwd2_call(A, dA, cvec, G, M)

    bad = [
        lambda: tt.bwd2_call(A.float(), dA, cvec, G, M),  # f32 planes
        lambda: tt.bwd2_call(A, dA, cvec, G.float(), M),  # f32 vectors
        lambda: tt.bwd2_call(A, dA, cvec.double(), G, M),  # f64 coefficients
        lambda: tp.pair_call(x["A"], x["dA"], x["cvec"], x["Mk"].to(torch.bfloat16),
                             x["Mi"].to(torch.bfloat16)),  # bf16 vectors on f32 planes
        lambda: tp.pair_call(x["A"], x["dA"].to(torch.bfloat16), x["cvec"], x["Mk"],
                             x["Mi"]),  # planes of two dtypes
        lambda: tp.pair_call(x["A"], x["dA"], x["cvec"], x["Mi"], x["Mk"]),  # Mk, Mi swapped
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()
    for S in (0, 4):  # 3 reduce tiles at n = 70: no part may be empty of tiles
        with pytest.raises(RuntimeError):
            split(S)
    assert (tt.bwd2_call.launches, tp.pair_call.launches,
            tp.pair_call.bf16.launches) == before


@pytest.mark.requires_cuda
@pytest.mark.parametrize("directed", [False, True])
def test_cuda_plane_grads_launch_k1_and_k11(cuda, directed):
    """Planes that need gradients on the card: the forward still launches
    K1 (and K11 for the fused step), and every cotangent, the planes' too,
    is autograd of the plain version at the saved inputs (as the JAX
    package takes jax.vjp of its reference): the same numbers as autograd
    through the plain version alone."""
    from gncde_tpu_torch.solve.tableaus import get_tableau

    nbasis = 11 if directed else 8
    planes, idx, tau, Z, layers, _ = _inputs(cuda, (8, 8, 8), nbasis=nbasis)
    flat = [t for lp in layers for t in (lp["norm_w"], lp["norm_b"], lp["W"], lp["lin_b"],
                                         *lp["basis"].unbind(0))]
    leaves = [p.clone().requires_grad_() for p in planes]
    Zl = Z.clone().requires_grad_()
    before = mk.megakernel_vf_eval.launches
    out = mk.MegakernelVF.apply(nbasis, False, idx, tau, Zl, *leaves, *flat)
    assert mk.megakernel_vf_eval.launches == before + 1
    W = torch.randn_like(out)
    got = torch.autograd.grad((out * W).sum(), leaves + [Zl])
    ref_leaves = [p.clone().requires_grad_() for p in planes] + [Z.clone().requires_grad_()]
    ref = mk.plain_vf_eval(tuple(ref_leaves[:4]), idx, tau, ref_leaves[4], layers)
    want = torch.autograd.grad((ref * W).sum(), ref_leaves)
    for a, b in zip(got, want):
        _assert_close(a, b, 1e-3)
    if directed:
        return
    # The fused step: one K11 launch forward, the plain step's autograd back.
    B, n, H = Z.shape
    ts = torch.cumsum(torch.full((B, planes[0].shape[1] + 1), 0.2, device=cuda), 1)
    t, h = ts[:, 2] + 0.01, torch.full((B,), 0.05, device=cuda)
    leaves = [p.clone().requires_grad_() for p in planes]
    before = tfs.fused_step_call.launches
    y1, err, f1 = tfs.FusedRKStep.apply(get_tableau("tsit5"), nbasis, False, ts, t, Z, h,
                                        torch.zeros_like(Z), *leaves, *flat)
    assert tfs.fused_step_call.launches == before + 1
    g = torch.autograd.grad((y1 * W).sum() + err.sum() + f1.sum(), leaves)
    assert all(torch.isfinite(x).all() and float(x.abs().max()) > 0 for x in g)


# ---------------------------------------------------------------------------
# The enc_idx path: K7, K6a, K6b
# ---------------------------------------------------------------------------

# Ragged against K6's owned blocks and reduce tiles and K7's 256-column
# CTAs; H reaches each compiled chunk width of K6a (csrc/plane_mma.cu: 8,
# 32, 64 with three chunks at 130) and K6b's ring stages of 32 columns
# (five at 130, the last ragged); (n70, n45) is a rectangular pair.
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


# K6b's and K6b-bf's main-path shapes (chip_smoke.py phases 8 and 22):
# genre-H128 (one CTA a 64 x 64 plane tile, four ring stages), trade-H512
# (16 tiles: the plan splits H in 16 parts), a ragged small shape with two
# elements and a rectangular one whose H takes the scalar vector copies.
K6B_SHAPES = [(1505, 1505, 128, 1), (255, 255, 512, 1), (300, 300, 5, 2), (300, 211, 13, 2)]
K6B_IDS = ["genre-H128", "trade-H512", "n300-H5-B2", "rect-300x211-H13-B2"]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("nr,nc,H,B", K6B_SHAPES, ids=K6B_IDS)
@pytest.mark.parametrize("bf16", [False, True], ids=["K6b", "K6b-bf"])
def test_cuda_k6b_main_shapes_match_plain_and_repeat(cuda, nr, nc, H, B, bf16):
    """K6b (3xTF32) and K6b-bf (bf16 mma.sync) on their plan within 1e-4 of
    the plain version, two launches bitwise equal, each counted once on its
    own counter."""
    x = _pair_inputs(cuda, nr, nc, H, B)
    dt = torch.bfloat16 if bf16 else torch.float32
    args = tuple(x[k].to(dt) for k in ("A", "dA", "Gr", "Mk", "Mi", "Gc"))
    mine, other = ((tp.pair_dw_call.bf16, tp.pair_dw_call) if bf16
                   else (tp.pair_dw_call, tp.pair_dw_call.bf16))
    before = (mine.launches, other.launches)
    got, again = tp.pair_dw_call(*args), tp.pair_dw_call(*args)
    ref = tp.plain_pair_dw(*args)
    torch.cuda.synchronize()
    assert (mine.launches, other.launches) == (before[0] + 2, before[1])
    assert got.shape == (B, 4) and torch.isfinite(got).all()
    _assert_close(got, ref, 1e-4)
    assert torch.equal(got, again)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("splits", [1, 2, 5])
@pytest.mark.parametrize("bf16", [False, True], ids=["K6b", "K6b-bf"])
def test_cuda_k6b_every_split_of_h_matches_plain(cuda, bf16, splits, monkeypatch):
    """Every split of the H extent (n=100 x 70, H=130: five ring stages of
    32 columns in 1, 2 or 5 parts, ``pair_dw_plan`` forced) gives the plain
    version's sums within 1e-4."""
    nr, nc, H, B = 100, 70, 130, 2
    plan = tp.pair_dw_plan(B, nr, nc, H)
    monkeypatch.setattr(tp, "pair_dw_plan", lambda *a: tp.PairDwPlan(
        plan.tiles, splits, plan.tiles * splits))
    x = _pair_inputs(cuda, nr, nc, H, B)
    dt = torch.bfloat16 if bf16 else torch.float32
    args = tuple(x[k].to(dt) for k in ("A", "dA", "Gr", "Mk", "Mi", "Gc"))
    got = tp.pair_dw_call(*args)
    torch.cuda.synchronize()
    _assert_close(got, tp.plain_pair_dw(*args), 1e-4)


@pytest.mark.requires_cuda
def test_cuda_k6b_refuses_a_split_beyond_its_column_chunks(cuda, monkeypatch):
    """No fallback: a plan that splits H into more parts than it has ring
    stages (H=40: two) is refused by the launch, and nothing is counted."""
    x = _pair_inputs(cuda, 70, 70, 40, 1)
    args = tuple(x[k] for k in ("A", "dA", "Gr", "Mk", "Mi", "Gc"))
    monkeypatch.setattr(tp, "pair_dw_plan", lambda *a: tp.PairDwPlan(4, 3, 12))
    before = tp.pair_dw_call.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        tp.pair_dw_call(*args)
    assert tp.pair_dw_call.launches == before


@pytest.mark.requires_cuda
def test_cuda_k6b_plan_tile_matches_the_c_side(cuda):
    """The plane tile and ring width that ``pair_dw_plan`` counts tiles and
    column chunks with (``DW_TILE``, ``DW_HK``, which size the parts
    buffer) are the kernel's own (``pk::DT``, ``pk::DHK``)."""
    import ctypes

    fn = _build.load("plane_mma").gncde_pair_dw_dims
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 2)()
    assert fn(out) == 0
    assert (out[0], out[1]) == (tp.DW_TILE, tp.DW_HK)


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


# K10 one row per lane group: H = 1 and 3 (scalar gathers, groups of 1 and
# 4 lanes), 16 and 32 (float4 gathers, 4 and 8 lanes), 33 (32 lanes, two
# column passes); K = 1, 20 (the flagship's) and 129 (the scaled band's,
# past four 32-slot chunks).
K10_HS = [1, 3, 16, 32, 33]
K10_KS = [1, 20, 129]
K10_MODES = ["batched", "shared-indices", "shared-values", "shared-M", "misaligned-M"]


def _ell_case(dev, n, K, H, B, mode, seed=0):
    """indices with padding slots (n, and one negative) in most rows and
    rows 0 and n - 1 all padding; values; M. ``shared-*`` hands that
    operand over unbatched (batch stride 0); ``misaligned-M`` puts M at a
    4-byte offset (no float4 gathers)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, (B, n, K)).astype(np.int32)
    idx[rng.random((B, n, K)) < 0.3] = n
    idx[:, 0, :] = n
    idx[:, n - 1, :] = n
    if K > 1:
        idx[:, 1, 0] = -1
    indices = torch.tensor(idx, device=dev)
    values = torch.tensor(rng.normal(size=(B, n, K)).astype(np.float32), device=dev)
    M = torch.tensor(rng.normal(size=(B, n, H)).astype(np.float32), device=dev)
    if mode == "shared-indices":
        indices = indices[0]
    elif mode == "shared-values":
        values = values[0]
    elif mode == "shared-M":
        M = M[0]
    elif mode == "misaligned-M":
        buf = torch.empty(M.numel() + 1, device=dev)
        M = buf[1:].view(B, n, H).copy_(M)
    return indices, values, M


@pytest.mark.requires_cuda
@pytest.mark.parametrize("mode", K10_MODES)
@pytest.mark.parametrize("K", K10_KS)
@pytest.mark.parametrize("H", K10_HS)
def test_cuda_k10_rows_match_plain(cuda, H, K, mode):
    n, B = 67, 3
    indices, values, M = _ell_case(cuda, n, K, H, B, mode)
    before = tell.ell_spmm_call.launches
    got = tell.ell_spmm_call(indices, values, M)
    again = tell.ell_spmm_call(indices, values, M)
    ref = tell.plain_ell_spmm(indices, values, M)
    torch.cuda.synchronize()
    assert tell.ell_spmm_call.launches == before + 2
    assert got.shape == ref.shape == (B, n, H)
    _assert_close(got, ref, 1e-4)
    assert torch.equal(got, again)
    assert not got[:, 0].any() and not got[:, n - 1].any()  # all-padding rows


@pytest.mark.requires_cuda
def test_cuda_k10_raises_on_what_it_does_not_take(cuda):
    indices, values, M = _ell_case(cuda, 30, 5, 4, 2, "batched")
    before = tell.ell_spmm_call.launches
    bad = [
        (indices.long(), values, M),  # int64 indices
        (indices, values.double(), M),  # f64 values
        (indices, values, M.to(torch.bfloat16)),  # bf16 M
        (indices.cpu(), values, M),  # indices on the CPU
        (indices, values.cpu(), M),  # values on the CPU
        (indices[:, :20], values[:, :20], M),  # rows differ from M's
        (indices, values[..., :4], M),  # K differs
        (indices, torch.cat([values, values[:1]]), M),  # batches differ
        (indices[0, 0], values, M),  # 1-d indices
    ]
    for args in bad:
        with pytest.raises(ValueError):
            tell.ell_spmm_call(*args)
    assert tell.ell_spmm_call.launches == before


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


def _step_inputs(dev, n, B, widths, seed=0, T=8, nbasis=8):
    """Per-element planes and knots, y, f0, h (one finished element: h = 1
    past the last knot) and layer params (basis ``(nbasis, 2)``), from
    ``seed``."""
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
            basis=t(rng.uniform(-1 / 15, 1 / 15, (nbasis, 2)))))
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
        tab, 8, False, ts, tq_, y_, h_, f0_, *planes, *fl))
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


# ---------------------------------------------------------------------------
# The directed 11-term basis: K1d, K2d, K11d
# ---------------------------------------------------------------------------

DIR_CASES = [((8, 8, 8), True), ((32, 32, 32, 32, 512), True), ((8, 8, 8), False)]
DIR_IDS = ["square-per-element", "trade-widths", "shared-planes"]


def _assert_asymmetric(planes, idx, tau):
    """Column sums of A(tau) differ from its row sums, so a row/column swap
    in a directed term cannot pass."""
    A, _ = mk.hermite(planes, idx, tau)
    rA, cA = A.sum(-1), A.sum(-2)
    assert float((cA - rA).abs().max()) > 0.1 * float(rA.abs().max())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("widths,per_element", DIR_CASES, ids=DIR_IDS)
def test_cuda_k1_directed_matches_plain(cuda, widths, per_element):
    planes, idx, tau, Z, layers, _ = _inputs(cuda, widths, per_element, seed=7, nbasis=11)
    _assert_asymmetric(planes, idx, tau)
    before = mk.megakernel_vf_eval.launches
    got = mk.megakernel_vf_eval(planes, idx, tau, Z, layers)
    again = mk.megakernel_vf_eval(planes, idx, tau, Z, layers)
    ref = mk.plain_vf_eval(planes, idx, tau, Z, layers)
    torch.cuda.synchronize()
    assert mk.megakernel_vf_eval.launches == before + 2
    assert torch.equal(got, again)  # the column sums too: no atomics
    _assert_close(got, ref, 1e-4)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("need_tau", [False, True])
@pytest.mark.parametrize("case", [*DIR_CASES, *K2_WIDE], ids=[*DIR_IDS, *K2_WIDE_IDS])
def test_cuda_k2_directed_matches_plain(cuda, case, need_tau):
    inputs = _k2_case(cuda, case, seed=8, nbasis=11)
    _assert_asymmetric(*inputs[:3])
    _check_k2(inputs, need_tau, 11)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n,B,widths,method", STEP_CASES[:3], ids=STEP_IDS[:3])
def test_cuda_fused_step_directed_matches_plain_and_repeats(cuda, n, B, widths, method):
    """K11d against its plain version, 1e-4 of each output's scale, a
    finished element included; a second launch bitwise equal."""
    from gncde_tpu_torch.solve.tableaus import get_tableau

    tab = get_tableau(method)
    planes, ts, tq, y, h, f0, layers = _step_inputs(cuda, n, B, widths, seed=9, nbasis=11)
    got = tfs.fused_step_call(planes, ts, tq, y, h, f0, layers, tab)
    again = tfs.fused_step_call(planes, ts, tq, y, h, f0, layers, tab)
    ref = tfs._step_reference(planes, ts, tq, y, h, f0, layers, tab)
    torch.cuda.synchronize()
    for a, b, c in zip(got, ref, again):
        assert torch.isfinite(a).all()
        assert torch.equal(a, c)
        _assert_close(a, b, 1e-4)


@pytest.mark.requires_cuda
def test_cuda_fused_step_directed_backward_matches_autograd_of_plain(cuda):
    """K11d's chain rule (one K2d per stage) against autograd of the plain
    step: y, f0, t, h and every layer parameter, 1e-3 of each scale."""
    from gncde_tpu_torch.solve.tableaus import get_tableau

    tab = get_tableau("tsit5")
    planes, ts, tq, y, h, f0, layers = _step_inputs(cuda, 400, 4, (16, 16, 16), seed=10,
                                                    nbasis=11)
    flat = [p for lp in layers for p in
            (lp["norm_w"], lp["norm_b"], lp["W"], lp["lin_b"], *lp["basis"])]
    rng = np.random.default_rng(11)
    W = [torch.tensor(rng.normal(size=y.shape).astype(np.float32), device=cuda)
         for _ in range(3)]

    def grads(fn):
        leaves = [x.detach().clone().requires_grad_(True) for x in (tq, y, h, f0, *flat)]
        tq_, y_, h_, f0_, *fl = leaves
        outs = fn(tq_, y_, h_, f0_, fl)
        sum((o * w).sum() for o, w in zip(outs, W)).backward()
        return [x.grad for x in leaves]

    got = grads(lambda tq_, y_, h_, f0_, fl: tfs.FusedRKStep.apply(
        tab, 11, False, ts, tq_, y_, h_, f0_, *planes, *fl))
    ref = grads(lambda tq_, y_, h_, f0_, fl: tfs._step_reference(
        planes, ts, tq_, y_, h_, f0_, mk._unflatten(fl, 11), tab)[:3])
    for a, b in zip(got, ref):
        _assert_close(a, b, 1e-3)


@pytest.mark.requires_cuda
def test_cuda_field_directed_megakernel_matches_dense(cuda):
    """The directed field on the card: K1d forward + K2d backward through the
    autograd Function against the dense backend, value and every gradient
    (the unused index encoder and MLPs get none on either route), with a
    per-element query time that needs its own gradient (dtau)."""
    H = 8
    planes, _, _, Z, _, _ = _inputs(cuda, (H, H), seed=12)
    ts = torch.linspace(0.0, 1.0, T, device=cuda).repeat(B, 1)
    ts[1] *= 1.3
    ctrl = MatrixControl(CubicInterpolation(ts, planes))
    vf = TDVF(H, H, H, 2, 1, N, idx_dim=4, generator=torch.Generator().manual_seed(0)).to(cuda)
    t0 = torch.tensor([0.1, 0.55, 0.93], device=cuda)
    results = {}
    try:
        for name in ("dense", "megakernel"):
            ops.set_fusion_backend(name)
            vf.zero_grad(set_to_none=True)
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
                p.grad.clone() for p in vf.gnn_layers.parameters()]
            assert all(p.grad is None for p in vf.idx_enc.parameters())
    finally:
        ops.set_fusion_backend("auto")
    _assert_close(results["megakernel"][0], results["dense"][0], 1e-4)
    for a, b in zip(results["megakernel"][1:], results["dense"][1:]):
        _assert_close(a, b, 1e-3)


@pytest.mark.requires_cuda
def test_cuda_wrong_basis_shape_raises(cuda):
    """K1, K2 and K11 take an (8, 2) or (11, 2) basis, one size for the
    stack; another shape, or a stack that mixes the two, raises before any
    launch."""
    from gncde_tpu_torch.solve.tableaus import get_tableau

    planes, idx, tau, Z, layers, G = _inputs(cuda, (8, 8, 8))
    _, _, _, _, layers11, _ = _inputs(cuda, (8, 8, 8), nbasis=11)
    bad = {"seven": [dict(lp, basis=lp["basis"][:7]) for lp in layers],
           "mixed": [layers[0], layers11[1]]}
    before = mk.megakernel_vf_eval.launches, mkb.megakernel_vf_bwd.launches
    for stack in bad.values():
        with pytest.raises(ValueError, match=r"\(8, 2\) or \(11, 2\)"):
            mk.megakernel_vf_eval(planes, idx, tau, Z, stack)
        with pytest.raises(ValueError, match=r"\(8, 2\) or \(11, 2\)"):
            mkb.megakernel_vf_bwd(planes, idx, tau, Z, stack, G, True)
    assert (mk.megakernel_vf_eval.launches, mkb.megakernel_vf_bwd.launches) == before
    sp, ts, tq, y, h, f0, slayers = _step_inputs(cuda, 40, 2, (8, 8), nbasis=11)
    steps = tfs.fused_step_call.launches
    with pytest.raises(ValueError, match=r"\(8, 2\) or \(11, 2\)"):
        tfs.fused_step_call(sp, ts, tq, y, h, f0, [dict(lp, basis=lp["basis"][:10])
                                                   for lp in slayers], get_tableau("tsit5"))
    assert tfs.fused_step_call.launches == steps


# ---------------------------------------------------------------------------
# fusion_precision bf16: K1bf, K2bf, K11bf (either basis) on bf16 planes
# ---------------------------------------------------------------------------
# The kernels and their plain versions form the same bf16 operands (the
# Hermite evaluation unfused in both, B1, B2^T and C^T rounded at JAX's
# points) from the same data, but their f32 intermediates (each layer's M,
# the cotangents, so the ReLU masks) differ in their last bits (summation
# order), and rounding one to bf16 moves it by a whole bf16 ulp; through a
# deep stack the flips compound. So the plain version runs layer by layer
# from the kernel's own intermediates, read back from its scratch
# (chip_smoke.py's bf16_k1_stepwise, bf16_k2_stepwise and
# bf16_step_bwd_stepwise), and every layer's values and every output are
# held to the f32 kernels' bounds: forward 1e-4, cotangents 1e-3. K11bf's
# stage derivatives: one plain K1bf eval each at the stage input formed from
# the kernel's own, y1 and err formed from them, 1e-4 as K11.

BF16_CASES = [((8, 8, 8), True, 8), ((5, 8, 3), True, 8), ((8, 8, 8), False, 8),
              ((32, 32, 32, 32, 512), True, 8), ((8, 8, 8), True, 11),
              ((32, 32, 32, 32, 512), True, 11)]
BF16_IDS = ["square-per-element", "widths-5-8-3", "shared-planes", "trade-widths",
            "directed-square", "directed-trade-widths"]


def _bf16(planes):
    return tuple(p.to(torch.bfloat16).contiguous() for p in planes)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("widths,per_element,nbasis", BF16_CASES, ids=BF16_IDS)
def test_cuda_k1bf_matches_plain_and_repeats(cuda, widths, per_element, nbasis):
    planes, idx, tau, Z, layers, _ = _inputs(cuda, widths, per_element, seed=12, nbasis=nbasis)
    planes = _bf16(planes)
    before = mk.megakernel_vf_eval.launches, mk.megakernel_vf_eval.bf16.launches
    got, (errs, _) = chip_smoke.bf16_k1_stepwise(torch, planes, idx, tau, Z, layers)
    again = mk.megakernel_vf_eval(planes, idx, tau, Z, layers, bf16=True)
    torch.cuda.synchronize()
    # The bf16 counter moved, the f32 one did not.
    assert (mk.megakernel_vf_eval.launches, mk.megakernel_vf_eval.bf16.launches) == (
        before[0], before[1] + 2)
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)  # no atomics: bitwise repeatable
    assert set(errs) == {"out"} | {f"M{l}" for l in range(len(layers))}
    assert max(errs.values()) <= 1e-4, errs


@pytest.mark.requires_cuda
@pytest.mark.parametrize("need_tau", [False, True])
@pytest.mark.parametrize("widths,per_element,nbasis", BF16_CASES, ids=BF16_IDS)
def test_cuda_k2bf_matches_plain(cuda, widths, per_element, nbasis, need_tau):
    planes, idx, tau, Z, layers, G = _inputs(cuda, widths, per_element, seed=13,
                                             nbasis=nbasis)
    planes = _bf16(planes)
    before = mkb.megakernel_vf_bwd.launches, mkb.megakernel_vf_bwd.bf16.launches
    got, (errs, _) = chip_smoke.bf16_k2_stepwise(torch, planes, idx, tau, Z, layers, G,
                                                 need_tau)
    again = mkb.megakernel_vf_bwd(planes, idx, tau, Z, layers, G, need_tau, bf16=True)
    torch.cuda.synchronize()
    assert (mkb.megakernel_vf_bwd.launches, mkb.megakernel_vf_bwd.bf16.launches) == (
        before[0], before[1] + 2)
    assert torch.equal(got[1], again[1])
    L = len(layers)
    assert {f"dbasis{l}" for l in range(L)} | {f"g{l}" for l in range(1, L)} <= set(errs)
    assert ("dtau" in errs) == need_tau
    for gl in got[2]:
        assert gl[4].shape == (B, nbasis, 2)
    assert max(errs.values()) <= 1e-3, errs


@pytest.mark.requires_cuda
@pytest.mark.parametrize("nbasis", [8, 11], ids=["undirected", "directed"])
@pytest.mark.parametrize("n,B,widths,method", STEP_CASES[:3], ids=STEP_IDS[:3])
def test_cuda_fused_step_bf16_matches_plain_and_repeats(cuda, n, B, widths, method, nbasis):
    """K11bf against its plain version stage by stage (each stage one plain
    K1bf eval at the stage input formed from the kernel's stage
    derivatives, y1 and err formed from them: 1e-4), a finished element
    included; a second launch bitwise equal; only the bf16 counter
    moves."""
    from gncde_tpu_torch.solve.tableaus import get_tableau

    tab = get_tableau(method)
    planes, ts, tq, y, h, f0, layers = _step_inputs(cuda, n, B, widths, seed=14,
                                                    nbasis=nbasis)
    planes = _bf16(planes)
    before = tfs.fused_step_call.launches, tfs.fused_step_call.bf16.launches
    got = tfs.fused_step_call(planes, ts, tq, y, h, f0, layers, tab, bf16=True)
    again = tfs.fused_step_call(planes, ts, tq, y, h, f0, layers, tab, bf16=True)
    ref = tfs._step_reference(planes, ts, tq, y, h, f0, layers, tab, bf16=True,
                              given_ks=got[3])
    torch.cuda.synchronize()
    assert tfs.fused_step_call.launches == before[0]
    assert tfs.fused_step_call.bf16.launches >= before[1] + 2
    for what, a, b, c in zip(("y1", "err", "f1", "ks"), got, ref, again):
        assert torch.isfinite(a).all()
        assert torch.equal(a, c)
        _assert_close(a, b, 1e-4)


# K2bf's and K2dbf's main-path shapes: the flagship (phase 21), the trade
# field (its 512-wide layer in four column groups of 16-row CTAs) and the
# largest n the vector-field kernels serve.
K2BF_SHAPES = {"flagship": (400, 4, (16, 16, 16)), "trade": (255, 4, (32, 32, 32, 32, 512)),
               "n640": (640, 1, (64, 64, 64))}


def _flat_bwd(out):
    dtau, dZ, per_layer = out
    return [dtau, dZ] + [x for layer in per_layer for x in layer]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("need_tau", [False, True])
@pytest.mark.parametrize("nbasis", [8, 11], ids=["K2bf", "K2dbf"])
@pytest.mark.parametrize("shape", list(K2BF_SHAPES))
def test_cuda_k2bf_main_shapes_match_plain_layer_by_layer(cuda, shape, nbasis, need_tau):
    """K2bf and K2dbf on the bf16 sweep's plan at the main paths' shapes,
    with and without dtau: every output and every layer's M, x and g within
    1e-3 of the plain bf16 version run layer by layer, two launches bitwise
    equal."""
    n, B, widths = K2BF_SHAPES[shape]
    planes, idx, tau, Z, layers, G = chip_smoke.make_inputs(torch, n, B, widths, seed=5,
                                                            nbasis=nbasis)
    planes = _bf16(planes)
    got, (errs, _) = chip_smoke.bf16_k2_stepwise(torch, planes, idx, tau, Z, layers, G,
                                                 need_tau)
    again = mkb.megakernel_vf_bwd(planes, idx, tau, Z, layers, G, need_tau, bf16=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(_flat_bwd(got), _flat_bwd(again)))
    assert ("dtau" in errs) == need_tau
    assert max(errs.values()) <= 1e-3, errs


@pytest.mark.requires_cuda
@pytest.mark.parametrize("bm", [16, 8, 4])
def test_cuda_k2bf_every_sweep_plan_matches_plain(cuda, bm, monkeypatch):
    """Every CTA height of the bf16 sweep (the directed trade field, with
    dtau; 4-row CTAs fill half of the MMA's 8-row blocks) within K2's bound
    layer by layer."""
    monkeypatch.setattr(mkb, "BWD_BMS", (bm,))
    planes, idx, tau, Z, layers, G = chip_smoke.make_inputs(torch, *K2_WIDE[0], seed=3,
                                                            nbasis=11)
    _, (errs, _) = chip_smoke.bf16_k2_stepwise(torch, _bf16(planes), idx, tau, Z, layers, G,
                                               True)
    assert max(errs.values()) <= 1e-3, errs


@pytest.mark.requires_cuda
@pytest.mark.parametrize("nbasis", [8, 11], ids=["undirected", "directed"])
def test_cuda_k2bf_recompute_is_bitwise_k1bf(cuda, nbasis):
    """K2bf recomputes the forward with K1bf's own passes: its M_l and x_l
    are K1bf's bit for bit."""
    n, B, widths = K2BF_SHAPES["trade"]
    planes, idx, tau, Z, layers, G = chip_smoke.make_inputs(torch, n, B, widths,
                                                            nbasis=nbasis)
    planes = _bf16(planes)
    t1, t2 = {}, {}
    mk.megakernel_vf_eval(planes, idx, tau, Z, layers, bf16=True, trace=t1)
    mkb.megakernel_vf_bwd(planes, idx, tau, Z, layers, G, False, bf16=True, trace=t2)
    torch.cuda.synchronize()
    assert len(t1["M"]) == len(t2["M"]) == len(layers)
    assert all(torch.equal(a, b) for a, b in zip(t1["M"], t2["M"]))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("nbasis", [8, 11], ids=["undirected", "directed"])
def test_cuda_fused_step_bf16_backward_matches_plain_chain(cuda, nbasis):
    """K11bf's backward (one K2bf per stage): its gradients with respect to
    t, y, h, f0 and every layer parameter are bitwise those of the explicit
    chain over its K2bf launches, and every launch holds the plain K2bf
    layer by layer within 1e-3."""
    from gncde_tpu_torch.solve.tableaus import get_tableau

    tab = get_tableau("tsit5")
    planes, ts, tq, y, h, f0, layers = _step_inputs(cuda, 400, 4, (16, 16, 16), seed=15,
                                                    nbasis=nbasis)
    planes = _bf16(planes)
    flat = [p for lp in layers for p in
            (lp["norm_w"], lp["norm_b"], lp["W"], lp["lin_b"], *lp["basis"])]
    rng = np.random.default_rng(16)
    W = [torch.tensor(rng.normal(size=y.shape).astype(np.float32), device=cuda)
         for _ in range(3)]
    leaves = [x.detach().clone().requires_grad_(True) for x in (tq, y, h, f0, *flat)]
    outs = tfs.FusedRKStep.apply(tab, nbasis, True, ts, *leaves[:4], *planes, *leaves[4:])
    torch.autograd.backward(outs, W)
    ks = tfs.fused_step_call(planes, ts, tq, y, h, f0, layers, tab, bf16=True)[3]
    (tbar, ybar, hbar, f0bar, d_flat), stages = chip_smoke.bf16_step_bwd_stepwise(
        torch, tab, planes, ts, tq, y, h, f0, ks, layers, W, (True,) * 5)
    assert len(stages) == tab.num_stages - 1
    for a, b in zip(leaves, [tbar, ybar, hbar, f0bar, *d_flat]):
        assert torch.equal(a.grad, b)
    for errs, _ in stages:
        assert "dtau" in errs and max(errs.values()) <= 1e-3, errs


# The bf16 row pass (rows_body's bf16 instantiation: K1bf, K1dbf, K2bf's
# recompute, K11bf's stages) at the main paths' shapes: the flagship, the
# bench field (32 x 4), the trade field (its 512-wide last layer in four
# column groups), the largest n (640, one element) and an odd n whose rows
# fill no CTA height (300: a partial last CTA, npad 320) with odd widths
# (4-byte M copies).
K1BF_ROW_SHAPES = {"flagship": (400, 4, (16, 16, 16)), "bench": (400, 4, (32, 32, 32, 32)),
                   "trade": (255, 4, (32, 32, 32, 32, 512)), "n640": (640, 1, (64, 64, 64)),
                   "odd-n300": (300, 2, (13, 37, 70))}


def _bf16_inputs(shape, nbasis, seed=0):
    n, nb, widths = K1BF_ROW_SHAPES[shape]
    planes, idx, tau, Z, layers, G = chip_smoke.make_inputs(torch, n, nb, widths, seed=seed,
                                                            nbasis=nbasis)
    return _bf16(planes), idx, tau, Z, layers, G


@pytest.mark.requires_cuda
@pytest.mark.parametrize("nbasis", [8, 11], ids=["K1bf", "K1dbf"])
@pytest.mark.parametrize("shape", list(K1BF_ROW_SHAPES))
def test_cuda_k1bf_row_pass_main_shapes_match_plain_layer_by_layer(cuda, shape, nbasis):
    """K1bf and K1dbf on the bf16 row pass: the output and every layer's M
    within 1e-4 of the plain bf16 version run layer by layer from the
    kernel's own M; two launches bitwise equal."""
    planes, idx, tau, Z, layers, _ = _bf16_inputs(shape, nbasis, seed=31)
    got, (errs, _) = chip_smoke.bf16_k1_stepwise(torch, planes, idx, tau, Z, layers)
    again = mk.megakernel_vf_eval(planes, idx, tau, Z, layers, bf16=True)
    torch.cuda.synchronize()
    assert got.shape == (Z.shape[0], Z.shape[1], layers[-1]["W"].shape[0])
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    assert max(errs.values()) <= 1e-4, errs


@pytest.mark.requires_cuda
@pytest.mark.parametrize("bm", [16, 8, 4])
@pytest.mark.parametrize("shape", ["trade", "odd-n300", "n640"])
def test_cuda_k1bf_every_row_plan_gives_the_same_bits(cuda, shape, bm, monkeypatch):
    """The bf16 pass's plan only partitions the work: every CTA height (and
    so every cc and column group it takes) gives the default plan's output
    and per-layer M bit for bit, on the directed basis."""
    planes, idx, tau, Z, layers, _ = _bf16_inputs(shape, 11, seed=32)
    t0, t1 = {}, {}
    default = mk.megakernel_vf_eval(planes, idx, tau, Z, layers, bf16=True, trace=t0)
    monkeypatch.setattr(mk, "ROW_BMS", (bm,))
    got = mk.megakernel_vf_eval(planes, idx, tau, Z, layers, bf16=True, trace=t1)
    torch.cuda.synchronize()
    assert torch.equal(got, default)
    assert all(torch.equal(a, b) for a, b in zip(t0["M"], t1["M"]))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("nbasis", [8, 11], ids=["K2bf", "K2dbf"])
@pytest.mark.parametrize("shape", ["flagship", "n640", "odd-n300"])
def test_cuda_k2bf_recompute_is_bitwise_k1bf_at_the_row_pass_shapes(cuda, shape, nbasis):
    """K2bf's forward recompute runs K1bf's bf16 row pass on K1bf's plan:
    its M_l are K1bf's bit for bit at the flagship, n=640 and odd shapes
    (the trade's in test_cuda_k2bf_recompute_is_bitwise_k1bf)."""
    planes, idx, tau, Z, layers, G = _bf16_inputs(shape, nbasis, seed=33)
    t1, t2 = {}, {}
    mk.megakernel_vf_eval(planes, idx, tau, Z, layers, bf16=True, trace=t1)
    mkb.megakernel_vf_bwd(planes, idx, tau, Z, layers, G, False, bf16=True, trace=t2)
    torch.cuda.synchronize()
    assert len(t1["M"]) == len(t2["M"]) == len(layers)
    assert all(torch.equal(a, b) for a, b in zip(t1["M"], t2["M"]))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("nbasis", [8, 11], ids=["K11bf", "K11dbf"])
@pytest.mark.parametrize("shape", ["flagship", "bench"])
def test_cuda_fused_step_bf16_is_bitwise_the_per_stage_route(cuda, shape, nbasis):
    """K11bf (K11dbf) runs each stage on the bf16 row pass and the step's
    plans: y1, err, f1 and every stage derivative bit for bit the per-stage
    K1bf route's (six K1bf launches on K1bf's plans and the solver's stage
    combinations)."""
    from gncde_tpu_torch.solve.tableaus import get_tableau

    tab = get_tableau("tsit5")
    s = chip_smoke.STEP_SHAPES[shape]
    planes, ts, t, y, h, f0, layers = chip_smoke.make_step_inputs(torch, **s, nbasis=nbasis)
    planes = _bf16(planes)
    got = tfs.fused_step_call(planes, ts, t, y, h, f0, layers, tab, bf16=True)
    ref = tfs._step_reference(planes, ts, t, y, h, f0, layers, tab, True,
                              stage=lambda *a: mk.megakernel_vf_eval(*a, bf16=True))
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.requires_cuda
def test_cuda_k1bf_and_k11bf_largest_row_plans_launch_at_n640(cuda, monkeypatch):
    """The largest shared memory the bf16 row pass's plans ask for (n=640,
    CTAs of 16 rows, 128-column groups: 101,888 bytes; K11bf's stage plans,
    CTAs of 8 rows: 52,480 bytes) within the kernels' own allowances, on
    both bases: K1bf layer by layer within 1e-4 of its plain version, K11bf
    bitwise its per-stage route."""
    from gncde_tpu_torch.solve.tableaus import get_tableau

    n, widths = 640, (64, 64, 512)
    monkeypatch.setattr(mk, "ROW_BMS", (16,))
    assert max(p.smem_bytes for p in mk.row_plans(n, 1, widths, bf16=True)) == 101_888
    for nbasis in (8, 11):
        planes, idx, tau, Z, layers, _ = chip_smoke.make_inputs(torch, n, 1, widths,
                                                                nbasis=nbasis)
        _, (errs, _) = chip_smoke.bf16_k1_stepwise(torch, _bf16(planes), idx, tau, Z, layers)
        assert max(errs.values()) <= 1e-4, errs
    monkeypatch.setattr(tfs, "STEP_BMS", (8,))
    planes, ts, t, y, h, f0, layers = chip_smoke.make_step_inputs(torch, 640, 1, (64, 64, 64))
    assert tfs.step_smem_bytes(640, 1, layers, bf16=True) == 52_480
    tab = get_tableau("bosh3")
    got = tfs.fused_step_call(_bf16(planes), ts, t, y, h, f0, layers, tab, bf16=True)
    ref = tfs._step_reference(_bf16(planes), ts, t, y, h, f0, layers, tab, True,
                              stage=lambda *a: mk.megakernel_vf_eval(*a, bf16=True))
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["K1", "K1bf"])
def test_cuda_row_shared_memory_matches_the_c_side(cuda, bf16):
    """The planner's shared memory per row-pass CTA (``row_smem_bytes``) is
    what the launch computes (``gncde_row_smem_bytes``: ``rows_smem_floats``
    or, bf16, ``rows_smem_bytes_bf``) at every CTA height, group width and
    layer width, for n off every tile multiple."""
    import ctypes

    fn = _build.load("megakernel_fwd").gncde_row_smem_bytes
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    for n in (1, 40, 77, 255, 300, 400, 640):
        for bm in (4, 8, 16):
            for cw in (32, 64, 128):
                for H in (1, 5, 16, 33, 64, 65, 130, 512, 1024):
                    assert mk.row_smem_bytes(n, bm, cw, H, bf16) == fn(
                        n, bm, cw, H, int(bf16)), (n, bm, cw, H)


@pytest.mark.requires_cuda
def test_cuda_bf16_kernels_take_only_bf16_planes(cuda):
    """No fallback: K1bf, K2bf and K11bf refuse f32 planes (and K1, K2, K11
    bf16 ones) before any launch."""
    from gncde_tpu_torch.solve.tableaus import get_tableau

    planes, idx, tau, Z, layers, G = _inputs(cuda, (8, 8, 8))
    counters = (mk.megakernel_vf_eval, mk.megakernel_vf_eval.bf16, mkb.megakernel_vf_bwd,
                mkb.megakernel_vf_bwd.bf16, tfs.fused_step_call, tfs.fused_step_call.bf16)
    before = [c.launches for c in counters]
    for p, bf16 in ((planes, True), (_bf16(planes), False)):
        with pytest.raises(ValueError, match="planes must be"):
            mk.megakernel_vf_eval(p, idx, tau, Z, layers, bf16=bf16)
        with pytest.raises(ValueError, match="planes must be"):
            mkb.megakernel_vf_bwd(p, idx, tau, Z, layers, G, True, bf16=bf16)
    sp, ts, tq, y, h, f0, slayers = _step_inputs(cuda, 40, 2, (8, 8))
    with pytest.raises(ValueError, match="planes must be"):
        tfs.fused_step_call(sp, ts, tq, y, h, f0, slayers, get_tableau("tsit5"), bf16=True)
    assert [c.launches for c in counters] == before


# ---------------------------------------------------------------------------
# The bf16 enc_idx route: K7bf, K6a-bf, K6b-bf
# ---------------------------------------------------------------------------
# K7bf rounds its f32 chain once to bf16: an f32 last-bit difference moves
# an element by one bf16 ulp, so it is held to one ulp per element beyond
# K7's f32 bound (chip_smoke.bf16_ulps), and it equals K7's f32 output
# rounded once, bit for bit (the same device code up to the store). K6a-bf
# and K6b-bf take the same bf16 operands as their plain versions and form
# B1/B2 with the same roundings; only the order of the f32 sums differs
# (1e-4, as K6a/K6b).


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n,B,depth", [(300, 2, 2), (37, 1, 1), (90, 1, 3)],
                         ids=["n300-d2-B2", "n37-d1", "n90-d3"])
def test_cuda_modulate_bf16_matches_plain(cuda, n, B, depth):
    rng = np.random.default_rng(2)
    A = torch.tensor(rng.uniform(0.0, 1.0, (B, n, n)).astype(np.float32), device=cuda)
    dA = torch.tensor(rng.normal(0.0, 0.5, (B, n, n)).astype(np.float32), device=cuda)
    emb = torch.tensor(rng.normal(size=(n, 6)).astype(np.float32), device=cuda)
    ma, md = _mlp_pair(8, depth, 6, cuda)
    with torch.no_grad():
        ref = tmod.plain_modulate_pair(A, dA, ma, md, emb, torch.bfloat16)
        before = (tmod.modulate_pair.launches, tmod.modulate_pair.bf16.launches)
        got = tmod.modulate_pair(A, dA, ma, md, emb, torch.bfloat16)
        again = tmod.modulate_pair(A, dA, ma, md, emb, torch.bfloat16)
        f32 = tmod.modulate_pair(A, dA, ma, md, emb)
    torch.cuda.synchronize()
    assert (tmod.modulate_pair.launches, tmod.modulate_pair.bf16.launches) == (
        before[0] + 1, before[1] + 2)
    for a, b, c, d in zip(got, ref, again, f32):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        assert chip_smoke.bf16_ulps(torch, a, b) <= chip_smoke.K7BF_ULPS
        assert torch.equal(a, c) and torch.equal(a, d.to(torch.bfloat16))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("nr,nc,H,B", PAIR_CASES, ids=PAIR_IDS)
@pytest.mark.parametrize("kernel", ["K6a-bf-f32-vectors", "K6a-bf-bf16-vectors", "K6b-bf"])
def test_cuda_pair_bf16_kernel_matches_plain(cuda, kernel, nr, nc, H, B):
    x = _pair_inputs(cuda, nr, nc, H, B)
    bf = torch.bfloat16
    A, dA = x["A"].to(bf), x["dA"].to(bf)
    vdt = torch.float32 if kernel == "K6a-bf-f32-vectors" else bf
    V = {k: x[k].to(vdt) for k in ("Mk", "Mi", "Gr", "Gc")}
    if kernel.startswith("K6a"):
        args = (A, dA, x["cvec"], V["Mk"], V["Mi"])
        wrapper, plain = tp.pair_call, tp.plain_pair
    else:
        args = (A, dA, V["Gr"], V["Mk"], V["Mi"], V["Gc"])
        wrapper, plain = tp.pair_dw_call, tp.plain_pair_dw
    before = (wrapper.launches, wrapper.bf16.launches)
    got, again, ref = wrapper(*args), wrapper(*args), plain(*args)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.bf16.launches) == (before[0], before[1] + 2)
    if kernel == "K6b-bf":
        got, again, ref = (got,), (again,), (ref,)
    for a, b, c in zip(got, ref, again):
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
        _assert_close(a, b, 1e-4)
        assert torch.equal(a, c)


@pytest.mark.requires_cuda
def test_cuda_enc_idx_bf16_field_matches_plain_stack(cuda):
    """The directed enc_idx field under bf16 on the card (K7bf, K6a-bf per
    layer, K6a-bf + K6b-bf per layer backward) against the plain versions
    on the CPU from the route's own planes, inputs and cotangents
    (chip_smoke phase 25's check at n = 150), within the script's bounds."""
    vf, ctrl, y, t = chip_smoke.enc_idx_micro_case(torch, 150, 8, 3, 32)
    ops.set_fusion_precision("bf16")
    try:
        errs, launches, _ = chip_smoke.enc_idx_bf16_errors(torch, vf, ctrl, y, t)
    finally:
        ops.set_fusion_precision("f32")
    assert (launches["K7bf"], launches["K6a-bf"], launches["K6b-bf"]) == (1, 6, 3)
    assert not any(launches[k] for k in ("K7", "K6a", "K6b", "K1", "K3"))
    assert errs["layers_records"] == 3
    chip_smoke.check_enc_idx_bf16(errs, "n=150")


@pytest.mark.requires_cuda
def test_cuda_bf16_enc_idx_wrappers_raise_instead_of_falling_back(cuda):
    """K6a-bf takes bf16 vectors only on bf16 planes, K6b-bf bf16 operands
    only (and K6b f32 ones only), K7 an f32 or bf16 output only: each
    refusal raises before any launch."""
    x = _pair_inputs(cuda, 70, 70, 5, 1)
    bf = torch.bfloat16
    counters = (tp.pair_call, tp.pair_call.bf16, tp.pair_dw_call, tp.pair_dw_call.bf16,
                tmod.modulate_pair, tmod.modulate_pair.bf16)
    before = [c.launches for c in counters]
    with pytest.raises(ValueError):  # f32 planes with bf16 vectors
        tp.pair_call(x["A"], x["dA"], x["cvec"], x["Mk"].to(bf), x["Mi"].to(bf))
    with pytest.raises(ValueError):  # planes of two dtypes
        tp.pair_call(x["A"].to(bf), x["dA"], x["cvec"], x["Mk"], x["Mi"])
    with pytest.raises(ValueError):  # bf16 planes with f32 K6b operands
        tp.pair_dw_call(x["A"].to(bf), x["dA"].to(bf), x["Gr"], x["Mk"], x["Mi"], x["Gc"])
    ma, md = _mlp_pair(8, 2, 6, cuda)
    with pytest.raises(ValueError):
        tmod.modulate_pair(x["A"], x["dA"], ma, md, torch.zeros((70, 6), device=cuda),
                           torch.float16)
    assert [c.launches for c in counters] == before


# ---------------------------------------------------------------------------
# The megakernel design probes (ops/mk_probe.py): K1-4mm (P1, P5 v4mm*),
# K1bf's first row pass, fwd_rows, with the probe flags (P3 current, red,
# notr; P4's ablations and full), and the variants that are K1bf (P2, P5
# full) or K11bf (P6 fusedstep)
# ---------------------------------------------------------------------------
# Each eval variant against its plain version on the same bf16 planes, layer
# by layer from the kernel's own M (chip_smoke.probe_stepwise), at K1bf's
# bound (1e-4; P4 dma_only, f32 row sums, 1e-5). P4 full is P3 current's
# launch, and P3 notr computes its arithmetic: both bitwise P3 current (the
# first row pass with every flag off); P2 current and P5 full bitwise K1bf.

PROBE_WIDTHS = [(8, 8, 8), (32, 32, 32, 32)]
PROBE_IDS = ["8x3", "32x4"]
EVAL_VARIANTS = [k for k, v in mp.VARIANTS.items() if v.kind == "eval"]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("widths", PROBE_WIDTHS, ids=PROBE_IDS)
@pytest.mark.parametrize("key", EVAL_VARIANTS)
def test_cuda_probe_variant_matches_plain(cuda, key, widths):
    planes, idx, tau, Z, layers, _ = _inputs(cuda, widths, True, seed=21)
    planes = _bf16(planes)
    v = mp.VARIANTS[key]
    rvec = mp.red_operand(planes, idx, tau) if v.needs_red else None
    before = v.launches
    got, (errs, _) = chip_smoke.probe_stepwise(torch, v, planes, idx, tau, Z, layers, rvec)
    again = v(planes, idx, tau, Z, layers, rvec=rvec)
    torch.cuda.synchronize()
    assert v.launches == before + 2
    assert torch.isfinite(got).all() and torch.equal(got, again)
    assert max(errs.values()) <= (1e-5 if key == "P4/dma_only" else 1e-4), errs
    if key in ("P4/full", "P3/notr"):
        assert torch.equal(got, mp.launch_k1bf_probe(planes, idx, tau, Z, layers))
    if key in ("P2/current", "P5/full"):
        assert torch.equal(got, mk.megakernel_vf_eval(planes, idx, tau, Z, layers, bf16=True))


@pytest.mark.requires_cuda
def test_cuda_probe_fusedstep_matches_seq(cuda):
    from gncde_tpu_torch.solve.tableaus import get_tableau

    planes, idx, tau, y, layers, _ = _inputs(cuda, (8, 8, 8), True, seed=22)
    planes = _bf16(planes)
    tab = get_tableau("tsit5")
    ts = torch.linspace(0.0, 1.0, T, device=cuda).expand(B, T).contiguous()
    t, h = torch.full((B,), 0.1, device=cuda), torch.full((B,), 0.09, device=cuda)
    f0 = mk.megakernel_vf_eval(planes, *mk.interval(ts, t), y, layers, bf16=True)
    seq, fused = mp.VARIANTS["P6/seq"], mp.VARIANTS["P6/fusedstep"]
    before = seq.launches, fused.launches
    a = seq(planes, ts, t, y, h, f0, layers, tab)
    b = fused(planes, ts, t, y, h, f0, layers, tab)
    torch.cuda.synchronize()
    assert seq.launches == before[0] + 6 and fused.launches >= before[1] + 1
    for (x, r), tol in zip(zip(b[:3], a[:3]), (1e-5, 1e-4, 1e-4)):
        _assert_close(x, r, tol)
    for got in (a, b):  # each stage by stage against the plain step on its own ks
        ref = tfs._step_reference(planes, ts, t, y, h, f0, layers, tab, True, given_ks=got[3])
        for x, r in zip(got, ref):
            _assert_close(x, r, 1e-4)


@pytest.mark.requires_cuda
def test_cuda_probe_wrappers_raise_instead_of_falling_back(cuda):
    """K1-4mm takes layers up to 64 wide, the probes the undirected basis
    and bf16 planes, no_norm square layers only: each refusal raises before
    any launch."""
    planes, idx, tau, Z, layers, _ = _inputs(cuda, (8, 8, 128), True, seed=23)
    bf = _bf16(planes)
    v4, nonorm = mp.VARIANTS["P5/v4mm"], mp.VARIANTS["P4/no_norm"]
    before = v4.launches, nonorm.launches
    with pytest.raises(ValueError):  # a 128-wide layer
        v4(bf, idx, tau, Z, layers)
    with pytest.raises(ValueError):  # f32 planes
        v4(planes, idx, tau, Z, layers[:1])
    with pytest.raises(ValueError):  # not square
        nonorm(bf, idx, tau, Z, [dict(layers[0], W=layers[0]["W"][:5], lin_b=layers[0]["lin_b"][:5])])
    dplanes, didx, dtau, dZ, dlayers, _ = _inputs(cuda, (8, 8), True, seed=24, nbasis=11)
    with pytest.raises(ValueError):  # the directed basis
        v4(_bf16(dplanes), didx, dtau, dZ, dlayers)
    with pytest.raises(ValueError):  # notr is a variant of the full body, not of a drop
        mp.launch_k1bf_probe(bf, idx, tau, Z, layers[:1], drop="no_reduce", notr=True)
    assert (v4.launches, nonorm.launches) == before


# ---------------------------------------------------------------------------
# K8's and the f32 row pass's redesigns: shapes, plans, bitwise invariants
# ---------------------------------------------------------------------------

# K8: block sizes 1, 5 (4-byte copies), 32 and 128; H 1, 16 (one 16-wide
# chunk), 32, 33 (a partial second chunk, 4-byte M copies) and 64; n is
# 3 bs + bs / 2 + 1 (not a multiple of bs above bs 1); padded slots; shared
# operands with batch stride 0.
K8_BS = [1, 5, 32, 128]
K8_HS = [1, 16, 32, 33, 64]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("mode", ["batched", "shared-matrix", "shared-pattern"])
@pytest.mark.parametrize("H", K8_HS)
@pytest.mark.parametrize("bs", K8_BS)
def test_cuda_k8_matches_plain_and_repeats(cuda, bs, H, mode):
    n, B = 3 * bs + bs // 2 + 1, 3
    idx, blocks, nblocks, rng = _bcsr_batch(cuda, n, bs, B)
    assert float(tb.slot_mask(idx, nblocks).min()) == 0.0  # padded slots exist
    M = torch.tensor(rng.normal(size=(B, n, H)).astype(np.float32), device=cuda)
    bi, bl, Mo = _bcsr_operands(mode, idx, blocks, M)
    before = tb.bcsr_spmm.launches
    got = tb.bcsr_spmm(tb.BCSR(bi, bl, n), Mo)
    again = tb.bcsr_spmm(tb.BCSR(bi, bl, n), Mo)
    ref = tb.bcsr_spmm_plain(tb.BCSR(bi, bl, n), Mo)
    torch.cuda.synchronize()
    assert tb.bcsr_spmm.launches == before + 2
    _assert_close(got, ref, 1e-4)
    assert torch.equal(got, again)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("rb", [8, 16, 32])
@pytest.mark.parametrize("bs,H", [(128, 16), (128, 40), (37, 5)], ids=["bs128-H16",
                                                                      "bs128-H40", "bs37-H5"])
def test_cuda_k8_every_strip_height_gives_the_same_bits(cuda, bs, H, rb, monkeypatch):
    """Each output is one FMA chain over the slots and the block's columns
    in order, whatever the plan's strip height: every instantiation gives
    the default plan's bits."""
    n, B = 3 * bs + bs // 2 + 1, 2
    idx, blocks, _, rng = _bcsr_batch(cuda, n, bs, B)
    M = torch.tensor(rng.normal(size=(B, n, H)).astype(np.float32), device=cuda)
    mat = tb.BCSR(idx, blocks, n)
    default = tb.bcsr_spmm(mat, M)
    plan = tb.spmm_plan
    monkeypatch.setattr(tb, "spmm_plan", lambda *a: plan(*a)._replace(rb=rb))
    got = tb.bcsr_spmm(mat, M)
    torch.cuda.synchronize()
    _assert_close(got, tb.bcsr_spmm_plain(mat, M), 1e-4)
    assert torch.equal(got, default)


@pytest.mark.requires_cuda
def test_cuda_k8_largest_plan_launches_at_n640(cuda):
    """The largest shared memory K8's plans ask for (bs 128, strips of 32
    rows, 32-column chunks: 99,840 bytes) at n=640: the kernel's own
    allowance (``cudaFuncSetAttribute``) covers it, and it matches the plain
    version bit-repeatably."""
    n, bs, H, B = 640, 128, 64, 4
    idx, blocks, _, rng = _bcsr_batch(cuda, n, bs, B)
    M = torch.tensor(rng.normal(size=(B, n, H)).astype(np.float32), device=cuda)
    assert tb.spmm_plan(B, n // bs, bs, H)[::3] == (32, 99_840)
    mat = tb.BCSR(idx, blocks, n)
    assert mat.nb == n // bs
    got, again = tb.bcsr_spmm(mat, M), tb.bcsr_spmm(mat, M)
    torch.cuda.synchronize()
    _assert_close(got, tb.bcsr_spmm_plain(mat, M), 1e-4)
    assert torch.equal(got, again)


# The f32 row pass of K1/K1d: the trade field (n=255, 32 x 4 -> 512), the
# largest n (640, 64-wide layers), england's widths (n=129, last layer 1024,
# eight column groups) and an odd shape (n=77, widths 13 -> 37 -> 70: a
# partial column group, 4-byte M copies where the scratch rows are not a
# multiple of 4 floats).
K1_ROW_CASES = [(255, 2, (32, 32, 32, 32, 512)), (640, 1, (64, 64, 64)),
                (129, 2, (64, 64, 64, 1024)), (77, 3, (13, 37, 70))]
K1_ROW_IDS = ["trade-n255", "n640-64x3", "england-n129", "odd-n77"]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("nbasis", [8, 11], ids=["undirected", "directed"])
@pytest.mark.parametrize("n,nb,widths", K1_ROW_CASES, ids=K1_ROW_IDS)
def test_cuda_k1_row_pass_matches_plain(cuda, n, nb, widths, nbasis):
    planes, idx, tau, Z, layers, _ = chip_smoke.make_inputs(torch, n, nb, widths,
                                                            nbasis=nbasis)
    got = mk.megakernel_vf_eval(planes, idx, tau, Z, layers)
    again = mk.megakernel_vf_eval(planes, idx, tau, Z, layers)
    ref = mk.plain_vf_eval(planes, idx, tau, Z, layers)
    torch.cuda.synchronize()
    _assert_close(got, ref, 1e-4)
    assert torch.equal(got, again)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("bm", [16, 8, 4])
@pytest.mark.parametrize("n,nb,widths", K1_ROW_CASES[::3], ids=K1_ROW_IDS[::3])
def test_cuda_k1_every_row_plan_gives_the_same_bits(cuda, n, nb, widths, bm, monkeypatch):
    """The row pass's plan only partitions the work: every CTA height gives
    the default plan's output and per-layer M bit for bit."""
    planes, idx, tau, Z, layers, _ = chip_smoke.make_inputs(torch, n, nb, widths, nbasis=11)
    t0, t1 = {}, {}
    default = mk.megakernel_vf_eval(planes, idx, tau, Z, layers, trace=t0)
    monkeypatch.setattr(mk, "ROW_BMS", (bm,))
    got = mk.megakernel_vf_eval(planes, idx, tau, Z, layers, trace=t1)
    torch.cuda.synchronize()
    assert torch.equal(got, default)
    assert all(torch.equal(a, b) for a, b in zip(t0["M"], t1["M"]))


@pytest.mark.requires_cuda
def test_cuda_k1_largest_row_plan_launches_at_n640(cuda, monkeypatch):
    """The largest shared memory the row pass's plans ask for (n=640, CTAs
    of 16 rows, 128-column groups: 92,928 bytes) within the kernel's own
    allowance, on both bases, matching the plain version."""
    n, widths = 640, (64, 64, 512)
    monkeypatch.setattr(mk, "ROW_BMS", (16,))
    assert max(p.smem_bytes for p in mk.row_plans(n, 1, widths)) == 92_928
    for nbasis in (8, 11):
        planes, idx, tau, Z, layers, _ = chip_smoke.make_inputs(torch, n, 1, widths,
                                                                nbasis=nbasis)
        got = mk.megakernel_vf_eval(planes, idx, tau, Z, layers)
        ref = mk.plain_vf_eval(planes, idx, tau, Z, layers)
        torch.cuda.synchronize()
        _assert_close(got, ref, 1e-4)


@pytest.mark.requires_cuda
def test_cuda_k2_largest_sweep_plan_launches_at_n640(cuda, monkeypatch):
    """The largest shared memory the reverse sweep's plans ask for (n=640,
    dtau's operands, CTAs of 8 rows, 64-column groups: 198,272 bytes) within
    the kernel's own allowance, on both bases, matching the plain version."""
    n, widths = 640, (64, 64, 512)
    monkeypatch.setattr(mkb, "BWD_BMS", (8,))
    plans = mkb.bwd_row_plans(n, 1, widths, True)
    assert max(p.smem_bytes for p in plans) == 198_272 <= mkb.BWD_SMEM_MAX
    assert plans[-1].groups == 8
    for nbasis in (8, 11):
        inputs = chip_smoke.make_inputs(torch, n, 1, widths, nbasis=nbasis)
        _check_k2(inputs, True, nbasis)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["K2", "K2bf"])
def test_cuda_sweep_shared_memory_matches_the_c_side(cuda, bf16):
    """The planner's shared memory per sweep CTA (``bwd_smem_bytes``, which
    picks the plan and its waves) is what the launch computes
    (``gncde_bwd_smem_bytes``: ``bwd_smem_floats`` or, bf16,
    ``bwd_smem_bytes_bf``) at every CTA height, group width and dtau flag,
    for n and H off every tile multiple."""
    import ctypes

    fn = _build.load("megakernel_bwd").gncde_bwd_smem_bytes
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_int
    for n in (1, 40, 77, 255, 400, 640):
        for bm in (4, 8, 16):
            for cw in (32, 64, 128):
                for H in (1, 5, 16, 33, 64, 130, 512):
                    for tau in (False, True):
                        assert mkb.bwd_smem_bytes(n, bm, cw, H, tau, bf16) == fn(
                            n, bm, cw, H, int(tau), int(bf16)), (n, bm, cw, H, tau)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("bm", [16, 8, 4])
def test_cuda_k2_every_sweep_plan_matches_plain(cuda, bm, monkeypatch):
    """Every CTA height of the sweep (the trade field, directed, with dtau)
    within K2's bound, bitwise repeatable."""
    monkeypatch.setattr(mkb, "BWD_BMS", (bm,))
    inputs = chip_smoke.make_inputs(torch, *K2_WIDE[0], seed=3, nbasis=11)
    _check_k2(inputs, True, 11)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("nbasis", [8, 11], ids=["undirected", "directed"])
@pytest.mark.parametrize("shape", ["flagship", "bench"])
def test_cuda_fused_step_is_bitwise_the_per_stage_route(cuda, shape, nbasis):
    """K11 (K11d) runs each stage on K1's row pass and plans: y1, err, f1
    and every stage derivative bit for bit the per-stage route's (six K1 or
    K1d launches and the solver's stage combinations)."""
    from gncde_tpu_torch.solve.tableaus import get_tableau

    tab = get_tableau("tsit5")
    s = chip_smoke.STEP_SHAPES[shape]
    planes, ts, t, y, h, f0, layers = chip_smoke.make_step_inputs(torch, **s, nbasis=nbasis)
    got = tfs.fused_step_call(planes, ts, t, y, h, f0, layers, tab)
    ref = tfs._step_reference(planes, ts, t, y, h, f0, layers, tab,
                              stage=mk.megakernel_vf_eval)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.requires_cuda
def test_cuda_fused_step_largest_row_plan_launches_at_n640(cuda, monkeypatch):
    """K11's largest stage plan (n=640, 64-wide layers, CTAs of 8 rows:
    47,744 bytes of dynamic shared memory) launches within its allowance
    and equals the per-stage route bit for bit."""
    from gncde_tpu_torch.solve.tableaus import get_tableau

    tab = get_tableau("bosh3")
    monkeypatch.setattr(tfs, "STEP_BMS", (8,))
    planes, ts, t, y, h, f0, layers = chip_smoke.make_step_inputs(torch, 640, 1, (64, 64, 64))
    assert tfs.step_smem_bytes(640, 1, layers) == 47_744
    got = tfs.fused_step_call(planes, ts, t, y, h, f0, layers, tab)
    ref = tfs._step_reference(planes, ts, t, y, h, f0, layers, tab,
                              stage=mk.megakernel_vf_eval)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("nbasis", [8, 11], ids=["undirected", "directed"])
@pytest.mark.parametrize("n,nb,widths", K1_ROW_CASES[:3:2], ids=K1_ROW_IDS[:3:2])
def test_cuda_k2_recompute_is_bitwise_k1(cuda, n, nb, widths, nbasis):
    """K2 recomputes the forward with K1's row pass on K1's plan: its M_l
    are K1's bit for bit, and its gradients still match the plain
    version's."""
    planes, idx, tau, Z, layers, G = chip_smoke.make_inputs(torch, n, nb, widths,
                                                            nbasis=nbasis)
    t1, t2 = {}, {}
    mk.megakernel_vf_eval(planes, idx, tau, Z, layers, trace=t1)
    got = mkb.megakernel_vf_bwd(planes, idx, tau, Z, layers, G, True, trace=t2)
    ref = mkb.plain_vf_bwd(planes, idx, tau, Z, layers, G, True)
    torch.cuda.synchronize()
    assert len(t1["M"]) == len(t2["M"]) == len(layers)
    assert all(torch.equal(a, b) for a, b in zip(t1["M"], t2["M"]))
    _assert_close(got[1], ref[1], 1e-3)
    _assert_close(got[0], ref[0], 1e-3)
