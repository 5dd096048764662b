"""The port's CUDA kernels K1 and K2 against their plain PyTorch versions.

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
"""

import numpy as np
import pytest
import torch

from gncde_tpu_torch import ops
from gncde_tpu_torch.interp import CubicInterpolation, MatrixControl
from gncde_tpu_torch.models.vector_fields import PermEquivGraphVectorField as TVF
from gncde_tpu_torch.ops import megakernel as mk
from gncde_tpu_torch.ops import megakernel_bwd as mkb

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


CASES = [((8, 8, 8), True), ((5, 8, 3), True), ((8, 8, 8), False)]
IDS = ["square-per-element", "widths-5-8-3", "shared-planes"]


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
