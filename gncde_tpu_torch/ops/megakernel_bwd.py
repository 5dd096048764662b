"""K2: every cotangent of one vector-field evaluation per batch element.

Counterpart of ``gncde_tpu/ops/pallas/megakernel_bwd.py``. Given the K1
inputs and an output cotangent ``G`` (B, n, Hout), returns

    dtau (B,), dZ (B, n, Hin0),
    per layer: dnorm_w (B, Hin), dnorm_b (B, Hin), dW (B, Hout, Hin),
               dlin_b (B, Hout), dbasis (B, P, 2)

with P = 8 for the undirected basis and 11 for the directed one

-- per-element parameter cotangents, summed over the batch by the caller
(as ``bwd_call_batched`` leaves them). ``dtau`` is computed only when
``need_tau`` (zeros otherwise).

* :func:`plain_vf_bwd` is the plain PyTorch version: ``torch.autograd.grad``
  of :func:`~gncde_tpu_torch.ops.megakernel.plain_vf_eval` with the
  parameters expanded per element. CPU tensors always take it.
* :func:`megakernel_vf_bwd` launches ``csrc/megakernel_bwd.cu`` for CUDA
  tensors and raises if it cannot.
"""

from __future__ import annotations

import ctypes
import typing as tp

import torch

from . import _build
from .megakernel import (
    NBASIS_DIRECTED,
    NSTAT,
    Planes,
    LayerParams,
    _LAYER_KEYS,
    _check_inputs,
    hermite,
    launch_args,
    plain_layer_stack,
    scratch_width,
)

PerLayer = tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                    torch.Tensor]


def plain_vf_bwd(planes: Planes, idx, tau, Z, layers: tp.Sequence[LayerParams],
                 G, need_tau: bool = True):
    """Plain PyTorch version of K2 (autograd of the dense layer stack, on
    whichever basis the layers carry)."""
    B = Z.shape[0]
    with torch.enable_grad():
        tau_ = tau.detach().clone().requires_grad_(need_tau)
        Z_ = Z.detach().clone().requires_grad_(True)
        blayers, leaves = [], []
        for lp in layers:
            bl = {}
            for k in _LAYER_KEYS:
                v = lp[k].detach()
                bl[k] = v.unsqueeze(0).expand((B,) + v.shape).clone()
                bl[k].requires_grad_(True)
                leaves.append(bl[k])
            blayers.append(bl)
        A, dA = hermite(planes, idx, tau_)
        out = plain_layer_stack(A, dA, Z_, blayers)
        inputs = [Z_] + leaves + ([tau_] if need_tau else [])
        grads = torch.autograd.grad(out, inputs, G)
    dZ = grads[0]
    per_layer = []
    for l in range(len(layers)):
        g = grads[1 + 5 * l: 6 + 5 * l]
        per_layer.append(tuple(g))
    dtau = grads[-1] if need_tau else torch.zeros_like(tau)
    return dtau, dZ, per_layer


_BWD_ARGTYPES = [
    _build.P, _build.P, _build.P, _build.P, _build.L,  # planes, stride
    _build.P, _build.P, _build.P, _build.P,  # idx, tau, Z, G
    _build.I, _build.I, _build.I,  # B, n, L
    _build.P, _build.P, _build.I,  # dims, ptrs (host arrays), directed
    _build.I,  # need_tau
    _build.P, _build.P, _build.P, _build.P, _build.I,  # stats, M, X, g, ldm
    _build.P,  # dZ
    _build.P, _build.I, _build.P,  # part, ptot, red
    _build.P,  # stream
]


def _bwd_lib():
    lib = _build.load("megakernel_bwd")
    fn = lib.gncde_mk_bwd
    if fn.argtypes is None:
        fn.argtypes = _BWD_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _layer_sizes(layers) -> tp.List[tp.Tuple[int, int]]:
    return [(lp["W"].shape[1], lp["W"].shape[0]) for lp in layers]


def _launch_bwd(planes: Planes, idx, tau, Z, layers, G, need_tau):
    nbasis = _check_inputs(planes, idx, tau, Z, layers, extra=(G,))
    if G.shape != Z.shape[:2] + (layers[-1]["W"].shape[0],):
        raise ValueError(f"G {tuple(G.shape)} does not match the output shape")
    fn = _bwd_lib()
    B, n, hin0 = Z.shape
    L = len(layers)
    dev = Z.device
    Z = Z.detach().contiguous()
    G = G.detach().contiguous()
    bstride, idx32, tau32, dims, ptrs, keep = launch_args(planes, idx, tau, layers)
    sizes = _layer_sizes(layers)
    ptot = sum(2 * hi + ho * hi + ho + 2 * nbasis + 1 for hi, ho in sizes)
    nblk = -(-n // 16)
    f32 = dict(device=dev, dtype=torch.float32)
    stats = torch.empty((B, NSTAT, n), **f32)
    ldm = scratch_width(layers)
    mbuf = torch.empty((L, B, n, ldm), **f32)
    xbuf = torch.empty((L, B, n, ldm), **f32)
    gbuf = torch.empty((2, B, n, ldm), **f32)
    dZ = torch.empty((B, n, hin0), **f32)
    part = torch.empty((B, nblk, ptot), **f32)
    red = torch.empty((B, ptot), **f32)
    err = fn(
        *[_build.ptr(p) for p in planes], bstride,
        _build.ptr(idx32), _build.ptr(tau32), _build.ptr(Z), _build.ptr(G),
        B, n, L, ctypes.cast(dims, _build.P), ctypes.cast(ptrs, _build.P),
        int(nbasis == NBASIS_DIRECTED), int(bool(need_tau)),
        _build.ptr(stats), _build.ptr(mbuf), _build.ptr(xbuf), _build.ptr(gbuf),
        ldm, _build.ptr(dZ), _build.ptr(part), ptot, _build.ptr(red),
        _build.stream(),
    )
    _build.check(err, "K2 megakernel_bwd")
    megakernel_vf_bwd.launches += 1
    del keep
    per_layer, off = [], 0
    for hi, ho in sizes:
        chunks = []
        for size, shape in ((hi, (hi,)), (hi, (hi,)), (ho * hi, (ho, hi)),
                            (ho, (ho,)), (2 * nbasis, (nbasis, 2))):
            chunks.append(red[:, off:off + size].reshape((B,) + shape))
            off += size
        dtau_l = red[:, off]
        off += 1
        per_layer.append((tuple(chunks), dtau_l))
    dtau = sum(d for _, d in per_layer)
    return dtau, dZ, [c for c, _ in per_layer]


def megakernel_vf_bwd(planes: Planes, idx, tau, Z, layers, G,
                      need_tau: bool = True):
    """K2: the CUDA kernel for CUDA tensors, the plain version on CPU."""
    if Z.is_cuda:
        return _launch_bwd(planes, idx, tau, Z, layers, G, need_tau)
    return plain_vf_bwd(planes, idx, tau, Z, layers, G, need_tau)


megakernel_vf_bwd.launches = 0
