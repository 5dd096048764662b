"""K1: one whole vector-field evaluation per batch element.

Counterpart of ``gncde_tpu/ops/pallas/megakernel.py``. For each batch
element ``b`` the eval reads that element's four Hermite interval planes
``d, c, b, a`` at interval ``idx[b]``, forms ``A(tau[b])`` and
``dA(tau[b])``, and runs the undirected perm-equiv layer stack
``L x [RMSNorm -> Linear -> A_bar @ M (+ M)]`` with ReLU between layers.

* :func:`plain_vf_eval` is the plain PyTorch version (the dense layer
  stack, counterpart of ``_xla_reference``). CPU tensors always take it.
* :func:`megakernel_vf_eval` launches the CUDA kernel
  (``csrc/megakernel_fwd.cu``) for CUDA tensors and raises if it cannot.
* :class:`MegakernelVF` is the ``autograd.Function`` the vector field
  calls: forward is K1, backward is K2 (``ops/megakernel_bwd.py``).

Planes are ``(T-1, n, n)`` (shared by the batch) or ``(B, T-1, n, n)``
(one stack per element, as the trainer's irregular time grids need).
"""

from __future__ import annotations

import ctypes
import typing as tp

import torch

from . import _build
from .equiv_basis import fusion_matrix_dense

#: Largest n the vf-level kernels serve; above it the tiled regime (ROADMAP
#: slice 2) is needed. Kept equal to the JAX package's cap so both packages
#: dispatch the same shapes.
MEGAKERNEL_MAX_N = 640
#: Widest layer input and output the kernels take
#: (csrc/megakernel_common.cuh MAXIN, MAXOUT): outputs are swept in chunks
#: of 64 columns, so the CDE wrapper's wide last layers (H * E * 2: 512 for
#: the trade configs, 1024 for england) are served.
MAX_IN = 64
MAX_OUT = 4096

Planes = tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
LayerParams = tp.Dict[str, torch.Tensor]

_LAYER_KEYS = ("norm_w", "norm_b", "W", "lin_b", "basis")


def interval(ts: torch.Tensor, t: torch.Tensor):
    """Per-element interval index and offset: ``ts`` (B, T), ``t`` (B,)."""
    idx = torch.searchsorted(ts, t[:, None].to(ts.dtype), right=True)[:, 0] - 1
    idx = idx.clamp(0, ts.shape[-1] - 2)
    tau = t - ts.gather(1, idx[:, None])[:, 0]
    return idx, tau


def select_planes(planes: Planes, idx: torch.Tensor):
    """Each element's interval planes, (B, n, n) each."""
    if planes[0].dim() == 4:
        rows = torch.arange(idx.shape[0], device=idx.device)
        return tuple(p[rows, idx] for p in planes)
    return tuple(p[idx] for p in planes)


def hermite(planes: Planes, idx: torch.Tensor, tau: torch.Tensor):
    """A(tau) and dA(tau) per element from the interval planes."""
    d, c, b, a = select_planes(planes, idx)
    t = tau[:, None, None]
    A = ((d * t + c) * t + b) * t + a
    dA = (3.0 * d * t + 2.0 * c) * t + b
    return A, dA


def _bview(p: torch.Tensor, unbatched_dim: int) -> torch.Tensor:
    """A parameter with an optional leading batch dim, made batch-first."""
    return p.unsqueeze(0) if p.dim() == unbatched_dim else p


def plain_layer_stack(A, dA, Z, layers: tp.Sequence[LayerParams]):
    """Dense layer stack on per-element A, dA (B, n, n) and Z (B, n, Hin).

    Parameters may carry a leading batch dim (used for per-element grads).
    """
    feats = Z
    for l, lp in enumerate(layers):
        nw = _bview(lp["norm_w"], 1)[:, None, :]
        nb = _bview(lp["norm_b"], 1)[:, None, :]
        W = _bview(lp["W"], 2)
        lb = _bview(lp["lin_b"], 1)[:, None, :]
        basis = _bview(lp["basis"], 2)
        inv = torch.rsqrt((feats * feats).mean(-1, keepdim=True) + 1e-6)
        m = (feats * inv * nw + nb) @ W.transpose(-2, -1) + lb
        params = [basis[:, k] for k in range(basis.shape[1])]
        fused = fusion_matrix_dense(A, dA, params)
        feats = m + fused @ m
        if l < len(layers) - 1:
            feats = torch.relu(feats)
    return feats


def plain_vf_eval(planes: Planes, idx, tau, Z, layers):
    """Plain PyTorch version of K1."""
    A, dA = hermite(planes, idx, tau)
    return plain_layer_stack(A, dA, Z, layers)


def _check_inputs(planes: Planes, idx, tau, Z, layers, extra=()):
    dev = Z.device
    B, n, _ = Z.shape
    shape = planes[0].shape
    for p in planes:
        if p.shape != shape or p.dtype != torch.float32 or p.device != dev:
            raise ValueError("planes must be four float32 tensors of one shape "
                             "on the node state's device")
        if not p.is_contiguous():
            raise ValueError("planes must be contiguous")
    if shape[-2:] != (n, n) or (len(shape) == 4 and shape[0] != B):
        raise ValueError(f"planes {tuple(shape)} do not match Z {tuple(Z.shape)}")
    if n > MEGAKERNEL_MAX_N:
        raise ValueError(f"n={n} exceeds MEGAKERNEL_MAX_N={MEGAKERNEL_MAX_N}")
    for t in (Z, tau, *extra):
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError("Z, tau and G must be float32 on one device")
    if idx.device != dev or idx.shape != (B,) or tau.shape != (B,):
        raise ValueError("idx and tau must be (B,) on the node state's device")
    hin = Z.shape[-1]
    for lp in layers:
        hout, h_in = lp["W"].shape
        if h_in != hin or hout > MAX_OUT or hin > MAX_IN:
            raise ValueError(f"layer widths {h_in}->{hout} unsupported "
                             f"(inputs up to {MAX_IN}, outputs up to {MAX_OUT})")
        if lp["basis"].shape != (8, 2):
            raise ValueError("the kernels serve the undirected 8-term basis")
        hin = hout


def launch_args(planes: Planes, idx, tau, layers):
    """The C arguments shared by K1 and K2: plane pointers and batch
    stride, int32 idx, contiguous tau, and host arrays of layer dims and
    parameter pointers (the parameter tensors are kept alive in ``keep``)."""
    d, c, b, a = planes
    n = d.shape[-1]
    bstride = (d.shape[1] * n * n) if d.dim() == 4 else 0
    idx32 = idx.to(torch.int32).contiguous()
    tau32 = tau.contiguous()
    keep, ptrs, dims = [idx32, tau32], [], []
    for lp in layers:
        for k in _LAYER_KEYS:
            t = lp[k].detach().to(torch.float32).contiguous()
            keep.append(t)
            ptrs.append(t.data_ptr())
        dims += [lp["W"].shape[1], lp["W"].shape[0]]
    ptr_arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    dim_arr = (ctypes.c_int * len(dims))(*dims)
    return bstride, idx32, tau32, dim_arr, ptr_arr, keep


def scratch_width(layers) -> int:
    """Row length of the kernels' M/X scratch: the widest layer."""
    return max(max(lp["W"].shape) for lp in layers)


_FWD_ARGTYPES = [
    _build.P, _build.P, _build.P, _build.P, _build.L,  # planes, stride
    _build.P, _build.P, _build.P,  # idx, tau, Z
    _build.I, _build.I, _build.I,  # B, n, L
    _build.P, _build.P,  # dims, ptrs (host arrays)
    _build.P, _build.P, _build.I,  # stats, Mbuf, ldm
    _build.P, _build.P,  # out, stream
]


def _fwd_lib():
    lib = _build.load("megakernel_fwd")
    fn = lib.gncde_mk_fwd
    if fn.argtypes is None:
        fn.argtypes = _FWD_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _launch_fwd(planes: Planes, idx, tau, Z, layers):
    _check_inputs(planes, idx, tau, Z, layers)
    fn = _fwd_lib()
    B, n, _ = Z.shape
    Z = Z.detach().contiguous()
    bstride, idx32, tau32, dims, ptrs, keep = launch_args(planes, idx, tau, layers)
    stats = torch.empty((B, 6, n), device=Z.device, dtype=torch.float32)
    ldm = scratch_width(layers)
    mbuf = torch.empty((2, B, n, ldm), device=Z.device, dtype=torch.float32)
    out = torch.empty((B, n, layers[-1]["W"].shape[0]), device=Z.device,
                      dtype=torch.float32)
    err = fn(
        *[_build.ptr(p) for p in planes], bstride,
        _build.ptr(idx32), _build.ptr(tau32), _build.ptr(Z),
        B, n, len(layers), ctypes.cast(dims, _build.P),
        ctypes.cast(ptrs, _build.P),
        _build.ptr(stats), _build.ptr(mbuf), ldm, _build.ptr(out),
        _build.stream(),
    )
    _build.check(err, "K1 megakernel_fwd")
    megakernel_vf_eval.launches += 1
    del keep
    return out


def megakernel_vf_eval(planes: Planes, idx, tau, Z, layers):
    """K1: ``(B, n, Hout)`` vf output; the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. Not differentiable by itself (see
    :class:`MegakernelVF`)."""
    if Z.is_cuda:
        return _launch_fwd(planes, idx, tau, Z, layers)
    return plain_vf_eval(planes, idx, tau, Z, layers)


megakernel_vf_eval.launches = 0


class MegakernelVF(torch.autograd.Function):
    """Differentiable vf eval: forward K1, backward K2.

    Inputs: ``(idx, tau, Z, d, c, b, a, *flat)`` where ``flat`` holds, per
    layer, ``norm_w, norm_b, W, lin_b`` and the eight basis 2-vectors.
    """

    @staticmethod
    def forward(ctx, idx, tau, Z, d, c, b, a, *flat):
        layers = _unflatten(flat)
        planes = (d, c, b, a)
        with torch.no_grad():
            out = megakernel_vf_eval(planes, idx, tau, Z, layers)
        ctx.save_for_backward(idx, tau, Z, d, c, b, a, *flat)
        return out

    @staticmethod
    def backward(ctx, g):
        from .megakernel_bwd import megakernel_vf_bwd

        idx, tau, Z, d, c, b, a, *flat = ctx.saved_tensors
        if any(ctx.needs_input_grad[3:7]):
            raise NotImplementedError(
                "gradients with respect to the coefficient planes are not "
                "served by the megakernel backward"
            )
        layers = _unflatten(flat)
        need_tau = ctx.needs_input_grad[1]
        dtau, dZ, per_layer = megakernel_vf_bwd(
            (d, c, b, a), idx, tau, Z, layers, g.contiguous(), need_tau=need_tau
        )
        return (None, dtau if need_tau else None, dZ, None, None, None, None,
                *flat_grads(per_layer))


_PER_LAYER = 12  # norm_w, norm_b, W, lin_b + 8 basis vectors


def flat_grads(per_layer) -> tp.List[torch.Tensor]:
    """K2's per-element, per-layer parameter cotangents summed over the
    batch, in the order of :func:`flatten_params`."""
    grads = []
    for dnw, dnb, dW, dlb, dbasis in per_layer:
        grads += [dnw.sum(0), dnb.sum(0), dW.sum(0), dlb.sum(0)]
        db = dbasis.sum(0)
        grads += [db[k] for k in range(db.shape[0])]
    return grads


def flatten_params(vf) -> tp.List[torch.Tensor]:
    flat = []
    for layer in vf.gnn_layers:
        conv = layer.conv_layer
        flat += [conv.norm.weight, conv.norm.bias, conv.linear.weight,
                 conv.linear.bias, *layer.params]
    return flat


def _unflatten(flat) -> tp.List[LayerParams]:
    layers = []
    for i in range(0, len(flat), _PER_LAYER):
        nw, nb, W, lb, *basis = flat[i:i + _PER_LAYER]
        layers.append(dict(norm_w=nw, norm_b=nb, W=W, lin_b=lb,
                           basis=torch.stack(basis)))
    return layers


def layer_params(vf) -> tp.List[LayerParams]:
    """Per-layer parameters of a PermEquivGraphVectorField, basis as (8, 2)."""
    return _unflatten(flatten_params(vf))


def megakernel_vf(planes: Planes, ts, t, Z, vf):
    """The field's fast path: interval lookup, then :class:`MegakernelVF`."""
    if ts.dim() == 1:
        ts = ts.unsqueeze(0).expand(Z.shape[0], -1)
    idx, tau = interval(ts, t)
    return MegakernelVF.apply(idx, tau, Z, *planes, *flatten_params(vf))
