"""K11: one explicit FSAL Runge-Kutta step in one kernel launch.

Counterpart of ``gncde_tpu/ops/pallas/fused_step.py``. When the solver
offers a step to the field's ``fused_rk_step`` hook
(``models/vector_fields/fields.py``) and the megakernel backend serves the
field, :func:`fused_rk_step` runs the whole step -- the stage inputs, the S
vf evals, ``y1``, ``err`` and ``f1`` -- as one cooperative CUDA launch
(``csrc/fused_step.cu``) instead of S x (1 + L) K1 launches and the torch
glue between them. Off by default (``ops.set_fused_step``), as in JAX.

* :func:`_step_reference` is the plain version: the same step composed of
  :func:`~gncde_tpu_torch.ops.megakernel.plain_vf_eval` stage by stage. CPU
  tensors take it.
* :func:`fused_step_call` launches K11 for CUDA tensors (raising on what the
  kernel does not take) and returns the stage derivatives ``ks`` too.
* :class:`FusedRKStep` is the differentiable step: forward K11, backward the
  explicit-RK chain rule written out (``_fused_step_vjp._bwd``): per stage,
  in reverse, one K2 (:func:`~gncde_tpu_torch.ops.megakernel_bwd.megakernel_vf_bwd`)
  on the stage input rebuilt from the stored ``ks``, and the ``kbar``,
  ``ybar``, ``hbar``, ``tbar`` accumulations in torch. No forward eval is
  recomputed. The JAX package takes ``jax.vjp`` of the per-stage
  composition instead for n above its backward kernel's VMEM limit
  (``_bwd_max_n``); the port's K2 serves every n the hook takes (n <= 640),
  so the chain rule serves every step. A gradient with respect to the
  coefficient planes raises, as :class:`~gncde_tpu_torch.ops.megakernel.MegakernelVF`
  does.

Shapes are batch-first: ``t``, ``h`` ``(B,)``; ``y``, ``f0`` ``(B, n, H)``;
planes ``(B, T-1, n, n)`` or ``(T-1, n, n)``; knots ``(B, T)``.
"""

from __future__ import annotations

import ctypes
import typing as tp

import numpy as np
import torch

from . import _build
from .megakernel import (
    Planes,
    _check_inputs,
    _unflatten,
    flat_grads,
    flatten_params,
    interval,
    launch_args,
    plain_vf_eval,
    scratch_width,
)
from .megakernel_bwd import megakernel_vf_bwd

#: Most evaluated stages and layers one build serves (csrc/fused_step.cu).
MAX_STAGES = 8
MAX_LAYERS = 8

TabArrays = tp.Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def _tableau_arrays(tab) -> TabArrays:
    """(amat, bvec, berr, cvec) as dense float32 arrays over [f0, k1 .. kS].

    amat[s, j]: weight of k_j in the input of evaluated stage s+1 (zero
    padded); bvec/berr: solution / embedded-error weights; cvec[s]: node of
    evaluated stage s+1.
    """
    s_eval = tab.num_stages - 1
    amat = np.zeros((s_eval, s_eval), np.float32)
    for srow in range(s_eval):
        for j, aij in enumerate(tab.a[srow + 1]):
            amat[srow, j] = aij
    bvec = np.zeros((s_eval + 1,), np.float32)
    bvec[:len(tab.b)] = tab.b
    berr = np.zeros((s_eval + 1,), np.float32)
    berr[:len(tab.b_err)] = tab.b_err
    cvec = np.asarray(tab.c[1:], np.float32)
    return amat, bvec, berr, cvec


# Tableau arrays and objects by tableau name.
_TAB_CACHE: tp.Dict[str, TabArrays] = {}
_TAB_OBJ_CACHE: tp.Dict[str, tp.Any] = {}


def _register(tab) -> TabArrays:
    """The tableau's arrays, cached by name; raises when a different tableau
    reuses a registered name (it would integrate with the first one's
    coefficients)."""
    key = tab.name
    if key not in _TAB_CACHE:
        _TAB_CACHE[key] = _tableau_arrays(tab)
        _TAB_OBJ_CACHE[key] = tab
    elif _TAB_OBJ_CACHE[key] != tab:
        raise ValueError(
            f"fused_rk_step: tableau name {key!r} was already registered with "
            "different coefficients; give distinct tableaus distinct names")
    return _TAB_CACHE[key]


def _stage_nodes(tab, ts, t, h):
    """Per-element ``(idx, tau)``, each ``(B, S)``, of every stage's node
    ``t + c_s h`` (formed as the solver forms it): the interval lookup of
    ``ops/megakernel.py``, which clamps a node past the last knot to the
    last interval."""
    c = torch.tensor(tab.c[1:], dtype=t.dtype, device=t.device)
    t_stages = t[:, None] + c[None, :] * h[:, None]  # (B, S)
    B, S = t_stages.shape
    idx, tau = interval(ts.repeat_interleave(S, 0), t_stages.reshape(-1))
    return idx.reshape(B, S), tau.reshape(B, S)


def _combine(weights, ks, start):
    """``sum_j weights[j] * ks[j]`` over the nonzero weights, in order (the
    solver's ``_rk_step`` order); ``start`` when every weight is zero."""
    acc = None
    for w, k in zip(weights, ks):
        if w == 0.0:
            continue
        term = float(w) * k
        acc = term if acc is None else acc + term
    return start if acc is None else acc


def _step_reference(planes: Planes, ts, t, y, h, f0, layers, tab):
    """Plain version of K11: ``(y1, err, f1, ks)`` with ``ks`` ``(B, S, n, H)``
    the stage derivatives k_1 .. k_S, each stage a
    :func:`~gncde_tpu_torch.ops.megakernel.plain_vf_eval` (mirrors the
    solver's ``_rk_step`` for explicit FSAL tableaus)."""
    _register(tab)
    idx, tau = _stage_nodes(tab, ts, t, h)
    hb = h[:, None, None]
    ks = [f0]
    for s in range(1, tab.num_stages):
        acc = _combine(tab.a[s], ks, None)
        yi = y if acc is None else y + hb * acc
        ks.append(plain_vf_eval(planes, idx[:, s - 1], tau[:, s - 1], yi, layers))
    y1 = y + hb * _combine(tab.b, ks, torch.zeros_like(y))
    err = hb * _combine(tab.b_err, ks, torch.zeros_like(y))
    return y1, err, ks[-1], torch.stack(ks[1:], 1)


_ARGTYPES = [
    _build.P, _build.P, _build.P, _build.P, _build.L,  # planes, stride
    _build.P, _build.P, _build.P, _build.P, _build.P,  # idx, tau, h, y, f0
    _build.I, _build.I, _build.I, _build.I, _build.I,  # Btot, b0, nb, n, S
    _build.P, _build.P, _build.P,  # amat, bvec, berr (host arrays)
    _build.I, _build.P, _build.P,  # L, dims, ptrs (host arrays)
    _build.P, _build.P, _build.I, _build.P, _build.P,  # stats, Mbuf, ldm, Yi, ks
    _build.P, _build.P, _build.P, _build.P,  # y1, err, f1, stream
]


def _lib():
    lib = _build.load("fused_step")
    fn = lib.gncde_fused_step
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.gncde_fused_step_capacity.argtypes = []
        lib.gncde_fused_step_capacity.restype = ctypes.c_int
    return lib


_CAPACITY: tp.Dict[int, int] = {}


def capacity(device) -> int:
    """How many K11 CTAs can be resident at once on ``device`` (a
    cooperative launch needs them all resident)."""
    dev = torch.device(device).index
    dev = torch.cuda.current_device() if dev is None else dev
    if dev not in _CAPACITY:
        with torch.cuda.device(dev):
            _CAPACITY[dev] = int(_lib().gncde_fused_step_capacity())
    return _CAPACITY[dev]


def _host_floats(a: np.ndarray):
    flat = np.ascontiguousarray(a, np.float32).reshape(-1)
    return (ctypes.c_float * flat.size)(*flat.tolist())


def _launch(planes: Planes, idx, tau, y, h, f0, layers, tabs: TabArrays):
    amat, bvec, berr, _ = tabs
    S = amat.shape[0]
    _check_inputs(planes, idx[:, 0], tau[:, 0], y, layers, extra=(f0, h))
    if S > MAX_STAGES or len(layers) > MAX_LAYERS:
        raise ValueError(f"K11 serves up to {MAX_STAGES} stages and {MAX_LAYERS} "
                         f"layers; got {S} and {len(layers)}")
    B, n, H = y.shape
    if f0.shape != y.shape or h.shape != (B,) or idx.shape != (B, S) or tau.shape != (B, S):
        raise ValueError("K11: f0 must match y (B, n, H); h must be (B,) and the "
                         "stage nodes (B, S)")
    if layers[-1]["W"].shape[0] != H:
        raise ValueError("K11: the layer stack must map the state width to itself")
    lib = _lib()
    nrb = -(-n // 16)  # csrc/megakernel_common.cuh BM
    per_launch = capacity(y.device) // nrb
    if per_launch < 1:
        raise RuntimeError(f"K11: not even one batch element ({nrb} CTAs) fits a "
                           f"cooperative launch on this device")
    y = y.detach().contiguous()
    f0 = f0.detach().contiguous()
    h32 = h.detach().contiguous()
    bstride, idx32, tau32, dims, ptrs, keep = launch_args(planes, idx, tau, layers)
    ldm = scratch_width(layers)
    f32 = dict(device=y.device, dtype=torch.float32)
    stats = torch.empty((B, 6, n), **f32)
    mbuf = torch.empty((2, B, n, ldm), **f32)
    yi = torch.empty((B, n, H), **f32)
    ks = torch.empty((B, S, n, H), **f32)
    y1, err, f1 = (torch.empty((B, n, H), **f32) for _ in range(3))
    host = [_host_floats(a) for a in (amat, bvec, berr)]
    for b0 in range(0, B, per_launch):
        nb = min(per_launch, B - b0)
        code = lib.gncde_fused_step(
            *[_build.ptr(p) for p in planes], bstride, _build.ptr(idx32),
            _build.ptr(tau32), _build.ptr(h32), _build.ptr(y), _build.ptr(f0),
            B, b0, nb, n, S, *[ctypes.cast(a, _build.P) for a in host],
            len(layers), ctypes.cast(dims, _build.P), ctypes.cast(ptrs, _build.P),
            _build.ptr(stats), _build.ptr(mbuf), ldm, _build.ptr(yi), _build.ptr(ks),
            _build.ptr(y1), _build.ptr(err), _build.ptr(f1), _build.stream())
        _build.check(code, "K11 fused_step")
        fused_step_call.launches += 1
    del keep
    return y1, err, f1, ks


def fused_step_call(planes: Planes, ts, t, y, h, f0, layers, tab):
    """K11: ``(y1, err, f1, ks)`` of one step of ``tab`` from ``(t, y)`` with
    step ``h`` and FSAL derivative ``f0``. The kernel for CUDA tensors (one
    cooperative launch; a batch whose CTAs do not all fit at once in chunks
    that do), the plain version for CPU tensors. Not differentiable by
    itself (see :class:`FusedRKStep`)."""
    if not y.is_cuda:
        return _step_reference(planes, ts, t, y, h, f0, layers, tab)
    tabs = _register(tab)
    idx, tau = _stage_nodes(tab, ts, t, h)
    return _launch(planes, idx, tau, y, h, f0, layers, tabs)


fused_step_call.launches = 0


def _bsum(x, y):
    """Per-element inner product of two (B, ...) tensors."""
    return (x * y).flatten(1).sum(1)


class FusedRKStep(torch.autograd.Function):
    """Differentiable fused step: forward K11, backward the explicit-RK chain
    rule with one K2 per stage. Inputs ``(tab, ts, t, y, h, f0, d, c, b, a,
    *flat)`` with ``flat`` as for :class:`~gncde_tpu_torch.ops.megakernel.MegakernelVF`."""

    @staticmethod
    def forward(ctx, tab, ts, t, y, h, f0, d, c, b, a, *flat):
        layers = _unflatten(flat)
        with torch.no_grad():
            y1, err, f1, ks = fused_step_call((d, c, b, a), ts, t, y, h, f0, layers, tab)
        ctx.tab = tab
        ctx.save_for_backward(ts, t, y, h, f0, ks, d, c, b, a, *flat)
        return y1, err, f1

    @staticmethod
    def backward(ctx, g_y1, g_err, g_f1):
        ts, t, y, h, f0, ks, d, c, b, a, *flat = ctx.saved_tensors
        needs = ctx.needs_input_grad
        if any(needs[6:10]):
            raise NotImplementedError(
                "gradients with respect to the coefficient planes are not served "
                "by the fused step's backward")
        need_t, need_y, need_h, need_f0 = needs[2], needs[3], needs[4], needs[5]
        need_vf = any(needs[10:])
        layers = _unflatten(flat)
        planes = (d, c, b, a)
        amat, bvec, berr, cvec = _register(ctx.tab)
        idx, tau = _stage_nodes(ctx.tab, ts, t, h)
        S = amat.shape[0]
        hb = h[:, None, None]
        k = [f0] + [ks[:, j] for j in range(S)]  # k[0] = f0, k[i] = stage i
        kbar = [hb * (float(bvec[j]) * g_y1 + float(berr[j]) * g_err) for j in range(S + 1)]
        kbar[S] = kbar[S] + g_f1
        ybar = g_y1
        hbar = sum(float(bvec[j]) * _bsum(k[j], g_y1) + float(berr[j]) * _bsum(k[j], g_err)
                   for j in range(S + 1))
        tbar = torch.zeros_like(t)
        want_dt = need_t or need_h
        d_flat = None
        for i in range(S, 0, -1):
            acc = _combine(amat[i - 1, :i], k, None)
            Yi = y if acc is None else y + hb * acc
            d_ti, d_Yi, per_layer = megakernel_vf_bwd(
                planes, idx[:, i - 1], tau[:, i - 1], Yi, layers,
                kbar[i].contiguous(), need_tau=want_dt)
            if want_dt:
                tbar = tbar + d_ti
                hbar = hbar + float(cvec[i - 1]) * d_ti
            ybar = ybar + d_Yi
            if acc is not None:
                hbar = hbar + _bsum(acc, d_Yi)
            for j in range(i):
                if amat[i - 1, j] != 0.0:
                    kbar[j] = kbar[j] + (hb * float(amat[i - 1, j])) * d_Yi
            if need_vf:
                grads = flat_grads(per_layer)
                d_flat = grads if d_flat is None else [x + g for x, g in zip(d_flat, grads)]
        d_flat = d_flat if need_vf else [None] * len(flat)
        return (None, None, tbar if need_t else None, ybar if need_y else None,
                hbar if need_h else None, kbar[0] if need_f0 else None,
                None, None, None, None, *d_flat)


def fused_rk_step(tab, planes: Planes, ts, t, y, h, f0, vf):
    """One explicit FSAL RK step of the field ``vf`` through K11.

    Returns ``(y1, err, f1)`` with the semantics of the solver's
    ``_rk_step``. Callers ensure ``tab.fsal`` and an explicit tableau (the
    FSAL property ``a[last] == b`` makes the last stage's eval the next
    step's ``f0``); the field's hook checks the rest.
    """
    _register(tab)
    if ts.dim() == 1:
        ts = ts.unsqueeze(0).expand(y.shape[0], -1)
    return FusedRKStep.apply(tab, ts, t, y, h, f0, *planes, *flatten_params(vf))
