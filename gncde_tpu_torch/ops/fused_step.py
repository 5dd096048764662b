"""K11: one explicit FSAL Runge-Kutta step in one kernel launch.

Counterpart of ``gncde_tpu/ops/pallas/fused_step.py``. When the solver
offers a step to the field's ``fused_rk_step`` hook
(``models/vector_fields/fields.py``) and the megakernel backend serves the
field, :func:`fused_rk_step` runs the whole step -- the stage inputs, the S
vf evals, ``y1``, ``err`` and ``f1`` -- as one cooperative CUDA launch
(``csrc/fused_step.cu``) instead of S x (1 + L) K1 launches and the torch
glue between them. Off by default (``ops.set_fused_step``), as in JAX.

* :func:`_step_reference` is the plain version: the same step composed of
  :func:`~gncde_tpu_torch.ops.megakernel.plain_vf_eval` (with ``bf16``,
  ``plain_vf_eval_bf16``) stage by stage. CPU tensors take it.
* :func:`fused_step_call` launches K11 for CUDA tensors (raising on what the
  kernel does not take) and returns the stage derivatives ``ks`` too. Its
  stages run K1's row pass on :func:`step_plans` (``rows_body`` in one
  grid of resident CTAs that walk each phase's virtual CTAs,
  :func:`step_walk`; with ``bf16`` the bf16 row pass), so a step is the
  per-stage K1 (K1bf) route's bit for bit.
* :class:`FusedRKStep` is the differentiable step: forward K11, backward the
  explicit-RK chain rule written out (``_fused_step_vjp._bwd``): per stage,
  in reverse, one K2 (:func:`~gncde_tpu_torch.ops.megakernel_bwd.megakernel_vf_bwd`)
  on the stage input rebuilt from the stored ``ks``, and the ``kbar``,
  ``ybar``, ``hbar``, ``tbar`` accumulations in torch. No forward eval is
  recomputed. The JAX package takes ``jax.vjp`` of the per-stage
  composition instead for n above its backward kernel's VMEM limit
  (``_bwd_max_n``); the port's K2 serves every n the hook takes (n <= 640),
  so the chain rule serves every step. Where a coefficient plane needs a
  gradient, every cotangent comes from autograd of the plain step, as the
  JAX package takes ``jax.vjp`` of ``_step_reference`` then (and
  :class:`~gncde_tpu_torch.ops.megakernel.MegakernelVF` of the plain eval).

Shapes are batch-first: ``t``, ``h`` ``(B,)``; ``y``, ``f0`` ``(B, n, H)``;
planes ``(B, T-1, n, n)`` or ``(T-1, n, n)``; knots ``(B, T)``. The layers
carry the undirected ``(8, 2)`` or the directed ``(11, 2)`` basis; the
kernel is built for both (its ``directed`` argument), and the backward's
K2 follows the basis. Under ``fusion_precision: bf16`` (``bf16``) the planes
are bfloat16, each stage is K1bf's arithmetic (K11bf, the kernel's bf16
instantiation) and the backward runs one K2bf per stage.
"""

from __future__ import annotations

import ctypes
import functools
import types
import typing as tp

import numpy as np
import torch

from . import _build
from .megakernel import (
    NBASIS_DIRECTED,
    NSTAT,
    Planes,
    _check_inputs,
    _unflatten,
    flat_grads,
    field_basis_size,
    flatten_params,
    interval,
    launch_args,
    plain_vf_eval,
    plain_vf_eval_bf16,
    plain_vjp,
    plan_array,
    row_plans,
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


def _step_reference(planes: Planes, ts, t, y, h, f0, layers, tab, bf16: bool = False,
                    given_ks=None, stage=None):
    """Plain version of K11 (with ``bf16``, of K11bf): ``(y1, err, f1, ks)``
    with ``ks`` ``(B, S, n, H)`` the stage derivatives k_1 .. k_S, each stage a
    :func:`~gncde_tpu_torch.ops.megakernel.plain_vf_eval` (or
    ``plain_vf_eval_bf16``; mirrors the solver's ``_rk_step`` for explicit
    FSAL tableaus).

    Stage by stage: with ``given_ks`` (a kernel's ``ks``) every stage input,
    ``y1`` and ``err`` are formed from the given stage derivatives, so each
    returned stage derivative is one plain eval on the kernel's own stage
    input and ``y1`` and ``err`` differ from the kernel's only by f32 sums.
    ``stage`` replaces the plain eval (called as it is)."""
    _register(tab)
    idx, tau = _stage_nodes(tab, ts, t, h)
    hb = h[:, None, None]
    ks = [f0]
    known = ks if given_ks is None else [f0] + list(given_ks.unbind(1))
    if stage is None:
        stage = plain_vf_eval_bf16 if bf16 else plain_vf_eval
    for s in range(1, tab.num_stages):
        acc = _combine(tab.a[s], known, None)
        yi = y if acc is None else y + hb * acc
        ks.append(stage(planes, idx[:, s - 1], tau[:, s - 1], yi, layers))
    y1 = y + hb * _combine(tab.b, known, torch.zeros_like(y))
    err = hb * _combine(tab.b_err, known, torch.zeros_like(y))
    return y1, err, ks[-1], torch.stack(ks[1:], 1)


_ARGTYPES = [
    _build.P, _build.P, _build.P, _build.P, _build.L,  # planes, stride
    _build.P, _build.P, _build.P, _build.P, _build.P,  # idx, tau, h, y, f0
    _build.I, _build.I, _build.I, _build.I, _build.I,  # Btot, b0, nb, n, S
    _build.P, _build.P, _build.P,  # amat, bvec, berr (host arrays)
    _build.I, _build.P, _build.P, _build.P,  # L, dims, ptrs, row plans (host arrays)
    _build.I, _build.I,  # directed, bf16
    _build.P, _build.P, _build.I, _build.P, _build.P,  # stats, Mbuf, ldm, Yi, ks
    _build.P, _build.P, _build.P, _build.P,  # y1, err, f1, stream
]


def _lib():
    lib = _build.load("fused_step")
    fn = lib.gncde_fused_step
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.gncde_fused_step_capacity.argtypes = [_build.I, _build.I, _build.I]
        lib.gncde_fused_step_capacity.restype = ctypes.c_int
    return lib


_CAPACITY: tp.Dict[tp.Tuple[int, bool, bool, int], int] = {}


def capacity(device, directed: bool = False, bf16: bool = False, smem: int = 0) -> int:
    """How many K11 CTAs (of the directed basis's build or not, the bf16
    one or not, with ``smem`` bytes of dynamic shared memory,
    :func:`step_smem_bytes`) can be resident at once on ``device`` (a
    cooperative launch needs them all resident)."""
    dev = torch.device(device).index
    dev = torch.cuda.current_device() if dev is None else dev
    key = (dev, bool(directed), bool(bf16), int(smem))
    if key not in _CAPACITY:
        with torch.cuda.device(dev):
            _CAPACITY[key] = int(_lib().gncde_fused_step_capacity(
                int(bool(directed)), int(bool(bf16)), key[3]))
    return _CAPACITY[key]


#: The CTA heights of the kernel's stage plans: 8 or 4 rows, whose
#: plans take one column a thread for any layer of the step (at most
#: ``MAX_IN`` wide), so one instantiation of the row pass serves them all.
STEP_BMS = (8, 4)


def step_plans(n: int, B: int, widths, bf16: bool = False):
    """The kernel's row-pass plan per layer
    (:func:`~gncde_tpu_torch.ops.megakernel.row_plans` on :data:`STEP_BMS`;
    any plan gives the per-stage K1 (K1bf) route's bits)."""
    return row_plans(n, B, widths, STEP_BMS, bf16)


def step_smem_bytes(n: int, B: int, layers, bf16: bool = False) -> int:
    """The kernel's dynamic shared memory at ``n`` nodes and batch ``B``
    (``bf16``: K11bf's): the largest of its layers' row-pass plans
    (:func:`step_plans`)."""
    widths = (layers[0]["W"].shape[1],) + tuple(lp["W"].shape[0] for lp in layers)
    return max(p.smem_bytes for p in step_plans(n, B, widths, bf16))


def step_walk(n: int, B: int, plans) -> tp.List[tp.List[tp.Tuple[int, int, int]]]:
    """The virtual CTAs of one stage of the kernel, phase by phase, in
    the order its grid walks them: the prep's (element, 16-row block, 0),
    then each layer's (element, row block, column group) of its plan. CTA
    ``g`` of a grid of ``G`` takes entries ``g, g + G, ...`` of each phase."""
    nrb = -(-n // 16)
    phases = [[(b, r, 0) for b in range(B) for r in range(nrb)]]
    for p in plans:
        per = -(-n // p.bm) * p.groups
        phases.append([(b, w // p.groups, w % p.groups) for b in range(B) for w in range(per)])
    return phases


def _host_floats(a: np.ndarray):
    flat = np.ascontiguousarray(a, np.float32).reshape(-1)
    return (ctypes.c_float * flat.size)(*flat.tolist())


def _launch(planes: Planes, idx, tau, y, h, f0, layers, tabs: TabArrays, bf16: bool):
    amat, bvec, berr, _ = tabs
    S = amat.shape[0]
    directed = _check_inputs(planes, idx[:, 0], tau[:, 0], y, layers,
                             extra=(f0, h), bf16=bf16) == NBASIS_DIRECTED
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
    # Every chunk's stages run on the whole batch's row plans (any plan gives
    # the same bits); the kernel walks them with at most the resident CTAs.
    plans = plan_array(n, B, layers, STEP_BMS)
    smem = step_smem_bytes(n, B, layers, bf16)
    per_launch = capacity(y.device, directed, bf16, smem) // nrb
    if per_launch < 1:
        raise RuntimeError(f"K11: not even one batch element ({nrb} CTAs) fits a "
                           f"cooperative launch on this device")
    y = y.detach().contiguous()
    f0 = f0.detach().contiguous()
    h32 = h.detach().contiguous()
    bstride, idx32, tau32, dims, ptrs, keep = launch_args(planes, idx, tau, layers)
    ldm = scratch_width(layers)
    f32 = dict(device=y.device, dtype=torch.float32)
    stats = torch.empty((B, NSTAT, n), **f32)
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
            ctypes.cast(plans, _build.P),
            int(directed), int(bool(bf16)), _build.ptr(stats), _build.ptr(mbuf), ldm,
            _build.ptr(yi), _build.ptr(ks), _build.ptr(y1), _build.ptr(err), _build.ptr(f1),
            _build.stream())
        _build.check(code, "K11bf fused_step" if bf16 else "K11 fused_step")
        (fused_step_call.bf16 if bf16 else fused_step_call).launches += 1
    del keep
    return y1, err, f1, ks


def fused_step_call(planes: Planes, ts, t, y, h, f0, layers, tab, bf16: bool = False):
    """K11 (with ``bf16``, K11bf on bf16 planes): ``(y1, err, f1, ks)`` of
    one step of ``tab`` from ``(t, y)`` with step ``h`` and FSAL derivative
    ``f0``. The kernel for CUDA tensors (one cooperative launch; a batch
    whose CTAs do not all fit at once in chunks that do), the plain version
    for CPU tensors. Not differentiable by itself (see
    :class:`FusedRKStep`)."""
    if not y.is_cuda:
        return _step_reference(planes, ts, t, y, h, f0, layers, tab, bf16)
    tabs = _register(tab)
    idx, tau = _stage_nodes(tab, ts, t, h)
    return _launch(planes, idx, tau, y, h, f0, layers, tabs, bf16)


#: Launches of the f32 kernel; ``.bf16.launches`` those of K11bf.
fused_step_call.launches = 0
fused_step_call.bf16 = types.SimpleNamespace(launches=0)


def _bsum(x, y):
    """Per-element inner product of two (B, ...) tensors."""
    return (x * y).flatten(1).sum(1)


def step_vjp(tab, planes: Planes, ts, t, y, h, f0, ks, layers, g_y1, g_err, g_f1,
             needs, stage_bwd):
    """The explicit-RK chain rule of one step (``_fused_step_vjp._bwd``):
    per stage, in reverse, ``stage_bwd`` (K2's signature) on the stage input
    rebuilt from the stored stage derivatives ``ks`` (B, S, n, H), then the
    ``kbar``, ``ybar``, ``hbar``, ``tbar`` accumulations in torch. ``needs``
    = (t, y, h, f0, layer parameters) flags; returns ``(tbar, ybar, hbar,
    f0bar, flat parameter grads or None)``."""
    need_t, need_y, need_h, need_f0, need_vf = needs
    amat, bvec, berr, cvec = _register(tab)
    idx, tau = _stage_nodes(tab, ts, t, h)
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
        d_ti, d_Yi, per_layer = stage_bwd(
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
    return (tbar if need_t else None, ybar if need_y else None, hbar if need_h else None,
            kbar[0] if need_f0 else None, d_flat)


class FusedRKStep(torch.autograd.Function):
    """Differentiable fused step: forward K11, backward the explicit-RK chain
    rule with one K2 per stage (with ``bf16``, K11bf and K2bf). Inputs
    ``(tab, nbasis, bf16, ts, t, y, h, f0, d, c, b, a, *flat)`` with
    ``nbasis`` and ``flat`` as for
    :class:`~gncde_tpu_torch.ops.megakernel.MegakernelVF`."""

    @staticmethod
    def forward(ctx, tab, nbasis, bf16, ts, t, y, h, f0, d, c, b, a, *flat):
        layers = _unflatten(flat, nbasis)
        with torch.no_grad():
            y1, err, f1, ks = fused_step_call((d, c, b, a), ts, t, y, h, f0, layers, tab,
                                              bf16)
        ctx.tab, ctx.nbasis, ctx.bf16 = tab, nbasis, bf16
        ctx.save_for_backward(ts, t, y, h, f0, ks, d, c, b, a, *flat)
        return y1, err, f1

    @staticmethod
    def backward(ctx, g_y1, g_err, g_f1):
        ts, t, y, h, f0, ks, d, c, b, a, *flat = ctx.saved_tensors
        # needs[k]: input k of (ts, t, y, h, f0, d, c, b, a, *flat).
        needs = ctx.needs_input_grad[3:]
        if any(needs[5:9]):
            # A plane needs a cotangent: the JAX package's semantics for the
            # case (its ``_bwd`` takes ``jax.vjp`` of ``_step_reference``
            # when the planes are perturbed), not a fallback. Every
            # cotangent comes from autograd of the plain step.
            tab, nbasis, bf16 = ctx.tab, ctx.nbasis, ctx.bf16

            def f(t, y, h, f0, d, c, b, a, *flat):
                return _step_reference((d, c, b, a), ts, t, y, h, f0,
                                       _unflatten(flat, nbasis), tab, bf16)[:3]

            grads = plain_vjp(f, (t, y, h, f0, d, c, b, a, *flat), needs[1:],
                              (g_y1, g_err, g_f1))
            return (None, None, None, None, *grads)
        need_vf = any(needs[9:])

        tbar, ybar, hbar, f0bar, d_flat = step_vjp(
            ctx.tab, (d, c, b, a), ts, t, y, h, f0, ks, _unflatten(flat, ctx.nbasis),
            g_y1, g_err, g_f1, (needs[1], needs[2], needs[3], needs[4], need_vf),
            functools.partial(megakernel_vf_bwd, bf16=ctx.bf16))
        d_flat = d_flat if need_vf else [None] * len(flat)
        return (None, None, None, None, tbar, ybar, hbar, f0bar, None, None, None, None,
                *d_flat)


def fused_rk_step(tab, planes: Planes, ts, t, y, h, f0, vf, bf16: bool = False):
    """One explicit FSAL RK step of the field ``vf`` through K11 (with
    ``bf16``, K11bf).

    Returns ``(y1, err, f1)`` with the semantics of the solver's
    ``_rk_step``. Callers ensure ``tab.fsal`` and an explicit tableau (the
    FSAL property ``a[last] == b`` makes the last stage's eval the next
    step's ``f0``); the field's hook checks the rest.
    """
    _register(tab)
    if ts.dim() == 1:
        ts = ts.unsqueeze(0).expand(y.shape[0], -1)
    return FusedRKStep.apply(tab, field_basis_size(vf), bf16, ts, t, y, h, f0, *planes,
                             *flatten_params(vf))
