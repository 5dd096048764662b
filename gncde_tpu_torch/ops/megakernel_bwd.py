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
* :func:`plain_vf_bwd_bf16` is the plain version of K2bf, the backward under
  ``fusion_precision: bf16``, written out as ``_make_bwd_kernel(bf16=True)``
  computes it (not autograd of the bf16 forward: the JAX kernel rounds g
  and M for its products, and reads the unrounded planes for the basis
  cotangents).
* :func:`megakernel_vf_bwd` launches ``csrc/megakernel_bwd.cu`` (f32: the
  forward recompute on K1's row pass) or, with ``bf16``,
  ``csrc/megakernel_bwd_bf.cu`` (K1bf's prep and bf16 row pass), then the
  reverse sweep of ``csrc/bwd_sweep.cuh`` on :func:`bwd_row_plan`'s plan
  per layer (bf16: its tensor-core instantiation on bf16 planes) for CUDA
  tensors and raises if it cannot.
"""

from __future__ import annotations

import ctypes
import functools
import types
import typing as tp

import torch

from . import _build, megakernel
from .megakernel import (
    NBASIS_DIRECTED,
    NSTAT,
    Planes,
    LayerParams,
    _LAYER_KEYS,
    _check_inputs,
    bf16_coeffs,
    bf16_layer,
    bf16_rank_vectors,
    bf16_stats,
    hermite,
    hermite3,
    launch_args,
    plain_layer_stack,
    plan_array,
    rbf,
    scratch_width,
    transform,
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


def _bsum(x: torch.Tensor) -> torch.Tensor:
    """Per-element total of a (B, ...) tensor, (B,)."""
    return x.flatten(1).sum(1)


@torch.no_grad()
def plain_vf_bwd_bf16(planes: Planes, idx, tau, Z, layers: tp.Sequence[LayerParams],
                      G, need_tau: bool = True, given=None, trace=None):
    """Plain PyTorch version of K2bf (either basis), in K2's return layout.

    The forward is recomputed as K1bf computes it. Per layer in reverse:
    ``P = gb Mb^T`` and ``Q = P^T`` of the bf16-rounded cotangent and M; the
    basis cotangents ``<A|dA, P>``, ``<A|dA, Q>`` on the unrounded planes;
    ``dM = Cop gb + (rank terms)`` with ``Cop = b1_0 Ah^T + b1_1 dAh^T + b2_0
    Ah + b2_1 dAh`` formed in bf16 in that order (each product and sum
    rounded); everything else in f32.

    Layer by layer: ``given`` (a kernel's intermediates, read back through
    :func:`megakernel_vf_bwd`'s ``trace``: per layer ``"M"``, the inputs
    ``"X"`` and the masked input cotangents ``"g"``, entry 0 of the last
    two unused) makes each layer's forward and backward start from the
    given values, so both sides round the same M and g to bf16 and only one
    layer's f32 sums separate them. ``trace`` (a dict) receives this
    version's own ``"M"``, ``"X"`` and ``"g"`` in that layout."""
    n = Z.shape[-2]
    A, dA, ddA = hermite3(planes, idx, tau, need_dd=need_tau)
    st = bf16_stats(A, dA)
    directed = layers[0]["basis"].shape[0] == NBASIS_DIRECTED
    if need_tau:
        rddA = ddA.sum(-1, keepdim=True)
        sddA = rddA.sum(-2, keepdim=True)
        dgddA = torch.diagonal(ddA, dim1=-2, dim2=-1)[..., None]
        cddA = ddA.sum(-2)[..., None]
    L = len(layers)
    # Each layer's input x, M and its input's masked cotangent: the given
    # ones when layer by layer, else this version's own.
    x_in = (lambda l: Z if l == 0 else given["X"][l]) if given else (lambda l: xs[l])
    m_in = (lambda l: given["M"][l]) if given else (lambda l: Ms[l])
    xs, zns, invs, Ms = [Z], [], [], []
    for l, lp in enumerate(layers):
        M, zn, inv = transform(x_in(l), lp)
        zns.append(zn)
        invs.append(inv)
        Ms.append(M)
        out = bf16_layer(st, m_in(l), lp["basis"])
        xs.append(torch.relu(out) if l < L - 1 else out)

    g = G
    gs = [None] * L
    dtau = torch.zeros_like(tau)
    per_layer = [None] * L
    for l in range(L - 1, -1, -1):
        lp, p = layers[l], layers[l]["basis"]
        x, zn, inv, M = x_in(l), zns[l], invs[l], m_in(l)
        if l < L - 1:
            if given:
                g = given["g"][l + 1]
            g = torch.where(x_in(l + 1) > 0.0, g, torch.zeros_like(g))
        gb, Mb = rbf(g), rbf(M)
        P = gb @ Mb.transpose(-2, -1)
        Q = P.transpose(-2, -1)
        dvec, u, v, c7 = bf16_rank_vectors(st, p, n)
        s = M.sum(-2, keepdim=True)  # (B, 1, H)
        gcol = g.sum(-2, keepdim=True)
        gM_row = (g * M).sum(-1, keepdim=True)  # (B, n, 1)
        du_vec = (g * s).sum(-1, keepdim=True)
        dv_vec = (M * gcol).sum(-1, keepdim=True)
        dc7 = _bsum(gcol * s)
        sgM = _bsum(gM_row)
        sA, sdA = st.sA.flatten(), st.sdA.flatten()

        def pair(x0, x1):
            return torch.stack([x0, x1], -1)

        def dots(vec, a, b):
            return pair(_bsum(vec * a), _bsum(vec * b)) / n

        dp1 = pair(_bsum(A * P), _bsum(dA * P))
        dp2 = pair(_bsum(A * Q), _bsum(dA * Q))
        dp3 = pair(_bsum(gM_row * st.dgA), _bsum(gM_row * st.dgdA))
        dp7v = dc7 * sA / n**2
        dp7 = pair(dp7v, dp7v)
        dp8 = pair(sgM * sA / n**2, sgM * sdA / n**2)
        if directed:
            dbasis = [dp1, dp2, dp3, dots(du_vec, st.cA, st.cdA), dots(dv_vec, st.rA, st.cdA),
                      dots(dv_vec, st.cA, st.cdA), dots(dv_vec, st.rA, st.rdA),
                      dots(gM_row, st.cA, st.cdA), dots(gM_row, st.rA, st.rdA), dp7, dp8]
        else:
            dbasis = [dp1, dp2, dp3, dots(du_vec, st.rA, st.rdA), dots(dv_vec, st.rA, st.rdA),
                      dots(gM_row, st.rA, st.rdA), dp7, dp8]
        dbasis = torch.stack(dbasis, 1)  # (B, P, 2)

        if need_tau:
            dtau = dtau + (1.0 + p[0, 0]) * dp1[:, 1] + (1.0 + p[0, 1]) * _bsum(ddA * P)
            dtau = dtau + p[1, 0] * dp2[:, 1] + p[1, 1] * _bsum(ddA * Q)
            if directed:
                _, _, p3, p4, p4p, p5, p5p, p6, p6p, p7, p8 = p
                ddvec_dt = (p3[0] * st.dgdA + p3[1] * dgddA + (p6[0] * st.cdA + p6[1] * cddA) / n
                            + (p6p[0] * st.rdA + p6p[1] * rddA) / n
                            + (p8[0] * st.sdA + p8[1] * sddA) / n**2)
                du_dt = (p4[0] * st.cdA + p4[1] * cddA) / n
                dv_dt = (p4p[0] * st.rdA + p4p[1] * cddA + p5[0] * st.cdA + p5[1] * cddA
                         + p5p[0] * st.rdA + p5p[1] * rddA) / n
            else:
                _, _, p3, p4, p5, p6, p7, p8 = p
                ddvec_dt = (p3[0] * st.dgdA + p3[1] * dgddA + (p6[0] * st.rdA + p6[1] * rddA) / n
                            + (p8[0] * st.sdA + p8[1] * sddA) / n**2)
                du_dt = (p4[0] * st.rdA + p4[1] * rddA) / n
                dv_dt = (p5[0] * st.rdA + p5[1] * rddA) / n
            dtau = dtau + _bsum(gM_row * ddvec_dt) + _bsum(du_vec * du_dt) + _bsum(dv_vec * dv_dt)
            dtau = dtau + dc7 * (p7[0] + p7[1]) * sdA / n**2

        c = bf16_coeffs(p)
        Aht, dAht = st.Ah.transpose(-2, -1), st.dAh.transpose(-2, -1)
        Cop = rbf(rbf(c[0] * Aht) + rbf(c[1] * dAht))
        Cop = rbf(Cop + rbf(c[2] * st.Ah))
        Cop = rbf(Cop + rbf(c[3] * st.dAh))
        utg = (u * g).sum(-2, keepdim=True)
        dM = Cop @ gb + dvec * g + utg + v * gcol + c7 * gcol

        dW = dM.transpose(-2, -1) @ zn  # (B, Hout, Hin)
        dlin_b = dM.sum(-2)
        dzn = dM @ lp["W"]
        dnorm_w = (dzn * x * inv).sum(-2)
        dnorm_b = dzn.sum(-2)
        h = dzn * lp["norm_w"]
        dot_hx = (h * x).sum(-1, keepdim=True)
        g = h * inv - x * (inv**3 / x.shape[-1]) * dot_hx
        if l > 0:
            gs[l] = torch.where(x > 0.0, g, torch.zeros_like(g))
        per_layer[l] = (dnorm_w, dnorm_b, dW, dlin_b, dbasis)
    if trace is not None:
        trace.update(M=Ms, X=[None] + xs[1:L], g=gs)
    return dtau, g, per_layer


# ---------------------------------------------------------------------------
# The reverse sweep's launch plan (csrc/bwd_sweep.cuh)
# ---------------------------------------------------------------------------

#: Ring stages of the sweep's M and g tiles (``BSTAGES``), the dynamic shared
#: memory a plan may take (``BWD_SMEM_MAX``: with the sweep's static shared
#: memory it stays inside an H100 CTA's 227 KB) and the most layers one K2
#: call takes (``BWD_LMAX``).
BWD_STAGES = 3
BWD_SMEM_MAX = 204_800
BWD_MAX_LAYERS = 16
#: The CTA heights :func:`bwd_row_plan` tries, tallest first (a tool or test
#: that times or checks one height sets this to it).
BWD_BMS = (16, 8, 4)
#: Sweep CTAs an SM holds at once: at most two by registers (128 a thread,
#: ptxas), fewer where shared memory binds: the SM's 228 KB over the plan's
#: dynamic and the sweep's static shared memory (``BwdShared``) and 1 KB the
#: card keeps per CTA.
BWD_CTAS_BY_REGISTERS = 2
SM_SMEM_BYTES = 228 * 1024
BWD_STATIC_BYTES = 4 * (3 * 128 + 3 * 256 + 8 + 2 * 16 * 64 + 16 + 16 * 3 + 16 * 2 + 8 * 14)


class BwdPlan(tp.NamedTuple):
    """One layer's plan of the reverse sweep: ``bm`` rows per CTA, ``cc``
    output columns per thread (f32; the bf16 sweep's products are warps'
    tensor-core blocks, and cc only sets its width), ``cw = 512 cc / bm``
    columns per CTA, ``groups`` CTAs across the output's width; the grid's
    CTAs and each CTA's dynamic shared memory."""

    bm: int
    cc: int
    cw: int
    groups: int
    ctas: int
    smem_bytes: int


def bwd_smem_bytes(n: int, bm: int, cw: int, H: int, tau: bool, bf16: bool = False) -> int:
    """Dynamic shared memory of one sweep CTA (``bwd_smem_floats``): u over
    n rounded up to the ring tile; the row operands C^T, A, dA at (i, k) and
    (k, i) (and ddA at both under ``tau``), bm rows of npad + 4; the CTA's
    rows of g (ring width + 64 / bm); the ring of M and g tiles, rows of
    ``cw`` columns, or of H rounded up to 4 where one group holds the
    layer. With ``bf16`` (``bwd_smem_bytes_bf``) C^T's rows are bf16 (npad +
    8 halves, at least 8 rows), beside bf16 copies of the CTA's rows of g
    and of one ring tile of M and g (the ring width rounded up to 16, plus
    8 halves). A card test holds it to the library's own count
    (``gncde_bwd_smem_bytes``)."""
    kt = megakernel.ROW_KT
    npad = -(-n // kt) * kt
    rw = min(cw, -(-H // 4) * 4)
    nrow = 7 if tau else 5
    f32 = npad + nrow * bm * (npad + 4) + bm * (rw + 64 // bm) + BWD_STAGES * 2 * kt * rw
    if not bf16:
        return 4 * f32
    nbr, hw = max(bm, 8), -(-rw // 16) * 16
    return 4 * (f32 - bm * (npad + 4)) + 2 * (nbr * (npad + 8) + (nbr + 2 * kt) * (hw + 8))


def bwd_waves(p: BwdPlan) -> int:
    """How many rounds of resident CTAs the plan's grid takes on the card
    (``_build.SMS`` SMs, :data:`BWD_CTAS_BY_REGISTERS` CTAs an SM at most)."""
    per_sm = min(BWD_CTAS_BY_REGISTERS,
                 SM_SMEM_BYTES // (p.smem_bytes + BWD_STATIC_BYTES + 1024))
    return -(-p.ctas // (_build.SMS * per_sm))


def bwd_row_plan(n: int, B: int, H: int, tau: bool, bms=None, bf16: bool = False) -> BwdPlan:
    """The sweep's plan for an ``H``-wide layer at ``n`` nodes and batch
    ``B`` (``tau``: the dtau operands too; ``bf16``: the bf16 sweep's shared
    memory, :func:`bwd_smem_bytes`). Per CTA height ``bm`` of ``bms``
    (by default :data:`BWD_BMS`: 16, 8, 4 rows), the fewest columns per
    thread whose CTA holds the whole layer (``cw`` up to 128; wider layers
    take ``ceil(H / cw)`` groups), narrowed where its shared memory would
    pass :data:`BWD_SMEM_MAX`; of those, the one whose grid takes the fewest
    waves of resident CTAs (:func:`bwd_waves`: a CTA's time is its own
    serial chain, so a second wave doubles it), then the one with the most
    CTAs (the shortest chains). Raises where none fits."""
    cands = []
    for bm in BWD_BMS if bms is None else bms:
        ccs = [cc for cc in (1, 2, 4) if 32 <= 512 * cc // bm <= 128]
        first = next((i for i, c in enumerate(ccs) if 512 * c // bm >= H), len(ccs) - 1)
        for cc in reversed(ccs[:first + 1]):
            cw = 512 * cc // bm
            smem = bwd_smem_bytes(n, bm, cw, H, tau, bf16)
            if smem <= BWD_SMEM_MAX:
                groups = -(-H // cw)
                cands.append(BwdPlan(bm, cc, cw, groups, -(-n // bm) * groups * B, smem))
                break
    if not cands:
        raise ValueError(f"no sweep plan fits n={n}, H={H} in {BWD_SMEM_MAX} bytes")
    return min(cands, key=lambda p: (bwd_waves(p), -p.ctas))


def bwd_row_plans(n: int, B: int, widths, tau: bool, bms=None,
                  bf16: bool = False) -> tp.List[BwdPlan]:
    """:func:`bwd_row_plan` of every layer of a stack of ``widths``."""
    return [bwd_row_plan(n, B, h, tau, bms, bf16) for h in widths[1:]]


class BwdLayout(tp.NamedTuple):
    """What one K2 call launches and allocates: the sweep's plans as
    the C entry point takes them (a host array of (bm, cc, groups) per
    layer), the floats of the layers' partial blocks (B, ceil(n / bm),
    ptot_l) and of the scratch of its layers of several groups."""

    plans: tp.Any
    part_floats: int
    work_floats: int


@functools.lru_cache(maxsize=256)
def _bwd_layout(n: int, B: int, sizes: tp.Tuple[tp.Tuple[int, int], ...], nbasis: int,
                tau: bool, bms: tp.Tuple[int, ...], bf16: bool) -> BwdLayout:
    widths = (sizes[0][0],) + tuple(ho for _, ho in sizes)
    plans = bwd_row_plans(n, B, widths, tau, bms, bf16)
    part = work = 0
    for (hi, ho), p in zip(sizes, plans):
        nrb = -(-n // p.bm)
        part += B * nrb * (2 * hi + ho * hi + ho + 2 * nbasis + 1)
        if p.groups > 1:
            work = max(work, B * p.groups * (n * (hi + 3) + nrb * 8))
    flat = [x for p in plans for x in (p.bm, p.cc, p.groups)]
    return BwdLayout((ctypes.c_int * len(flat))(*flat), part, work)


def bwd_layout(n: int, B: int, layers, nbasis: int, tau: bool, bf16: bool = False) -> BwdLayout:
    """The K2 call's :class:`BwdLayout` (cached per shape, basis, tau,
    :data:`BWD_BMS` and precision)."""
    return _bwd_layout(n, B, tuple(_layer_sizes(layers)), nbasis, bool(tau), tuple(BWD_BMS),
                       bool(bf16))


_BWD_ARGTYPES = [
    _build.P, _build.P, _build.P, _build.P, _build.L,  # planes, stride
    _build.P, _build.P, _build.P, _build.P,  # idx, tau, Z, G
    _build.I, _build.I, _build.I,  # B, n, L
    _build.P, _build.P,  # dims, ptrs (host arrays)
    _build.P, _build.P,  # K1's row plans (the recompute's), the sweep's plans (host arrays)
    _build.I, _build.I,  # directed, need_tau
    _build.P, _build.P, _build.P, _build.P, _build.I,  # stats, M, X, g, ldm
    _build.P,  # dZ
    _build.P, _build.L, _build.P, _build.L,  # part, its floats, work, its floats
    _build.I, _build.P,  # ptot, red
    _build.P,  # stream
]


def _bwd_lib(bf16: bool):
    if bf16:
        fn = _build.load("megakernel_bwd_bf").gncde_mk_bwd_bf16
    else:
        fn = _build.load("megakernel_bwd").gncde_mk_bwd
    if fn.argtypes is None:
        fn.argtypes = _BWD_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _layer_sizes(layers) -> tp.List[tp.Tuple[int, int]]:
    return [(lp["W"].shape[1], lp["W"].shape[0]) for lp in layers]


def _launch_bwd(planes: Planes, idx, tau, Z, layers, G, need_tau, bf16, trace=None):
    nbasis = _check_inputs(planes, idx, tau, Z, layers, extra=(G,), bf16=bf16)
    if G.shape != Z.shape[:2] + (layers[-1]["W"].shape[0],):
        raise ValueError(f"G {tuple(G.shape)} does not match the output shape")
    fn = _bwd_lib(bf16)
    B, n, hin0 = Z.shape
    L = len(layers)
    dev = Z.device
    Z = Z.detach().contiguous()
    G = G.detach().contiguous()
    bstride, idx32, tau32, dims, ptrs, keep = launch_args(planes, idx, tau, layers)
    sizes = _layer_sizes(layers)
    ptot = sum(2 * hi + ho * hi + ho + 2 * nbasis + 1 for hi, ho in sizes)
    if L > BWD_MAX_LAYERS:
        raise ValueError(f"K2 takes up to {BWD_MAX_LAYERS} layers; got {L}")
    f32 = dict(device=dev, dtype=torch.float32)
    stats = torch.empty((B, NSTAT, n), **f32)
    ldm = scratch_width(layers)
    mbuf = torch.empty((L, B, n, ldm), **f32)
    xbuf = torch.empty((L, B, n, ldm), **f32)
    gbuf = torch.empty((L, B, n, ldm), **f32)
    dZ = torch.empty((B, n, hin0), **f32)
    lay = bwd_layout(n, B, layers, nbasis, need_tau, bf16)
    part = torch.empty((lay.part_floats,), **f32)
    work = torch.empty((lay.work_floats,), **f32) if lay.work_floats else None
    red = torch.empty((B, ptot), **f32)
    err = fn(
        *[_build.ptr(p) for p in planes], bstride,
        _build.ptr(idx32), _build.ptr(tau32), _build.ptr(Z), _build.ptr(G),
        B, n, L, ctypes.cast(dims, _build.P), ctypes.cast(ptrs, _build.P),
        ctypes.cast(plan_array(n, B, layers), _build.P),
        ctypes.cast(lay.plans, _build.P), int(nbasis == NBASIS_DIRECTED), int(bool(need_tau)),
        _build.ptr(stats), _build.ptr(mbuf), _build.ptr(xbuf), _build.ptr(gbuf),
        ldm, _build.ptr(dZ), _build.ptr(part), part.numel(), _build.ptr(work),
        0 if work is None else work.numel(), ptot, _build.ptr(red),
        _build.stream(),
    )
    _build.check(err, "K2bf megakernel_bwd" if bf16 else "K2 megakernel_bwd")
    (megakernel_vf_bwd.bf16 if bf16 else megakernel_vf_bwd).launches += 1
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
    if trace is not None:
        trace.update(M=[mbuf[l, :, :, :ho] for l, (_, ho) in enumerate(sizes)],
                     X=[None] + [xbuf[l, :, :, :hi] for l, (hi, _) in enumerate(sizes) if l],
                     g=[None] + [gbuf[l, :, :, :hi] for l, (hi, _) in enumerate(sizes) if l])
    return dtau, dZ, [c for c, _ in per_layer]


def megakernel_vf_bwd(planes: Planes, idx, tau, Z, layers, G,
                      need_tau: bool = True, bf16: bool = False, trace=None):
    """K2 (with ``bf16``, K2bf on bf16 planes): the CUDA kernel for CUDA
    tensors, the plain version on CPU. ``trace`` (a dict) receives each
    layer's M, input x and masked input cotangent g (``"M"``, ``"X"``,
    ``"g"``; entry 0 of the last two None): the kernel's, read back from its
    scratch, or (CPU, bf16) the plain version's."""
    if Z.is_cuda:
        return _launch_bwd(planes, idx, tau, Z, layers, G, need_tau, bf16, trace)
    if bf16:
        return plain_vf_bwd_bf16(planes, idx, tau, Z, layers, G, need_tau, trace=trace)
    return plain_vf_bwd(planes, idx, tau, Z, layers, G, need_tau)


#: Launches of the f32 kernel; ``.bf16.launches`` those of K2bf.
megakernel_vf_bwd.launches = 0
megakernel_vf_bwd.bf16 = types.SimpleNamespace(launches=0)
