"""The megakernel design probes P1-P6 on the card.

Counterpart of the six TPU probes under ``benchmarks/`` (``mk_probe.py``,
``mk_probe2.py``, ``mk_probe4.py`` to ``mk_probe7.py``): each is a
``pl.pallas_call`` that evaluates the undirected perm-equiv field under
``fusion_precision: bf16`` (bf16 Hermite planes, bf16 tensor-core operands,
f32 sums) in another arrangement, at n=400, H=32, L=3, B=16, to ask where
the production eval (K1bf) spends its time. Every variant is registered in
:data:`VARIANTS` under its probe and its JAX name, with a wrapper that
counts its own launches and a plain PyTorch version:

* P1 ``restructured`` and P5 ``v4mm``, ``v4mm_mt``, ``v4mm_bf16``: no
  B1/B2 builds; per layer four products ``Ah Mh``, ``dAh Mh``, ``Ah^T Mh``,
  ``dAh^T Mh`` combined in f32 (the family K1-4mm, ``csrc/mk_probe.cu``):
  ``v4mm_mt`` forms the column side as ``(Mh^T Ah)^T``, ``v4mm_bf16``
  evaluates the Hermite in bf16. P1 and ``v4mm`` are one function and one
  launch. P5 ``full`` is K1bf.
* P2 ``current``, ``fixedslice``, ``batchgrid``: the production body in
  three arrangements. On the card ``current`` and ``batchgrid`` are both
  K1bf's own launch (one launch per eval, each element gathering its
  interval's planes); ``fixedslice`` is K1bf on ``(B, 1, n, n)`` stacks
  sliced once (the caller slices; ``idx`` is then 0).
* P3 ``current``, ``red`` (the statistics pass replaced by a
  ``(B, n, 4)`` operand ``[rA, rdA, diagA, diagdA]`` made in torch from
  :func:`~gncde_tpu_torch.ops.tiled.cubic_plane_reductions`, see
  :func:`red_operand`), ``notr`` (B2 staged in its natural layout and fed
  transposed to the product), ``red_notr``: compile-time flags on K1bf's
  first row pass, ``fwd_rows`` (``csrc/megakernel_common.cuh``,
  instantiated with them only in ``csrc/mk_probe.cu``); ``current`` is
  that pass with every flag off.
* P4 the ablation :data:`DROPS`: each drops one component of the same pass
  through its flag ``D`` (the math is wrong on purpose, as in
  ``mk_probe5.py:52-129``); ``full`` is that pass with every flag off. P3
  and P4 ablate ``fwd_rows``, not K1bf's redesigned row pass, so that each
  variant reads against the pass it changes; P2, P5 ``full`` and P6
  follow K1bf and K11bf onto the redesigned pass.
* P6 ``seq`` (six K1bf launches and the torch stage combinations of one
  Tsit5 step) and ``fusedstep`` (one K11bf launch per step,
  ``ops/fused_step.py``).

On a CUDA tensor a wrapper launches its kernel or raises; a CPU tensor takes
the plain version. The plain versions of P1/P3/P4/P5 take ``given_M`` (a
kernel's per-layer M, read back through the wrapper's ``trace``) to be held
layer by layer, as :func:`~gncde_tpu_torch.ops.megakernel.plain_vf_eval_bf16`
is. Planes are bf16 stacks ``(B, T-1, n, n)`` or ``(T-1, n, n)``; the layer
stack must carry the undirected ``(8, 2)`` basis.
"""

from __future__ import annotations

import ctypes
import typing as tp

import torch

from . import _build
from . import fused_step as fs
from . import megakernel as mk
from .tiled import cubic_plane_reductions, hermite_weights, rank_terms, reductions_at

#: The probes' own shape (all six files): nodes, width, layers, batch, knots.
PROBE_SHAPE = dict(n=400, H=32, L=3, B=16, T=12)
#: P4's ablation variants, in ``mk_probe5.py``'s order (the C enum of
#: ``csrc/mk_probe.cu``).
DROPS = ("full", "no_hermite", "no_reduce", "no_transpose", "no_bbuild", "no_rowmm",
         "no_colmm", "no_norm", "no_glue", "dma_only")
#: Widest layer the K1-4mm kernels take (one 64-column chunk, csrc HC).
MAX_4MM_OUT = 64

Planes = mk.Planes


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def hermite_bf16(planes: Planes, idx, tau):
    """A(t), dA(t) evaluated in bf16 as ``mk_probe6.py:52-59`` does: tau
    rounded, every product and sum rounded to bf16 (held in f32)."""
    r = mk.rbf
    d, c, b, a = (p.to(torch.float32) for p in mk.select_planes(planes, idx))
    t = r(tau)[:, None, None]
    x = r(r(r(r(r(d * t) + c) * t) + b) * t)
    A = r(x + a)
    y = r(r(r(r(3.0 * d) * t) + r(2.0 * c)) * t)
    return A, r(y + b)


def _reductions(A, dA):
    """(rA, rdA, dgA, dgdA) ``(B, n)`` and (sA, sdA) ``(B,)`` in f32."""
    rA, rdA = A.sum(-1), dA.sum(-1)
    return (rA, rdA, torch.diagonal(A, dim1=-2, dim2=-1),
            torch.diagonal(dA, dim1=-2, dim2=-1), rA.sum(-1), rdA.sum(-1))


def _glue(part, M, p, red):
    """``part + dvec M + u s^T + 1 (w + c7 s)^T`` of one undirected layer,
    in JAX's order, from the reductions ``red`` of :func:`_reductions`."""
    n = M.shape[-2]
    dvec, u, v, c7 = rank_terms(p, n, *red)
    s = M.sum(-2, keepdim=True)
    w = (v[..., None] * M).sum(-2, keepdim=True)
    return part + dvec[..., None] * M + u[..., None] * s + (w + c7[:, None, None] * s)


def _stack(Z, layers, layer_fn, given_M, trace, no_norm=False):
    """The layer loop shared by the plain versions: layer ``l`` applies
    ``layer_fn(M, p)`` to its M (``given_M[l]`` when given) and the
    output feeds the next layer through a ReLU. ``trace["M"]`` receives the
    M this version computed per layer."""
    feats, Ms = Z, []
    for l, lp in enumerate(layers):
        Ms.append(feats if no_norm else mk.transform(feats, lp)[0])
        feats = layer_fn(Ms[l] if given_M is None else given_M[l], lp["basis"])
        if l < len(layers) - 1:
            feats = torch.relu(feats)
    if trace is not None:
        trace["M"] = Ms
    return feats


def plain_4mm(planes: Planes, idx, tau, Z, layers, herm_bf16: bool = False, given_M=None,
              trace=None):
    """Plain version of K1-4mm (P1 ``restructured``, P5 ``v4mm`` and
    ``v4mm_mt``; with ``herm_bf16``, ``v4mm_bf16``): per layer the four
    products of ``Ah``, ``dAh`` (A(t), dA(t) rounded to bf16) and their
    transposes with M rounded, exact products summed in f32, combined with
    the unrounded f32 coefficients ``(1 + p1)`` and ``p2``."""
    A, dA = (hermite_bf16 if herm_bf16 else mk.hermite)(planes, idx, tau)
    Ah, dAh = mk.rbf(A), mk.rbf(dA)
    AhT, dAhT = Ah.transpose(-2, -1), dAh.transpose(-2, -1)
    red = _reductions(A, dA)

    def layer(M, p):
        Mh = mk.rbf(M)
        rowpart = (1.0 + p[0, 0]) * (Ah @ Mh) + (1.0 + p[0, 1]) * (dAh @ Mh)
        colpart = p[1, 0] * (AhT @ Mh) + p[1, 1] * (dAhT @ Mh)
        return _glue(rowpart + colpart, M, p, red)

    return _stack(Z, layers, layer, given_M, trace)


def red_operand(planes: Planes, idx, tau, reductions=None):
    """P3's ``(B, n, 4)`` operand ``[rA, rdA, diagA, diagdA]`` at each
    element's interval: the plane reductions (``reductions``, or made here
    by :func:`~gncde_tpu_torch.ops.tiled.cubic_plane_reductions`) weighted
    by the Hermite weights of ``tau`` (``mk_probe4.py:224-231``)."""
    if reductions is None:
        reductions = cubic_plane_reductions(planes)
    rA, rdA, _, _, dgA, dgdA = reductions_at(reductions, idx, *hermite_weights(tau))
    return torch.stack([rA, rdA, dgA, dgdA], -1)


def plain_k1bf_probe(planes: Planes, idx, tau, Z, layers, drop: str = "full", rvec=None,
                     given_M=None, trace=None):
    """Plain version of K1bf with the probe flags (P3, P4): K1bf's function
    (:func:`~gncde_tpu_torch.ops.megakernel.plain_vf_eval_bf16`) with the
    statistics taken from ``rvec`` when given (P3 ``red``) and, per
    ``drop``, one component replaced as ``mk_probe5.py`` replaces it. P3's
    ``notr`` computes K1bf's function (``B2 = b2_0 Ah + b2_1 dAh``
    contracted over its row index is ``B2^T Mh``)."""
    if drop not in DROPS:
        raise ValueError(f"unknown ablation {drop!r}; one of {DROPS}")
    sel = [p.to(torch.float32) for p in mk.select_planes(planes, idx)]
    if drop == "dma_only":
        rows = (sel[0] + sel[1] + sel[2] + sel[3]).sum(-1, keepdim=True)
        return rows * torch.ones(layers[-1]["W"].shape[0], device=rows.device)
    A, dA = (sel[3], sel[2]) if drop == "no_hermite" else mk.hermite(planes, idx, tau)
    Ah, dAh = mk.rbf(A), mk.rbf(dA)
    At, dAt = (Ah, dAh) if drop == "no_transpose" else (Ah.transpose(-2, -1),
                                                        dAh.transpose(-2, -1))
    if drop == "no_reduce":
        one = torch.ones_like(A[..., 0])
        red = (one, one, one, one, one[:, 0], one[:, 0])
    elif rvec is not None:
        rA, rdA = rvec[..., 0], rvec[..., 1]
        red = (rA, rdA, rvec[..., 2], rvec[..., 3], rA.sum(-1), rdA.sum(-1))
    else:
        red = _reductions(A, dA)

    def layer(M, p):
        c = mk.bf16_coeffs(p)
        if drop == "no_bbuild":
            B1, B2t = Ah, dAt
        else:
            B1 = mk.rbf(mk.rbf(c[0] * Ah) + mk.rbf(c[1] * dAh))
            B2t = mk.rbf(mk.rbf(c[2] * At) + mk.rbf(c[3] * dAt))
        Mh = mk.rbf(M)
        rowpart = M if drop == "no_rowmm" else B1 @ Mh
        colpart = M if drop == "no_colmm" else B2t @ Mh
        if drop == "no_glue":
            return rowpart + colpart
        return _glue(rowpart + colpart, M, p, red)

    return _stack(Z, layers, layer, given_M, trace, no_norm=drop == "no_norm")


# ---------------------------------------------------------------------------
# Kernels (csrc/mk_probe.cu)
# ---------------------------------------------------------------------------

_COMMON = [
    _build.P, _build.P, _build.P, _build.P, _build.L,  # planes, stride
    _build.P, _build.P, _build.P,  # idx, tau, Z
    _build.I, _build.I, _build.I,  # B, n, L
    _build.P, _build.P,  # dims, ptrs (host arrays)
]
_ARGTYPES = {
    "gncde_mk4mm": _COMMON + [
        _build.I, _build.I,  # mt, herm_bf16
        _build.P, _build.P, _build.I,  # Ah, dAh, np
        _build.P, _build.P, _build.I, _build.P, _build.P,  # stats, Mbuf, ldm, out, stream
    ],
    "gncde_mkprobe": _COMMON + [
        _build.I, _build.I, _build.I, _build.P,  # drop, red, notr, rvec
        _build.P, _build.P, _build.I, _build.P, _build.P,  # stats, Mbuf, ldm, out, stream
    ],
}


def _fn(name: str):
    fn = getattr(_build.load("mk_probe"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _check(planes, idx, tau, Z, layers, max_out=None, square=False):
    if mk._check_inputs(planes, idx, tau, Z, layers, bf16=True) != mk.NBASIS_UNDIRECTED:
        raise ValueError("the probes take the undirected (8, 2) basis")
    for lp in layers:
        hout, hin = lp["W"].shape
        if max_out is not None and hout > max_out:
            raise ValueError(f"K1-4mm takes layer outputs up to {max_out}; got {hout}")
        if square and hout != hin:
            raise ValueError(f"no_norm feeds a layer's input as its M: needs square "
                             f"layers, got {hin}->{hout}")


def _args(planes, idx, tau, Z, layers):
    """The C arguments shared by both entry points, the M scratch, the
    output and what must outlive the launch."""
    B, n, _ = Z.shape
    Z = Z.detach().contiguous()
    bstride, idx32, tau32, dims, ptrs, keep = mk.launch_args(planes, idx, tau, layers)
    ldm = mk.scratch_width(layers)
    f32 = dict(device=Z.device, dtype=torch.float32)
    mbuf = torch.empty((len(layers), B, n, ldm), **f32)
    out = torch.empty((B, n, layers[-1]["W"].shape[0]), **f32)
    head = [*[_build.ptr(p) for p in planes], bstride, _build.ptr(idx32), _build.ptr(tau32),
            _build.ptr(Z), B, n, len(layers), ctypes.cast(dims, _build.P),
            ctypes.cast(ptrs, _build.P)]
    return head, mbuf, ldm, out, keep + [Z]


def _trace(trace, mbuf, layers):
    if trace is not None:
        trace["M"] = [mbuf[l, :, :, :lp["W"].shape[0]] for l, lp in enumerate(layers)]


def launch_4mm(planes: Planes, idx, tau, Z, layers, mt: bool = False, herm_bf16: bool = False,
               trace=None):
    """One K1-4mm eval on the card: a prep pass writes ``Ah``, ``dAh``
    (bf16, zero-padded to a multiple of 32) and the statistics, then one
    pass per layer runs the four products (``mt``: the column side as
    ``(Mh^T Ah)^T``)."""
    if mt and herm_bf16:
        raise ValueError("K1-4mm: the bf16 Hermite is built for the transposed-load form")
    _check(planes, idx, tau, Z, layers, max_out=MAX_4MM_OUT)
    head, mbuf, ldm, out, keep = _args(planes, idx, tau, Z, layers)
    B, n, _ = Z.shape
    npad = -(-n // 32) * 32
    bf = dict(device=Z.device, dtype=torch.bfloat16)
    Ah, dAh = torch.empty((B, npad, npad), **bf), torch.empty((B, npad, npad), **bf)
    stats = torch.empty((B, 4, n), device=Z.device, dtype=torch.float32)
    err = _fn("gncde_mk4mm")(*head, int(mt), int(herm_bf16), _build.ptr(Ah), _build.ptr(dAh),
                             npad, _build.ptr(stats), _build.ptr(mbuf), ldm, _build.ptr(out),
                             _build.stream())
    _build.check(err, "K1-4mm mk_probe")
    del keep
    _trace(trace, mbuf, layers)
    return out


def launch_k1bf_probe(planes: Planes, idx, tau, Z, layers, drop: str = "full", notr=False,
                      rvec=None, trace=None):
    """One eval of K1bf's first passes with the probe flags on the card (P3
    ``red`` with ``rvec``, ``notr``; P4 ``drop``): the prep pass and
    ``fwd_rows`` instantiated with them; without a flag (P3 ``current``,
    P4 ``full``) the same passes with every flag off."""
    if drop not in DROPS:
        raise ValueError(f"unknown ablation {drop!r}; one of {DROPS}")
    if (notr or rvec is not None) and drop != "full":
        raise ValueError("red and notr are variants of the full body")
    _check(planes, idx, tau, Z, layers, square=drop == "no_norm")
    B, n, _ = Z.shape
    if rvec is not None and (rvec.shape != (B, n, 4) or rvec.dtype != torch.float32
                             or rvec.device != Z.device):
        raise ValueError("rvec must be a float32 (B, n, 4) tensor on the node state's device")
    rvec = None if rvec is None else rvec.contiguous()
    head, mbuf, ldm, out, keep = _args(planes, idx, tau, Z, layers)
    stats = torch.empty((B, mk.NSTAT, n), device=Z.device, dtype=torch.float32)
    err = _fn("gncde_mkprobe")(*head, DROPS.index(drop), int(rvec is not None), int(notr),
                               _build.ptr(rvec), _build.ptr(stats), _build.ptr(mbuf), ldm,
                               _build.ptr(out), _build.stream())
    _build.check(err, f"K1bf probe ({drop}{', red' if rvec is not None else ''}"
                      f"{', notr' if notr else ''}) mk_probe")
    del keep
    if drop != "dma_only":
        _trace(trace, mbuf, layers)
    return out


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------


class Variant:
    """One probe variant: ``kind`` ``"eval"`` (called as ``(planes, idx,
    tau, Z, layers, rvec=None, trace=None)``) or ``"step"`` (``(planes, ts,
    t, y, h, f0, layers, tab)``, returning ``(y1, err, f1, ks)``).
    ``launches`` counts the kernel launches its wrapper made on the card."""

    def __init__(self, probe, name, family, replaces, kernel, plain, kind="eval",
                 source="gncde_tpu_torch/csrc/mk_probe.cu", needs_red=False):
        self.probe, self.name, self.family, self.replaces = probe, name, family, replaces
        self.kernel, self.plain, self.kind, self.source = kernel, plain, kind, source
        self.needs_red = needs_red
        self.launches = 0

    @property
    def key(self) -> str:
        return f"{self.probe}/{self.name}"

    def __call__(self, *args, **kw):
        if args[3].is_cuda:  # the node state Z, or the step's y
            return self.kernel(self, *args, **kw)
        return self.plain(*args, **kw)


def _once(launch):
    """A kernel function that counts one launch per call."""
    def kernel(variant, *args, **kw):
        out = launch(*args, **kw)
        variant.launches += 1
        return out
    return kernel


def _k1bf(planes, idx, tau, Z, layers, rvec=None, trace=None):
    return mk.megakernel_vf_eval(planes, idx, tau, Z, layers, bf16=True, trace=trace)


def _plain_k1bf(planes, idx, tau, Z, layers, rvec=None, given_M=None, trace=None):
    return mk.plain_vf_eval_bf16(planes, idx, tau, Z, layers, given_M=given_M, trace=trace)


def _4mm(mt=False, herm_bf16=False):
    def launch(planes, idx, tau, Z, layers, rvec=None, trace=None):
        return launch_4mm(planes, idx, tau, Z, layers, mt, herm_bf16, trace)

    def plain(planes, idx, tau, Z, layers, rvec=None, given_M=None, trace=None):
        return plain_4mm(planes, idx, tau, Z, layers, herm_bf16, given_M, trace)
    return _once(launch), plain


def _probe(drop="full", red=False, notr=False):
    def launch(planes, idx, tau, Z, layers, rvec=None, trace=None):
        return launch_k1bf_probe(planes, idx, tau, Z, layers, drop, notr,
                                 rvec if red else None, trace)

    def plain(planes, idx, tau, Z, layers, rvec=None, given_M=None, trace=None):
        return plain_k1bf_probe(planes, idx, tau, Z, layers, drop, rvec if red else None,
                                given_M, trace)
    return _once(launch), plain


def _seq_kernel(variant, planes, ts, t, y, h, f0, layers, tab):
    """P6 ``seq``: the Tsit5 step as six K1bf launches and the torch stage
    combinations (:func:`~gncde_tpu_torch.ops.fused_step._step_reference`
    with K1bf as its stage)."""
    def stage(*args):
        out = mk.megakernel_vf_eval(*args, bf16=True)
        variant.launches += 1
        return out
    return fs._step_reference(planes, ts, t, y, h, f0, layers, tab, True, stage=stage)


def _fused_kernel(variant, planes, ts, t, y, h, f0, layers, tab):
    """P6 ``fusedstep``: K11bf, one cooperative launch per step (in batch
    chunks that fit the card, ``fused_step.capacity``)."""
    before = fs.fused_step_call.bf16.launches
    out = fs.fused_step_call(planes, ts, t, y, h, f0, layers, tab, bf16=True)
    variant.launches += fs.fused_step_call.bf16.launches - before
    return out


def _plain_step(planes, ts, t, y, h, f0, layers, tab):
    return fs._step_reference(planes, ts, t, y, h, f0, layers, tab, True)


_K1BF_SRC = "gncde_tpu_torch/csrc/megakernel_fwd.cu"
_K11BF_SRC = "gncde_tpu_torch/csrc/fused_step.cu"


def _registry() -> tp.Dict[str, Variant]:
    k1bf = (_once(_k1bf), _plain_k1bf)
    rows = [
        ("P1", "restructured", "K1-4mm", "benchmarks/mk_probe.py:107", *_4mm(), {}),
        ("P2", "current", "K1bf", "benchmarks/mk_probe2.py:69", *k1bf, dict(source=_K1BF_SRC)),
        ("P2", "fixedslice", "K1bf", "benchmarks/mk_probe2.py:69", *k1bf,
         dict(source=_K1BF_SRC)),
        ("P2", "batchgrid", "K1bf", "benchmarks/mk_probe2.py:99", *k1bf,
         dict(source=_K1BF_SRC)),
        ("P3", "current", "K1bf-probe", "benchmarks/mk_probe4.py:183", *_probe(), {}),
        ("P3", "red", "K1bf-probe", "benchmarks/mk_probe4.py:183", *_probe(red=True),
         dict(needs_red=True)),
        ("P3", "notr", "K1bf-probe", "benchmarks/mk_probe4.py:183", *_probe(notr=True), {}),
        ("P3", "red_notr", "K1bf-probe", "benchmarks/mk_probe4.py:183",
         *_probe(red=True, notr=True), dict(needs_red=True)),
    ]
    rows += [("P4", drop, "K1bf-ablation", "benchmarks/mk_probe5.py:177", *_probe(drop), {})
             for drop in DROPS]
    rows += [
        ("P5", "full", "K1bf", "benchmarks/mk_probe6.py:175", *k1bf, dict(source=_K1BF_SRC)),
        ("P5", "v4mm", "K1-4mm", "benchmarks/mk_probe6.py:175", *_4mm(), {}),
        ("P5", "v4mm_mt", "K1-4mm", "benchmarks/mk_probe6.py:175", *_4mm(mt=True), {}),
        ("P5", "v4mm_bf16", "K1-4mm", "benchmarks/mk_probe6.py:175", *_4mm(herm_bf16=True),
         {}),
        ("P6", "seq", "K1bf", "benchmarks/mk_probe7.py:183", _seq_kernel, _plain_step,
         dict(kind="step", source=_K1BF_SRC)),
        ("P6", "fusedstep", "K11bf", "benchmarks/mk_probe7.py:241", _fused_kernel,
         _plain_step, dict(kind="step", source=_K11BF_SRC)),
    ]
    out = {}
    for probe, name, family, rep, kernel, plain, kw in rows:
        v = Variant(probe, name, family, rep, kernel, plain, **kw)
        out[v.key] = v
    return out


#: Every probe variant, keyed ``"P<k>/<JAX name>"``.
VARIANTS: tp.Dict[str, Variant] = _registry()


def reset_launches() -> None:
    for v in VARIANTS.values():
        v.launches = 0
