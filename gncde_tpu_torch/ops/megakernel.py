"""K1: one whole vector-field evaluation per batch element.

Counterpart of ``gncde_tpu/ops/pallas/megakernel.py``. For each batch
element ``b`` the eval reads that element's four Hermite interval planes
``d, c, b, a`` at interval ``idx[b]``, forms ``A(tau[b])`` and
``dA(tau[b])``, and runs the perm-equiv layer stack
``L x [RMSNorm -> Linear -> A_bar @ M (+ M)]`` with ReLU between layers, on
the undirected 8-term basis (each layer's ``basis`` is ``(8, 2)``) or the
directed 11-term one (``(11, 2)``, ``fusion_matrix_dense_directed``), one
basis for the whole stack.

* :func:`plain_vf_eval` is the plain PyTorch version (the dense layer
  stack, counterpart of ``_xla_reference``). CPU tensors always take it.
* :func:`plain_vf_eval_bf16` is the plain version of K1bf, the eval under
  ``fusion_precision: bf16`` (``_make_vf_body(bf16=True)``): bf16 planes
  read and evaluated in f32, the two n x n products on bf16 operands
  rounded where JAX rounds them, with f32 sums; everything else f32.
* :func:`megakernel_vf_eval` launches the CUDA kernel
  (``csrc/megakernel_fwd.cu``: the prep pass, then one row pass per layer
  on that layer's :func:`row_plan`; with ``bf16`` the bf16 row pass on
  bf16 planes, its products on the tensor cores) for CUDA tensors and
  raises if it cannot.
* :class:`MegakernelVF` is the ``autograd.Function`` the vector field
  calls: forward is K1, backward is K2 (``ops/megakernel_bwd.py``), or,
  where a coefficient plane needs a gradient, autograd of the plain
  version, as the JAX package's ``_mk_bwd`` takes ``jax.vjp`` of
  ``_xla_reference`` then.

Planes are ``(T-1, n, n)`` (shared by the batch) or ``(B, T-1, n, n)``
(one stack per element, as the trainer's irregular time grids need):
float32, or bfloat16 for the bf16 kernels.
"""

from __future__ import annotations

import ctypes
import functools
import types
import typing as tp

import torch

from . import _build
from .equiv_basis import fusion_matrix_dense, fusion_matrix_dense_directed

#: Largest n the vf-level kernels serve; above it the tiled regime (ROADMAP
#: slice 2) is needed. Kept equal to the JAX package's cap so both packages
#: dispatch the same shapes.
MEGAKERNEL_MAX_N = 640
#: Widest layer input and output the kernels take
#: (csrc/megakernel_common.cuh MAXIN, MAXOUT): the f32 row pass runs wide
#: outputs in column groups of up to 128 (:func:`row_plan`), the bf16 one
#: sweeps them in chunks of 64 columns, so the CDE wrapper's wide last
#: layers (H * E * 2: 512 for the trade configs, 1024 for england) are
#: served.
MAX_IN = 64
MAX_OUT = 4096

Planes = tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
LayerParams = tp.Dict[str, torch.Tensor]

_LAYER_KEYS = ("norm_w", "norm_b", "W", "lin_b", "basis")
#: Basis 2-vectors of the undirected and the directed basis
#: (csrc/megakernel_common.cuh NBASIS_U, NBASIS_D).
NBASIS_UNDIRECTED = 8
NBASIS_DIRECTED = 11
#: Rows of the kernels' (B, NSTAT, n) statistics buffer
#: (csrc/megakernel_common.cuh NSTAT).
NSTAT = 9


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
    """A(tau) and dA(tau) per element from the interval planes, in f32
    (bf16 planes are read as stored and upcast, as the kernels read them)."""
    A, dA, _ = hermite3(planes, idx, tau, need_dd=False)
    return A, dA


def hermite3(planes: Planes, idx, tau, need_dd: bool = True):
    """A(tau), dA(tau) and, with ``need_dd``, d(dA)/dtau per element, in f32,
    each product and sum rounded once (no contraction: the bf16 kernels
    evaluate the same way, so their bf16 operands round identically)."""
    d, c, b, a = (p.to(torch.float32) for p in select_planes(planes, idx))
    t = tau[:, None, None]
    A = ((d * t + c) * t + b) * t + a
    dA = (3.0 * d * t + 2.0 * c) * t + b
    ddA = 6.0 * d * t + 2.0 * c if need_dd else None
    return A, dA, ddA


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
        dense = (fusion_matrix_dense_directed if basis.shape[1] == NBASIS_DIRECTED
                 else fusion_matrix_dense)
        fused = dense(A, dA, params)
        feats = m + fused @ m
        if l < len(layers) - 1:
            feats = torch.relu(feats)
    return feats


def plain_vf_eval(planes: Planes, idx, tau, Z, layers):
    """Plain PyTorch version of K1."""
    A, dA = hermite(planes, idx, tau)
    return plain_layer_stack(A, dA, Z, layers)


# ---------------------------------------------------------------------------
# fusion_precision bf16 (K1bf): JAX's rounding points, _make_vf_body(bf16=True)
# ---------------------------------------------------------------------------


def rbf(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 (to nearest even) and held in float32.

    A product of two such values is exact in f32, so a product of rounded
    operands summed in f32 is JAX's ``preferred_element_type=f32`` dot (torch's
    CPU ``matmul`` on bf16 tensors would round its result to bf16)."""
    return x.to(torch.bfloat16).to(torch.float32)


class Bf16Stats(tp.NamedTuple):
    """What every layer of a bf16 eval shares, per element: the bf16-rounded
    A(t), dA(t) held in f32 ``(B, n, n)``; the f32 row sums, diagonals
    ``(B, n, 1)`` and totals ``(B, 1, 1)`` of the unrounded planes; and the
    column sums of the rounded ones (the directed basis; JAX takes them as
    row sums of its bf16 transposes)."""

    Ah: torch.Tensor
    dAh: torch.Tensor
    rA: torch.Tensor
    rdA: torch.Tensor
    sA: torch.Tensor
    sdA: torch.Tensor
    dgA: torch.Tensor
    dgdA: torch.Tensor
    cA: torch.Tensor
    cdA: torch.Tensor


def bf16_stats(A: torch.Tensor, dA: torch.Tensor) -> Bf16Stats:
    Ah, dAh = rbf(A), rbf(dA)
    rA, rdA = A.sum(-1, keepdim=True), dA.sum(-1, keepdim=True)
    diag = lambda x: torch.diagonal(x, dim1=-2, dim2=-1)[..., None]  # noqa: E731
    return Bf16Stats(Ah, dAh, rA, rdA, rA.sum(-2, keepdim=True), rdA.sum(-2, keepdim=True),
                     diag(A), diag(dA), Ah.sum(-2)[..., None], dAh.sum(-2)[..., None])


def bf16_rank_vectors(st: Bf16Stats, p: torch.Tensor, n: int):
    """``(dvec, u, v, c7)`` of one layer's ``(8, 2)`` or ``(11, 2)`` basis
    ``p`` from the stats (``ops/tiled.py`` ``rank_terms``: the residual
    identity folded into dvec; the directed basis's quirks), as
    ``(B, n, 1)`` vectors and a ``(B, 1, 1)`` c7."""
    from .tiled import rank_terms

    col = lambda x: x[..., 0]  # noqa: E731
    dvec, u, v, c7 = rank_terms(p, n, col(st.rA), col(st.rdA), col(st.dgA), col(st.dgdA),
                                st.sA.flatten(), st.sdA.flatten(), col(st.cA), col(st.cdA))
    return dvec[..., None], u[..., None], v[..., None], c7[:, None, None]


def bf16_coeffs(p: torch.Tensor) -> torch.Tensor:
    """``(1 + p1_0, 1 + p1_1, p2_0, p2_1)`` rounded to bf16: the coefficients
    of the row operand B1 and the column operand B2^T."""
    return rbf(torch.stack([1.0 + p[0, 0], 1.0 + p[0, 1], p[1, 0], p[1, 1]]))


def transform(feats: torch.Tensor, lp: LayerParams):
    """RMSNorm then Linear of one layer: ``(M, zn, inv_rms)``."""
    inv = torch.rsqrt((feats * feats).mean(-1, keepdim=True) + 1e-6)
    zn = feats * inv * lp["norm_w"] + lp["norm_b"]
    return zn @ lp["W"].transpose(-2, -1) + lp["lin_b"], zn, inv


def bf16_layer(st: Bf16Stats, M: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """One layer's fused apply in bf16 precision (before the ReLU).

    ``B1 = b1_0 Ah + b1_1 dAh`` and ``B2^T = b2_0 Ah^T + b2_1 dAh^T`` are
    formed in bf16 (each product and the sum rounded), separately: their sum
    would round again. ``Mh`` is M rounded; the two products are exact
    products of bf16 values summed in f32. The rank terms are f32 on the
    unrounded M."""
    n = M.shape[-2]
    c = bf16_coeffs(p)
    B1 = rbf(rbf(c[0] * st.Ah) + rbf(c[1] * st.dAh))
    B2t = rbf(rbf(c[2] * st.Ah.transpose(-2, -1)) + rbf(c[3] * st.dAh.transpose(-2, -1)))
    Mh = rbf(M)
    rowpart, colpart = B1 @ Mh, B2t @ Mh
    dvec, u, v, c7 = bf16_rank_vectors(st, p, n)
    s = M.sum(-2, keepdim=True)
    w = (v * M).sum(-2, keepdim=True)
    return rowpart + colpart + dvec * M + u * s + (w + c7 * s)


def plain_vf_eval_bf16(planes: Planes, idx, tau, Z, layers, given_M=None, trace=None):
    """Plain PyTorch version of K1bf (either basis). :class:`MegakernelVF`
    takes its gradients from K2bf, and from autograd of this version (each
    bf16 rounding passing its cotangent through) only where a plane needs
    one.

    Layer by layer: with ``given_M`` (a kernel's per-layer M, read back
    through :func:`megakernel_vf_eval`'s ``trace``) each layer applies the
    given M, and its own M is the transform of the previous layer's output
    computed from the given one. Then both sides round the same M to bf16
    and only one layer's f32 sums separate them. ``trace`` (a dict)
    receives the per-layer M this version computed, under ``"M"``."""
    A, dA = hermite(planes, idx, tau)
    st = bf16_stats(A, dA)
    feats, Ms = Z, []
    for l, lp in enumerate(layers):
        Ms.append(transform(feats, lp)[0])
        feats = bf16_layer(st, Ms[l] if given_M is None else given_M[l], lp["basis"])
        if l < len(layers) - 1:
            feats = torch.relu(feats)
    if trace is not None:
        trace["M"] = Ms
    return feats


def basis_size(layers) -> int:
    """The stack's number of basis 2-vectors, 8 (undirected) or 11
    (directed); raises on another shape or on a stack that mixes the two."""
    shapes = {tuple(lp["basis"].shape) for lp in layers}
    if len(shapes) != 1 or next(iter(shapes)) not in ((NBASIS_UNDIRECTED, 2),
                                                      (NBASIS_DIRECTED, 2)):
        raise ValueError(f"the kernels take a (8, 2) or (11, 2) basis, one size for the "
                         f"whole stack; got {sorted(shapes)}")
    return next(iter(shapes))[0]


def _check_inputs(planes: Planes, idx, tau, Z, layers, extra=(), bf16: bool = False):
    """Raises on what the kernels do not take; returns the basis size. The
    f32 kernels take float32 planes, the bf16 kernels bfloat16 ones."""
    dev = Z.device
    B, n, _ = Z.shape
    shape = planes[0].shape
    dtype = torch.bfloat16 if bf16 else torch.float32
    for p in planes:
        if p.shape != shape or p.dtype != dtype or p.device != dev:
            raise ValueError(f"planes must be four {dtype} tensors of one shape "
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
        hin = hout
    return basis_size(layers)


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


#: The row pass (``csrc/megakernel_common.cuh`` ``rows_body``): rows of M
#: per ring tile (``RKT``) and ring stages (``RSTAGES``).
ROW_KT = 32
ROW_STAGES = 3


class RowPlan(tp.NamedTuple):
    """One layer's launch plan of the row pass: ``bm`` rows per CTA, ``cc``
    output columns per thread (f32; the bf16 pass's products are warps'
    tensor-core blocks, and cc only sets its width), ``cw = 512 cc / bm``
    columns per CTA, ``groups`` CTAs across the output's width; the grid's
    CTAs and each CTA's dynamic shared memory."""

    bm: int
    cc: int
    cw: int
    groups: int
    ctas: int
    smem_bytes: int


#: Rows of the next layer's W per chunk the row pass stages (``RWCH``).
ROW_WCH = 128


def row_smem_bytes(n: int, bm: int, cw: int, H: int, bf16: bool = False) -> int:
    """Dynamic shared memory of one row-pass CTA (``rows_smem_bytes``): v;
    its rows of C over n rounded up to the ring tile and the ring (rows of
    ``cw`` columns, or of H rounded up to 4 where one group holds the
    layer), or, where they need more, the next layer's W chunks
    (``ROW_WCH`` rows of H + 1; only a layer at most ``MAX_IN`` wide feeds
    another). With ``bf16`` (``rows_smem_bytes_bf``) the rows of B1 and of
    B2^T in bf16 (npad + 8 halves, at least 8 rows each) take C's place,
    and one ring tile rounded to bf16 (the ring's width rounded up to 16,
    plus 8 halves) follows the ring. A card test holds it to the library's
    own count (``gncde_row_smem_bytes``)."""
    npad = -(-n // ROW_KT) * ROW_KT
    rs = min(cw, -(-H // 4) * 4)
    wchunk = ROW_WCH * (H + 1) if H <= MAX_IN else 0
    if bf16:
        rows, hw = max(bm, 8), -(-rs // 16) * 16
        return 4 * npad + max(4 * rows * (npad + 8) + 4 * ROW_STAGES * ROW_KT * rs
                              + 2 * ROW_KT * (hw + 8), 4 * wchunk)
    return 4 * (npad + max(bm * (npad + 4) + ROW_STAGES * ROW_KT * rs, wchunk))


#: The CTA heights :func:`row_plan` tries, tallest first (a tool or test
#: that times or checks one height sets this to it).
ROW_BMS = (16, 8, 4)


def row_plan(n: int, B: int, H: int, bms=None, bf16: bool = False) -> RowPlan:
    """The row pass's plan for an ``H``-wide layer at ``n`` nodes and batch
    ``B``: the tallest CTA (``bm`` of ``bms``, by default :data:`ROW_BMS`:
    16, 8, then 4 rows) whose grid still runs at least ``_build.SMS`` CTAs
    (else the last); per
    ``bm``, the fewest columns per thread whose CTA holds the whole layer
    (``cw`` up to 128; wider layers take ``ceil(H / 128)`` groups). Every
    plan gives the same bits: only the work's partition changes. ``bf16``:
    the bf16 pass's plan, the same CTAs with its own shared memory."""
    for bm in ROW_BMS if bms is None else bms:
        ccs = [cc for cc in (1, 2, 4) if 32 <= 512 * cc // bm <= 128]
        cc = next((c for c in ccs if 512 * c // bm >= H), ccs[-1])
        cw = 512 * cc // bm
        groups = -(-H // cw)
        ctas = -(-n // bm) * groups * B
        if ctas >= _build.SMS:
            break
    return RowPlan(bm, cc, cw, groups, ctas, row_smem_bytes(n, bm, cw, H, bf16))


def row_plans(n: int, B: int, widths, bms=None, bf16: bool = False) -> tp.List[RowPlan]:
    """:func:`row_plan` of every layer of a stack of ``widths`` (input, then
    each layer's output)."""
    return [row_plan(n, B, h, bms, bf16) for h in widths[1:]]


@functools.lru_cache(maxsize=256)
def _plan_array(n: int, B: int, widths: tp.Tuple[int, ...], bms: tp.Tuple[int, ...]):
    flat = [x for p in row_plans(n, B, widths, bms) for x in (p.bm, p.cc, p.groups)]
    return (ctypes.c_int * len(flat))(*flat)


def plan_array(n: int, B: int, layers, bms=None):
    """The row plans of ``layers`` (CTA heights ``bms``, by default
    :data:`ROW_BMS`) as the C entry points take them: a host array of (bm,
    cc, groups) per layer, built once per shape, stack of widths and heights
    (the C side only reads it). The f32 and the bf16 pass take the same
    array."""
    widths = (layers[0]["W"].shape[1],) + tuple(lp["W"].shape[0] for lp in layers)
    return _plan_array(n, B, widths, tuple(ROW_BMS if bms is None else bms))


_FWD_ARGTYPES = [
    _build.P, _build.P, _build.P, _build.P, _build.L,  # planes, stride
    _build.P, _build.P, _build.P,  # idx, tau, Z
    _build.I, _build.I, _build.I,  # B, n, L
    _build.P, _build.P, _build.P,  # dims, ptrs, row plans (host arrays)
    _build.I, _build.I,  # directed, bf16
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


def _launch_fwd(planes: Planes, idx, tau, Z, layers, bf16: bool, trace=None):
    nbasis = _check_inputs(planes, idx, tau, Z, layers, bf16=bf16)
    fn = _fwd_lib()
    B, n, _ = Z.shape
    Z = Z.detach().contiguous()
    bstride, idx32, tau32, dims, ptrs, keep = launch_args(planes, idx, tau, layers)
    stats = torch.empty((B, NSTAT, n), device=Z.device, dtype=torch.float32)
    ldm = scratch_width(layers)
    mbuf = torch.empty((len(layers), B, n, ldm), device=Z.device, dtype=torch.float32)
    out = torch.empty((B, n, layers[-1]["W"].shape[0]), device=Z.device,
                      dtype=torch.float32)
    err = fn(
        *[_build.ptr(p) for p in planes], bstride,
        _build.ptr(idx32), _build.ptr(tau32), _build.ptr(Z),
        B, n, len(layers), ctypes.cast(dims, _build.P),
        ctypes.cast(ptrs, _build.P),
        ctypes.cast(plan_array(n, B, layers), _build.P),
        int(nbasis == NBASIS_DIRECTED), int(bool(bf16)),
        _build.ptr(stats), _build.ptr(mbuf), ldm, _build.ptr(out),
        _build.stream(),
    )
    _build.check(err, "K1bf megakernel_fwd" if bf16 else "K1 megakernel_fwd")
    (megakernel_vf_eval.bf16 if bf16 else megakernel_vf_eval).launches += 1
    del keep
    if trace is not None:
        trace["M"] = [mbuf[l, :, :, :lp["W"].shape[0]] for l, lp in enumerate(layers)]
    return out


def megakernel_vf_eval(planes: Planes, idx, tau, Z, layers, bf16: bool = False,
                       trace=None):
    """K1 (with ``bf16``, K1bf on bf16 planes): ``(B, n, Hout)`` vf output;
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors. Not
    differentiable by itself (see :class:`MegakernelVF`). ``trace`` (a dict)
    receives each layer's M under ``"M"``: the kernel's, read back from its
    scratch, or (CPU, bf16) the plain version's."""
    if Z.is_cuda:
        return _launch_fwd(planes, idx, tau, Z, layers, bf16, trace)
    if bf16:
        return plain_vf_eval_bf16(planes, idx, tau, Z, layers, trace=trace)
    return plain_vf_eval(planes, idx, tau, Z, layers)


#: Launches of the f32 kernel; ``.bf16.launches`` those of K1bf.
megakernel_vf_eval.launches = 0
megakernel_vf_eval.bf16 = types.SimpleNamespace(launches=0)


class MegakernelVF(torch.autograd.Function):
    """Differentiable vf eval: forward K1, backward K2 (with ``bf16``, K1bf
    and K2bf).

    Inputs: ``(nbasis, bf16, idx, tau, Z, d, c, b, a, *flat)`` where ``flat``
    holds, per layer, ``norm_w, norm_b, W, lin_b`` and the ``nbasis`` (8 or
    11) basis 2-vectors.
    """

    @staticmethod
    def forward(ctx, nbasis, bf16, idx, tau, Z, d, c, b, a, *flat):
        layers = _unflatten(flat, nbasis)
        planes = (d, c, b, a)
        with torch.no_grad():
            out = megakernel_vf_eval(planes, idx, tau, Z, layers, bf16)
        ctx.nbasis, ctx.bf16 = nbasis, bf16
        ctx.save_for_backward(idx, tau, Z, d, c, b, a, *flat)
        return out

    @staticmethod
    def backward(ctx, g):
        from .megakernel_bwd import megakernel_vf_bwd

        idx, tau, Z, d, c, b, a, *flat = ctx.saved_tensors
        if any(ctx.needs_input_grad[5:9]):
            # A plane needs a cotangent, which K2 does not form. This is the
            # JAX package's own semantics for the case, not a fallback:
            # ``_mk_bwd`` takes ``jax.vjp`` of ``_xla_reference`` for every
            # cotangent when the planes are perturbed. Here every cotangent
            # comes from autograd of the plain version at the saved inputs.
            plain, nbasis = (plain_vf_eval_bf16 if ctx.bf16 else plain_vf_eval), ctx.nbasis

            def f(tau, Z, d, c, b, a, *flat):
                return plain((d, c, b, a), idx, tau, Z, _unflatten(flat, nbasis))

            grads = plain_vjp(f, (tau, Z, d, c, b, a, *flat), ctx.needs_input_grad[3:], (g,))
            return (None, None, None, *grads)
        layers = _unflatten(flat, ctx.nbasis)
        need_tau = ctx.needs_input_grad[3]
        dtau, dZ, per_layer = megakernel_vf_bwd(
            (d, c, b, a), idx, tau, Z, layers, g.contiguous(), need_tau=need_tau,
            bf16=ctx.bf16,
        )
        return (None, None, None, dtau if need_tau else None, dZ, None, None, None, None,
                *flat_grads(per_layer))


def plain_vjp(fn, inputs, needs, cotangents):
    """The cotangents of ``fn(*inputs)`` (a plain version, one output or a
    tuple) for ``cotangents``, by autograd at the given inputs: one entry per
    input, None where its ``needs`` flag is off."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(bool(need)) for x, need in zip(inputs, needs)]
        out = fn(*leaves)
        outs = out if isinstance(out, tuple) else (out,)
        wrt = [x for x, need in zip(leaves, needs) if need]
        grads = iter(torch.autograd.grad(outs, wrt, cotangents, allow_unused=True))
    return [next(grads) if need else None for need in needs]


def flat_grads(per_layer) -> tp.List[torch.Tensor]:
    """K2's per-element, per-layer parameter cotangents summed over the
    batch, in the order of :func:`flatten_params`."""
    grads = []
    for dnw, dnb, dW, dlb, dbasis in per_layer:
        grads += [dnw.sum(0), dnb.sum(0), dW.sum(0), dlb.sum(0)]
        db = dbasis.sum(0)
        grads += [db[k] for k in range(db.shape[0])]
    return grads


def field_basis_size(vf) -> int:
    """8 for an undirected field's layers, 11 for a directed one's."""
    return len(vf.gnn_layers[0].params)


def flatten_params(vf) -> tp.List[torch.Tensor]:
    flat = []
    for layer in vf.gnn_layers:
        conv = layer.conv_layer
        flat += [conv.norm.weight, conv.norm.bias, conv.linear.weight,
                 conv.linear.bias, *layer.params]
    return flat


def _unflatten(flat, nbasis: int = NBASIS_UNDIRECTED) -> tp.List[LayerParams]:
    """Inverse of :func:`flatten_params` for a stack of ``nbasis`` basis
    2-vectors per layer."""
    per_layer = 4 + nbasis  # norm_w, norm_b, W, lin_b + the basis vectors
    layers = []
    for i in range(0, len(flat), per_layer):
        nw, nb, W, lb, *basis = flat[i:i + per_layer]
        layers.append(dict(norm_w=nw, norm_b=nb, W=W, lin_b=lb,
                           basis=torch.stack(basis)))
    return layers


def layer_params(vf) -> tp.List[LayerParams]:
    """Per-layer parameters of a perm-equiv field, basis as (8, 2) or, for
    the directed field, (11, 2)."""
    return _unflatten(flatten_params(vf), field_basis_size(vf))


def megakernel_vf(planes: Planes, ts, t, Z, vf, bf16: bool = False):
    """The field's fast path: interval lookup, then :class:`MegakernelVF`."""
    if ts.dim() == 1:
        ts = ts.unsqueeze(0).expand(Z.shape[0], -1)
    idx, tau = interval(ts, t)
    return MegakernelVF.apply(field_basis_size(vf), bf16, idx, tau, Z, *planes,
                              *flatten_params(vf))
