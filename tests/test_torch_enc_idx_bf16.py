"""The enc_idx route under ``fusion_precision: bf16`` against the JAX
package's bf16 route, on the CPU and on both bases: the plain versions of
K7bf (``modulate_pair(out_dtype=bf16)``), K6a-bf and K6b-bf (``_pair_call``
and ``_pair_dw_call`` on bf16 planes) against the Pallas kernels in
interpret mode, the plane-pair autograd Function's cotangents, and the
whole enc_idx field with its parameter gradients.

The JAX side is compiled with ``xla_allow_excess_precision`` off. With it
on (XLA's default), the CPU backend drops the bf16 rounding of an
intermediate that feeds a dot: in ``_pair_kernel`` it multiplies
``bf16(c0 A) + bf16(c1 dA)`` unrounded, while the kernel's dtypes, the
stored B1 and the TPU kernel round the sum (2.3e-3 of max|ref| apart on a
pair sweep). With it off, every bf16 op of the reference rounds as its
dtype says, which is what the port and its kernels compute.

Bounds, each against the largest magnitude of the reference array:
* K7bf: one bf16 ulp per element (the f32 chain's last bits may differ, and
  rounding then moves an element a whole ulp);
* K6a-bf, K6b-bf: 1e-5 (the same bf16 operands; only the order of the f32
  sums differs); the plane-pair cotangents 1e-4 as in f32, the bf16 plane
  cotangents one bf16 ulp per element;
* the field 2e-4 and every gradient leaf 5e-3: the f32 route is 1.1e-3 to
  1.5e-3 (field) and up to 4e-2 (gradients) away from the bf16 one, so the
  bounds tell the precisions apart. The planted faults -- the port in f32,
  or B1/B2 rounded once instead of at every op -- exceed them.
"""

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from gncde_tpu import ops as jops
from gncde_tpu.interp import CubicInterpolation as JCubic
from gncde_tpu.interp import MatrixControl as JMatrixControl
from gncde_tpu.interp import backward_hermite_coefficients as j_bhc
from gncde_tpu.models.vector_fields import PermEquivDirGraphVectorField as JDVF
from gncde_tpu.models.vector_fields import PermEquivGraphVectorField as JVF
from gncde_tpu.nn import MLP as JMLP
from gncde_tpu.ops.pallas import modulate as jmod
from gncde_tpu.ops.pallas import tiled as jt
from gncde_tpu_torch import ops
from gncde_tpu_torch.interp import CubicInterpolation, MatrixControl
from gncde_tpu_torch.models.vector_fields import PermEquivDirGraphVectorField as TDVF
from gncde_tpu_torch.models.vector_fields import PermEquivGraphVectorField as TVF
from gncde_tpu_torch.nn import MLP
from gncde_tpu_torch.ops import modulate as tmod
from gncde_tpu_torch.ops import pair as tp

from torch_parity_utils import copy_jax_to_torch, hermite_path, jax_leaves

BF16 = torch.bfloat16
FIELD_TOL = 2e-4
GRAD_TOL = 5e-3


def _jcompile(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` with every bf16 op rounded."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _rel(got, ref):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1e-30)


def _bf16_ulps(got, ref):
    """Largest distance in bf16 ulps (of the reference element) of two bf16
    arrays."""
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    return float((np.abs(got - ref) / ulp).max())


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _record(monkeypatch, calls, *targets):
    """Wrap each ``(module, name)`` so that its calls append ``(name, the
    first argument's dtype, the result)`` to ``calls``."""
    for mod, name in targets:
        def wrapped(*a, _name=name, _f=getattr(mod, name)):
            out = _f(*a)
            calls.append((_name, a[0].dtype, out))
            return out

        monkeypatch.setattr(mod, name, wrapped)


@pytest.fixture
def precision():
    """Restores both packages' knobs."""
    yield
    jops.set_fusion_precision("f32")
    jops.set_fusion_backend("auto")
    ops.set_fusion_precision("f32")
    ops.set_fusion_backend("auto")


# ---------------------------------------------------------------------------
# K7bf, K6a-bf, K6b-bf
# ---------------------------------------------------------------------------


def test_plain_modulate_pair_bf16_matches_pallas():
    """K7bf's plain version (through the wrapper on CPU tensors) against
    the Pallas kernel in interpret mode with ``out_dtype=bf16``, ragged (n
    = 20, tile 8): bf16 planes within one bf16 ulp, the padding zero."""
    n, d, B, tile = 20, 5, 2, 8
    rng = np.random.default_rng(21)
    A = rng.uniform(-0.2, 1.0, (B, n, n)).astype(np.float32)
    dA = rng.normal(0.0, 0.5, (B, n, n)).astype(np.float32)
    emb = rng.normal(size=(n, d)).astype(np.float32)
    k1, k2 = jr.split(jr.PRNGKey(22))
    mj = [JMLP(in_size=2 * d + 1, out_size=1, width_size=8, depth=2, key=k) for k in (k1, k2)]
    mt = [MLP(2 * d + 1, 1, 8, 2, generator=torch.Generator().manual_seed(0))
          for _ in range(2)]
    for a, b in zip(mj, mt):
        copy_jax_to_torch(a, b)
    with torch.no_grad():
        got = tmod.modulate_pair(torch.tensor(A), torch.tensor(dA), *mt, torch.tensor(emb),
                                 BF16)
    assert all(g.dtype == BF16 for g in got)
    f = _jcompile(lambda a, da, e: jmod.modulate_pair(a, da, *mj, e, tile=tile,
                                                      out_dtype=jnp.bfloat16),
                  jnp.asarray(A[0]), jnp.asarray(dA[0]), jnp.asarray(emb))
    flips = 0
    for b in range(B):
        ref = f(jnp.asarray(A[b]), jnp.asarray(dA[b]), jnp.asarray(emb))
        for g, r in zip(got, ref):
            assert r.dtype == jnp.bfloat16 and r.shape == (24, 24)
            r = _np(r)
            assert _bf16_ulps(g[b], r[:n, :n]) <= 1.0
            flips += int((g[b].float().numpy() != r[:n, :n]).sum())
            assert not r[n:].any() and not r[:, n:].any()
    assert flips <= 2 * B * n * n // 100  # rare: an f32 last-bit difference at a tie


PAIR_SHAPES = [(24, 24), (20, 13)]
PAIR_IDS = ["square-n24", "rect-20x13"]


def _pair_inputs(nr, nc, H, B, tile, seed=23):
    """bf16 planes (B, nr, nc) (as f32 arrays of bf16 values), f32 vectors,
    and the JAX vectors zero-padded to the tile."""
    rng = np.random.default_rng(seed)

    def bf(x):
        return np.asarray(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
                          .astype(jnp.float32))

    A = bf(rng.normal(0.1, 0.3, (B, nr, nc)))
    dA = bf(rng.normal(0.0, 0.5, (B, nr, nc)))
    vec = {k: rng.normal(size=(B, nc if k in ("Mk", "Gc") else nr, H)).astype(np.float32)
           for k in ("Mk", "Mi", "Gr", "Gc")}
    cvec = np.array([1.03, 0.071, -0.044, 0.052], np.float32)
    NPr, NPc = jt._cdiv(nr, tile) * tile, jt._cdiv(nc, tile) * tile

    def pad(x, rows, dtype):
        return jnp.zeros((rows, H), dtype).at[:x.shape[0]].set(jnp.asarray(x).astype(dtype))

    return dict(A=A, dA=dA, cvec=cvec, **vec,
                pad_c=lambda x, dt=jnp.float32: pad(x, NPc, dt),
                pad_r=lambda x, dt=jnp.float32: pad(x, NPr, dt))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_pair_dw_matches_pallas_beyond_128_columns(dtype):
    """K6b's plain version (through the wrapper on CPU tensors) against
    ``_pair_dw_call`` in interpret mode on a ragged rectangular shape (20 x
    13, tile 8) with H = 130, over the 128 columns a K6b ring stage
    never held at once and the width whose chunks the card's plan splits:
    f32 planes and vectors within 1e-5, bf16 ones within 1e-5 (the same bf16
    operands; only the order of the f32 sums differs)."""
    nr, nc, H, B, tile = 20, 13, 130, 2, 8
    x = _pair_inputs(nr, nc, H, B, tile, seed=31)
    jdt, tdt = (jnp.bfloat16, BF16) if dtype == "bf16" else (jnp.float32, torch.float32)
    keys = ("Gr", "Mk", "Mi", "Gc")
    pads = {"Gr": x["pad_r"], "Mk": x["pad_c"], "Mi": x["pad_r"], "Gc": x["pad_c"]}
    got = tp.pair_dw_call(*(torch.tensor(x[k]).to(tdt) for k in ("A", "dA") + keys))
    f = _jcompile(lambda a, da, gr, mk, mi, gc: jt._pair_dw_call(
        a, da, gr, mk, mi, gc, nr=nr, nc=nc, tile=tile, interpret=True),
        *[jnp.zeros((nr, nc), jdt)] * 2, *(pads[k](x[k][0], jdt) for k in keys))
    for b in range(B):
        dw = f(*(jnp.asarray(x[k][b]).astype(jdt) for k in ("A", "dA")),
               *(pads[k](x[k][b], jdt) for k in keys))
        assert _rel(got[b], _np(dw)[0]) <= 1e-5


@pytest.mark.parametrize("nr,nc", PAIR_SHAPES, ids=PAIR_IDS)
@pytest.mark.parametrize("kernel", ["K6a-bf-f32-vectors", "K6a-bf-bf16-vectors", "K6b-bf"])
def test_plain_pair_bf16_matches_pallas(kernel, nr, nc):
    """K6a-bf (f32 vectors: the forward; bf16 vectors: the backward) and
    K6b-bf (bf16 vectors) through the wrappers on CPU tensors against
    ``_pair_call`` and ``_pair_dw_call`` on bf16 planes in interpret mode."""
    H, B, tile = 5, 2, 8
    x = _pair_inputs(nr, nc, H, B, tile)
    vdt = jnp.float32 if kernel == "K6a-bf-f32-vectors" else jnp.bfloat16
    tv = torch.float32 if vdt == jnp.float32 else BF16
    A, dA = (torch.tensor(x[k]).to(BF16) for k in ("A", "dA"))
    V = {k: torch.tensor(x[k]).to(tv) for k in ("Mk", "Mi", "Gr", "Gc")}
    kw = dict(nr=nr, nc=nc, tile=tile, interpret=True)
    if kernel.startswith("K6a"):
        got = tp.pair_call(A, dA, torch.tensor(x["cvec"]), V["Mk"], V["Mi"])
        f = _jcompile(lambda a, da, c, mk, mi: jt._pair_call(a, da, c, mk, mi, **kw),
                      *[jnp.zeros((nr, nc), jnp.bfloat16)] * 2,
                      jnp.asarray(x["cvec"]).reshape(1, 4), x["pad_c"](x["Mk"][0], vdt),
                      x["pad_r"](x["Mi"][0], vdt))
    else:
        got = (tp.pair_dw_call(A, dA, V["Gr"], V["Mk"], V["Mi"], V["Gc"]),)
        f = _jcompile(lambda a, da, gr, mk, mi, gc: jt._pair_dw_call(a, da, gr, mk, mi, gc,
                                                                    **kw),
                      *[jnp.zeros((nr, nc), jnp.bfloat16)] * 2,
                      *(pad(x[k][0], vdt) for k, pad in (("Gr", x["pad_r"]),
                                                        ("Mk", x["pad_c"]),
                                                        ("Mi", x["pad_r"]),
                                                        ("Gc", x["pad_c"]))))
    for b in range(B):
        Ab, dAb = (jnp.asarray(x[k][b]).astype(jnp.bfloat16) for k in ("A", "dA"))
        if kernel.startswith("K6a"):
            row, col = f(Ab, dAb, jnp.asarray(x["cvec"]).reshape(1, 4),
                         x["pad_c"](x["Mk"][b], vdt), x["pad_r"](x["Mi"][b], vdt))
            assert _rel(got[0][b], _np(row)[:nr]) <= 1e-5
            assert _rel(got[1][b], _np(col)[:nc]) <= 1e-5
        else:
            dw = f(Ab, dAb, x["pad_r"](x["Gr"][b], vdt), x["pad_c"](x["Mk"][b], vdt),
                   x["pad_r"](x["Mi"][b], vdt), x["pad_c"](x["Gc"][b], vdt))
            assert _rel(got[0][b], _np(dw)[0]) <= 1e-5


@pytest.mark.parametrize("nr,nc", PAIR_SHAPES, ids=PAIR_IDS)
def test_plane_pair_apply_bf16_cotangents_match_jax(nr, nc, monkeypatch):
    """PlanePairApply on bf16 planes and f32 vectors against jax.vjp of
    plane_pair_apply: the backward runs K6a-bf on bf16 cotangents and
    K6b-bf on bf16 operands (``mm_dtype``), and returns bf16 plane
    cotangents (f32 rank-H products cast)."""
    H, B, tile = 5, 2, 8
    x = _pair_inputs(nr, nc, H, B, tile, seed=24)
    c_row = np.array([1.1, -0.06], np.float32)
    c_col = np.array([0.05, 0.08], np.float32)

    def vjp(A, dA, cr, cc, Mk, Mi, Gr, Gc):
        _, f = jax.vjp(lambda *a: jt.plane_pair_apply(*a, nr, nc, tile), A, dA, cr, cc, Mk, Mi)
        return f((Gr, Gc))

    zplane = jnp.zeros((nr, nc), jnp.bfloat16)
    args0 = (zplane, zplane, jnp.asarray(c_row), jnp.asarray(c_col),
             x["pad_c"](x["Mk"][0]), x["pad_r"](x["Mi"][0]), x["pad_r"](x["Gr"][0]),
             x["pad_c"](x["Gc"][0]))
    f = _jcompile(vjp, *args0)
    ref = {k: [] for k in ("A", "dA", "cr", "cc", "Mk", "Mi")}
    for b in range(B):
        cots = f(jnp.asarray(x["A"][b]).astype(jnp.bfloat16),
                 jnp.asarray(x["dA"][b]).astype(jnp.bfloat16), jnp.asarray(c_row),
                 jnp.asarray(c_col), x["pad_c"](x["Mk"][b]), x["pad_r"](x["Mi"][b]),
                 x["pad_r"](x["Gr"][b]), x["pad_c"](x["Gc"][b]))
        assert cots[0].dtype == jnp.bfloat16
        for k, v in zip(ref, cots):
            ref[k].append(_np(v))
    ins = [torch.tensor(x["A"]).to(BF16), torch.tensor(x["dA"]).to(BF16),
           torch.tensor(c_row), torch.tensor(c_col), torch.tensor(x["Mk"]),
           torch.tensor(x["Mi"])]
    for v in ins:
        v.requires_grad_(True)
    calls = []
    for name in ("plain_pair", "plain_pair_dw"):
        def wrapped(*a, _name=name, _f=getattr(tp, name)):
            calls.append((_name, a[0].dtype, a[3].dtype))
            return _f(*a)

        monkeypatch.setattr(tp, name, wrapped)
    row, col = tp.plane_pair_apply(*ins)
    torch.autograd.backward((row, col), (torch.tensor(x["Gr"]), torch.tensor(x["Gc"])))
    # K6a-bf forward on f32 vectors, K6a-bf backward on bf16 cotangents,
    # K6b-bf on bf16 operands.
    assert calls == [("plain_pair", BF16, torch.float32), ("plain_pair", BF16, BF16),
                     ("plain_pair_dw", BF16, BF16)]
    assert ins[0].grad.dtype == BF16 and ins[1].grad.dtype == BF16
    assert _bf16_ulps(ins[0].grad, np.stack(ref["A"])) <= 1.0
    assert _bf16_ulps(ins[1].grad, np.stack(ref["dA"])) <= 1.0
    assert _rel(ins[2].grad, np.sum(ref["cr"], 0)) <= 1e-4
    assert _rel(ins[3].grad, np.sum(ref["cc"], 0)) <= 1e-4
    assert _rel(ins[4].grad, np.stack(ref["Mk"])[:, :nc]) <= 1e-4
    assert _rel(ins[5].grad, np.stack(ref["Mi"])[:, :nr]) <= 1e-4


# ---------------------------------------------------------------------------
# The enc_idx field under bf16, both bases
# ---------------------------------------------------------------------------

N, H, L, B, T, D = 24, 8, 2, 2, 5, 16
BASES = {"undirected": (JVF, TVF), "directed": (JDVF, TDVF)}


def _field_case(basis):
    """Inputs (bf16 Hermite stacks, knots, t, Z, W) and the JAX and port
    fields with copied weights (emb encoder, idx_dim 16)."""
    rng = np.random.default_rng(25)
    ts, A = hermite_path(rng, B, T, N)
    A = A + np.triu(rng.uniform(0.0, 0.2, A.shape)).astype(np.float32)  # asymmetric
    t = (ts[:, 1] + np.array([0.03, 0.11])).astype(np.float32)
    Z = rng.normal(size=(B, N, H)).astype(np.float32)
    W = rng.normal(size=(B, N, H)).astype(np.float32)
    coeffs = tuple(c.astype(jnp.bfloat16)
                   for c in jax.vmap(j_bhc)(jnp.asarray(ts), jnp.asarray(A)))
    jc, tc = BASES[basis]
    kw = dict(input_dim=H, hidden_dim=H, output_dim=H, num_layers=L, data_embed_dim=1,
              num_nodes=N, enc_idx=True, enc_type="emb", idx_dim=D)
    vf_j = jc(**kw, key=jr.PRNGKey(26))
    vf_t = tc(**kw, generator=torch.Generator().manual_seed(0))
    copy_jax_to_torch(vf_j, vf_t)
    return dict(ts=ts, t=t, Z=Z, W=W, coeffs=coeffs, vf_j=vf_j, vf_t=vf_t)


def _jax_field(case, precision):
    """The JAX field on its Pallas route (interpret mode) under
    ``precision``: value, dZ and the parameter gradients of sum(f * W)."""
    jops.set_fusion_backend("megakernel")
    jops.set_fusion_precision(precision)
    try:
        def loss(vf, Z_):
            out = jax.vmap(lambda ts_, c_, t_, z_: vf(t_, z_, JMatrixControl(JCubic(ts_, c_))))(
                jnp.asarray(case["ts"]), case["coeffs"], jnp.asarray(case["t"]), Z_)
            return jnp.sum(out * case["W"]), out

        f = _jcompile(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True),
                      case["vf_j"], jnp.asarray(case["Z"]))
        (_, out), (g_vf, g_z) = f(case["vf_j"], jnp.asarray(case["Z"]))
    finally:
        jops.set_fusion_precision("f32")
        jops.set_fusion_backend("auto")
    return np.asarray(out), np.asarray(g_z), jax_leaves(g_vf)


def _port_field(case, precision):
    ops.set_fusion_backend("megakernel")
    ops.set_fusion_precision(precision)
    try:
        vf = case["vf_t"]
        planes = tuple(torch.tensor(_np(c)).to(BF16) for c in case["coeffs"])
        ctrl = MatrixControl(CubicInterpolation(torch.tensor(case["ts"]), planes))
        vf.zero_grad(set_to_none=True)
        Z = torch.tensor(case["Z"]).requires_grad_(True)
        out = vf(torch.tensor(case["t"]), Z, ctrl)
        (out * torch.tensor(case["W"])).sum().backward()
        grads = {k: p.grad.clone() for k, p in vf.named_parameters()}
    finally:
        ops.set_fusion_precision("f32")
        ops.set_fusion_backend("auto")
    return out.detach(), Z.grad, grads


def _field_errs(port, ref):
    """(field rel err, {leaf: rel err} over dZ and every parameter)."""
    out, gz, grads = port
    r_out, r_gz, r_leaves = ref
    errs = {"Z": _rel(gz, r_gz)}
    errs.update({k: _rel(g, r_leaves[k.replace(".", "/")]) for k, g in grads.items()})
    return _rel(out, r_out), errs


@pytest.fixture(scope="module", params=list(BASES))
def field_case(request):
    case = _field_case(request.param)
    case["jax_bf16"] = _jax_field(case, "bf16")
    return case


def test_bf16_enc_idx_field_matches_jax_bf16_route(field_case, precision, monkeypatch):
    """The port's enc_idx field on the kernel route under bf16 (K7bf, then
    K6a-bf per layer forward, K6a-bf + K6b-bf per layer backward: their
    plain versions on the CPU, on bf16 planes) against the JAX bf16 route:
    the field within 2e-4, dZ and every parameter gradient (layers,
    idx_enc, both MLPs) within 5e-3."""
    calls = []
    _record(monkeypatch, calls, (tmod, "plain_modulate_pair"), (tp, "plain_pair"),
            (tp, "plain_pair_dw"))
    port = _port_field(field_case, "bf16")
    assert sorted((k, dt) for k, dt, _ in calls) == sorted(
        [("plain_modulate_pair", torch.float32)] + [("plain_pair", BF16)] * 2 * L
        + [("plain_pair_dw", BF16)] * L)
    assert all(o.dtype == BF16 for o in calls[0][2])  # K7bf's output planes
    assert calls[1][2][0].dtype == torch.float32  # K6a-bf's f32 sums
    field_err, errs = _field_errs(port, field_case["jax_bf16"])
    assert field_err <= FIELD_TOL, field_err
    bad = {k: e for k, e in errs.items() if not e <= GRAD_TOL}
    assert not bad, bad
    assert {"idx_enc.module.weight", "msg_func_adj.layers.0.weight"} <= set(errs)


@pytest.mark.parametrize("fault", ["port-in-f32", "B1-rounded-once"])
def test_bf16_field_bound_catches_planted_faults(field_case, precision, monkeypatch, fault):
    """The same check fails for the port in f32 (K7 and K6 on f32 planes),
    and for K6a-bf's plain version forming B1 and B2 in f32 and rounding
    them once: the field exceeds its bound (measured 1.2e-3 to 2.8e-3)."""
    precision_ = "bf16"
    if fault == "port-in-f32":
        precision_ = "f32"
    else:
        def once(A, dA, cvec, Mk, Mi):
            c = cvec.to(BF16).float()
            B1 = (c[0] * A.float() + c[1] * dA.float()).to(BF16).float()
            B2 = (c[2] * A.float() + c[3] * dA.float()).to(BF16).float()
            return B1 @ Mk.float(), B2.transpose(-2, -1) @ Mi.float()

        monkeypatch.setattr(tp, "plain_pair", once)
    field_err, _ = _field_errs(_port_field(field_case, precision_), field_case["jax_bf16"])
    assert field_err > FIELD_TOL, field_err


def test_bf16_decomposed_branch_casts_its_planes(field_case, precision, monkeypatch):
    """MLPs outside K7's family take the decomposed modulation, its planes
    cast to bf16 under bf16 (``fields.py``'s branch, as JAX's): the same
    values and gradients as the K7bf route here, K7 not called, K6 on bf16
    planes."""
    ref = _port_field(field_case, "bf16")
    calls = []
    _record(monkeypatch, calls, (tmod, "plain_modulate_pair"), (tp, "plain_pair"))
    monkeypatch.setattr(tmod, "modulate_supported", lambda mlp: False)
    got = _port_field(field_case, "bf16")
    assert {(k, dt) for k, dt, _ in calls} == {("plain_pair", BF16)}
    field_err, errs = _field_errs(got, (ref[0].numpy(), ref[1].numpy(),
                                        {k.replace(".", "/"): v.numpy()
                                         for k, v in ref[2].items()}))
    assert field_err <= 1e-6 and max(errs.values()) <= 1e-6, (field_err, errs)


def test_chip_smoke_enc_idx_bf16_check_at_small_n(precision):
    """``chip_smoke.enc_idx_bf16_errors`` (phase 25's check) on the CPU at
    ``enc_idx_micro_case``'s recipe cut to n = 24, H = 8, L = 2, idx_dim 16
    (the field's route runs the plain versions here): one recorded
    plane-pair apply per layer, every error within the script's bounds
    (``check_enc_idx_bf16``), and the modulation's gradients for every
    parameter of the index encoder and both MLPs."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    vf, ctrl, y, t = chip_smoke.enc_idx_micro_case(torch, 24, 8, 2, 16, device="cpu")
    ops.set_fusion_backend("megakernel")
    ops.set_fusion_precision("bf16")
    errs, launches, out = chip_smoke.enc_idx_bf16_errors(torch, vf, ctrl, y, t)
    assert out.shape == (1, 24, 8) and not any(launches.values())  # CPU: no launch
    assert errs["layers_records"] == 2 and tp.plane_pair_apply.__name__ == "plane_pair_apply"
    assert set(errs["free_running"]) == {"state", *(k for k, _ in vf.named_parameters())}
    assert set(errs["modulation"]) == {k for k, _ in vf.named_parameters()
                                       if k.startswith(("idx_enc", "msg_func_adj"))}
    chip_smoke.check_enc_idx_bf16(errs, "CPU")
    assert max(errs["free_running"].values()) <= chip_smoke.K2_TOL
