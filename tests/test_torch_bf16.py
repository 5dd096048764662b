"""Port parity under ``fusion_precision: bf16`` (the JAX package's production
precision): the plain versions of K1bf, K2bf and K11bf, the dense layers'
bf16 apply and the bf16 slim control, against the JAX package on the CPU.

The JAX bf16 megakernels cannot run in Pallas interpret mode on the CPU
(XLA's CPU dot refuses their bf16 x bf16 -> f32 products), and a jitted
call of the kernel bodies fails the same way once XLA folds the transposed
operand into the dot. So the references are the JAX kernel bodies called
as functions, op by op: ``megakernel._make_vf_body(n, dims, True,
directed)`` and ``megakernel_bwd._make_bwd_kernel(n, dims, True, directed,
need_tau=True)`` with holder objects for its refs, per batch element, on the
same bf16 planes (read as f32, as the kernels read them).

Tolerances. On the same bf16 operands both sides round at the same points
and differ only in the order of their f32 sums (measured: 1e-7 to 6e-7 of
each output's scale); each test holds that to 5e-6. A bf16 route that ran in
f32 would be off by the bf16 rounding itself (measured 5e-4 to 4e-3), so
every test also asserts that the port is at least 3x closer to the JAX bf16
result than that result is to the JAX f32 one.
"""

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from gncde_tpu import ops as jops
from gncde_tpu.interp import CubicInterpolation as JCubic
from gncde_tpu.models.continuous import make_control as j_make_control
from gncde_tpu.models.vector_fields import PermEquivDirGraphVectorField as JDVF
from gncde_tpu.models.vector_fields import PermEquivGraphVectorField as JVF
from gncde_tpu.models.vector_fields.layers import ConvEquivFusionDirectedLayer as JDL
from gncde_tpu.models.vector_fields.layers import ConvEquivFusionLayer as JL
from gncde_tpu.ops.pallas import megakernel as jmk
from gncde_tpu.ops.pallas import megakernel_bwd as jmkb
from gncde_tpu_torch import ops
from gncde_tpu_torch.interp import CubicInterpolation, MatrixControl
from gncde_tpu_torch.models.continuous import make_control
from gncde_tpu_torch.models.vector_fields import PermEquivDirGraphVectorField as TDVF
from gncde_tpu_torch.models.vector_fields import PermEquivGraphVectorField as TVF
from gncde_tpu_torch.models.vector_fields.layers import ConvEquivFusionDirectedLayer as TDL
from gncde_tpu_torch.models.vector_fields.layers import ConvEquivFusionLayer as TL
from gncde_tpu_torch.ops import fused_step as tfs
from gncde_tpu_torch.ops import megakernel as mk
from gncde_tpu_torch.ops import megakernel_bwd as mkb
from gncde_tpu_torch.ops import tiled as tt
from gncde_tpu_torch.solve.solve import _rk_step
from gncde_tpu_torch.solve.tableaus import get_tableau

from torch_parity_utils import copy_jax_to_torch

N, H, L, B = 20, 8, 2, 3
#: Port vs JAX on the same bf16 operands: f32 summation order only.
TOL = 5e-6
#: The port must be this many times closer to JAX bf16 than JAX bf16 is to
#: JAX f32.
CLOSER = 3.0
BASES = [False, True]
BASIS_IDS = ["undirected", "directed"]


@pytest.fixture
def precision():
    """Restores both packages' fusion precision and backend after a test."""
    yield
    ops.set_fusion_precision("f32")
    ops.set_fusion_backend("auto")
    ops.set_fused_step(False)
    jops.set_fusion_precision("f32")
    jops.set_fusion_backend("auto")


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _check(what, port, jax_bf16, jax_f32):
    """The port within TOL of JAX bf16, and CLOSER times closer to it than
    JAX bf16 is to JAX f32."""
    err, gap = _rel(port, jax_bf16), _rel(jax_f32, jax_bf16)
    assert err <= TOL, f"{what}: port {err:.3e} off JAX bf16 (> {TOL})"
    assert CLOSER * err <= gap, f"{what}: port {err:.3e} vs bf16-f32 gap {gap:.3e}"


def _inputs(directed, seed):
    """bf16 planes (B, n, n) (per element), offsets, node state, cotangent,
    and a JAX field with its port copy. Directed planes are scaled by
    column, so column sums differ from row sums."""
    rng = np.random.default_rng(seed)
    planes = [rng.uniform(-0.05, 0.1, (B, N, N)).astype(np.float32) for _ in range(4)]
    if directed:
        planes = [p * np.linspace(0.2, 1.8, N, dtype=np.float32)[None, None, :]
                  for p in planes]
    bf = tuple(torch.tensor(p).to(torch.bfloat16) for p in planes)
    tau = rng.uniform(0.0, 0.2, B).astype(np.float32)
    Z = rng.normal(size=(B, N, H)).astype(np.float32)
    G = rng.normal(size=(B, N, H)).astype(np.float32)
    jcls, tcls = (JDVF, TDVF) if directed else (JVF, TVF)
    vf_j = jcls(input_dim=H, hidden_dim=H, output_dim=H, num_layers=L, data_embed_dim=1,
                num_nodes=N, key=jr.PRNGKey(seed + 3))
    vf_t = tcls(H, H, H, L, 1, N, generator=torch.Generator().manual_seed(0))
    copy_jax_to_torch(vf_j, vf_t)
    refs = [la[k] for la in jmk._layer_param_arrays(vf_j)
            for k in ("norm_w", "norm_b", "W", "lin_b", "basis")]
    layers = [{k: v.detach() for k, v in lp.items()} for lp in mk.layer_params(vf_t)]
    return dict(bf=bf, f32=[p.float().numpy() for p in bf], tau=tau, Z=Z, G=G,
                refs=refs, layers=layers, vf_t=vf_t,
                # (B, 1, n, n) stacks of one interval each, all at interval 0.
                stacks=tuple(p[:, None] for p in bf), idx=torch.zeros(B, dtype=torch.long))


@pytest.mark.parametrize("directed", BASES, ids=BASIS_IDS)
def test_plain_k1bf_matches_jax_bf16_body(directed):
    s = _inputs(directed, seed=0)
    ref = {}
    for bf16 in (True, False):
        body = jmk._make_vf_body(N, [(H, H)] * L, bf16, directed)
        ref[bf16] = np.stack([np.asarray(body(
            jnp.float32(s["tau"][b]), *[jnp.asarray(p[b]) for p in s["f32"]],
            jnp.asarray(s["Z"][b]), s["refs"])) for b in range(B)])
    before = mk.megakernel_vf_eval.bf16.launches
    got = mk.megakernel_vf_eval(s["stacks"], s["idx"], torch.tensor(s["tau"]),
                                torch.tensor(s["Z"]), s["layers"], bf16=True)
    assert mk.megakernel_vf_eval.bf16.launches == before  # CPU: plain version
    _check("K1bf", got.numpy(), ref[True], ref[False])


class _Ref:
    """Stands in for a Pallas ref: ``[:]`` reads or replaces the value,
    ``[i, j]`` reads or sets one entry."""

    def __init__(self, value=None):
        self.value = value

    def __getitem__(self, key):
        return self.value if key == slice(None) else self.value[key]

    def __setitem__(self, key, value):
        if key == slice(None):
            self.value = value
        else:
            self.value = jnp.asarray(self.value).at[key].set(value)


def _jax_bwd(s, bf16, directed):
    """Every output of the JAX backward body per element: [dtau, dZ, then per
    layer dnorm_w, dnorm_b, dW, dlin_b, dbasis]."""
    kernel, _ = jmkb._make_bwd_kernel(N, [(H, H)] * L, bf16, directed, True)
    outs = []
    for b in range(B):
        dtau, dz, grads = _Ref(jnp.zeros((1, 1))), _Ref(), [_Ref() for _ in range(5 * L)]
        kernel(_Ref(jnp.full((1, 1), s["tau"][b])),
               *[_Ref(jnp.asarray(p[b])) for p in s["f32"]], _Ref(jnp.asarray(s["Z"][b])),
               _Ref(jnp.asarray(s["G"][b])), *[_Ref(r) for r in s["refs"]], dtau, dz, *grads)
        outs.append([np.asarray(dtau.value)[0, 0], np.asarray(dz.value)]
                    + [np.asarray(g.value) for g in grads])
    return outs


@pytest.mark.parametrize("directed", BASES, ids=BASIS_IDS)
def test_plain_k2bf_matches_jax_bf16_bwd_body(directed):
    s = _inputs(directed, seed=1)
    ref = {bf16: _jax_bwd(s, bf16, directed) for bf16 in (True, False)}
    before = mkb.megakernel_vf_bwd.bf16.launches
    dtau, dZ, per_layer = mkb.megakernel_vf_bwd(
        s["stacks"], s["idx"], torch.tensor(s["tau"]), torch.tensor(s["Z"]), s["layers"],
        torch.tensor(s["G"]), need_tau=True, bf16=True)
    assert mkb.megakernel_vf_bwd.bf16.launches == before
    port = [dtau, dZ] + [g for layer in per_layer for g in layer]
    names = ["dtau", "dZ"] + [f"{k}{l}" for l in range(L)
                              for k in ("dnorm_w", "dnorm_b", "dW", "dlin_b", "dbasis")]
    for i, name in enumerate(names):
        got = port[i].numpy()
        jb, jf = (np.stack([np.reshape(o[i], got.shape[1:]) for o in ref[k]])
                  for k in (True, False))
        _check(f"K2bf {name}", got, jb, jf)


def _step_setup(directed, seed):
    """A flagship-like field (n = N, width H, two layers) on per-element bf16
    stacks, a control over them and a Tsit5 step's (t, y, h, f0)."""
    rng = np.random.default_rng(seed)
    T = 5
    ts = torch.tensor(np.cumsum(rng.uniform(0.1, 0.3, (B, T)), 1).astype(np.float32))
    scale = np.linspace(0.2, 1.8, N, dtype=np.float32) if directed else 1.0
    stacks = tuple(torch.tensor((rng.uniform(-0.05, 0.1, (B, T - 1, N, N)) * scale)
                                .astype(np.float32)).to(torch.bfloat16) for _ in range(4))
    cls = TDVF if directed else TVF
    vf = cls(H, H, H, L, 1, N, generator=torch.Generator().manual_seed(seed))
    ctrl = MatrixControl(CubicInterpolation(ts, stacks))
    t = ts[:, 0] + 0.3 * (ts[:, -1] - ts[:, 0])
    h = (ts[:, -1] - ts[:, 0]) / 20
    y = torch.tensor(rng.normal(size=(B, N, H)).astype(np.float32))
    return vf, ctrl, t, h, y


@pytest.mark.parametrize("directed", BASES, ids=BASIS_IDS)
def test_plain_k11bf_step_matches_per_stage_k1bf_route(precision, directed):
    """The plain K11bf step (``_step_reference``, bf16) and its backward (the
    chain of plain K2bf) against the solver's per-stage route through
    MegakernelVF (plain K1bf and K2bf per stage): y1, err, f1 to TOL, the
    gradients of sum(y1 W) to 1e-5 (both sum the same K2bf cotangents in
    another order); both CLOSER times closer to each other than to the f32
    step."""
    vf, ctrl, t, h, y = _step_setup(directed, seed=4)
    tab = get_tableau("tsit5")
    ops.set_fusion_backend("megakernel")
    W = torch.tensor(np.random.default_rng(5).normal(size=y.shape).astype(np.float32))

    def run(prec, fused):
        ops.set_fusion_precision(prec)
        ops.set_fused_step(fused)
        vf.zero_grad(set_to_none=True)
        y_ = y.clone().requires_grad_(True)
        with torch.no_grad():
            f0 = vf(t, y, ctrl)
        outs = _rk_step(tab, vf, t, y_, h, ctrl, f0)
        (outs[0] * W).sum().backward()
        grads = [y_.grad] + [p.grad for p in vf.gnn_layers.parameters()]
        return [o.detach().numpy() for o in outs], [g.numpy() for g in grads]

    before = tfs.fused_step_call.bf16.launches
    fused, fused_g = run("bf16", True)
    assert tfs.fused_step_call.bf16.launches == before  # CPU: plain version
    stage, stage_g = run("bf16", False)
    f32, f32_g = run("f32", False)
    for what, a, b, c in zip(("y1", "err", "f1"), fused, stage, f32):
        err, gap = _rel(a, b), _rel(c, b)
        assert err <= TOL and CLOSER * err <= gap, (what, err, gap)
    for a, b, c in zip(fused_g, stage_g, f32_g):
        err, gap = _rel(a, b), _rel(c, b)
        assert err <= 1e-5 and CLOSER * err <= gap, (err, gap)


@pytest.mark.parametrize("directed", BASES, ids=BASIS_IDS)
def test_dense_layer_bf16_apply_matches_jax(precision, directed):
    """The dense per-layer apply (the CPU trainer's path) under bf16: the
    fused operator formed on bf16 planes, one product with M rounded; the
    output and the gradients of sum(out W) w.r.t. the features and every
    layer parameter, against JAX's layer (``layers.py:147-155`` /
    ``:273-281``) through ``jax.grad``."""
    import jax

    rng = np.random.default_rng(6)
    A = rng.uniform(0.0, 0.3, (B, N, N)).astype(np.float32)
    dA = rng.normal(size=(B, N, N)).astype(np.float32)
    x = rng.normal(size=(B, N, H)).astype(np.float32)
    W = rng.normal(size=(B, N, H)).astype(np.float32)
    jl = (JDL if directed else JL)(H, H, key=jr.PRNGKey(7))
    tl = (TDL if directed else TL)(H, H, generator=torch.Generator().manual_seed(0))
    copy_jax_to_torch(jl, tl)
    jops.set_fusion_backend("dense")
    ops.set_fusion_backend("dense")

    def jax_run():
        def loss(layer, x_):
            out = jax.vmap(lambda xx, a, da: layer(xx, a, da))(x_, A, dA)
            return jnp.sum(out * W), out

        (_, out), (g_layer, g_x) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            jl, jnp.asarray(x))
        g_p = [np.asarray(p) for p in g_layer.params]
        conv = g_layer.conv_layer
        g_p += [np.asarray(conv.norm.weight), np.asarray(conv.norm.bias),
                np.asarray(conv.linear.weight), np.asarray(conv.linear.bias)]
        return [np.asarray(out), np.asarray(g_x)] + g_p

    def port_run():
        tl.zero_grad(set_to_none=True)
        x_ = torch.tensor(x, requires_grad=True)
        out = tl(x_, torch.tensor(A), torch.tensor(dA))
        (out * torch.tensor(W)).sum().backward()
        conv = tl.conv_layer
        g_p = [p.grad.numpy() for p in tl.params]
        g_p += [conv.norm.weight.grad.numpy(), conv.norm.bias.grad.numpy(),
                conv.linear.weight.grad.numpy(), conv.linear.bias.grad.numpy()]
        return [out.detach().numpy(), x_.grad.numpy()] + g_p

    res = {}
    for prec in ("bf16", "f32"):
        jops.set_fusion_precision(prec)
        ops.set_fusion_precision(prec)
        res[prec] = (jax_run(), port_run())
    names = ["out", "dx"] + [f"dparam{k}" for k in range(len(tl.params))] + [
        "dnorm_w", "dnorm_b", "dW", "dlin_b"]
    for i, name in enumerate(names):
        _check(f"dense bf16 {name}", res["bf16"][1][i], res["bf16"][0][i], res["f32"][0][i])


def test_make_control_stores_bf16_and_reduces_after_the_cast(precision):
    """Under bf16 the slim control's four Hermite stacks are bfloat16, the
    path evaluates them in f32 as JAX does, and the tiled regime's
    reductions (n > 640 under the megakernel backend) are taken of the bf16
    stacks: equal to the JAX control's, and not those of the f32 stacks."""
    n, T, Bc = 650, 3, 1
    rng = np.random.default_rng(8)
    ts = np.cumsum(rng.uniform(0.1, 0.3, (Bc, T)), 1).astype(np.float32)
    # Reference-layout [time, value] stacks: the value channel is last.
    coeffs = [rng.normal(size=(Bc, T - 1, n, n, 2)).astype(np.float32) for _ in range(4)]
    for prec in ("bf16", "f32"):
        ops.set_fusion_precision(prec)
        jops.set_fusion_precision(prec)
        ops.set_fusion_backend("megakernel")
        jops.set_fusion_backend("megakernel")
        ctrl = make_control("cubic", torch.tensor(ts), tuple(torch.tensor(c) for c in coeffs))
        jctrl = [j_make_control("cubic", jnp.asarray(ts[b]),
                                tuple(jnp.asarray(c[b]) for c in coeffs), slim=True)
                 for b in range(Bc)]
        want = torch.bfloat16 if prec == "bf16" else torch.float32
        assert all(c.dtype == want for c in ctrl.path.coeffs)
        for got, ref in zip(ctrl.red, zip(*[j.red for j in jctrl])):
            np.testing.assert_allclose(got.numpy(), np.stack([np.asarray(r) for r in ref]),
                                       rtol=1e-5, atol=1e-4)
        if prec == "bf16":
            f32_red = tt.cubic_plane_reductions(
                tuple(torch.tensor(c[..., -1]) for c in coeffs))
            assert float((ctrl.red.rs - f32_red.rs).abs().max()) > 1e-3
            # Evaluation in f32 of the bf16 stacks, as the jitted JAX path
            # promotes them.
            import jax

            tq = torch.tensor(ts[:, 0] + 0.37 * (ts[:, 1] - ts[:, 0]))
            jpath = JCubic(jnp.asarray(ts[0]), tuple(
                jnp.asarray(c[0, ..., -1]).astype(jnp.bfloat16) for c in coeffs))
            tj = jnp.float32(tq[0])
            for got, ref in ((ctrl.adj(tq), jax.jit(jpath.evaluate)(tj)),
                             (ctrl.dadj(tq), jax.jit(jpath.derivative)(tj))):
                assert got.dtype == torch.float32
                np.testing.assert_allclose(got[0].numpy(), np.asarray(ref), rtol=1e-5,
                                           atol=1e-5)


# ---------------------------------------------------------------------------
# The layer-by-layer checks of the bf16 kernels (chip_smoke.py phase 21)
# ---------------------------------------------------------------------------


def _stack(directed, seed):
    """bf16 interval stacks, (idx, tau), node state, cotangent and a
    3-layer stack (two hidden ReLUs) of the port field's parameters."""
    s = _inputs(directed, seed)
    layers = s["layers"] + [{k: v.clone() for k, v in s["layers"][-1].items()}]
    return (s["stacks"], s["idx"], torch.tensor(s["tau"]), torch.tensor(s["Z"]), layers,
            torch.tensor(s["G"]))


@pytest.mark.parametrize("directed", BASES, ids=BASIS_IDS)
def test_stepwise_plain_versions_reproduce_their_own_run(directed):
    """Fed their own intermediates, the layer-by-layer modes of the plain
    K1bf, K2bf and K11bf (``given_M``, ``given``, ``given_ks``) compute
    the plain versions bit for bit."""
    planes, idx, tau, Z, layers, G = _stack(directed, seed=20)
    mine, again = {}, {}
    out = mk.plain_vf_eval_bf16(planes, idx, tau, Z, layers, trace=mine)
    assert len(mine["M"]) == 3
    assert torch.equal(out, mk.plain_vf_eval_bf16(planes, idx, tau, Z, layers,
                                                  given_M=mine["M"], trace=again))
    assert all(torch.equal(a, b) for a, b in zip(mine["M"], again["M"]))

    mine, again = {}, {}
    ref = mkb.plain_vf_bwd_bf16(planes, idx, tau, Z, layers, G, True, trace=mine)
    got = mkb.plain_vf_bwd_bf16(planes, idx, tau, Z, layers, G, True, given=mine,
                                trace=again)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert all(torch.equal(a, b) for gl, rl in zip(got[2], ref[2]) for a, b in zip(gl, rl))
    for key in ("M", "X", "g"):
        assert all(a is b is None or torch.equal(a, b) for a, b in zip(mine[key], again[key]))
    # K2bf's forward recompute is K1bf's.
    fwd = {}
    mk.plain_vf_eval_bf16(planes, idx, tau, Z, layers, trace=fwd)
    assert all(torch.equal(a, b) for a, b in zip(mine["M"], fwd["M"]))

    tab = get_tableau("tsit5")
    step = _step_case(directed)
    ref = tfs._step_reference(*step, tab, bf16=True)
    got = tfs._step_reference(*step, tab, bf16=True, given_ks=ref[3])
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def _step_case(directed):
    """(planes, ts, t, y, h, f0, layers) of one Tsit5 step on the bf16
    stacks of :func:`_stack` (two knots, the state width the stack's)."""
    planes, _, _, Z, layers, _ = _stack(directed, seed=21)
    ts = torch.tensor([[0.0, 1.0]] * B)
    t = torch.tensor([0.1, 0.3, 0.5])
    h = torch.tensor([0.05, 0.1, 0.2])
    return planes, ts, t, Z, h, 0.1 * Z, layers


def _f32_products(fn):
    """``fn`` with the plain versions' bf16 rounding switched off: the fault
    of a kernel that took f32 products."""
    def run(*args, **kwargs):
        saved = mk.rbf, mkb.rbf
        mk.rbf = mkb.rbf = lambda x: x
        try:
            return fn(*args, **kwargs)
        finally:
            mk.rbf, mkb.rbf = saved
    return run


def _basis_off(planes, idx, tau, Z, layers, G, need_tau=True, bf16=False, trace=None):
    """The fault of a kernel whose layer-0 basis cotangent is off by 1% of its
    scale in one entry."""
    dtau, dZ, per_layer = mkb.plain_vf_bwd_bf16(planes, idx, tau, Z, layers, G, need_tau,
                                                trace=trace)
    db = per_layer[0][4].clone()
    db[0, 0, 0] += 0.01 * db.abs().max()
    return dtau, dZ, [per_layer[0][:4] + (db,)] + per_layer[1:]


@pytest.mark.parametrize("fault", ["k1bf-f32-products", "k2bf-f32-products",
                                   "k2bf-basis-cotangent"])
def test_stepwise_check_fails_a_wrong_kernel(monkeypatch, fault):
    """chip_smoke.py's layer-by-layer checks of K1bf and K2bf (the CPU
    wrappers' plain versions in the kernels' place) pass the right
    function at 0 and fail a planted fault by more than their bounds
    (1e-4, 1e-3): products in f32 instead of bf16, and one basis
    cotangent 1% off (beyond the 5e-3 of a K11bf stage's too)."""
    import chip_smoke

    planes, idx, tau, Z, layers, G = _stack(True, seed=22)
    if fault.startswith("k1bf"):
        check = lambda: chip_smoke.bf16_k1_stepwise(  # noqa: E731
            torch, planes, idx, tau, Z, layers)[1][0]
        bound = chip_smoke.K1_TOL
        assert max(check().values()) == 0.0
        wrong = _f32_products(mk.plain_vf_eval_bf16)
        monkeypatch.setattr(mk, "megakernel_vf_eval",
                            lambda p, i, t, z, ls, bf16=False, trace=None: wrong(
                                p, i, t, z, ls, trace=trace))
    else:
        check = lambda: chip_smoke.bf16_k2_stepwise(  # noqa: E731
            torch, planes, idx, tau, Z, layers, G, True)[1][0]
        bound = chip_smoke.K2_TOL
        assert max(check().values()) == 0.0
        if fault == "k2bf-basis-cotangent":
            monkeypatch.setattr(mkb, "megakernel_vf_bwd", _basis_off)
        else:
            wrong = _f32_products(mkb.plain_vf_bwd_bf16)
            monkeypatch.setattr(mkb, "megakernel_vf_bwd",
                                lambda p, i, t, z, ls, g, need_tau=True, bf16=False,
                                trace=None: wrong(p, i, t, z, ls, g, need_tau, trace=trace))
    errs = check()
    assert max(errs.values()) > 3 * bound, errs
    if fault == "k2bf-basis-cotangent":
        # Also beyond the bound of a single K11bf stage's basis cotangents.
        assert max(errs, key=errs.get) == "dbasis0"
        assert errs["dbasis0"] > chip_smoke.BF16_STAGE_BASIS_TOL
