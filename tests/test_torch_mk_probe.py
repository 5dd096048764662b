"""The megakernel design probes P1-P6 (``ops/mk_probe.py``): every variant's
plain version against the JAX probe body on the CPU.

The probe bodies are Pallas kernels on bf16 tensor-core operands; XLA's CPU
dot refuses their bf16 x bf16 -> f32 products in interpret mode and under
jit, so each body is called as a function, op by op, per batch element (as
``tests/test_torch_bf16.py`` calls the production body): each probe file is
loaded with importlib, its refs are holder objects, and the loaded module's
``pl`` is replaced by one whose ``program_id`` returns the element index.
The files are not edited.

P5's ``v4mm_bf16`` body cannot run on any backend (``mk_probe6.py:126``
reads ``At``, which only ``full`` and ``v4mm`` assign); its reference is the
function of its docstring: Ah, dAh evaluated in bf16 with jnp exactly as
``mk_probe6.py:52-59`` does, then the JAX ``v4mm`` body at tau = 0 on the
planes (0, 0, dAh, Ah), where A = Ah and dA = dAh exactly.

Tolerances as in ``tests/test_torch_bf16.py``: on the same bf16 operands
both sides round at the same points and differ only in the order of their
f32 sums, held to 5e-6 of each output's scale; a variant that rounds in bf16
must also be at least 3x closer to the JAX bf16 body than that body is to
its f32 route (the same body with ``jnp.bfloat16`` read as float32, or the
production f32 body).
"""

import importlib.util
import pathlib
import types

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from gncde_tpu.models.vector_fields import PermEquivGraphVectorField as JVF
from gncde_tpu.ops.pallas import megakernel as jmk
from gncde_tpu.ops.pallas import tiled as jtiled
from gncde_tpu_torch.models.vector_fields import PermEquivGraphVectorField as TVF
from gncde_tpu_torch.ops import megakernel as mk
from gncde_tpu_torch.ops import mk_probe as mp

from torch_parity_utils import copy_jax_to_torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, H, L, B, T = 40, 8, 2, 2, 5
DIMS = [(H, H)] * L
TOL = 5e-6
CLOSER = 3.0


def _load(name):
    """A probe file as a module of its own (the file itself untouched)."""
    spec = importlib.util.spec_from_file_location(f"_ref_{name}", ROOT / "benchmarks" /
                                                  f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Ref:
    """Stands in for a Pallas ref: ``[:]`` reads or replaces the value,
    ``[i]`` reads one entry."""

    def __init__(self, value=None):
        self.value = value

    def __getitem__(self, key):
        return self.value if key == slice(None) else self.value[key]

    def __setitem__(self, key, value):
        assert key == slice(None)
        self.value = value


#: jnp with bfloat16 read as float32: a probe body's f32 route.
_JNP_F32 = types.ModuleType("jnp_f32")
_JNP_F32.__dict__.update(jnp.__dict__)
_JNP_F32.bfloat16 = jnp.float32


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _check(what, port, jax_bf16, jax_f32=None):
    err = _rel(port, jax_bf16)
    assert err <= TOL, f"{what}: port {err:.3e} off the JAX body (> {TOL})"
    if jax_f32 is not None:
        gap = _rel(jax_f32, jax_bf16)
        assert CLOSER * err <= gap, f"{what}: port {err:.3e} vs bf16-f32 gap {gap:.3e}"


@pytest.fixture(scope="module")
def s():
    """bf16 per-element stacks (B, T-1, n, n), per-element (idx, tau), the
    node state, a JAX field's layer refs and its port copy's layers, and each
    element's interval planes as jnp bf16."""
    rng = np.random.default_rng(0)
    stacks = tuple(torch.tensor(rng.uniform(-0.05, 0.1, (B, T - 1, N, N))
                                .astype(np.float32)).to(torch.bfloat16) for _ in range(4))
    idx = np.array([2, 1])
    tau = rng.uniform(0.0, 0.2, B).astype(np.float32)
    Z = rng.normal(size=(B, N, H)).astype(np.float32)
    vf_j = JVF(input_dim=H, hidden_dim=H, output_dim=H, num_layers=L, data_embed_dim=1,
               num_nodes=N, key=jr.PRNGKey(3))
    vf_t = TVF(H, H, H, L, 1, N, generator=torch.Generator().manual_seed(0))
    copy_jax_to_torch(vf_j, vf_t)
    refs = [la[k] for la in jmk._layer_param_arrays(vf_j)
            for k in ("norm_w", "norm_b", "W", "lin_b", "basis")]
    f32 = [p.float().numpy() for p in stacks]
    return dict(stacks=stacks, f32=f32, idx=idx, tau=tau, Z=Z, refs=refs,
                layers=[{k: v.detach() for k, v in lp.items()} for lp in mk.layer_params(vf_t)],
                # each element's interval planes, as jnp bf16
                sel=[[jnp.asarray(p[b, idx[b]], jnp.bfloat16) for p in f32] for b in range(B)])


def _port(s, key, **kw):
    """The variant's wrapper on CPU tensors (its plain version); no launch."""
    v = mp.VARIANTS[key]
    out = v(s["stacks"], torch.tensor(s["idx"]), torch.tensor(s["tau"]), torch.tensor(s["Z"]),
            s["layers"], **kw)
    assert v.launches == 0
    return out.numpy()


def _grid_body(mod, make, s, extra=(), planes=None, tau=None, f32=False):
    """A batch-grid probe body (``kernel(idx_sref, tau_sref, d, c, b, a, z,
    *extra, *layers, out)``) per element, ``pl.program_id`` the element."""
    mod.jnp = _JNP_F32 if f32 else jnp
    outs = []
    tau = s["tau"] if tau is None else tau
    for b in range(B):
        mod.pl = types.SimpleNamespace(program_id=lambda axis, b=b: b)
        out = _Ref()
        make()(_Ref(jnp.asarray(s["idx"])), _Ref(jnp.asarray(tau)),
               *[_Ref(p) for p in (planes[b] if planes else s["sel"][b])],
               _Ref(jnp.asarray(s["Z"][b])), *[_Ref(e[b]) for e in extra],
               *[_Ref(r) for r in s["refs"]], out)
        outs.append(np.asarray(out.value))
    mod.jnp = jnp
    return np.stack(outs)


def _prod_body(s, bf16, planes=None, tau=None):
    """The production megakernel (``megakernel._make_kernel``, the body P2,
    P3 ``current``, P4/P5 ``full`` and P6 run) per element."""
    kernel = jmk._make_kernel(N, DIMS, bf16)
    tau = s["tau"] if tau is None else tau
    outs = []
    for b in range(B):
        out = _Ref()
        kernel(_Ref(jnp.full((1, 1), tau[b])),
               *[_Ref(p) for p in (planes[b] if planes else s["sel"][b])],
               _Ref(jnp.asarray(s["Z"][b])), *[_Ref(r) for r in s["refs"]], out)
        outs.append(np.asarray(out.value))
    return np.stack(outs)


def test_p1_restructured_matches_jax_body(s):
    mod = _load("mk_probe")
    ref = {}
    for bf16 in (True, False):
        make = mod.make_restructured_kernel(N, DIMS, bf16)
        outs = []
        for b in range(B):
            out = _Ref()
            make(_Ref(jnp.full((1, 1), s["tau"][b])), *[_Ref(p) for p in s["sel"][b]],
                 _Ref(jnp.asarray(s["Z"][b])), *[_Ref(r) for r in s["refs"]], out)
            outs.append(np.asarray(out.value))
        ref[bf16] = np.stack(outs)
    _check("P1 restructured", _port(s, "P1/restructured"), ref[True], ref[False])


@pytest.mark.parametrize("name", ["current", "fixedslice", "batchgrid"])
def test_p2_arrangement_matches_production_make_kernel(s, name):
    """P2 runs the production ``_make_kernel``; ``fixedslice`` on interval 3
    of every element's stack (``mk_probe2.py:85``), sliced once: on the
    port the caller passes ``(B, 1, n, n)`` stacks and idx 0."""
    if name == "fixedslice":
        planes = [[jnp.asarray(p[b, 3], jnp.bfloat16) for p in s["f32"]] for b in range(B)]
        stacks = tuple(p[:, 3:4].contiguous() for p in s["stacks"])
        idx = torch.zeros(B, dtype=torch.long)
    else:
        planes, stacks, idx = None, s["stacks"], torch.tensor(s["idx"])
    ref = {bf16: _prod_body(s, bf16, planes) for bf16 in (True, False)}
    v = mp.VARIANTS[f"P2/{name}"]
    got = v(stacks, idx, torch.tensor(s["tau"]), torch.tensor(s["Z"]), s["layers"])
    assert v.launches == 0
    _check(f"P2 {name}", got.numpy(), ref[True], ref[False])


def _jax_rvec(s):
    """P3's operand as ``mk_probe4.py:181, 224-231`` forms it (per element)."""
    red = jtiled.cubic_plane_reductions(tuple(jnp.asarray(p, jnp.bfloat16) for p in s["f32"]))
    out = []
    for b in range(B):
        wA, wdA = jtiled.hermite_weights(jnp.float32(s["tau"][b]))
        rs, dg = red.rs[b, s["idx"][b]], red.dg[b, s["idx"][b]]
        out.append(np.asarray(jnp.stack([rs @ wA, rs @ wdA, dg @ wA, dg @ wdA], axis=-1)))
    return np.stack(out)


def test_p3_red_operand_matches_jax(s):
    got = mp.red_operand(s["stacks"], torch.tensor(s["idx"]), torch.tensor(s["tau"]))
    assert got.shape == (B, N, 4) and got.dtype == torch.float32
    assert _rel(got.numpy(), _jax_rvec(s)) <= 1e-6


@pytest.mark.parametrize("name", ["current", "red", "notr", "red_notr"])
def test_p3_variant_matches_jax_body(s, name):
    mod = _load("mk_probe4")
    use_red, no_tr = "red" in name, "notr" in name
    jrvec = _jax_rvec(s)
    extra = [[jnp.asarray(jrvec[b]) for b in range(B)]] if use_red else []
    ref = {f32: _grid_body(mod, lambda: mod.make_kernel(N, DIMS, use_red, no_tr), s, extra,
                           f32=f32) for f32 in (False, True)}
    kw = {}
    if use_red:
        kw["rvec"] = mp.red_operand(s["stacks"], torch.tensor(s["idx"]), torch.tensor(s["tau"]))
    _check(f"P3 {name}", _port(s, f"P3/{name}", **kw), ref[False], ref[True])


@pytest.mark.parametrize("drop", mp.DROPS)
def test_p4_ablation_matches_jax_body(s, drop):
    mod = _load("mk_probe5")
    ref = {f32: _grid_body(mod, lambda: mod.make_kernel(N, DIMS, drop), s, f32=f32)
           for f32 in (False, True)}
    # dma_only rounds nothing: its f32 route is itself.
    _check(f"P4 {drop}", _port(s, f"P4/{drop}"), ref[False],
           None if drop == "dma_only" else ref[True])


def _v4mm_bf16_reference(mod, s, f32):
    """v4mm_bf16's function: the bf16 Hermite of ``mk_probe6.py:52-59`` by
    jnp, then the v4mm body at tau = 0 on (0, 0, dAh, Ah)."""
    planes = []
    for b in range(B):
        d, c, b_, a = s["sel"][b]
        taub = jnp.float32(s["tau"][b]).astype(jnp.bfloat16)
        Ah = ((d * taub + c) * taub + b_) * taub + a
        dAh = (3.0 * d * taub + 2.0 * c) * taub + b_
        zero = jnp.zeros_like(Ah)
        planes.append([zero, zero, dAh, Ah])
    return _grid_body(mod, lambda: mod.make_kernel(N, DIMS, "v4mm"), s, planes=planes,
                      tau=np.zeros(B, np.float32), f32=f32)


@pytest.mark.parametrize("variant", ["full", "v4mm", "v4mm_mt", "v4mm_bf16"])
def test_p5_variant_matches_jax_body(s, variant):
    mod = _load("mk_probe6")
    if variant == "v4mm_bf16":
        ref = _v4mm_bf16_reference(mod, s, f32=False)
    else:
        ref = _grid_body(mod, lambda: mod.make_kernel(N, DIMS, variant), s)
    _check(f"P5 {variant}", _port(s, f"P5/{variant}"), ref, _prod_body(s, False))


def test_p5_v4mm_bf16_jax_body_cannot_run(s):
    """The finding behind v4mm_bf16's reference: the body reads ``At``,
    which it never assigns."""
    mod = _load("mk_probe6")
    with pytest.raises(UnboundLocalError):
        _grid_body(mod, lambda: mod.make_kernel(N, DIMS, "v4mm_bf16"), s)


def test_p6_eval_body_is_the_production_body(s):
    """P6's fused step evaluates ``mk_probe7._eval_body``: the production
    ``_make_vf_body(n, dims, True, False)``, bit for bit (so K11bf, which
    holds that body, is P6's kernel)."""
    mod = _load("mk_probe7")
    body = jmk._make_vf_body(N, DIMS, True, False)
    for b in range(B):
        args = (jnp.float32(s["tau"][b]), *[p.astype(jnp.float32) for p in s["sel"][b]],
                jnp.asarray(s["Z"][b]))
        np.testing.assert_array_equal(
            np.asarray(mod._eval_body(N, DIMS, *args, [_Ref(r) for r in s["refs"]])),
            np.asarray(body(*args, [_Ref(r) for r in s["refs"]])))


def test_p6_step_variants_share_the_plain_step(s):
    """On CPU tensors both P6 variants are the plain bf16 Tsit5 step, one
    plain K1bf eval per stage, and launch nothing."""
    from gncde_tpu_torch.ops import fused_step as fs
    from gncde_tpu_torch.solve.tableaus import get_tableau

    tab = get_tableau("tsit5")
    ts = torch.linspace(0.0, 1.0, T).expand(B, T).contiguous()
    t = torch.tensor([0.1, 0.4])
    h = torch.full((B,), 0.09)
    y = torch.tensor(s["Z"])
    f0 = mk.plain_vf_eval_bf16(s["stacks"], *mk.interval(ts, t), y, s["layers"])
    outs = [mp.VARIANTS[f"P6/{name}"](s["stacks"], ts, t, y, h, f0, s["layers"], tab)
            for name in ("seq", "fusedstep")]
    ref = fs._step_reference(s["stacks"], ts, t, y, h, f0, s["layers"], tab, True)
    for out in outs:
        for a, r in zip(out, ref):
            assert torch.equal(a, r)
    assert all(mp.VARIANTS[f"P6/{n}"].launches == 0 for n in ("seq", "fusedstep"))


def test_registry_names_every_jax_variant():
    assert sorted(mp.VARIANTS) == sorted(
        ["P1/restructured", "P2/current", "P2/fixedslice", "P2/batchgrid", "P3/current",
         "P3/red", "P3/notr", "P3/red_notr"] + [f"P4/{d}" for d in mp.DROPS]
        + ["P5/full", "P5/v4mm", "P5/v4mm_mt", "P5/v4mm_bf16", "P6/seq", "P6/fusedstep"])
    for v in mp.VARIANTS.values():
        assert (ROOT / v.replaces.split(":")[0]).exists() and (ROOT / v.source).exists()
