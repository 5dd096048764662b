"""Gradients with respect to the coefficient planes through the K1 route and
the fused step (gncde_tpu_torch/ops/megakernel.py ``MegakernelVF``,
ops/fused_step.py ``FusedRKStep``).

No trainer differentiates the planes, but the JAX package serves the case:
its ``_mk_bwd`` and the fused step's ``_bwd`` take ``jax.vjp`` of their
plain references for every cotangent when the planes are perturbed. The
port does the same by autograd of its plain versions. Held here, on the CPU
(the forward is the plain version; the branch is the same on the card,
where the forward launches K1 / K11), against ``jax.vjp`` of the JAX
kernels in Pallas interpret mode, fields with copied weights, inputs from a
numpy seed: the K1 route on the undirected (8-term) and directed (11-term)
bases through the field's own dispatch, and a fused explicit step (Bosh3,
the cheapest FSAL tableau to interpret) through the solver's hook. float32 on both sides; rtol 1e-4 of each cotangent's
scale (sums over n^2 products in another order, as the K2 parity tests).
"""

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gncde_tpu.interp import backward_hermite_coefficients as j_bhc
from gncde_tpu.models.vector_fields import PermEquivDirGraphVectorField as JDVF
from gncde_tpu.models.vector_fields import PermEquivGraphVectorField as JVF
from gncde_tpu.ops.pallas import fused_step as jfs
from gncde_tpu.ops.pallas import megakernel as jmk
from gncde_tpu.solve import tableaus as jtab
from gncde_tpu_torch import ops
from gncde_tpu_torch.interp import CubicInterpolation, MatrixControl
from gncde_tpu_torch.models.vector_fields import PermEquivDirGraphVectorField as TDVF
from gncde_tpu_torch.models.vector_fields import PermEquivGraphVectorField as TVF
from gncde_tpu_torch.solve.solve import _rk_step
from gncde_tpu_torch.solve.tableaus import get_tableau

from torch_parity_utils import copy_jax_to_torch, hermite_path, jax_leaves

N, H, L, T = 10, 4, 2, 5
RTOL = 1e-4


def _close(got, ref, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=RTOL,
                               atol=RTOL * max(np.abs(ref).max(), 1e-30), err_msg=what)


@pytest.fixture
def megakernel():
    ops.set_fusion_backend("megakernel")
    try:
        yield
    finally:
        ops.set_fusion_backend("auto")
        ops.set_fused_step(False)


def _setup(B, directed, seed):
    rng = np.random.default_rng(seed)
    ts, A = hermite_path(rng, B, T, N)
    coeffs_j = jax.vmap(j_bhc)(jnp.asarray(ts), jnp.asarray(A))
    t = np.array([ts[b, 1 + b] + 0.4 * (ts[b, 2 + b] - ts[b, 1 + b]) for b in range(B)],
                 np.float32)
    jcls, tcls = (JDVF, TDVF) if directed else (JVF, TVF)
    vf_j = jcls(input_dim=H, hidden_dim=H, output_dim=H, num_layers=L, data_embed_dim=1,
                num_nodes=N, key=jr.PRNGKey(seed + 5))
    vf_t = tcls(H, H, H, L, 1, N, generator=torch.Generator().manual_seed(0))
    copy_jax_to_torch(vf_j, vf_t)
    return dict(ts=ts, t=t, coeffs_j=coeffs_j, vf_j=vf_j, vf_t=vf_t,
                y=rng.normal(size=(B, N, H)).astype(np.float32),
                W=[rng.normal(size=(B, N, H)).astype(np.float32) for _ in range(3)])


def _port_leaves(s):
    """The planes as leaves that need gradients, and the control over them."""
    planes = [torch.tensor(np.asarray(c), requires_grad=True) for c in s["coeffs_j"]]
    ctrl = MatrixControl(CubicInterpolation(torch.as_tensor(s["ts"]), tuple(planes)))
    return planes, ctrl


def _grads(outs, W, planes, named, extra):
    loss = sum((o * torch.tensor(w)).sum() for o, w in zip(outs, W))
    names = ["d", "c", "b", "a"] + list(extra) + [k for k, _ in named]
    wrt = planes + list(extra.values()) + [p for _, p in named]
    grads = torch.autograd.grad(loss, wrt, allow_unused=True)  # the directed basis
    # leaves some of its 2-vectors out of the field (JAX's gradient is zero there)
    return dict(zip(names, [np.zeros(x.shape, np.float32) if g is None else g.numpy()
                            for x, g in zip(wrt, grads)]))


def _jit_vjp(f, args, cotangents):
    """``(f(*args), vjp(cotangents))`` of ``jax.vjp``, compiled as one
    program (op by op, the first call compiles each small op: seconds)."""
    def run(args, cotangents):
        out, vjp = jax.vjp(f, *args)
        return out, vjp(cotangents)

    return jax.jit(run)(args, cotangents)


def _jax_grads(gc, extra, gvf):
    out = dict(zip(["d", "c", "b", "a"], (np.asarray(x) for x in gc)))
    out.update({k: np.asarray(v) for k, v in extra.items()})
    out.update({k.replace("/", "."): v for k, v in jax_leaves(gvf).items()})
    return out


@pytest.mark.parametrize("directed", [False, True], ids=["undirected", "directed"])
def test_k1_route_plane_grads_match_jax_vjp(megakernel, directed):
    """The field's dispatch sends planes that need gradients to the K1 route
    (``MegakernelVF``), whose backward serves them on either basis."""
    s = _setup(B=2, directed=directed, seed=3 + directed)
    planes, ctrl = _port_leaves(s)
    t = torch.tensor(s["t"], requires_grad=True)
    y = torch.tensor(s["y"], requires_grad=True)
    out = s["vf_t"](t, y, ctrl)
    assert type(out.grad_fn).__name__ == "MegakernelVFBackward"
    got = _grads([out], s["W"][:1], planes, list(s["vf_t"].named_parameters()),
                 {"t": t, "y": y})

    def f(coeffs, t_, Z, vf):
        return jax.vmap(lambda c, ts_, tt, z: jmk.megakernel_vf_eval(c, ts_, tt, z, vf))(
            coeffs, jnp.asarray(s["ts"]), t_, Z)

    with pltpu.force_tpu_interpret_mode():
        ref_out, (gc, gt, gZ, gvf) = _jit_vjp(f, (s["coeffs_j"], jnp.asarray(s["t"]),
                                                  jnp.asarray(s["y"]), s["vf_j"]),
                                              jnp.asarray(s["W"][0]))
    _close(out.detach().numpy(), ref_out, "vf output")
    ref = _jax_grads(gc, {"t": gt, "y": gZ}, gvf)
    assert set(got) == set(ref)
    for k, g in got.items():
        _close(g, ref[k], k)


def test_fused_step_plane_grads_match_jax_vjp(megakernel):
    """The fused Bosh3 step (three evaluated stages) through the solver's hook (``FusedRKStep``) with
    planes that need gradients, one element, against ``jax.vjp`` of the JAX
    fused step."""
    ops.set_fused_step(True)
    s = _setup(B=1, directed=False, seed=7)
    planes, ctrl = _port_leaves(s)
    rng = np.random.default_rng(8)
    h_np = np.array([0.15], np.float32)
    f0_np = (0.1 * rng.normal(size=(1, N, H))).astype(np.float32)
    t = torch.tensor(s["t"], requires_grad=True)
    y = torch.tensor(s["y"], requires_grad=True)
    h = torch.tensor(h_np, requires_grad=True)
    f0 = torch.tensor(f0_np, requires_grad=True)
    outs = _rk_step(get_tableau("bosh3"), s["vf_t"], t, y, h, ctrl, f0)
    assert type(outs[0].grad_fn).__name__ == "FusedRKStepBackward"
    got = _grads(outs, s["W"], planes, list(s["vf_t"].named_parameters()),
                 {"t": t, "y": y, "h": h, "f0": f0})

    tab = jtab.get_tableau("Bosh3")
    ts0 = jnp.asarray(s["ts"][0])

    def f(coeffs, t_, y_, h_, f0_, vf):
        return jfs.fused_rk_step(tab, coeffs, ts0, t_, y_, h_, f0_, vf)

    args = (tuple(c[0] for c in s["coeffs_j"]), jnp.asarray(s["t"][0]),
            jnp.asarray(s["y"][0]), jnp.asarray(h_np[0]), jnp.asarray(f0_np[0]), s["vf_j"])
    with pltpu.force_tpu_interpret_mode():
        ref_outs, (gc, gt, gy, gh, gf0, gvf) = _jit_vjp(
            f, args, tuple(jnp.asarray(w[0]) for w in s["W"]))
    for o, r in zip(outs, ref_outs):
        _close(o.detach().numpy()[0], r, "step output")
    ref = _jax_grads(gc, {"t": gt, "y": gy, "h": gh, "f0": gf0}, gvf)
    assert set(got) == set(ref)
    for k, g in got.items():
        _close(g[0] if k in ("d", "c", "b", "a", "y", "f0") else g,
               ref[k] if k not in ("t", "h") else np.reshape(ref[k], (1,)), k)
