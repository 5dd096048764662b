"""Port parity of the fused RK step (gncde_tpu_torch/ops/fused_step.py, K11)
and its solver hook.

On the CPU the step runs its plain version (the stage loop of
``plain_vf_eval``) forward and the manual explicit-RK chain rule backward
(one ``megakernel_vf_bwd`` per stage, its plain version). Held against:

* the JAX fused step ``fused_step.fused_rk_step`` in Pallas interpret mode,
  Tsit5 only (one value case and one gradient case at n = 12: the interpret
  mode costs about 10 s a call), rtol 1e-5 for values and 1e-4 for
  gradients (float32 on both sides, the n-sums and the stage chain in
  another order);
* the JAX solver's per-stage ``_rk_step`` on the dense backend for Dopri5
  and Bosh3 (no interpret mode), rtol 1e-5;
* the port's own per-stage route (flag off): the hook's None conditions,
  and the adaptive solve with the flag on against the flag off, rtol 1e-5.
The kernel itself is held against the plain version on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py phases 14-15).
"""

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gncde_tpu import ops as jops
from gncde_tpu.interp import (
    CubicInterpolation as JCubic,
    MatrixControl as JMatrixControl,
    backward_hermite_coefficients as j_bhc,
)
from gncde_tpu.models.vector_fields import PermEquivGraphVectorField as JVF
from gncde_tpu.ops.pallas import fused_step as jfs
from gncde_tpu.solve import solve as jsolve
from gncde_tpu.solve import tableaus as jtab
from gncde_tpu_torch import ops
from gncde_tpu_torch.interp import CubicInterpolation, MatrixControl
from gncde_tpu_torch.models.vector_fields import PermEquivGraphVectorField as TVF
from gncde_tpu_torch.ops import fused_step as tfs
from gncde_tpu_torch.solve import ODETerm, PIDController, SaveAt, diffeqsolve
from gncde_tpu_torch.solve.solve import _rk_step
from gncde_tpu_torch.solve.tableaus import ButcherTableau, get_tableau

from torch_parity_utils import copy_jax_to_torch, hermite_path, jax_leaves

N, H, L, T = 12, 8, 2, 6


def _close(got, ref, rtol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-30))


@pytest.fixture
def megakernel():
    ops.set_fusion_backend("megakernel")
    ops.set_fused_step(True)
    try:
        yield
    finally:
        ops.set_fusion_backend("auto")
        ops.set_fused_step(False)


def _setup(B, seed=0, n=N):
    """Both fields with copied weights, per-element Hermite planes, a
    per-element (t, y, h, f0) with one element past the last knot (h = 1,
    as the solver gives a finished element)."""
    rng = np.random.default_rng(seed)
    ts, A = hermite_path(rng, B, T, n)
    coeffs_j = jax.vmap(j_bhc)(jnp.asarray(ts), jnp.asarray(A))
    t = (ts[:, 1] + 0.05).astype(np.float32)
    h = rng.uniform(0.05, 0.3, B).astype(np.float32)
    if B > 1:
        t[-1], h[-1] = ts[-1, -1] + 0.05, 1.0
    y = rng.normal(size=(B, n, H)).astype(np.float32)
    f0 = (0.1 * rng.normal(size=(B, n, H))).astype(np.float32)
    vf_j = JVF(input_dim=H, hidden_dim=H, output_dim=H, num_layers=L,
               data_embed_dim=1, num_nodes=n, key=jr.PRNGKey(seed + 3))
    vf_t = TVF(H, H, H, L, 1, n, generator=torch.Generator().manual_seed(0))
    copy_jax_to_torch(vf_j, vf_t)
    ctrl = MatrixControl(CubicInterpolation(
        torch.as_tensor(ts), tuple(torch.tensor(np.asarray(c)) for c in coeffs_j)))
    return dict(ts=ts, coeffs_j=coeffs_j, t=t, h=h, y=y, f0=f0, vf_j=vf_j, vf_t=vf_t,
                ctrl=ctrl, W=[rng.normal(size=(B, n, H)).astype(np.float32) for _ in range(3)])


def _port_step(s, tab, with_grads=False):
    """The port's step through the solver's ``_rk_step`` (so through the
    hook); returns outputs and, with ``with_grads``, the gradients of
    sum(y1 W0 + err W1 + f1 W2) with respect to y, f0 and the field's
    parameters (state_dict names)."""
    vf = s["vf_t"]
    y = torch.tensor(s["y"], requires_grad=with_grads)
    f0 = torch.tensor(s["f0"], requires_grad=with_grads)
    outs = _rk_step(tab, vf, torch.tensor(s["t"]), y, torch.tensor(s["h"]), s["ctrl"], f0)
    if not with_grads:
        return [o.detach().numpy() for o in outs], None
    loss = sum((o * torch.tensor(w)).sum() for o, w in zip(outs, s["W"]))
    names = [k for k, _ in vf.named_parameters()]
    grads = torch.autograd.grad(loss, [y, f0] + [p for _, p in vf.named_parameters()])
    return ([o.detach().numpy() for o in outs],
            dict(zip(["y", "f0"] + names, [g.numpy() for g in grads])))


def _jax_fused(s, with_grads=False):
    """The JAX K11 on element 0 in interpret mode (unbatched call)."""
    tab = jtab.get_tableau("Tsit5")
    ctrl = JMatrixControl(JCubic(jnp.asarray(s["ts"][0]),
                                 tuple(c[0] for c in s["coeffs_j"])))
    args = (jnp.asarray(s["t"][0]), jnp.asarray(s["y"][0]), jnp.asarray(s["h"][0]),
            jnp.asarray(s["f0"][0]))

    def f(y, f0, vf):
        return jfs.fused_rk_step(tab, tuple(ctrl.path.coeffs), ctrl.path.ts, args[0], y,
                                 args[2], f0, vf)

    with pltpu.force_tpu_interpret_mode():
        outs = f(args[1], args[3], s["vf_j"])
        if not with_grads:
            return [np.asarray(o) for o in outs], None

        def loss(y, f0, vf):
            return sum(jnp.sum(o * w[0]) for o, w in zip(f(y, f0, vf), s["W"]))

        gy, gf0, gvf = jax.grad(loss, argnums=(0, 1, 2))(args[1], args[3], s["vf_j"])
    grads = {"y": np.asarray(gy), "f0": np.asarray(gf0)}
    grads.update({k.replace("/", "."): v for k, v in jax_leaves(gvf).items()})
    return [np.asarray(o) for o in outs], grads


def test_fused_step_matches_jax_kernel_interpret(megakernel):
    s = _setup(B=1)
    before = tfs.fused_step_call.launches
    got, _ = _port_step(s, get_tableau("tsit5"))
    assert tfs.fused_step_call.launches == before  # CPU: the plain version
    ref, _ = _jax_fused(s)
    for a, b in zip(got, ref):
        _close(a[0], b, 1e-5)


def test_fused_step_grads_match_jax_kernel_interpret(megakernel):
    s = _setup(B=1, seed=1)
    _, got = _port_step(s, get_tableau("tsit5"), with_grads=True)
    _, ref = _jax_fused(s, with_grads=True)
    assert set(got) == set(ref)
    for k, g in got.items():
        _close(g[0] if k in ("y", "f0") else g, ref[k], 1e-4)


@pytest.mark.parametrize("method", ["Dopri5", "Bosh3"])
def test_fused_step_matches_jax_dense_rk_step(megakernel, method):
    """Dopri5 and Bosh3 through the port's hook (the step's plain version)
    against the JAX solver's per-stage step on the dense backend, per
    element (vmapped), the finished element included."""
    s = _setup(B=3, seed=2)
    got, _ = _port_step(s, get_tableau(method))
    jops.set_fusion_backend("dense")
    try:
        tab = jtab.get_tableau(method)
        vf = s["vf_j"]

        def one(ts, coeffs, t, y, h, f0):
            return jsolve._rk_step(tab, vf, t, y, h, JMatrixControl(JCubic(ts, coeffs)), f0)

        ref = jax.vmap(one)(jnp.asarray(s["ts"]), s["coeffs_j"], jnp.asarray(s["t"]),
                            jnp.asarray(s["y"]), jnp.asarray(s["h"]), jnp.asarray(s["f0"]))
    finally:
        jops.set_fusion_backend("auto")
    for a, b in zip(got, ref):
        _close(a, b, 1e-5)


def test_hook_returns_none_where_jax_does(megakernel):
    """The hook's None conditions: enc_idx, the flag off, a backend other
    than megakernel, n above MEGAKERNEL_MAX_N, and a stack that does not map
    the state width to itself. The flag on otherwise runs the fused step."""
    s = _setup(B=2, seed=3)
    tab = get_tableau("tsit5")
    t, h = torch.tensor(s["t"]), torch.tensor(s["h"])
    y, f0 = torch.tensor(s["y"]), torch.tensor(s["f0"])
    hook = s["vf_t"].fused_rk_step
    assert hook(tab, t, y, h, s["ctrl"], f0) is not None
    ops.set_fused_step(False)
    assert hook(tab, t, y, h, s["ctrl"], f0) is None
    ops.set_fused_step(True)
    for name in ("dense", "decomposed", "pipeline", "pallas"):
        ops.set_fusion_backend(name)
        assert hook(tab, t, y, h, s["ctrl"], f0) is None
    ops.set_fusion_backend("megakernel")
    big = torch.zeros(2, 641, H)  # the hook looks at the shape before any plane
    assert hook(tab, t, big, h, s["ctrl"], big) is None
    g = torch.Generator().manual_seed(0)
    wide = TVF(H, H, 2 * H, L, 1, N, generator=g)
    assert wide.fused_rk_step(tab, t, y, h, s["ctrl"], f0) is None
    enc = TVF(H, H, H, L, 1, N, enc_idx=True, enc_type="emb", idx_dim=4, generator=g)
    assert enc.fused_rk_step(tab, t, y, h, s["ctrl"], f0) is None


def test_tableau_name_collision_raises():
    tab = get_tableau("bosh3")
    tfs._register(tab)
    other = ButcherTableau(name="bosh3", c=tab.c, a=tab.a, b=tab.b,
                           b_err=tuple(2 * x for x in tab.b_err), order=tab.order,
                           error_order=tab.error_order, fsal=True)
    with pytest.raises(ValueError, match="already registered"):
        tfs._register(other)


def test_adaptive_solve_with_fused_step_matches_per_stage(megakernel, monkeypatch):
    """A Tsit5 + PID solve under the checkpointed adjoint with the flag on
    (one fused step per attempt) against the flag off: trajectory, step
    counts and the gradients of a loss (rtol 1e-5 and 1e-4)."""
    s = _setup(B=2, seed=4)
    ts = torch.as_tensor(s["ts"])
    steps = []
    real = tfs.fused_rk_step
    monkeypatch.setattr(tfs, "fused_rk_step", lambda *a: steps.append(1) or real(*a))

    def solve():
        vf = s["vf_t"]
        vf.zero_grad(set_to_none=True)
        y0 = torch.tensor(s["y"], requires_grad=True)
        sol = diffeqsolve(ODETerm(vf), "Tsit5", t0=ts[:, 0], t1=ts[:, -1], dt0=None,
                          y0=y0, args=s["ctrl"], stepsize_controller=PIDController(),
                          saveat=SaveAt(ts=ts), max_steps=64, adjoint="checkpointed")
        (sol.ys * torch.tensor(s["W"][0])[:, None]).sum().backward()
        return sol, [y0.grad] + [p.grad for p in vf.parameters()]

    before = tfs.fused_step_call.launches
    on, g_on = solve()
    taken = len(steps)
    ops.set_fused_step(False)
    off, g_off = solve()
    assert tfs.fused_step_call.launches == before  # CPU: plain versions only
    # Every attempt went through the hook (twice under the checkpoint), none
    # with the flag off.
    attempts = int((off.stats["num_accepted_steps"] + off.stats["num_rejected_steps"]).max())
    assert taken >= attempts > 0 and len(steps) == taken
    for k in ("num_accepted_steps", "num_rejected_steps"):
        assert torch.equal(on.stats[k], off.stats[k])
    _close(on.ys.detach(), off.ys.detach(), 1e-5)
    for a, b in zip(g_on, g_off):
        _close(a, b, 1e-4)
