"""Port parity: the batched Tsit5 + PID solve against ``jax.vmap`` of the JAX
``diffeqsolve``, on the perm-equiv CDE vector field with per-element
irregular knots and copied parameters.

The adaptive comparison runs in float64 (JAX with x64 switched on for the
test): every element must take the same number of accepted and rejected
steps as its JAX counterpart, and the saved trajectory must agree within
rtol 1e-4 of its scale. In float32 the counts are not a fair check: the
embedded error estimate is a cancellation of nearly equal stage sums, so
last-bit differences in the vector field's reductions move the next step
size by ~1e-3 relative and can flip a later accept/reject decision (the
trainer test holds the float32 losses instead). The constant-step "none"
path (the dataset generator's solve) is compared in float32 within the
same rtol.
"""

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from gncde_tpu.interp import (
    CubicInterpolation as JCubic,
    MatrixControl as JMatrixControl,
    backward_hermite_coefficients as j_bhc,
)
from gncde_tpu.models.vector_fields import PermEquivGraphVectorField as JVF
from gncde_tpu.solve import (
    ConstantStepSize as JConst,
    ODETerm as JTerm,
    PIDController as JPID,
    SaveAt as JSaveAt,
    diffeqsolve as jsolve,
)
from gncde_tpu_torch.interp import CubicInterpolation, MatrixControl
from gncde_tpu_torch.models.vector_fields import PermEquivGraphVectorField as TVF
from gncde_tpu_torch.solve import (
    ConstantStepSize,
    ODETerm,
    PIDController,
    SaveAt,
    diffeqsolve,
)

from torch_parity_utils import copy_jax_to_torch, hermite_path, jax_leaves

N, H, B, T, MAX_STEPS = 8, 4, 3, 6, 64


def _close(got, ref, rtol=1e-4):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-30))


def _problem(dtype):
    rng = np.random.default_rng(7)
    ts, _ = hermite_path(rng, B, T, N)
    # A smooth adjacency path sampled at the knots (a rough one makes the
    # controller thrash at every knot and exhaust the step budget).
    A0, A1 = rng.uniform(0.0, 0.3, (2, 1, 1, N, N))
    A = A0 + np.sin(2.0 * ts)[:, :, None, None] * A1
    ts, A = ts.astype(dtype), A.astype(dtype)
    coeffs_j = jax.vmap(j_bhc)(jnp.asarray(ts), jnp.asarray(A))
    y0 = rng.normal(size=(B, N, H)).astype(dtype)
    vf_j = JVF(input_dim=H, hidden_dim=H, output_dim=H, num_layers=2,
               data_embed_dim=1, num_nodes=N, key=jr.PRNGKey(11))
    # The port holds float32 parameters: give JAX the same (rounded) values.
    vf_j = jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x, np.float32), dtype), vf_j)
    vf_t = TVF(H, H, H, 2, 1, N, generator=torch.Generator().manual_seed(0))
    copy_jax_to_torch(vf_j, vf_t)
    vf_t.to(torch.float64 if dtype == np.float64 else torch.float32)
    ctrl = MatrixControl(CubicInterpolation(
        torch.as_tensor(ts), tuple(torch.tensor(np.asarray(c)) for c in coeffs_j)))
    return dict(ts=ts, coeffs_j=coeffs_j, y0=y0, vf_j=vf_j, vf_t=vf_t, ctrl=ctrl)


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("adjoint", ["full", "checkpointed"])
def test_tsit5_pid_matches_vmapped_jax(x64, adjoint):
    p = _problem(np.float64)

    def one(vf, ts_, c_, y0_):
        sol = jsolve(JTerm(vf), "Tsit5", t0=ts_[0], t1=ts_[-1], dt0=None, y0=y0_,
                     args=JMatrixControl(JCubic(ts_, c_)),
                     stepsize_controller=JPID(rtol=1e-3, atol=1e-6),
                     saveat=JSaveAt(ts=ts_), max_steps=MAX_STEPS, adjoint=adjoint)
        return sol.ys, sol.stats["num_accepted_steps"], sol.stats["num_rejected_steps"]

    def jloss(vf, y0_):
        ys, acc, rej = jax.vmap(lambda a, b, c: one(vf, a, b, c))(
            jnp.asarray(p["ts"]), p["coeffs_j"], y0_)
        return jnp.sum(ys ** 2), (ys, acc, rej)

    (_, (ys_j, acc_j, rej_j)), (g_vf, g_y0) = jax.jit(
        jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        p["vf_j"], jnp.asarray(p["y0"]))

    ts = torch.as_tensor(p["ts"])
    y0 = torch.as_tensor(p["y0"]).requires_grad_(True)
    sol = diffeqsolve(ODETerm(p["vf_t"]), "Tsit5", t0=ts[:, 0], t1=ts[:, -1], dt0=None,
                      y0=y0, args=p["ctrl"],
                      stepsize_controller=PIDController(rtol=1e-3, atol=1e-6),
                      saveat=SaveAt(ts=ts), max_steps=MAX_STEPS, adjoint=adjoint)
    np.testing.assert_array_equal(sol.stats["num_accepted_steps"].numpy(), np.asarray(acc_j))
    np.testing.assert_array_equal(sol.stats["num_rejected_steps"].numpy(), np.asarray(rej_j))
    assert int(np.asarray(rej_j).sum()) > 0  # the controller really rejected steps
    _close(sol.ys.detach(), ys_j)
    # Gradients through the solve (RK stages + dense output; controller
    # decisions detached on both sides).
    p["vf_t"].zero_grad()
    sol.ys.square().sum().backward()
    _close(y0.grad, g_y0)
    jg = jax_leaves(g_vf)
    for name, prm in p["vf_t"].named_parameters():
        _close(prm.grad, jg[name.replace(".", "/")])


def test_constant_step_saved_solve_matches():
    """ConstantStepSize + adjoint="none" (the dataset generator's solve)."""
    p = _problem(np.float32)
    n_save = 9

    def one(ts_, c_, y0_):
        save = jnp.linspace(ts_[0], ts_[-1], n_save)
        sol = jsolve(JTerm(p["vf_j"]), "Dopri5", t0=ts_[0], t1=ts_[-1], dt0=0.05, y0=y0_,
                     args=JMatrixControl(JCubic(ts_, c_)),
                     stepsize_controller=JConst(), saveat=JSaveAt(ts=save),
                     max_steps=40, adjoint="none")
        return sol.ys

    ref = jax.jit(jax.vmap(one))(jnp.asarray(p["ts"]), p["coeffs_j"], jnp.asarray(p["y0"]))
    ts = torch.as_tensor(p["ts"])
    save = torch.stack([torch.linspace(float(a), float(b), n_save)
                        for a, b in zip(ts[:, 0], ts[:, -1])])
    sol = diffeqsolve(ODETerm(p["vf_t"]), "Dopri5", t0=ts[:, 0], t1=ts[:, -1], dt0=0.05,
                      y0=torch.as_tensor(p["y0"]), args=p["ctrl"],
                      stepsize_controller=ConstantStepSize(), saveat=SaveAt(ts=save),
                      max_steps=40, adjoint="none")
    _close(sol.ys, ref)
