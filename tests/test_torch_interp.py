"""Port parity: gncde_tpu_torch.interp against gncde_tpu.interp.

Tolerance atol 1e-6 with rtol 1e-6: float32 on both sides; the Hermite
coefficients divide by h and h^2 (h ~ 0.1..0.3), so entries reach O(100)
and their last-bit rounding is relative, not absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gncde_tpu import interp as jinterp
from gncde_tpu_torch import interp as tinterp

TOL = dict(atol=1e-6, rtol=1e-6)


def _series(seed=0, T=9, n=4, nan_frac=0.0, repeat=False):
    rng = np.random.default_rng(seed)
    ts = np.cumsum(rng.uniform(0.1, 0.3, T)).astype(np.float32)
    ts -= ts[0]
    if repeat:  # repeated knots, as pad-to-max window batching produces
        ts[-2:] = ts[-3]
    ys = rng.normal(size=(T, n, n)).astype(np.float32)
    if nan_frac:
        ys[rng.uniform(size=ys.shape) < nan_frac] = np.nan
        ys[:, 0, 0] = np.nan  # an all-missing channel
    return ts, ys


@pytest.mark.parametrize("nan_frac", [0.0, 0.3])
def test_fill_nan_and_linear_coeffs(nan_frac):
    ts, ys = _series(seed=1, nan_frac=nan_frac)
    ref = np.asarray(jinterp.linear_interpolation(jnp.asarray(ts), jnp.asarray(ys)))
    got = tinterp.linear_interpolation(torch.as_tensor(ts), torch.as_tensor(ys)).numpy()
    np.testing.assert_allclose(got, ref, equal_nan=True, **TOL)


@pytest.mark.parametrize("nan_frac,repeat", [(0.0, False), (0.2, False), (0.0, True)])
def test_backward_hermite_coefficients(nan_frac, repeat):
    ts, ys = _series(seed=2, nan_frac=nan_frac, repeat=repeat)
    ref = jinterp.backward_hermite_coefficients(jnp.asarray(ts), jnp.asarray(ys))
    got = tinterp.backward_hermite_coefficients(torch.as_tensor(ts), torch.as_tensor(ys))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), equal_nan=True, **TOL)


def test_batched_coefficients_match_vmap():
    rng = np.random.default_rng(3)
    B, T, n = 3, 7, 3
    ts = np.stack([_series(seed=10 + b, T=T)[0] for b in range(B)])
    ys = rng.normal(size=(B, T, n, n, 2)).astype(np.float32)
    ref = jax.vmap(jinterp.backward_hermite_coefficients)(jnp.asarray(ts), jnp.asarray(ys))
    got = tinterp.backward_hermite_coefficients(torch.as_tensor(ts), torch.as_tensor(ys))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("kind", ["linear", "cubic"])
def test_paths_evaluate_and_derivative_batched(kind):
    """Per-element knots (B, T) evaluated at per-element t (B,), against the
    JAX path vmapped over the batch -- including t on a knot, before the
    first knot and past the last one."""
    B, T, n = 4, 8, 3
    ts = np.stack([_series(seed=20 + b, T=T, repeat=(kind == "linear" and b == 0))[0]
                   for b in range(B)])
    ys = np.random.default_rng(4).normal(size=(B, T, n, n)).astype(np.float32)
    if kind == "linear":
        jpath = lambda t_, y_: jinterp.LinearInterpolation(t_, y_)  # noqa: E731
        tpath = tinterp.LinearInterpolation(torch.as_tensor(ts), torch.as_tensor(ys))
        jcoef = jnp.asarray(ys)
    else:
        jcoef = jax.vmap(jinterp.backward_hermite_coefficients)(jnp.asarray(ts),
                                                               jnp.asarray(ys))
        jpath = lambda t_, c_: jinterp.CubicInterpolation(t_, c_)  # noqa: E731
        tpath = tinterp.CubicInterpolation(
            torch.as_tensor(ts),
            tinterp.backward_hermite_coefficients(torch.as_tensor(ts), torch.as_tensor(ys)))
    for q in (ts[:, 3] + 0.05, ts[:, 2], ts[:, -1], ts[:, 0] - 0.1, ts[:, -1] + 0.2):
        q = q.astype(np.float32)
        for meth in ("evaluate", "derivative"):
            ref = jax.vmap(lambda t_, c_, s_: getattr(jpath(t_, c_), meth)(s_))(
                jnp.asarray(ts), jcoef, jnp.asarray(q))
            got = getattr(tpath, meth)(torch.as_tensor(q)).numpy()
            np.testing.assert_allclose(got, np.asarray(ref), **TOL)


def test_matrix_control_slims_the_value_channel():
    B, T, n = 2, 6, 3
    rng = np.random.default_rng(5)
    ts = np.stack([_series(seed=30 + b, T=T)[0] for b in range(B)])
    X = rng.normal(size=(B, T, n, n, 2)).astype(np.float32)
    coeffs = tinterp.backward_hermite_coefficients(torch.as_tensor(ts), torch.as_tensor(X))
    ctrl = tinterp.MatrixControl.from_stacked("cubic", torch.as_tensor(ts), coeffs)
    assert ctrl.tgrad_is_unit and all(c.is_contiguous() for c in ctrl.path.coeffs)
    q = torch.as_tensor(ts[:, 2] + 0.01)
    jc = jax.vmap(jinterp.backward_hermite_coefficients)(jnp.asarray(ts), jnp.asarray(X))
    ref = jax.vmap(lambda t_, c_, s_: jinterp.MatrixControl.from_stacked(
        "cubic", t_, c_).adj(s_))(jnp.asarray(ts), jc, jnp.asarray(q.numpy()))
    np.testing.assert_allclose(ctrl.adj(q).numpy(), np.asarray(ref), **TOL)
