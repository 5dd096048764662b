"""Port parity: gncde_tpu_torch.ops.equiv_basis against gncde_tpu.ops.equiv_basis.

Tolerance atol 1e-5 (and rtol 1e-5): both sides are float32 on the CPU, but
the row/column/global sums over n and the matmuls reduce in different
orders, so the last bits of O(1..10) entries differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gncde_tpu.ops import equiv_basis as jeb
from gncde_tpu_torch.ops import equiv_basis as teb

TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(directed, n=12, H=5, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.uniform(0, 1, (n, n)).astype(np.float32)
    dA = rng.normal(size=(n, n)).astype(np.float32)
    M = rng.normal(size=(n, H)).astype(np.float32)
    params = [rng.uniform(-1 / 15, 1 / 15, 2).astype(np.float32)
              for _ in range(11 if directed else 8)]
    return A, dA, M, params


def _j(params):
    return [jnp.asarray(p) for p in params]


def _t(params):
    return [torch.as_tensor(p) for p in params]


@pytest.mark.parametrize("directed", [False, True])
def test_fusion_matrix_dense(directed):
    A, dA, _, params = _inputs(directed)
    jf = jeb.fusion_matrix_dense_directed if directed else jeb.fusion_matrix_dense
    tf = teb.fusion_matrix_dense_directed if directed else teb.fusion_matrix_dense
    ref = np.asarray(jf(jnp.asarray(A), jnp.asarray(dA), _j(params)))
    got = tf(torch.as_tensor(A), torch.as_tensor(dA), _t(params)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("directed", [False, True])
def test_fused_coeffs(directed):
    A, dA, _, params = _inputs(directed, seed=1)
    jf = jeb.fused_coeffs_directed if directed else jeb.fused_coeffs
    tf = teb.fused_coeffs_directed if directed else teb.fused_coeffs
    ref = jf(jnp.asarray(A), jnp.asarray(dA), _j(params))
    got = tf(torch.as_tensor(A), torch.as_tensor(dA), _t(params))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("add_identity", [False, True])
def test_fused_apply_and_matvec(directed, add_identity):
    A, dA, M, params = _inputs(directed, seed=2)
    ref = np.asarray(jeb.fused_apply(jnp.asarray(A), jnp.asarray(dA), jnp.asarray(M),
                                     _j(params), directed=directed,
                                     add_identity=add_identity))
    got = teb.fused_apply(torch.as_tensor(A), torch.as_tensor(dA), torch.as_tensor(M),
                          _t(params), directed=directed, add_identity=add_identity)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    # The decomposition equals the materialised operator applied once.
    dense = (teb.fusion_matrix_dense_directed if directed else teb.fusion_matrix_dense)(
        torch.as_tensor(A), torch.as_tensor(dA), _t(params))
    want = dense @ torch.as_tensor(M) + (torch.as_tensor(M) if add_identity else 0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=1e-5)


def test_batched_parameters_broadcast():
    """A leading batch dim on A/dA and on every parameter (per-element
    parameters are how the plain K2 takes per-element gradients)."""
    rng = np.random.default_rng(3)
    B, n = 3, 7
    A = torch.as_tensor(rng.uniform(size=(B, n, n)).astype(np.float32))
    dA = torch.as_tensor(rng.normal(size=(B, n, n)).astype(np.float32))
    P = torch.as_tensor(rng.uniform(-0.1, 0.1, (B, 8, 2)).astype(np.float32))
    got = teb.fusion_matrix_dense(A, dA, [P[:, k] for k in range(8)])
    for b in range(B):
        ref = np.asarray(jeb.fusion_matrix_dense(
            jnp.asarray(A[b].numpy()), jnp.asarray(dA[b].numpy()),
            [jnp.asarray(P[b, k].numpy()) for k in range(8)]))
        np.testing.assert_allclose(got[b].numpy(), ref, **TOL)
