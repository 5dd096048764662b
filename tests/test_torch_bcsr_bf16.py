"""BCSR controls stored in bf16 (``bcsr_control_from_edge_snapshots(dtype=
bfloat16)``, as ``benchmarks/bcsr_scale.py`` builds its n=32768 control)
against the JAX package on the CPU.

The bf16 is only how the Hermite coefficient tiles are stored. Both packages
evaluate a tile as ``((d tau + c) tau + b) tau + a`` with a float32 ``tau``
that carries dimensions (JAX: ``interp/bcsr_paths.py``; the port:
``interp/paths.py`` ``_bcast``), so bf16 x f32 promotes to float32 in both, and
the tiles that reach the BCSR kernels K8/K9 are float32 (the port's wrappers
refuse anything else). So no bf16 variant of K8 or K9 exists to port. Here:
``evaluate`` and ``derivative`` of the two controls agree to 1e-7 of their
scale (the same f32 arithmetic on the same bf16 values) and are float32, and
one perm-equiv field eval through the BCSR route agrees with JAX's within
1e-5 (f32 sums in another order).
"""

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from gncde_tpu.interp import bcsr_control_from_edge_snapshots as j_from_edges
from gncde_tpu.models.vector_fields import PermEquivGraphVectorField as JVF
from gncde_tpu_torch.interp import bcsr_control_from_edge_snapshots as t_from_edges
from gncde_tpu_torch.models.vector_fields import PermEquivGraphVectorField as TVF

from torch_parity_utils import copy_jax_to_torch

N, BS, BAND, T, H = 96, 32, 4, 3, 6
TQ = (0.15, 0.6, 0.95)


def _snapshots(seed=0):
    """A circular +-BAND band, new weights at every knot."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(N), 2 * BAND + 1)
    dst = (src + np.tile(np.arange(-BAND, BAND + 1), N)) % N
    return [(src, dst, rng.uniform(0.05, 0.2, src.size).astype(np.float32))
            for _ in range(T)]


@pytest.fixture(scope="module")
def controls():
    ts = np.linspace(0.0, 1.0, T).astype(np.float32)
    snaps = _snapshots()
    return (t_from_edges(ts, snaps, N, BS, dtype=torch.bfloat16),
            j_from_edges(jnp.asarray(ts), snaps, N, block_size=BS, dtype=jnp.bfloat16))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def test_bf16_storage_is_bf16_on_both_sides(controls):
    got, ref = controls
    for c in (*got.path.coeffs, *got.path.coeffs_T):
        assert c.dtype == torch.bfloat16
    for c in (*ref.path.coeffs, *ref.path.coeffs_T):
        assert c.dtype == jnp.bfloat16
    for a, b in zip((*got.path.coeffs, *got.path.coeffs_T),
                    (*ref.path.coeffs, *ref.path.coeffs_T)):
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))


@pytest.mark.parametrize("which", ["evaluate", "derivative"])
def test_bf16_tiles_evaluate_to_float32_as_in_jax(controls, which):
    got, ref = controls
    for tq in TQ:
        v, r = getattr(got.path, which)(torch.tensor(tq)), getattr(ref.path, which)(tq)
        for a, b in ((v.blocks, r.blocks), (v.blocks_T, r.blocks_T)):
            assert a.dtype == torch.float32 and b.dtype == jnp.float32
            assert _rel(a.numpy(), b) <= 1e-7


def test_field_through_bf16_bcsr_control_matches_jax(controls):
    got, ref = controls
    rng = np.random.default_rng(1)
    vf_j = JVF(input_dim=H, hidden_dim=H, output_dim=H, num_layers=2, data_embed_dim=1,
               num_nodes=N, key=jr.PRNGKey(4))
    vf_t = TVF(H, H, H, 2, 1, N, generator=torch.Generator().manual_seed(0))
    copy_jax_to_torch(vf_j, vf_t)
    Z = rng.normal(size=(N, H)).astype(np.float32)
    with torch.no_grad():
        out = vf_t(torch.tensor([0.37]), torch.tensor(Z)[None], got)[0]
    assert _rel(out.numpy(), vf_j(jnp.float32(0.37), jnp.asarray(Z), ref)) <= 1e-5
