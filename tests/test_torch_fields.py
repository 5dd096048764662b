"""Port parity: PermEquivGraphVectorField value and gradients against the
JAX field (vmapped over per-element controls), with copied parameters, under
the port's ``dense`` backend and its ``megakernel`` backend (on CPU tensors
the K1/K2 autograd Function runs the kernels' plain versions). Also the
parameter exchange of nn/convert.py.

Tolerance rtol 1e-4 against each array's scale: float32 on both sides, the
gradients sum n^2 products in different orders.
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
from gncde_tpu.models.continuous import GraphNeuralCDE as JGNCDE
from gncde_tpu.models.vector_fields import PermEquivGraphVectorField as JVF
from gncde_tpu.nn import tree_serialise_leaves
from gncde_tpu_torch import ops
from gncde_tpu_torch.interp import CubicInterpolation, MatrixControl
from gncde_tpu_torch.models import GraphNeuralCDE
from gncde_tpu_torch.models.vector_fields import PermEquivGraphVectorField as TVF
from gncde_tpu_torch.nn import convert
from gncde_tpu_torch.ops import megakernel

from torch_parity_utils import copy_jax_to_torch, hermite_path, jax_leaves

N, H, L, B, T = 12, 6, 2, 3, 6


def _close(got, ref, rtol=1e-4):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-30))


@pytest.fixture
def backend():
    yield ops.set_fusion_backend
    ops.set_fusion_backend("auto")


@pytest.mark.parametrize("name", ["dense", "megakernel"])
def test_vector_field_value_and_grads(backend, name):
    rng = np.random.default_rng(0)
    ts, A = hermite_path(rng, B, T, N)
    t = (ts[:, 2] + 0.05).astype(np.float32)
    Z = rng.normal(size=(B, N, H)).astype(np.float32)
    coeffs_j = jax.vmap(j_bhc)(jnp.asarray(ts), jnp.asarray(A))
    vf_j = JVF(input_dim=H, hidden_dim=H, output_dim=H, num_layers=L,
               data_embed_dim=1, num_nodes=N, key=jr.PRNGKey(3))

    def jloss(vf, Zb):
        out = jax.vmap(lambda ts_, c_, t_, z_: vf(t_, z_, JMatrixControl(JCubic(ts_, c_))))(
            jnp.asarray(ts), coeffs_j, jnp.asarray(t), Zb)
        return jnp.sum(out ** 2), out

    (_, ref), (gvf, gZ) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        vf_j, jnp.asarray(Z))

    vf_t = TVF(H, H, H, L, 1, N, generator=torch.Generator().manual_seed(0))
    copy_jax_to_torch(vf_j, vf_t)
    ctrl = MatrixControl(CubicInterpolation(torch.as_tensor(ts),
                                            tuple(torch.tensor(np.asarray(c))
                                                  for c in coeffs_j)))
    backend(name)
    Zt = torch.as_tensor(Z).requires_grad_(True)
    out = vf_t(torch.as_tensor(t), Zt, ctrl)
    (out ** 2).sum().backward()

    _close(out.detach(), ref)
    _close(Zt.grad, gZ)
    jgrads = jax_leaves(gvf)
    for name_, p in vf_t.named_parameters():
        _close(p.grad, jgrads[name_.replace(".", "/")])


def test_megakernel_gate_refuses_large_n(backend, monkeypatch):
    """Above the megakernel cap (n > 640) K1 refuses the shape and the
    megakernel backend sends the field to the tiled regime
    (ops/tiled.py) instead of K1, or of silently running dense."""
    from gncde_tpu_torch.ops import tiled

    n = 641
    vf = TVF(4, 4, 4, 2, 1, n, generator=torch.Generator().manual_seed(0))
    ts = torch.tensor([[0.0, 1.0]])
    planes = tuple(torch.zeros(1, 1, n, n) for _ in range(4))
    layers = megakernel.layer_params(vf)
    with pytest.raises(ValueError, match="MEGAKERNEL_MAX_N"):
        megakernel._check_inputs(planes, torch.zeros(1, dtype=torch.long),
                                 torch.zeros(1), torch.zeros(1, n, 4), layers)
    calls = []
    real = tiled.tiled_vf_eval
    monkeypatch.setattr(tiled, "tiled_vf_eval",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(megakernel, "megakernel_vf",
                        lambda *a, **k: pytest.fail("K1 reached for n > 640"))
    backend("megakernel")
    out = vf(torch.tensor([0.5]), torch.zeros(1, n, 4),
             MatrixControl(CubicInterpolation(ts, planes)))
    assert calls == [1] and out.shape == (1, n, 4)


def test_convert_round_trips_jax_weights(tmp_path):
    """Leaf-path dict <-> state_dict, and the JAX save_weights npz (leaf_<i>
    in flatten order) loads into the port's parameter order."""
    vf_j = JVF(input_dim=H, hidden_dim=H, output_dim=H, num_layers=L,
               data_embed_dim=1, num_nodes=N, key=jr.PRNGKey(5))
    model_j = JGNCDE(vf_j, hidden_dim=H, interpolation="cubic", key=jr.PRNGKey(6))
    g = torch.Generator().manual_seed(1)
    model_t = GraphNeuralCDE(TVF(H, H, H, L, 1, N, generator=g), H, "cubic", generator=g)

    leaves = jax_leaves(model_j)
    assert list(leaves) == [k.replace(".", "/") for k, _ in model_t.named_parameters()]
    model_t.load_state_dict(convert.to_state_dict(leaves), strict=True)
    back = convert.from_state_dict(model_t.state_dict())
    for k, v in leaves.items():
        np.testing.assert_array_equal(back[k], v)

    path = str(tmp_path / "w.npz")
    tree_serialise_leaves(path, model_j)
    fresh = GraphNeuralCDE(TVF(H, H, H, L, 1, N, generator=g), H, "cubic", generator=g)
    convert.load_jax_npz(fresh, path)
    for (k, a), (_, b) in zip(fresh.named_parameters(), model_t.named_parameters()):
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy())
    convert.save_jax_npz(fresh, str(tmp_path / "w2.npz"))
    np.testing.assert_array_equal(np.load(str(tmp_path / "w2.npz"))["leaf_3"],
                                  np.load(path)["leaf_3"])
