"""The dyn trainer's ``sparse_control`` (ELL and BCSR) against the JAX
package, on the trainer's own data pipeline: the vector field and its
gradients through each package's sparse control on the dynamic graph (graph
events, per-element patterns), and synced trainer steps, the port's against
the JAX ``make_step_fn``, with sparse controls built by each package's
``build_sparse_control`` from the same coefficients and a copied
initialisation. Losses and max_grad within rtol 1e-3, as in
``tests/test_torch_trainer.py``. The ops, controls and the vector field on
synthetic paths are held in ``tests/test_torch_sparse.py``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from gncde_tpu import interp as jinterp
from gncde_tpu_torch import interp as tinterp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_parity_utils import copy_jax_to_torch  # noqa: E402


def _dyn_data(**spec_kw):
    from gncde_tpu_torch.data import ode_dataset as tds
    from gncde_tpu_torch.data import pipeline as tpipe

    spec = tds.ODEDatasetSpec(name="heat", batch_size=2, num_nodes=9, method="Tsit5",
                              seed=1234, **spec_kw)
    return tpipe.get_split_train_data(spec, tds.generate(spec), "cubic")


@pytest.mark.parametrize("fmt", ["ell", "bcsr"])
def test_dyn_graph_field_and_grads_track_jax(fmt):
    """The field through each package's sparse control on the dynamic graph,
    without the adaptive controller: ``sum(f(t_k, Z_k) * W_k)`` over five
    times per element spread across the window (graph events between them),
    its value and the gradients with respect to Z and every field
    parameter, within rtol 1e-3 of the JAX package's (f32).

    The JAX package's e2e setting (``tests/test_sparse_model.py``: grid,
    num_nodes 9, batch 2, time_tick 10, irregular, all_dynamic,
    ``sparse_block_size`` 4) with ``event_p`` 0.05 instead of 0.001, so the
    two elements' union patterns differ: ELL row degrees differ, and one
    element's BCSR block rows have padded slots where the other's have none.
    """
    from gncde_tpu.models.vector_fields import PermEquivGraphVectorField as JVF
    from gncde_tpu_torch.models.vector_fields import PermEquivGraphVectorField as TVF

    d = _dyn_data(dynamic_graph=True, all_dynamic=True, graph_type="grid",
                  final_time=1.0, time_tick=10, sampling_type="irregular", dt0=0.05,
                  event_p=0.05)
    ts = np.asarray(d["train_t"], np.float32)
    coeffs = tuple(np.asarray(c, np.float32) for c in d["train_graph_path_coeffs"])
    kw = dict(sparse_format=fmt, block_size=4)
    ctrl_j = jinterp.build_sparse_control("cubic", jnp.asarray(ts),
                                          tuple(map(jnp.asarray, coeffs)), **kw)
    ctrl_t = tinterp.build_sparse_control("cubic", ts, coeffs, **kw)
    if fmt == "bcsr":
        nblocks = ctrl_t.path.layout.nblocks
        assert not torch.equal(nblocks[0], nblocks[1]) and bool((nblocks < 3).any())
    else:
        degree = (ctrl_t.path.indices < 9).sum(-1)
        assert not torch.equal(degree[0], degree[1])

    H, B, n = 4, 2, 9
    vf_j = JVF(input_dim=H, hidden_dim=H, output_dim=H, num_layers=2, data_embed_dim=16,
               num_nodes=0, key=jr.PRNGKey(1))
    vf_t = TVF(H, H, H, 2, 16, 0, generator=torch.Generator().manual_seed(0))
    copy_jax_to_torch(vf_j, vf_t)
    rng = np.random.default_rng(3)
    frac = np.array([0.1, 0.3, 0.5, 0.7, 0.9], np.float32)[:, None]
    tq = (ts[:, 0] + frac * (ts[:, -1] - ts[:, 0])).astype(np.float32)  # (5, B)
    Z = rng.normal(size=(len(frac), B, n, H)).astype(np.float32)
    W = rng.normal(size=Z.shape).astype(np.float32)

    Zt = torch.tensor(Z, requires_grad=True)
    loss_t = sum((vf_t(torch.tensor(tq[k]), Zt[k], ctrl_t) * torch.tensor(W[k])).sum()
                 for k in range(len(frac)))
    loss_t.backward()

    @jax.jit
    def loss_j(v, Z_):
        out = [jax.vmap(lambda c, t, z: v(t, z, c))(ctrl_j, tq[k], Z_[k])
               for k in range(len(frac))]
        return jnp.sum(jnp.stack(out) * W)

    ref, (g_vf, g_Z) = jax.value_and_grad(loss_j, argnums=(0, 1))(vf_j, jnp.asarray(Z))
    np.testing.assert_allclose(float(loss_t.detach()), float(ref), rtol=1e-3)
    np.testing.assert_allclose(Zt.grad.numpy(), np.asarray(g_Z), rtol=1e-3,
                               atol=1e-3 * float(np.abs(g_Z).max()))
    vf_g = TVF(H, H, H, 2, 16, 0, generator=torch.Generator().manual_seed(0))
    copy_jax_to_torch(g_vf, vf_g)
    grads_t = dict(vf_t.named_parameters())
    for k, p in vf_g.named_parameters():
        ref_g = p.detach().numpy()
        np.testing.assert_allclose(grads_t[k].grad.numpy(), ref_g, rtol=1e-3,
                                   atol=1e-3 * float(np.abs(ref_g).max()), err_msg=k)


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("fmt", ["ell", "bcsr"])
def test_dyn_trainer_sparse_steps_track_jax(fmt, x64):
    """Two steps of the port's trainer step against the JAX one with
    ``sparse_control`` (num_nodes 9, batch 2, ``sparse_block_size`` 4, Tsit5,
    max_steps 64: the JAX package's own e2e setting), parameters synced after
    each step: losses and max_grad within rtol 1e-3.

    In float64 on a static grid, as ``tests/test_torch_trainer.py``'s free
    run and for the same reason: the adaptive controller turns last-bit
    differences into ~1e-3 step-placement differences, and on the dynamic
    graph's reject storms into more. Both packages' BCSR ops round their
    operands to float32 (``bcsr_spmm_xla``), so on the dynamic graph BCSR
    parts by 1e-2 after one step even in float64, while ELL holds 1e-5.
    The data comes from the port's generator (the same arrays go to both).
    """
    from gncde_tpu.configs import MSELossCfg as JMSE, OptimiserCfg as JOpt
    from gncde_tpu.models.continuous import GraphNeuralCDE as JGNCDE
    from gncde_tpu.models.vector_fields import PermEquivGraphVectorField as JVF
    from gncde_tpu.nn import is_inexact_array, partition
    from gncde_tpu.train.trainer import make_step_fn as j_make_step_fn
    from gncde_tpu_torch.configs import MSELossCfg, OptimiserCfg
    from gncde_tpu_torch.data import ode_dataset as tds
    from gncde_tpu_torch.data import pipeline as tpipe
    from gncde_tpu_torch.models import GraphNeuralCDE
    from gncde_tpu_torch.models.vector_fields import PermEquivGraphVectorField as TVF
    from gncde_tpu_torch.train.trainer import make_step_fn

    H = 4
    opt = dict(name="adamw", weight_decay=1e-4, gradient_clipping=True,
               schedule=dict(name="constant_schedule", value=1e-2))
    spec = tds.ODEDatasetSpec(name="heat", batch_size=2, dynamic_graph=False,
                              num_nodes=9, time_tick=8, method="Tsit5",
                              amp_range=(1.0, 1.0), seed=1234)
    d = tpipe.get_split_train_data(spec, tds.generate(spec), "cubic")
    f64 = lambda x: np.asarray(x, np.float64)  # noqa: E731
    ts, y, y0 = f64(d["train_t"]), f64(d["train_true_y"]), f64(d["true_y0"])
    coeffs = tuple(f64(c) for c in d["train_graph_path_coeffs"])
    kw = dict(sparse_format=fmt, block_size=4)
    ctrl_j = jinterp.build_sparse_control("cubic", jnp.asarray(ts),
                                          tuple(map(jnp.asarray, coeffs)), **kw)
    ctrl_t = tinterp.build_sparse_control("cubic", ts, coeffs, **kw)
    model_j = JGNCDE(JVF(input_dim=H, hidden_dim=H, output_dim=H, num_layers=2,
                         data_embed_dim=16, num_nodes=0, key=jr.PRNGKey(1)),
                     hidden_dim=H, interpolation="cubic", method="Tsit5", max_steps=64,
                     adjoint="checkpointed", key=jr.PRNGKey(2))
    model_j = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float64) if jnp.issubdtype(x.dtype, jnp.floating) else x,
        model_j)
    g = torch.Generator().manual_seed(0)
    model_t = GraphNeuralCDE(TVF(H, H, H, 2, 16, 0, generator=g), H, "cubic",
                             method="Tsit5", max_steps=64, adjoint="checkpointed",
                             generator=g)
    copy_jax_to_torch(model_j, model_t)
    model_t.double()
    opt_j, _ = JOpt(**opt).build()
    opt_state = opt_j.init(partition(model_j, is_inexact_array)[0])
    step_j = j_make_step_fn(opt_j, JMSE(name="MSE").build())
    opt_t, schedule = OptimiserCfg.from_dict(opt).build(model_t.parameters())
    step_t = make_step_fn(opt_t, schedule, MSELossCfg(name="MSE").build(), True)
    data_j = (jnp.asarray(ts), ctrl_j, jnp.asarray(y), jnp.asarray(y0))
    data_t = (torch.tensor(ts), ctrl_t, torch.tensor(y), torch.tensor(y0))
    out = {"jax": ([], []), "torch": ([], [])}
    for _ in range(2):
        lj, model_j, opt_state, gj, _ = step_j(model_j, opt_state, data_j)
        lt, gt, _ = step_t(model_t, data_t)
        for key, (l_, g_) in (("jax", (lj, gj)), ("torch", (lt, gt))):
            out[key][0].append(float(l_))
            out[key][1].append(float(g_))
        copy_jax_to_torch(model_j, model_t)
    losses_t, grads_t = out["torch"]
    assert all(np.isfinite(losses_t)) and len(set(losses_t)) == 2
    np.testing.assert_allclose(losses_t, out["jax"][0], rtol=1e-3)
    np.testing.assert_allclose(grads_t, out["jax"][1], rtol=1e-3)
