"""The slice as a whole: training steps of the port's trainer step against
the JAX ``make_step_fn`` (gncde_tpu/train/trainer.py), from the same heat
data (the flagship dataset block cut to n=9) and a copied initialisation:
Tsit5 + PID solve under the checkpointed adjoint, MSE, and the flagship
optimiser (AdamW lr 0.1, weight decay 1e-4, clip by global norm 1.0).

Three free-running steps, losses and the logged max_grad within rtol 1e-3,
run in float64 (JAX with x64 switched on for the test) on a static grid.
Why not float32 on the dynamic graph for a free run: the adaptive
controller amplifies last-bit differences. In float32 the embedded error
estimate is a cancellation of nearly equal stage sums, so XLA and torch
rounding move step sizes and can flip accept/reject decisions; on the
dynamic graph the controller thrashes at the graph events (runs of
rejections), and there even float64 rounding grows into ~1e-3 differences
of the trajectory. Either way the two solves are equally valid
discretisations whose gradients differ in the last digits, and AdamW's
first update at lr 0.1, ``lr * g / (|g| + eps)``, turns a sign difference
in any near-zero gradient component into a 0.2 parameter difference: after
one such update the two runs train different parameters (at n=9, float32,
the free runs' third losses are 1.48 and 0.64).

So on the flagship (dynamic, float32) data the three steps are held with
the parameters synced: after each step the JAX step's updated parameters
are copied into the port's model, so every step's loss and max_grad are
computed by both sides at the same parameters, and held within rtol 1e-3
(the largest difference seen is 6e-4, from the f32 step placement above).

Run as a script, the module compares the two trainers on the flagship
config itself, from the JAX trainer's own data and initialisation, and
prints each side's losses, free-running and synced::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_trainer.py --num-nodes 400
"""

import argparse
import json
import os
import sys
import tempfile

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from gncde_tpu.configs import MSELossCfg as JMSE, OptimiserCfg as JOpt
from gncde_tpu.data import ode_dataset as jds
from gncde_tpu.data import pipeline as jpipe
from gncde_tpu.models.continuous import GraphNeuralCDE as JGNCDE, make_control as j_make_control
from gncde_tpu.models.vector_fields import PermEquivGraphVectorField as JVF
from gncde_tpu.nn import is_inexact_array, partition
from gncde_tpu.train.trainer import make_step_fn as j_make_step_fn
from gncde_tpu_torch.configs import MSELossCfg, OptimiserCfg
from gncde_tpu_torch.models import GraphNeuralCDE, make_control
from gncde_tpu_torch.models.vector_fields import PermEquivGraphVectorField as TVF
from gncde_tpu_torch.train.trainer import make_step_fn

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_parity_utils import copy_jax_to_torch  # noqa: E402

H, STEPS = 16, 3
OPT = dict(name="adamw", weight_decay=1e-4, gradient_clipping=True,
           schedule=dict(name="constant_schedule", value=0.1))
FLAGSHIP = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                        "configs", "dyn", "perm_equiv_gncde.yaml")


def _data(dynamic: bool):
    spec = jds.ODEDatasetSpec(name="heat", batch_size=2, dynamic_graph=dynamic,
                              all_dynamic=True, num_nodes=9, time_tick=8,
                              method="Tsit5", amp_range=(1.0, 1.0), seed=1234)
    return jpipe.get_split_train_data(spec, jds.generate(spec), "cubic")


def _small_models():
    model_j = JGNCDE(JVF(input_dim=H, hidden_dim=H, output_dim=H, num_layers=2,
                         data_embed_dim=16, num_nodes=0, key=jr.PRNGKey(1)),
                     hidden_dim=H, interpolation="cubic", method="Tsit5",
                     max_steps=64, adjoint="checkpointed", key=jr.PRNGKey(2))
    g = torch.Generator().manual_seed(0)
    model_t = GraphNeuralCDE(TVF(H, H, H, 2, 16, 0, generator=g), H, "cubic",
                             method="Tsit5", max_steps=64, adjoint="checkpointed",
                             generator=g)
    return model_j, model_t


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _run(d, dtype, steps, sync=False, models=_small_models):
    """``steps`` training steps on both sides from a copied init; returns
    {"jax"|"torch": (losses, max_grads)}. With ``sync`` the JAX step's
    updated parameters are copied into the port's model after each step."""
    model_j, model_t = models()
    cast = lambda x: jnp.asarray(np.asarray(x, np.float32), dtype)  # noqa: E731
    model_j = jax.tree_util.tree_map(cast, model_j)
    copy_jax_to_torch(model_j, model_t)
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    model_t.to(tdtype)

    # JAX: the trainer's jitted step on the vmapped loss.
    opt_j, _ = JOpt(**OPT).build()
    opt_state = opt_j.init(partition(model_j, is_inexact_array)[0])
    step_j = j_make_step_fn(opt_j, JMSE(name="MSE").build())
    coeffs = tuple(cast(c) for c in d["train_graph_path_coeffs"])
    ctrl_j = j_make_control("cubic", cast(d["train_t"]), coeffs, slim=True)
    data_j = (cast(d["train_t"]), ctrl_j, cast(d["train_true_y"]), cast(d["true_y0"]))

    # Port: the same step on the batched model.
    opt_t, schedule = OptimiserCfg.from_dict(OPT).build(model_t.parameters())
    step_t = make_step_fn(opt_t, schedule, MSELossCfg(name="MSE").build(), True)
    t = lambda x: torch.tensor(np.asarray(x), dtype=tdtype)  # noqa: E731
    ctrl_t = make_control("cubic", t(d["train_t"]),
                          tuple(t(c) for c in d["train_graph_path_coeffs"]))
    data_t = (t(d["train_t"]), ctrl_t, t(d["train_true_y"]), t(d["true_y0"]))
    assert data_t[0].shape[0] == data_j[0].shape[0]

    out = {"jax": ([], []), "torch": ([], [])}
    for _ in range(steps):
        lj, model_j, opt_state, gj, _ = step_j(model_j, opt_state, data_j)
        lt, gt, _ = step_t(model_t, data_t)
        for key, (l_, g_) in (("jax", (lj, gj)), ("torch", (lt, gt))):
            out[key][0].append(float(l_))
            out[key][1].append(float(g_))
        if sync:
            copy_jax_to_torch(model_j, model_t)
    return out


def test_three_train_steps_track_jax(x64):
    out = _run(_data(dynamic=False), np.float64, STEPS)
    losses_t, grads_t = out["torch"]
    losses_j, grads_j = out["jax"]
    assert all(np.isfinite(losses_t))
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-3)
    # max_grad is logged from the unclipped grads on both sides.
    np.testing.assert_allclose(grads_t, grads_j, rtol=1e-3)
    assert len(set(losses_t)) == STEPS  # the optimiser moved the parameters


def test_float32_flagship_data_three_synced_steps_match():
    out = _run(_data(dynamic=True), np.float32, STEPS, sync=True)
    losses_t, grads_t = out["torch"]
    assert all(np.isfinite(losses_t)) and len(set(losses_t)) == STEPS
    np.testing.assert_allclose(losses_t, out["jax"][0], rtol=1e-3)
    np.testing.assert_allclose(grads_t, out["jax"][1], rtol=1e-3)


def _flagship(num_nodes: int, steps: int, dtype):
    """Both trainers on configs/dyn/perm_equiv_gncde.yaml (cut to
    ``num_nodes``), from the JAX trainer's own data and initialisation
    (its key split of ``seed``), free-running and synced, in ``dtype``."""
    import yaml

    from gncde_tpu.configs import GraphNeuralCDECfg as JModelCfg
    from gncde_tpu.configs import ODEDataSetCfg as JDataCfg
    from gncde_tpu_torch.configs import GraphNeuralCDECfg

    with open(FLAGSHIP) as f:
        cfg = yaml.safe_load(f)
    assert cfg["optimiser"] == OPT  # _run builds both optimisers from OPT
    data_key, _, _, model_key, _ = jr.split(jr.PRNGKey(cfg["seed"]), 5)
    with tempfile.TemporaryDirectory() as tmp:
        cfg["dataset"].update(num_nodes=num_nodes, cache_dir=tmp)
        d = JDataCfg(**cfg["dataset"]).get_training_data(data_key)

    def models():
        return (JModelCfg(**cfg["model"]).build(model_key),
                GraphNeuralCDECfg.from_dict(cfg["model"]).build(
                    torch.Generator().manual_seed(0)))

    for sync in (False, True):
        out = _run(d, dtype, steps, sync=sync, models=models)
        print(json.dumps({"num_nodes": num_nodes, "dtype": np.dtype(dtype).name,
                          "synced": sync,
                          "jax_losses": out["jax"][0], "torch_losses": out["torch"][0],
                          "jax_max_grad": out["jax"][1],
                          "torch_max_grad": out["torch"][1]}), flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="flagship trainer comparison")
    ap.add_argument("--num-nodes", type=int, default=400)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    args = ap.parse_args()
    jax.config.update("jax_enable_x64", args.dtype == "float64")
    _flagship(args.num_nodes, args.steps, np.dtype(args.dtype).type)
