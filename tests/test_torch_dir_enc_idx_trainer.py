"""Two parameter-synced TGBTrainer steps of a small directed enc_idx model
against the JAX window step, one step of it under bf16, and the directed
enc_idx trade config's CLI on the CPU. The JAX step's compile takes most of this file's time, so it
has a file of its own (as tests/test_torch_directed_trainer.py does).

The model: the directed field with enc_idx (``emb`` encoder, idx_dim 4),
hidden 4, 2 layers, E = 2, on a tiny TGB-format trade CSV (n = 12, 16
snapshots in windows of 3) at ``dt0=0.25``. The JAX model is built by
hand at H * E * 2 outputs: the JAX config gives a controlled enc_idx field
H outputs, which its CDE wrapper cannot reshape (ROADMAP Queue 3 item 3);
the port's config gives it H * E * 2, as every controlled field.

Each step starts both sides from the JAX parameters (copied in before the
step); the JAX step runs its dense path. The port runs its dense path and
its kernel route (K7, K6a, K6b: their plain versions on the CPU). Bounds,
those of ``test_tgb_enc_idx_train_step_matches_jax``: loss rtol 1e-4 on
both routes, the gradient norm rtol 1e-4 (dense) and 5e-4 (kernel route:
the rank-structured sums round otherwise than the dense basis matrices,
and the solve's RMSNorms amplify it).
"""

import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from gncde_tpu import ops as jops
from gncde_tpu.configs import OptimiserCfg as JOpt
from gncde_tpu.configs.dataset_configs import TGBDataSetCfg as JDataCfg
from gncde_tpu.models.tgb import TGBGraphNeuralCDE as JTGBModel
from gncde_tpu.models.vector_fields import PermEquivDirGraphVectorField as JDVF
from gncde_tpu.nn import is_inexact_array, partition
from gncde_tpu.train.windowed import TGBTrainer as JTrainer, make_window_step_fn
from gncde_tpu_torch import ops
from gncde_tpu_torch.configs import OptimiserCfg, TGBDataSetCfg, TGBGraphNeuralCDECfg
from gncde_tpu_torch.ops import modulate as tmod
from gncde_tpu_torch.ops import pair as tp
from gncde_tpu_torch.train import windowed
from gncde_tpu_torch.train.trainer import make_step_fn

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_parity_utils import copy_jax_to_torch  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
N, HID, E = 12, 4, 2
OPT = dict(name="adamw", weight_decay=1e-4, gradient_clipping=True,
           schedule=dict(name="constant_schedule", value=1e-2))


def _write_trade_csv(root, n_snap=10, seed=0):
    rng = np.random.default_rng(seed)
    rows = ["timestamp,source,destination,weight"]
    for t in range(n_snap):
        for _ in range(30):
            s, d = rng.integers(0, N, 2)
            rows.append(f"{t},{s},{d},{rng.uniform(0.1, 2.0):.4f}")
    (root / "tgbn-trade").mkdir(parents=True, exist_ok=True)
    (root / "tgbn-trade" / "tgbn-trade_edgelist.csv").write_text("\n".join(rows) + "\n")
    return root


def _model_cfg():
    return dict(name="tgb_graph_neural_cde", hidden_dim=HID, interpolation="cubic",
                method="Tsit5", return_sequence=False, dt0=0.25,
                vector_field=dict(name="PermEquivDirGraphVectorField", hidden_dim=HID,
                                  num_layers=2, data_embed_dim=E, num_nodes=N,
                                  enc_idx=True, enc_type="emb", idx_dim=4))


@pytest.fixture
def backends():
    yield
    ops.set_fusion_backend("auto")
    jops.set_fusion_backend("auto")


def test_dir_enc_idx_two_synced_steps_match_jax(tmp_path, backends):
    root = _write_trade_csv(tmp_path / "data", n_snap=16)
    kw = dict(name="tgbn-trade", window_size=3, stride=3, frequency="None",
              data_dir=str(root), interpolation="cubic")
    jwins = list(JDataCfg(**kw, cache_dir=str(tmp_path / "jcache")).get_training_data())[:2]
    twins = list(TGBDataSetCfg.from_dict(dict(kw, cache_dir=str(tmp_path / "tcache")))
                 .get_training_data())[:2]
    assert len(jwins) == len(twins) == 2
    vf_j = JDVF(input_dim=HID, hidden_dim=HID, output_dim=HID * E * 2, num_layers=2,
                data_embed_dim=E, num_nodes=N, enc_idx=True, enc_type="emb", idx_dim=4,
                key=jr.PRNGKey(41))
    model_j = JTGBModel(vf_j, HID, "cubic", method="Tsit5", return_sequence=False,
                        dt0=0.25, key=jr.PRNGKey(42))
    jops.set_fusion_backend("dense")
    jtrainer = JTrainer(model=_model_cfg(), optimiser=OPT,
                        dataset=dict(name="tgbn-trade", data_dir=str(tmp_path)))
    jopt, _ = JOpt(**OPT).build()
    jstep = make_window_step_fn(jopt, jtrainer._loss)
    opt_state = jopt.init(partition(model_j, is_inexact_array)[0])

    ttrainer = windowed.TGBTrainer.from_dict(dict(
        model=_model_cfg(), dataset=dict(name="tgbn-trade"), optimiser=OPT, device="cpu"))
    ports = {}
    for backend in ("dense", "megakernel"):
        model_t = TGBGraphNeuralCDECfg.from_dict(_model_cfg()).build(
            torch.Generator().manual_seed(0))
        optimiser, schedule = OptimiserCfg.from_dict(OPT).build(model_t.parameters())
        ports[backend] = (model_t, make_step_fn(optimiser, schedule, ttrainer._loss, True))
    vf = ports["dense"][0].vector_field
    assert vf.enc_idx and vf.gnn_layers[-1].conv_layer.linear.out_features == HID * E * 2

    losses = []
    for jw, tw in zip(jwins, twins):
        jdata = tuple(jnp.asarray(jw[k]) if k != "graph_path_coeffs" else jw[k]
                      for k in ("start_time", "t", "graph_path_coeffs", "x_t", "true_y0",
                                "true_y", "source_mask"))
        for model_t, _ in ports.values():
            copy_jax_to_torch(model_j, model_t)
        loss_j, model_j, opt_state, grad_j, _ = jstep(model_j, opt_state, jdata)
        losses.append(float(loss_j))
        for backend, (model_t, tstep) in ports.items():
            ops.set_fusion_backend(backend)
            calls = (tmod.modulate_pair.launches, tp.pair_call.launches,
                     tp.pair_dw_call.launches)
            loss_t, grad_t, _ = tstep(model_t, ttrainer._data_tuple(
                windowed._to_device(tw, "cpu")))
            assert (tmod.modulate_pair.launches, tp.pair_call.launches,
                    tp.pair_dw_call.launches) == calls  # CPU: the plain versions
            np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4,
                                       err_msg=backend)
            np.testing.assert_allclose(float(grad_t), float(grad_j),
                                       rtol=1e-4 if backend == "dense" else 5e-4,
                                       err_msg=backend)
    assert len(set(losses)) == 2 and all(np.isfinite(losses))


def test_trade_dir_enc_idx_cli_runs_on_cpu(tmp_path):
    """python -m gncde_tpu_torch.run.tgb on
    configs/tgb/trade_perm_equiv_dir_enc_idx_gncde.yaml (the mlp index
    encoder of width 512) cut to n = 12, on the CPU, with the JAX package,
    pyyaml and networkx blocked."""
    _write_trade_csv(tmp_path / "data")
    code = """
import runpy, sys
for _name in ("jax", "jaxlib", "gncde_tpu", "yaml", "networkx"):
    sys.modules[_name] = None
sys.argv = ["tgb", "--config", {cfg!r}, "epochs=1", "eval_freq=1", "log_freq=1",
            "min_epochs=0", "dataset.data_dir={tmp}/data", "dataset.cache_dir={tmp}/cache",
            "checkpoint_dir={tmp}/ckpt/", "model.dt0=0.25",
            "model.vector_field.num_nodes=12", "device=cpu", "wandb.mode=disabled"]
runpy.run_module("gncde_tpu_torch.run.tgb", run_name="__main__")
""".format(cfg=str(ROOT / "configs" / "tgb" / "trade_perm_equiv_dir_enc_idx_gncde.yaml"),
           tmp=str(tmp_path))
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")  # one torch thread
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    for line in ("PermEquivDirGraphVectorField", "Data loading done: 1/0/2 windows",
                 "Train Loss", "Final:"):
        assert line in res.stderr, line


def test_dir_enc_idx_bf16_step_takes_the_bf16_route(tmp_path, backends, monkeypatch):
    """One TGBTrainer step of the same model under
    ``ops.set_fusion_precision("bf16")`` (as the JAX package sets it; the
    TGB trainer has no precision field): the adjacency control stores bf16
    stacks (the JAX model's ``make_control(slim=True)``), K7bf's and
    K6a-bf's plain versions run on bf16 planes, and the loss is finite and
    differs from the f32 step's."""
    from gncde_tpu_torch.models import tgb as ttgb

    root = _write_trade_csv(tmp_path / "data")
    kw = dict(name="tgbn-trade", window_size=3, stride=3, frequency="None",
              data_dir=str(root), interpolation="cubic", cache_dir=str(tmp_path / "tcache"))
    win = list(TGBDataSetCfg.from_dict(kw).get_training_data())[0]
    trainer = windowed.TGBTrainer.from_dict(dict(
        model=_model_cfg(), dataset=dict(name="tgbn-trade"), optimiser=OPT, device="cpu"))
    planes, losses = [], {}
    real = tp.plain_pair
    monkeypatch.setattr(tp, "plain_pair", lambda *a: planes.append(a[0].dtype) or real(*a))
    ops.set_fusion_backend("megakernel")
    try:
        for precision in ("f32", "bf16"):
            ops.set_fusion_precision(precision)
            model = TGBGraphNeuralCDECfg.from_dict(_model_cfg()).build(
                torch.Generator().manual_seed(0))
            optimiser, schedule = OptimiserCfg.from_dict(OPT).build(model.parameters())
            step = make_step_fn(optimiser, schedule, trainer._loss, True)
            planes.clear()
            losses[precision] = float(step(model, trainer._data_tuple(
                windowed._to_device(win, "cpu")))[0])
            want = torch.bfloat16 if precision == "bf16" else torch.float32
            assert planes and set(planes) == {want}, precision
        ctrl = ttgb.adjacency_control("cubic", torch.linspace(0, 1, 3)[None],
                                      tuple(torch.zeros(1, 2, 4, 4) for _ in range(4)))
        assert all(c.dtype == torch.bfloat16 for c in ctrl.path.coeffs)
    finally:
        ops.set_fusion_precision("f32")
    assert np.isfinite(losses["bf16"]) and losses["bf16"] != losses["f32"]
