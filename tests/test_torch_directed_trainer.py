"""Two parameter-synced TGBTrainer steps of the directed trade config
(configs/tgb/trade_perm_equiv_dir_gncde.yaml at its widths: hidden 32, 4
layers, last layer 32 * 8 * 2 = 512) against the JAX trainer, on a tiny
TGB-format trade CSV (n = 12, 16 snapshots in the config's windows of 3)
and ``model.dt0=0.25`` (4 constant steps per window). The JAX step's
compile takes most of this file's time, so it has a file of its own (as
tests/test_torch_sparse_trainer.py does).

The port runs each step on its dense path and on the megakernel route (K1d
forward, K2d backward: their plain versions on the CPU), from the JAX
parameters copied in before each step. Losses and max_grad within rtol
1e-3 in float32 (the directed rank terms and the dense basis matrices sum
in another order, and the solve's RMSNorms amplify it). The directed
field's index encoder and modulation MLPs are unused without enc_idx: their
gradients are zero on both sides, and AdamW's weight decay moves them
alike (rtol 1e-6: one multiply by ``1 - lr * wd``). Then the trade
config's CLI on the same kind of CSV, on the CPU, without the JAX package.
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
from gncde_tpu.configs import TGBGraphNeuralCDECfg as JModelCfg
from gncde_tpu.configs.dataset_configs import TGBDataSetCfg as JDataCfg
from gncde_tpu.nn import is_inexact_array, partition
from gncde_tpu.train.windowed import TGBTrainer as JTrainer, make_window_step_fn
from gncde_tpu_torch import ops
from gncde_tpu_torch.configs import OptimiserCfg, TGBDataSetCfg, TGBGraphNeuralCDECfg
from gncde_tpu_torch.ops import megakernel as mk
from gncde_tpu_torch.run import common
from gncde_tpu_torch.train import windowed
from gncde_tpu_torch.train.trainer import make_step_fn

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_parity_utils import copy_jax_to_torch, jax_leaves  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
N = 12


def _write_trade_csv(root, n_snap=16, seed=0):
    rng = np.random.default_rng(seed)
    rows = ["timestamp,source,destination,weight"]
    for t in range(n_snap):
        for _ in range(30):
            s, d = rng.integers(0, N, 2)
            rows.append(f"{t},{s},{d},{rng.uniform(0.1, 2.0):.4f}")
    (root / "tgbn-trade").mkdir(parents=True, exist_ok=True)
    (root / "tgbn-trade" / "tgbn-trade_edgelist.csv").write_text("\n".join(rows) + "\n")
    return root


@pytest.fixture
def backends():
    yield
    ops.set_fusion_backend("auto")
    jops.set_fusion_backend("auto")


def test_trade_dir_trainer_steps_match_jax(tmp_path, backends):
    cfg = common.safe_load((ROOT / "configs" / "tgb" /
                            "trade_perm_equiv_dir_gncde.yaml").read_text())
    model_cfg = dict(cfg["model"], dt0=0.25)
    model_cfg["vector_field"] = dict(model_cfg["vector_field"], num_nodes=N)
    opt = cfg["optimiser"]
    root = _write_trade_csv(tmp_path / "data")
    kw = dict(name="tgbn-trade", window_size=3, stride=3, frequency="None",
              data_dir=str(root), interpolation="cubic")
    jwins = list(JDataCfg(**kw, cache_dir=str(tmp_path / "jcache")).get_training_data())[:2]
    twins = list(TGBDataSetCfg.from_dict(dict(kw, cache_dir=str(tmp_path / "tcache")))
                 .get_training_data())[:2]
    assert len(jwins) == len(twins) == 2

    model_j = JModelCfg(**model_cfg).build(jr.PRNGKey(3))
    jops.set_fusion_backend("dense")
    jtrainer = JTrainer(model=model_cfg, optimiser=opt,
                        dataset=dict(name="tgbn-trade", data_dir=str(tmp_path)))
    jopt, _ = JOpt(**opt).build()
    jstep = make_window_step_fn(jopt, jtrainer._loss)
    opt_state = jopt.init(partition(model_j, is_inexact_array)[0])

    ttrainer = windowed.TGBTrainer.from_dict(dict(
        model=model_cfg, dataset=dict(name="tgbn-trade"), optimiser=opt, device="cpu"))
    ports = {}
    for backend in ("dense", "megakernel"):
        model_t = TGBGraphNeuralCDECfg.from_dict(model_cfg).build(
            torch.Generator().manual_seed(0))
        optimiser, schedule = OptimiserCfg.from_dict(opt).build(model_t.parameters())
        ports[backend] = (model_t, make_step_fn(optimiser, schedule, ttrainer._loss, True))
    vf = ports["dense"][0].vector_field
    assert [l.conv_layer.linear.out_features for l in vf.gnn_layers] == [32, 32, 32, 512]
    unused = [k for k, _ in ports["dense"][0].named_parameters()
              if ".idx_enc." in k or ".msg_func_adj" in k]
    assert unused

    for jw, tw in zip(jwins, twins):
        jdata = tuple(jnp.asarray(jw[k]) if k != "graph_path_coeffs" else jw[k]
                      for k in ("start_time", "t", "graph_path_coeffs", "x_t", "true_y0",
                                "true_y", "source_mask"))
        for model_t, _ in ports.values():
            copy_jax_to_torch(model_j, model_t)
        loss_j, model_j, opt_state, grad_j, _ = jstep(model_j, opt_state, jdata)
        updated = jax_leaves(model_j)
        for backend, (model_t, tstep) in ports.items():
            ops.set_fusion_backend(backend)
            launches = mk.megakernel_vf_eval.launches
            loss_t, grad_t, _ = tstep(model_t, ttrainer._data_tuple(
                windowed._to_device(tw, "cpu")))
            assert mk.megakernel_vf_eval.launches == launches  # CPU: plain versions
            np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-3,
                                       err_msg=backend)
            np.testing.assert_allclose(float(grad_t), float(grad_j), rtol=1e-3,
                                       err_msg=backend)
            params = dict(model_t.named_parameters())
            for k in unused:  # zero gradient: AdamW's weight decay alone
                np.testing.assert_allclose(params[k].detach().numpy(),
                                           updated[k.replace(".", "/")], rtol=1e-6,
                                           atol=1e-9, err_msg=k)


def test_trade_dir_cli_runs_on_cpu(tmp_path):
    """python -m gncde_tpu_torch.run.tgb on the directed trade config cut to
    n=12, on the CPU, with the JAX package, pyyaml and networkx blocked."""
    _write_trade_csv(tmp_path / "data", n_snap=10)
    code = """
import runpy, sys
for _name in ("jax", "jaxlib", "gncde_tpu", "yaml", "networkx"):
    sys.modules[_name] = None
sys.argv = ["tgb", "--config", {cfg!r}, "epochs=1", "eval_freq=1", "log_freq=1",
            "min_epochs=0", "dataset.data_dir={tmp}/data", "dataset.cache_dir={tmp}/cache",
            "checkpoint_dir={tmp}/ckpt/", "model.dt0=0.25",
            "model.vector_field.num_nodes=12", "device=cpu", "wandb.mode=disabled"]
runpy.run_module("gncde_tpu_torch.run.tgb", run_name="__main__")
""".format(cfg=str(ROOT / "configs" / "tgb" / "trade_perm_equiv_dir_gncde.yaml"),
           tmp=str(tmp_path))
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")  # one torch thread
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    for line in ("PermEquivDirGraphVectorField", "Data loading done: 1/0/2 windows",
                 "Train Loss", "Final:"):
        assert line in res.stderr, line

