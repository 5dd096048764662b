"""Port parity of the TGB slice against the JAX package, on the CPU: the edge
list loader and snapshots (gncde_tpu/data/tgb.py), the windows and the
dataset config (data/windows.py, TGBDataSetCfg), TGBGraphNeuralCDE's forward
with copied weights, the masked CE and NDCG@10, and two TGBTrainer steps.
Inputs are made with numpy from a seed (or read from the repo's fixture) and
given to both sides; everything runs at n=12 on the dense path of both
packages.

Tolerances. Loader, snapshots and windows are exact, except the Hermite
coefficients: both sides compute them in f32 by the same formulas, held to
1e-6 of their scale. The model's forward is a constant-step f32 solve on
both sides, so outputs agree to rounding: 1e-4 of the scale. CE and NDCG
agree to 1e-6 (one f32 log-softmax, the same stable ranking). Trainer steps:
losses and max_grad within rtol 1e-4 (f32 forward and backward through a
constant-step solve; no adaptive controller to amplify rounding), with the
JAX step's updated parameters copied into the port after each step.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from gncde_tpu.configs import OptimiserCfg as JOpt
from gncde_tpu.configs import TGBGraphNeuralCDECfg as JModelCfg
from gncde_tpu.configs.dataset_configs import TGBDataSetCfg as JDataCfg
from gncde_tpu.data import tgb as jtgb
from gncde_tpu.nn import is_inexact_array, partition, tree_serialise_leaves
from gncde_tpu.train import metrics as jmetrics
from gncde_tpu.train.windowed import TGBTrainer as JTrainer, make_window_step_fn
from gncde_tpu_torch.configs import (
    OptimiserCfg,
    TGBDataSetCfg,
    TGBGraphNeuralCDECfg,
)
from gncde_tpu_torch.data import tgb
from gncde_tpu_torch.nn import convert
from gncde_tpu_torch.run import common
from gncde_tpu_torch.train import metrics, trainer as dyn_trainer, windowed
from gncde_tpu_torch.train.trainer import make_step_fn

from torch_parity_utils import copy_jax_to_torch

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "tgbn_genre_sample.csv")
N = 12
OPT = dict(name="adamw", weight_decay=1e-4, gradient_clipping=True,
           schedule=dict(name="constant_schedule", value=1e-2))


def _close(got, ref, tol):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err, scale = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    assert err <= tol * max(scale, 1e-30), f"max abs err {err:.3e} > {tol} x {scale:.3e}"


def _write_synth(root, seed=0, n_snap=22):
    """A TGB-format CSV with string node ids (a few never start an edge)."""
    rng = np.random.default_rng(seed)
    rows = ["timestamp,source,destination,weight"]
    for t in range(n_snap):
        for _ in range(30):
            s, d = rng.integers(0, N, 2)
            rows.append(f"{t},n{s},n{d},{rng.uniform(0.1, 2.0):.4f}")
    path = root / "tgbn-trade"
    path.mkdir(parents=True, exist_ok=True)
    (path / "tgbn-trade_edgelist.csv").write_text("\n".join(rows) + "\n")
    return root


def _write_fixture(root):
    (root / "tgbn-genre").mkdir(parents=True, exist_ok=True)
    shutil.copy(FIXTURE, root / "tgbn-genre" / "tgbn-genre_edgelist.csv")
    return root


@pytest.mark.parametrize("source", ["genre-fixture", "synth"])
def test_loader_and_snapshots_match_jax(tmp_path, source):
    if source == "genre-fixture":
        name, freq, root = "tgbn-genre", "weekly", _write_fixture(tmp_path)
    else:
        name, freq, root = "tgbn-trade", "None", _write_synth(tmp_path)
    je = jtgb.load_tgb_edgelist(name, str(root))
    te = tgb.load_tgb_edgelist(name, str(root))
    assert te.num_nodes == je.num_nodes
    for field in ("src", "dst", "t", "msg"):
        a, b = getattr(te, field), getattr(je, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    js, ts_ = jtgb.process_snapshots(je, freq), tgb.process_snapshots(te, freq)
    assert len(ts_) == len(js) > 1
    for a, b in zip(ts_, js):
        assert a.t == b.t and np.array_equal(a.src, b.src)
        assert np.array_equal(a.adj, b.adj) and np.array_equal(a.x, b.x)


def _data_cfgs(tmp_path, interpolation, window_size=3):
    root = _write_synth(tmp_path / "data")
    kw = dict(name="tgbn-trade", window_size=window_size, stride=window_size,
              frequency="None", data_dir=str(root), interpolation=interpolation)
    return (JDataCfg(**kw, cache_dir=str(tmp_path / "jcache")),
            TGBDataSetCfg.from_dict(dict(kw, cache_dir=str(tmp_path / "tcache"))))


@pytest.mark.parametrize("interpolation", ["cubic", "linear"])
def test_windows_match_jax(tmp_path, interpolation):
    jcfg, tcfg = _data_cfgs(tmp_path, interpolation)
    for split in ("get_training_data", "get_validation_data", "get_test_data"):
        jw, tw = list(getattr(jcfg, split)()), list(getattr(tcfg, split)())
        assert len(tw) == len(jw) > 0, split
        for a, b in zip(tw, jw):
            for k in ("t", "true_y", "true_y0", "x_t", "source_mask", "start_time"):
                assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
            if interpolation == "cubic":
                for c_t, c_j in zip(a["graph_path_coeffs"], b["graph_path_coeffs"]):
                    _close(c_t, np.asarray(c_j)[..., -1], 1e-6)
            else:
                _close(a["graph_path_coeffs"], np.asarray(b["graph_path_coeffs"])[..., -1], 1e-6)
            assert not set(a) & {"A", "A_t", "events_time", "x_coeffs"}
    # The second read comes from the cache.
    assert len(list(tcfg.get_training_data())) == len(list(jcfg.get_training_data()))


def _model_cfg(persistence_head=False):
    return dict(name="tgb_graph_neural_cde", hidden_dim=4, interpolation="cubic",
                method="Tsit5", return_sequence=False, dt0=0.1,
                persistence_head=persistence_head,
                vector_field=dict(name="PermEquivGraphVectorField", hidden_dim=4,
                                  num_layers=2, data_embed_dim=4, num_nodes=N))


def _models(persistence_head=False, seed=3):
    cfg = _model_cfg(persistence_head)
    model_j = JModelCfg(**cfg).build(jr.PRNGKey(seed))
    model_t = TGBGraphNeuralCDECfg.from_dict(cfg).build(torch.Generator().manual_seed(0))
    copy_jax_to_torch(model_j, model_t)
    return model_j, model_t


def _one_window(tmp_path, window_size=4):
    jcfg, tcfg = _data_cfgs(tmp_path, "cubic", window_size)
    return list(jcfg.get_training_data())[0], list(tcfg.get_training_data())[0]


def _jax_tuple(d):
    return (jnp.asarray(d["start_time"]), jnp.asarray(d["t"]), d["graph_path_coeffs"],
            jnp.asarray(d["x_t"]), jnp.asarray(d["true_y0"]), jnp.asarray(d["true_y"]),
            jnp.asarray(d["source_mask"]))


@pytest.mark.parametrize("persistence_head", [False, True], ids=["plain-head", "persistence"])
def test_model_forward_matches_jax(tmp_path, persistence_head):
    wj, wt = _one_window(tmp_path)
    model_j, model_t = _models(persistence_head)
    if persistence_head:  # move the gate off its zero init so the decoder counts
        model_j = model_j.replace(residual_gate=jnp.float32(0.7))
        copy_jax_to_torch(model_j, model_t)
    ref = model_j(*_jax_tuple(wj)[1:5])
    with torch.no_grad():
        got = windowed.TGBTrainer._predict(model_t, windowed.TGBTrainer._data_tuple(
            windowed._to_device(wt, "cpu")))[0]
    _close(got[0], ref, 1e-4)


def test_convert_npz_and_data_encoder_quirk(tmp_path):
    """The JAX save_weights file (leaf_<i> in flatten order, the vector
    field listed twice: on its own and inside the CDE wrapper) loads into the
    port, and the port's init keeps the reference quirk that data_encoder
    reuses the encoder's key (equal draws when the widths agree)."""
    model_j, model_t = _models(seed=5)
    path = str(tmp_path / "w.npz")
    tree_serialise_leaves(path, model_j)
    fresh = TGBGraphNeuralCDECfg.from_dict(_model_cfg()).build(torch.Generator().manual_seed(1))
    assert torch.equal(fresh.data_encoder.weight, fresh.encoder.weight)
    assert torch.equal(fresh.data_encoder.bias, fresh.encoder.bias)
    convert.load_jax_npz(fresh, path)
    for (k, a), (_, b) in zip(fresh.state_dict().items(), model_t.state_dict().items()):
        assert torch.equal(a, b), k
    convert.save_jax_npz(fresh, str(tmp_path / "w2.npz"))
    j, t = np.load(path), np.load(str(tmp_path / "w2.npz"))
    assert sorted(j.files) == sorted(t.files)
    for k in j.files:
        np.testing.assert_array_equal(j[k], t[k])


def test_masked_ce_and_ndcg_match_jax():
    rng = np.random.default_rng(7)
    y_pred = rng.normal(size=(N, N)).astype(np.float32)
    y_pred[:, 3] = y_pred[:, 5]  # ties: the stable ranking decides
    label = rng.uniform(size=(N, N)).astype(np.float32) * (rng.uniform(size=(N, N)) < 0.4)
    label[2] = 0.0  # a row with no relevance
    mask = rng.uniform(size=N) < 0.7
    mask[2] = True
    ce_j = jnp.sum(-label * jax.nn.log_softmax(y_pred, axis=-1), axis=-1)
    ce_j = jnp.sum(jnp.where(mask, ce_j, 0.0)) / jnp.sum(mask)
    nd_j = jmetrics.masked_mean_ndcg(jnp.asarray(label), jnp.asarray(y_pred), mask, k=10)
    t = [torch.tensor(x)[None] for x in (y_pred, label, mask)]
    _close(windowed._masked_ce(*t)[0], ce_j, 1e-6)
    _close(metrics.masked_mean_ndcg(t[1], t[0], t[2], k=10)[0], nd_j, 1e-6)
    _close(metrics.ndcg_at_k(t[1][0], t[0][0]), jmetrics.ndcg_at_k(label, y_pred), 1e-6)


def test_trainer_steps_match_jax(tmp_path):
    """Two TGBTrainer steps (two windows) of the port's step against the JAX
    window step, with the JAX parameters copied into the port after each."""
    jcfg, tcfg = _data_cfgs(tmp_path, "cubic", window_size=4)
    jw, tw = list(jcfg.get_training_data())[:2], list(tcfg.get_training_data())[:2]
    model_j, model_t = _models(seed=9)
    jtrainer = JTrainer(model=_model_cfg(), dataset=dict(
        name="tgbn-trade", data_dir=str(tmp_path)), optimiser=OPT)
    jopt, _ = JOpt(**OPT).build()
    jstep = make_window_step_fn(jopt, jtrainer._loss)
    opt_state = jopt.init(partition(model_j, is_inexact_array)[0])
    ttrainer = windowed.TGBTrainer.from_dict(dict(
        model=_model_cfg(), dataset=dict(name="tgbn-trade"), optimiser=OPT, device="cpu"))
    optimiser, schedule = OptimiserCfg.from_dict(OPT).build(model_t.parameters())
    tstep = make_step_fn(optimiser, schedule, ttrainer._loss, True)
    for dj, dt in zip(jw, tw):
        loss_t, grad_t, _ = tstep(model_t, ttrainer._data_tuple(windowed._to_device(dt, "cpu")))
        loss_j, model_j, opt_state, grad_j, _ = jstep(model_j, opt_state, _jax_tuple(dj))
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4)
        np.testing.assert_allclose(float(grad_t), float(grad_j), rtol=1e-4)
        copy_jax_to_torch(model_j, model_t)


@pytest.mark.parametrize("which", ["dyn", "tgb"])
def test_trainers_default_to_the_card(which, monkeypatch, tmp_path):
    """Both trainers default to device cuda and, without a card, raise and
    name the override before they touch any data, instead of running on
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = os.path.join(os.path.dirname(FIXTURE), os.pardir, os.pardir, "configs")
    if which == "dyn":
        cfg = common.safe_load(open(os.path.join(root, "dyn", "perm_equiv_gncde.yaml")).read())
        trainer = dyn_trainer.Trainer.from_dict(cfg)
    else:
        cfg = common.safe_load(open(os.path.join(root, "tgb", "genre_perm_equiv_gncde.yaml")).read())
        cfg["dataset"]["data_dir"] = str(tmp_path / "missing")
        trainer = windowed.TGBTrainer.from_dict(cfg)
    assert trainer.device == "cuda"
    with pytest.raises(RuntimeError, match="device=cpu"):
        trainer.run()
