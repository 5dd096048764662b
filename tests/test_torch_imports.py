"""The port stands alone: no jax, pydantic, optax or module of the JAX
package (gncde_tpu) anywhere in gncde_tpu_torch, and no pyyaml or networkx on
the dyn and TGB paths. Also the YAML-subset reader, the config schemas, the
CLI smokes of the port, the probe timer without the TPU probe files and
chip_smoke.py's refusal to run without a card.
"""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import yaml

from gncde_tpu_torch.configs import ConfigError
from gncde_tpu_torch.run import common
from gncde_tpu_torch.train.trainer import Trainer

ROOT = pathlib.Path(__file__).resolve().parents[1]
FLAGSHIP = ROOT / "configs" / "dyn" / "perm_equiv_gncde.yaml"

# Makes the named top-level packages unimportable (a None entry in
# sys.modules: ``import`` raises ImportError, ``find_spec`` finds nothing),
# so the code after it proves it does not need them.
BLOCKER = """
import sys
for _name in {names!r}:
    sys.modules[_name] = None
"""
# Top-level names: "gncde_tpu" blocks the JAX package and not the port,
# whose top-level name is gncde_tpu_torch.
NEVER = ("jax", "jaxlib", "pydantic", "optax", "gncde_tpu")
FLAGSHIP_PATH_FREE = NEVER + ("yaml", "networkx")


def _run(code, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")  # one torch thread
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_every_module_imports_without_jax_pydantic_optax():
    code = BLOCKER.format(names=set(NEVER)) + """
import importlib, pkgutil, gncde_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(gncde_tpu_torch.__path__, "gncde_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
bad = [m for m, v in sys.modules.items() if v is not None and m.split(".")[0] in {names!r}]
assert not bad, bad
assert sys.modules["jax"] is None
print("imported", len(mods))
""".format(names=set(NEVER))
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert "imported" in res.stdout


def test_cli_smoke_without_yaml_or_networkx(tmp_path):
    """SKILL.md section 1 smoke under the port, at n=16, with pyyaml and
    networkx blocked as well: the flagship path needs neither."""
    code = BLOCKER.format(names=set(FLAGSHIP_PATH_FREE)) + """
import runpy
sys.argv = ["dyn", "--config", {cfg!r}, "epochs=2", "eval_freq=1", "log_freq=1",
            "min_epochs=0", "dataset.num_nodes=16", "dataset.batch_size=2",
            "dataset.time_tick=10", "model.max_steps=64",
            "dataset.cache_dir={tmp}/cache", "checkpoint_dir={tmp}/ckpt/",
            "device=cpu", "wandb.mode=disabled"]
runpy.run_module("gncde_tpu_torch.run.dyn", run_name="__main__")
assert sys.modules["jax"] is None and sys.modules["yaml"] is None
""".format(cfg=str(FLAGSHIP), tmp=str(tmp_path))
    res = _run(code, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    log = res.stderr
    for line in ("Data loading done", "Train Loss", "Model saved", "Best validation loss"):
        assert line in log, line
    assert list((tmp_path / "cache").glob("torch_cache_*_default_train.pkl"))


@pytest.mark.parametrize("path", sorted((ROOT / "configs" / "dyn").glob("*.yaml"))
                         + sorted((ROOT / "configs" / "tgb").glob("*.yaml")),
                         ids=lambda p: p.name if p.parent.name == "dyn" else f"tgb/{p.name}")
def test_yaml_subset_reader_matches_safe_load(path):
    text = path.read_text()
    assert common.read_yaml_subset(text) == yaml.safe_load(text)


def _write_tgb_csv(root, n_nodes=12, n_snap=10, seed=0):
    rng = np.random.default_rng(seed)
    rows = ["timestamp,source,destination,weight"]
    for t in range(n_snap):
        for _ in range(30):
            s, d = rng.integers(0, n_nodes, 2)
            rows.append(f"{t},{s},{d},{rng.uniform(0.1, 2.0):.4f}")
    (root / "tgbn-trade").mkdir(parents=True)
    (root / "tgbn-trade" / "tgbn-trade_edgelist.csv").write_text("\n".join(rows))


def test_tgb_cli_smoke_without_yaml_or_networkx(tmp_path):
    """python -m gncde_tpu_torch.run.tgb on the genre config cut to n=12
    (a TGB-format CSV written here), on the CPU, with pyyaml, networkx and
    the JAX package blocked."""
    _write_tgb_csv(tmp_path / "data")
    code = BLOCKER.format(names=set(FLAGSHIP_PATH_FREE)) + """
import runpy
sys.argv = ["tgb", "--config", {cfg!r}, "epochs=1", "eval_freq=1", "log_freq=1",
            "min_epochs=0", "dataset.name=tgbn-trade", "dataset.frequency=None",
            "dataset.window_size=3", "dataset.stride=3", "dataset.data_dir={tmp}/data",
            "dataset.cache_dir={tmp}/cache", "checkpoint_dir={tmp}/ckpt/",
            "model.dt0=0.25", "model.hidden_dim=4", "model.vector_field.hidden_dim=4",
            "model.vector_field.data_embed_dim=2", "model.vector_field.num_nodes=12",
            "device=cpu", "wandb.mode=disabled"]
runpy.run_module("gncde_tpu_torch.run.tgb", run_name="__main__")
assert sys.modules["gncde_tpu"] is None and sys.modules["yaml"] is None
""".format(cfg=str(ROOT / "configs" / "tgb" / "genre_perm_equiv_gncde.yaml"), tmp=str(tmp_path))
    res = _run(code, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    for line in ("Data loading done: 1/0/2 windows", "Train Loss", "Final:"):
        assert line in res.stderr, line
    assert list((tmp_path / "cache").glob("torch_cache_*_default_train.pkl"))


@pytest.mark.parametrize("text", ["1", "-3", "1.0e-4", "1e-4", "0.5", ".5", "true",
                                  "False", "null", "~", "cubic", "'a b'", "[0.8, 0.2]",
                                  "[1, two, 3.0]", ".checkpoints/", "1_000"])
def test_scalar_parsing_matches_safe_load(text):
    assert common.parse_scalar(text) == yaml.safe_load(text)


def _flagship():
    return yaml.safe_load(FLAGSHIP.read_text())


def test_trainer_schema_reads_the_flagship_config():
    tr = Trainer.from_dict(_flagship())
    assert tr.model.vector_field.hidden_dim == 16 and tr.dataset.num_nodes == 400
    assert tr.optimiser.schedule.value == 0.1 and tr.optimiser.weight_decay == 1e-4
    assert tr.dataset.split_ratio == [0.8, 0.2] and tr.dataset.amp_range == (1.0, 1.0)


def test_schema_rejections():
    cfg = _flagship()
    cfg["model"]["hiden_dim"] = 3  # typo: unknown keys are rejected
    with pytest.raises(ConfigError, match="hiden_dim"):
        Trainer.from_dict(cfg)
    cfg = _flagship()
    del cfg["dataset"]["dynamic_graph"]
    with pytest.raises(ConfigError, match="dynamic_graph"):
        Trainer.from_dict(cfg)
    cfg = _flagship()
    cfg["loss"]["name"] = "L2"
    with pytest.raises(ConfigError, match="L2"):
        Trainer.from_dict(cfg)
    cfg = _flagship()
    cfg["fusion_precision"] = "bf16"  # served by K1bf/K2bf/K11bf: accepted
    assert Trainer.from_dict(cfg).fusion_precision == "bf16"
    cfg["fusion_precision"] = "fp8"  # no such precision: refuse early
    with pytest.raises(ValueError, match="precision"):
        Trainer.from_dict(cfg)
    cfg = _flagship()
    cfg["model"]["method"] = "Kvaerno5"
    with pytest.raises(NotImplementedError, match="Kvaerno5"):
        Trainer.from_dict(cfg)
    cfg = _flagship()
    cfg["optimiser"]["name"] = "sgd"  # in the schema, not ported yet
    with pytest.raises(NotImplementedError, match="sgd"):
        Trainer.from_dict(cfg)
    assert common.apply_overrides(_flagship(), ["dataset.num_nodes=16"])[
        "dataset"]["num_nodes"] == 16
    with pytest.raises(ValueError):
        common.apply_overrides({}, ["no_equals_sign"])


def test_probe_timer_runs_on_cpu_without_jax_or_the_probe_files():
    """``ops/mk_probe.py`` and ``run/mk_probe.py`` need nothing of JAX, the
    JAX package or ``benchmarks/`` (the TPU probes): the probe timer at a
    tiny size on the CPU (the plain versions) with all three blocked."""
    code = BLOCKER.format(names=set(NEVER) | {"benchmarks"}) + """
import runpy
sys.argv = ["mk_probe", "--device", "cpu", "--n", "20", "--hidden", "8", "--layers", "2",
            "--batch", "2", "--evals", "2", "--steps", "1", "--blocks", "1",
            "--only", "P2/current,P1,P3/red,P4/dma_only,P6"]
runpy.run_module("gncde_tpu_torch.run.mk_probe", run_name="__main__")
assert sys.modules["jax"] is None and sys.modules["benchmarks"] is None
"""
    res = _run(code)
    assert res.returncode == 0, res.stderr[-3000:]
    last = json.loads(res.stdout.strip().splitlines()[-1])
    assert sorted(last["results"]) == ["P1/restructured", "P2/current", "P3/red",
                                       "P4/dma_only", "P6/fusedstep", "P6/seq"]
    assert last["device"].startswith("cpu")
    assert last["results"]["P1/restructured"]["rel_dev_vs_current"] < 1e-2


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and '"ok": true' not in res.stdout
    # Alone in a directory (no package beside it) it fails too.
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and '"ok": true' not in res.stdout
