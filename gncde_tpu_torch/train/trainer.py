"""Dynamical-systems trainer (full-batch, inter/extra-polation evaluation).

Counterpart of ``gncde_tpu/train/trainer.py``: the epoch loop, the metric
names and log lines, inter/extra validation, the best-validation weight save
and patience early stop. The device is explicit and every tensor of the run
lives there: ``device: cuda`` by default, which raises when no card is
visible; the CPU runs only when asked for (``device=cpu``).
With ``sparse_control`` the coefficient dicts become sparse controls
(``interp.build_sparse_control``: ELL through K10, or BCSR through K8/K9)
on the host before they move to the device. Not ported yet (ROADMAP):
resume, ``nan_guard`` and the async full-state checkpointer.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import random
import time
import typing as tp

import numpy as np
import torch

from .. import ops as ops_config
from ..configs import (
    GraphNeuralCDECfg,
    MSELossCfg,
    ODEDataSetCfg,
    OptimiserCfg,
    Schema,
    WandBConfig,
    clip_by_global_norm,
)
from ..configs._schema import required
from ..interp import build_sparse_control
from ..models.continuous import make_control
from . import checkpoints
from .logging import MetricLogger

logging.basicConfig(level=logging.INFO)


def resolve_device(name: str) -> torch.device:
    """The run's device. A CUDA device that is not visible raises: the
    trainers never fall back to the CPU on their own."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but no CUDA device is visible; pass "
            "the override device=cpu to run on the CPU")
    return device


def tensor_bytes(obj, seen=None) -> int:
    """Bytes of every distinct tensor reachable from a control (its path,
    coefficient tuples, layout), each counted once."""
    seen = set() if seen is None else seen
    if isinstance(obj, torch.Tensor):
        key = (obj.data_ptr(), obj.numel())
        if key in seen:
            return 0
        seen.add(key)
        return obj.numel() * obj.element_size()
    if isinstance(obj, (tuple, list)):
        return sum(tensor_bytes(x, seen) for x in obj)
    if hasattr(obj, "__dict__"):
        return sum(tensor_bytes(x, seen) for x in vars(obj).values())
    return 0


def make_step_fn(optimiser: torch.optim.Optimizer, schedule, loss: tp.Callable,
                 gradient_clipping: bool):
    """One training step (counterpart of the JAX ``make_step_fn``): loss and
    grads, ``max_grad`` of the unclipped grads, clip by global norm 1.0, the
    scheduled learning rate for this update count, the optimiser update, and
    ``max_update`` (largest parameter change)."""
    count = [0]

    def step(model: torch.nn.Module, data_i):
        params = [p for p in model.parameters() if p.requires_grad]
        for p in params:
            p.grad = None
        loss_val = loss(model, data_i)
        loss_val.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        for p, g in zip(params, grads):
            p.grad = g
        with torch.no_grad():
            max_grad = torch.stack([g.abs().max() for g in grads]).max()
            if gradient_clipping:
                clip_by_global_norm(grads, 1.0)
            for group in optimiser.param_groups:
                group["lr"] = schedule(count[0])
            before = [p.detach().clone() for p in params]
            optimiser.step()
            max_update = torch.stack(
                [(p - b).abs().max() for p, b in zip(params, before)]).max()
        count[0] += 1
        return loss_val.detach(), max_grad, max_update

    return step


@dataclasses.dataclass
class Trainer(Schema):
    """Dyn-task trainer; reads the JAX package's YAML configs unchanged."""

    _extra: tp.ClassVar[str] = "ignore"

    wandb: WandBConfig = dataclasses.field(default_factory=WandBConfig)
    model: GraphNeuralCDECfg = required()
    epochs: int = 2000
    patience: int = -1
    min_epochs: int = 100
    seed: int = 1234
    log_freq: int = 10
    eval_freq: int = 10
    checkpoint_dir: str = ".checkpoints/"
    checkpoint_name: str = "model"
    dataset: ODEDataSetCfg = required()
    optimiser: OptimiserCfg = required()
    loss: MSELossCfg = required()
    logger_name: str = "gncde"
    resume: bool = False
    metrics_jsonl: tp.Optional[str] = None
    #: Scaled-n message passing: the dense graph-path coefficients become a
    #: sparse control on the host, exact at any density (the pattern is the
    #: union of nonzero coefficient entries).
    sparse_control: bool = False
    sparse_max_degree: tp.Optional[int] = None
    #: "ell" (element-sparse, K10), "bcsr" (blocked-ELL, K8/K9) or "auto"
    #: (by blocked fill ratio: ``interp.build_sparse_control``).
    sparse_format: tp.Literal["ell", "bcsr", "auto"] = "ell"
    sparse_block_size: int = 128
    #: "bf16" stores the control's Hermite stacks in bfloat16 and runs the
    #: message passing on bf16 operands with f32 sums (K1bf/K2bf/K11bf on the
    #: card); set before the controls are built. None keeps the process-wide
    #: setting (``ops.set_fusion_precision``, "f32" by default).
    fusion_precision: tp.Optional[str] = None
    fusion_backend: tp.Optional[str] = None
    nan_guard: bool = False
    #: "cuda" (the default: raises without a card), "cuda:<i>" or "cpu".
    device: str = "cuda"

    def validate(self) -> None:
        for knob in ("resume", "nan_guard"):
            if getattr(self, knob):
                raise NotImplementedError(f"{knob} is not ported yet (see ROADMAP)")
        if self.fusion_precision is not None:
            ops_config.check_fusion_precision(self.fusion_precision)
        if self.fusion_backend is not None:
            ops_config.check_fusion_backend(self.fusion_backend)

    def resolve_device(self) -> torch.device:
        return resolve_device(self.device)

    def _hash_config(self) -> str:
        config_str = json.dumps(self.to_dict(), sort_keys=True, default=str)
        return hashlib.md5(config_str.encode()).hexdigest()

    def run_initialisations(self) -> None:
        random.seed(self.seed)
        np.random.seed(self.seed)
        torch.manual_seed(self.seed)
        if self.fusion_precision is not None:
            ops_config.set_fusion_precision(self.fusion_precision)
        if self.fusion_backend is not None:
            ops_config.set_fusion_backend(self.fusion_backend)

    def run(self) -> tp.Dict[str, tp.Any]:
        self.run_initialisations()
        device = self.resolve_device()
        config_hash = self._hash_config()
        logger = logging.getLogger(self.logger_name)
        logger.setLevel(logging.INFO)
        logger.info(self)

        train_data = self.dataset.get_training_data()
        val_data = self.dataset.get_validation_data()
        test_data = self.dataset.get_test_data()
        logger.info("Data loading done")

        # Slim (or sparse) control built once, on the host, then moved to the
        # device with the rest of the data.
        interpolation = self.model.interpolation
        for dct in (train_data, val_data, test_data):
            for ckey, tkey in (("train_graph_path_coeffs", "train_t"),
                               ("val_graph_path_coeffs", "t"),
                               ("test_graph_path_coeffs", "t")):
                if ckey not in dct:
                    continue
                if self.sparse_control:
                    ctrl = build_sparse_control(
                        interpolation, dct[tkey], dct[ckey], sparse_format=self.sparse_format,
                        max_degree=self.sparse_max_degree, block_size=self.sparse_block_size)
                else:
                    ctrl = make_control(interpolation, dct[tkey], dct[ckey])
                dct[ckey] = ctrl.to(device)
        control_bytes = tensor_bytes([dct.get(k) for dct in (train_data, val_data, test_data)
                                      for k in ("train_graph_path_coeffs",
                                                "val_graph_path_coeffs",
                                                "test_graph_path_coeffs")])
        if self.sparse_control:
            logger.info("Sparse control conversion done (format=%s)", self.sparse_format)
        else:
            logger.info("Slim control conversion done")

        def tup(d, t_key, c_key, y_key):
            return (d[t_key].to(device), d[c_key], d[y_key].to(device),
                    d["true_y0"].to(device))

        train_i = tup(train_data, "train_t", "train_graph_path_coeffs", "train_true_y")
        val_i = tup(train_data, "t", "val_graph_path_coeffs", "true_y")
        separate_val_i = tup(val_data, "t", "test_graph_path_coeffs", "true_y")
        test_i = tup(test_data, "t", "test_graph_path_coeffs", "true_y")

        model = self.model.build(torch.Generator().manual_seed(self.seed)).to(device)
        optimiser, schedule = self.optimiser.build(model.parameters())
        step = make_step_fn(optimiser, schedule, self.loss.build(),
                            self.optimiser.gradient_clipping)
        validation_loss_fn = self.loss.build_validation_loss()

        metric_logger = MetricLogger(project=self.wandb.project, mode=self.wandb.mode,
                                     jsonl_path=self.metrics_jsonl,
                                     config=self.to_dict())
        metric_logger.log({"num_params": sum(p.numel() for p in model.parameters())})

        id_inter = train_data["id_test_inter"]
        id_extra = train_data["id_test_extra"].to(device)
        id_inter = id_inter.to(device) if id_inter is not None else None
        ids_total = id_extra if id_inter is None else torch.cat([id_inter, id_extra])

        best_val, corr_test, corr_test_l1, best_epoch = np.inf, np.inf, np.inf, 0
        patience_counter = 0
        train_losses, step_times, solver_steps = [], [], {}
        for epoch in range(self.epochs):
            start = time.perf_counter()
            train_loss, max_grad, max_update = step(model, train_i)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            end = time.perf_counter()
            stats = model.last_stats
            solver_steps = {k: v.tolist() for k, v in stats.items()}
            train_losses.append(float(train_loss))
            step_times.append(end - start)
            metric_logger.log({"train_loss": train_loss,
                               "train_step_time": end - start,
                               "max_grad": max_grad, "max_update": max_update})
            if epoch == 0 or (epoch + 1) % self.log_freq == 0:
                logger.info("Epoch: %04d, Train Loss: %s, Train Step Time: %.4fs, LR: %s",
                            epoch + 1, float(train_loss), end - start, schedule(epoch))

            if (epoch + 1) % self.eval_freq != 0:
                continue
            total_val, total_val_l1 = validation_loss_fn(model, val_i)
            val_inter = (total_val[:, id_inter].mean() if id_inter is not None
                         else torch.tensor(float("nan")))
            val_extra = total_val[:, id_extra].mean()
            val_total = total_val[:, ids_total].mean()
            sep_val, sep_val_l1 = validation_loss_fn(model, separate_val_i)
            sep_val_total = float(sep_val.mean())
            logger.info("Epoch: %04d, Val Inter: %s, Val Extra: %s, Val Total: %s",
                        epoch + 1, float(val_inter), float(val_extra), float(val_total))
            metric_logger.log({
                "validation_loss_inter": val_inter,
                "validation_loss_extra": val_extra,
                "validation_loss_total": val_total,
                "validation_loss_l1_total": total_val_l1.mean(),
                "separate_val_loss_total": sep_val_total,
                "separate_val_loss_l1_total": sep_val_l1.mean(),
                "validation_step_time": time.perf_counter() - end,
            })
            if sep_val_total < best_val:
                patience_counter = 0
                best_val, best_epoch = sep_val_total, epoch
                if self.checkpoint_dir:
                    path = checkpoints.save_weights(
                        f"{self.checkpoint_dir.rstrip('/')}/{config_hash}.pt", model)
                    logger.info("Model saved at epoch %d to %s", epoch, path)
                test_loss, test_l1 = validation_loss_fn(model, test_i)
                corr_test, corr_test_l1 = float(test_loss.mean()), float(test_l1.mean())
                metric_logger.log({"test_loss": corr_test})
            else:
                patience_counter += 1
                if (self.patience > 0
                        and patience_counter * self.eval_freq >= self.patience
                        and epoch > self.min_epochs):
                    logger.info("Early stopping")
                    break

        logger.info("Best validation loss: %s, test loss: %s, L1 test loss: %s, epoch: %s",
                    best_val, corr_test, corr_test_l1, best_epoch)
        metric_logger.log({"validation_loss": best_val, "corr_test_loss": corr_test,
                           "best_epoch": best_epoch})
        metric_logger.close()
        return {
            "validation_loss": best_val,
            "corr_test_loss": corr_test,
            "best_epoch": best_epoch,
            "train_losses": train_losses,
            "train_step_s": step_times,
            "solver_steps": solver_steps,
            "control_bytes": control_bytes,
            "device": str(device),
        }
