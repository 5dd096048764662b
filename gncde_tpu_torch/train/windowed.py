"""Windowed-task trainers: the shared epoch loop and the TGB trainer.

Counterpart of ``gncde_tpu/train/windowed.py`` (``_WindowedTrainerBase`` and
``TGBTrainer``; reference src/engine/trainer_tgb.py): one window per step,
the masked softmax cross-entropy over the active source rows as the loss,
NDCG@10 on the validation windows as the selection metric (higher wins),
``eval_at_init`` making the initial model a selection candidate, patience,
and the same log lines. Every window is moved to the run's device once,
before the first step. ``batch_windows``, ``sparse_control`` and the
``listwise``/``hinge`` losses are refused when the config is read (not
ported yet); keys the port does not read, such as the sparse-control and
ranking-loss settings, are dropped, as the JAX schema's extra="ignore"
drops unknown ones.
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

from ..configs import OptimiserCfg, Schema, TGBDataSetCfg, TGBGraphNeuralCDECfg, WandBConfig
from ..configs._schema import required
from . import checkpoints
from .logging import MetricLogger
from .metrics import masked_mean_ndcg
from .trainer import make_step_fn, resolve_device

logging.basicConfig(level=logging.INFO)


def _to_device(window: tp.Dict, device) -> tp.Dict:
    """A window dict as tensors on ``device`` with a leading batch dim of 1."""
    def put(v):
        if isinstance(v, (tuple, list)):
            return tuple(put(x) for x in v)
        return torch.as_tensor(np.asarray(v)).unsqueeze(0).to(device)

    return {k: put(v) for k, v in window.items()}


@dataclasses.dataclass
class WindowedTrainerBase(Schema):
    """The epoch loop shared by the windowed tasks. Task hooks:
    ``_data_tuple(window)``, ``_loss(model, data_i)``,
    ``_eval_metrics(model, data_i)`` and ``_selection(metrics)`` (lower is
    better)."""

    _extra: tp.ClassVar[str] = "ignore"

    wandb: WandBConfig = dataclasses.field(default_factory=WandBConfig)
    epochs: int = 2000
    patience: int = -1
    min_epochs: int = 100
    seed: int = 1234
    log_freq: int = 10
    eval_freq: int = 10
    checkpoint_dir: str = ".checkpoints/"
    checkpoint_name: str = "model"
    optimiser: OptimiserCfg = required()
    logger_name: str = "gncde"
    metrics_jsonl: tp.Optional[str] = None
    batch_windows: bool = False
    sparse_control: bool = False
    eval_at_init: bool = True
    #: "cuda" (the default: raises without a card), "cuda:<i>" or "cpu".
    device: str = "cuda"

    def validate(self) -> None:
        for knob in ("batch_windows", "sparse_control"):
            if getattr(self, knob):
                raise NotImplementedError(f"{knob} is not ported yet (see ROADMAP)")

    def _hash_config(self) -> str:
        config_str = json.dumps(self.to_dict(), sort_keys=True, default=str)
        return hashlib.md5(config_str.encode()).hexdigest()

    def run(self) -> tp.Dict[str, tp.Any]:
        random.seed(self.seed)
        np.random.seed(self.seed)
        torch.manual_seed(self.seed)
        device = resolve_device(self.device)
        config_hash = self._hash_config()
        logger = logging.getLogger(self.logger_name)
        logger.setLevel(logging.INFO)
        logger.info(self)

        loaders = [self.dataset.get_training_data(), self.dataset.get_validation_data(),
                   self.dataset.get_test_data()]
        logger.info("Data loading done: %d/%d/%d windows", *map(len, loaders))
        train_w, val_w, test_w = ([_to_device(w, device) for w in loader]
                                  for loader in loaders)

        model = self.model.build(torch.Generator().manual_seed(self.seed)).to(device)
        metric_logger = MetricLogger(project=self.wandb.project, mode=self.wandb.mode,
                                     jsonl_path=self.metrics_jsonl, config=self.to_dict())
        metric_logger.log({"num_params": sum(p.numel() for p in model.parameters())})
        optimiser, schedule = self.optimiser.build(model.parameters())
        step = make_step_fn(optimiser, schedule, self._loss,
                            self.optimiser.gradient_clipping)

        best_selection, best_epoch = np.inf, 0
        final_test_metrics: tp.Dict[str, float] = {}
        val_metrics: tp.Dict[str, float] = {}
        patience_counter = 0

        def eval_and_select(epoch, train_loss=None) -> bool:
            """Shared eval + best-model selection; True on improvement."""
            nonlocal best_selection, best_epoch, final_test_metrics, patience_counter
            nonlocal val_metrics
            t0 = time.perf_counter()
            val_metrics = self._eval_windows(model, val_w)
            val_metrics["validation_step_time"] = time.perf_counter() - t0
            metric_logger.log(val_metrics)
            logger.info("Epoch: %04d, %s", epoch + 1, val_metrics)
            if not val_w:
                # No validation windows (tiny split): select on train loss.
                if train_loss is None:
                    return False
                selection = train_loss
            else:
                selection = self._selection(val_metrics)
            if selection < best_selection:
                patience_counter = 0
                best_selection, best_epoch = selection, epoch
                if self.checkpoint_dir:
                    path = checkpoints.save_weights(
                        f"{self.checkpoint_dir.rstrip('/')}/{config_hash}.pt", model)
                    logger.info("Model saved at epoch %d to %s", epoch, path)
                final_test_metrics = {
                    f"test_{k.replace('validation_', '')}": v
                    for k, v in self._eval_windows(model, test_w).items()}
                metric_logger.log(final_test_metrics)
                return True
            patience_counter += 1
            return False

        if self.eval_at_init and val_w:
            eval_and_select(-1)  # best_epoch == -1: the initial model won

        train_losses, step_times = [], []
        for epoch in range(self.epochs):
            train_loss, max_grad, max_update = 0.0, 0.0, 0.0
            start_time = time.perf_counter()
            for window in train_w:
                t0 = time.perf_counter()
                loss, g, u = step(model, self._data_tuple(window))
                loss = float(loss)  # waits for the step to finish
                step_times.append(time.perf_counter() - t0)
                train_losses.append(loss)
                train_loss += loss
                max_grad = max(max_grad, float(g))
                max_update = max(max_update, float(u))
            train_loss /= max(len(train_w), 1)
            end_time = time.perf_counter()
            metric_logger.log({"train_loss": train_loss,
                               "train_step_time": end_time - start_time,
                               "max_grad": max_grad, "max_update": max_update})
            if epoch == 0 or (epoch + 1) % self.log_freq == 0:
                logger.info("Epoch: %04d, Train Loss: %s, Step Time: %.4fs, LR: %s",
                            epoch + 1, train_loss, end_time - start_time, schedule(epoch))
            if (epoch + 1) % self.eval_freq == 0:
                if not eval_and_select(epoch, train_loss=train_loss):
                    if (self.patience > 0
                            and patience_counter * self.eval_freq >= self.patience
                            and epoch > self.min_epochs):
                        logger.info("Early stopping")
                        break

        summary = {"best_selection": best_selection, "best_epoch": best_epoch,
                   **final_test_metrics}
        logger.info("Final: %s", summary)
        metric_logger.log({"best_epoch": best_epoch})
        metric_logger.close()
        return {**summary, "validation_metrics": val_metrics,
                "train_losses": train_losses, "train_step_s": step_times,
                "device": str(device)}

    @torch.no_grad()
    def _eval_windows(self, model, windows) -> tp.Dict[str, float]:
        totals: tp.Dict[str, float] = {}
        for window in windows:
            for k, v in self._eval_metrics(model, self._data_tuple(window)).items():
                totals[k] = totals.get(k, 0.0) + float(v)
        return {k: v / max(len(windows), 1) for k, v in totals.items()}


def _masked_ce(y_pred, label, mask) -> torch.Tensor:
    """Per-window masked softmax cross-entropy over the active source rows."""
    ce = (-label * torch.log_softmax(y_pred, -1)).sum(-1)
    return torch.where(mask, ce, torch.zeros_like(ce)).sum(-1) / mask.sum(-1)


@dataclasses.dataclass
class TGBTrainer(WindowedTrainerBase):
    """Reference src/engine/trainer_tgb.py: trains masked softmax CE and
    selects on validation NDCG@10."""

    model: TGBGraphNeuralCDECfg = required()
    dataset: TGBDataSetCfg = required()
    loss_type: tp.Literal["ce", "listwise", "hinge"] = "ce"

    def validate(self) -> None:
        super().validate()
        if self.loss_type != "ce":
            raise NotImplementedError(
                f"loss_type {self.loss_type!r} is not ported yet (see ROADMAP)")

    @staticmethod
    def _data_tuple(d):
        return (d["start_time"], d["t"], d["graph_path_coeffs"], d["x_t"],
                d["true_y0"], d["true_y"], d["source_mask"])

    @staticmethod
    def _predict(model, data_i):
        start_time, t_i, adj_coeffs, x_t, x0, label, mask = data_i
        return model(t_i, adj_coeffs, x_t, x0, start_time), label, mask

    def _loss(self, model, data_i):
        return _masked_ce(*self._predict(model, data_i)).mean()

    def _eval_metrics(self, model, data_i):
        y_pred, label, mask = self._predict(model, data_i)
        return {"validation_loss": _masked_ce(y_pred, label, mask).mean(),
                "validation_ndcg@10": masked_mean_ndcg(label, y_pred, mask, k=10).mean()}

    def _selection(self, metrics):
        # Reference selects on max NDCG (trainer_tgb.py:261-285).
        return -metrics["validation_ndcg@10"]
