"""Loss configs for the dynamical-systems task (counterpart of
``gncde_tpu/configs/loss_configs.py``, MSE). The JAX loss vmaps the model
over the batch; the port's model takes the batch as a leading dim."""

from __future__ import annotations

import dataclasses
import typing as tp

import torch

from ._schema import Schema, required


def _predict(model, data_i, **kw):
    t_i, coeffs_adj_i, label_i, x0_i = data_i
    return model(t_i, coeffs_adj_i, x0_i, **kw).squeeze(-1), label_i


@dataclasses.dataclass
class MSELossCfg(Schema):
    name: tp.Literal["MSE"] = required()

    @staticmethod
    def mse_loss(model, data_i) -> torch.Tensor:
        pred_y, label_i = _predict(model, data_i)
        return ((pred_y - label_i) ** 2).mean()

    @staticmethod
    @torch.no_grad()
    def validation_mse_loss(model, data_i):
        """Per-timestep (MSE, MAE) over nodes, each (B, T)."""
        pred_y, label_i = _predict(model, data_i, adjoint="full")
        diff = pred_y - label_i
        return (diff ** 2).mean(-1), diff.abs().mean(-1)

    def build(self):
        return self.mse_loss

    def build_validation_loss(self):
        return self.validation_mse_loss
