"""Optimiser and learning-rate schedule configs.

Counterpart of ``gncde_tpu/configs/optimiser_configs.py`` (same field names
and literals). The optax chain maps to torch as:

* ``adamw`` -> ``torch.optim.AdamW`` (b1 0.9, b2 0.999, eps 1e-8, decoupled
  decay ``p -= lr * (adam_update + wd * p)``, the same as optax). The schema
  accepts ``adam`` and ``sgd`` as the JAX one does, but they and the
  warmup-cosine schedule are not ported yet (ROADMAP Queue 1).
* ``gradient_clipping`` -> :func:`clip_by_global_norm` (by hand, because
  ``clip_grad_norm_`` adds 1e-6 to the norm).
* a schedule is a function of the update count; the trainer writes its
  value into the optimiser's learning rate before every step.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import torch

from ._schema import Schema, required


@dataclasses.dataclass
class ConstantScheduleCfg(Schema):
    name: tp.Literal["constant_schedule"] = "constant_schedule"
    value: float = 0.01

    def build(self) -> tp.Callable[[int], float]:
        return lambda step: self.value


@dataclasses.dataclass
class OptimiserCfg(Schema):
    name: tp.Literal["adam", "sgd", "adamw"] = required()
    weight_decay: float = 0.0
    schedule: ConstantScheduleCfg = required()
    gradient_clipping: bool = required()

    def validate(self) -> None:
        if self.name != "adamw":
            raise NotImplementedError(
                f"optimiser {self.name!r} is not ported yet (see ROADMAP)")

    def build(self, params) -> tp.Tuple[torch.optim.Optimizer, tp.Callable[[int], float]]:
        """(optimiser, schedule)."""
        schedule = self.schedule.build()
        opt = torch.optim.AdamW(params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=self.weight_decay)
        return opt, schedule


def clip_by_global_norm(grads: tp.Sequence[torch.Tensor], max_norm: float = 1.0):
    """optax.clip_by_global_norm: ``g`` unchanged when ``||g|| < max_norm``,
    else ``g / ||g|| * max_norm``. Returns the unclipped global norm."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm
