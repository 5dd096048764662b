"""Model factory configs (counterpart of ``gncde_tpu/configs/model_configs.py``
for ``graph_neural_cde`` and ``tgb_graph_neural_cde``)."""

from __future__ import annotations

import dataclasses
import typing as tp

import torch

from ._schema import Schema, required
from .vector_field_configs import VectorFieldCfg

_INTERP = tp.Literal["linear", "rectilinear", "cubic", "cubic_hermite"]
_METHOD = tp.Literal["Tsit5", "Dopri5", "Dopri8", "Bosh3", "Euler", "Heun",
                     "Kvaerno3", "Kvaerno3Picard", "KenCarp4", "Kvaerno4",
                     "Kvaerno5"]
_PORTED_METHODS = ("Tsit5", "Dopri5", "Bosh3", "Euler", "Heun")


@dataclasses.dataclass
class GraphNeuralCDECfg(Schema):
    name: tp.Literal["graph_neural_cde"] = required()
    vector_field: VectorFieldCfg = required()
    hidden_dim: int = 64
    interpolation: _INTERP = "linear"
    use_initial: bool = True
    method: _METHOD = "Tsit5"
    return_sequence: bool = True
    max_steps: int = 512
    adjoint: tp.Literal["checkpointed", "full"] = "checkpointed"

    def validate(self) -> None:
        if self.method not in _PORTED_METHODS:
            raise NotImplementedError(
                f"solver {self.method!r} is not ported yet (ROADMAP Queue 1)")

    def build(self, generator: torch.Generator, device=None):
        from ..models import GraphNeuralCDE

        vector_field = self.vector_field.build(generator, device)
        return GraphNeuralCDE(
            vector_field,
            hidden_dim=self.hidden_dim,
            interpolation=self.interpolation,
            method=self.method,
            return_sequence=self.return_sequence,
            max_steps=self.max_steps,
            adjoint=self.adjoint,
            generator=generator,
            device=device,
        )


@dataclasses.dataclass
class TGBGraphNeuralCDECfg(Schema):
    name: tp.Literal["tgb_graph_neural_cde"] = required()
    vector_field: VectorFieldCfg = required()
    hidden_dim: int = 64
    interpolation: _INTERP = "linear"
    use_initial: bool = True
    method: _METHOD = "Tsit5"
    return_sequence: bool = True
    use_mlps: bool = False
    dt0: float = 0.01
    persistence_head: bool = False
    adjoint: tp.Literal["checkpointed", "full"] = "checkpointed"

    def validate(self) -> None:
        if self.method not in _PORTED_METHODS:
            raise NotImplementedError(
                f"solver {self.method!r} is not ported yet (ROADMAP Queue 1)")
        if self.use_mlps:
            raise NotImplementedError("use_mlps (MLP encoder/decoder) is not ported yet")
        if self.interpolation not in ("linear", "cubic"):
            raise NotImplementedError(
                f"interpolation {self.interpolation!r} is not ported yet")

    def build(self, generator: torch.Generator, device=None):
        from ..models import TGBGraphNeuralCDE

        vector_field = self.vector_field.build(generator, device)
        return TGBGraphNeuralCDE(
            vector_field,
            hidden_dim=self.hidden_dim,
            interpolation=self.interpolation,
            method=self.method,
            return_sequence=self.return_sequence,
            dt0=self.dt0,
            persistence_head=self.persistence_head,
            adjoint=self.adjoint,
            generator=generator,
            device=device,
        )
