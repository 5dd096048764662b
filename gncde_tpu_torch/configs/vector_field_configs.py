"""Vector-field factory config (counterpart of
``gncde_tpu/configs/vector_field_configs.py``). Every name of the JAX
schema validates; ``PermEquivGraphVectorField`` and
``PermEquivDirGraphVectorField``, each with or without ``enc_idx``, build
in the port.

One rule differs from the JAX package: a controlled enc_idx field (of
either basis) emits ``H * E * 2`` entries like every other controlled
field, so that the CDE wrapper can contract it with the data path. The JAX rule gives it ``H``
entries, and ``TGBGraphNeuralCDE`` then fails the wrapper's reshape
(ROADMAP Queue 3 item 3, closed by ruling: ``H * E * 2`` stands)."""

from __future__ import annotations

import dataclasses
import typing as tp

import torch

from ._schema import Schema, required

_PORTED = ("PermEquivGraphVectorField", "PermEquivDirGraphVectorField")


@dataclasses.dataclass
class VectorFieldCfg(Schema):
    name: tp.Literal[
        "ConstVectorField",
        "GNODEVectorField",
        "GNODEFloorVectorField",
        "PermEquivGraphVectorField",
        "PermEquivDirGraphVectorField",
        "GraphVectorField",
        "PreMultFusionGraphVectorField",
        "STGraphVectorField",
    ] = required()
    hidden_dim: int = 64
    data_embed_dim: int = 16
    node_embed_dim: int = 16
    num_layers: int = 4
    use_control: bool = True
    cheb_k: int = 3
    num_nodes: int = 0
    enc_idx: bool = False
    enc_type: str = "mlp"
    idx_dim: int = 512

    def validate(self) -> None:
        if self.name not in _PORTED:
            raise NotImplementedError(
                f"vector field {self.name!r} is not ported yet (see ROADMAP)")

    def _output_dim(self) -> int:
        """Reference rule: a controlled field emits H * E * 2 entries."""
        if not self.use_control:
            return self.hidden_dim
        return self.hidden_dim * self.data_embed_dim * 2

    def build(self, generator: torch.Generator, device=None):
        from ..models import vector_fields

        cls = getattr(vector_fields, self.name)
        # As the JAX package: enc_type and idx_dim reach the field only with
        # enc_idx, so the directed field's unused index encoder and MLPs
        # take the field's defaults otherwise.
        kw = {}
        if self.use_control and self.enc_idx:
            kw = dict(enc_idx=True, enc_type=self.enc_type, idx_dim=self.idx_dim)
        return cls(
            input_dim=self.hidden_dim,
            hidden_dim=self.hidden_dim,
            output_dim=self._output_dim(),
            num_layers=self.num_layers,
            data_embed_dim=self.data_embed_dim,
            num_nodes=self.num_nodes,
            generator=generator,
            device=device,
            **kw,
        )
