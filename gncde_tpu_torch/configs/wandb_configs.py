"""Experiment-tracking config (counterpart of
``gncde_tpu/configs/wandb_configs.py``)."""

from __future__ import annotations

import dataclasses
import typing as tp

from ._schema import Schema


@dataclasses.dataclass
class WandBConfig(Schema):
    _extra: tp.ClassVar[str] = "ignore"

    project: str = "GNCDEs"
    mode: str = "auto"  # auto | disabled ("auto" uses wandb when installed)
