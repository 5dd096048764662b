"""Weight snapshots (counterpart of ``gncde_tpu/train/checkpoints.py``
``save_weights`` / ``load_weights``) through ``torch.save``. Full-state
resume and the async checkpointer are not ported yet (ROADMAP)."""

from __future__ import annotations

from pathlib import Path

import torch
from torch import nn


def save_weights(path: str, model: nn.Module) -> str:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    torch.save(model.state_dict(), path)
    return path


def load_weights(path: str, model: nn.Module) -> nn.Module:
    model.load_state_dict(torch.load(path, map_location="cpu"))
    return model
