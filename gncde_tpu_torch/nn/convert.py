"""Parameter exchange between the JAX package and the port.

The JAX package's parameters are a dict of numpy arrays keyed by leaf path
(``gncde_tpu/nn/module.py`` ``_leaf_key``: field names and list indices
joined by ``/``, e.g. ``vector_field/gnn_layers/0/conv_layer/linear/weight``).
The port's modules use the same attribute names, so a leaf path maps to a
``state_dict`` key by swapping ``/`` for ``.``. Layouts agree: ``Linear``
weights are ``(out, in)`` on both sides, and each fusion layer keeps its
basis as eight 2-vectors ``param1 .. param8``.

``save_weights`` of the JAX package writes the leaves as ``leaf_<i>`` in
flatten order; the port registers its parameters in the JAX field order, so
``named_parameters()`` order is that flatten order.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch
from torch import nn


def to_state_dict(params: tp.Mapping[str, np.ndarray],
                  device: torch.device | str | None = None
                  ) -> tp.Dict[str, torch.Tensor]:
    """JAX leaf-path dict -> port ``state_dict``."""
    return {
        k.replace("/", "."): torch.tensor(np.asarray(v, np.float32), device=device)
        for k, v in params.items()
    }


def from_state_dict(sd: tp.Mapping[str, torch.Tensor]) -> tp.Dict[str, np.ndarray]:
    """Port ``state_dict`` -> JAX leaf-path dict of numpy arrays."""
    return {k.replace(".", "/"): v.detach().cpu().numpy() for k, v in sd.items()}


def load_leaves(model: nn.Module, leaves: tp.Sequence[np.ndarray]) -> None:
    """Load arrays given in JAX flatten order (``leaf_0, leaf_1, ...``)."""
    params = list(model.named_parameters())
    if len(params) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves for {len(params)} parameters")
    with torch.no_grad():
        for (name, p), arr in zip(params, leaves):
            arr = np.asarray(arr)
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {arr.shape} != {tuple(p.shape)}")
            p.copy_(torch.as_tensor(arr, dtype=p.dtype))


def load_jax_npz(model: nn.Module, path: str) -> None:
    """Load a ``gncde_tpu`` ``save_weights`` file into ``model``."""
    data = np.load(path)
    keys = sorted((k for k in data.files if k.startswith("leaf_")),
                  key=lambda k: int(k.split("_")[1]))
    load_leaves(model, [data[k] for k in keys])


def save_jax_npz(model: nn.Module, path: str) -> None:
    """Write ``model``'s parameters as a ``gncde_tpu`` ``save_weights`` file."""
    arrays = {f"leaf_{i}": p.detach().cpu().numpy()
              for i, (_, p) in enumerate(model.named_parameters())}
    np.savez(path, **arrays)
