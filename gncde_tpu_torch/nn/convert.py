"""Parameter exchange between the JAX package and the port.

The JAX package's parameters are a dict of numpy arrays keyed by leaf path
(``gncde_tpu/nn/module.py`` ``_leaf_key``: field names and list indices
joined by ``/``, e.g. ``vector_field/gnn_layers/0/conv_layer/linear/weight``).
The port's modules use the same attribute names, so a leaf path maps to a
``state_dict`` key by swapping ``/`` for ``.``. Layouts agree: ``Linear``
weights are ``(out, in)`` on both sides, and each fusion layer keeps its
basis as 2-vectors: ``param1 .. param8``, and for the directed layer also
``param4_prime``, ``param5_prime`` and ``param6_prime``.

``save_weights`` of the JAX package writes the leaves as ``leaf_<i>`` in
flatten order: the field order of each module, a module shared by two
fields appearing once per field (the TGB model's vector field also sits
inside its CDE wrapper). :func:`jax_leaf_names` lists the port's parameters
in that order: a module's own parameters, then its children, in
registration order, unless the module names its JAX field order in
``JAX_FIELDS``. A parameter listed twice takes the later array, as the JAX
model's forward reads the wrapper's copy. An enc_idx field registers
``idx_enc`` (its ``module``), ``msg_func_adj`` and ``msg_func_adj_deriv``
(their ``layers[*]``) after ``gnn_layers``, the JAX field order. The
directed layer and field name theirs in ``JAX_FIELDS``: the layer's primed
parameters sit between the unprimed ones (``param4, param4_prime, param5,
...``), and the directed field lists ``idx_enc`` and both MLPs, which it
builds even without enc_idx, as the JAX field does.
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


def jax_leaf_names(model: nn.Module, prefix: str = "") -> tp.List[str]:
    """``state_dict`` names of ``model``'s parameters in JAX flatten order."""
    fields = getattr(model, "JAX_FIELDS", None)
    if fields is None:
        fields = list(model._parameters) + list(model._modules)
    names = []
    for f in fields:
        v = getattr(model, f)
        if isinstance(v, nn.Parameter):
            names.append(prefix + f)
        elif isinstance(v, nn.Module):
            names += jax_leaf_names(v, f"{prefix}{f}.")
    return names


def load_leaves(model: nn.Module, leaves: tp.Sequence[np.ndarray]) -> None:
    """Load arrays given in JAX flatten order (``leaf_0, leaf_1, ...``)."""
    names = jax_leaf_names(model)
    if len(names) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves for {len(names)} parameters")
    params = model.state_dict(keep_vars=True)
    with torch.no_grad():
        for name, arr in zip(names, leaves):
            p, arr = params[name], np.asarray(arr)
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
    params = model.state_dict()
    arrays = {f"leaf_{i}": params[name].cpu().numpy()
              for i, name in enumerate(jax_leaf_names(model))}
    np.savez(path, **arrays)
