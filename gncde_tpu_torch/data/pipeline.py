"""Control-path assembly: padding dynamic graphs over time, stacking the time
channel, interpolation coefficients, and the train/test data dicts.

Counterpart of ``gncde_tpu/data/pipeline.py``; the data-dict keys are the
same. Everything here is batched over a leading dim and runs on the host
CPU in float32.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from ..interp import linear_interpolation, backward_hermite_coefficients
from .ode_dataset import ODEDatasetSpec, ODEDatasetResult, split_train_val_test
from .operators import get_graph_operator


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)


def padding_graph_by_time(adjacencies: torch.Tensor, events_indices, T: int,
                          padding_mode: str = "none") -> torch.Tensor:
    """Repeat each event's adjacency until the next event
    (dataset_configs.py:107-145). adjacencies: (B, E+1, n, n) -> (B, T, n, n)."""
    if events_indices is None:
        return adjacencies[:, None].expand(-1, T, -1, -1)
    event_idx = torch.zeros(T, dtype=torch.int64)
    event_idx[torch.as_tensor(np.asarray(events_indices), dtype=torch.int64)] = 1
    cum = torch.cumsum(event_idx, 0)
    padded = adjacencies[:, cum]
    if padding_mode == "none":
        keep = (event_idx > 0)[None, :, None, None]
        padded = torch.where(keep, padded, torch.tensor(float("nan")))
    return padded


def graph_interpolation_coeffs(ts: torch.Tensor, padded: torch.Tensor,
                               interpolation: str):
    """Channel 0 = time, channel 1 = adjacency (dataset_configs.py:147-173)."""
    t_index = ts[:, :, None, None].expand(padded.shape)
    X = torch.stack([t_index, padded], dim=-1)
    if interpolation == "linear":
        return linear_interpolation(ts, X)
    if interpolation == "cubic":
        return backward_hermite_coefficients(ts, X)
    raise ValueError(f"Unknown interpolation method: {interpolation}")


def prepare_graph_path(ts, adjacencies, events_indices, interpolation: str,
                       padding_mode: str):
    """Truncate to visible events, pad, and compute batched coefficients
    (dataset_configs.py:175-199). ts: (B, T); adjacencies: (B, E+1, n, n)."""
    ts = _f32(ts)
    adjacencies = _f32(adjacencies)
    if events_indices is not None:
        events_indices = np.asarray(events_indices)
        visible = int(np.sum(events_indices < ts.shape[1]))
        adjacencies = adjacencies[:, : visible + 1]
        events_indices = events_indices[:visible]
    else:
        adjacencies = adjacencies if adjacencies.dim() == 3 else adjacencies[:, 0]
    pad = padding_graph_by_time(adjacencies, events_indices, ts.shape[1], padding_mode)
    return graph_interpolation_coeffs(ts, pad, interpolation)


def signal_interpolation_coeffs(ts, signal, interpolation: str):
    """Per-trajectory data-path coefficients (dataset_configs.py:201-234).
    signal: (B, T, n)."""
    ts, signal = _f32(ts), _f32(signal)
    t_index = ts.reshape(ts.shape + (1,) * (signal.dim() - 2)).expand(signal.shape)
    X = torch.stack([t_index, signal], dim=-1)
    if interpolation == "linear":
        return linear_interpolation(ts, X)
    if interpolation == "cubic":
        return backward_hermite_coefficients(ts, X)
    raise ValueError(f"Unknown interpolation method: {interpolation}")


def apply_operator(spec: ODEDatasetSpec, A: np.ndarray, L: np.ndarray) -> torch.Tensor:
    return get_graph_operator(spec.operator_type, _f32(A), _f32(L))


def _common(dataset: ODEDatasetResult, OM: torch.Tensor) -> tp.Dict:
    return {
        "t": _f32(dataset.t),
        "true_y": _f32(dataset.true_y),
        "true_y0": _f32(dataset.x0),
        "A": OM,
        "A_t": (torch.as_tensor(dataset.events_time_indices)
                if dataset.events_time_indices is not None else None),
        "events_time": (_f32(dataset.events_time)
                        if dataset.events_time is not None else None),
        "labels": _f32(dataset.labels),
    }


def get_split_train_data(spec: ODEDatasetSpec, dataset: ODEDatasetResult,
                         interpolation: str) -> tp.Dict:
    """Training data dict (dataset_configs.py:236-283)."""
    id_train, id_test_extra, id_test_inter = split_train_val_test(spec)
    OM = apply_operator(spec, dataset.A, dataset.L)
    data = _common(dataset, OM)
    data.update({
        "train_t": _f32(dataset.t[:, id_train]),
        "train_true_y": _f32(dataset.true_y[:, id_train]),
        "id_train": torch.as_tensor(id_train),
        "id_test_extra": torch.as_tensor(id_test_extra),
        "id_test_inter": (torch.as_tensor(id_test_inter)
                          if id_test_inter is not None else None),
    })
    data["train_graph_path_coeffs"] = prepare_graph_path(
        dataset.t[:, id_train], OM, dataset.events_time_indices, interpolation,
        spec.padding_mode)
    data["val_graph_path_coeffs"] = prepare_graph_path(
        dataset.t, OM, dataset.events_time_indices, interpolation, spec.padding_mode)
    data["y_coeffs"] = signal_interpolation_coeffs(dataset.t, dataset.true_y,
                                                   interpolation)
    return data


def get_split_test_data(spec: ODEDatasetSpec, dataset: ODEDatasetResult,
                        interpolation: str) -> tp.Dict:
    """Held-out data dict (dataset_configs.py:285-322)."""
    OM = apply_operator(spec, dataset.A, dataset.L)
    data = _common(dataset, OM)
    data["test_graph_path_coeffs"] = prepare_graph_path(
        dataset.t, OM, dataset.events_time_indices, interpolation, spec.padding_mode)
    data["y_coeffs"] = signal_interpolation_coeffs(dataset.t, dataset.true_y,
                                                   interpolation)
    return data
