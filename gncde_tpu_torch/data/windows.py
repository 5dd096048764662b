"""Sliding-window machinery for the TGB snapshot datasets.

Counterpart of the TGB part of ``gncde_tpu/data/windows.py`` (reference
src/dataset/tgb_dataset.py and dataset_configs.py:615-811): disjoint
shuffled window starts split 60/20/20, the last snapshot of a window is the
target, the window body (``window[:-1]``) forms the control path with knot
times 0..T-2, node features default to the adjacency rows, and the
interpolation coefficients are computed once per window.

Window dicts hold numpy arrays. Keys the TGB CDE never reads are left out:
``A``, ``A_t``, ``events_time`` and ``x_coeffs`` (at tgbn-genre scale
``x_coeffs`` alone is about 580 MB of host memory per window). And
``graph_path_coeffs`` holds only the adjacency (value) channel of the JAX
window's stacked ``[time, value]`` coefficients -- the channel the slim
control keeps -- as ``(d, c, b, a)``, each ``(T-1, n, n)``, for cubic
interpolation, or the knot values ``(T, n, n)`` for linear.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np
import torch

from ..interp import backward_hermite_coefficients, linear_interpolation


@dataclasses.dataclass
class Snapshot:
    adj: np.ndarray  # (n, n) dense weighted adjacency
    x: tp.Optional[np.ndarray] = None  # (n, d) node features
    y: tp.Optional[np.ndarray] = None  # targets
    t: float = 0.0
    src: tp.Optional[np.ndarray] = None  # active source nodes (TGB)


def to_dense_adj(src: np.ndarray, dst: np.ndarray,
                 edge_attr: tp.Optional[np.ndarray], num_nodes: int) -> np.ndarray:
    """Dense weighted float32 adjacency; duplicate edges accumulate in edge
    order (torch_geometric's to_dense_adj, dataset_configs.py:676-680)."""
    A = np.zeros((num_nodes, num_nodes), dtype=np.float32)
    w = (np.ones(len(src), dtype=np.float32) if edge_attr is None
         else np.asarray(edge_attr, dtype=np.float32))
    np.add.at(A, (np.asarray(src), np.asarray(dst)), w)
    return A


def sample_disjoint_window_starts(num_snapshots: int, window_size: int, stride: int,
                                  split_ratio: tp.Sequence[float],
                                  rng: np.random.Generator):
    """Shuffled disjoint train/val/test window start indices
    (dataset_configs.py:692-716)."""
    window_starts = np.arange(0, num_snapshots - window_size + 1, stride)
    rng.shuffle(window_starts)
    num_train = int(len(window_starts) * split_ratio[0])
    num_val = int(len(window_starts) * split_ratio[1])
    train = window_starts[:num_train]
    val = window_starts[num_train:num_train + num_val]
    test = window_starts[num_train + num_val:]
    return train, val, test


def _softmax_rows(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def adjacency_coeffs(times: np.ndarray, A: np.ndarray, interpolation: str):
    """Value-channel path coefficients of the adjacency samples ``A``
    (T, n, n): the channel the slim control reads."""
    ts, ys = torch.from_numpy(times), torch.from_numpy(A)
    if interpolation == "linear":
        return linear_interpolation(ts, ys).numpy()
    if interpolation == "cubic":
        return tuple(c.numpy() for c in backward_hermite_coefficients(ts, ys))
    raise ValueError(f"Unknown interpolation method: {interpolation}")


def process_window_tgb(window: tp.List[Snapshot], interpolation: str,
                       normalise_features: bool = False) -> tp.Dict:
    """TGB window dict (dataset_configs.py:772-811), keys as above."""
    last = window[-1]
    body = window[:-1]
    times = np.arange(len(body), dtype=np.float32)
    num_nodes = last.x.shape[0]
    source_mask = np.isin(np.arange(num_nodes), last.src)
    if normalise_features:
        x_t = np.stack([_softmax_rows(s.x) for s in body])
    else:
        x_t = np.stack([s.x for s in body])
    return {
        "t": times,
        "true_y": last.x,
        "true_y0": body[0].x,
        "x_t": x_t,
        "source_mask": source_mask,
        "start_time": np.float32(body[0].t),
        "graph_path_coeffs": adjacency_coeffs(
            times, np.stack([s.adj for s in body]), interpolation),
    }


class WindowLoader:
    """The processed window dicts in order (the reference's DataLoader with
    identity collate and no shuffling, tgb_dataset.py:202-218)."""

    def __init__(self, windows: tp.List[tp.Dict]):
        self.windows = windows

    def __len__(self):
        return len(self.windows)

    def __iter__(self):
        return iter(self.windows)
