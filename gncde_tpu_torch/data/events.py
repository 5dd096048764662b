"""Dynamic-graph event machinery: when the topology changes and how.

The port's copy of ``gncde_tpu/data/events.py`` (numpy only), kept here so
the port imports nothing of the JAX package. Reference: src/dataset/data_tools.py:75-158. Note the reference's
``gen_events_happen_time`` is broken for ``enable_all_dynamic=False`` (returns
``np.stack`` of an empty list -- enshrined by a reference test); here that
branch is implemented to the obvious intent (shared event indices across the
batch) while the all-dynamic branch matches the reference.
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np


def gen_events_happen_time(
    t: np.ndarray,
    event_times: int,
    split_ratio: tp.Sequence[float],
    enable_all_dynamic: bool = False,
    rng: tp.Optional[np.random.Generator] = None,
):
    """Sample event indices/times per batch element.

    Returns (event_t, event_indices): event_t is (batch, E); event_indices is
    (E,) -- shared across the batch, as in the reference (only the last batch
    element's indices are returned there; with a shared permutation stream the
    per-element draws coincide only by accident, so we draw once and share,
    which is the consistent interpretation the downstream padding code
    assumes: dataset_configs.py:189-198 applies a single index vector).
    """
    if rng is None:
        rng = np.random.default_rng()
    batch_size, num_t = t.shape
    n_train = int(num_t * split_ratio[0])

    if not enable_all_dynamic:
        random_indices = rng.permutation(n_train - 2) + 2
        event_indices = np.sort(random_indices[:event_times])
        event_ts = np.stack([t[i, event_indices] for i in range(batch_size)], axis=0)
        return event_ts, event_indices

    train_event_times = math.ceil(event_times * split_ratio[0])
    test_event_time = event_times - train_event_times
    train_random_indices = rng.permutation(n_train - 2) + 2
    test_random_indices = rng.permutation(num_t - n_train) + n_train
    event_indices = np.sort(
        np.concatenate(
            [
                train_random_indices[:train_event_times],
                test_random_indices[:test_event_time],
            ]
        )
    )
    event_ts = np.stack([t[i, event_indices] for i in range(batch_size)], axis=0)
    return event_ts, event_indices


def gen_events_happen_graph(
    A: np.ndarray,
    event_times: int,
    p: float = 0.1,
    rng: tp.Optional[np.random.Generator] = None,
):
    """Chain of randomly perturbed graphs: drop edges w.p. 20p, add w.p. p.

    Reference data_tools.py:111-158. Returns (A_list, D_list, L_list), each a
    list of length event_times+1 of (batch, n, n) arrays.
    """
    if rng is None:
        rng = np.random.default_rng()
    batch_size, n, _ = A.shape
    idx = np.arange(n)

    def dl(a):
        D = np.zeros_like(a)
        D[..., idx, idx] = a.sum(axis=-1)
        return D, D - a

    D, L = dl(A)
    A_list, D_list, L_list = [A.copy()], [D.copy()], [L.copy()]

    for _ in range(event_times):
        A_new = A.copy()
        drop = rng.binomial(1, min(20 * p, 1.0), size=A.shape).astype(bool)
        A_new[drop] = 0.0
        add = rng.binomial(1, p, size=A.shape).astype(bool)
        A_new[add] = 1.0
        D_new, L_new = dl(A_new)
        A_list.append(A_new.copy())
        D_list.append(D_new.copy())
        L_list.append(L_new.copy())
        A = A_new

    return A_list, D_list, L_list
