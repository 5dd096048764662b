"""Synthetic dynamical-systems dataset generation (heat).

Counterpart of ``gncde_tpu/data/ode_dataset.py``. The random draws are
numpy's (``np.random.default_rng(spec.seed)``) in the same order as the JAX
package, so both packages build the same time grids, initial states and
graph events; the numpy helpers for events and rectangles are the port's
own copies (``data/events.py``, ``data/misc_rect.py``). The ground truth is
a constant-step solve with the port's solver on the host CPU in float32
(``adjoint="none"``), one batched solve per graph segment -- preprocessing,
not the training hot path.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np
import torch

from ..solve import ODETerm, SaveAt, ConstantStepSize, diffeqsolve
from . import ode_systems
from .events import gen_events_happen_time, gen_events_happen_graph
from .misc_rect import sample_non_overlapping_rect
from .graph_gen import generate_graphs, degree_laplacian


@dataclasses.dataclass
class ODEDatasetSpec:
    name: str  # heat (the only system ported)
    batch_size: int = 1
    dynamic_graph: bool = False
    all_dynamic: bool = False
    graph_type: str = "grid"
    split_ratio: tp.Sequence[float] = (0.8, 0.2)
    num_nodes: int = 400
    final_time: float = 5.0
    time_tick: int = 100
    sampling_type: str = "irregular"
    method: str = "Dopri5"
    dt0: float = 0.01
    layout: str = "community"
    operator_type: str = "norm_lap"
    padding_mode: str = "same"
    seed: int = 1234
    amp_range: tp.Tuple[float, float] = (0.5, 1.0)
    beta: tp.Tuple[float, float] = (0.5, 1.0)
    gamma: tp.Tuple[float, float] = (0.3, 1.0)
    sparse_scale: int = 10
    event_times: int = 10
    event_p: float = 0.001


@dataclasses.dataclass
class ODEDatasetResult:
    t: np.ndarray  # (B, T)
    x0: np.ndarray  # (B, n, 1)
    true_y: np.ndarray  # (B, T, n)
    A: np.ndarray  # (B, n, n) static or (B, E+1, n, n) dynamic
    D: np.ndarray
    L: np.ndarray
    labels: np.ndarray
    events_time: tp.Optional[np.ndarray]  # (B, E)
    events_time_indices: tp.Optional[np.ndarray]  # (E,)
    spec: ODEDatasetSpec


def _check_ported(spec: ODEDatasetSpec) -> None:
    if spec.name.lower() != "heat" or spec.graph_type == "mixed":
        raise NotImplementedError(
            f"dataset {spec.name!r} on {spec.graph_type!r} graphs is not ported "
            "yet (heat on grid only; see ROADMAP)")


def gen_sampling_time(spec: ODEDatasetSpec, rng: np.random.Generator, batch: int):
    """Reference ode_dataset.py:303-342."""
    if spec.sampling_type == "equal":
        t = np.linspace(0.0, spec.final_time, spec.time_tick)
        return np.tile(t, (batch, 1))
    if spec.sampling_type == "irregular":
        t_full = np.linspace(0.0, spec.final_time, spec.time_tick * spec.sparse_scale)
        num_points = int(spec.time_tick * 1.2)
        rows = []
        for _ in range(batch):
            sel = np.sort(rng.permutation(t_full)[:num_points])
            sel[0] = 0.0
            rows.append(sel)
        return np.stack(rows, axis=0)
    raise ValueError(f"{spec.sampling_type} sampling is not supported")


def initialize_states(spec: ODEDatasetSpec, rng: np.random.Generator, batch: int):
    """Patch-amplitude grid initialisation (reference ode_dataset.py:93-140)."""
    N = int(np.ceil(np.sqrt(spec.num_nodes)))
    x0 = np.zeros((batch, N, N))
    center_sizes = [(0.20, 0.20), (0.30, 0.30), (0.20, 0.30)]
    for i in range(batch):
        existing: list = []
        for frac_h, frac_w in center_sizes:
            h = max(1, int(frac_h * N))
            w = max(1, int(frac_w * N))
            r1, c1, r2, c2 = sample_non_overlapping_rect(N, h, w, existing, rng=rng)
            existing.append((r1, c1, r2, c2))
            x0[i, r1:r2, c1:c2] = rng.uniform(*spec.amp_range)
    return x0.reshape(batch, -1, 1)


def solve_segment(spec: ODEDatasetSpec, L: np.ndarray, A: np.ndarray,
                  x0: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Batched constant-step ground-truth solve of one graph segment on the
    host CPU. Returns ys of shape (B, T_seg, n, C)."""
    max_steps = int(np.ceil(spec.final_time / spec.dt0)) + 4
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32)  # noqa: E731
    t_ = f32(t)
    vf = ode_systems.make_system(spec.name, f32(A), f32(L))
    sol = diffeqsolve(
        ODETerm(lambda tt, y, args: vf(tt, y)), spec.method,
        t0=t_[:, 0], t1=t_[:, -1], dt0=spec.dt0, y0=f32(x0),
        stepsize_controller=ConstantStepSize(), saveat=SaveAt(ts=t_),
        max_steps=max_steps, adjoint="none",
    )
    return sol.ys.numpy()


def generate(spec: ODEDatasetSpec) -> ODEDatasetResult:
    _check_ported(spec)
    rng = np.random.default_rng(spec.seed)
    batch = spec.batch_size

    event_times = spec.event_times
    if spec.all_dynamic:
        event_times += int(event_times / spec.split_ratio[0] * spec.split_ratio[1])

    t = gen_sampling_time(spec, rng, batch)
    x0 = initialize_states(spec, rng, batch)
    labels = np.zeros(batch)

    A = generate_graphs(spec.graph_type, spec.num_nodes, batch, spec.seed, spec.layout)
    D, L = degree_laplacian(A)

    if not spec.dynamic_graph:
        ys = solve_segment(spec, L, A, x0, t)
        events_time, event_indices = None, None
        A_out, D_out, L_out = A, D, L
    else:
        events_time, event_indices = gen_events_happen_time(
            t, event_times, spec.split_ratio, spec.all_dynamic, rng=rng)
        event_times = len(event_indices)
        A_list, D_list, L_list = gen_events_happen_graph(
            A, event_times, spec.event_p, rng=rng)
        segments = []
        state = x0
        for k in range(len(A_list)):
            if k == 0:
                t_seg = t[:, : event_indices[0]]
            elif k == event_times:
                t_seg = t[:, event_indices[k - 1]:]
            else:
                t_seg = t[:, event_indices[k - 1]: event_indices[k]]
            if t_seg.shape[1] == 0:
                continue
            ys_seg = solve_segment(spec, L_list[k], A_list[k], state, t_seg)
            state = ys_seg[:, -1]
            segments.append(ys_seg)
        ys = np.concatenate(segments, axis=1)
        A_out = np.stack(A_list, axis=1)
        D_out = np.stack(D_list, axis=1)
        L_out = np.stack(L_list, axis=1)

    return ODEDatasetResult(
        t=t, x0=x0, true_y=ys[..., 0], A=A_out, D=D_out, L=L_out, labels=labels,
        events_time=events_time, events_time_indices=event_indices, spec=spec,
    )


def split_train_val_test(spec: ODEDatasetSpec,
                         rng: tp.Optional[np.random.Generator] = None):
    """Train / extrapolation / interpolation split (ode_dataset.py:344-386)."""
    if rng is None:
        rng = np.random.default_rng(spec.seed + 77)
    if spec.sampling_type == "equal":
        id_train = list(range(round(spec.time_tick * spec.split_ratio[0])))
        id_test_extra = list(range(round(spec.time_tick * spec.split_ratio[0]),
                                   spec.time_tick))
        id_test_inter = None
    elif spec.sampling_type == "irregular":
        id_test_extra = list(range(
            spec.time_tick, round(spec.time_tick * (1.0 + spec.split_ratio[1]))))
        all_indices = list(range(1, spec.time_tick))
        id_test_inter = rng.permutation(all_indices)[
            : round(spec.time_tick * spec.split_ratio[1])].tolist()
        id_test_inter.sort()
        id_train = list(sorted(set(range(spec.time_tick)) - set(id_test_inter)))
    else:
        raise ValueError(f"{spec.sampling_type} sampling is not supported")
    return id_train, id_test_extra, id_test_inter
