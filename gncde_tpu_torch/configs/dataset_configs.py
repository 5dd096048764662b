"""Dataset configurations and their cache layer.

Counterpart of ``ODEDataSetCfg`` and ``TGBDataSetCfg`` in
``gncde_tpu/configs/dataset_configs.py``. ``ODEDataSetCfg``:
same fields, defaults and literals, and the reference's seed mutation for
the validation and test draws (``seed += 500`` then ``+= 1000``, each after
the cache key is taken). The cache holds the generated trajectories (the
expensive ground-truth solves) under ``cache_dir`` as
``torch_cache_<md5>_<split>.pkl`` -- a namespace of its own, so the JAX and
torch caches never collide -- and the data dicts are rebuilt from them.
``TGBDataSetCfg`` caches each split's processed windows the same way.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import pickle
import typing as tp
from pathlib import Path

import numpy as np

from ._schema import Schema, required
from ..data.ode_dataset import ODEDatasetSpec, generate
from ..data import pipeline
from ..data import tgb as tgb_data
from ..data import windows as win

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ODEDataSetCfg(Schema):
    name: tp.Literal["heat", "gene", "mutualistic", "sir"] = required()
    batch_size: int = 1
    dynamic_graph: bool = required()
    all_dynamic: bool = required()
    graph_type: tp.Literal["grid", "random", "power_law", "small_world",
                           "community", "mixed"] = "grid"
    split_ratio: tp.List = dataclasses.field(default_factory=lambda: [0.8, 0.2])
    num_nodes: int = 400
    final_time: float = 5.0
    time_tick: int = 100
    sampling_type: tp.Literal["irregular", "equal"] = "irregular"
    method: tp.Literal["Dopri5", "Tsit5"] = "Dopri5"
    dt0: float = 0.01
    layout: tp.Literal["community", "degree"] = "community"
    operator_type: tp.Literal["lap", "norm_lap", "kipf", "norm_adj"] = "norm_lap"
    padding_mode: tp.Literal["same", "none"] = "same"
    cache_dir: str = "cache"
    interpolation: tp.Literal["linear", "cubic"] = "cubic"
    seed: int = 1234
    amp_range: tp.Tuple = (0.5, 1.0)
    beta: tp.Tuple[float, float] = (0.5, 1.0)
    gamma: tp.Tuple[float, float] = (0.3, 1.0)

    def validate(self) -> None:
        if self.name != "heat" or self.graph_type != "grid":
            raise NotImplementedError(
                f"dataset {self.name!r} on {self.graph_type!r} graphs is not "
                "ported yet (heat on grid only; see ROADMAP)")
        if self.operator_type not in ("lap", "norm_lap"):
            raise NotImplementedError(
                f"operator {self.operator_type!r} is not ported yet (see ROADMAP)")

    def _spec(self) -> ODEDatasetSpec:
        return ODEDatasetSpec(
            name=self.name, batch_size=self.batch_size,
            dynamic_graph=self.dynamic_graph, all_dynamic=self.all_dynamic,
            graph_type=self.graph_type, split_ratio=tuple(self.split_ratio),
            num_nodes=self.num_nodes, final_time=self.final_time,
            time_tick=self.time_tick, sampling_type=self.sampling_type,
            method=self.method, dt0=self.dt0, layout=self.layout,
            operator_type=self.operator_type, padding_mode=self.padding_mode,
            seed=self.seed, amp_range=tuple(self.amp_range),
            beta=tuple(self.beta), gamma=tuple(self.gamma),
        )

    def get_training_data(self) -> tp.Dict:
        path = _cache_path(self, "default_train")
        dataset = _load_or_compute(path, lambda: generate(self._spec()))
        return pipeline.get_split_train_data(self._spec(), dataset, self.interpolation)

    def get_validation_data(self) -> tp.Dict:
        path = _cache_path(self, "default_test")
        self.seed += 500  # reference quirk: decorrelate the validation draw
        dataset = _load_or_compute(path, lambda: generate(self._spec()))
        return pipeline.get_split_test_data(self._spec(), dataset, self.interpolation)

    def get_test_data(self) -> tp.Dict:
        path = _cache_path(self, "default2_test")
        self.seed += 1000
        dataset = _load_or_compute(path, lambda: generate(self._spec()))
        return pipeline.get_split_test_data(self._spec(), dataset, self.interpolation)


def _cache_path(cfg: Schema, data_key: str) -> Path:
    """``cache_dir/torch_cache_<md5 of the config without cache_dir>_<key>.pkl``."""
    d = cfg.to_dict()
    d.pop("cache_dir")
    digest = hashlib.md5(json.dumps(d, sort_keys=True, default=str).encode()).hexdigest()
    cache_dir = Path(cfg.cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    return cache_dir / f"torch_cache_{digest}_{data_key}.pkl"


def _load_or_compute(cache_path: Path, compute):
    if cache_path.exists():
        try:
            with open(cache_path, "rb") as f:
                logger.info("Loaded cache from %s", cache_path)
                return pickle.load(f)
        except Exception as e:  # noqa: BLE001 - a corrupt cache is rebuilt
            logger.info("Cache load failed: %s. Computing fresh result.", e)
    result = compute()
    try:
        with open(cache_path, "wb") as f:
            pickle.dump(result, f)
        logger.info("Saved cache to %s", cache_path)
    except Exception as e:  # noqa: BLE001
        logger.info("Cache save failed: %s", e)
    return result


@dataclasses.dataclass
class TGBDataSetCfg(Schema):
    """TGB node-property windows (reference dataset_configs.py:461-903).

    The ``-synth`` names are offline surrogates at the real dataset's scale
    (``tools/fetch_tgb.py synthetic``); they never shadow real data.
    """

    name: tp.Literal["tgbn-trade", "tgbn-genre", "tgbn-trade-synth",
                     "tgbn-genre-synth"] = "tgbn-trade"
    window_size: int = 5
    stride: int = 1
    split_ratio: tp.List[float] = dataclasses.field(default_factory=lambda: [0.6, 0.2, 0.2])
    interpolation: tp.Literal["linear", "cubic"] = "cubic"
    cache_dir: str = ".cache"
    seed: int = 1234
    shard_train_windows: bool = False
    frequency: tp.Literal["None", "daily", "weekly", "monthly", "yearly"] = "None"
    data_dir: str = "datasets"
    normalise_features: bool = False
    recompile: bool = False

    def validate(self) -> None:
        if self.shard_train_windows:
            raise NotImplementedError(
                "shard_train_windows (multi-host window sharding) is not ported")

    def _split_windows(self):
        """(train, val, test) lists of snapshot windows; the edge list is
        read once per config object, not once per split."""
        if getattr(self, "_splits", None) is None:
            edges = tgb_data.load_tgb_edgelist(self.name, self.data_dir)
            snapshots = tgb_data.process_snapshots(edges, self.frequency)
            rng = np.random.default_rng(self.seed)
            starts = win.sample_disjoint_window_starts(
                len(snapshots), self.window_size, self.stride, self.split_ratio, rng)
            w = self.window_size
            self._splits = [[snapshots[s:s + w] for s in split] for split in starts]
        return self._splits

    def _get_loader(self, split_idx: int, data_key: str) -> win.WindowLoader:
        def compute():
            return [win.process_window_tgb(wnd, self.interpolation, self.normalise_features)
                    for wnd in self._split_windows()[split_idx]]

        return win.WindowLoader(_load_or_compute(_cache_path(self, data_key), compute))

    def get_training_data(self) -> win.WindowLoader:
        return self._get_loader(0, "default_train")

    def get_validation_data(self) -> win.WindowLoader:
        return self._get_loader(1, "default_val")

    def get_test_data(self) -> win.WindowLoader:
        return self._get_loader(2, "default2_test")
