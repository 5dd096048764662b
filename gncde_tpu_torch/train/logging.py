"""Metric logging with wandb-compatible names (counterpart of
``gncde_tpu/train/logging.py``): wandb when installed and enabled, always an
in-memory history, and an optional JSONL file."""

from __future__ import annotations

import json
import logging
import time
import typing as tp
from pathlib import Path

logger = logging.getLogger(__name__)

try:  # wandb is optional
    import wandb as _wandb
except Exception:  # noqa: BLE001
    _wandb = None


class MetricLogger:
    def __init__(self, project: str = "GNCDEs", mode: str = "auto",
                 jsonl_path: tp.Optional[str] = None,
                 config: tp.Optional[dict] = None):
        self.history: tp.List[dict] = []
        self._file = None
        self._use_wandb = False
        if mode != "disabled" and _wandb is not None:
            try:
                _wandb.init(project=project, config=config or {})
                self._use_wandb = True
            except Exception as e:  # noqa: BLE001 - offline environments
                logger.info("wandb unavailable (%s); falling back to JSONL", e)
        if jsonl_path is not None:
            Path(jsonl_path).parent.mkdir(parents=True, exist_ok=True)
            self._file = open(jsonl_path, "a")

    def log(self, metrics: tp.Dict[str, tp.Any]) -> None:
        record = {k: (float(v) if hasattr(v, "__float__") else v)
                  for k, v in metrics.items()}
        record["_time"] = time.time()
        self.history.append(record)
        if self._use_wandb:
            _wandb.log({k: v for k, v in record.items() if k != "_time"})
        if self._file is not None:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
        if self._use_wandb:
            _wandb.finish()
