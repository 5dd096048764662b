"""TGB (Temporal Graph Benchmark) node-property dataset ingestion.

Counterpart of ``gncde_tpu/data/tgb.py``: reads an on-disk TGB-format edge
list CSV (columns timestamp/ts, source/src, destination/dst[, weight/w]) from
the layouts the ``tgb`` package caches, builds the joint node index in
first-seen order over the sources, then the destinations (node ids are
compared as strings), and buckets the edges into dense-adjacency snapshots
whose node features are the adjacency rows. No network access and no pandas:
the columns are split in bulk, so a tgbn-genre-scale file (millions of rows)
parses in seconds.
"""

from __future__ import annotations

import csv
import io
import typing as tp
from pathlib import Path

import numpy as np

from .windows import Snapshot, to_dense_adj

MINUTE_DURATION = 60
HOUR_DURATION = 60 * MINUTE_DURATION
DAY_DURATION = 24 * HOUR_DURATION
WEEK_DURATION = 7 * DAY_DURATION
MONTH_DURATION = 30 * DAY_DURATION
YEAR_DURATION = 365 * DAY_DURATION

FREQUENCY_DURATIONS = {
    "None": 1,
    "daily": DAY_DURATION,
    "weekly": WEEK_DURATION,
    "monthly": MONTH_DURATION,
    "yearly": YEAR_DURATION,
}


class TemporalEdges(tp.NamedTuple):
    src: np.ndarray
    dst: np.ndarray
    t: np.ndarray
    msg: tp.Optional[np.ndarray]
    num_nodes: int


def _columns(text: str) -> tp.Tuple[tp.List[str], tp.List[tp.List[str]]]:
    """(header, columns of raw cell strings), empty rows skipped."""
    if '"' in text:  # quoted cells: the csv module parses them
        rows = [r for r in csv.reader(io.StringIO(text)) if r]
        return rows[0], [list(col) for col in zip(*rows[1:])]
    lines = [line for line in text.splitlines() if line]
    header = lines[0].split(",")
    ncol = len(header)
    cells = ",".join(lines[1:]).split(",") if len(lines) > 1 else []
    if len(cells) != ncol * (len(lines) - 1):
        raise ValueError(f"rows of the edge list do not all have {ncol} cells")
    return header, [cells[i::ncol] for i in range(ncol)]


def load_tgb_edgelist(name: str, data_dir: str = "datasets") -> TemporalEdges:
    """Load a TGB edge list from disk."""
    base = Path(data_dir)
    underscored = name.replace("-", "_")
    candidates = [
        base / name / f"{name}_edgelist.csv",
        base / name / f"{underscored}_edgelist.csv",
        base / underscored / f"{underscored}_edgelist.csv",
        base / f"{name}_edgelist.csv",
        base / f"{underscored}_edgelist.csv",
    ]
    path = next((c for c in candidates if c.exists()), None)
    if path is None:
        raise FileNotFoundError(
            f"TGB dataset {name!r} not found under {base}/. Place the TGB "
            f"edgelist CSV at {candidates[0]} (columns: timestamp/ts, "
            "source/src, destination/dst[, weight/w]).")
    header, cols = _columns(path.read_text())
    index = {c.strip().lower(): i for i, c in enumerate(header)}

    def col(*names):
        return next((index[k] for k in names if k in index), None)

    i_t = col("timestamp", "ts", "time", "t", "year")
    i_s = col("source", "src", "u")
    i_d = col("destination", "dst", "target", "i", "v")
    i_w = col("weight", "w", "msg")
    srcs, dsts = cols[i_s], cols[i_d]
    t = np.array(list(map(float, cols[i_t])), dtype=np.float64)
    w = (np.array(list(map(float, cols[i_w])), dtype=np.float64).astype(np.float32)
         if i_w is not None else np.ones(len(srcs), dtype=np.float32))
    # Joint index in first-seen order: sources first, then destinations.
    nodes = {v: i for i, v in enumerate(dict.fromkeys(srcs + dsts))}
    src = np.fromiter(map(nodes.__getitem__, srcs), dtype=np.int64, count=len(srcs))
    dst = np.fromiter(map(nodes.__getitem__, dsts), dtype=np.int64, count=len(dsts))
    return TemporalEdges(src=src, dst=dst, t=t, msg=w, num_nodes=len(nodes))


def process_snapshots(edges: TemporalEdges, frequency: str = "None") -> tp.List[Snapshot]:
    """Bucket edges by ``frequency`` into dense-adjacency snapshots; node
    features are the adjacency rows (dataset_configs.py:615-690)."""
    duration = FREQUENCY_DURATIONS.get(frequency)
    if duration is None:
        raise ValueError(f"Invalid frequency: {frequency}")
    start_time = edges.t.min()
    end_time = edges.t.max()
    snapshots = []
    current = start_time
    while current <= end_time:
        mask = (edges.t >= current) & (edges.t < current + duration)
        src = edges.src[mask]
        dst = edges.dst[mask]
        msg = edges.msg[mask] if edges.msg is not None else None
        adj = to_dense_adj(src, dst, msg, edges.num_nodes)
        snapshots.append(Snapshot(adj=adj, x=adj, t=float(current), src=src))
        current += duration
    return snapshots
