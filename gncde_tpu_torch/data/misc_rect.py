"""Non-overlapping rectangle sampling for patch initial conditions.

The port's copy of ``gncde_tpu/data/misc_rect.py`` (numpy only). Reference: src/dataset/misc.py:182-214.
"""

from __future__ import annotations

import typing as tp

import numpy as np


def rects_overlap(rect1, rect2) -> bool:
    return not (
        rect1[2] <= rect2[0]
        or rect1[0] >= rect2[2]
        or rect1[3] <= rect2[1]
        or rect1[1] >= rect2[3]
    )


def sample_non_overlapping_rect(
    N: int,
    h: int,
    w: int,
    existing_rects: tp.Sequence,
    max_attempts: int = 100,
    rng: tp.Optional[np.random.Generator] = None,
):
    if rng is None:
        rng = np.random.default_rng()
    for _ in range(max_attempts):
        r = int(rng.integers(0, N - h + 1))
        c = int(rng.integers(0, N - w + 1))
        rect = (r, c, r + h, c + w)
        if not any(rects_overlap(rect, ex) for ex in existing_rects):
            return rect
    raise RuntimeError(
        f"Could not sample a non-overlapping rectangle after {max_attempts} attempts"
    )
