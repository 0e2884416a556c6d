"""Exact dynamic time warping on the host (numpy).

A copy of the JAX package's ``ops/dtw.py``: exact O(T1*T2) DTW, the true
minimal-cost path, through the C library of ``native`` when the system
compiler builds it and this numpy version otherwise.  Host code, not a
device kernel.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def dtw_path(x: np.ndarray, y: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal-cost alignment path between frame sequences.

    Uses the native C library (``native/dtw.c``)
    when the system compiler is available; falls back to this numpy
    implementation otherwise.

    Arguments:
        x -- [T1, D] frames
        y -- [T2, D] frames
    Returns:
        (path_x, path_y) index arrays of equal length.
    """
    from multilingual_text_to_speech_tpu_torch.native import (
        dtw_path_native,
    )

    native = dtw_path_native(np.asarray(x), np.asarray(y))
    if native is not None:
        return native

    t1, t2 = len(x), len(y)
    # pairwise Euclidean distances [T1, T2]
    dist = np.sqrt(
        np.maximum(
            (x * x).sum(1)[:, None] + (y * y).sum(1)[None, :] - 2.0 * (x @ y.T),
            0.0,
        )
    )

    INF = np.inf
    cost = np.full((t1 + 1, t2 + 1), INF, dtype=np.float64)
    cost[0, 0] = 0.0
    # moves: diagonal (1,1), down (1,0), right (0,1)
    for i in range(1, t1 + 1):
        prev = cost[i - 1]
        row = np.empty(t2 + 1)
        row[0] = INF
        d = dist[i - 1]
        # row[j] = d[j-1] + min(prev[j-1], prev[j], row[j-1]); the row[j-1]
        # term is a running dependency -> do the two vectorizable mins first,
        # then a fast scalar pass for the in-row propagation.
        base = np.minimum(prev[:-1], prev[1:])  # min(prev[j-1], prev[j])
        running = INF
        for j in range(1, t2 + 1):
            running = d[j - 1] + min(base[j - 1], running)
            row[j] = running
        cost[i] = row

    # backtrack
    path: List[Tuple[int, int]] = []
    i, j = t1, t2
    while i > 0 and j > 0:
        path.append((i - 1, j - 1))
        choices = (cost[i - 1, j - 1], cost[i - 1, j], cost[i, j - 1])
        move = int(np.argmin(choices))
        if move == 0:
            i, j = i - 1, j - 1
        elif move == 1:
            i -= 1
        else:
            j -= 1
    while i > 0:
        path.append((i - 1, 0))
        i -= 1
    while j > 0:
        path.append((0, j - 1))
        j -= 1
    path.reverse()
    px, py = zip(*path)
    return np.asarray(px), np.asarray(py)
