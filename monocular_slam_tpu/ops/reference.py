"""Plain numpy references for the frontend's device ops.

Written from the definitions, independent of the vectorized formulations
under test, and checked against them by the CPU tests and by `chip_smoke.py`
on the GPU:

  - `fast_score_nms`: FAST-9 corner score (largest threshold at which 9
    contiguous ring pixels are all brighter or all darker than the centre)
    with the border ring zeroed, then 3x3 non-max suppression;
  - `match_top2`: brute-force Hamming table, best and second-best per query,
    Lowe ratio + absolute gates, optional mutual cross-check.
"""

from __future__ import annotations

import numpy as np

from monocular_slam_tpu.ops.fast import BORDER, RING_OFFSETS

BIG = 1 << 20  # distance given to invalid rows/columns (as `ops.matching`)


def fast_score_nms(img: np.ndarray, threshold: float) -> np.ndarray:
    """(H, W) FAST-9 score after threshold, border and 3x3 NMS."""
    img = np.asarray(img, np.float32)
    H, W = img.shape
    arcs = (np.arange(16)[:, None] + np.arange(9)[None, :]) % 16  # (16, 9)
    score = np.zeros((H, W), np.float32)
    for y in range(BORDER, H - BORDER):
        for x in range(BORDER, W - BORDER):
            d = np.array(
                [img[y + dy, x + dx] - img[y, x] for dy, dx in RING_OFFSETS],
                np.float32,
            )[arcs]
            best = max(d.min(axis=1).max(), (-d).min(axis=1).max())
            score[y, x] = best if best > threshold else 0.0
    out = np.zeros_like(score)
    for y in range(H):
        for x in range(W):
            win = score[max(y - 1, 0) : y + 2, max(x - 1, 0) : x + 2]
            out[y, x] = score[y, x] if score[y, x] >= win.max() else 0.0
    return out


def match_top2(
    a_pm1: np.ndarray,
    b_pm1: np.ndarray,
    a_valid: np.ndarray,
    b_valid: np.ndarray,
    ratio: float,
    max_dist: int,
    cross_check: bool = True,
):
    """Returns (idx, dist, ok) with the semantics of `ops.matching.match`:
    the first index wins a tie, the ratio test compares in float32."""
    # ±1 dot products are integers of magnitude <= 256: exact in float32
    dots = a_pm1.astype(np.float32) @ b_pm1.astype(np.float32).T
    D = (256 - dots.astype(np.int64)) >> 1
    D[:, ~np.asarray(b_valid)] = BIG
    D[~np.asarray(a_valid), :] = BIG
    rows = np.arange(D.shape[0])
    best = D.argmin(axis=1)
    d1 = D[rows, best]
    D2 = D.copy()
    D2[rows, best] = BIG
    d2 = D2.min(axis=1)
    ok = (
        np.asarray(a_valid)
        & (d1.astype(np.float32) < np.float32(ratio) * d2.astype(np.float32))
        & (d1 <= max_dist)
    )
    if cross_check:
        ok &= D.argmin(axis=0)[best] == rows
    return best, d1, ok
