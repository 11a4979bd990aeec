"""Descriptor matching: Hamming distances as one int8 matmul + ratio test.

Replaces the reference's BFMatcher kNN + Lowe ratio matching
(`src/CameraPoseEstimator.cpp:200-213`; ratio 0.8 for tracking, 0.85 for
init per `src/ParamConfig.h:5`). The O(N*M) distance table is computed as a
single int8 matmul on the 256-dim +-1 expansion:

    dist = (256 - A_pm1 @ B_pm1^T) / 2

which is exactly Hamming distance (integer arithmetic, so any accumulation
order gives the same table), and replaces DBoW2's
scalar SWAR popcount loop (`FORB.cpp:81-100`). Top-2 per row + ratio test +
optional mutual cross-check produce fixed-shape match arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

FEATURE_MATCH_RATIO_TEST = 0.85  # `src/ParamConfig.h:5` (init)
TRACKING_RATIO = 0.8  # matchFeatures default (`CameraPoseEstimator.cpp:200`)


def hamming_matrix(a_pm1: jnp.ndarray, b_pm1: jnp.ndarray) -> jnp.ndarray:
    """(N, 256) int8, (M, 256) int8 -> (N, M) int32 Hamming distances."""
    dots = jnp.matmul(
        a_pm1.astype(jnp.int8),
        b_pm1.astype(jnp.int8).T,
        preferred_element_type=jnp.int32,
    )
    return (256 - dots) >> 1


class Matches(NamedTuple):
    """Fixed-shape match table: one entry per query feature."""

    idx: jnp.ndarray  # (N,) int32 — best match in B for each A feature
    dist: jnp.ndarray  # (N,) int32 — its Hamming distance
    ok: jnp.ndarray  # (N,) bool — passed ratio/validity/cross checks
    n_matches: jnp.ndarray  # scalar


def match(
    a_pm1: jnp.ndarray,
    b_pm1: jnp.ndarray,
    a_valid: jnp.ndarray,
    b_valid: jnp.ndarray,
    ratio: float = FEATURE_MATCH_RATIO_TEST,
    max_dist: int = 256,
    cross_check: bool = True,
) -> Matches:
    """Lowe-ratio kNN matching, fixed shapes.

    Invalid rows/cols are pushed to +inf distance. The ratio test compares
    best vs second-best (knnMatch k=2 + `m0.distance < ratio * m1.distance`,
    `src/CameraPoseEstimator.cpp:205-210`). The full (N, M) distance table
    is materialized; every pipeline call site matches frame against frame
    (M = n_features), where that table is small.
    """
    D = hamming_matrix(a_pm1, b_pm1)  # (N, M)
    BIG = jnp.int32(1 << 20)
    D = jnp.where(b_valid[None, :], D, BIG)
    D = jnp.where(a_valid[:, None], D, BIG)
    return _select_matches(D, a_valid, ratio, max_dist, cross_check)


def _select_matches(D, a_valid, ratio, max_dist, cross_check) -> Matches:
    """Top-2 per row + ratio/absolute gates + optional mutual cross-check
    over a (masked) distance table."""
    BIG = jnp.int32(1 << 20)
    # top-2 smallest per row without a full sort: fused min+argmin, then a
    # compare-masked second pass (a plain fused elementwise pass over D).
    best = jnp.argmin(D, axis=1).astype(jnp.int32)  # (N,)
    d1 = jnp.min(D, axis=1)
    cols = jnp.arange(D.shape[1], dtype=jnp.int32)
    d2 = jnp.min(
        jnp.where(cols[None, :] == best[:, None], BIG, D), axis=1
    )

    ok = (
        a_valid
        & (d1.astype(jnp.float32) < ratio * d2.astype(jnp.float32))
        & (d1 <= max_dist)
    )
    if cross_check:
        # mutual best: argmin over columns must point back
        best_col = jnp.argmin(D, axis=0)  # (M,)
        ok = ok & (best_col[best] == jnp.arange(D.shape[0]))
    return Matches(idx=best, dist=d1, ok=ok, n_matches=jnp.sum(ok))


def guided_match(
    a_pm1: jnp.ndarray,
    b_pm1: jnp.ndarray,
    a_valid: jnp.ndarray,
    b_valid: jnp.ndarray,
    nodes_a: jnp.ndarray,
    nodes_b: jnp.ndarray,
    ratio: float = FEATURE_MATCH_RATIO_TEST,
    max_dist: int = 256,
    cross_check: bool = True,
) -> Matches:
    """DBoW2 direct-index ("FeatureVector") guided matching: only descriptor
    pairs quantized to the SAME vocabulary node are candidates
    (`ThirdParty/DBoW2/DBoW2/FeatureVector.h:1-56`; ORB-SLAM's
    SearchByBoW). `nodes_*` are per-feature node ids from
    `retrieval.vocabulary.node_words` (typically a few levels above the
    leaves).

    The "index" is a node-equality mask on the full Hamming table (ONE int8
    matmul) — same candidate-restriction semantics as DBoW2 (including its
    recall loss at quantization boundaries), none of its CPU bucketing
    machinery. `benchmarks/loop_match_scale.py` measures both paths at map
    scale; the SLAM pipeline defaults to the full table and keeps this for
    parity/recall-precision control."""
    D = hamming_matrix(a_pm1, b_pm1)
    BIG = jnp.int32(1 << 20)
    same_node = nodes_a[:, None] == nodes_b[None, :]
    D = jnp.where(same_node, D, BIG)
    D = jnp.where(b_valid[None, :], D, BIG)
    D = jnp.where(a_valid[:, None], D, BIG)
    return _select_matches(D, a_valid, ratio, max_dist, cross_check)
