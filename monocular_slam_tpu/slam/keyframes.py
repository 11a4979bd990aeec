"""Keyframe selection and frame culling.

The reference processes EVERY frame through every stage (no keyframe notion —
`src/main.cpp:48-51`) while its UML design promises keyframe insertion and
culling (`Mapper.insertKeyFrame`, `localKeyframeCulling` in ORBSLAM.png;
`LocalMapper::FrameCulling` declared at `src/LocalMapper.h:40`). This module
supplies both as pure functions over SlamState:

  - select_keyframes: ORB-SLAM-shaped rule — a frame becomes a keyframe when
    its tracked-point overlap with the previous keyframe drops below a ratio
    (the scene changed enough to deserve anchoring);
  - cull_frames: redundant-frame rule — a frame whose observed points are
    ~all seen by >= 3 other frames contributes nothing to the map's
    constraint structure and can be dropped from global optimization.

Keyframe flags feed loop-closure databases and global/pose-graph
optimization; tracking itself stays per-frame (latency path).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from monocular_slam_tpu.slam import mapping
from monocular_slam_tpu.slam.state import SlamState


def tracked_overlap(state: SlamState, i, j) -> jnp.ndarray:
    """Fraction of frame i's associated points also observed in frame j."""
    C = mapping.covisibility(state)
    own = jnp.maximum(C[i, i], 1)
    return C[i, j] / own


def select_keyframes(
    state: SlamState, n_frames: int, overlap_thresh: float = 0.7,
    min_gap: int = 1, max_gap: int = 15,
) -> np.ndarray:
    """(F,) bool keyframe flags (host-side; runs on the covisibility matrix).

    Frame i is a keyframe if its point overlap with the last keyframe is
    below `overlap_thresh`, at least `min_gap` frames passed, or `max_gap`
    frames passed regardless (temporal anchor)."""
    C = np.asarray(mapping.covisibility(state))
    flags = np.zeros(state.poses.shape[0], bool)
    valid = np.asarray(state.pose_valid)
    last_kf = None
    for i in range(int(n_frames)):
        if not valid[i]:
            continue
        if last_kf is None:
            flags[i] = True
            last_kf = i
            continue
        own = max(C[i, i], 1)
        overlap = C[i, last_kf] / own
        if (overlap < overlap_thresh and i - last_kf >= min_gap) or (
            i - last_kf >= max_gap
        ):
            flags[i] = True
            last_kf = i
    return flags


def cull_frames_device(
    state: SlamState,
    keyframes: jnp.ndarray,
    protect: jnp.ndarray,
    redundancy: float = 0.9,
    min_other_obs: int = 3,
) -> jnp.ndarray:
    """`cull_frames` as ONE compiled program (the host version pulls the
    full feat_point/kp_valid/point_valid arrays and loops over keyframes in
    Python — ~1 MB of sync plus O(K) host work per call, which dominated
    the with-loop-closer frame cost when run per keyframe). Sequential over frames via `fori_loop` so a chain of mutually-
    redundant keyframes can't all vanish — each cull updates the counts the
    next decision sees. `protect` (F,) marks frames never culled (the first
    keyframe and the newest ones still gathering observations)."""
    from monocular_slam_tpu.slam import state as state_mod

    S, N = state.feat_point.shape
    F = state.poses.shape[0]
    P = state.point_valid.shape[0]
    fp = state.feat_point
    kv = state.kp_valid
    pv = state.point_valid
    slot_of = state.slot_of

    cam_idx, pt_idx, _, _, valid = state_mod.observation_edges(state)
    contrib = valid & keyframes[cam_idx] & pv[pt_idx]
    counts = jax.ops.segment_sum(
        contrib.astype(jnp.int32), pt_idx, num_segments=P
    )

    def body(f, carry):
        flags, counts = carry
        s = jnp.maximum(slot_of[f], 0)
        resident = slot_of[f] >= 0
        pids = fp[s]  # (N,)
        ok = (pids >= 0) & kv[s] & pv[jnp.maximum(pids, 0)] & resident
        n_obs = jnp.sum(ok.astype(jnp.int32))
        well = ok & (counts[jnp.maximum(pids, 0)] >= min_other_obs + 1)
        frac = jnp.sum(well.astype(jnp.int32)) / jnp.maximum(n_obs, 1)
        considered = flags[f] & ~protect[f] & resident
        # evicted keyframes keep their flag (redundancy can't be assessed;
        # the pose still anchors graphs); zero-observation ones are culled
        cull = considered & ((n_obs == 0) | (frac >= redundancy))
        flags = flags.at[f].set(flags[f] & ~cull)
        dec = jnp.where(cull & ok, 1, 0)
        counts = counts.at[jnp.where(ok, pids, P)].add(-dec, mode="drop")
        return flags, counts

    flags, _ = jax.lax.fori_loop(0, F, body, (keyframes, counts))
    return flags


def cull_frames(
    state: SlamState, keyframes: np.ndarray, redundancy: float = 0.9,
    min_other_obs: int = 3,
) -> np.ndarray:
    """Mark redundant keyframes: >= `redundancy` of their observed points are
    seen by at least `min_other_obs` OTHER KEYFRAMES (ORB-SLAM's rule — the
    count must be over keyframes, not all frames: with per-frame tracking
    every point is seen by many ordinary frames, which would flag every
    keyframe as redundant and empty the place-recognition database).
    Returns updated flags (never culls the first keyframe). Sequential over
    keyframes so a chain of mutually-redundant keyframes can't all vanish —
    each cull updates the counts the next decision sees."""
    fp = np.asarray(state.feat_point)
    kv = np.asarray(state.kp_valid)
    pv = np.asarray(state.point_valid)
    slot_of = np.asarray(state.slot_of)
    P = pv.shape[0]
    flags = keyframes.copy()
    kf_ids = np.where(flags)[0]

    def kf_counts():
        c = np.zeros(P, np.int64)
        for j in np.where(flags)[0]:
            sj = slot_of[j]
            if sj < 0:  # features evicted: contributes no observations
                continue
            pids = fp[sj][(fp[sj] >= 0) & kv[sj]]
            np.add.at(c, pids, 1)
        return c

    counts = kf_counts()
    for i in kf_ids[1:]:
        si = slot_of[i]
        if si < 0:
            # evicted keyframe: its observations are gone, so redundancy
            # can't be assessed — keep the flag (pose still anchors graphs)
            continue
        pids = fp[si][(fp[si] >= 0) & kv[si]]
        pids = pids[pv[pids]]
        if len(pids) == 0:
            flags[i] = False
            continue
        well_observed = counts[pids] >= (min_other_obs + 1)  # +1 = itself
        if well_observed.mean() >= redundancy:
            flags[i] = False
            np.subtract.at(counts, pids, 1)
    return flags
