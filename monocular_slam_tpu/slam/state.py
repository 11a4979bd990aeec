"""SlamState — the immutable, fixed-capacity world state.

Replaces the reference's mutable `DataManager` "CAS" (`src/DataManager.h:23-36`,
pattern documented at `src/Frame.h:3-9`) with a single pytree of mask-padded
arrays. Every pipeline stage is a pure function state' = f(state, ...), jitted
once for the whole run.

Two capacity tiers (the long-trajectory design the reference's unbounded
vectors never had, SURVEY.md §5.7):

  - POSE tier, capacity F = cfg.max_frames: poses/pose_valid/k, indexed by
    the logical frame id. 12 floats per frame — thousands of frames cost
    nothing, and the full trajectory survives to the end of the run.
  - FEATURE tier, capacity S = cfg.max_slots: the big per-frame slabs
    (keypoints, descriptors, feat_point back-pointers), indexed by SLOT.
    `slot_of (F,)` maps frame -> slot (-1 once evicted); `frame_of (S,)`
    maps slot -> occupying frame (-1 free). The session recycles slots
    keyframe-aware (non-keyframes first), so descriptor memory scales with
    scene coverage, not trajectory length. Map points persist independently
    of slots — an evicted frame's pose and its triangulated points stay.

Key representation choice: the reference keeps a per-map-point observation map
`MapPoint::observerToIndex` (frameIdx -> featureIdx, `src/MapPoint.h:27`) AND
a per-feature back-pointer `Features::mapPointsIndices` (`src/Frame.h:30`).
Only the back-pointer `feat_point` is stored here — the observation list is
its inverse and every consumer (BA edge building, covisibility counting)
derives it with one flatten, so the two can never disagree.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from monocular_slam_tpu.slam.config import SlamConfig


class SlamState(NamedTuple):
    # --- pose tier (capacity F = max_frames, indexed by frame id) ---
    poses: jnp.ndarray  # (F, 3, 4) world->camera Rt (`Frame::Rt`)
    pose_valid: jnp.ndarray  # (F,) bool — pose has been estimated
    k: jnp.ndarray  # (F, 4) per-frame intrinsics (`Frame::K`)
    # --- feature tier (capacity S = max_slots, indexed by slot) ---
    kp_uv: jnp.ndarray  # (S, N, 2) float32 — undistorted pixels
    kp_scale: jnp.ndarray  # (S, N) pyramid scale (`Features::scales`)
    kp_valid: jnp.ndarray  # (S, N) bool
    desc: jnp.ndarray  # (S, N, 8) uint32 packed ORB
    desc_pm1: jnp.ndarray  # (S, N, 256) int8 for matmul matching
    feat_point: jnp.ndarray  # (S, N) int32 — map point id or -1
    slot_of: jnp.ndarray  # (F,) int32 — frame's slot, -1 if evicted/none
    frame_of: jnp.ndarray  # (S,) int32 — slot's frame, -1 if free
    # --- map points (capacity P) ---
    points: jnp.ndarray  # (P, 3) world positions
    point_valid: jnp.ndarray  # (P,) bool
    n_points: jnp.ndarray  # scalar int32 — live (valid) map-point count
    n_frames: jnp.ndarray  # scalar int32 — frames ingested so far


def n_slots(cfg: SlamConfig) -> int:
    return cfg.max_slots if cfg.max_slots else cfg.max_frames


def empty_state(cfg: SlamConfig, dtype=jnp.float32) -> SlamState:
    F, N, P = cfg.max_frames, cfg.frontend.n_features, cfg.max_points
    S = n_slots(cfg)
    return SlamState(
        poses=jnp.tile(
            jnp.concatenate([jnp.eye(3, dtype=dtype), jnp.zeros((3, 1), dtype)], axis=1),
            (F, 1, 1),
        ),
        pose_valid=jnp.zeros(F, bool),
        k=jnp.zeros((F, 4), dtype),
        kp_uv=jnp.zeros((S, N, 2), dtype),
        kp_scale=jnp.ones((S, N), dtype),
        kp_valid=jnp.zeros((S, N), bool),
        desc=jnp.zeros((S, N, 8), jnp.uint32),
        desc_pm1=jnp.zeros((S, N, 256), jnp.int8),
        feat_point=jnp.full((S, N), -1, jnp.int32),
        slot_of=jnp.full(F, -1, jnp.int32),
        frame_of=jnp.full(S, -1, jnp.int32),
        points=jnp.zeros((P, 3), dtype),
        point_valid=jnp.zeros(P, bool),
        n_points=jnp.asarray(0, jnp.int32),
        n_frames=jnp.asarray(0, jnp.int32),
    )


def slot_index(state: SlamState, frame_idx) -> jnp.ndarray:
    """Clamped slot of a frame (0 if evicted — callers must mask with
    `slot_of[frame_idx] >= 0` when the frame may not be resident)."""
    return jnp.maximum(state.slot_of[frame_idx], 0)


def add_frame_features(
    state: SlamState,
    frame_idx,
    slot_idx,
    uv,
    scale,
    valid,
    desc,
    desc_pm1,
    k,
) -> SlamState:
    """Write one frame's extracted features into slot `slot_idx` (the
    `FeatureExtractor::process` write, `src/FeatureExtractor.cpp:13-31`),
    evicting the slot's previous occupant from the frame->slot map. The
    evicted frame's pose, validity and triangulated points are untouched.
    Timestamps stay host-side in the session: device f32 cannot hold TUM
    epoch stamps (~1.3e9 s) to the 0.02 s association tolerance."""
    dtype = state.kp_uv.dtype
    F = state.slot_of.shape[0]
    old_frame = state.frame_of[slot_idx]
    slot_of = state.slot_of.at[
        jnp.where(old_frame >= 0, old_frame, jnp.int32(F))
    ].set(-1, mode="drop")
    slot_of = slot_of.at[frame_idx].set(jnp.asarray(slot_idx, jnp.int32))
    return state._replace(
        kp_uv=state.kp_uv.at[slot_idx].set(uv.astype(dtype)),
        kp_scale=state.kp_scale.at[slot_idx].set(scale.astype(dtype)),
        kp_valid=state.kp_valid.at[slot_idx].set(valid),
        desc=state.desc.at[slot_idx].set(desc),
        desc_pm1=state.desc_pm1.at[slot_idx].set(desc_pm1),
        feat_point=state.feat_point.at[slot_idx].set(
            jnp.full(state.feat_point.shape[1], -1, jnp.int32)
        ),
        slot_of=slot_of,
        frame_of=state.frame_of.at[slot_idx].set(
            jnp.asarray(frame_idx, jnp.int32)
        ),
        k=state.k.at[frame_idx].set(jnp.asarray(k, dtype)),
        n_frames=jnp.maximum(state.n_frames, jnp.asarray(frame_idx + 1, jnp.int32)),
    )


def observation_edges(state: SlamState):
    """Flatten feat_point into BA edge arrays (fixed capacity S*N).

    Returns (cam_idx (E,), pt_idx (E,), uv (E, 2), info (E,), valid (E,)).
    cam_idx is the observing FRAME id (via frame_of); edges in free slots are
    masked. This derives what the reference builds by iterating MapPoint
    observation maps in `src/Util.cpp:87-169`.
    """
    S, N = state.feat_point.shape
    F = state.poses.shape[0]
    fr = state.frame_of  # (S,)
    cam_idx = jnp.repeat(jnp.maximum(fr, 0), N)
    pt_idx = state.feat_point.reshape(-1)
    uv = state.kp_uv.reshape(S * N, 2)
    # information 1/scale — the reference's I_2/scale (`src/Util.cpp:141-153`)
    info = (1.0 / state.kp_scale.reshape(-1)).astype(state.kp_uv.dtype)
    valid = (
        (pt_idx >= 0)
        & state.kp_valid.reshape(-1)
        & jnp.repeat(fr >= 0, N)
        & state.pose_valid[cam_idx]
    )
    return cam_idx, jnp.maximum(pt_idx, 0), uv, info, valid


def allocate_points(
    state: SlamState, new_xyz: jnp.ndarray, want: jnp.ndarray
):
    """Allocate up to sum(want) new map points from a fixed-size candidate
    buffer into FREE slots (never-used or culled — slots are recycled, so a
    long run only exhausts capacity when the *live* map outgrows P).
    Returns (state', slot_ids (M,) int32) where slot_ids[i] is the allocated
    id or -1 if not allocated (capacity full or not wanted).

    Replaces `CameraPoseEstimator::registerNewMapPoint`
    (`src/CameraPoseEstimator.cpp:235-243`) + the slot reuse the reference
    gets for free from `std::vector` deletion (`src/DataManager.h:29-35`,
    `MapPoint.cpp:8-28`), as two cumsum rankings and one scatter. Safe
    because `mapping.cull_points` clears every dangling `feat_point`
    back-pointer when it frees a slot — nothing can alias a recycled id.
    """
    P = state.points.shape[0]
    M = want.shape[0]
    rank = jnp.cumsum(want.astype(jnp.int32)) - 1  # rank among wanted
    # rank free slots; slot_of_rank[r] = index of the (r+1)-th free slot
    free = ~state.point_valid
    frank = jnp.cumsum(free.astype(jnp.int32)) - 1  # (P,)
    slot_of_rank = (
        jnp.full(M + 1, P, jnp.int32)
        .at[jnp.where(free & (frank < M), frank, M)]
        .set(jnp.arange(P, dtype=jnp.int32), mode="drop")[:M]
    )
    slots = slot_of_rank[jnp.clip(rank, 0, M - 1)]
    ok = want & (slots < P)
    # Non-allocated candidates scatter out-of-bounds with drop semantics so
    # duplicate-index write ordering can never clobber a real allocation.
    slots_safe = jnp.where(ok, slots, P)
    points = state.points.at[slots_safe].set(new_xyz.astype(state.points.dtype), mode="drop")
    point_valid = state.point_valid.at[slots_safe].set(True, mode="drop")
    state = state._replace(
        points=points,
        point_valid=point_valid,
        n_points=jnp.sum(point_valid.astype(jnp.int32)),
    )
    return state, jnp.where(ok, slots, -1)
