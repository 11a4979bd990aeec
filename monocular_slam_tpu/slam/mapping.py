"""Local mapping hygiene: observation bookkeeping, map-point culling,
projection-guided association (fuse), and covisibility.

The reference's `LocalMapper` declared exactly this API and implemented none
of it (`src/LocalMapper.h:30-42` — `CreateNewMapPoints`, `MapPointCulling`,
`SearchInNeighbors`, `FrameCulling`; only the constructor exists,
`src/LocalMapper.cpp:7-8`). Point creation lives in the tracker; this module
supplies the rest as pure jitted functions over SlamState:

  - observation_counts / anchors: derived from the feat_point back-pointers
    with segment reductions (no separate observation store to desync);
  - cull_points: drop points that failed to gain support (ORB-SLAM's
    mapPointCulling rule shape: too few observations after a grace period);
  - fuse: project the map into a frame and associate unmatched features to
    existing points by descriptor distance within a pixel radius —
    `SearchInNeighbors`' job; prevents the tracker from fragmenting the map
    into duplicates when a track briefly drops;
  - covisibility: frame-frame shared-point counts as ONE matmul (the
    covisibility graph of ORBSLAM.png's ModelManager).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from monocular_slam_tpu.geometry import camera as cam
from monocular_slam_tpu.geometry import se3
from monocular_slam_tpu.slam import state as state_mod
from monocular_slam_tpu.slam.state import SlamState


def observation_counts(state: SlamState) -> jnp.ndarray:
    """(P,) number of valid observations per map point."""
    _, pt_idx, _, _, valid = state_mod.observation_edges(state)
    P = state.points.shape[0]
    return jax.ops.segment_sum(valid.astype(jnp.int32), pt_idx, num_segments=P)


def point_anchors(state: SlamState) -> jnp.ndarray:
    """(P,) first observing frame per point (capacity F if unobserved)."""
    cam_idx, pt_idx, _, _, valid = state_mod.observation_edges(state)
    P = state.points.shape[0]
    F = state.poses.shape[0]
    return jax.ops.segment_min(
        jnp.where(valid, cam_idx, jnp.int32(F)), pt_idx, num_segments=P
    )


def point_descriptors(state: SlamState) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Representative +-1 descriptor per point: the descriptor of its
    EARLIEST slot-resident observation, ranked by observing FRAME id (not
    slot index — after slot recycling the slot ordering is allocation
    history, and a slot-ranked representative could change when an unrelated
    frame is evicted). Returns (desc_pm1 (P, 256) int8, has (P,) bool).
    Points whose observers were all evicted lose their descriptor
    (has=False) and gracefully drop out of fuse/projection association —
    their 3D positions persist."""
    S, N = state.feat_point.shape
    P = state.points.shape[0]
    cam_idx, pt_idx, _, _, valid = state_mod.observation_edges(state)
    flat_id = jnp.arange(S * N, dtype=jnp.int32)
    # rank key = frame*S*N + flat slot id: min over it picks the earliest
    # observing frame (frame capacities keep F*S*N < 2^31 — 4096 frames x
    # 256 slots x 1024 features ~ 1.1e9)
    key = cam_idx * jnp.int32(S * N) + flat_id
    big = jnp.iinfo(jnp.int32).max
    first_key = jax.ops.segment_min(
        jnp.where(valid, key, big), pt_idx, num_segments=P
    )
    has = first_key < big
    first_safe = jnp.where(has, first_key % jnp.int32(S * N), 0)
    desc = state.desc_pm1.reshape(S * N, -1)[first_safe]
    return desc, has


def cull_points(
    state: SlamState, i, min_obs: int = 3, grace: int = 3
) -> tuple[SlamState, jnp.ndarray]:
    """Invalidate points older than `grace` frames with fewer than `min_obs`
    observations, and clear dangling feature associations.

    The `MapPointCulling` rule shape (never implemented by the reference).
    Returns (state', n_culled).
    """
    counts = observation_counts(state)
    anchors = point_anchors(state)
    mature = anchors < (i - grace)
    cull = state.point_valid & mature & (counts < min_obs)
    point_valid = state.point_valid & ~cull
    fp = state.feat_point
    dangling = cull[jnp.maximum(fp, 0)] & (fp >= 0)
    fp = jnp.where(dangling, -1, fp)
    return (
        state._replace(
            point_valid=point_valid,
            feat_point=fp,
            # freed slots are recycled by allocate_points; n_points tracks
            # the LIVE count, not a high-water cursor
            n_points=jnp.sum(point_valid.astype(jnp.int32)),
        ),
        jnp.sum(cull.astype(jnp.int32)),
    )


class FuseResult(NamedTuple):
    state: SlamState
    n_associated: jnp.ndarray


def fuse(
    state: SlamState,
    i,
    radius_px: float = 4.0,
    max_hamming: int = 60,
    image_wh=(640, 480),
    slab_cap: int = 4096,
) -> FuseResult:
    """Project all valid map points into frame i; features without a map
    point adopt the best projecting point within `radius_px` whose
    representative descriptor is within `max_hamming`.

    The candidates are first compacted to the <= `slab_cap` points actually
    visible in frame i (one O(P) projection + cumsum), so the pairwise
    pixel/Hamming tables are (N, L) instead of (N, P) — the O(N*P) HBM
    traffic this stage used to burn at map scale only
    ever touched ~in-view points anyway."""
    P = state.points.shape[0]
    N = state.kp_uv.shape[1]
    L = min(slab_cap, P)
    T = state.poses[i]
    k = state.k[i]
    Xc = se3.apply(T, state.points)  # (P, 3)
    uv_proj = cam.project(k, Xc)
    vis = (
        state.point_valid
        & (Xc[:, 2] > 1e-3)
        & cam.in_image(uv_proj, image_wh[0], image_wh[1])
    )

    pdesc, has_desc = point_descriptors(state)
    vis = vis & has_desc

    # --- compact visible points into an (L,) slab --------------------------
    rank = jnp.cumsum(vis.astype(jnp.int32)) - 1
    slab_of = jnp.where(vis & (rank < L), rank, L)
    slab_pid = (
        jnp.full(L + 1, 0, jnp.int32)
        .at[slab_of]
        .set(jnp.arange(P, dtype=jnp.int32), mode="drop")[:L]
    )
    slab_used = jnp.arange(L) < jnp.minimum(jnp.sum(vis.astype(jnp.int32)), L)
    uv_l = uv_proj[slab_pid]  # (L, 2)
    desc_l = pdesc[slab_pid]  # (L, 256)

    si = state_mod.slot_index(state, i)
    feat_uv = state.kp_uv[si]  # (N, 2)
    free = state.kp_valid[si] & (state.feat_point[si] < 0)

    # distance gates: pixel proximity AND descriptor distance
    d2 = jnp.sum(
        (feat_uv[:, None, :] - uv_l[None, :, :]) ** 2, axis=-1
    )  # (N, L)
    near = (d2 <= radius_px * radius_px) & slab_used[None, :] & free[:, None]

    dots = jnp.matmul(
        state.desc_pm1[si].astype(jnp.int8),
        desc_l.T,
        preferred_element_type=jnp.int32,
    )
    ham = (256 - dots) >> 1  # (N, L)
    BIG = jnp.int32(1 << 20)
    ham_gated = jnp.where(near & (ham <= max_hamming), ham, BIG)

    best = jnp.argmin(ham_gated, axis=1)  # (N,)
    best_d = jnp.take_along_axis(ham_gated, best[:, None], axis=1)[:, 0]
    adopt = best_d < BIG

    fp_i = jnp.where(adopt, slab_pid[best], state.feat_point[si])
    state = state._replace(feat_point=state.feat_point.at[si].set(fp_i))
    return FuseResult(state, jnp.sum(adopt.astype(jnp.int32)))


def covisibility(state: SlamState) -> jnp.ndarray:
    """(F, F) matrix of shared-map-point counts between frames — the
    covisibility graph as one matmul over the frame-point incidence
    (rows of evicted frames are zero)."""
    F = state.poses.shape[0]
    P = state.points.shape[0]
    cam_idx, pt_idx, _, _, valid = state_mod.observation_edges(state)
    inc = jnp.zeros((F, P), jnp.float32)
    inc = inc.at[cam_idx, pt_idx].max(valid.astype(jnp.float32))
    return jnp.matmul(inc, inc.T, preferred_element_type=jnp.float32).astype(jnp.int32)


def _incidence(state: SlamState) -> jnp.ndarray:
    """(F, P) 0/1 frame-point observation incidence (slot-resident
    observations, scattered to their frame rows)."""
    S, N = state.feat_point.shape
    F = state.poses.shape[0]
    P = state.points.shape[0]
    fp = state.feat_point
    resident = state.frame_of >= 0
    valid = (
        (fp >= 0)
        & state.kp_valid
        & resident[:, None]
        & state.point_valid[jnp.maximum(fp, 0)]
    )
    rows = jnp.repeat(
        jnp.where(resident, state.frame_of, jnp.int32(F)), N
    )
    inc = jnp.zeros((F + 1, P), jnp.float32)
    return inc.at[
        rows,
        jnp.maximum(fp.reshape(-1), 0),
    ].max(valid.reshape(-1).astype(jnp.float32))[:F]


def covisibility_row(state: SlamState, i) -> jnp.ndarray:
    """(F,) shared-map-point counts between frame i and every frame: one row
    of the covisibility graph as an incidence matvec (exact — 0/1 inputs with
    f32 accumulation)."""
    inc = _incidence(state)
    return jnp.matmul(inc, inc[i], preferred_element_type=jnp.float32).astype(
        jnp.int32
    )


def frame_overlap(state: SlamState, i, j) -> jnp.ndarray:
    """Fraction of frame i's associated points also observed by frame j —
    the keyframe-selection signal (scene change vs the last keyframe)."""
    si = state_mod.slot_index(state, i)
    sj = state_mod.slot_index(state, j)
    fp_i = state.feat_point[si]
    ok_i = (fp_i >= 0) & state.kp_valid[si]
    fp_j = state.feat_point[sj]
    ok_j = (fp_j >= 0) & state.kp_valid[sj]
    P = state.points.shape[0]
    seen_j = jnp.zeros(P, bool).at[jnp.where(ok_j, fp_j, P)].set(True, mode="drop")
    shared = jnp.sum((ok_i & seen_j[jnp.maximum(fp_i, 0)]).astype(jnp.int32))
    return shared / jnp.maximum(jnp.sum(ok_i.astype(jnp.int32)), 1)


def covisibility_window(state: SlamState, i, min_shared: int = 15) -> jnp.ndarray:
    """(F,) bool mask of frames covisible with frame i (>= min_shared points).
    The active-set selector for covisibility-windowed local BA (SURVEY.md 5.7)."""
    C = covisibility(state)
    return (C[i] >= min_shared) & state.pose_valid
