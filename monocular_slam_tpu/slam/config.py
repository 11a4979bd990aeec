"""Typed configuration tree — replaces the reference's three config tiers
(CLI flags `src/AppConfig.cpp`, compile-time constants `src/ParamConfig.h`,
and scattered `#define` toggles; see SURVEY.md 5.6).

All values that shape arrays are Python ints (static under jit); thresholds
are floats baked into the compiled programs.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class FrontendConfig:
    n_features: int = 1000  # keypoints per frame
    n_levels: int = 8  # pyramid levels (ORB default)
    fast_threshold: float = 20.0
    match_ratio_init: float = 0.85  # FEATURE_MATCH_RATIO_TEST (ParamConfig.h:5)
    match_ratio_track: float = 0.8  # matchFeatures default (CameraPoseEstimator.cpp:200)
    max_hamming: int = 80  # absolute descriptor distance gate
    # BRIEF steering: "binned" = angle rounded to 6-deg bins (descriptor
    # bits flip only at bin crossings), "continuous" = exact per-keypoint
    # steering (OpenCV ORB semantics; measurably more robust under fast
    # per-frame rotation — a 4 deg/frame orbit tracked 27/100 binned vs
    # 100/100 continuous). Both run the same one-hot sampling core; their
    # speeds on the GPU are not measured.
    # or "auto" = run binned while tracking is healthy and switch to
    # continuous when the inlier count degrades (hysteresis on an EMA; both
    # step programs are compiled, the session just picks one per frame) —
    # flagship speed in easy regimes, continuous robustness under
    # aggressive motion, no manual toggle.
    steer_mode: str = "auto"
    # auto-mode hysteresis thresholds as fractions of n_features: drop into
    # continuous when the tracked-inlier EMA falls below auto_low, return
    # to binned when it recovers above auto_high
    auto_low: float = 0.08
    auto_high: float = 0.18


@dataclass(frozen=True)
class InitConfig:
    ransac_iters: int = 2000  # `src/CameraPoseEstimator.cpp:26`
    sampson_px: float = 1.5  # inlier threshold in pixels
    min_inliers: int = 30
    max_cos_parallax: float = 0.99995  # reject rays with < ~0.6 deg parallax
    refine_iters: int = 25  # two-view BA polish of the algebraic init
    refine_px_thresh: float = 2.0  # post-refine reprojection gate
    # acceptance: the map must contain enough points whose depth is actually
    # observable, else the session defers and retries on a later frame
    strong_cos_parallax: float = 0.99985  # ~1 deg
    min_strong_parallax: int = 50
    max_defer: int = 6  # frames to wait before sliding the init reference


@dataclass(frozen=True)
class TrackConfig:
    back_traverse: int = 5  # numBackTraverse (`CameraPoseEstimator.cpp:390`)
    pnp_iters: int = 512
    pnp_px_thresh: float = 3.0
    # 15 (not 10): with relocalization as the safety net, a stricter gate
    # is strictly better — a 10-inlier consensus can be a garbage pose
    # (measured: one accepted 1 m-off frame on a fast-rotation orbit; at 15
    # it is rejected, relocalization recovers, ATE 10.8 -> 2.5 cm)
    pnp_min_inliers: int = 15
    triangulate_px_thresh: float = 2.0
    min_depth: float = 0.05
    max_depth: float = 100.0
    # TrackLocalMap (ORB-SLAM's track-local-map step; the capability the
    # reference declared as SearchInNeighbors, `src/LocalMapper.h:36`):
    # project window-covisible map points into the PnP pose, adopt
    # associations for still-free features, then motion-only re-refine.
    track_local_map: bool = True
    local_map_cap: int = 4096  # projection slab capacity
    # older covisible frames added to the projection slab beyond the
    # back-traverse window (ORB-SLAM's covisibility local map): at a
    # revisit the tracker re-adopts the ORIGINAL map points and anchors to
    # them, bounding drift without an explicit loop closure
    local_map_covis: int = 6
    local_radius_px: float = 9.0  # projection search radius (PnP pose)
    predict_radius_px: float = 18.0  # search radius under the motion model
    local_max_hamming: int = 64
    triangulate_max_cos_parallax: float = 0.99985  # ~1 deg minimum parallax
    # Relocalization (ORB-SLAM's Tracking::Relocalization; the reference has
    # no recovery — a failed frame is skipped forever, `src/Pipeline.h:57-61`)
    reloc_after: int = 3  # consecutive tracking failures before attempting
    reloc_min_inliers: int = 25  # stricter than tracking: a wrong
    # relocalization poisons the map, a missed one just waits a frame
    reloc_candidates: int = 3  # BoW-ranked keyframes to try per attempt


@dataclass(frozen=True)
class BAConfig:
    window: int = 8  # local BA keyframe window
    local_iters: int = 10
    # Run the mapping block (fuse -> windowed local BA -> cull) at KEYFRAME
    # rate — ORB-SLAM's LocalMapping cadence — instead of every frame. Every
    # frame still gets the motion-only pose refinement inside the tracker.
    # False restores the reference-shaped per-frame optimiser stage
    # (`src/Optimiser.cpp:6-18` runs FULL BA every frame).
    keyframe_only: bool = True
    # With keyframe_only, also run the mapping block every Nth frame even
    # without a keyframe (0 disables): long all-tracked stretches otherwise
    # accumulate unrefined triangulations between sparse keyframes (measured
    # 0.4 -> 6 mm synthetic ATE with no floor). 2 (not 4): on the rendered
    # image bench the denser floor cut per-seed drift from 0.8-1.6 cm to a
    # tight 0.7-0.9 cm across 4 PRNG seeds — the floor is the cheapest
    # anti-drift lever the session has (a window/iteration bump bought
    # less at higher cost).
    cadence_floor: int = 2
    # ...and on EVERY tracked frame for the first `warmup_frames`: the young
    # bootstrap map is noisy 2-view structure whose points have too few
    # observations to survive culling unless BA polishes them as the first
    # associations arrive (measured: gating BA during frames 2-8 collapsed
    # tracking by frame 5 on the rendered benchmark).
    warmup_frames: int = 10
    local_max_points: int = 2048  # active-point slab capacity for local BA
    # (measured max ~2030 active in a W=8 window at 1000 feat/frame; halving
    # the slab from 4096 halves every per-iteration grid op in window_ba)
    full_iters: int = 15  # FULL_BA_ITER (ParamConfig.h:18)
    pose_iters: int = 10  # POSE_BA_ITER (ParamConfig.h:15)
    huber_full: float = 5.99**0.5  # ParamConfig.h:8
    huber_pose: float = 5.991**0.5  # ParamConfig.h:10
    chi2_gate: float = 5.991  # ParamConfig.h:12
    use_covisibility: bool = True  # covisibility-ranked window (SURVEY.md 5.7)
    # vs pure time window; after a loop closure time-adjacent != covisible


@dataclass(frozen=True)
class MappingConfig:
    """Local-mapping hygiene — the `LocalMapper` stage the reference declared
    but never implemented (`src/LocalMapper.h:30-42`)."""

    enabled: bool = True
    fuse_every: int = 4  # frames between SearchInNeighbors-style fuse passes
    cull_every: int = 8  # frames between MapPointCulling passes
    cull_min_obs: int = 3  # observations required to survive culling
    # frames of immunity for a new point. 6 (not ORB-SLAM's ~3): with the
    # keyframe-rate mapping block, culling fires on every block, so a point
    # needs enough frames to accumulate min_obs associations first.
    cull_grace: int = 6
    fuse_radius_px: float = 4.0
    fuse_max_hamming: int = 60
    # keyframe selection (Mapper.insertKeyFrame in ORBSLAM.png)
    keyframe_overlap: float = 0.7  # new KF when overlap with last KF drops below
    keyframe_max_gap: int = 15
    # redundant-keyframe culling (LocalMapper::FrameCulling, LocalMapper.h:40)
    kf_cull_redundancy: float = 0.9  # fraction of points covered elsewhere
    kf_cull_min_other_obs: int = 3
    kf_keep_recent: int = 2  # newest keyframes are never culled
    # keyframes between FrameCulling passes (running it on EVERY keyframe
    # was a dominant with-loop-closer cost)
    kf_cull_every: int = 8


@dataclass(frozen=True)
class SlamConfig:
    max_frames: int = 128  # pose-tier capacity (12 floats/frame — cheap)
    # Feature-tier capacity: recycled SLOTS holding the big per-frame slabs
    # (keypoints/descriptors/associations). None = max_frames (no eviction).
    # Smaller than max_frames turns on keyframe-aware slot eviction so a
    # long trajectory's descriptor memory scales with scene coverage, not
    # length (SURVEY.md §5.7; the reference's DataManager grows unboundedly,
    # `src/DataManager.h:25-35`).
    max_slots: int | None = None
    max_points: int = 20000
    image_wh: tuple = (640, 480)
    # Frames of host-side lag before a frame's packed step stats are pulled
    # and acted on (loop-closure consistency, relocalization streaks, frame
    # culling). Lag keeps the host from serializing on every frame's device
    # scalars — by the time frame i-stat_lag is read, its step finished long
    # ago and the pull is a cheap completed-buffer fetch. Must stay below
    # the tracker's back-traverse window so relocalization can still reach
    # the newest frame.
    stat_lag: int = 3
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    init: InitConfig = field(default_factory=InitConfig)
    track: TrackConfig = field(default_factory=TrackConfig)
    ba: BAConfig = field(default_factory=BAConfig)
    mapping: MappingConfig = field(default_factory=MappingConfig)
