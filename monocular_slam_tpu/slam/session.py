"""SlamSession — host-side driver orchestrating the jitted SLAM stages.

The analog of the reference's `main` loop + `ProcessingPipeline`
(`src/main.cpp:40-51`, `src/Pipeline.h:49-65`). Frame-count branching
(frame 0 / bootstrap / tracked, `CameraPoseEstimator.cpp:517-527`) lives on
the host; once initialized, each frame is ONE compiled program
(`_session_step`: track -> local BA -> fuse -> cull -> keyframe rule, plus
fused loop-closure DETECTION when a closer is attached) with zero host
round-trips — per-frame outcomes come back as two packed device vectors
that the host pulls `stat_lag` frames late, when the data has long been
ready. The reference runs its stages as separate virtual calls over shared
memory (`Pipeline.h:57-64`); separate *dispatches* here would each cost a
host->device hop and a sync per `int()`.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from monocular_slam_tpu.ops import features as features_mod
from monocular_slam_tpu.ops import orb
from monocular_slam_tpu.slam import (
    local_ba,
    loop_closer as lc_mod,
    mapping,
    state as state_mod,
    tracker,
)
from monocular_slam_tpu.slam.config import SlamConfig
from monocular_slam_tpu.slam.state import SlamState
from typing import NamedTuple

# packed per-frame stats layout (one int32 vector + one float32 vector per
# frame instead of ~10 separate device scalars: one host pull each)
_I32_FIELDS = (
    "tracked", "n_inliers", "n_new_points", "n_fused", "n_culled",
    "is_keyframe", "last_kf", "cand_j", "cand_n",
)
_F32_FIELDS = ("chi2_before", "chi2_after", "cand_score", "cand_floor")
_BOOL_FIELDS = frozenset({"tracked", "is_keyframe"})


class FrameStats:
    """Per-frame outcomes. After the fused step the values live in two
    packed DEVICE vectors; reading any field pulls both once and caches
    them (device-lazy — don't read in a hot loop before the lag window)."""

    __slots__ = ("frame", "loop_closed", "_i32", "_vals")

    def __init__(self, frame: int, **kw):
        object.__setattr__(self, "frame", frame)
        object.__setattr__(self, "loop_closed", False)
        object.__setattr__(self, "_i32", None)
        vals = {
            "tracked": False, "n_inliers": 0, "n_new_points": 0,
            "n_fused": 0, "n_culled": 0, "is_keyframe": False,
            "last_kf": -1, "cand_j": -1, "cand_n": 0,
            "chi2_before": float("nan"), "chi2_after": float("nan"),
            "cand_score": 0.0, "cand_floor": 0.0,
        }
        vals.update(kw)
        object.__setattr__(self, "_vals", vals)

    def _set_device(self, packed) -> None:
        # start the device->host copy NOW, in the background: a later
        # blocking np.asarray queues behind every dispatched step (it syncs
        # to the END of the dispatch queue), while an async copy started at
        # enqueue time is long done when the lagged drain reads it
        try:
            packed.copy_to_host_async()
        except (AttributeError, RuntimeError):
            pass
        object.__setattr__(self, "_i32", packed)

    def _resolve(self) -> None:
        if self._i32 is None:
            return
        packed = np.asarray(self._i32)
        n_i = len(_I32_FIELDS)
        f32 = packed[n_i:].view(np.float32)
        vals = self._vals
        for n, x in zip(_I32_FIELDS, packed[:n_i]):
            vals[n] = bool(x) if n in _BOOL_FIELDS else int(x)
        for n, x in zip(_F32_FIELDS, f32):
            vals[n] = float(x)
        object.__setattr__(self, "_i32", None)

    def __getattr__(self, name):
        vals = object.__getattribute__(self, "_vals")
        if name in vals:
            FrameStats._resolve(self)
            return vals[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name in FrameStats.__slots__:
            object.__setattr__(self, name, value)
        else:
            FrameStats._resolve(self)
            object.__getattribute__(self, "_vals")[name] = value

    def __repr__(self):  # resolves — debugging aid only
        self._resolve()
        return f"FrameStats(frame={self.frame}, {self._vals})"


class StepStats(NamedTuple):
    tracked: jnp.ndarray
    n_inliers: jnp.ndarray
    n_new_points: jnp.ndarray
    chi2_before: jnp.ndarray
    chi2_after: jnp.ndarray
    n_fused: jnp.ndarray
    n_culled: jnp.ndarray
    is_keyframe: jnp.ndarray
    last_kf: jnp.ndarray


def _session_step(
    state: SlamState, i, last_kf, key, cfg: SlamConfig, run_ba: bool
) -> tuple[SlamState, StepStats]:
    """One fused per-frame step for an initialized session: PnP track, the
    keyframe rule, then (conditionally, on-device) the mapping block —
    fuse -> windowed local BA -> cull. `lax.cond` skips the untaken work at
    runtime while keeping this a single compiled program.

    With `cfg.ba.keyframe_only` (default) the mapping block runs only when
    the frame is promoted to a keyframe — ORB-SLAM's LocalMapping cadence
    (tracking stays per-frame via the motion-only refinement inside
    `tracker.track`). Otherwise it follows the reference-shaped per-frame
    cadence (`src/Optimiser.cpp:6-18`) with fuse/cull on their own clocks."""
    tres = tracker.track(state, i, key, cfg)
    state = tres.state
    nan = jnp.asarray(jnp.nan, state.poses.dtype)
    m = cfg.mapping
    zero = jnp.asarray(0, jnp.int32)

    # keyframe rule (Mapper.insertKeyFrame, ORBSLAM.png): first tracked frame,
    # overlap with the last keyframe dropped, or max gap exceeded. When the
    # last keyframe's features were evicted (slot recycling), slot_index
    # clamps to slot 0 and the overlap would be measured against an arbitrary
    # frame — treat it as 0 (scene changed) instead.
    kf_resident = state.slot_of[jnp.maximum(last_kf, 0)] >= 0
    ov = jnp.where(
        kf_resident, mapping.frame_overlap(state, i, jnp.maximum(last_kf, 0)), 0.0
    )
    is_kf = tres.ok & (
        (last_kf < 0)
        | (ov < m.keyframe_overlap)
        | (i - last_kf >= m.keyframe_max_gap)
    )
    last_kf = jnp.where(is_kf, jnp.asarray(i, jnp.int32), last_kf)

    def _fuse(st):
        r = mapping.fuse(
            st, i, radius_px=m.fuse_radius_px,
            max_hamming=m.fuse_max_hamming, image_wh=cfg.image_wh,
        )
        return r.state, r.n_associated.astype(jnp.int32)

    def _cull(st):
        r = mapping.cull_points(
            st, i, min_obs=m.cull_min_obs, grace=m.cull_grace
        )
        return r[0], r[1].astype(jnp.int32)

    def _ba(st):
        r = local_ba.local_bundle_adjust(st, i, cfg)
        return r.state, r.chi2_initial, r.chi2_final

    if cfg.ba.keyframe_only:
        # keyframe-rate mapping block. Fuse/cull run ONLY on keyframe blocks
        # (ORB-SLAM's LocalMapping fuses and culls per inserted keyframe;
        # fusing on every block measured 0.37 -> 1.7 cm ATE on the rendered
        # benchmark — the 4 px merge radius wrongly unifies points when
        # applied at frame rate). Cadence-floor/warmup blocks solve alone.
        def _map_block(st):
            n_f = n_c = zero
            if m.enabled:
                st, n_f = jax.lax.cond(is_kf, _fuse, lambda s: (s, zero), st)
            if run_ba:
                st, c0, c1 = _ba(st)
            else:
                c0 = c1 = nan
            if m.enabled:
                st, n_c = jax.lax.cond(is_kf, _cull, lambda s: (s, zero), st)
            return st, c0, c1, n_f, n_c

        run_map = is_kf
        if cfg.ba.cadence_floor:
            run_map = run_map | (tres.ok & (i % cfg.ba.cadence_floor == 0))
        if cfg.ba.warmup_frames:
            run_map = run_map | (tres.ok & (i < cfg.ba.warmup_frames))
        state, chi2_0, chi2_1, n_fused, n_culled = jax.lax.cond(
            run_map,
            _map_block,
            lambda st: (st, nan, nan, zero, zero),
            state,
        )
    else:
        if run_ba:
            state, chi2_0, chi2_1 = jax.lax.cond(
                tres.ok, _ba, lambda st: (st, nan, nan), state
            )
        else:
            chi2_0 = chi2_1 = nan
        n_fused = n_culled = zero
        if m.enabled and m.fuse_every:
            state, n_fused = jax.lax.cond(
                tres.ok & (i % m.fuse_every == 0),
                _fuse, lambda st: (st, zero), state,
            )
        if m.enabled and m.cull_every:
            state, n_culled = jax.lax.cond(
                tres.ok & (i % m.cull_every == 0),
                _cull, lambda st: (st, zero), state,
            )

    return state, StepStats(
        tracked=tres.ok,
        n_inliers=tres.n_pnp_inliers,
        n_new_points=tres.n_new_points,
        chi2_before=chi2_0,
        chi2_after=chi2_1,
        n_fused=n_fused,
        n_culled=n_culled,
        is_keyframe=is_kf,
        last_kf=last_kf,
    )


def _image_session_step(
    state: SlamState, img, i, slot, last_kf, key, k, dist, cfg: SlamConfig,
    run_ba: bool,
) -> tuple[SlamState, StepStats]:
    """ONE program for a tracked image frame: ORB extraction -> keypoint
    undistortion -> state ingest -> `_session_step`. Fusing extraction into
    the step saves two dispatch round trips per frame and lets XLA schedule
    the extractor into the step's pipeline bubbles."""
    from monocular_slam_tpu.geometry import camera as cam

    feats = features_mod.extract(
        img.astype(jnp.float32),
        n_features=cfg.frontend.n_features,
        n_levels=cfg.frontend.n_levels,
        fast_threshold=cfg.frontend.fast_threshold,
        steer_mode=cfg.frontend.steer_mode,
    )
    # radtan undistortion is exactly identity at zero coefficients, so the
    # no-distortion datasets ride the same program
    uv = cam.undistort_pixels(k, dist, feats.uv)
    state = state_mod.add_frame_features(
        state, i, slot, uv, feats.scale, feats.valid, feats.desc,
        feats.desc_pm1, k,
    )
    return _session_step(state, i, last_kf, key, cfg, run_ba)


def _pack_step(
    state: SlamState, stats: StepStats, db, i, voc, lcfg
):
    """Append fused loop-closure detection (when a vocabulary is attached)
    and pack the step outcome into two vectors — the session's only
    per-frame host-visible products besides the state itself."""
    if voc is None:
        det = lc_mod.null_detect_out()
    else:
        db, det = lc_mod.detect_step(
            voc, lcfg, db, state, i, stats.is_keyframe
        )
    i32 = jnp.stack([
        stats.tracked.astype(jnp.int32),
        jnp.asarray(stats.n_inliers, jnp.int32),
        jnp.asarray(stats.n_new_points, jnp.int32),
        jnp.asarray(stats.n_fused, jnp.int32),
        jnp.asarray(stats.n_culled, jnp.int32),
        stats.is_keyframe.astype(jnp.int32),
        jnp.asarray(stats.last_kf, jnp.int32),
        det.best_j,
        det.n_cand,
    ])
    f32 = jnp.stack([
        jnp.asarray(stats.chi2_before, jnp.float32),
        jnp.asarray(stats.chi2_after, jnp.float32),
        det.score,
        det.floor,
    ])
    # ONE packed vector (floats bitcast into the int lanes): one host pull
    # per frame
    packed = jnp.concatenate(
        [i32, jax.lax.bitcast_convert_type(f32, jnp.int32)]
    )
    return state, db, stats.last_kf, packed


class SlamSession:
    """Feed frames (images or precomputed features), get trajectory + map.

    Usage:
        sess = SlamSession(cfg)
        for img, ts in frames:
            sess.add_frame(img, k=K, timestamp=ts)
        poses, valid = sess.trajectory()
    """

    def __init__(
        self,
        cfg: SlamConfig = SlamConfig(),
        seed: int = 0,
        run_ba: bool = True,
        loop_closer=None,
    ):
        self.cfg = cfg
        self.run_ba = run_ba
        self.loop_closer = loop_closer  # optional slam.loop_closer.LoopCloser
        self.state: SlamState = state_mod.empty_state(cfg)
        self.key = jax.random.PRNGKey(seed)
        self.stats: list[FrameStats] = []
        self.timestamps: list[float] = []  # host-side (f32 can't hold epochs)
        self._next = 0

        voc = loop_closer.voc if loop_closer is not None else None
        lcfg = loop_closer.lc if loop_closer is not None else None
        # the BoW database rides THROUGH the fused step program (detection
        # and the row insert run on device at keyframe rate); a session
        # without a closer carries a 1-element dummy
        self._db = (
            loop_closer._db if loop_closer is not None
            else jnp.zeros((1, 1), jnp.float32)
        )

        # jit the stages once (cfg is static through closure). With
        # steer_mode="auto" BOTH steering variants of the image programs are
        # built; the session picks one per frame from tracking health
        # (binned while healthy, continuous when inliers degrade).
        import dataclasses as _dc

        self._auto_steer = cfg.frontend.steer_mode == "auto"
        steer_modes = (
            ("binned", "continuous") if self._auto_steer
            else (cfg.frontend.steer_mode,)
        )
        self._steer = steer_modes[0]
        self._steer_since = 0
        self._inlier_ema: float | None = None
        self._programs: dict = {}
        for m in steer_modes:
            cfg_m = _dc.replace(
                cfg, frontend=_dc.replace(cfg.frontend, steer_mode=m)
            )
            extract_m = jax.jit(
                partial(
                    features_mod.extract,
                    n_features=cfg.frontend.n_features,
                    n_levels=cfg.frontend.n_levels,
                    fast_threshold=cfg.frontend.fast_threshold,
                    steer_mode=m,
                )
            )
            img_step_m = jax.jit(
                lambda st, db, img, i, slot, last_kf, key, k, dist,
                _c=cfg_m: _pack_step(
                    *_image_session_step(
                        st, img, i, slot, last_kf, key, k, dist, _c, run_ba
                    ),
                    db, i, voc, lcfg,
                )
            )
            img_step_buf_m = jax.jit(
                lambda st, db, buf, j, i, slot, last_kf, key, k, dist,
                _c=cfg_m: _pack_step(
                    *_image_session_step(
                        st, buf[j], i, slot, last_kf, key, k, dist, _c,
                        run_ba,
                    ),
                    db, i, voc, lcfg,
                )
            )
            self._programs[m] = (extract_m, img_step_m, img_step_buf_m)
        self._bootstrap = jax.jit(
            lambda st, f0, f1, key: tracker.bootstrap(st, key, cfg, f0, f1)
        )
        self._initialized = False
        self._init_ref = 0  # bootstrap reference frame (slides on failure)
        # NOTE deliberately no donate_argnums here: donating the state
        # pytree through these programs once measured no steady-state gain
        # but blew the bootstrap program's XLA compile up 20x (the donation
        # aliasing analysis interacts pathologically with the big
        # tree_map(where) failure-restore outputs); not re-measured on GPU
        self._step = jax.jit(
            lambda st, db, i, last_kf, key: _pack_step(
                *_session_step(st, i, last_kf, key, cfg, run_ba),
                db, i, voc, lcfg,
            )
        )
        self._add_feats = jax.jit(state_mod.add_frame_features)
        self._reloc = jax.jit(
            lambda st, i, cand, key: tracker.relocalize(st, i, cand, key, cfg)
        )
        m = cfg.mapping
        self._cull_fn = jax.jit(
            lambda st, flags, protect: _kf_cull_device(
                st, flags, protect, m.kf_cull_redundancy,
                m.kf_cull_min_other_obs,
            )
        )
        self._fail_streak = 0
        self._dev_consts: dict = {}  # host bytes -> device array (k, dist)
        self._last_kf = jnp.asarray(-1, jnp.int32)  # device keyframe anchor
        self._kf_culled: set[int] = set()  # FrameCulling victims
        self._keyframes: list[int] = []  # incrementally folded from stats
        self._kf_scanned = 0  # stats entries already folded
        self._kf_since_cull = 0  # keyframes since the last FrameCulling pass
        self._cull_pending = None  # (device flags, kf snapshot, dispatch frame)
        # stats pending host-side processing (pulled `stat_lag` frames late)
        self._pending: list[FrameStats] = []
        # feature-tier slot allocator (host mirror of state.frame_of):
        # slots are handed out in order, then recycled keyframe-aware
        S = state_mod.n_slots(cfg)
        self._slot_frame: list[int] = [-1] * S  # slot -> frame id
        self._free_slots: list[int] = list(range(S - 1, -1, -1))
        # frames younger than this many steps are never evicted: the
        # tracker's back-traverse match window must stay resident (the BA
        # window needs no protection — its covisibility ranking already
        # restricts itself to slot-resident frames)
        self._protect_window = cfg.track.back_traverse + 2

    def _split(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    # current-steering program accessors (auto mode switches per frame)
    @property
    def _extract(self):
        return self._programs[self._steer][0]

    @property
    def _img_step(self):
        return self._programs[self._steer][1]

    @property
    def _img_step_buf(self):
        return self._programs[self._steer][2]

    def _update_steer_health(self, st: FrameStats) -> None:
        """Auto steering: binned-LUT descriptors while tracking is healthy,
        exact continuous steering when tracking degrades (fast per-frame
        rotation destabilizes binned descriptors — the inlier-EMA drop is
        the early warning, a failed frame the alarm).

        Switching changes every subsequent descriptor, which perturbs
        matching against pre-switch frames (~a bin's worth of Hamming
        noise) — so switches carry a DWELL time: the degrade switch fires
        at most once per dwell window, and the recover switch additionally
        demands a long healthy streak. Measured without the dwell: the mode
        flapped every few frames and the switch noise itself broke
        tracking."""
        fe = self.cfg.frontend
        i = st.frame
        if st.tracked:
            n = float(st.n_inliers)
            self._inlier_ema = (
                n if self._inlier_ema is None
                else 0.7 * self._inlier_ema + 0.3 * n
            )
        low = fe.auto_low * fe.n_features
        high = fe.auto_high * fe.n_features
        dwell = i - self._steer_since
        if self._steer == "binned":
            # degradation is usually a CLIFF, not a slope (measured: >=100
            # inliers for 40 frames, dead 4 frames later) — so trigger on a
            # sharp RELATIVE drop against the healthy EMA as well as on the
            # absolute floor and outright failure
            sharp_drop = (
                st.tracked
                and self._inlier_ema is not None
                and float(st.n_inliers) < 0.45 * self._inlier_ema
            )
            ema_low = self._inlier_ema is not None and self._inlier_ema < low
            if (not st.tracked) or (dwell >= 10 and (sharp_drop or ema_low)):
                self._steer = "continuous"
                self._steer_since = i
                self._inlier_ema = None  # fresh statistics for the new mode
        else:
            if (
                st.tracked
                and dwell >= 50
                and self._inlier_ema is not None
                and self._inlier_ema > high
            ):
                self._steer = "binned"
                self._steer_since = i

    def lower_image_step(self, fn=None):
        """The per-frame image program (extraction -> track -> local BA ->
        keyframe mapping -> loop detection), lowered at `cfg.image_wh` for
        the current steering mode unless `fn` names another. `.compile()`
        it for `memory_analysis()` / `cost_analysis()`."""
        cfg = self.cfg
        dtype = self.state.kp_uv.dtype
        img = jnp.zeros((cfg.image_wh[1], cfg.image_wh[0]), jnp.float32)
        return (fn or self._img_step).lower(
            self.state, self._db, img, 2, 2, jnp.asarray(0, jnp.int32),
            jax.random.PRNGKey(0), jnp.zeros(4, dtype), jnp.zeros(5, dtype),
        )

    def prewarm(self, image: bool = False, n_threads: int = 4) -> float:
        """Compile the session's per-frame programs ahead of the first frame,
        in PARALLEL threads (XLA releases the GIL while it compiles, and the
        programs are independent, so wall time is the max, not the sum).
        Results land in the persistent compilation cache. Returns seconds
        spent."""
        import time
        from concurrent.futures import ThreadPoolExecutor

        t0 = time.perf_counter()
        cfg = self.cfg
        st = self.state
        db = self._db
        key = jax.random.PRNGKey(0)
        N = cfg.frontend.n_features
        dtype = st.kp_uv.dtype

        def _mk_extract(fn):
            def c():
                if image:
                    img = jnp.zeros(
                        (cfg.image_wh[1], cfg.image_wh[0]), jnp.float32
                    )
                    fn.lower(img).compile()
            return c

        def _mk_img_step(fn):
            def c():
                if image:
                    self.lower_image_step(fn).compile()
            return c

        def c_add():
            self._add_feats.lower(
                st, 0, 0, jnp.zeros((N, 2), dtype), jnp.ones(N, dtype),
                jnp.zeros(N, bool), jnp.zeros((N, 8), jnp.uint32),
                jnp.zeros((N, 256), jnp.int8), jnp.zeros(4, dtype),
            ).compile()

        def c_boot():
            self._bootstrap.lower(st, 0, 1, key).compile()

        def c_step():
            self._step.lower(
                st, db, 2, jnp.asarray(0, jnp.int32), key
            ).compile()

        jobs = [c_add, c_boot, c_step]
        for ext_fn, img_fn, _buf_fn in self._programs.values():
            jobs.append(_mk_extract(ext_fn))
            jobs.append(_mk_img_step(img_fn))
        with ThreadPoolExecutor(n_threads) as ex:
            futs = [ex.submit(f) for f in jobs]
            for f in futs:
                f.result()
        return time.perf_counter() - t0

    def _acquire_slot(self, i: int) -> tuple[int, int]:
        """Free slot for frame i, evicting keyframe-aware when exhausted:
        the oldest non-keyframe's features go first (they were only needed
        for the tracker's recent-frame window), then the oldest keyframe
        outside the protected window. Evicted frames keep their pose,
        validity, and triangulated map points — only descriptors/keypoints
        and their observation back-pointers are dropped, so feature memory
        scales with scene coverage (keyframes surviving FrameCulling) rather
        than trajectory length (SURVEY.md §5.7; the reference's DataManager
        keeps everything forever, `src/DataManager.h:25-35`).

        Returns (slot, prev_frame): prev_frame is the evicted occupant
        (-1 if the slot was free) so a failed ingest can roll the host
        mirror back via `_release_slot`."""
        if self._free_slots:
            slot = self._free_slots.pop()
            self._slot_frame[slot] = i
            return slot, -1
        protect_after = i - self._protect_window
        # keyframe flags may lag by `stat_lag` frames; lagging keyframes are
        # inside the protected window anyway (stat_lag < protect_window)
        if self.loop_closer is not None:
            kfs = set(self._keyframes_known())
        else:
            kfs = set(self.keyframes)
        resident = sorted(
            (f, slo) for slo, f in enumerate(self._slot_frame) if f >= 0
        )
        victim = None
        for f, slo in resident:
            if f >= protect_after:
                break
            if f not in kfs:
                victim = slo
                break
        if victim is None:
            for f, slo in resident:
                if f >= protect_after:
                    break
                victim = slo  # oldest keyframe — slots truly exhausted
                break
        if victim is None:
            raise ValueError(
                "all feature slots are held by the active window; raise "
                "cfg.max_slots"
            )
        prev = self._slot_frame[victim]
        self._slot_frame[victim] = i
        return victim, prev

    def _release_slot(self, slot: int, prev_frame: int) -> None:
        """Undo `_acquire_slot` after a failed ingest (the device state was
        never updated, so the host mirror must not claim the frame landed)."""
        self._slot_frame[slot] = prev_frame
        if prev_frame < 0:
            self._free_slots.append(slot)

    def add_frame_features(
        self, feats: orb.Features, k, timestamp: float, dist=None
    ) -> FrameStats:
        """Ingest a frame from precomputed features (the fixture path — the
        reference's CSV snapshot trick, SURVEY.md 5.4). `dist` (radtan
        5-vector) undistorts keypoints before they enter the state — the
        correction the reference only half-applied (SURVEY.md 2.4)."""
        if dist is not None:
            if np.any(np.asarray(dist) != 0):
                from monocular_slam_tpu.geometry import camera as _cam

                feats = feats._replace(
                    uv=_cam.undistort_pixels(
                        jnp.asarray(k), jnp.asarray(dist), feats.uv
                    )
                )
        i = self._next
        if i >= self.cfg.max_frames:
            raise ValueError(f"frame capacity {self.cfg.max_frames} exhausted")
        slot, prev = self._acquire_slot(i)
        try:
            self.state = self._add_feats(
                self.state,
                i,
                slot,
                feats.uv,
                feats.scale,
                feats.valid,
                feats.desc,
                feats.desc_pm1,
                jnp.asarray(k),
            )
        except Exception:
            self._release_slot(slot, prev)
            raise
        self._next += 1
        self.timestamps.append(float(timestamp))
        st = FrameStats(frame=i)
        if i == 0:
            st.tracked = True  # reference frame; pose_valid set by bootstrap
        elif not self._initialized:
            # Deferred two-view initialization: retry against the reference
            # frame until the map is well-conditioned (the reference runs its
            # `initialPoseEstimation` exactly once on frames (0, 1) and lives
            # with whatever it gets, `src/main.cpp:48-51`).
            res = self._bootstrap(self.state, self._init_ref, i, self._split())
            self.state = res.state
            st.tracked = bool(res.ok)
            st.n_inliers = int(res.n_inliers)
            st.n_new_points = int(res.n_points)
            if st.tracked:
                self._initialized = True
                st.is_keyframe = True
                self._last_kf = jnp.asarray(i, jnp.int32)
                if self.loop_closer is not None:
                    # the map's first anchor must be queryable for closure
                    self._db = self.loop_closer._insert_from_state(
                        self._db, self.state, i
                    )
                    self.loop_closer._db = self._db
            elif i - self._init_ref >= self.cfg.init.max_defer:
                self._init_ref = i - 1
        else:
            # ONE fused program per frame; stats stay on device (lazy)
            self.state, self._db, self._last_kf, packed = self._step(
                self.state, self._db, i, self._last_kf, self._split()
            )
            st._set_device(packed)
        self._enqueue(st)
        return st

    def _enqueue(self, st: FrameStats) -> None:
        self.stats.append(st)
        if self.loop_closer is None and not self._auto_steer:
            return
        if self.loop_closer is not None:
            self.loop_closer._db = self._db
        self._pending.append(st)
        self._drain(force=False)

    def _drain(self, force: bool) -> None:
        """Process pending frame stats once they are `stat_lag` frames old
        (their device scalars are finished buffers by then — the pull does
        not serialize the dispatch pipeline)."""
        lag = self.cfg.stat_lag
        if self._cull_pending is not None and (
            force or self._next - self._cull_pending[2] > lag
        ):
            self._cull_apply()
        while self._pending and (force or len(self._pending) > lag):
            st = self._pending.pop(0)
            self._process_stat(st)

    def _process_stat(self, st: FrameStats) -> None:
        i = st.frame
        st._resolve()
        self._fold_kf_upto(i + 1)
        if self._auto_steer:
            self._update_steer_health(st)
        if self.loop_closer is None:
            return
        if not st.tracked:
            # Relocalization (ORB-SLAM Tracking::Relocalization): after a
            # run of failures, PnP against the BoW-nearest keyframes. Only
            # active with a loop closer attached — its database supplies
            # the candidates.
            self._fail_streak += 1
            if self._fail_streak >= self.cfg.track.reloc_after:
                self._try_relocalize()
            return
        self._fail_streak = 0
        if not st.is_keyframe:
            return
        self._kf_since_cull += 1
        if (
            self._kf_since_cull >= self.cfg.mapping.kf_cull_every
            and self._cull_pending is None
            and len(self._keyframes_known())
            > self.cfg.mapping.kf_keep_recent + 1
        ):
            self._kf_since_cull = 0
            self._cull_dispatch()
        lc = self.loop_closer
        j = lc.offer(i, st.cand_j, st.cand_score, st.cand_floor, st.cand_n)
        if j is not None and j not in self._kf_culled:
            # the correction graph spans EVERY ever-promoted keyframe —
            # culled ones keep their poses and remain valid vertices, so
            # non-keyframe propagation chains stay bounded by the keyframe
            # cadence (propagating a whole early revolution through the one
            # surviving early keyframe measured 0.3-1.0 m of frozen drift)
            self.state, closed = lc.close(
                self.state, i, j, self._split(),
                keyframes=list(self._keyframes),
            )
            st.loop_closed = closed

    def _try_relocalize(self) -> None:
        """Relocalize the NEWEST ingested frame against the BoW-nearest
        resident keyframes (the failure was detected `stat_lag` frames
        late; rescuing an old frame would leave the tracker's motion model
        dead — the newest frame is the one the next step can chain from)."""
        lc = self.loop_closer
        i = self._next - 1
        newest = self.stats[i]
        newest._resolve()
        if newest.tracked:
            self._fail_streak = 0
            return
        sl = int(self.state.slot_of[i])
        if sl < 0:
            return
        scores = np.asarray(lc._reloc_scores(self._db, self.state, i))
        slot_of = np.asarray(self.state.slot_of)
        pose_valid = np.asarray(self.state.pose_valid)
        order = np.argsort(-scores)
        cands = [
            int(f) for f in order
            if np.isfinite(scores[f]) and f < i and slot_of[f] >= 0
            and pose_valid[f]
        ][: self.cfg.track.reloc_candidates]
        for cand in cands:
            res = self._reloc(self.state, i, cand, self._split())
            if bool(res.ok):
                self.state = res.state
                newest.tracked = True
                newest.n_inliers = int(res.n_inliers)
                self._fail_streak = 0
                return

    def _dev_const(self, arr, dtype) -> jnp.ndarray:
        """Device copy of a small host constant (k, dist), cached by value —
        constants transfer ONCE instead of a transfer per frame."""
        if isinstance(arr, jnp.ndarray):
            return arr.astype(dtype)
        key = (np.asarray(arr, np.float64).tobytes(), str(dtype))
        hit = self._dev_consts.get(key)
        if hit is None:
            hit = jax.device_put(jnp.asarray(arr, dtype))
            self._dev_consts[key] = hit
        return hit

    def _ingest_image_step(
        self, step_args, i, timestamp, slot, prev_frame
    ) -> FrameStats:
        try:
            out = step_args()
        except Exception:
            # the fused step never dispatched/failed at dispatch: roll the
            # host mirrors back so bookkeeping matches the device state
            self._release_slot(slot, prev_frame)
            raise
        self.state, self._db, self._last_kf, packed = out
        self._next += 1
        self.timestamps.append(float(timestamp))
        st = FrameStats(frame=i)
        st._set_device(packed)
        self._enqueue(st)
        return st

    def add_frame(self, img, k, timestamp: float = 0.0, dist=None) -> FrameStats:
        """Ingest a grayscale image (H, W) [0, 255].

        Initialized sessions run ONE fused program per image frame
        (`_image_session_step`); until then extraction runs standalone and
        the frame takes the feature path."""
        if self._initialized and self._next >= 2:
            i = self._next
            if i >= self.cfg.max_frames:
                raise ValueError(
                    f"frame capacity {self.cfg.max_frames} exhausted"
                )
            dtype = self.state.kp_uv.dtype
            dist_arr = self._dev_const(
                np.zeros(5) if dist is None else dist, dtype
            )
            img_dev = (
                img if isinstance(img, jnp.ndarray) else jax.device_put(img)
            )
            slot, prev = self._acquire_slot(i)
            return self._ingest_image_step(
                lambda: self._img_step(
                    self.state, self._db, img_dev, i, slot, self._last_kf,
                    self._split(), self._dev_const(k, dtype), dist_arr,
                ),
                i, timestamp, slot, prev,
            )
        feats = self._extract(jnp.asarray(img, dtype=jnp.float32))
        return self.add_frame_features(feats, k, timestamp, dist=dist)

    def add_frame_from_buffer(
        self, buffer, idx: int, k, timestamp: float = 0.0, dist=None
    ) -> FrameStats:
        """Ingest frame `idx` of a DEVICE-RESIDENT (N, H, W) image buffer.

        The analog of the reference's FrameLoader preload
        (`src/main.cpp:35-37` loads every frame into RAM before the per-frame
        loop): frames live in device memory, the per-frame loop does ZERO
        host->device transfers. The slice happens inside the fused step
        program."""
        if self._initialized and self._next >= 2:
            i = self._next
            if i >= self.cfg.max_frames:
                raise ValueError(
                    f"frame capacity {self.cfg.max_frames} exhausted"
                )
            dtype = self.state.kp_uv.dtype
            dist_arr = self._dev_const(
                np.zeros(5) if dist is None else dist, dtype
            )
            slot, prev = self._acquire_slot(i)
            return self._ingest_image_step(
                lambda: self._img_step_buf(
                    self.state, self._db, buffer, idx, i, slot, self._last_kf,
                    self._split(), self._dev_const(k, dtype), dist_arr,
                ),
                i, timestamp, slot, prev,
            )
        feats = self._extract(buffer[idx].astype(jnp.float32))
        return self.add_frame_features(feats, k, timestamp, dist=dist)

    def _cull_dispatch(self) -> None:
        """Launch the FrameCulling program; the (F,) flag pull is deferred
        to a later drain via an async host copy (a blocking pull here would
        sync to the end of the dispatch queue — see `_set_device`)."""
        m = self.cfg.mapping
        if self.loop_closer is not None:
            kfs = self._keyframes_known()
        else:
            kfs = self.keyframes
        if len(kfs) <= m.kf_keep_recent + 1:
            return
        F = self.cfg.max_frames
        flags = np.zeros(F, bool)
        flags[kfs] = True
        protect = np.zeros(F, bool)
        protect[kfs[0]] = True  # the map's first anchor
        protect[kfs[-m.kf_keep_recent:]] = True  # still gathering obs
        flags_dev = self._cull_fn(
            self.state, jnp.asarray(flags), jnp.asarray(protect)
        )
        try:
            flags_dev.copy_to_host_async()
        except (AttributeError, RuntimeError):
            pass
        self._cull_pending = (flags_dev, kfs, self._next)

    def _cull_apply(self) -> list[int]:
        if self._cull_pending is None:
            return []
        flags_dev, kfs, _ = self._cull_pending
        self._cull_pending = None
        new_flags = np.asarray(flags_dev)
        culled = [f for f in kfs if not new_flags[f]]
        self._kf_culled.update(culled)
        if culled and self.loop_closer is not None:
            # drop culled keyframes out of the device BoW database (their
            # zeroed rows leave the candidate set and the similarity floor)
            F = self.cfg.max_frames
            for lo in range(0, len(culled), 64):
                rows = np.full(64, F, np.int32)
                chunk = culled[lo:lo + 64]
                rows[: len(chunk)] = chunk
                self._db = self.loop_closer._clear_rows(
                    self._db, jnp.asarray(rows)
                )
            self.loop_closer._db = self._db
            # remembered loop edges are NOT dropped: a culled keyframe keeps
            # its pose and stays a valid vertex of the correction graph
        return culled

    def cull_redundant_keyframes(self) -> list[int]:
        """Unflag keyframes whose observed points are redundantly covered by
        other frames — `LocalMapper::FrameCulling` (`src/LocalMapper.h:40`,
        declared, never implemented; `Mapper.localKeyframeCulling` in
        ORBSLAM.png). Culled keyframes leave the loop-closure candidate set
        (their BoW rows are zeroed) and the essential graph, bounding both
        by scene coverage rather than trajectory length. One compiled
        program + one (F,) bool pull — an earlier host version pulled the full
        association arrays and looped in Python on EVERY keyframe. Returns the newly culled ids. (The session's internal
        loop uses the dispatch/apply halves asynchronously; this public
        entry is synchronous.)"""
        self._cull_apply()  # a stale pending pass first, if any
        self._cull_dispatch()
        return self._cull_apply()

    # --- outputs -----------------------------------------------------------
    def _fold_kf_upto(self, n: int) -> None:
        """Fold keyframe flags from stats[:n] into the keyframe list (each
        frame's flag is read at most once over the session's lifetime)."""
        while self._kf_scanned < n:
            s = self.stats[self._kf_scanned]
            if bool(s.is_keyframe):
                self._keyframes.append(s.frame)
            self._kf_scanned += 1

    def _keyframes_known(self) -> list[int]:
        """Keyframes folded so far (may lag the newest `stat_lag` frames —
        the internal, non-syncing view)."""
        return [f for f in self._keyframes if f not in self._kf_culled]

    @property
    def keyframes(self) -> list[int]:
        """Live keyframe indices (excludes FrameCulling victims). Forces
        pending stats to be processed — the exact external view."""
        self._drain(force=True)
        self._fold_kf_upto(len(self.stats))
        return [f for f in self._keyframes if f not in self._kf_culled]

    def flush(self) -> None:
        """Process all pending per-frame outcomes (loop closures,
        relocalizations, culling) now."""
        self._drain(force=True)

    def trajectory(self):
        """(poses (F, 3, 4), valid (F,), timestamps (F,)) as numpy, trimmed
        to ingested frames. Flushes pending loop-closure work first."""
        self._drain(force=True)
        n = self._next
        return (
            np.asarray(self.state.poses[:n]),
            np.asarray(self.state.pose_valid[:n]),
            np.asarray(self.timestamps, dtype=np.float64),
        )

    def map_points(self):
        """(P_used, 3) numpy array of valid map points."""
        self._drain(force=True)
        pts = np.asarray(self.state.points)
        ok = np.asarray(self.state.point_valid)
        return pts[ok]

    @property
    def n_map_points(self) -> int:
        return int(self.state.n_points)


def _kf_cull_device(state, flags, protect, redundancy, min_other_obs):
    from monocular_slam_tpu.slam import keyframes as kf_mod

    return kf_mod.cull_frames_device(
        state, flags, protect,
        redundancy=redundancy, min_other_obs=min_other_obs,
    )
