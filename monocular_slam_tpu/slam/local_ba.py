"""Per-frame windowed local bundle adjustment.

The reference's `Optimiser` stage re-runs FULL global BA after every frame
(`src/Optimiser.cpp:6-18`) — O(T^2) over a trajectory (SURVEY.md 5.7). Here
the per-frame refinement is a fixed-size window: the W frames most covisible
with the current frame (including it) are free, the next W are fixed
anchors, and all map points observed by the window are free.

Two-stage layout:

1. **Slab compaction** — the window observes <= 2W*N landmarks but the global
   point capacity P is 10-100x larger; BA arrays sized by P make every
   landmark-side op pay for dead capacity. One P-length cumsum ranks active points into a
   fixed-capacity slab, once per solve.
2. **Scatter-free LM iterations** — the slab problem runs on the structured
   (frame, feature) engine (`optim/window_ba.py`): landmark reductions ride a
   (P_slab, 2W) observation table built with ONE scatter per solve, so the
   10-iteration LM loop contains only gathers, einsums, and one matmul
   for the Schur cross term. The generic edge-list engine (`optim/ba.py`)
   rebuilt a dense (F,6,P,3) Schur operand with two scatter-adds EVERY
   iteration.

Global BA (`optim.ba.global_bundle_adjust`) remains available for loop
closure and final refinement.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from monocular_slam_tpu.optim import window_ba
from monocular_slam_tpu.slam import state as state_mod
from monocular_slam_tpu.slam.config import SlamConfig
from monocular_slam_tpu.slam.state import SlamState


class LocalBAResult(NamedTuple):
    state: SlamState
    chi2_initial: jnp.ndarray
    chi2_final: jnp.ndarray


def _covisibility_row(state: SlamState, i) -> jnp.ndarray:
    """(F,) shared-valid-map-point counts between frame i and every frame.

    Cheaper than `mapping.covisibility_row` for one row: one N-sized scatter
    into a (P,) seen-mask + one (F, N) gather — no (F, P) incidence build.
    """
    P = state.points.shape[0]
    F = state.poses.shape[0]
    si = state_mod.slot_index(state, i)
    fp_i = state.feat_point[si]
    ok_i = (fp_i >= 0) & state.kp_valid[si]
    seen = jnp.zeros(P, bool).at[jnp.where(ok_i, fp_i, P)].set(True, mode="drop")
    fp = state.feat_point  # (S, N)
    resident = state.frame_of >= 0
    hit = (fp >= 0) & state.kp_valid & seen[jnp.maximum(fp, 0)] & resident[:, None]
    per_slot = jnp.sum(hit.astype(jnp.int32), axis=1)  # (S,)
    # scatter slot counts to their frames (evicted frames count 0)
    return (
        jnp.zeros(F + 1, jnp.int32)
        .at[jnp.where(resident, state.frame_of, F)]
        .add(per_slot.astype(jnp.int32), mode="drop")[:F]
    )


def _select_window(state: SlamState, i, cfg: SlamConfig):
    """Pick the 2W-slot active window around frame i.

    Covisibility mode (default): rank past frames by shared-map-point count
    with frame i (the SURVEY.md §5.7 active-set selector); the W most
    covisible (always including i) are FREE, the next W are fixed anchors.
    After a loop closure, time-adjacent != covisible, so this keeps the
    window meaningful. Time mode: the reference-shaped sliding window —
    frames (i-2W, i] with the older half fixed.

    Returns (g_safe (2W,), valid_frame (2W,), fixed (2W,)).
    """
    W = cfg.ba.window
    F2 = 2 * W
    slot = jnp.arange(F2, dtype=jnp.int32)

    if cfg.ba.use_covisibility:
        F = state.poses.shape[0]
        row = _covisibility_row(state, i)  # (F,)
        past = (
            (jnp.arange(F, dtype=jnp.int32) < i)
            & state.pose_valid
            & (state.slot_of >= 0)
        )
        # frame i leads; ties between equally-covisible frames break toward
        # recency so pure odometry degenerates to the sliding window.
        score = jnp.where(past, row.astype(jnp.float32), -1.0)
        score = score + jnp.arange(F, dtype=jnp.float32) / F
        score = score.at[jnp.maximum(i, 0)].set(jnp.float32(3e38))
        vals, g_idx = jax.lax.top_k(score, F2)
        g_safe = g_idx.astype(jnp.int32)
        valid_frame = (vals > 0.0) & state.pose_valid[g_safe]
        free = (slot < W) & valid_frame
    else:
        base = i - (F2 - 1)
        g_idx = base + slot  # oldest..newest
        g_ok = g_idx >= 0
        g_safe = jnp.maximum(g_idx, 0)
        valid_frame = g_ok & state.pose_valid[g_safe] & (state.slot_of[g_safe] >= 0)
        free = (slot >= W) & valid_frame

    # Frame 0 is the gauge anchor whenever it lands in the window — the
    # reference pins it in every BA (`src/Util.cpp:69-77`).
    fixed = ~free | (g_safe == 0)
    return g_safe, valid_frame, fixed


def local_bundle_adjust(
    state: SlamState, i, cfg: SlamConfig
) -> LocalBAResult:
    """Adjust poses of the W frames most covisible with frame i (including i)
    and their map points; the next-W covisible frames are fixed anchors.
    `i` is a traced int."""
    N = state.feat_point.shape[1]
    F2 = 2 * cfg.ba.window

    g_safe, valid_frame, fixed = _select_window(state, i, cfg)
    sg = state_mod.slot_index(state, g_safe)  # (2W,) window frames' slots

    pt_slot = state.feat_point[sg]  # (2W, N), -1 for none
    valid = (
        (pt_slot >= 0)
        & state.kp_valid[sg]
        & valid_frame[:, None]
        & state.point_valid[jnp.maximum(pt_slot, 0)]
    )

    # --- compact the active points into a small slab -----------------------
    # Slab capacity: worst case is F2*N distinct points, but windows
    # re-observe the same landmarks heavily; overflow edges are dropped for
    # this call (those points simply skip one refinement).
    P = state.points.shape[0]
    P_BA = min(P, F2 * N, cfg.ba.local_max_points)
    pt_safe = jnp.maximum(pt_slot, 0)
    active = (
        jnp.zeros(P, bool)
        .at[jnp.where(valid, pt_slot, P)]
        .set(True, mode="drop")
    )
    rank = jnp.cumsum(active.astype(jnp.int32)) - 1  # (P,) slab slot
    n_active = jnp.sum(active.astype(jnp.int32))
    overflow = rank >= P_BA
    slab_of = jnp.where(active & ~overflow, rank, P_BA)  # P_BA = dump slot
    # inverse map: slab slot -> global point id (for write-back)
    inv = jnp.full(P_BA + 1, 0, jnp.int32).at[slab_of].set(
        jnp.arange(P, dtype=jnp.int32), mode="drop"
    )
    points_slab = state.points[inv[:P_BA]]
    pt_local = slab_of[pt_safe]  # (2W, N) slab slot (P_BA if overflow)
    valid = valid & (pt_local < P_BA)
    pt_local = jnp.minimum(pt_local, P_BA - 1)

    prob = window_ba.build(
        poses=state.poses[g_safe],
        points=points_slab,
        k=state.k[g_safe],
        pt_slot=pt_local,
        uv=state.kp_uv[sg],
        info=(1.0 / state.kp_scale[sg]).astype(state.kp_uv.dtype),
        valid=valid,
        fixed=fixed,
    )
    res = window_ba.bundle_adjust(
        prob, n_iters=cfg.ba.local_iters, delta=cfg.ba.huber_full
    )

    # Write back free-frame poses and the slab points. Early in the run
    # g_safe contains clamped duplicates of frame 0; route non-free slots out
    # of bounds (drop) so duplicate writes can't clobber a real update.
    free = ~fixed
    F = state.poses.shape[0]
    write_idx = jnp.where(free, g_safe, jnp.int32(F))
    poses = state.poses.at[write_idx].set(res.poses, mode="drop")
    slab_used = jnp.arange(P_BA) < n_active
    pts_write_idx = jnp.where(slab_used, inv[:P_BA], jnp.int32(P))
    points = state.points.at[pts_write_idx].set(res.points, mode="drop")
    new_state = state._replace(poses=poses, points=points)
    return LocalBAResult(new_state, res.chi2_initial, res.chi2_history[-1])
