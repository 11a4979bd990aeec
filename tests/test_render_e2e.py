"""End-to-end image pipeline on a rendered TUM-format dataset: disk loader ->
ORB extraction -> two-view init -> PnP tracking -> local BA -> ATE.

This is the flagship-metric path (`BASELINE.json.metric`): the same route the
reference drives in `main.cpp:48-51` (FrameLoader -> FeatureExtractor ->
CameraPoseEstimator), measured by trajectory ATE against the exported
groundtruth.txt rather than by eyeball (`UnitTest/compareORBSLAM`).
"""

import json

import numpy as np
import pytest

import jax

from monocular_slam_tpu.datasets import render, tum
from monocular_slam_tpu.eval import ate as ate_mod
from monocular_slam_tpu.slam.config import FrontendConfig, SlamConfig
from monocular_slam_tpu.slam.session import SlamSession


@pytest.fixture(scope="module")
def tum_synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("data") / "tum_synth_e2e"
    render.export_tum(str(root), key=jax.random.PRNGKey(3), n_frames=12, wh=(320, 240))
    return str(root)


def test_cli_loop_closure(tum_synth, tmp_path, capsys):
    """`run.main --loop-closure` builds its session with the closer attached
    (bundled vocabulary) and tracks the sequence through the CLI."""
    from monocular_slam_tpu import run

    rc = run.main([
        "--dataset", tum_synth, "--out", str(tmp_path / "out"),
        "--features", "600", "--max-frames", "16", "--max-points", "4000",
        "--start", "0", "--end", "12", "--step", "1", "--loop-closure",
    ])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["frames"] == 12
    # the bar of test_image_pipeline_ate, which runs the same sequence
    assert summary["tracked"] >= 10
    assert summary["ate_rmse"] < 0.04
    assert summary["loop_closures"] == []  # a short arc has no revisit


def test_image_pipeline_ate(tum_synth):
    seq = tum.load(tum_synth)
    assert len(seq.frames) == 12
    assert seq.frames[0].pose_gt is not None
    # calib.txt intrinsics (scaled for 320x240), not the sniffed 640x480 ones
    assert seq.k[2] < 320

    cfg = SlamConfig(
        max_frames=16,
        max_points=4000,
        image_wh=(320, 240),
        frontend=FrontendConfig(n_features=600),
    )
    sess = SlamSession(cfg, seed=0, run_ba=True)
    for i in range(len(seq.frames)):
        sess.add_frame(seq.load_image(i), seq.k, seq.frames[i].timestamp)

    poses, valid, _ = sess.trajectory()
    gt = np.stack([f.pose_gt for f in seq.frames])
    assert valid.sum() >= 10, f"tracked only {valid.sum()}/12"
    r = ate_mod.ate(poses[valid], gt[: len(valid)][valid])
    # rendered scene, real integer-pixel ORB extractor at 320x240: a few cm
    # of drift over the 12-frame orbit is the expected regime
    assert r.rmse < 0.04, f"ATE {r.rmse:.4f} m"


def test_map_stays_bounded(tum_synth):
    """Local-mapping hygiene fires: culling keeps map growth bounded and the
    session flags keyframes (the LocalMapper duties, src/LocalMapper.h:30-42)."""
    seq = tum.load(tum_synth)
    cfg = SlamConfig(
        max_frames=16,
        max_points=4000,
        image_wh=(320, 240),
        frontend=FrontendConfig(n_features=400),
    )
    sess = SlamSession(cfg, seed=0, run_ba=True)
    stats = [
        sess.add_frame(seq.load_image(i), seq.k, seq.frames[i].timestamp)
        for i in range(len(seq.frames))
    ]
    assert any(s.is_keyframe for s in stats)
    assert any(s.n_culled > 0 or s.n_fused > 0 for s in stats)
    assert sess.n_map_points < 4000


def test_image_pipeline_loop_closure(tmp_path_factory):
    """Full image-path loop closure: rendered orbit that revisits its start
    -> PNG -> ORB -> tracking -> BoW detection -> Sim3 -> keyframe pose
    graph -> global BA. The reference stubbed every stage past detection
    (`src/LoopCloser.cpp:147-155`)."""
    from monocular_slam_tpu.retrieval import vocabulary as vocab_mod
    from monocular_slam_tpu.slam.loop_closer import LoopCloser, LoopClosureConfig

    root = str(tmp_path_factory.mktemp("data") / "tum_loop")
    n = 100  # ang_step 0.07 rad -> full revisit at ~90 frames
    render.export_tum(
        root, key=jax.random.PRNGKey(7), n_frames=n, wh=(320, 240), ang_step=0.07
    )
    seq = tum.load(root)
    cfg = SlamConfig(
        max_frames=112,
        max_points=8000,
        image_wh=(320, 240),
        # continuous steering: at 4 deg/frame rotation the binned-LUT
        # descriptors cross a bin edge for most keypoints every frame and
        # tracking collapses at the orbit's midpoint (27/100 binned vs
        # 100/100 continuous) — this is the documented robustness mode for
        # aggressive-motion regimes (FrontendConfig.steer_mode)
        frontend=FrontendConfig(n_features=600, steer_mode="continuous"),
    )
    # vocabulary trained offline on the sequence's own descriptors. Size
    # matters: a 512-word (k=8, L=3) vocab has a ~0.47 BoW similarity floor
    # and the true revisit pops out by only ~0.03-0.07 — below the margin
    # gate, so the closure never fires before the revisit collides with the
    # drifted map. 4096 words (k=8, L=4) drop the floor to ~0.13 and the
    # revisit margins to 0.12-0.19 (the DBoW2 k^L scaling story,
    # `TemplatedVocabulary.h:55-57` defaults to 10^5 words).
    sess0 = SlamSession(cfg, seed=0, run_ba=False)
    descs = []
    for i in range(0, n, 2):
        f = sess0._extract(jax.numpy.asarray(seq.load_image(i), jax.numpy.float32))
        descs.append(np.asarray(f.desc_pm1)[np.asarray(f.valid)])
    voc = vocab_mod.train(np.concatenate(descs), k=8, L=4, seed=0)

    lc = LoopCloser(
        voc=voc, cfg=cfg,
        lc=LoopClosureConfig(min_gap=40, min_score=0.05, consistency=2),
    )
    sess = SlamSession(cfg, seed=0, run_ba=True, loop_closer=lc)
    for i in range(n):
        sess.add_frame(seq.load_image(i), seq.k, seq.frames[i].timestamp)

    poses, valid, _ = sess.trajectory()
    assert valid.sum() >= n - 6, f"tracked only {valid.sum()}/{n}"
    assert len(lc.closures) >= 1, "no loop closure fired on the revisit"
    i, j = lc.closures[0]
    assert i - j >= 40
    gt = np.stack([f.pose_gt for f in seq.frames])
    r = ate_mod.ate(poses[valid], gt[: len(valid)][valid])
    # 100 frames at 4 deg/frame, quarter-resolution images: ~6 cm of drift
    # over the 5.6 m orbit is this regime's noise floor
    assert r.rmse < 0.10, f"ATE {r.rmse:.4f} m"
