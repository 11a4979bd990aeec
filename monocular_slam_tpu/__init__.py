"""monocular_slam_tpu — a monocular SLAM engine built from scratch in JAX.

Capability surface mirrors the C++ reference ``eastgeneral2007/Monocular_SLAM``
(see SURVEY.md): ORB-style feature extraction + Hamming matching, eight-point +
RANSAC two-view initialization, PnP tracking, DLT triangulation, Levenberg-
Marquardt bundle adjustment (pose-only / windowed local / global, with a
Schur-complement reduction over camera/landmark blocks), bag-of-words loop
closure, Sim3 pose-graph optimization, TUM/KITTI/Middlebury dataset loaders,
trajectory + point-cloud export, and ATE/RPE evaluation.

The design is accelerator-first: fixed-capacity mask-padded state pytrees,
vmapped hypothesis sampling instead of sequential RANSAC loops, matmul-shaped
Hamming distances, `lax.while_loop` trust-region LM, and `shard_map`
distribution of BA edge sets over a `jax.sharding.Mesh`.
"""

__version__ = "0.1.0"

from monocular_slam_tpu import geometry, ops, optim  # noqa: F401
