"""Core differential geometry + multiple-view geometry for SLAM.

Everything here is pure jax.numpy, shape-static, and vmap-friendly. These
modules replace the reference's Eigen/OpenCV math layer
(`src/CommonMath.{h,cpp}`, `src/Converter.{h,cpp}`, g2o `types/se3quat.h`,
`types/sim3.h` — see SURVEY.md §2).
"""

from monocular_slam_tpu.geometry import so3, se3, sim3, camera  # noqa: F401
