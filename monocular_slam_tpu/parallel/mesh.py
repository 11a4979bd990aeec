"""Device mesh construction for distributed SLAM.

The reference has no distributed backend at all (SURVEY.md 2.5 — its only
parallelism is an optional OpenMP region in g2o's Schur loop). Here the
communication layer is a `jax.sharding.Mesh` with two logical axes:

  - "data":  embarrassing parallelism — RANSAC hypothesis batches, per-frame
             feature extraction, edge linearization.
  - "model": landmark-block sharding for bundle adjustment — each device owns
             a contiguous slab of map points and all BA edges that observe
             them; the Schur reduction is a psum over this axis.

The cards of one host are joined all to all (NVLink), so the mesh follows
the algorithm alone; across hosts jax.distributed +
standard device enumeration applies (multi-host initialization is the
caller's responsibility via `jax.distributed.initialize`).
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh


def make_mesh(n_devices: int | None = None, data: int | None = None) -> Mesh:
    """Build a (data, model) mesh over the first n_devices devices.

    `data` defaults to 1 (all devices on the model/landmark axis) — global BA
    is the capacity-limited workload. Pass data>1 to trade devices toward
    hypothesis-parallel front-end work.
    """
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    devs = devs[:n_devices]
    if data is None:
        data = 1
    assert n_devices % data == 0, (n_devices, data)
    model = n_devices // data
    arr = np.array(devs).reshape(data, model)
    return Mesh(arr, axis_names=("data", "model"))
