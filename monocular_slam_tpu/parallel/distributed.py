"""Multi-host (multi-process) initialization and mesh construction.

The reference is a single process with zero distribution (SURVEY.md §5.8);
the north-star capability is distributed global BA with >=70% scaling
efficiency from 1 host to >=2 hosts. This module is the process-level entry:

  initialize()   -> jax.distributed.initialize from explicit args or env
                    (MSLAM_COORDINATOR / MSLAM_NUM_PROCESSES / MSLAM_PROCESS_ID,
                    falling back to JAX's own cluster auto-detection).
  global_mesh()  -> a Mesh over ALL global devices with hosts laid out along
                    the OUTER axis dimension, so a "model"-axis shard stays
                    host-local whenever shards divide evenly into hosts —
                    landmark slabs then ride ICI within a host and only the
                    psum of (F,6)/(F*6)^2 pose blocks crosses DCN.
  replicated() / model_sharded() -> NamedShardings for placing host-local
                    copies of problem arrays onto the global mesh.

On one process everything degrades to the single-host `parallel/mesh.py`
behavior. Multi-process CPU (the test harness: 2 processes x 4 virtual CPU
devices) uses the same code path as a multi-host cluster — see
`benchmarks/multihost.py` and `tests/test_multihost.py`.
"""

from __future__ import annotations

import os

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

_INITIALIZED = False


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialize jax.distributed for multi-process runs (idempotent).

    Resolution order: explicit args -> MSLAM_* env vars -> JAX cluster
    auto-detection (cluster metadata). Returns True if a multi-process
    runtime was initialized, False for single-process operation.
    """
    global _INITIALIZED
    if _INITIALIZED:
        return jax.process_count() > 1

    coordinator_address = coordinator_address or os.environ.get("MSLAM_COORDINATOR")
    if num_processes is None and "MSLAM_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["MSLAM_NUM_PROCESSES"])
    if process_id is None and "MSLAM_PROCESS_ID" in os.environ:
        process_id = int(os.environ["MSLAM_PROCESS_ID"])

    if num_processes is not None and num_processes <= 1:
        return False
    if coordinator_address is None and num_processes is None:
        # No explicit config: let JAX try cluster auto-detection only when it
        # is clearly running under a managed multi-host environment.
        return False

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    _INITIALIZED = True
    return jax.process_count() > 1


def global_mesh(data: int = 1) -> Mesh:
    """(data, model) mesh over ALL global devices, host-major order.

    Host-major (process-grouped) device order keeps each model-axis slab on
    one host when n_shards % n_hosts == 0: the all-to-nothing landmark data
    never crosses DCN, only the Schur psum does.
    """
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    n = len(devs)
    assert n % data == 0, (n, data)
    arr = np.array(devs).reshape(data, n // data)
    return Mesh(arr, axis_names=("data", "model"))


def model_sharded(mesh: Mesh) -> NamedSharding:
    """Sharding for landmark-slab arrays: leading axis over "model"."""
    return NamedSharding(mesh, P(None, "model") if "data" in mesh.shape and mesh.shape["data"] > 1 else P("model"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def put_global(x, sharding: NamedSharding):
    """Place a host-local full copy of `x` as a global array with `sharding`.

    Every process must hold the SAME full array (deterministic construction —
    the pattern of our benchmarks/tests). Each process donates only the
    shards it is responsible for."""
    import jax.numpy as jnp

    x = jnp.asarray(x)
    if jax.process_count() == 1:
        return jax.device_put(x, sharding)
    return jax.make_array_from_callback(x.shape, sharding, lambda idx: x[idx])
