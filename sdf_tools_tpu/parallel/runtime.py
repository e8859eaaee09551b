"""Multi-host runtime plumbing: process initialization + host-local feeding.

The reference is single-process (SURVEY.md §2); this is the invented
multi-host half of the scaling layer (SURVEY §2 required-components table,
last row): ``jax.distributed.initialize`` entry point, process-count-aware
mesh construction, and host-local slab feeding so each host only ever
materializes its own part of a volume (BASELINE config #5: 1024^3 over N>=2
hosts).

Launch recipe (one command per host/process):

    JAX_COORDINATOR=host0:8476 JAX_NUM_PROCESSES=4 JAX_PROCESS_ID=<i> \
        python my_script.py

    # my_script.py
    from sdf_tools_tpu.parallel import runtime
    runtime.initialize()                       # no-op when single-process
    mesh = runtime.process_mesh({"x": jax.device_count()})
    vol = runtime.host_local_volume(mesh, "x", (1024, 1024, 1024),
                                    jnp.bool_, my_slab_loader)
    ...

Nothing sets the coordinator/process env vars for you: set the three env
vars (or pass them explicitly). ``JAX_COORDINATOR`` may be
``localhost:<port>`` for several processes on one machine.
"""
from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

_initialized = False


def is_multiprocess_env() -> bool:
    """True when the environment requests multi-process JAX."""
    return os.environ.get("JAX_NUM_PROCESSES") not in (None, "", "1")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize the JAX distributed runtime if (and only if) needed.

    Reads JAX_COORDINATOR / JAX_NUM_PROCESSES / JAX_PROCESS_ID when args are
    not given. Returns True if the distributed runtime was initialized,
    False for the untouched single-process path. Safe to call twice.
    """
    global _initialized
    if _initialized:
        return True
    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "0") or 0) or None
    if process_id is None:
        pid = os.environ.get("JAX_PROCESS_ID")
        process_id = int(pid) if pid is not None else None
    if not coordinator_address and num_processes in (None, 1):
        return False  # single process: leave JAX untouched
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    _initialized = True
    return True


def process_mesh(axis_sizes: dict, devices=None) -> Mesh:
    """Build a mesh over ALL processes' devices ({axis: size}; row-major).

    With k processes and d local devices each, the global device list has
    k*d entries ordered by process — an x-slab mesh therefore assigns
    contiguous volume slabs to each host, which keeps the ppermute halos of
    neighboring slabs on-host or between adjacent hosts (DCN-friendly).
    """
    if devices is None:
        devices = jax.devices()
    names = tuple(axis_sizes.keys())
    sizes = tuple(int(s) for s in axis_sizes.values())
    total = int(np.prod(sizes))
    if total != len(devices):
        raise ValueError(
            f"mesh wants {total} devices, runtime has {len(devices)} "
            f"({jax.process_count()} processes x {jax.local_device_count()} local)"
        )
    return Mesh(np.asarray(devices).reshape(sizes), names)


def host_local_volume(
    mesh: Mesh,
    axis: str,
    global_shape: Tuple[int, ...],
    dtype,
    slab_loader: Callable[[int, int], np.ndarray],
) -> jax.Array:
    """Assemble a globally x-sharded volume from HOST-LOCAL data.

    ``slab_loader(start, stop)`` is called once per LOCAL device with the
    global x-range owned by that device and must return the [stop-start,
    ...] numpy slab — each host only ever materializes its own slabs (the
    1024^3 bool mask is 1 GB; a 4-host job holds 256 MB per host).
    """
    sharding = NamedSharding(mesh, P(axis))
    nx = global_shape[0]
    n_shards = mesh.shape[axis]
    if nx % n_shards != 0:
        raise ValueError(f"axis 0 extent {nx} not divisible by mesh {axis}={n_shards}")
    sl = nx // n_shards
    axis_pos = list(mesh.axis_names).index(axis)
    arrays = []
    for d in jax.local_devices():
        # device's coordinate along the sharded mesh axis (other axes
        # replicate, so dp-duplicated devices load the same slab)
        coords = np.argwhere(mesh.devices == d)[0]
        idx = int(coords[axis_pos])
        start = idx * sl
        slab = np.asarray(slab_loader(start, start + sl), dtype=dtype)
        if slab.shape[0] != sl or slab.shape != (sl,) + tuple(global_shape[1:]):
            raise ValueError(f"slab_loader returned {slab.shape}, want {(sl,) + tuple(global_shape[1:])}")
        arrays.append(jax.device_put(slab, d))
    return jax.make_array_from_single_device_arrays(global_shape, sharding, arrays)


def replicated(mesh: Mesh, value) -> jax.Array:
    """Place a host-consistent value fully replicated over the mesh."""
    return jax.device_put(value, NamedSharding(mesh, P()))
