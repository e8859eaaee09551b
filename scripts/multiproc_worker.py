#!/usr/bin/env python
"""Worker for the multi-process CPU test/dryrun (one process of N).

Usage: JAX_COORDINATOR=localhost:PORT JAX_NUM_PROCESSES=N JAX_PROCESS_ID=i \
       python scripts/multiproc_worker.py <grid_n> <out.npy-for-proc-0>

Each process: initialize the distributed runtime, build a global x-slab
mesh over all processes' CPU devices, feed HOST-LOCAL slabs of a
deterministic scene, run the sharded signed field, and (process 0) save the
gathered result for comparison against the single-process answer.
"""
import os
import sys

os.environ.setdefault("XLA_FLAGS", "")
os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

# must run before ANYTHING initializes the XLA backend (jax.devices etc.)
from sdf_tools_tpu.parallel import runtime  # noqa: E402

_distributed = runtime.initialize()

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from sdf_tools_tpu.parallel import sharded  # noqa: E402


def scene(n):
    rng = np.random.default_rng(7)
    mask = rng.random((n, n, n)) < 0.1
    mask[0, 0, 0] = True
    return mask


def main():
    n = int(sys.argv[1])
    out_path = sys.argv[2]
    assert _distributed, "expected multi-process env"
    n_dev = jax.device_count()
    assert jax.process_count() > 1, "expected >1 processes"
    mesh = runtime.process_mesh({"x": n_dev})

    full = scene(n)  # deterministic; each host slices ITS slabs only

    vol = runtime.host_local_volume(
        mesh, "x", (n, n, n), np.bool_, lambda a, b: full[a:b]
    )

    f = jax.jit(
        jax.shard_map(
            lambda m: sharded.sharded_signed_field(m, 0.1, "x", backend="stencil"),
            mesh=mesh,
            in_specs=P("x"),
            out_specs=P("x"),
        )
    )
    out = f(vol)
    # gather to every host for the comparison dump
    gathered = np.asarray(
        jax.jit(lambda v: v, out_shardings=jax.NamedSharding(mesh, P()))(out)
    )
    if jax.process_index() == 0:
        np.save(out_path, gathered)
        print("proc0 saved", gathered.shape)
    print(f"proc {jax.process_index()} ok ({jax.process_count()} procs, {n_dev} devices)")


def main_train():
    """Multi-process dryrun of the FULL sharded train step (VERDICT item 5:
    dryrun in multi-process mode). Mesh dp x x over all processes' devices;
    inputs fed as global arrays from process-local data."""
    from jax.sharding import NamedSharding

    from sdf_tools_tpu.parallel import train

    n_dev = jax.device_count()
    dp = 2
    xs = n_dev // dp
    mesh = runtime.process_mesh({"dp": dp, "x": xs})
    cfg = train.PipelineConfig(grid_n=4 * xs, image_h=8, image_w=8, edt_backend="stencil")
    step = train.make_train_step(mesh, cfg)

    rng = np.random.default_rng(0)
    B, N = dp, 32
    center = np.full(3, 0.5 * cfg.grid_n * cfg.resolution)
    u = rng.normal(size=(B, N, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    pts = (center + u * (0.2 * cfg.grid_n * cfg.resolution)).astype(np.float32)
    tgt = np.full((B, cfg.image_h, cfg.image_w), 1.0, np.float32)

    pts_g = jax.make_array_from_process_local_data(NamedSharding(mesh, P("dp")), pts)
    tgt_g = jax.make_array_from_process_local_data(NamedSharding(mesh, P("dp")), tgt)
    new_pts, loss = step(pts_g, tgt_g)
    jax.block_until_ready((new_pts, loss))
    loss_v = float(np.asarray(jax.jit(lambda x: x, out_shardings=NamedSharding(mesh, P()))(loss)))
    assert np.isfinite(loss_v), loss_v
    print(f"proc {jax.process_index()} train-step ok, loss={loss_v:.4f}")


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "train":
        main_train()
    else:
        main()
