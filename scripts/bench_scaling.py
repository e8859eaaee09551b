#!/usr/bin/env python
"""Sharded-EDT scaling harness (BASELINE config #5 machinery).

Measures the sharded pipeline on a virtual CPU device mesh: it validates
that the collectives compile + execute at N devices and reports the
communication volume analytically (the boundary-summary design makes EDT
communication O(surface): 2 x all_gather of [P, ny, nz] int32 line
summaries per field, independent of iteration count — at 1024^3 over 8
shards that is 8 x 2 x 1024^2 x 4 B = 64 MB vs the 8 GB volume, 0.8%).

Usage: env JAX_PLATFORMS=cpu \
         XLA_FLAGS=--xla_force_host_platform_device_count=8 \
         python scripts/bench_scaling.py [n]
"""
import json
import os as _os
import sys as _sys
import time

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from sdf_tools_tpu.parallel import sharded


def main():
    n = int(_sys.argv[1]) if len(_sys.argv) > 1 else 128
    n_dev = len(jax.devices())
    rng = np.random.default_rng(0)
    mask = rng.random((n, n, n)) < 0.08
    mask[0, 0, 0] = True

    results = {}
    for p in [1, 2, 4, n_dev]:
        if n % p != 0 or p > n_dev:
            continue
        mesh = sharded.make_mesh({"x": p}, devices=jax.devices()[:p])
        f = jax.jit(
            jax.shard_map(
                lambda m: sharded.sharded_signed_field(m, 0.05, "x", backend="stencil"),
                mesh=mesh,
                in_specs=P("x"),
                out_specs=P("x"),
            )
        )
        m = jax.device_put(jnp.asarray(mask))
        out = f(m)
        out.block_until_ready()
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = f(m)
            out.block_until_ready()
            ts.append(time.perf_counter() - t0)
        results[p] = float(np.median(ts))

    base = results.get(1)
    report = {
        "grid": f"{n}^3",
        "devices": {
            str(p): {
                "seconds": round(t, 3),
                "speedup": round(base / t, 2) if base else None,
                "efficiency": round(base / t / p, 2) if base else None,
            }
            for p, t in results.items()
        },
        "comm_model_bytes_per_field": 2 * n * n * 4 * len(results),
        "note": "virtual CPU mesh (no real multi-chip available); communication is O(surface) by design",
    }
    print(json.dumps(report))


if __name__ == "__main__":
    main()
