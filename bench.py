"""Benchmark: two-field exact EDT at 512^3 on one GPU.

Prints the device lines, then ONE JSON line: {"metric", "value", "unit",
"vs_baseline", ...extras}. Fails without a GPU.

The metric is end-to-end signed-field throughput (both EDT fields + combine)
in voxels/s on the BASELINE scene class (random spheres, ~8% fill).

vs_baseline: the reference (UM-ARM-Lab/sdf_tools) publishes no numbers and
its ROS/catkin stack cannot be built here, so the baseline is
scipy.ndimage.distance_transform_edt — a C implementation of the same exact
separable-EDT algorithm class, run twice (two fields) single-threaded on
this machine's CPU, which is strictly FASTER than the reference's Python
binding path (utils_3d.py per-voxel SetValue loop + bucket-queue).
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def make_scene(n: int, seed: int = 0) -> np.ndarray:
    """Random-sphere occupancy (40 spheres, radii 3-12% of n) of shape n^3.

    Each sphere is rasterized inside its own bounding box only (cells outside
    the box are outside the sphere), so 512^3 builds in about a second.
    """
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, n, (40, 3))
    r = rng.uniform(n * 0.03, n * 0.12, 40)
    mask = np.zeros((n, n, n), bool)
    for k in range(40):
        lo = np.maximum(np.floor(c[k] - r[k]).astype(int), 0)
        hi = np.minimum(np.ceil(c[k] + r[k]).astype(int) + 1, n)
        x2 = (np.arange(lo[0], hi[0]) - c[k, 0]) ** 2
        y2 = (np.arange(lo[1], hi[1]) - c[k, 1]) ** 2
        z2 = (np.arange(lo[2], hi[2]) - c[k, 2]) ** 2
        mask[lo[0] : hi[0], lo[1] : hi[1], lo[2] : hi[2]] |= (
            x2[:, None, None] + y2[None, :, None] + z2[None, None, :]
        ) <= r[k] ** 2
    return mask


def _spread(times):
    """{median, min, max} of a timing list (seconds)."""
    return {
        "median": float(np.median(times)),
        "min": float(np.min(times)),
        "max": float(np.max(times)),
    }


def _time(f, *args, repeats: int):
    """Warm once, then time ``repeats`` calls, each ending in
    block_until_ready on the full result."""
    import jax

    jax.block_until_ready(f(*args))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        times.append(time.perf_counter() - t0)
    return _spread(times)


def bench_edt(mask: np.ndarray, repeats: int = 5) -> dict:
    import jax
    import jax.numpy as jnp

    from sdf_tools_tpu.ops import edt

    backend = edt.resolve_backend("auto")
    f = jax.jit(lambda mm: edt.signed_field_from_masks(mm, 0.05, backend=backend))
    return _time(f, jnp.asarray(mask), repeats=repeats)


def bench_cpu_baseline(mask: np.ndarray) -> float:
    from scipy import ndimage

    t0 = time.perf_counter()
    d_free = ndimage.distance_transform_edt(~mask)  # distance to filled
    d_fill = ndimage.distance_transform_edt(mask)  # distance to free
    _ = (d_free - d_fill).astype(np.float32)
    return time.perf_counter() - t0


def _render_setup(mask: np.ndarray):
    import jax.numpy as jnp

    from sdf_tools_tpu.grid import GridMeta, make_origin_transform
    from sdf_tools_tpu.ops import edt, render

    n = mask.shape[0]
    res = 0.05
    meta = GridMeta.create(make_origin_transform([0.0, 0.0, 0.0]), res, mask.shape)
    sdf, _ = edt.extract_signed_distance_field(jnp.asarray(mask), meta, oob_value=1e3)
    center = np.full(3, 0.5 * n * res)
    cam = center + np.array([-1.2 * n * res, 0.0, 0.4 * n * res])
    h = w = 1024
    origins, dirs = render.camera_rays(
        jnp.asarray(cam, jnp.float32), jnp.asarray(center, jnp.float32),
        jnp.asarray([0.0, 0.0, 1.0]), 50.0, h, w,
    )
    return sdf, origins, dirs, 4.0 * n * res, h * w


def bench_render(mask: np.ndarray, repeats: int = 5):
    """Sphere-trace rays/s over the 512^3 SDF (BASELINE config #4)."""
    import jax

    from sdf_tools_tpu.ops import render

    sdf, origins, dirs, t_max, rays = _render_setup(mask)
    # rays passed as ARGS: closing over device arrays constant-folds them
    # into the compile
    f = jax.jit(
        lambda s, o, d: render.render_depth(s, o, d, t_max=t_max, max_steps=64).depth
    )
    return _time(f, sdf, origins, dirs, repeats=repeats), rays


def bench_render_bwd(mask: np.ndarray, repeats: int = 3):
    """value_and_grad of a depth loss through sphere_trace_depth's IFT
    custom_vjp, gradients w.r.t. the SDF values (BASELINE config #4 'with
    pixel gradients')."""
    import jax
    import jax.numpy as jnp

    from sdf_tools_tpu.grid import SdfGrid
    from sdf_tools_tpu.ops import render

    sdf, origins, dirs, t_max, rays = _render_setup(mask)

    def loss(values, o, d):
        s = SdfGrid(values=values, meta=sdf.meta, oob_value=sdf.oob_value)
        r = render.render_depth(s, o, d, t_max=t_max, max_steps=64)
        return jnp.sum(r.depth**2)

    f = jax.jit(jax.value_and_grad(loss))
    return _time(f, sdf.values, origins, dirs, repeats=repeats), rays


def bench_edt_bwd(mask: np.ndarray, repeats: int = 3):
    """Gradient of a field loss w.r.t. soft occupancy through the
    feature-transform surrogate (ops/diff.sdf_from_occupancy_ft)."""
    import jax
    import jax.numpy as jnp

    from sdf_tools_tpu.ops import diff

    occ = jnp.asarray(mask, jnp.float32) * 0.9 + 0.05

    def loss(o):
        return jnp.sum(diff.sdf_from_occupancy_ft(o, 0.05, "auto") ** 2)

    return _time(jax.jit(jax.grad(loss)), occ, repeats=repeats)


def main():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from sdf_tools_tpu import devices

    cache = devices.setup_compile_cache()
    import jax

    devices.require_gpu(jax.devices())
    device = devices.device_info()
    print(f"device: {json.dumps(device)}")
    print(f"card: {devices.card_name_and_power_limit()}")
    print(f"compile cache: {cache}", flush=True)

    n = int(os.environ.get("SDFT_BENCH_N", "512"))
    mask = make_scene(n)
    edt_t = bench_edt(mask)
    render_t, rays = bench_render(mask)
    render_bwd_t, _ = bench_render_bwd(mask)
    edt_bwd_t = bench_edt_bwd(mask)

    # CPU baseline at 256^3 extrapolated to n^3 (same per-voxel cost for
    # this algorithm class) to keep bench wall time bounded.
    nb = 256
    t_cpu = bench_cpu_baseline(make_scene(nb)) * (n**3 / nb**3)
    t_edt = edt_t["median"]

    def rel_spread(sp):
        return round((sp["max"] - sp["min"]) / sp["median"], 4)

    print(json.dumps({
        "metric": f"edt_{n}_voxels_per_s",
        "value": round(n**3 / t_edt, 1),
        "unit": "voxel/s",
        "vs_baseline": round(t_cpu / t_edt, 2),
        "device": device,
        "edt_seconds": round(t_edt, 5),
        "edt_seconds_minmax": [round(edt_t["min"], 5), round(edt_t["max"], 5)],
        "render_rays_per_s": round(rays / render_t["median"], 1),
        "render_seconds_1Mray": round(render_t["median"], 5),
        "render_seconds_minmax": [round(render_t["min"], 5), round(render_t["max"], 5)],
        "render_bwd_rays_per_s": round(rays / render_bwd_t["median"], 1),
        "render_bwd_seconds_1Mray": round(render_bwd_t["median"], 5),
        "edt_bwd_voxels_per_s": round(n**3 / edt_bwd_t["median"], 1),
        "edt_bwd_seconds": round(edt_bwd_t["median"], 5),
        "cpu_baseline_seconds_extrapolated": round(t_cpu, 2),
        "edt_rel_spread_inproc": rel_spread(edt_t),
        "render_rel_spread_inproc": rel_spread(render_t),
        "scene": f"{n}^3 random spheres, fill={mask.mean():.3f}",
    }))


if __name__ == "__main__":
    main()
