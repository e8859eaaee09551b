"""Smoke run of the SDF engine's main path on one GPU (or four, behind an option).

    python chip_smoke.py              # one card: every phase below
    python chip_smoke.py --multi-gpu  # four cards: the sharded path only

Phases (one card), each raising on failure:
  1. device    : JAX's first device is a GPU; card name and power limit.
  2. edt       : 512^3 random-sphere scene through SdfEngine.sdf_from_occupancy;
                 both d^2 fields bit-exact against the C++ exact oracle, signed
                 f32 values within 2 ulp of the f64 combine, the Pallas kernel
                 route bitwise equal to the XLA stencil, both timed.
  3. queries   : seeded pointcloud -> 256^3 voxelize -> SDF -> query_with_grad
                 on 10^6 points; a 10^4 subsample against the scalar oracle.
  4. render    : 1024^2 depth over the 512^3 field and value_and_grad of a
                 depth loss; a 16K-ray subsample against the CPU.
  5. ft        : differentiable EDT (feature-transform surrogate) forward and
                 backward at 512^3.
  6. memory    : peak device memory and the EDT step's memory analysis.
  7. gpu tests : the tests marked ``gpu`` (pytest, in this process).

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

RES = 0.05  # metres per cell of the scenes
N_EDT = 512  # signed field, render and FT scene edge
N_QUERY = 256  # pointcloud scene edge for the query phase
N_QUERIES = 1_000_000
N_QUERY_CHECK = 10_000
IMAGE = 1024


def log(*args):
    print(*args, flush=True)


def timed(fn, *args, reps: int = 5):
    """(result, median seconds) of warmed calls, each ending in
    block_until_ready on the full result."""
    import jax

    out = jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return out, float(np.median(times))


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def phase_device():
    import jax

    from sdf_tools_tpu import devices

    devs = devices.require_gpu(jax.devices())
    info = devices.device_info(devs)
    log(f"[device] kind={info['kind']} count={info['count']}")
    log(f"[device] card: {devices.card_name_and_power_limit()}")
    return info


class _Oracle(threading.Thread):
    """The C++ exact EDT of both fields, computed on the host while the GPU
    works (ctypes releases the GIL)."""

    def __init__(self, mask):
        super().__init__(daemon=True)
        self.mask = mask
        self.result = None
        self.error = None

    def run(self):
        try:
            from sdf_tools_tpu import native

            self.result = (native.edt_exact(self.mask), native.edt_exact(~self.mask))
        except BaseException as e:  # re-raised in the main thread
            self.error = e

    def get(self):
        self.join()
        if self.error is not None:
            raise self.error
        return self.result


def phase_edt(mask_np):
    import jax
    import jax.numpy as jnp

    from sdf_tools_tpu import native
    from sdf_tools_tpu.engine import SdfEngine
    from sdf_tools_tpu.ops import edt

    n = mask_np.shape[0]
    if not native.available():
        raise RuntimeError("the native exact oracle could not be built (make -C native)")
    oracle = _Oracle(mask_np)
    oracle.start()

    mask = jnp.asarray(mask_np)
    engine = SdfEngine((n,) * 3, RES)
    check(engine.backend == "pallas", f"engine backend is {engine.backend!r}")
    sdf = engine.sdf_from_occupancy(mask)
    values = np.asarray(sdf.values)

    d2 = jax.jit(lambda m: edt.squared_edt_both(m, backend="pallas"))
    d2a, d2b = (np.asarray(a) for a in d2(mask))
    routes = {}
    for backend in ("pallas", "stencil"):
        f = jax.jit(lambda m, b=backend: edt.signed_field_from_masks(m, RES, backend=b))
        out, t = timed(f, mask)
        routes[backend] = (np.asarray(out[0]), t)
        log(f"[edt] {backend}: two-field signed field {n}^3 median of 5 = {t * 1e3:.3f} ms")

    ref_a, ref_b = oracle.get()
    inf = int(edt.INF_D2)
    for name, got, ref in (("filled", d2a, ref_a), ("free", d2b, ref_b)):
        want = np.minimum(ref, inf).astype(np.int32)
        bad = int(np.count_nonzero(got != want))
        check(bad == 0, f"[edt] d2 {name}: {bad} cells differ from the exact oracle")
    log(f"[edt] d2 of both fields bit-exact vs the C++ oracle at {n}^3")

    f64 = (np.sqrt(ref_a.astype(np.float64)) - np.sqrt(ref_b.astype(np.float64))) * RES
    ulp = np.spacing(np.abs(f64).astype(np.float32)).astype(np.float64)
    err = np.abs(values.astype(np.float64) - f64) / ulp
    check(float(err.max()) <= 2.0, f"[edt] signed values {err.max():.2f} ulp from f64")
    log(f"[edt] signed f32 within {err.max():.2f} ulp of the f64 combine (limit 2)")

    kern, stencil = routes["pallas"][0], routes["stencil"][0]
    check(np.array_equal(kern.view(np.uint32), stencil.view(np.uint32)),
          "[edt] kernel route and XLA stencil differ")
    check(np.array_equal(kern.view(np.uint32), values.view(np.uint32)),
          "[edt] SdfEngine field differs from signed_field_from_masks")
    log("[edt] kernel route == XLA stencil == SdfEngine, bitwise")
    t_k, t_s = routes["pallas"][1], routes["stencil"][1]
    log(f"[edt] kernel {t_k * 1e3:.3f} ms vs stencil {t_s * 1e3:.3f} ms ({t_s / t_k:.1f}x)")
    return values


def phase_queries():
    import jax
    import jax.numpy as jnp

    from sdf_tools_tpu.engine import SdfEngine
    from sdf_tools_tpu.oracle.reference_query import OracleSdf

    n, res = N_QUERY, RES
    extent = n * res
    rng = np.random.default_rng(1)
    # pointcloud: 2e5 points on the surfaces of 12 random spheres
    centers = rng.uniform(0.2 * extent, 0.8 * extent, (12, 3))
    radii = rng.uniform(0.03 * extent, 0.12 * extent, 12)
    u = rng.normal(size=(200_000, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    k = rng.integers(0, 12, 200_000)
    pts = (centers[k] + radii[k, None] * u).astype(np.float32)
    q = rng.uniform(-0.05 * extent, 1.05 * extent, (N_QUERIES, 3)).astype(np.float32)

    engine = SdfEngine((n,) * 3, res)
    sdf = engine.sdf_from_points(pts)
    d, g, ok = engine.query_with_grad(sdf, q)
    _, t = timed(engine.query_with_grad, sdf, q)
    d, g, ok = np.asarray(d), np.asarray(g), np.asarray(ok)
    check(d.shape == (N_QUERIES,) and g.shape == (N_QUERIES, 3), "[queries] shapes")
    check(np.isfinite(d).all() and np.isfinite(g[ok]).all(), "[queries] non-finite")
    log(f"[queries] {N_QUERIES} query_with_grad median of 5 = {t * 1e3:.3f} ms "
        f"({N_QUERIES / t:.4g} queries/s), {ok.mean():.3f} in bounds")

    # scalar oracle on a 1e4 subsample. There is no matrix product on this
    # path: the error is f32 rounding of the point's grid coordinate
    # (|coordinate| <= ~13.5 m, slope <= 1 into the distance) plus a few ulp
    # from the 8-corner interpolation, so allow 32 ulp of (|d| + extent).
    oracle = OracleSdf(np.asarray(sdf.values), res, np.asarray(sdf.meta.origin_transform,
                       np.float64), engine.oob_value)
    sub = rng.choice(q.shape[0], N_QUERY_CHECK, replace=False)
    worst = 0.0
    for i in sub:
        ov, ook = oracle.estimate_distance(q[i].astype(np.float64))
        check(bool(ok[i]) == ook, f"[queries] in-bounds flag differs at point {i}")
        tol = 32 * np.finfo(np.float32).eps * (abs(ov) + extent)
        worst = max(worst, abs(float(d[i]) - ov) / tol)
    check(worst <= 1.0, f"[queries] oracle error {worst:.3f} x tolerance")
    log(f"[queries] {N_QUERY_CHECK} subsample vs scalar oracle: "
        f"worst error {worst:.4f} x tolerance")

    # gradients: the same jitted function on the CPU
    cpu = jax.devices("cpu")[0]
    qs = jnp.asarray(q[sub])
    g_gpu = np.asarray(engine.query_with_grad(sdf, qs)[1])
    vals_cpu = jax.device_put(sdf.values, cpu)
    g_cpu = np.asarray(engine._query_with_grad(vals_cpu, jax.device_put(qs, cpu))[1])
    m = ok[sub]
    rel = np.linalg.norm(g_gpu[m] - g_cpu[m]) / np.linalg.norm(g_cpu[m])
    check(rel <= 1e-5, f"[queries] gradient rel L2 vs CPU {rel:.3g}")
    log(f"[queries] gradient vs CPU: rel L2 {rel:.3g} (limit 1e-5)")


def _render_fns(meta, oob, n):
    import jax
    import jax.numpy as jnp

    from sdf_tools_tpu.grid import SdfGrid
    from sdf_tools_tpu.ops import render

    t_max, eps = 4.0 * n * RES, 1e-3

    def fwd(values, o, d):
        r = render.render_depth(
            SdfGrid(values=values, meta=meta, oob_value=oob), o, d,
            t_max=t_max, eps=eps, max_steps=64,
        )
        return r.depth, r.hit

    def loss(values, o, d, w):
        depth, _ = fwd(values, o, d)
        return jnp.sum(w * depth**2)

    return jax.jit(fwd), jax.jit(jax.value_and_grad(loss)), eps, t_max


def _ground_truth(values, meta, o, d, t_max, eps, samples=4096):
    """(hit, t, step): the first sample along each ray where the corrected
    trilinear distance is below eps, computed on the default device."""
    import jax
    import jax.numpy as jnp

    from sdf_tools_tpu.grid import SdfGrid
    from sdf_tools_tpu.ops import query

    ts = jnp.linspace(1e-3, t_max, samples, dtype=jnp.float32)

    @jax.jit
    def first_below(v, o, d):
        p = o[:, None, :] + ts[None, :, None] * d[:, None, :]
        dist, ok = query.estimate_distance(SdfGrid.create(v, meta, 1e3), p)
        below = ok & (dist < eps)
        return below.any(axis=1), jnp.where(below.any(axis=1), ts[jnp.argmax(below, 1)], jnp.inf)

    shape = np.shape(o)[:-1]
    o, d = jnp.reshape(o, (-1, 3)), jnp.reshape(d, (-1, 3))
    parts = [
        first_below(values, o[i : i + 1024], d[i : i + 1024])
        for i in range(0, o.shape[0], 1024)
    ]
    hit = np.concatenate([np.asarray(h) for h, _ in parts]).reshape(shape)
    t = np.concatenate([np.asarray(t) for _, t in parts]).reshape(shape)
    return hit, t, float(ts[1] - ts[0])


def phase_render(values_np):
    import jax
    import jax.numpy as jnp

    from sdf_tools_tpu.grid import GridMeta, make_origin_transform
    from sdf_tools_tpu.ops import render

    n = values_np.shape[0]
    meta = GridMeta.create(make_origin_transform([0.0, 0.0, 0.0]), RES, values_np.shape)
    fwd, vg, eps, t_max = _render_fns(meta, 1e3, n)
    center = np.full(3, 0.5 * n * RES)
    cam = center + np.array([-1.2 * n * RES, 0.0, 0.4 * n * RES])
    h = w = IMAGE
    o, d = render.camera_rays(
        jnp.asarray(cam, jnp.float32), jnp.asarray(center, jnp.float32),
        jnp.asarray([0.0, 0.0, 1.0]), 50.0, h, w,
    )
    values = jnp.asarray(values_np)
    (depth, hit), t = timed(fwd, values, o, d)
    log(f"[render] {h}^2 forward median of 5 = {t * 1e3:.3f} ms "
        f"({h * w / t:.4g} rays/s), hit fraction {float(jnp.mean(hit)):.3f}")
    ones = jnp.ones((h, w), jnp.float32)
    (val, grad), tb = timed(vg, values, o, d, ones)
    check(np.isfinite(float(val)) and bool(jnp.all(jnp.isfinite(grad))), "[render] grad")
    log(f"[render] {h}^2 value_and_grad median of 5 = {tb * 1e3:.3f} ms "
        f"({h * w / tb:.4g} rays/s)")

    # 16K-ray subsample (every 8th row and column) against the CPU
    cpu = jax.devices("cpu")[0]
    os_, ds_ = o[::8, ::8], d[::8, ::8]
    dep_g, hit_g = (np.asarray(a) for a in fwd(values, os_, ds_))
    vals_c, os_c, ds_c = (jax.device_put(a, cpu) for a in (values, os_, ds_))
    dep_c, hit_c = (np.asarray(a) for a in fwd(vals_c, os_c, ds_c))
    # The march is sensitive to the last bit of its inputs on a share of the
    # rays (a grazing ray can step over a thin crossing and hit a surface
    # behind it), and the GPU rounds and contracts its float sums in another
    # order than the CPU. So hit/miss flips may touch at most 0.1% of the
    # rays, and the GPU has to be as right as the CPU against dense ground
    # truth: the first below-eps sample of the corrected trilinear along
    # each ray (4096 samples).
    flips = float(np.mean(hit_g != hit_c))
    both = hit_g & hit_c
    far = float(np.mean(np.abs(dep_g - dep_c)[both] > eps))
    truth_hit, truth_t, step = _ground_truth(values, meta, os_, ds_, t_max, eps)
    tol = 2 * step + 0.5 * RES

    def right(dep, hit):
        return float(np.mean((hit == truth_hit) & (~hit | (np.abs(dep - truth_t) <= tol))))

    right_g, right_c = right(dep_g, hit_g), right(dep_c, hit_c)
    log(f"[render] {hit_g.size} rays vs CPU: hit/miss flips {flips:.5f} (limit 0.001); "
        f"both-hit depths more than eps={eps} apart: {far:.4f}")
    log(f"[render] agreement with dense ground truth (hit flag, depth within "
        f"{tol:.4f}): GPU {right_g:.4f}, CPU {right_c:.4f} (GPU limit "
        f"{right_c - 0.002:.4f})")
    check(flips <= 0.001, f"[render] hit/miss flips on {flips:.5f} of the rays")
    check(right_g >= right_c - 0.002, "[render] GPU less right than the CPU")
    # gradients of a loss over the rays whose march took the same path on
    # the GPU, the CPU and the CPU with ray origins moved by one ulp (depths
    # within 1e-5 m of each other). Near-tangent rays (the IFT divides by
    # grad(d).v) and hit points within rounding of a cell centre (where the
    # trilinear stencil switches corners) amplify last-bit differences, so
    # the GPU is held to 3x what one ulp does on the CPU alone.
    o_p = os_c * (1 + 2.0**-23)
    dep_p, hit_p = (np.asarray(a) for a in fwd(vals_c, o_p, ds_c))
    same = both & hit_p & (np.abs(dep_g - dep_c) <= 1e-5) & (np.abs(dep_p - dep_c) <= 1e-5)
    wts = jnp.asarray(same.astype(np.float32))
    w_c = jax.device_put(wts, cpu)
    g_g = np.asarray(vg(values, os_, ds_, wts)[1])
    g_c = np.asarray(vg(vals_c, os_c, ds_c, w_c)[1])
    g_p = np.asarray(vg(vals_c, o_p, ds_c, w_c)[1])
    rel = float(np.linalg.norm(g_g - g_c) / np.linalg.norm(g_c))
    rel_cpu = float(np.linalg.norm(g_p - g_c) / np.linalg.norm(g_c))
    limit = max(3 * rel_cpu, 1e-4)
    log(f"[render] gradient over {same.sum()} same-path hits ({same.mean():.4f} of the "
        f"rays): GPU vs CPU rel L2 {rel:.3g}; CPU vs CPU with origins moved one ulp "
        f"{rel_cpu:.3g} (limit {limit:.3g})")
    check(rel <= limit, f"[render] gradient rel L2 vs CPU {rel:.3g}")


def phase_ft(mask_np, values_np):
    import jax
    import jax.numpy as jnp

    from sdf_tools_tpu.ops import diff

    occ = jnp.asarray(mask_np, jnp.float32)
    rng = np.random.default_rng(5)
    cot = rng.standard_normal(mask_np.shape).astype(np.float32)

    @jax.jit
    def fwd_bwd(o, c):
        vals, pullback = jax.vjp(lambda x: diff.sdf_from_occupancy_ft(x, RES, "auto"), o)
        return vals, pullback(c)[0]

    (vals, g), t = timed(fwd_bwd, occ, jnp.asarray(cot), reps=3)
    check(np.array_equal(np.asarray(vals).view(np.uint32), values_np.view(np.uint32)),
          "[ft] forward differs from the signed field")
    g = np.asarray(g, np.float64)
    # every cell's cotangent lands, times -2*res, on exactly one feature
    # cell; the f32 scatter-add sums with atomics in a run-dependent order,
    # and each add rounds by at most half an ulp of its partial sum, so
    # allow 1e-7 of the routed absolute mass
    want = -2 * RES * cot.astype(np.float64).sum()
    tol = 1e-7 * 2 * RES * np.abs(cot).astype(np.float64).sum()
    check(abs(g.sum() - want) <= tol, f"[ft] mass {g.sum()} vs {want} (tol {tol})")
    check(np.isfinite(g).all(), "[ft] non-finite gradient")
    log(f"[ft] forward == signed field bitwise; forward+backward median of 3 = "
        f"{t * 1e3:.3f} ms; mass error {abs(g.sum() - want):.3g} (limit {tol:.3g})")


def phase_memory(mask_np):
    import jax
    import jax.numpy as jnp

    from sdf_tools_tpu.ops import edt

    step = jax.jit(lambda m: edt.signed_field_from_masks(m, RES))
    ma = step.lower(jnp.asarray(mask_np)).compile().memory_analysis()
    log(f"[memory] EDT step: arguments {ma.argument_size_in_bytes} B, outputs "
        f"{ma.output_size_in_bytes} B, temporaries {ma.temp_size_in_bytes} B")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"[memory] peak_bytes_in_use {stats.get('peak_bytes_in_use', 'not reported')} B")


def phase_gpu_tests():
    import pytest

    os.environ["SDFT_TEST_PLATFORM"] = "gpu"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests", "test_gpu.py")])
    check(rc == 0, f"[gpu tests] pytest exit code {rc}")
    log("[gpu tests] passed")


def phase_multi_gpu():
    """x-slab and 2x2-tile sharded signed fields at 1024^3 on four cards,
    each bitwise against the one-card field, and three sharded train steps."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from bench import make_scene
    from sdf_tools_tpu.ops import edt
    from sdf_tools_tpu.parallel import sharded, train
    import __graft_entry__ as entry

    devs = jax.devices()
    check(len(devs) == 4, f"--multi-gpu needs 4 GPUs, found {len(devs)}")
    mask_np = make_scene(1024)
    n = mask_np.shape[0]
    outs = {}
    for name, axes, spec, fn in (
        ("x-slab", {"x": 4}, P("x"),
         lambda m: sharded.sharded_signed_field(m, RES, "x")),
        ("2x2-tile", {"x": 2, "y": 2}, P("x", "y"),
         lambda m: sharded.sharded_signed_field_2d(m, RES, "x", "y")),
    ):
        mesh = sharded.make_mesh(axes)
        # placed shard by shard from the host: nothing lands on device 0
        mask = jax.device_put(mask_np, NamedSharding(mesh, spec))
        f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=spec, out_specs=spec))
        out, t = timed(f, mask)
        check(out.sharding.device_set == set(devs), f"[multi] {name} placement")
        outs[name] = np.asarray(out)
        log(f"[multi] {name} signed field {n}^3 on 4 GPUs median of 5 = {t * 1e3:.3f} ms")
        del mask, out
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0) for d in devs]
    log(f"[multi] per-device peak bytes after the sharded fields: {peaks}")
    check(max(peaks) <= 1.5 * min(peaks), "[multi] device 0 holds more than its share")

    ref_f = jax.jit(lambda m: edt.signed_field_from_masks(m, RES)[0])
    ref, t_ref = timed(ref_f, jax.device_put(mask_np, devs[0]), reps=3)
    ref = np.asarray(ref)
    log(f"[multi] one-card signed field {n}^3 median of 3 = {t_ref * 1e3:.3f} ms")
    for name, out in outs.items():
        check(np.array_equal(out.view(np.uint32), ref.view(np.uint32)),
              f"[multi] {name} differs from the one-card field")
    log("[multi] x-slab and 2x2-tile fields == one-card field, bitwise")
    del ref, outs

    cfg = train.PipelineConfig(grid_n=256, resolution=0.05, image_h=64, image_w=64,
                               t_max=40.0)
    mesh = sharded.make_mesh({"dp": 1, "x": 4})
    step = train.make_train_step(mesh, cfg)
    rng = np.random.default_rng(0)
    center = np.full(3, 0.5 * cfg.grid_n * cfg.resolution)
    u = rng.normal(size=(1, 4096, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    pts = jnp.asarray((center + u * (0.2 * cfg.grid_n * cfg.resolution)).astype(np.float32))
    target = jnp.full((1, cfg.image_h, cfg.image_w), 1.0, jnp.float32)
    entry._assert_no_volume_collectives(
        step.lower(pts, target).compile().as_text(), cfg.grid_n**3
    )
    p, losses = pts, []
    for _ in range(3):
        p, loss = step(p, target)
        losses.append(float(loss))
    moved = float(jnp.max(jnp.abs(p - pts)))
    check(all(np.isfinite(losses)) and moved > 0, f"[multi] train {losses} moved {moved}")
    log(f"[multi] 3 train steps on dp=1,x=4 at 256^3: losses {losses}, points moved "
        f"{moved:.3g}; no volume-sized collectives")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi-gpu", action="store_true",
                    help="run only the four-card sharded path")
    args = ap.parse_args(argv)

    from sdf_tools_tpu import devices

    log(f"[device] compile cache: {devices.setup_compile_cache()}")
    info = phase_device()
    if args.multi_gpu:
        phase_multi_gpu()
    else:
        from bench import make_scene

        mask = make_scene(N_EDT)
        values = phase_edt(mask)
        phase_queries()
        phase_render(values)
        phase_ft(mask, values)
        phase_memory(mask)
        phase_gpu_tests()
    print(json.dumps({"ok": True, "device": info}), flush=True)


if __name__ == "__main__":
    main()
