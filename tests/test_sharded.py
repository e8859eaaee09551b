"""Sharded EDT on a virtual 8-device CPU mesh vs the single-device result."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from jax.sharding import PartitionSpec as P
from jax import shard_map

from sdf_tools_tpu.ops import edt
from sdf_tools_tpu.parallel import sharded


def _mesh_1d(n=8, name="x"):
    return sharded.make_mesh({name: n})


@pytest.mark.parametrize("shape,p", [((32, 16, 8), 0.1), ((16, 8, 24), 0.05), ((8, 12, 4), 0.4)])
def test_sharded_edt_matches_single_device(shape, p):
    rng = np.random.default_rng(0)
    mask = rng.random(shape) < p
    if not mask.any():
        mask[0, 0, 0] = True
    mesh = _mesh_1d(8)

    f = shard_map(
        lambda m: sharded.sharded_squared_edt(m, "x", backend="stencil"),
        mesh=mesh,
        in_specs=P("x"),
        out_specs=P("x"),
    )
    out = np.asarray(jax.jit(f)(jnp.asarray(mask)))
    ref = np.asarray(edt.squared_edt(jnp.asarray(mask), backend="stencil"))
    np.testing.assert_array_equal(out, ref)


def test_sharded_edt_no_seeds_line():
    # lines with seeds only in one shard + lines with no seeds at all
    mask = np.zeros((32, 4, 4), bool)
    mask[3, 0, 0] = True  # only shard 0 has a seed, in one line
    mesh = _mesh_1d(8)
    f = shard_map(
        lambda m: sharded.sharded_squared_edt(m, "x", backend="stencil"),
        mesh=mesh,
        in_specs=P("x"),
        out_specs=P("x"),
    )
    out = np.asarray(jax.jit(f)(jnp.asarray(mask)))
    ref = np.asarray(edt.squared_edt(jnp.asarray(mask), backend="stencil"))
    np.testing.assert_array_equal(out, ref)


def test_sharded_signed_field():
    rng = np.random.default_rng(1)
    mask = rng.random((32, 12, 6)) < 0.15
    mask[0, 0, 0] = True
    res = 0.1
    mesh = _mesh_1d(8)
    f = shard_map(
        lambda m: sharded.sharded_signed_field(m, res, "x", backend="stencil"),
        mesh=mesh,
        in_specs=P("x"),
        out_specs=P("x"),
    )
    out = np.asarray(jax.jit(f)(jnp.asarray(mask)))
    ref, _, _ = edt.signed_field_from_masks(jnp.asarray(mask), res, backend="stencil")
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-6, atol=1e-7)


def test_sharded_signed_field_fused_dual():
    """The pallas route of sharded_signed_field (ONE stacked boundary
    collective + two-field envelopes + combine epilogue) is bitwise
    identical to the single-device field. check_vma=False: see
    test_pallas_backend_inside_shard_map."""
    rng = np.random.default_rng(4)
    mask = rng.random((32, 16, 8)) < 0.15
    mask[0, 0, 0] = True
    res = 0.1
    mesh = _mesh_1d(8)
    f = shard_map(
        lambda m: sharded.sharded_signed_field(
            m, res, "x", backend="pallas", interpret=True
        ),
        mesh=mesh,
        in_specs=P("x"),
        out_specs=P("x"),
        check_vma=False,
    )
    out = np.asarray(jax.jit(f)(jnp.asarray(mask)))
    ref, _, _ = edt.signed_field_from_masks(jnp.asarray(mask), res, backend="stencil")
    np.testing.assert_array_equal(
        out.view(np.uint32), np.asarray(ref).view(np.uint32)
    )
    # lines with seeds in only one shard + seedless free-field lines
    mask2 = np.zeros((32, 4, 4), bool)
    mask2[3, 0, 0] = True
    out2 = np.asarray(jax.jit(f)(jnp.asarray(mask2)))
    ref2, _, _ = edt.signed_field_from_masks(jnp.asarray(mask2), res, backend="stencil")
    np.testing.assert_array_equal(
        out2.view(np.uint32), np.asarray(ref2).view(np.uint32)
    )


def test_halo_envelope_matches_local():
    rng = np.random.default_rng(2)
    shape = (32, 8, 8)
    f_in = rng.integers(0, 200, shape).astype(np.int32)
    mesh = _mesh_1d(8)
    g = shard_map(
        lambda a: sharded.sharded_envelope_axis0_halo(a, "x", halo=4),
        mesh=mesh,
        in_specs=P("x"),
        out_specs=P("x"),
    )
    out = np.asarray(jax.jit(g)(jnp.asarray(f_in)))
    ref = np.asarray(edt.envelope_pass_brute(jnp.asarray(f_in), 0))
    np.testing.assert_array_equal(out, ref)


def test_sharded_edt_2d_mesh_with_dp():
    """Nested data-parallel axis: batch of scenes, each x-sharded."""
    rng = np.random.default_rng(3)
    masks = rng.random((2, 16, 8, 8)) < 0.2
    masks[:, 0, 0, 0] = True
    mesh = sharded.make_mesh({"dp": 2, "x": 4})

    f = shard_map(
        lambda m: sharded.sharded_squared_edt(m[0], "x", backend="stencil")[None],
        mesh=mesh,
        in_specs=P("dp", "x"),
        out_specs=P("dp", "x"),
    )
    out = np.asarray(jax.jit(f)(jnp.asarray(masks)))
    for b in range(2):
        ref = np.asarray(edt.squared_edt(jnp.asarray(masks[b]), backend="stencil"))
        np.testing.assert_array_equal(out[b], ref)


# ---------------------------------------------------------------------------
# Round 2: 2-D volume mesh, pallas-under-shard_map, sharded renderer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["reshard", "halo"])
def test_sharded_edt_2d_volume_mesh(method):
    """(x, y) tile decomposition over a 2x4 mesh, both strategies, bit-exact
    vs single device (VERDICT round-1 item 4)."""
    rng = np.random.default_rng(4)
    mask = rng.random((16, 32, 8)) < 0.12
    mask[0, 0, 0] = True
    mesh = sharded.make_mesh({"x": 2, "y": 4})
    f = shard_map(
        lambda m: sharded.sharded_squared_edt_2d(m, "x", "y", "stencil", method),
        mesh=mesh,
        in_specs=P("x", "y"),
        out_specs=P("x", "y"),
    )
    out = np.asarray(jax.jit(f)(jnp.asarray(mask)))
    ref = np.asarray(edt.squared_edt(jnp.asarray(mask), backend="stencil"))
    np.testing.assert_array_equal(out, ref)


def test_sharded_signed_field_2d_mesh():
    rng = np.random.default_rng(5)
    mask = rng.random((8, 16, 12)) < 0.2
    mask[0, 0, 0] = True
    mesh = sharded.make_mesh({"x": 2, "y": 4})
    f = shard_map(
        lambda m: sharded.sharded_signed_field_2d(m, 0.1, "x", "y"),
        mesh=mesh,
        in_specs=P("x", "y"),
        out_specs=P("x", "y"),
    )
    out = np.asarray(jax.jit(f)(jnp.asarray(mask)))
    ref, _, _ = edt.signed_field_from_masks(jnp.asarray(mask), 0.1, backend="stencil")
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-6, atol=1e-7)


def test_sharded_signed_field_2d_mesh_fused_dual():
    """The pallas route on the (x, y) tile mesh (two-field kernels + stacked
    all_to_all + combine-before-reshard) is bitwise identical to the
    single-device field. check_vma=False: see
    test_pallas_backend_inside_shard_map."""
    rng = np.random.default_rng(9)
    mask = rng.random((16, 32, 8)) < 0.15
    mask[0, 0, 0] = True
    mesh = sharded.make_mesh({"x": 2, "y": 4})
    f = shard_map(
        lambda m: sharded.sharded_signed_field_2d(
            m, 0.1, "x", "y", "pallas", interpret=True
        ),
        mesh=mesh,
        in_specs=P("x", "y"),
        out_specs=P("x", "y"),
        check_vma=False,
    )
    out = np.asarray(jax.jit(f)(jnp.asarray(mask)))
    ref, _, _ = edt.signed_field_from_masks(jnp.asarray(mask), 0.1, backend="stencil")
    np.testing.assert_array_equal(
        out.view(np.uint32), np.asarray(ref).view(np.uint32)
    )


def test_pallas_backend_inside_shard_map():
    """The GPU path runs the Pallas kernel INSIDE shard_map; exercise it
    here via interpret mode on the virtual mesh.

    check_vma=False: interpret-mode pallas drops varying-manual-axes types
    inside the kernel (its gathers come back unvarying). The compiled
    kernel is opaque to shard_map, so the GPU path keeps check_vma=True
    (tests/test_gpu.py)."""
    rng = np.random.default_rng(6)
    mask = rng.random((16, 16, 128)) < 0.15
    mask[0, 0, 0] = True
    mesh = _mesh_1d(8)
    f = shard_map(
        lambda m: sharded.sharded_squared_edt(m, "x", backend="pallas", interpret=True),
        mesh=mesh,
        in_specs=P("x"),
        out_specs=P("x"),
        check_vma=False,
    )
    out = np.asarray(jax.jit(f)(jnp.asarray(mask)))
    ref = np.asarray(edt.squared_edt(jnp.asarray(mask), backend="stencil"))
    np.testing.assert_array_equal(out, ref)


def _sphere_sdf(n=32, res=0.1, r_cells=9):
    from sdf_tools_tpu.grid import GridMeta, make_origin_transform

    c = (n - 1) / 2.0
    ii = np.arange(n)
    d2 = (
        (ii[:, None, None] - c) ** 2
        + (ii[None, :, None] - c) ** 2
        + (ii[None, None, :] - c) ** 2
    )
    mask = d2 <= r_cells**2
    meta = GridMeta.create(make_origin_transform([0.0, 0.0, 0.0]), res, (n, n, n))
    vals, _, _ = edt.signed_field_from_masks(jnp.asarray(mask), res, backend="stencil")
    return np.asarray(vals), meta


def test_sharded_render_matches_single_device():
    """Slab-traced min-composited render == single-device render (VERDICT
    round-1 item 3: no full-volume all_gather)."""
    from sdf_tools_tpu.grid import SdfGrid
    from sdf_tools_tpu.ops import render

    vals, meta = _sphere_sdf()
    n = meta.shape[0]
    sdf = SdfGrid.create(jnp.asarray(vals), meta, 1e3)
    center = np.full(3, 0.5 * n * 0.1)
    cam = center - np.array([2.0, 0.3, 0.1])
    origins, dirs = render.camera_rays(cam, center, [0.0, 0.0, 1.0], 40.0, 12, 12)

    single = render.render_depth(sdf, origins, dirs, t_max=5.0)

    mesh = _mesh_1d(8)
    f = shard_map(
        lambda v: sharded.sharded_render_depth(
            v, meta, 1e3, origins, dirs, "x", halo=2, t_max=5.0
        ),
        mesh=mesh,
        in_specs=P("x"),
        out_specs=(P(), P()),
        check_vma=False,
    )
    depth, hit = jax.jit(f)(jnp.asarray(vals))
    h1 = np.asarray(single.hit)
    h2 = np.asarray(hit)
    # grazing silhouette rays may differ (the slab-restart march catches
    # edge hits the global NN-march creeps past); interior rays must agree
    assert (h1 != h2).sum() <= max(2, int(0.03 * h1.size))
    np.testing.assert_array_equal(h1[3:-3, 3:-3], h2[3:-3, 3:-3])
    both = h1 & h2
    # different step sequences; bisection refinement brings both to ~res/2
    np.testing.assert_allclose(
        np.asarray(depth)[both], np.asarray(single.depth)[both], atol=0.1 * 0.5
    )


def test_sharded_render_plane_backend_raises():
    """The plane-sweep backend is gone: asking for it inside the sharded
    renderer raises instead of silently marching."""
    from sdf_tools_tpu.grid import GridMeta, make_origin_transform
    from sdf_tools_tpu.ops import render

    n, res = 16, 0.1
    meta = GridMeta.create(make_origin_transform([0.0, 0.0, 0.0]), res, (n, n, n))
    vals = jnp.ones((n, n, n), jnp.float32)
    o, d = render.camera_rays(
        jnp.asarray([-1.0, 0.8, 0.8]), jnp.asarray([0.8, 0.8, 0.8]),
        jnp.asarray([0.0, 0.0, 1.0]), 30.0, 4, 4,
    )
    f = shard_map(
        lambda v: sharded.sharded_render_depth(
            v, meta, 1e3, o, d, "x", halo=2, t_max=5.0, backend="plane"
        ),
        mesh=_mesh_1d(8),
        in_specs=P("x"),
        out_specs=(P(), P()),
        check_vma=False,
    )
    with pytest.raises(ValueError, match="plane"):
        jax.jit(f)(vals)


def test_sharded_render_slab_parallel_rays_full_budget():
    """A ray near-parallel to the x-slab faces traverses its whole length
    inside ONE slab; the old max_steps//n_dev cap (16 steps at 8 shards)
    starved it into a silent miss. Regression for ADVICE r2 medium /
    VERDICT r2 item 6: the sharded render must match single-device for such
    rays with the full per-shard budget."""
    from sdf_tools_tpu.grid import GridMeta, make_origin_transform
    from sdf_tools_tpu.ops import edt as edt_ops
    from sdf_tools_tpu.ops import render

    n, res = 64, 0.1
    mask = np.zeros((n, n, n), bool)
    mask[:, 52:60, 28:36] = True  # wall far along +y
    meta = GridMeta.create(make_origin_transform([0.0, 0.0, 0.0]), res, (n,) * 3)
    sdf, _ = edt_ops.extract_signed_distance_field(
        jnp.asarray(mask), meta, oob_value=1e3, backend="stencil"
    )
    # rays starting at y~0 marching along +y: in-slab path ~60+ cells, far
    # beyond the old 16-step cap even with coarse skipping
    origins = jnp.asarray(
        [[1.6, 0.05, 3.2], [3.2, 0.05, 3.0], [4.8, 0.05, 3.4]], jnp.float32
    )
    dirs = jnp.asarray([[0.0, 1.0, 0.0]] * 3, jnp.float32)
    single = render.render_depth(
        sdf, origins, dirs, t_max=12.0, max_steps=96, backend="march"
    )
    mesh = _mesh_1d(8)
    f = shard_map(
        lambda v: sharded.sharded_render_depth(
            v, meta, 1e3, origins, dirs, "x", halo=2, t_max=12.0, max_steps=96
        ),
        mesh=mesh,
        in_specs=P("x"),
        out_specs=(P(), P()),
        check_vma=False,
    )
    depth, hit = jax.jit(f)(sdf.values)
    assert np.asarray(single.hit).all()
    assert np.asarray(hit).all(), "slab-parallel rays must not be starved"
    np.testing.assert_allclose(
        np.asarray(depth), np.asarray(single.depth), atol=res
    )


def test_sharded_render_gradients_flow_to_values():
    from sdf_tools_tpu.ops import render

    vals, meta = _sphere_sdf(n=16, r_cells=5)
    n = meta.shape[0]
    center = np.full(3, 0.5 * n * 0.1)
    cam = center - np.array([1.2, 0.0, 0.0])
    origins, dirs = render.camera_rays(cam, center, [0.0, 0.0, 1.0], 30.0, 4, 4)
    mesh = _mesh_1d(8)

    def loss_local(v):
        depth, hit = sharded.sharded_render_depth(
            v, meta, 1e3, origins, dirs, "x", halo=2, t_max=4.0
        )
        return jnp.sum(jnp.where(hit, depth, 0.0))

    f = shard_map(
        lambda v: jax.grad(loss_local)(v),
        mesh=mesh,
        in_specs=P("x"),
        out_specs=P("x"),
        check_vma=False,
    )
    g = np.asarray(jax.jit(f)(jnp.asarray(vals)))
    assert np.isfinite(g).all()
    assert np.abs(g).sum() > 0
    # gradient support spans multiple slabs (surface cells live in several)
    per_slab = np.abs(g).reshape(8, -1).sum(axis=1)
    assert (per_slab > 0).sum() >= 2


def test_train_step_hlo_has_no_volume_sized_collectives():
    """The train step's collectives must be O(rays + surface), never
    O(volume): assert no all-gather/all-reduce operand reaches the full
    volume size (VERDICT round-1 item 3 'comm bytes asserted in a test')."""
    import re

    from sdf_tools_tpu.parallel import train

    mesh = sharded.make_mesh({"dp": 2, "x": 4})
    cfg = train.PipelineConfig(grid_n=32, image_h=16, image_w=16)
    step = train.make_train_step(mesh, cfg)
    B, N = 2, 16
    pts = jnp.zeros((B, N, 3), jnp.float32)
    tgt = jnp.zeros((B, cfg.image_h, cfg.image_w), jnp.float32)
    txt = jax.jit(step).lower(pts, tgt).compile().as_text()
    volume_elems = cfg.grid_n**3  # full volume f32 elements
    biggest = 0
    # HLO: "%name = s32[1,4,32,32]{...} all-gather(...)"
    pat = r"=\s*\w+\[([0-9,]*)\][^\n]*?\b(all-gather|all-reduce|all-to-all|collective-permute)\("
    for m in re.finditer(pat, txt):
        dims = [int(d) for d in m.group(1).split(",") if d]
        elems = 1
        for d in dims:
            elems *= d
        biggest = max(biggest, elems)
    assert biggest > 0, "expected some collectives in the compiled step"
    assert biggest < volume_elems, (
        f"volume-sized collective found: {biggest} elems >= {volume_elems}"
    )


def test_sharded_render_2d_tiles_matches_single_device():
    """(x, y) TILE-sharded renderer (sharded_render_depth_2d) vs the
    unsharded march: halos in both axes (incl. tile corners via the
    exchange-on-extended ordering) and the min-composite over both axes."""
    from sdf_tools_tpu.grid import GridMeta, make_origin_transform
    from sdf_tools_tpu.ops import edt as edt_ops
    from sdf_tools_tpu.ops import render

    nx, ny, nz, res = 32, 32, 16, 0.1
    # solid geometry only: isolated 1-voxel speckles make hit/miss depend on
    # the marcher's step pattern (the single-device march disagrees with the
    # 1-D slab renderer on them too), which is not what this test measures.
    # The box spans the y-tile boundary (y=16); the sphere sits in one tile.
    mask = np.zeros((nx, ny, nz), bool)
    mask[10:22, 12:24, 4:12] = True
    ii = np.arange(nx)
    sph = (
        (ii[:, None, None] - 24.0) ** 2
        + (ii[None, :32, None][:, :ny] - 6.0) ** 2
        + (ii[None, None, :nz] - 10.0) ** 2
    ) <= 9.0
    mask |= sph
    meta = GridMeta.create(make_origin_transform([0.0, 0.0, 0.0]), res, (nx, ny, nz))
    sdf, _ = edt_ops.extract_signed_distance_field(
        jnp.asarray(mask), meta, oob_value=1e3, backend="stencil"
    )
    center = np.array([0.5 * nx, 0.5 * ny, 0.5 * nz]) * res
    cam = center - np.array([1.5 * nx * res, 0.8, 0.3])
    origins, dirs = render.camera_rays(
        jnp.asarray(cam, jnp.float32), jnp.asarray(center, jnp.float32),
        jnp.asarray([0.0, 0.0, 1.0]), 35.0, 12, 16,
    )
    t_max = 4.0 * nx * res
    single = render.render_depth(
        sdf, origins, dirs, t_max=t_max, max_steps=96, backend="march"
    )
    mesh = sharded.make_mesh({"x": 4, "y": 2})
    f = shard_map(
        lambda v: sharded.sharded_render_depth_2d(
            v, meta, 1e3, origins, dirs, "x", "y", halo=2, t_max=t_max,
            max_steps=96, backend="march",
        ),
        mesh=mesh,
        in_specs=P("x", "y"),
        out_specs=(P(), P()),
        check_vma=False,
    )
    depth, hit = jax.jit(f)(sdf.values)
    h1 = np.asarray(single.hit)
    h2 = np.asarray(hit)
    assert h1.any(), "test scene must produce hits"
    assert (h1 != h2).sum() <= max(1, int(0.01 * h1.size))
    both = h1 & h2
    np.testing.assert_allclose(
        np.asarray(depth)[both], np.asarray(single.depth)[both], atol=res
    )


def test_sharded_render_2d_mesh_rays_x_slabs():
    """2-D mesh (dp x-slabs): rays sharded over 'dp', the volume over 'x'.

    Ray parallelism composes with the slab renderer unchanged — each
    (dp, x) device renders ITS ray shard over ITS slab and the
    min-composite runs over 'x' only; gathering ray shards over 'dp'
    reassembles the full image. Must equal the unsharded march."""
    from sdf_tools_tpu.grid import GridMeta, make_origin_transform
    from sdf_tools_tpu.ops import edt as edt_ops
    from sdf_tools_tpu.ops import render

    nx, ny, nz, res = 32, 24, 16, 0.1
    rng = np.random.default_rng(11)
    mask = rng.random((nx, ny, nz)) < 0.04
    mask[12:20, 8:16, 4:12] = True
    meta = GridMeta.create(make_origin_transform([0.0, 0.0, 0.0]), res, (nx, ny, nz))
    sdf, _ = edt_ops.extract_signed_distance_field(
        jnp.asarray(mask), meta, oob_value=1e3, backend="stencil"
    )
    center = np.array([0.5 * nx, 0.5 * ny, 0.5 * nz]) * res
    cam = center - np.array([1.5 * nx * res, 0.2, 0.1])
    origins, dirs = render.camera_rays(
        jnp.asarray(cam, jnp.float32), jnp.asarray(center, jnp.float32),
        jnp.asarray([0.0, 0.0, 1.0]), 30.0, 8, 16,
    )
    t_max = 4.0 * nx * res
    o_flat = jnp.asarray(origins.reshape(-1, 3))
    v_flat = jnp.asarray(dirs.reshape(-1, 3))

    def body(v_local, o_rays, d_rays):
        # each (dp, x) device: its ray shard over its x-slab; composite
        # over 'x' only — 'dp' stays sharded and out_specs reassembles
        return sharded.sharded_render_depth(
            v_local, meta, 1e3, o_rays, d_rays, "x", halo=2, t_max=t_max,
            max_steps=96, backend="march",
        )

    # reference: 1-D x-mesh with replicated rays (covered vs single-device
    # by test_sharded_render_* above); ray dp-sharding must be EXACTLY
    # neutral — identical slab volumes, identical per-ray math
    mesh1 = sharded.make_mesh({"dp": 1, "x": 4})
    f1 = shard_map(
        body, mesh=mesh1,
        in_specs=(P("x"), P("dp"), P("dp")), out_specs=(P("dp"), P("dp")),
        check_vma=False,
    )
    d1, h1 = jax.jit(f1)(sdf.values, o_flat, v_flat)

    mesh2 = sharded.make_mesh({"dp": 2, "x": 4})
    f2 = shard_map(
        body, mesh=mesh2,
        in_specs=(P("x"), P("dp"), P("dp")), out_specs=(P("dp"), P("dp")),
        check_vma=False,
    )
    d2, h2 = jax.jit(f2)(sdf.values, o_flat, v_flat)
    np.testing.assert_array_equal(np.asarray(h2), np.asarray(h1))
    np.testing.assert_array_equal(np.asarray(d2), np.asarray(d1))
    assert np.asarray(h1).any()  # scene actually renders something


_ASYNC_HLO = """
  %ags = (s32[1,64,64]{2,1,0}, s32[4,64,64]{2,1,0}) all-gather-start(s32[1,64,64]{2,1,0} %x)
  %agd = s32[4,64,64]{2,1,0} all-gather-done(%ags)
  %cps = (f32[2,64,64], f32[2,64,64], u32[], u32[]) collective-permute-start(f32[2,64,64] %z)
"""


@pytest.mark.parametrize("volume,ok", [(64**3, True), (4 * 64 * 64, False)])
def test_collective_check_reads_async_forms(volume, ok):
    """The GPU compiles collectives to asynchronous ``-start`` ops with tuple
    results; the volume-sized-collective check must read those too."""
    import __graft_entry__ as entry

    if ok:
        entry._assert_no_volume_collectives(_ASYNC_HLO, volume)
    else:
        with pytest.raises(AssertionError, match="full-volume-scale"):
            entry._assert_no_volume_collectives(_ASYNC_HLO, volume)
