"""The XLA march (ops/render.py) on scenes that stress its hit decisions,
scored against dense-sampled ground truth of the same corrected-trilinear
distance: misses, rays starting inside, rays marching in -x, axis-aligned
rays, obstacles cut by the volume faces, and a silhouette-heavy view.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from sdf_tools_tpu.grid import GridMeta, SdfGrid
from sdf_tools_tpu.ops import query, render

T_MAX, EPS = 40.0, 1e-3


def _sphere_scene(shape=(64, 64, 128), res=0.1):
    """Analytic SDF of two spheres sampled at cell centers."""
    meta = GridMeta.create(origin_transform=jnp.eye(4), resolution=res, shape=shape)
    nx, ny, nz = shape
    ii, jj, kk = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    pts = (np.stack([ii, jj, kk], -1) + 0.5) * res
    c1 = np.array([nx * 0.5, ny * 0.5, nz * 0.45]) * res
    c2 = np.array([nx * 0.65, ny * 0.35, nz * 0.55]) * res
    d1 = np.linalg.norm(pts - c1, axis=-1) - 0.2 * ny * res
    d2 = np.linalg.norm(pts - c2, axis=-1) - 0.12 * ny * res
    values = np.minimum(d1, d2).astype(np.float32)
    return SdfGrid.create(jnp.asarray(values), meta, oob_value=jnp.inf)


@pytest.fixture(scope="module")
def scene():
    return _sphere_scene()


def _camera(shape, res, h, w, side=-1.0, fov=20.0):
    nx, ny, nz = shape
    center = np.array([nx, ny, nz]) * res * 0.5
    pos = center + np.array([side * nx * res * 1.5, ny * res * 0.1, nz * res * 0.05])
    return render.camera_rays(
        jnp.asarray(pos, jnp.float32), jnp.asarray(center, jnp.float32),
        jnp.asarray([0.0, 0.0, 1.0]), fov, h, w,
    )


def _march(sdf, o, v, t_max=T_MAX):
    r = render.render_depth(sdf, o, v, t_max=t_max, eps=EPS, max_steps=96)
    return np.asarray(r.depth).reshape(-1), np.asarray(r.hit).reshape(-1)


def _ground_truth(sdf, o, v, t_max=T_MAX, samples=4096):
    """(hit, t): first below-eps sample of the corrected trilinear along
    each ray, and the sampling step."""
    of = np.asarray(o).reshape(-1, 3)
    vf = np.asarray(v).reshape(-1, 3)
    ts = np.linspace(1e-3, t_max, samples).astype(np.float32)
    hit = np.zeros(of.shape[0], bool)
    t = np.full(of.shape[0], np.inf, np.float32)
    for b in range(0, of.shape[0], 256):
        p = of[b : b + 256, None, :] + ts[None, :, None] * vf[b : b + 256, None, :]
        d, ok = query.estimate_distance(sdf, jnp.asarray(p))
        below = np.asarray(ok & (d < EPS))
        hit[b : b + 256] = below.any(axis=1)
        t[b : b + 256] = np.where(below.any(axis=1), ts[below.argmax(axis=1)], np.inf)
    return hit, t, float(ts[1] - ts[0])


def _score(sdf, o, v, t_max=T_MAX):
    depth, hit = _march(sdf, o, v, t_max)
    truth, t_true, step = _ground_truth(sdf, o, v, t_max)
    both = hit & truth
    err = np.abs(depth[both] - t_true[both])
    return depth, hit, truth, both, err, step


def test_march_matches_dense_ground_truth(scene):
    o, v = _camera(scene.meta.shape, 0.1, 16, 64)
    _, hit, truth, both, err, step = _score(scene, o, v)
    assert (hit == truth).mean() > 0.98
    assert both.sum() > 100
    # the march can step over a thin grazing crossing (a sphere's limb in
    # front of the other sphere) and hit the surface behind it: those rays
    # are a minority; the rest sit within the sampling step of the crossing
    assert np.quantile(err, 0.9) < 0.5 * 0.1
    assert np.median(err) < 0.1 * 0.1


def test_march_miss_depth_is_tmax(scene):
    o, v = _camera(scene.meta.shape, 0.1, 8, 64)
    depth, hit = _march(scene, o, v)
    assert (~hit).any() and hit.any()
    np.testing.assert_array_equal(depth[~hit], T_MAX)


def test_march_ray_starting_inside(scene):
    res = 0.1
    center = np.array(scene.meta.shape) * res * 0.5
    center[2] = scene.meta.shape[2] * res * 0.45  # inside sphere 1
    o = np.tile(center, (64, 1)).astype(np.float32)
    v = np.tile([1.0, 0.0, 0.0], (64, 1)).astype(np.float32)
    depth, hit = _march(scene, jnp.asarray(o), jnp.asarray(v))
    assert hit.all()
    assert (depth < 2 * res).all(), depth[:4]


def test_march_axis_aligned_rays(scene):
    """Rays parallel to the z axis entering through the z=0 face."""
    res = 0.1
    nx, ny, _ = scene.meta.shape
    o = np.zeros((64, 3), np.float32)
    o[:, 0] = nx * res * 0.5 + np.linspace(-1.5, 1.5, 64)
    o[:, 1] = ny * res * 0.5
    o[:, 2] = -1.0
    v = np.tile([0.0, 0.0, 1.0], (64, 1)).astype(np.float32)
    _, hit, truth, both, err, step = _score(scene, jnp.asarray(o), jnp.asarray(v))
    np.testing.assert_array_equal(hit, truth)
    assert both.sum() > 10
    assert np.quantile(err, 0.95) < 0.5 * res


def test_march_negative_direction(scene):
    o, v = _camera(scene.meta.shape, 0.1, 12, 64, side=+1.0)
    _, hit, truth, both, err, step = _score(scene, o, v)
    assert (hit == truth).mean() > 0.98
    assert both.sum() > 50
    assert np.quantile(err, 0.95) < 0.5 * 0.1


def test_march_boundary_slivers():
    """Obstacles poking through the volume faces: crossings in the sliver
    between a grid face and the nearest cell center."""
    shape, res = (32, 32, 128), 0.05
    rng = np.random.default_rng(2)
    meta = GridMeta.create(jnp.eye(4), res, shape)
    ii, jj, kk = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    pts = (np.stack([ii, jj, kk], -1) + 0.5) * res
    d = np.full(shape, 1e9, np.float32)
    ext = np.array(shape) * res
    for _ in range(20):
        c = ext * rng.random(3)
        face = rng.integers(0, 7)
        if face < 6:
            ax, side = face % 3, face // 3
            c[ax] = (0.0 if side == 0 else ext[ax]) + res * rng.uniform(-6, 6)
        r = res * (3 + 8 * rng.random())
        d = np.minimum(d, np.linalg.norm(pts - c, axis=-1) - r)
    sdf = SdfGrid.create(jnp.asarray(d), meta, oob_value=jnp.inf)
    center = ext * 0.5
    cam = center + np.array([-shape[0] * res * 1.2, 0.0, ext[2] * 0.4])
    o, v = render.camera_rays(
        jnp.asarray(cam, jnp.float32), jnp.asarray(center, jnp.float32),
        jnp.asarray([0.0, 0.0, 1.0]), 50.0, 12, 64,
    )
    _, hit, truth, both, err, step = _score(sdf, o, v, t_max=15.0)
    assert truth.any()
    tol = 2 * step + 2 * res
    correct = hit == truth
    correct[both] = err <= tol
    # a handful of near-graze rays (true minimum within O(eps) of the
    # threshold) may resolve either way
    assert correct.sum() >= hit.size - 8, (int(correct.sum()), hit.size)


def test_march_silhouette_false_misses_bounded():
    """A band of rays grazing a sphere's limb, against dense ground truth.
    The march never reports a hit the surface does not have; stepping at
    least half a cell, it can step over a dip below eps that is shorter
    than its step, so a few limb rays are false misses: at most 2% of the
    true hits. Its hits sit at the crossing."""
    sdf = _sphere_scene()
    nx, ny, nz = sdf.meta.shape
    res = 0.1
    c1 = np.array([nx * 0.5, ny * 0.5, nz * 0.45]) * res
    limb = c1 + np.array([0.0, 0.0, 0.2 * ny * res])  # top of sphere 1
    pos = limb + np.array([-nx * res * 1.5, 0.0, 0.0])
    o, v = render.camera_rays(
        jnp.asarray(pos, jnp.float32), jnp.asarray(limb, jnp.float32),
        jnp.asarray([0.0, 0.0, 1.0]), 6.0, 16, 16,
    )
    _, hit, truth, both, err, step = _score(sdf, o, v)
    assert truth.any() and (~truth).any(), "scene must mix hit/miss"
    false_miss = int((truth & ~hit).sum())
    false_hit = int((~truth & hit).sum())
    assert false_hit == 0, (false_miss, false_hit)
    assert false_miss <= 0.02 * truth.sum(), (false_miss, false_hit)
    assert float(err.max()) < 0.2, f"depth err {err.max():.3f}"
