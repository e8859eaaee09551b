"""Differentiability bridges + dense estimate_distance sampling parity.

The dense sub-cell sampling mirrors the reference's estimate_distance_test
(/root/reference/src/estimate_distance_test.cpp): a rotated-origin grid
sampled at res/8 steps, values checked against the scalar oracle.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sdf_tools_tpu.grid import GridMeta, make_origin_transform
from sdf_tools_tpu.ops import diff, edt, query
from sdf_tools_tpu.oracle.reference_query import OracleSdf


def test_straight_through_sdf_gradient():
    occ = jnp.zeros((8, 8, 8)).at[3:5, 3:5, 3:5].set(1.0)
    res = jnp.float32(0.1)

    def loss(o):
        vals = diff.sdf_from_occupancy_st(o, res, "stencil")
        return jnp.sum(vals**2)

    vals = diff.sdf_from_occupancy_st(occ, res, "stencil")
    g = jax.grad(loss)(occ)
    # straight-through: dL/docc = dL/dsdf * (-2 res) elementwise
    expected = 2.0 * np.asarray(vals) * (-2.0 * 0.1)
    np.testing.assert_allclose(np.asarray(g), expected, rtol=1e-5)


def test_straight_through_wrapper_matches_forward():
    occ = jnp.zeros((6, 6, 6)).at[2:4, 2:4, 2:4].set(1.0)
    res = 0.1
    fwd = lambda o: edt.signed_field_from_masks(o > 0.5, res, "stencil")[0]
    st = diff.straight_through_sdf(fwd, res)
    np.testing.assert_allclose(np.asarray(st(occ)), np.asarray(fwd(occ)))
    g = jax.grad(lambda o: jnp.sum(st(o)))(occ)
    np.testing.assert_allclose(np.asarray(g), -2.0 * res, rtol=1e-6)


def test_dense_subcell_sampling_rotated_grid():
    """estimate_distance_test semantics: dense sub-cell queries on a grid
    with a rotated, translated origin; every sample must match the scalar
    oracle (the reference eyeballs this in rviz; we assert it)."""
    rng = np.random.default_rng(0)
    shape = (10, 10, 2)
    mask = np.zeros(shape, bool)
    mask[2:5, 3:7, :] = True
    mask[7, 1, :] = True
    theta = 0.35
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    origin = make_origin_transform([0.4, -0.2, 0.05], rot)
    meta = GridMeta.create(origin, 0.1, shape)
    sdf, _ = edt.extract_signed_distance_field(jnp.asarray(mask), meta, oob_value=-10000.0)
    oracle = OracleSdf(np.asarray(sdf.values), 0.1, np.asarray(origin, np.float64), -10000.0)

    # dense sampling at res/8 through the middle slab, in world frame
    gx = np.arange(0.05, 0.95, 0.1 / 8)
    gy = np.arange(0.05, 0.95, 0.1 / 8)
    pts_grid = np.stack(np.meshgrid(gx, gy, indexing="ij"), -1)
    pts_grid = np.concatenate(
        [pts_grid, np.full(pts_grid.shape[:2] + (1,), 0.1)], axis=-1
    )
    pts_world = pts_grid @ rot.T + np.array([0.4, -0.2, 0.05])
    vals, oks = query.estimate_distance(sdf, jnp.asarray(pts_world, jnp.float32))
    vals, oks = np.asarray(vals), np.asarray(oks)
    checked = 0
    for i in range(0, pts_world.shape[0], 7):
        for j in range(0, pts_world.shape[1], 7):
            ov, ook = oracle.estimate_distance(pts_world[i, j].astype(np.float64))
            assert bool(oks[i, j]) == ook
            if ook:
                np.testing.assert_allclose(vals[i, j], ov, rtol=3e-4, atol=3e-5)
                checked += 1
    assert checked > 50


def test_gradient_flavors_agree_in_smooth_regions():
    """Discrete vs smooth vs autodiff gradients roughly agree away from the
    surface (the reference prints these side by side; we assert cosine
    similarity)."""
    n = 16
    c = (n - 1) / 2
    ii = np.arange(n)
    d2 = (
        (ii[:, None, None] - c) ** 2
        + (ii[None, :, None] - c) ** 2
        + (ii[None, None, :] - c) ** 2
    )
    mask = d2 <= 4**2
    meta = GridMeta.create(make_origin_transform([0.0, 0.0, 0.0]), 0.1, (n, n, n))
    sdf, _ = edt.extract_signed_distance_field(jnp.asarray(mask), meta, oob_value=1e3)

    pts = np.asarray(
        meta.index_to_location(jnp.asarray([[2, 8, 8], [13, 8, 8], [8, 2, 8]]))
    )
    idx = jnp.asarray([[2, 8, 8], [13, 8, 8], [8, 2, 8]])
    g_disc, _ = query.gradient(sdf, idx, enable_edge_gradients=True)
    g_smooth, _ = query.smooth_gradient(sdf, jnp.asarray(pts), 0.05)
    g_auto = query.autodiff_gradient(sdf, jnp.asarray(pts))
    for a, b in [(g_disc, g_smooth), (g_smooth, g_auto)]:
        a, b = np.asarray(a), np.asarray(b)
        cos = (a * b).sum(-1) / (
            np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-12
        )
        assert (cos > 0.97).all()


def test_feature_transform_is_exact_nearest_seed():
    """feature_transform returns a TRUE argmin: d2 equals the exact EDT and
    the feature cell is a seed at exactly that distance."""
    from sdf_tools_tpu.ops import feature

    rng = np.random.default_rng(3)
    for shape, p in [((12, 10, 8), 0.08), ((6, 16, 6), 0.3), ((9, 7, 11), 0.02)]:
        mask = rng.random(shape) < p
        mask[0, 0, 0] = True
        d2, feat = feature.feature_transform(jnp.asarray(mask))
        d2 = np.asarray(d2)
        feat = np.asarray(feat)
        ref = np.asarray(edt.squared_edt(jnp.asarray(mask), backend="brute"))
        np.testing.assert_array_equal(d2, ref)
        ix, iy, iz = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
        fx, fy, fz = feat[..., 0], feat[..., 1], feat[..., 2]
        assert mask[fx, fy, fz].all(), "feature must point at a seed"
        dist = (ix - fx) ** 2 + (iy - fy) ** 2 + (iz - fz) ** 2
        np.testing.assert_array_equal(dist, ref)


def test_ft_surrogate_matches_fd_cross_terms():
    """Near-surface cross sensitivity: flipping cell i's nearest filled cell
    changes sdf[i]. The exact finite difference is nonzero; the diagonal ST
    surrogate predicts exactly 0 there; the feature-routed surrogate
    predicts the right sign and scale (VERDICT round-1 item 7)."""
    from sdf_tools_tpu.ops import feature

    # scene with a UNIQUE nearest filled cell for the probe (ties would make
    # a single-cell flip a no-op on the min): one isolated filled cell plus
    # a far block so both fields are non-degenerate
    n, res = 12, 0.1
    occ = np.zeros((n, n, n), np.float32)
    occ[5, 5, 5] = 1.0
    occ[0:2, 0:2, 0:2] = 1.0
    mask = occ > 0.5

    _, feat_filled = feature.feature_transform(jnp.asarray(mask))
    probe = (8, 5, 5)  # 3 cells from the isolated cell, far from the block
    assert not mask[probe]
    j = tuple(int(v) for v in np.asarray(feat_filled)[probe])
    assert mask[j]

    def sdf_at_probe(o):
        vals, _, _ = edt.signed_field_from_masks(o > 0.5, res, backend="stencil")
        return np.asarray(vals)[probe]

    # exact finite difference: flip the feature cell filled -> free
    occ_flip = occ.copy()
    occ_flip[j] = 0.0
    fd_slope = (sdf_at_probe(jnp.asarray(occ_flip)) - sdf_at_probe(jnp.asarray(occ))) / (
        0.0 - 1.0
    )
    assert fd_slope < 0, "removing the nearest filled cell must raise sdf"

    # diagonal ST: gradient w.r.t. occ[j] of a loss reading sdf[probe]
    def loss_st(o):
        return diff.sdf_from_occupancy_st(o, jnp.float32(res), "stencil")[probe]

    g_st = np.asarray(jax.grad(loss_st)(jnp.asarray(occ)))[j]
    assert g_st == 0.0, "diagonal surrogate has no cross terms"

    def loss_ft(o):
        return diff.sdf_from_occupancy_ft(o, jnp.float32(res), "stencil")[probe]

    g_ft = np.asarray(jax.grad(loss_ft)(jnp.asarray(occ)))[j]
    assert g_ft < 0, "feature surrogate must carry the cross term"
    # right order of magnitude (FD slope is a one-cell jump ~ res)
    assert 0.1 * abs(fd_slope) < abs(g_ft) < 10 * abs(fd_slope)


def test_ft_surrogate_forward_matches_st():
    occ = jnp.zeros((8, 8, 8)).at[2:6, 2:6, 2:6].set(1.0)
    a = diff.sdf_from_occupancy_st(occ, jnp.float32(0.1), "stencil")
    b = diff.sdf_from_occupancy_ft(occ, jnp.float32(0.1), "stencil")
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _ft_grad(occ, cot, res=0.1, backend="stencil"):
    def loss(o):
        vals = diff.sdf_from_occupancy_ft(o, jnp.float32(res), backend)
        return jnp.sum(vals * cot)

    return np.asarray(jax.grad(loss)(jnp.asarray(occ)))


@pytest.mark.parametrize(
    "shape,p,seed", [((10, 14, 8), 0.2, 19), ((9, 7, 11), 0.05, 5), ((6, 16, 6), 0.5, 2)]
)
def test_ft_backward_mass_conservation(shape, p, seed):
    """The scatter-add backward routes every valid cotangent, scaled by
    -2*res, onto exactly one feature cell: total mass is conserved."""
    rng = np.random.default_rng(seed)
    occ = (rng.random(shape) < p).astype(np.float32)
    occ.flat[0] = 1.0
    occ.flat[-1] = 0.0  # both fields non-empty: every cotangent is valid
    cot = rng.standard_normal(shape).astype(np.float32)
    g = _ft_grad(occ, cot)
    np.testing.assert_allclose(g.sum(), (-2 * 0.1) * cot.sum(), rtol=1e-4, atol=1e-4)


def test_ft_backward_matches_numpy_routing():
    """d_occ equals a host-side np.add.at of -2*res*cot onto each cell's
    opposite-side feature (the closest-point map of the other field)."""
    from sdf_tools_tpu.ops import feature

    rng = np.random.default_rng(7)
    occ = (rng.random((8, 12, 10)) < 0.15).astype(np.float32)
    occ[0, 0, 0], occ[-1, -1, -1] = 1.0, 0.0
    cot = rng.standard_normal(occ.shape).astype(np.float32)
    mask = occ > 0.5
    _, f_filled = feature.feature_transform(jnp.asarray(mask))
    _, f_free = feature.feature_transform(jnp.asarray(~mask))
    feat = np.where(mask[..., None], np.asarray(f_free), np.asarray(f_filled))
    ref = np.zeros(occ.shape, np.float32)
    np.add.at(ref, (feat[..., 0], feat[..., 1], feat[..., 2]), -0.2 * cot)
    np.testing.assert_allclose(_ft_grad(occ, cot), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("probe", [(8, 5, 5), (5, 9, 5), (5, 5, 2)])
def test_ft_backward_matches_finite_difference(probe):
    """Around an isolated filled cell, removing that cell moves sdf[probe]
    by a one-cell jump; the feature-routed gradient at the cell has the
    finite difference's sign and order of magnitude."""
    n, res = 12, 0.1
    occ = np.zeros((n, n, n), np.float32)
    occ[5, 5, 5] = 1.0
    occ[0:2, 0:2, 0:2] = 1.0
    cot = np.zeros(occ.shape, np.float32)
    cot[probe] = 1.0

    def sdf_at_probe(o):
        vals, _, _ = edt.signed_field_from_masks(jnp.asarray(o) > 0.5, res, "stencil")
        return float(np.asarray(vals)[probe])

    flip = occ.copy()
    flip[5, 5, 5] = 0.0
    fd = (sdf_at_probe(flip) - sdf_at_probe(occ)) / (0.0 - 1.0)
    g = _ft_grad(occ, cot, res)[5, 5, 5]
    assert fd < 0 and g < 0
    assert 0.1 * abs(fd) < abs(g) < 10 * abs(fd)


