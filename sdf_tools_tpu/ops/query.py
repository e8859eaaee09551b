"""Differentiable SDF query layer.

JAX re-design of the reference's query functions
(``/root/reference/include/sdf_tools/sdf.hpp``):

  * ``estimate_distance``: trilinear interpolation over center-corrected cell
    distances (reference ``EstimateDistanceInterpolateFromNeighbors``,
    ``sdf.hpp:903-914``; corner selection ``GetAxisInterpolationIndices``
    ``sdf.hpp:798-833``; center correction ``GetCorrectedCenterDistance``
    ``sdf.hpp:773-796``; trilinear ``sdf.hpp:745-771``). Fully batched: one
    vectorized 8-corner gather + fused trilinear math, differentiable w.r.t.
    both query points and grid values (JAX autodiff subsumes the reference's
    Eigen AutoDiffScalar path, ``sdf.hpp:613-640``).
  * ``grid_aligned_gradient`` / ``gradient``: central differences with the
    reference's edge handling (``sdf.hpp:432-526``), world-rotated
    (``sdf.hpp:405-430``).
  * ``full_gradient``: dense gradient field — replaces the reference's
    per-cell std::function loop (``sdf.hpp:341-358``) with shifted-array
    arithmetic (no N callback crossings).
  * ``smooth_gradient``: symmetric differences of estimate_distance with
    per-axis one-sided fallback (``sdf.hpp:544-598``).
  * ``distance_to_boundary`` (``sdf.hpp:963-989``).
  * ``project_out_of_collision*`` / ``project_into_valid_volume*``:
    batched gradient-ascent projection as a masked ``lax.while_loop``
    (``sdf.hpp:996-1191``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..grid import SdfGrid

Array = jax.Array


# ---------------------------------------------------------------------------
# Center-corrected trilinear distance estimate
# ---------------------------------------------------------------------------


def _flat_gather(values: Array, ix: Array, iy: Array, iz: Array) -> Array:
    """values[ix, iy, iz] via a flat 1-D gather.

    Multi-dimensional advanced indexing can lower to whole-slice
    materialization; one flat gather per query point cannot. All hot query
    paths go through here.
    """
    _, ny, nz = values.shape
    flat_idx = (ix * ny + iy) * nz + iz
    return values.reshape(-1)[flat_idx]


def corrected_center_distance(sdf: SdfGrid, ix: Array, iy: Array, iz: Array) -> Array:
    """|d| shrunk by res/2 toward the surface (reference sdf.hpp:773-796).

    Indices must be in bounds (callers clamp); matches the reference's
    protected accessor contract.
    """
    v = _flat_gather(sdf.values, ix, iy, iz)
    half = sdf.resolution * 0.5
    return jnp.where(v >= 0.0, v - half, v + half)


def _axis_interp_indices(i: Array, size: int, offset: Array) -> Tuple[Array, Array]:
    """Vectorized corner selection per axis (reference sdf.hpp:798-833)."""
    # offset >= 0 branch
    lo_p = i
    up_p = jnp.where(i + 1 >= size, i, i + 1)
    lo_p = jnp.where(i + 1 >= size, jnp.where(i - 1 < 0, i, i - 1), lo_p)
    # offset < 0 branch
    lo_n = jnp.where(i - 1 < 0, i, i - 1)
    up_n = jnp.where(i - 1 < 0, jnp.where(i + 1 >= size, i, i + 1), i)
    pos = offset >= 0.0
    return jnp.where(pos, lo_p, lo_n), jnp.where(pos, up_p, up_n)


def estimate_distance(
    sdf: SdfGrid, points: Array
) -> Tuple[Array, Array]:
    """Trilinearly-interpolated signed distance at world-frame ``points``.

    points: [..., 3] float. Returns (distance [...], in_bounds [...]).
    Out-of-bounds queries return ``sdf.oob_value`` with in_bounds=False,
    exactly like ``EstimateDistance4d`` (sdf.hpp:947-961).

    Implemented over :func:`interpolation_stencil` (ONE stacked 8-corner
    gather; the unused weight/gradient outputs are dead-code-eliminated
    under jit), so every caller — queries, march, verification tail,
    backward — shares the same gather shape.
    """
    _, _, value, _, in_bounds = interpolation_stencil(sdf, points)
    return jnp.where(in_bounds, value, sdf.oob_value.astype(value.dtype)), in_bounds


def interpolation_stencil(sdf: SdfGrid, points: Array):
    """The full trilinear stencil at ``points`` in one 8-corner gather.

    Returns (flat_idx [..., 8] int32, weights [..., 8], value [...],
    grad_grid [..., 3], in_bounds [...]): the 8 corner flat indices and
    their trilinear weights, the interpolated center-corrected distance,
    and its analytic gradient w.r.t. the grid-frame point — everything an
    IFT backward needs from ONE gather instead of re-running
    ``estimate_distance`` under jax.vjp (8 gathers) plus
    ``autodiff_gradient`` (another 8). Value and gradient are bit-identical
    to the autodiff path: d(corrected)/d(value) = 1 on both correction
    branches, and the gradient is the derivative of the same trilinear
    polynomial with corners held fixed (floor/corner selection are
    piecewise constant, zero-derivative under JAX too).
    Corner order: (m/p x)(m/p y)(m/p z), z fastest — mmm, mmp, mpm, ...
    """
    p = jnp.asarray(points)
    meta = sdf.meta
    res = sdf.resolution
    g = meta.world_to_grid(p)
    idx = jnp.floor(g / res).astype(jnp.int32)
    in_bounds = meta.index_in_bounds(idx)
    nx, ny, nz = meta.shape

    safe_idx = jnp.clip(idx, 0, jnp.asarray(meta.shape, jnp.int32) - 1)
    center = (safe_idx.astype(g.dtype) + 0.5) * res
    offset = g - center

    lx, ux = _axis_interp_indices(safe_idx[..., 0], nx, offset[..., 0])
    ly, uy = _axis_interp_indices(safe_idx[..., 1], ny, offset[..., 1])
    lz, uz = _axis_interp_indices(safe_idx[..., 2], nz, offset[..., 2])

    flat = sdf.values.reshape(-1)
    half = res * 0.5

    # ONE stacked gather for all 8 corners (8 separate 1M-index gathers
    # serialize their dispatch; a single 8M-index gather pipelines the HBM
    # transactions)
    idx8 = []
    for ix in (lx, ux):
        for iy in (ly, uy):
            for iz in (lz, uz):
                idx8.append((ix * ny + iy) * nz + iz)
    idx8s = jnp.stack(idx8, axis=-1)  # [..., 8]
    v8 = flat[idx8s]
    c8s = jnp.where(v8 >= 0.0, v8 - half, v8 + half)
    c8 = [c8s[..., k] for k in range(8)]

    inv_res = 1.0 / res
    axp = (g[..., 0] - (lx.astype(g.dtype) + 0.5) * res) * inv_res
    ayp = (g[..., 1] - (ly.astype(g.dtype) + 0.5) * res) * inv_res
    azp = (g[..., 2] - (lz.astype(g.dtype) + 0.5) * res) * inv_res
    wx = (1.0 - axp, axp)
    wy = (1.0 - ayp, ayp)
    wz = (1.0 - azp, azp)

    w8 = []
    value = jnp.zeros(g.shape[:-1], g.dtype)
    gx = jnp.zeros_like(value)
    gy = jnp.zeros_like(value)
    gz = jnp.zeros_like(value)
    k = 0
    for i in (0, 1):
        sx = 1.0 if i else -1.0
        for j in (0, 1):
            sy = 1.0 if j else -1.0
            for l in (0, 1):
                sz = 1.0 if l else -1.0
                w = wx[i] * wy[j] * wz[l]
                w8.append(w)
                c = c8[k]
                value = value + w * c
                gx = gx + sx * wy[j] * wz[l] * c
                gy = gy + wx[i] * sy * wz[l] * c
                gz = gz + wx[i] * wy[j] * sz * c
                k += 1
    grad_grid = jnp.stack([gx, gy, gz], axis=-1) * inv_res
    return (
        idx8s,
        jnp.stack(w8, axis=-1),
        value,
        grad_grid,
        in_bounds,
    )


def autodiff_gradient(sdf: SdfGrid, points: Array) -> Array:
    """d(estimate_distance)/d(world point) via JAX autodiff.

    Subsumes the reference's ``GetAutoDiffGradient`` (sdf.hpp:613-640);
    unlike the Eigen version it is also correct at cell centers.
    points: [..., 3] -> gradients [..., 3] (zeros out of bounds).
    """
    p = jnp.asarray(points)
    flat = p.reshape(-1, 3)

    def f(x):
        v, ok = estimate_distance(sdf, x)
        return v, ok

    grads, oks = jax.vmap(lambda x: jax.grad(lambda y: f(y)[0])(x))(flat), jax.vmap(
        lambda x: f(x)[1]
    )(flat)
    grads = jnp.where(oks[:, None], grads, 0.0)
    return grads.reshape(p.shape)


# ---------------------------------------------------------------------------
# Grid gradients
# ---------------------------------------------------------------------------


def grid_aligned_gradient(
    sdf: SdfGrid, indices: Array, enable_edge_gradients: bool = False
) -> Tuple[Array, Array]:
    """Finite-difference gradient at integer cell ``indices`` [..., 3].

    Matches ``GetGridAlignedGradient`` (sdf.hpp:432-526): central differences
    /(2 res) for interior cells; with ``enable_edge_gradients``, one-sided
    clamped differences on edges (zero where the axis has one cell). Returns
    (gradient [..., 3], valid [...]) where valid=False means the reference
    would have returned an empty vector.
    """
    idx = jnp.asarray(indices)
    meta = sdf.meta
    res = sdf.resolution
    shape = jnp.asarray(meta.shape, jnp.int32)
    in_bounds = meta.index_in_bounds(idx)
    interior = jnp.all((idx > 0) & (idx < shape - 1), axis=-1)

    ci = jnp.clip(idx, 0, shape - 1)
    lo = jnp.maximum(ci - 1, 0)
    hi = jnp.minimum(ci + 1, shape - 1)

    def val(x, y, z):
        return _flat_gather(sdf.values, x, y, z)

    x, y, z = ci[..., 0], ci[..., 1], ci[..., 2]
    incr = (hi - lo).astype(sdf.values.dtype) * res  # per-axis span
    gx = jnp.where(
        incr[..., 0] > 0,
        (val(hi[..., 0], y, z) - val(lo[..., 0], y, z)) / jnp.maximum(incr[..., 0], res),
        0.0,
    )
    gy = jnp.where(
        incr[..., 1] > 0,
        (val(x, hi[..., 1], z) - val(x, lo[..., 1], z)) / jnp.maximum(incr[..., 1], res),
        0.0,
    )
    gz = jnp.where(
        incr[..., 2] > 0,
        (val(x, y, hi[..., 2]) - val(x, y, lo[..., 2])) / jnp.maximum(incr[..., 2], res),
        0.0,
    )
    grad = jnp.stack([gx, gy, gz], axis=-1)
    valid = in_bounds & (interior | enable_edge_gradients)
    return jnp.where(valid[..., None], grad, 0.0), valid


def gradient(
    sdf: SdfGrid, indices: Array, enable_edge_gradients: bool = False
) -> Tuple[Array, Array]:
    """Grid-aligned gradient rotated into the world frame (sdf.hpp:405-430)."""
    g, valid = grid_aligned_gradient(sdf, indices, enable_edge_gradients)
    from ..grid import rotate_points

    return rotate_points(sdf.meta.origin_transform[:3, :3], g), valid


def full_gradient(
    sdf: SdfGrid,
    enable_edge_gradients: bool = True,
    gradient_function=None,
) -> Array:
    """Dense world-frame gradient field [nx, ny, nz, 3].

    Replaces ``GetFullGradient`` (sdf.hpp:341-358) — the reference calls a
    std::function per cell; here the whole field is three shifted-array
    subtractions. Cells the reference would give "no gradient" (edges with
    enable_edge_gradients=False) get zeros.

    ``gradient_function``: optional user rule, mirroring the reference's
    arbitrary ``GradientFunction`` parameter. Called as
    ``gradient_function(sdf, indices, enable_edge_gradients)`` with the dense
    [nx, ny, nz, 3] integer index grid; must return [nx, ny, nz, 3]
    world-frame gradients (batched — the JAX analogue of the
    reference's per-cell callback). None -> the built-in finite-difference
    rule below (the only rule the reference ecosystem ever passes).
    """
    if gradient_function is not None:
        nx, ny, nz = sdf.shape
        ix = jnp.arange(nx, dtype=jnp.int32)[:, None, None]
        iy = jnp.arange(ny, dtype=jnp.int32)[None, :, None]
        iz = jnp.arange(nz, dtype=jnp.int32)[None, None, :]
        idx = jnp.stack(jnp.broadcast_arrays(ix, iy, iz), axis=-1)
        return gradient_function(sdf, idx, enable_edge_gradients)
    v = sdf.values
    res = sdf.resolution

    def axis_grad(ax):
        n = v.shape[ax]
        if n == 1:
            return jnp.zeros_like(v)
        lo = jnp.concatenate(
            [lax.slice_in_dim(v, 0, 1, axis=ax), lax.slice_in_dim(v, 0, n - 1, axis=ax)],
            axis=ax,
        )
        hi = jnp.concatenate(
            [lax.slice_in_dim(v, 1, n, axis=ax), lax.slice_in_dim(v, n - 1, n, axis=ax)],
            axis=ax,
        )
        # interior: span 2*res; edges: span res (one-sided)
        span = jnp.full(v.shape, 2.0 * res)
        edge = jnp.zeros(v.shape, bool)
        edge = edge.at[tuple(0 if a == ax else slice(None) for a in range(3))].set(True)
        edge = edge.at[tuple(n - 1 if a == ax else slice(None) for a in range(3))].set(True)
        span = jnp.where(edge, res, span)
        g = (hi - lo) / span
        if not enable_edge_gradients:
            g = jnp.where(edge, 0.0, g)
        return g

    grid_grad = jnp.stack([axis_grad(0), axis_grad(1), axis_grad(2)], axis=-1)
    if not enable_edge_gradients:
        # reference: any-axis edge cell -> no gradient at all
        nx, ny, nz = v.shape
        ix = jnp.arange(nx)[:, None, None]
        iy = jnp.arange(ny)[None, :, None]
        iz = jnp.arange(nz)[None, None, :]
        interior = (
            (ix > 0) & (ix < nx - 1) & (iy > 0) & (iy < ny - 1) & (iz > 0) & (iz < nz - 1)
        )
        grid_grad = jnp.where(interior[..., None], grid_grad, 0.0)
    from ..grid import rotate_points

    return rotate_points(sdf.meta.origin_transform[:3, :3], grid_grad)


def smooth_gradient(sdf: SdfGrid, points: Array, nominal_window_size) -> Tuple[Array, Array]:
    """Symmetric finite differences of estimate_distance over a window.

    Matches ``GetSmoothGradient`` (sdf.hpp:544-598) with the per-axis
    central/one-sided fallback of ``ComputeAxisSmoothGradient``
    (sdf.hpp:656-697). Returns (gradient [..., 3], valid [...]); valid=False
    where the reference would throw (window unusable on some axis) or the
    point is out of bounds.
    """
    p = jnp.asarray(points)
    w = jnp.abs(jnp.asarray(nominal_window_size, p.dtype))
    v0, ok0 = estimate_distance(sdf, p)
    axes = []
    ok_all = ok0
    for ax in range(3):
        e = jnp.zeros((3,), p.dtype).at[ax].set(1.0)
        vm, okm = estimate_distance(sdf, p - w * e)
        vp, okp = estimate_distance(sdf, p + w * e)
        central = (vp - vm) / (2.0 * w)
        fwd = (vp - v0) / w
        bwd = (v0 - vm) / w
        g = jnp.where(
            okm & okp, central, jnp.where(okm, bwd, jnp.where(okp, fwd, 0.0))
        )
        axes.append(g)
        ok_all = ok_all & (okm | okp)
    return jnp.stack(axes, axis=-1), ok_all


# ---------------------------------------------------------------------------
# Boundary distance
# ---------------------------------------------------------------------------


def distance_to_boundary(sdf: SdfGrid, points: Array) -> Tuple[Array, Array]:
    """Min axis-aligned signed displacement to the grid boundary (sdf.hpp:976-989).

    Returns (signed displacement, inside?) — negative when outside.
    """
    p = jnp.asarray(points)
    g = sdf.meta.world_to_grid(p)
    sizes = sdf.meta.sizes.astype(g.dtype)
    disp = jnp.minimum(g, sizes - g)  # [..., 3]
    inside = jnp.all(disp >= 0.0, axis=-1)
    amin = jnp.argmin(jnp.abs(disp), axis=-1)
    val = jnp.take_along_axis(disp, amin[..., None], axis=-1)[..., 0]
    return val, inside


# ---------------------------------------------------------------------------
# Projection ops
# ---------------------------------------------------------------------------


def project_into_valid_volume(
    sdf: SdfGrid, points: Array, minimum_distance=0.0
) -> Array:
    """Clamp world points into the grid volume (sdf.hpp:1162-1191)."""
    p = jnp.asarray(points)
    g = sdf.meta.world_to_grid(p)
    margin = jnp.asarray(minimum_distance, g.dtype) + sdf.resolution * 1e-4
    sizes = sdf.meta.sizes.astype(g.dtype)
    clamped = jnp.clip(g, margin, sizes - margin)
    changed = jnp.any(clamped != g, axis=-1, keepdims=True)
    out = sdf.meta.grid_to_world(clamped)
    return jnp.where(changed, out, p)


def project_out_of_collision(
    sdf: SdfGrid,
    points: Array,
    minimum_distance=0.0,
    stepsize_multiplier: float = 1.0 / 8.0,
    max_steps: int = 1000,
) -> Tuple[Array, Array]:
    """Gradient-ascent projection to >= minimum_distance (sdf.hpp:1041-1122).

    Batched masked while_loop; each point steps along the normalized
    grid-aligned gradient by min(max_step, needed) until its interpolated
    distance exceeds ``minimum_distance``. Where the reference throws (flat
    or invalid gradient), we freeze the point and report success=False.

    Returns (projected points [..., 3], success [...]).
    """
    p0 = jnp.asarray(points)
    flat = p0.reshape(-1, 3)
    meta = sdf.meta
    res = sdf.resolution
    min_dist = jnp.asarray(minimum_distance, flat.dtype)
    margin = min_dist + res * stepsize_multiplier * 1e-4
    max_step = res * stepsize_multiplier

    # move OOB points into the volume first (sdf.hpp:1052-1055)
    start = project_into_valid_volume(sdf, flat)
    g0 = meta.world_to_grid(start)

    def grid_est(gpts):
        # estimate_distance on grid-frame points (skip the world transform)
        wpts = meta.grid_to_world(gpts)
        return estimate_distance(sdf, wpts)

    def cond(state):
        g, stuck, steps = state
        d, _ = grid_est(g)
        active = (d <= min_dist) & ~stuck
        return jnp.logical_and(jnp.any(active), steps < max_steps)

    def body(state):
        g, stuck, steps = state
        d, _ = grid_est(g)
        active = (d <= min_dist) & ~stuck
        idx = jnp.floor(g / res).astype(jnp.int32)
        grad, gvalid = grid_aligned_gradient(sdf, idx, enable_edge_gradients=True)
        norm = jnp.linalg.norm(grad, axis=-1)
        ok = gvalid & (norm > res * 0.25)
        step = jnp.minimum(max_step, margin - d)
        direction = grad / jnp.maximum(norm, 1e-30)[..., None]
        new_g = jnp.where((active & ok)[..., None], g + direction * step[..., None], g)
        new_stuck = stuck | (active & ~ok)
        return new_g, new_stuck, steps + 1

    stuck0 = jnp.zeros(flat.shape[:1], bool)
    gf, stuck, _ = lax.while_loop(cond, body, (g0, stuck0, jnp.int32(0)))
    d_final, _ = grid_est(gf)
    success = (d_final > min_dist) & ~stuck
    out = meta.grid_to_world(gf)
    return out.reshape(p0.shape), success.reshape(p0.shape[:-1])
