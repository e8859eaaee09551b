"""Differentiability bridges for non-differentiable stages.

The exact EDT is piecewise constant w.r.t. occupancy (flipping a cell moves
the field in discrete jumps), so gradients cannot flow through it natively.
``sdf_from_occupancy_st`` provides a straight-through surrogate so render /
distance losses can still shape occupancy (BASELINE: "pixel gradients flow
back to voxel occupancy"):

  forward:  hard two-field EDT of (occupancy > 0.5) — exact, same cells as
            the reference pipeline.
  backward: d(sdf[i])/d(occ[i]) = -2 * resolution on the diagonal. Rationale:
            flipping cell i from free (value >= +res) to filled (value <=
            -res) changes its own value by at least -2*res; the surrogate
            uses that slope everywhere, which empirically matches the sign
            and scale of one-cell finite differences near the surface where
            the gradient actually matters.

``sdf_from_occupancy_ft`` is the sharper feature-transform surrogate: the
TRUE sensitivity of sdf[i] lives at i's nearest opposite-side cell (remove
the nearest filled cell and a free cell's distance grows; fill the nearest
free cell and a filled cell sinks deeper), so the backward routes each
cell's cotangent to its EDT feature (closest-point map, ops/feature.py)
with the same -2*resolution slope. The diagonal ST predicts exactly zero
for these cross terms.
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp

from . import edt


@partial(jax.custom_vjp, nondiff_argnums=(2,))
def sdf_from_occupancy_st(occupancy, resolution, backend: str = "auto"):
    """Signed distance values from an occupancy grid, straight-through diff."""
    mask = occupancy > 0.5
    values, _, _ = edt.signed_field_from_masks(mask, resolution, backend=backend)
    return values


def _st_fwd(occupancy, resolution, backend):
    values = sdf_from_occupancy_st(occupancy, resolution, backend)
    return values, (resolution,)


def _st_bwd(backend, residuals, g):
    (resolution,) = residuals
    d_occ = g * (-2.0 * resolution)
    return d_occ, None


sdf_from_occupancy_st.defvjp(_st_fwd, _st_bwd)


@partial(jax.custom_vjp, nondiff_argnums=(2,))
def sdf_from_occupancy_ft(occupancy, resolution, backend: str = "auto"):
    """Signed distance values from occupancy; feature-routed backward.

    Forward identical to :func:`sdf_from_occupancy_st`. Backward scatters
    each cell's cotangent onto its nearest OPPOSITE-side cell (the EDT
    feature): free cells route to their nearest filled cell, filled cells
    to their nearest free cell, slope -2*resolution. Exact one-cell finite
    differences have this off-diagonal structure; the diagonal ST misses it
    entirely (tests/test_diff.py::test_ft_surrogate_matches_fd_cross_terms).
    """
    mask = occupancy > 0.5
    values, _, _ = edt.signed_field_from_masks(mask, resolution, backend=backend)
    return values


_FT_NATIVE_BACKENDS = ("auto", "pallas", "stencil")


def _features(mask):
    """(d2_filled, d2_free, flat, valid): both exact EDTs, each cell's
    opposite-side feature as a flat index, and whether it has one."""
    from . import feature

    nx, ny, nz = mask.shape
    d2_filled, feat_filled = feature.feature_transform(mask)
    d2_free, feat_free = feature.feature_transform(~mask)
    free_cell = ~mask
    # free cells' features live in the FILLED transform and vice versa
    feat = jnp.where(free_cell[..., None], feat_filled, feat_free)
    flat = (feat[..., 0] * ny + feat[..., 1]) * nz + feat[..., 2]
    valid = jnp.where(free_cell, d2_filled, d2_free) < jnp.int32(edt.INF_D2)
    return d2_filled, d2_free, flat, valid


def _ft_fwd(occupancy, resolution, backend):
    mask = occupancy > 0.5
    resolution = jnp.asarray(resolution)
    if backend in _FT_NATIVE_BACKENDS:
        # the d^2 of the feature transform IS the exact EDT, so the signed
        # values come from the same arrays (no duplicate EDT in the grad path)
        d2_filled, d2_free, flat, valid = _features(mask)
        values = edt.d2_to_distance(d2_filled, resolution) - edt.d2_to_distance(
            d2_free, resolution
        )
        return values, (flat, valid, resolution)
    # other backends (reference, scan, brute): preserve their forward values
    # exactly; the backward recomputes the features
    values = sdf_from_occupancy_ft(occupancy, resolution, backend)
    return values, (mask, resolution)


def _ft_bwd(backend, residuals, g):
    """Route each cell's cotangent (slope -2*resolution) onto its feature
    with one float scatter-add: on the GPU its atomics sum in a
    run-dependent order, so the result can differ in the last bits."""
    if backend in _FT_NATIVE_BACKENDS:
        flat, valid, resolution = residuals
    else:
        mask, resolution = residuals
        _, _, flat, valid = _features(mask)
    contrib = jnp.where(valid, g * (-2.0 * resolution), 0.0)
    d_occ = (
        jnp.zeros(flat.size, g.dtype)
        .at[flat.reshape(-1)]
        .add(contrib.reshape(-1), mode="drop")
        .reshape(g.shape)
    )
    return d_occ, None


sdf_from_occupancy_ft.defvjp(_ft_fwd, _ft_bwd)


def straight_through_sdf(forward_fn: Callable, resolution):
    """Wrap an arbitrary occupancy->sdf forward with the same ST backward.

    Used by the sharded pipeline where the forward contains collectives.
    """

    @jax.custom_vjp
    def f(occ):
        return forward_fn(occ)

    def fwd(occ):
        return forward_fn(occ), None

    def bwd(_, g):
        return (g * (-2.0 * jnp.asarray(resolution)),)

    f.defvjp(fwd, bwd)
    return f
