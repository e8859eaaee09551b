"""Feature transform: per-cell closest seed (argmin) of the exact EDT.

The reference keeps a ``closest_point`` per cell inside its propagation
state (``sdf_generation.hpp:19-27`` bucket_cell); our separable EDT does not
need one for distances, but the OCCUPANCY-GRADIENT surrogate does
(``ops/diff.py``): the true sensitivity of sdf[i] to occupancy lives at i's
nearest opposite-side cell, which is exactly the feature.

Implementation: the x line pass records the winning seed x directly from
the two prefix scans; the y/z envelope passes run the same odd-weight
3-tap relaxation as `edt.envelope_pass_stencil` but carry (d^2, argmin)
pairs — the select that updates d^2 also selects which neighbor's winner to
inherit. Ties pick an arbitrary valid winner (any closest point is
correct). Winners compose across passes with flat gathers.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from . import edt

Array = jax.Array


def _line_seed_x(mask: Array) -> Tuple[Array, Array]:
    """(d, x0): per cell, distance along x to the nearest seed in its line
    and that seed's x index (sentinel d when the line has no seed)."""
    mask = jnp.asarray(mask, bool)
    n = mask.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32).reshape(n, 1, 1)
    NEG = jnp.int32(-(1 << 30))
    last_seed = lax.cummax(jnp.where(mask, iota, NEG), axis=0)
    fwd = iota - last_seed
    next_seed = -lax.cummax(jnp.where(mask, -iota, NEG), axis=0, reverse=True)
    bwd = next_seed - iota
    d = jnp.minimum(fwd, bwd)
    x0 = jnp.where(fwd <= bwd, last_seed, next_seed)
    no_seed = d >= jnp.int32(1 << 24)
    d = jnp.minimum(d, jnp.int32(1 << 24))
    x0 = jnp.where(no_seed, jnp.int32(0), x0)
    return d, x0


def _envelope_argmin(f: Array, axis: int) -> Tuple[Array, Array]:
    """(out, j): exact envelope min_j f[j]+(i-j)^2 along ``axis`` plus the
    winning j per cell (paired odd-weight relaxation)."""
    n = f.shape[axis]
    j0 = lax.broadcasted_iota(jnp.int32, f.shape, axis)
    if n == 1:
        return f, j0

    INF = jnp.int32(edt.INF_D2)

    def shift(a, s, fill):
        return edt._shift_with_inf(a, axis, s) if fill is None else _shift_fill(a, axis, s, fill)

    def _shift_fill(a, ax, s, fill):
        pad_lo = max(s, 0)
        pad_hi = max(-s, 0)
        padded = jnp.pad(
            a,
            [(pad_lo, pad_hi) if k == ax else (0, 0) for k in range(a.ndim)],
            constant_values=fill,
        )
        start = [pad_hi if k == ax else 0 for k in range(a.ndim)]
        return lax.dynamic_slice(padded, start, a.shape)

    def cond(state):
        d, j, t, done = state
        return jnp.logical_and(~done, t <= n - 1)

    def body(state):
        d, j, t, _ = state
        c = 2 * t - 1
        up_d = edt._shift_with_inf(d, axis, 1)
        dn_d = edt._shift_with_inf(d, axis, -1)
        up_j = _shift_fill(j, axis, 1, 0)
        dn_j = _shift_fill(j, axis, -1, 0)
        cand_d = jnp.minimum(up_d, dn_d) + c
        cand_j = jnp.where(up_d <= dn_d, up_j, dn_j)
        new_d = jnp.minimum(d, cand_d)
        new_j = jnp.where(cand_d < d, cand_j, j)
        done = jnp.all(new_d == d)
        return new_d, new_j, t + 1, done

    d0 = jnp.asarray(f, jnp.int32)
    done0 = jnp.all(d0 != d0)
    out, j, _, _ = lax.while_loop(cond, body, (d0, j0, jnp.int32(1), done0))
    return out, j


def feature_transform(seed_mask: Array) -> Tuple[Array, Array]:
    """(d2, feat): exact squared EDT + closest-seed index map [..., 3].

    ``feat[x,y,z]`` is an index triple of a nearest seed cell (exact
    distance; ties arbitrary). Cells in a seedless volume get (0,0,0) with
    d2 >= INF_D2.
    """
    mask = jnp.asarray(seed_mask, bool)
    if mask.ndim != 3:
        raise ValueError(f"expected 3D mask, got {mask.shape}")
    nx, ny, nz = mask.shape
    d, x0 = _line_seed_x(mask)
    no_seed = d >= jnp.int32(1 << 24)
    f = jnp.where(no_seed, jnp.int32(edt.INF_D2), d * d).astype(jnp.int32)

    f, jy = _envelope_argmin(f, 1)
    f, jz = _envelope_argmin(f, 2)

    # compose winners: z winner k*, then the y winner AT (x, y, k*), then
    # the line seed AT (x, jy*, k*) — flat gathers
    ix = lax.broadcasted_iota(jnp.int32, mask.shape, 0)
    iy = lax.broadcasted_iota(jnp.int32, mask.shape, 1)
    kz = jz
    jy_flat = jy.reshape(-1)
    flat_y = (ix * ny + iy) * nz + kz
    jy_star = jy_flat[flat_y.reshape(-1)].reshape(mask.shape)
    x0_flat = x0.reshape(-1)
    flat_x = (ix * ny + jy_star) * nz + kz
    x_star = x0_flat[flat_x.reshape(-1)].reshape(mask.shape)
    feat = jnp.stack([x_star, jy_star, kz], axis=-1)
    return f, feat
