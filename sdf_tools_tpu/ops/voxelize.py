"""Voxelization: pointclouds and images -> occupancy grids.

Replaces the reference's Python scatter loop
(``/root/reference/scripts/3d_sdf_demo_rviz.py:22-29``:
``floor((p - origin)/res)`` then per-point assignment) with vectorized
scatter ops, plus differentiable soft variants so gradients can flow from
SDF/render losses back to point positions (BASELINE north star).
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..grid import GridMeta

Array = jax.Array


def voxelize_points(points: Array, meta: GridMeta, weights: Array | None = None) -> Array:
    """Hard-scatter points into a binary occupancy grid [nx, ny, nz] f32.

    Points outside the grid are dropped (reference demo clips the same way).
    """
    p = jnp.asarray(points)
    idx = meta.location_to_index(p)  # floor((world->grid)/res)
    in_bounds = meta.index_in_bounds(idx)
    nx, ny, nz = meta.shape
    # flat scatter (1-D indexing); OOB -> dropped
    flat_idx = (idx[..., 0] * ny + idx[..., 1]) * nz + idx[..., 2]
    flat_idx = jnp.where(in_bounds, flat_idx, -1)
    occ = jnp.zeros(nx * ny * nz, jnp.float32)
    w = jnp.ones(p.shape[:-1], jnp.float32) if weights is None else jnp.asarray(weights)
    occ = occ.at[flat_idx].max(w, mode="drop")
    return occ.reshape(meta.shape)


def soft_voxelize_points(points: Array, meta: GridMeta, temperature: float = 1.0) -> Array:
    """Differentiable trilinear point splatting -> soft occupancy in [0, 1].

    Each point deposits trilinear weights onto its 8 surrounding cell
    centers; per-cell mass is squashed with ``1 - exp(-mass/temperature)``
    (smooth, saturating, monotone — gradient flows to point positions).
    ``occupancy > 0.5`` then thresholds to the same cells as
    :func:`voxelize_points` for points near cell centers.
    """
    p = jnp.asarray(points)
    res = meta.resolution
    g = meta.world_to_grid(p) / res - 0.5  # continuous cell-center coords
    base = jnp.floor(g)
    frac = g - base
    base = base.astype(jnp.int32)
    nx, ny, nz = meta.shape
    occ = jnp.zeros(nx * ny * nz, jnp.float32)
    shape_arr = jnp.asarray(meta.shape, jnp.int32)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                corner = base + jnp.asarray([dx, dy, dz], jnp.int32)
                w = (
                    (frac[..., 0] if dx else 1.0 - frac[..., 0])
                    * (frac[..., 1] if dy else 1.0 - frac[..., 1])
                    * (frac[..., 2] if dz else 1.0 - frac[..., 2])
                )
                ok = jnp.all((corner >= 0) & (corner < shape_arr), axis=-1)
                flat_idx = (corner[..., 0] * ny + corner[..., 1]) * nz + corner[..., 2]
                flat_idx = jnp.where(ok, flat_idx, -1)
                occ = occ.at[flat_idx].add(jnp.where(ok, w, 0.0), mode="drop")
    occ = occ.reshape(meta.shape)
    return 1.0 - jnp.exp(-occ / temperature)


@jax.jit
def _mesh_parity_batch(v0, v1, v2, cx, cy, nz: Array, res, counts):
    """Accumulate per-column crossing-bucket parity counts for one triangle
    batch. v0/v1/v2: [B, 3] triangle vertices in GRID frame; cx/cy: [nx],
    [ny] cell-center xy in grid frame; counts: [nx, ny, nz] int32 running
    count of crossings ABOVE each cell center."""
    px = cx[None, :, None]  # [1, nx, 1]
    py = cy[None, None, :]  # [1, 1, ny]

    def edge(ax, ay, bx, by):
        # 2D edge function of (p - a) x (b - a); sign = side of edge
        return (bx - ax) * (py - ay) - (by - ay) * (px - ax)

    e0 = edge(v0[:, 0, None, None], v0[:, 1, None, None],
              v1[:, 0, None, None], v1[:, 1, None, None])
    e1 = edge(v1[:, 0, None, None], v1[:, 1, None, None],
              v2[:, 0, None, None], v2[:, 1, None, None])
    e2 = edge(v2[:, 0, None, None], v2[:, 1, None, None],
              v0[:, 0, None, None], v0[:, 1, None, None])
    denom = (
        (v1[:, 0] - v0[:, 0]) * (v2[:, 1] - v0[:, 1])
        - (v1[:, 1] - v0[:, 1]) * (v2[:, 0] - v0[:, 0])
    )[:, None, None]  # 2x signed projected area
    pos = (e0 > 0) & (e1 > 0) & (e2 > 0)
    neg = (e0 < 0) & (e1 < 0) & (e2 < 0)
    inside = (pos | neg) & (jnp.abs(denom) > 1e-12)  # vertical tris skipped
    safe = jnp.where(jnp.abs(denom) > 1e-12, denom, 1.0)
    # barycentric z of the vertical-ray crossing (w_i opposite vertex i)
    w0 = e1 / safe
    w1 = e2 / safe
    w2 = e0 / safe
    zc = (
        w0 * v0[:, 2, None, None]
        + w1 * v1[:, 2, None, None]
        + w2 * v2[:, 2, None, None]
    )
    # number of cell centers (z = (iz + 0.5) res) strictly below the crossing
    k = jnp.clip(jnp.ceil(zc / res - 0.5), 0, nz).astype(jnp.int32)
    k = jnp.where(inside, k, -1)  # dropped by the scatter
    nx_, ny_ = k.shape[1], k.shape[2]
    colbase = (jnp.arange(nx_)[:, None] * ny_ + jnp.arange(ny_)[None, :]) * (
        counts.shape[-1] + 1
    )
    flat = jnp.where(k >= 0, colbase[None] + k, -1).reshape(-1)
    hist = jnp.zeros(nx_ * ny_ * (counts.shape[-1] + 1), jnp.int32)
    hist = hist.at[flat].add(1, mode="drop")
    hist = hist.reshape(nx_, ny_, counts.shape[-1] + 1)
    # crossings above center iz = those with k > iz: reverse cumsum of
    # hist[..., iz+1:]
    above = jnp.cumsum(hist[..., ::-1], axis=-1)[..., ::-1]
    return counts + above[..., 1:]


def mesh_to_occupancy(
    vertices, faces, meta: GridMeta, batch: int = 256
) -> Array:
    """Solid-voxelize a watertight triangle mesh: occupancy [nx, ny, nz] f32.

    JAX replacement for the last ingestion path of the reference's
    ``SDF_Builder`` (arbitrary MoveIt collision meshes voxelized by per-voxel
    ``checkCollision``, ``sdf_builder.cpp:339-358``): point-in-mesh by RAY
    PARITY, fully vectorized — for every (x, y) column of cell centers, each
    triangle's vertical-ray crossing is rasterized with 2D edge functions
    and bucketed per z cell; a cell is filled iff the number of crossings
    above its center is odd. Work is O(T * nx * ny) elementwise + one flat
    scatter-add per triangle batch (no per-voxel collision queries).

    Cell centers are offset by an irrational epsilon (~1e-4 res) in x/y so
    exact edge/vertex ray hits — where parity is ambiguous — have measure
    zero for real meshes.
    """
    verts = jnp.asarray(vertices, jnp.float32)
    tris = jnp.asarray(faces, jnp.int32)
    if verts.ndim != 2 or verts.shape[-1] != 3:
        raise ValueError(f"vertices must be [V, 3], got {verts.shape}")
    if tris.ndim != 2 or tris.shape[-1] != 3:
        raise ValueError(f"faces must be [T, 3], got {tris.shape}")
    nx, ny, nz = meta.shape
    res = float(meta.resolution)
    # grid-frame geometry: the parity ray runs along the grid z axis
    vg = meta.world_to_grid(verts)
    cx = (jnp.arange(nx, dtype=jnp.float32) + 0.5) * res + 1.23456789e-4 * res
    cy = (jnp.arange(ny, dtype=jnp.float32) + 0.5) * res + 2.34567891e-4 * res

    T = tris.shape[0]
    pad = (-T) % batch
    if pad:
        tris = jnp.concatenate([tris, jnp.zeros((pad, 3), jnp.int32)], axis=0)
    counts = jnp.zeros((nx, ny, nz), jnp.int32)
    for i in range(0, T + pad, batch):
        f = tris[i : i + batch]
        v0, v1, v2 = vg[f[:, 0]], vg[f[:, 1]], vg[f[:, 2]]
        # padded faces are (0,0,0) -> degenerate -> denom 0 -> skipped
        counts = _mesh_parity_batch(
            v0, v1, v2, cx, cy, jnp.int32(nz), jnp.float32(res), counts
        )
    return (counts % 2 == 1).astype(jnp.float32)


def image_to_occupancy(image: Array, threshold: float = 0.5) -> Array:
    """Binary image [h, w] (row=y, col=x) -> occupancy [nx=w, ny=h, nz=1].

    Follows the utils_2d axis convention
    (``/root/reference/src/sdf_tools/utils_2d.py:30-36``): image[y, x] == 1
    marks grid cell (x, y) filled.
    """
    img = jnp.asarray(image)
    occ2d = (img > threshold).astype(jnp.float32).T  # [w, h]
    return occ2d[:, :, None]
