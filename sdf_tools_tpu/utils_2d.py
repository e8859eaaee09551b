"""Drop-in equivalent of the reference's ``sdf_tools.utils_2d``
(``/root/reference/src/sdf_tools/utils_2d.py``), backed by the JAX engine.

Axis convention preserved: ``grid_world[y, x]`` with the SDF returned as
``sdf[y, x]`` and gradients as ``grad[y, x, 2]`` (z gradient dropped).
"""
from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from .grid import CollisionMap, GridMeta, make_origin_transform
from .ops import edt, query
from .grid import SdfGrid


def compute_sdf_and_gradient(grid_world, sdf_resolution, sdf_origin, frame="world"):
    """(sdf[y,x] float32, gradient[y,x,2] float32) for a binary 2D world.

    Matches utils_2d.py:6-58: the grid is built x-major (nx = width), one z
    cell; gradients use edge gradients; the reference's oob COLLISION_CELL
    occupancy of -10000 maps to our oob value.
    """
    grid_world = np.asarray(grid_world)
    y_height, x_width = grid_world.shape
    occ = (grid_world.T == 1).astype(np.float32)[:, :, None]  # [x, y, 1]
    origin = make_origin_transform([sdf_origin[0], sdf_origin[1], 0.0])
    meta = GridMeta.create(origin, sdf_resolution, (x_width, y_height, 1), frame)
    sdf, _ = edt.extract_signed_distance_field(
        jnp.asarray(occ > 0.5), meta, oob_value=-10000.0
    )
    grad = query.full_gradient(sdf, enable_edge_gradients=True)
    np_sdf = np.asarray(sdf.values)[:, :, 0].T.astype(np.float32)  # [y, x]
    np_grad = np.asarray(grad)[:, :, 0, 0:2].transpose(1, 0, 2).astype(np.float32)
    return np_sdf, np_grad


def compute_gradient(sdf: SdfGrid):
    """Gradient of an existing 2D SdfGrid: (sdf[x,y], grad[x,y,2])."""
    grad = query.full_gradient(sdf, enable_edge_gradients=True)
    np_sdf = np.asarray(sdf.values)[:, :, 0]
    np_grad = np.asarray(grad)[:, :, 0, 0:2]
    return np_sdf, np_grad


def sdf_to_np(sdf: SdfGrid):
    return np.asarray(sdf.values)[:, :, 0]


def gradient_to_np(gradient):
    """Dense 2D gradient array -> numpy [x, y, 2] (z gradient dropped).

    Mirrors utils_2d.py:83-87; accepts the [nx, ny, 1, 3] array produced by
    ``query.full_gradient`` (the reference takes a VoxelGrid of gradients).
    """
    g = np.asarray(gradient)
    if g.ndim == 4:  # [nx, ny, nz, 3]
        g = g[:, :, 0, :]
    return g[:, :, 0:2]


def to_np(sdf: SdfGrid, gradient):
    """(sdf_to_np(sdf), gradient_to_np(gradient)) — utils_2d.py:79-80."""
    return sdf_to_np(sdf), gradient_to_np(gradient)


def grid_to_np(cmap: CollisionMap):
    return np.asarray(cmap.occupancy)[:, :, 0]
