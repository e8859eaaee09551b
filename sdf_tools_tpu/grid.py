"""Voxel-grid containers as JAX pytrees.

JAX replacement for the reference's ``VoxelGrid<T>`` class hierarchy
(``arc_utilities/voxel_grid.hpp`` consumed via
``/root/reference/include/sdf_tools/sdf.hpp:12``): instead of mutable C++
objects we use frozen dataclass pytrees wrapping dense ``jnp`` arrays plus
static geometric metadata, so every op is jit/vmap/shard-able.

Conventions (matching the reference):
  * values array has shape ``[nx, ny, nz]`` (x-major like the reference's
    flat layout ``x*stride1 + y*stride2 + z``; see
    ``/root/reference/src/sdf_tools/utils_3d.py:71-75``).
  * Cell centers: ``GridIndexToLocation`` of index ``i`` is
    ``origin_transform @ ((i + 0.5) * resolution)``
    (grid frame = origin_transform^-1 * world).
  * ``LocationToGridIndex`` floors the grid-frame coordinate / resolution.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Tuple

import jax
import jax.numpy as jnp
import numpy as np

Array = Any


def _pytree_dataclass(cls):
    """Register a dataclass as a JAX pytree; fields named in META_FIELDS are static."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    meta = getattr(cls, "META_FIELDS", ())
    data_fields = [f.name for f in dataclasses.fields(cls) if f.name not in meta]

    def flatten(obj):
        children = tuple(getattr(obj, n) for n in data_fields)
        aux = tuple(getattr(obj, n) for n in meta)
        return children, aux

    def unflatten(aux, children):
        kwargs = dict(zip(data_fields, children))
        kwargs.update(dict(zip(meta, aux)))
        return cls(**kwargs)

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)
    return cls


def make_origin_transform(translation, rotation=None, dtype=jnp.float32) -> Array:
    """Build a 4x4 origin transform from a translation (and optional 3x3 rotation)."""
    t = jnp.asarray(translation, dtype)
    m = jnp.eye(4, dtype=dtype)
    if rotation is not None:
        m = m.at[:3, :3].set(jnp.asarray(rotation, dtype))
    m = m.at[:3, 3].set(t)
    return m


def rotate_points(rot: Array, p: Array) -> Array:
    """p @ rot.T for [..., 3] points WITHOUT a matmul: at the default matmul
    precision a GPU may run an f32 matmul in TF32 (10 mantissa bits), which
    displaces far ray points and flips hit/miss decisions at surfaces.
    Explicit elementwise math always runs in full f32."""
    rot = rot.astype(p.dtype)
    return jnp.stack(
        [
            p[..., 0] * rot[0, 0] + p[..., 1] * rot[0, 1] + p[..., 2] * rot[0, 2],
            p[..., 0] * rot[1, 0] + p[..., 1] * rot[1, 1] + p[..., 2] * rot[1, 2],
            p[..., 0] * rot[2, 0] + p[..., 1] * rot[2, 1] + p[..., 2] * rot[2, 2],
        ],
        axis=-1,
    )


def invert_isometry(m: Array) -> Array:
    """Invert a rigid 4x4 transform: inv([R t]) = [R^T, -R^T t]."""
    r = m[:3, :3]
    t = m[:3, 3]
    inv = jnp.eye(4, dtype=m.dtype)
    inv = inv.at[:3, :3].set(r.T)
    inv = inv.at[:3, 3].set(-rotate_points(r.T, t))
    return inv


@_pytree_dataclass
class GridMeta:
    """Static+geometric metadata shared by every grid type.

    Mirrors the reference VoxelGrid geometry state
    (``/root/reference/include/sdf_tools/sdf.hpp:138-331``): origin transform,
    its inverse, uniform resolution, cell counts, and frame name.
    ``shape`` and ``frame`` are static (hashable) so jit caches per-geometry.
    """

    META_FIELDS = ("shape", "frame")

    origin_transform: Array  # [4,4]
    inv_origin_transform: Array  # [4,4]
    resolution: Array  # scalar f32
    shape: Tuple[int, int, int]
    frame: str

    @staticmethod
    def create(origin_transform, resolution, shape, frame="world") -> "GridMeta":
        m = jnp.asarray(origin_transform, jnp.float32)
        return GridMeta(
            origin_transform=m,
            inv_origin_transform=invert_isometry(m),
            resolution=jnp.asarray(resolution, jnp.float32),
            shape=tuple(int(s) for s in shape),
            frame=frame,
        )

    # ---- coordinate transforms (reference sdf.hpp:138-331 semantics) ----

    def world_to_grid(self, points: Array) -> Array:
        """World-frame points [..., 3] -> grid-frame coordinates [..., 3]."""
        p = jnp.asarray(points)
        r = self.inv_origin_transform[:3, :3]
        t = self.inv_origin_transform[:3, 3].astype(p.dtype)
        return rotate_points(r, p) + t

    def grid_to_world(self, points: Array) -> Array:
        """Grid-frame coordinates [..., 3] -> world-frame points [..., 3]."""
        p = jnp.asarray(points)
        r = self.origin_transform[:3, :3]
        t = self.origin_transform[:3, 3].astype(p.dtype)
        return rotate_points(r, p) + t

    def location_to_index(self, points: Array) -> Array:
        """World points [..., 3] -> integer grid indices [..., 3] (floor)."""
        g = self.world_to_grid(points)
        return jnp.floor(g / self.resolution).astype(jnp.int32)

    def index_to_location_grid_frame(self, indices: Array) -> Array:
        """Integer indices [..., 3] -> grid-frame cell-center coordinates."""
        i = jnp.asarray(indices)
        return (i.astype(jnp.float32) + 0.5) * self.resolution

    def index_to_location(self, indices: Array) -> Array:
        """Integer indices [..., 3] -> world-frame cell-center locations."""
        return self.grid_to_world(self.index_to_location_grid_frame(indices))

    def index_in_bounds(self, indices: Array) -> Array:
        i = jnp.asarray(indices)
        shape = jnp.asarray(self.shape, i.dtype)
        return jnp.all((i >= 0) & (i < shape), axis=-1)

    def location_in_bounds(self, points: Array) -> Array:
        return self.index_in_bounds(self.location_to_index(points))

    @property
    def sizes(self) -> Array:
        """Grid extents in meters per axis, [3]."""
        return jnp.asarray(self.shape, jnp.float32) * self.resolution


@_pytree_dataclass
class SdfGrid:
    """A signed distance field: f32 values + metadata.

    JAX analogue of ``sdf_tools::SignedDistanceField``
    (``/root/reference/include/sdf_tools/sdf.hpp:20``). ``values[x, y, z]``
    is the signed distance (meters) at the cell center; positive outside
    obstacles, negative inside (filled cells are at most ``-resolution``
    by construction of the two-field EDT, see ops/edt.py).
    """

    META_FIELDS = ("meta_static",)

    values: Array  # [nx, ny, nz] f32
    meta: GridMeta
    oob_value: Array  # scalar f32
    meta_static: Tuple = ()

    @staticmethod
    def create(values, meta: GridMeta, oob_value=jnp.inf) -> "SdfGrid":
        return SdfGrid(
            values=jnp.asarray(values, jnp.float32),
            meta=meta,
            oob_value=jnp.asarray(oob_value, jnp.float32),
        )

    @property
    def resolution(self):
        return self.meta.resolution

    @property
    def shape(self):
        return self.meta.shape

    def get_value_by_index(self, indices: Array) -> Tuple[Array, Array]:
        """Lookup [..., 3] int indices -> (value, in_bounds); OOB -> oob_value."""
        i = jnp.asarray(indices)
        ok = self.meta.index_in_bounds(i)
        ci = jnp.clip(i, 0, jnp.asarray(self.shape, i.dtype) - 1)
        # flat gather (1-D indexing, not 3-D advanced indexing)
        _, ny, nz = self.shape
        flat = (ci[..., 0] * ny + ci[..., 1]) * nz + ci[..., 2]
        v = self.values.reshape(-1)[flat]
        return jnp.where(ok, v, self.oob_value), ok

    def get_value_by_location(self, points: Array) -> Tuple[Array, Array]:
        return self.get_value_by_index(self.meta.location_to_index(points))


@_pytree_dataclass
class CollisionMap:
    """Occupancy grid + connected-component labels.

    JAX analogue of ``sdf_tools::CollisionMapGrid``
    (``/root/reference/include/sdf_tools/collision_map.hpp:34``). The
    reference stores ``COLLISION_CELL {float occupancy; uint32 component}``
    per voxel; we store them as two parallel arrays (structure-of-arrays is
    the XLA-friendly layout). Occupancy semantics: > 0.5 filled, < 0.5 free,
    == 0.5 unknown (``collision_map.hpp:20-32``).
    """

    META_FIELDS = ("components_valid",)

    occupancy: Array  # [nx, ny, nz] f32
    component: Array  # [nx, ny, nz] uint32
    meta: GridMeta
    oob_occupancy: Array  # scalar f32
    components_valid: bool = False

    @staticmethod
    def create(occupancy, meta: GridMeta, oob_occupancy=0.0, component=None) -> "CollisionMap":
        occ = jnp.asarray(occupancy, jnp.float32)
        comp = (
            jnp.zeros(occ.shape, jnp.uint32)
            if component is None
            else jnp.asarray(component, jnp.uint32)
        )
        return CollisionMap(
            occupancy=occ,
            component=comp,
            meta=meta,
            oob_occupancy=jnp.asarray(oob_occupancy, jnp.float32),
            components_valid=False,
        )

    @property
    def resolution(self):
        return self.meta.resolution

    @property
    def shape(self):
        return self.meta.shape

    def filled_mask(self, unknown_is_filled: bool = False) -> Array:
        """Boolean filled mask per the reference's is_filled_fn over occupancy
        (``/root/reference/include/sdf_tools/collision_map.hpp:680-712``)."""
        if unknown_is_filled:
            return self.occupancy >= 0.5
        return self.occupancy > 0.5


@_pytree_dataclass
class TaggedCollisionMap:
    """Tagged-object collision map: occupancy + component + object id + convex segment.

    JAX analogue of ``sdf_tools::TaggedObjectCollisionMapGrid``
    (``/root/reference/include/sdf_tools/tagged_object_collision_map.hpp:45``),
    cell struct at ``:22-43``.
    """

    META_FIELDS = ("components_valid", "convex_segments_valid")

    occupancy: Array  # [nx, ny, nz] f32
    component: Array  # [nx, ny, nz] uint32
    object_id: Array  # [nx, ny, nz] uint32
    convex_segment: Array  # [nx, ny, nz] uint32
    meta: GridMeta
    oob_occupancy: Array
    components_valid: bool = False
    convex_segments_valid: bool = False

    @staticmethod
    def create(occupancy, object_id, meta: GridMeta, oob_occupancy=0.0) -> "TaggedCollisionMap":
        occ = jnp.asarray(occupancy, jnp.float32)
        return TaggedCollisionMap(
            occupancy=occ,
            component=jnp.zeros(occ.shape, jnp.uint32),
            object_id=jnp.asarray(object_id, jnp.uint32),
            convex_segment=jnp.zeros(occ.shape, jnp.uint32),
            meta=meta,
            oob_occupancy=jnp.asarray(oob_occupancy, jnp.float32),
        )

    @property
    def resolution(self):
        return self.meta.resolution

    @property
    def shape(self):
        return self.meta.shape

    def filled_mask(self, unknown_is_filled: bool = False) -> Array:
        if unknown_is_filled:
            return self.occupancy >= 0.5
        return self.occupancy > 0.5
