"""High-level CollisionMap / TaggedCollisionMap operations.

The functional API equivalent of the reference's ``CollisionMapGrid`` and
``TaggedObjectCollisionMapGrid`` member functions (SURVEY.md C8/C9): SDF
extraction with occupancy/unknown/object filters, the free+named combine,
per-object SDFs, component updates, surface extraction, and component
topology. Methods that mutate in the reference return new pytrees here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .grid import CollisionMap, GridMeta, SdfGrid, TaggedCollisionMap
from .ops import edt, topology

Array = jax.Array


# ---------------------------------------------------------------------------
# CollisionMapGrid ops (reference collision_map.hpp/cpp)
# ---------------------------------------------------------------------------


def extract_sdf(
    cmap: CollisionMap,
    oob_value=jnp.inf,
    unknown_is_filled: bool = False,
    add_virtual_border: bool = False,
    backend: str = "auto",
) -> Tuple[SdfGrid, Tuple[Array, Array]]:
    """``CollisionMapGrid::ExtractSignedDistanceField``
    (collision_map.hpp:680-712): filled = occupancy > 0.5 (or == 0.5 when
    unknown_is_filled; implemented as >= 0.5 which is equivalent)."""
    mask = cmap.filled_mask(unknown_is_filled)
    return edt.extract_signed_distance_field(
        mask, cmap.meta, oob_value, add_virtual_border, backend
    )


def update_connected_components(cmap: CollisionMap) -> Tuple[CollisionMap, Array]:
    return topology.update_connected_components(cmap)


def _typed_component_surface(occupancy: Array, component: Array, component_types: str) -> Array:
    """Component-surface mask restricted to the requested occupancy type
    (shared by the collision-map and tagged-map wrappers)."""
    surf = topology.component_surface_mask(component)
    if component_types == "filled":
        sel = occupancy > 0.5
    elif component_types == "empty":
        sel = occupancy < 0.5
    elif component_types == "unknown":
        sel = occupancy == 0.5
    elif component_types == "all":
        sel = jnp.ones_like(occupancy, bool)
    else:
        raise ValueError(component_types)
    return surf & sel


def extract_component_surfaces(
    cmap: CollisionMap, component_types: str = "filled"
) -> Array:
    """Surface mask restricted to components of the requested occupancy type
    (``collision_map.cpp:697-754``). component_types in
    {"filled", "empty", "unknown", "all"}. Returns a bool mask; combine with
    ``cmap.component`` for per-component surfaces."""
    return _typed_component_surface(cmap.occupancy, cmap.component, component_types)


def extract_component_surfaces_map(
    cmap: CollisionMap, component_types: str = "filled"
) -> Dict[int, np.ndarray]:
    """Reference-shaped ``ExtractComponentSurfaces`` result: a map keyed by
    component id with that component's surface voxel indices [k, 3]
    (``collision_map.cpp:697-754`` returns map<component, surface index map>).
    The dense mask from :func:`extract_component_surfaces` is the device
    form; this is the host-side API-parity view."""
    surf = np.asarray(extract_component_surfaces(cmap, component_types))
    comp = np.asarray(cmap.component)
    out: Dict[int, np.ndarray] = {}
    for c in np.unique(comp[surf]):
        out[int(c)] = np.argwhere(surf & (comp == c))
    return out


def extract_connected_components(cmap: CollisionMap) -> Dict[int, np.ndarray]:
    """Per-component voxel index lists (``collision_map.cpp:756-778``).

    Host utility: returns {component_id: [k, 3] int array}. The dense label
    array ``cmap.component`` is the device representation; use this only
    at API boundaries.
    """
    comp = np.asarray(cmap.component)
    out: Dict[int, np.ndarray] = {}
    for c in np.unique(comp):
        if c == 0 and not (comp == 0).all():
            # 0 is "unlabeled" unless everything is labeled 0
            continue
        out[int(c)] = np.argwhere(comp == c)
    return out


def compute_component_topology(
    cmap: CollisionMap, recompute: bool = True
) -> np.ndarray:
    """(holes, voids) per component (``collision_map.cpp:620-671``)."""
    if recompute or not cmap.components_valid:
        cmap, n = topology.update_connected_components(cmap)
    else:
        n = int(np.asarray(cmap.component).max())
    return topology.compute_component_topology(cmap.component, int(n))


def resample(cmap: CollisionMap, new_resolution) -> CollisionMap:
    """Nearest-location resample (``collision_map.cpp:673-695``)."""
    occ, new_meta = topology.resample_nearest(cmap.occupancy, cmap.meta, new_resolution)
    comp, _ = topology.resample_nearest(
        cmap.component.astype(jnp.int32), cmap.meta, new_resolution
    )
    return CollisionMap.create(
        occ, new_meta, oob_occupancy=cmap.oob_occupancy, component=comp.astype(jnp.uint32)
    )


# ---------------------------------------------------------------------------
# TaggedObjectCollisionMapGrid ops (reference tagged_object_collision_map.*)
# ---------------------------------------------------------------------------


def tagged_filled_mask(
    tmap: TaggedCollisionMap,
    objects_to_use: Sequence[int] = (),
    unknown_is_filled: bool = False,
) -> Array:
    """is_filled with optional object-id filtering
    (tagged_object_collision_map.hpp:813-856)."""
    occ_filled = tmap.filled_mask(unknown_is_filled)
    if len(objects_to_use) == 0:
        return occ_filled
    sel = jnp.zeros(tmap.shape, bool)
    for oid in objects_to_use:
        sel = sel | (tmap.object_id == jnp.uint32(oid))
    return occ_filled & sel


def extract_tagged_sdf(
    tmap: TaggedCollisionMap,
    oob_value=jnp.inf,
    objects_to_use: Sequence[int] = (),
    unknown_is_filled: bool = False,
    add_virtual_border: bool = False,
    backend: str = "auto",
) -> Tuple[SdfGrid, Tuple[Array, Array]]:
    mask = tagged_filled_mask(tmap, objects_to_use, unknown_is_filled)
    return edt.extract_signed_distance_field(
        mask, tmap.meta, oob_value, add_virtual_border, backend
    )


def extract_free_and_named_objects_sdf(
    tmap: TaggedCollisionMap,
    oob_value=jnp.inf,
    unknown_is_filled: bool = True,
    backend: str = "auto",
) -> Tuple[SdfGrid, Tuple[Array, Array]]:
    """``ExtractFreeAndNamedObjectsSignedDistanceField``
    (tagged_object_collision_map.hpp:730-811): free-space SDF over ALL
    obstacles combined with a named-objects-only SDF — free value if >= 0,
    else named value if <= -0, else 0. Extrema = (free max, named min)."""
    free_mask = tmap.filled_mask(unknown_is_filled)
    named_mask = free_mask & (tmap.object_id > 0)
    free_vals, free_max, _ = edt.signed_field_from_masks(
        free_mask, tmap.resolution, backend
    )
    named_vals, _, named_min = edt.signed_field_from_masks(
        named_mask, tmap.resolution, backend
    )
    combined = jnp.where(
        free_vals >= 0.0,
        free_vals,
        jnp.where(named_vals <= -0.0, named_vals, jnp.zeros_like(free_vals)),
    )
    sdf = SdfGrid.create(combined, tmap.meta, oob_value)
    return sdf, (free_max, named_min)


def make_object_sdfs(
    tmap: TaggedCollisionMap,
    object_ids: Optional[Sequence[int]] = None,
    unknown_is_filled: bool = False,
    add_virtual_border: bool = False,
    backend: str = "auto",
) -> Dict[int, SdfGrid]:
    """Per-object SDF map (``MakeObjectSDFs``/``MakeAllObjectSDFs``,
    tagged_object_collision_map.hpp:875-915). object_ids=None -> all ids
    present (ignoring 0)."""
    if object_ids is None:
        ids = np.unique(np.asarray(tmap.object_id))
        object_ids = [int(i) for i in ids if i > 0]
    out = {}
    for oid in object_ids:
        sdf, _ = extract_tagged_sdf(
            tmap,
            jnp.inf,
            objects_to_use=[oid],
            unknown_is_filled=unknown_is_filled,
            add_virtual_border=add_virtual_border,
            backend=backend,
        )
        out[int(oid)] = sdf
    return out


def resample_tagged(tmap: TaggedCollisionMap, new_resolution) -> TaggedCollisionMap:
    """Nearest-location resample of a tagged map — all four cell fields
    (occupancy, component, object_id, convex_segment), matching
    ``TaggedObjectCollisionMapGrid::Resample``
    (tagged_object_collision_map.hpp:671, impl .cpp): the new grid shares the
    origin transform and copies, per new cell, the value stored at the new
    cell center's location in the old grid."""
    occ, new_meta = topology.resample_nearest(tmap.occupancy, tmap.meta, new_resolution)
    comp, _ = topology.resample_nearest(
        tmap.component.astype(jnp.int32), tmap.meta, new_resolution
    )
    obj, _ = topology.resample_nearest(
        tmap.object_id.astype(jnp.int32), tmap.meta, new_resolution
    )
    seg, _ = topology.resample_nearest(
        tmap.convex_segment.astype(jnp.int32), tmap.meta, new_resolution
    )
    return TaggedCollisionMap(
        occupancy=occ,
        component=comp.astype(jnp.uint32),
        object_id=obj.astype(jnp.uint32),
        convex_segment=seg.astype(jnp.uint32),
        meta=new_meta,
        oob_occupancy=tmap.oob_occupancy,
    )


def extract_tagged_component_surfaces(
    tmap: TaggedCollisionMap, component_types: str = "filled"
) -> Array:
    """Tagged-grid ``ExtractComponentSurfaces`` /
    ``Extract{Filled,Unknown,Empty}ComponentSurfaces``
    (tagged_object_collision_map.hpp:704-722): same semantics as the
    collision-map version, keyed on the tagged grid's occupancy/component.
    component_types in {"filled", "empty", "unknown", "all"}."""
    return _typed_component_surface(tmap.occupancy, tmap.component, component_types)


def extract_tagged_component_surfaces_map(
    tmap: TaggedCollisionMap, component_types: str = "filled"
) -> Dict[int, np.ndarray]:
    """Host-side map view {component_id: [k, 3] surface voxel indices} of
    :func:`extract_tagged_component_surfaces` (the reference returns
    map<component, surface index map>)."""
    surf = np.asarray(extract_tagged_component_surfaces(tmap, component_types))
    comp = np.asarray(tmap.component)
    out: Dict[int, np.ndarray] = {}
    for c in np.unique(comp[surf]):
        out[int(c)] = np.argwhere(surf & (comp == c))
    return out


def update_tagged_connected_components(
    tmap: TaggedCollisionMap,
) -> Tuple[TaggedCollisionMap, Array]:
    """6-connectivity over same binary occupancy, like the collision map."""
    binary = (tmap.occupancy > 0.5).astype(jnp.int32)
    comp, n = topology.connected_components_by_key(
        jnp.ones(tmap.shape, bool), binary
    )
    return dataclasses.replace(tmap, component=comp, components_valid=True), n


def update_convex_segments(
    tmap: TaggedCollisionMap,
    connected_threshold,
    add_virtual_border: bool = False,
    backend: str = "auto",
) -> Tuple[TaggedCollisionMap, Array]:
    """``UpdateConvexSegments`` (tagged_object_collision_map.cpp:552-654):
    SDF (virtual-border or free+named) -> local extrema map -> components of
    same-object cells with extrema within ``connected_threshold``."""
    if add_virtual_border:
        sdf, _ = extract_tagged_sdf(
            tmap,
            jnp.inf,
            objects_to_use=(),
            unknown_is_filled=True,
            add_virtual_border=True,
            backend=backend,
        )
    else:
        sdf, _ = extract_free_and_named_objects_sdf(
            tmap, jnp.inf, unknown_is_filled=True, backend=backend
        )
    seg, count = topology.convex_segments(tmap, sdf, connected_threshold)
    return (
        dataclasses.replace(tmap, convex_segment=seg, convex_segments_valid=True),
        count,
    )
