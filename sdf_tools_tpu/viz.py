"""Visualization exports: colored voxel clouds + PLY writer.

JAX replacement for the reference's rviz marker exports (its de-facto
observability surface, SURVEY.md §5). Instead of ROS CUBE_LIST markers, every
export returns dense ``(centers [N,3] float32, colors [N,4] float32)`` arrays
(world-frame cell centers and RGBA), filterable by alpha and writable to PLY
for any viewer. Color rules match the reference exactly:

  * SDF display (``sdf.cpp:504-585``): d > 0 -> green = 0.2 + 0.8*|d/max|;
    d < 0 -> red = 0.2 + 0.8*|d/min|; d == 0 -> blue.
  * Collision map display (``collision_map.cpp:317-420``): per-class colors
    for filled (> 0.5), free (< 0.5), unknown (== 0.5); alpha 0 hides a
    class (ExportForSeparateDisplay composes one export per class).
  * Component / convex-segment / object displays: deterministic color from
    the label via the same golden-angle hue wheel idea the reference gets
    from LookupComponentColor.
  * Tagged per-object contours (``tagged_object_collision_map.cpp:917-1182``):
    cells of a per-object SDF shell -1.9*res < d < 0.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from .grid import CollisionMap, GridMeta, SdfGrid, TaggedCollisionMap

Array = np.ndarray


def _cell_centers(meta: GridMeta) -> np.ndarray:
    nx, ny, nz = meta.shape
    ix, iy, iz = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    idx = np.stack([ix, iy, iz], axis=-1).reshape(-1, 3)
    return np.asarray(meta.index_to_location(jnp.asarray(idx)), np.float32)


def label_color(label: np.ndarray, alpha: float = 1.0) -> np.ndarray:
    """Deterministic distinct-ish RGBA per label (golden-angle hue wheel)."""
    h = (label.astype(np.float64) * 0.61803398875) % 1.0
    i = (h * 6).astype(int) % 6
    f = h * 6 - np.floor(h * 6)
    v, p, q, t = 1.0, 0.25, 1 - 0.75 * f, 0.25 + 0.75 * f
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    a = np.full_like(r, alpha)
    return np.stack([r, g, b, a], axis=-1).astype(np.float32)


def sdf_display(sdf: SdfGrid, alpha: float = 0.01) -> Tuple[Array, Array]:
    """ExportForDisplay color rule (sdf.cpp:553-585)."""
    v = np.asarray(sdf.values).reshape(-1)
    finite = np.isfinite(v)
    vmax = max(float(v[finite].max(initial=0.0)), 1e-12)
    vmin = min(float(v[finite].min(initial=0.0)), -1e-12)
    r = np.where(v < 0, np.abs(v / vmin) * 0.8 + 0.2, 0.0)
    g = np.where(v > 0, np.abs(v / vmax) * 0.8 + 0.2, 0.0)
    b = np.where(v == 0, 1.0, 0.0)
    a = np.full_like(r, np.clip(alpha, 0.0, 1.0))
    colors = np.stack([r, g, b, a], axis=-1).astype(np.float32)
    return _cell_centers(sdf.meta), colors


def sdf_display_collision_only(sdf: SdfGrid, alpha: float = 0.01) -> Tuple[Array, Array]:
    """ExportForDisplayCollisionOnly (sdf.cpp:589-639): only d <= 0 cells."""
    centers, colors = sdf_display(sdf, alpha)
    v = np.asarray(sdf.values).reshape(-1)
    keep = v <= 0.0
    return centers[keep], colors[keep]


def collision_map_display(
    cmap: CollisionMap,
    collision_color=(1.0, 0.0, 0.0, 0.5),
    free_color=(0.0, 1.0, 0.0, 0.0),
    unknown_color=(1.0, 1.0, 0.0, 0.0),
) -> Tuple[Array, Array]:
    """ExportForDisplay (collision_map.cpp:317-377): cells colored by class;
    classes with alpha == 0 are dropped (reference skips them)."""
    occ = np.asarray(cmap.occupancy).reshape(-1)
    centers = _cell_centers(cmap.meta)
    colors = np.zeros((occ.size, 4), np.float32)
    filled = occ > 0.5
    free = occ < 0.5
    unknown = occ == 0.5
    colors[filled] = collision_color
    colors[free] = free_color
    colors[unknown] = unknown_color
    keep = colors[:, 3] > 0.0
    return centers[keep], colors[keep]


def components_display(
    cmap: CollisionMap, alpha: float = 1.0
) -> Tuple[Array, Array]:
    """ExportConnectedComponentsForDisplay: color per component label."""
    comp = np.asarray(cmap.component).reshape(-1)
    centers = _cell_centers(cmap.meta)
    colors = label_color(comp, alpha)
    keep = comp > 0
    return centers[keep], colors[keep]


def tagged_objects_display(
    tmap: TaggedCollisionMap, alpha: float = 1.0, objects_to_draw=()
) -> Tuple[Array, Array]:
    """ExportForDisplay (tagged): filled cells colored by object id; id 0 and
    undrawn objects skipped (tagged_object_collision_map.cpp:917-1000)."""
    occ = np.asarray(tmap.occupancy).reshape(-1)
    obj = np.asarray(tmap.object_id).reshape(-1)
    centers = _cell_centers(tmap.meta)
    keep = (occ > 0.5) & (obj > 0)
    if len(objects_to_draw) > 0:
        keep &= np.isin(obj, np.asarray(objects_to_draw))
    return centers[keep], label_color(obj[keep], alpha)


def convex_segments_display(
    tmap: TaggedCollisionMap, alpha: float = 1.0
) -> Tuple[Array, Array]:
    seg = np.asarray(tmap.convex_segment).reshape(-1)
    centers = _cell_centers(tmap.meta)
    keep = seg > 0
    return centers[keep], label_color(seg[keep], alpha)


def tagged_occupancy_display(
    tmap: TaggedCollisionMap,
    collision_color=(1.0, 0.0, 0.0, 0.5),
    free_color=(0.0, 1.0, 0.0, 0.0),
    unknown_color=(1.0, 1.0, 0.0, 0.0),
) -> Tuple[Array, Array]:
    """ExportForDisplayOccupancyOnly (tagged_object_collision_map.cpp:1188-
    1233): cells colored by occupancy class only; alpha-0 classes dropped."""
    occ = np.asarray(tmap.occupancy).reshape(-1)
    centers = _cell_centers(tmap.meta)
    colors = np.zeros((occ.size, 4), np.float32)
    colors[occ > 0.5] = collision_color
    colors[occ < 0.5] = free_color
    colors[occ == 0.5] = unknown_color
    keep = colors[:, 3] > 0.0
    return centers[keep], colors[keep]


def tagged_components_display(
    tmap: TaggedCollisionMap,
    color_unknown_components: bool = False,
    alpha: float = 1.0,
) -> Tuple[Array, Array]:
    """ExportConnectedComponentsForDisplay (tagged,
    tagged_object_collision_map.cpp:1235-1283): every cell emitted; known
    cells colored by component, unknown cells gray unless
    ``color_unknown_components``."""
    occ = np.asarray(tmap.occupancy).reshape(-1)
    comp = np.asarray(tmap.component).reshape(-1)
    centers = _cell_centers(tmap.meta)
    colors = label_color(comp, alpha)
    if not color_unknown_components:
        unknown = occ == 0.5
        colors[unknown] = (0.5, 0.5, 0.5, 1.0)
    return centers, colors


def convex_segment_display(
    tmap: TaggedCollisionMap,
    object_id: int,
    convex_segment: int,
    alpha: float = 1.0,
) -> Tuple[Array, Array]:
    """ExportConvexSegmentForDisplay (tagged_object_collision_map.cpp:1285-
    1334): only cells with the requested (object_id, convex_segment)."""
    obj = np.asarray(tmap.object_id).reshape(-1)
    seg = np.asarray(tmap.convex_segment).reshape(-1)
    keep = (obj == np.uint32(object_id)) & (seg == np.uint32(convex_segment))
    centers = _cell_centers(tmap.meta)
    return centers[keep], label_color(seg[keep], alpha)


def object_contour_display(
    object_sdf: SdfGrid, alpha: float = 1.0
) -> Tuple[Array, Array]:
    """Per-object contour shell: cells with -1.9*res < d < 0
    (tagged_object_collision_map.cpp:1077-1182)."""
    v = np.asarray(object_sdf.values).reshape(-1)
    res = float(object_sdf.resolution)
    keep = (v < 0.0) & (v > -1.9 * res)
    centers = _cell_centers(object_sdf.meta)
    colors = np.tile(np.asarray([0.2, 0.2, 1.0, alpha], np.float32), (keep.sum(), 1))
    return centers[keep], colors


def surface_display(
    meta: GridMeta, surface_mask, alpha: float = 1.0
) -> Tuple[Array, Array]:
    keep = np.asarray(surface_mask).reshape(-1)
    centers = _cell_centers(meta)
    colors = np.tile(np.asarray([1.0, 0.5, 0.0, alpha], np.float32), (int(keep.sum()), 1))
    return centers[keep], colors


def save_ply(path: str, points: Array, colors: Optional[Array] = None):
    """Write a point cloud (+ optional RGBA colors) as binary-less ASCII PLY."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    n = len(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        if colors is not None:
            rgb = (np.clip(np.asarray(colors)[:, :3], 0, 1) * 255).astype(np.uint8)
            for p, c in zip(points, rgb):
                f.write(f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")
        else:
            for p in points:
                f.write(f"{p[0]} {p[1]} {p[2]}\n")
