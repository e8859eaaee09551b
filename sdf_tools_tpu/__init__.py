"""sdf_tools_tpu: a differentiable signed-distance-field engine in JAX.

A JAX/XLA/Pallas re-design of the capabilities of UM-ARM-Lab/sdf_tools; it
runs on the GPU (CUDA) and on the CPU. See docs/ARCHITECTURE.md and
docs/PARITY.md.
"""

from .grid import (
    CollisionMap,
    GridMeta,
    SdfGrid,
    TaggedCollisionMap,
    make_origin_transform,
)
from .ops.edt import (
    extract_signed_distance_field,
    signed_field_from_masks,
    signed_field_virtual_border,
    squared_edt,
)
from .ops.query import (
    autodiff_gradient,
    distance_to_boundary,
    estimate_distance,
    full_gradient,
    gradient,
    grid_aligned_gradient,
    project_into_valid_volume,
    project_out_of_collision,
    smooth_gradient,
)
from .ops.render import camera_rays, render_depth
from .ops.voxelize import image_to_occupancy, soft_voxelize_points, voxelize_points
from .ops.diff import sdf_from_occupancy_st
from .ops.topology import (
    candidate_corner_mask,
    component_holes_and_voids,
    component_surface_mask,
    compute_component_topology,
    connected_components_by_key,
    convex_segments,
    local_extrema_map,
    resample_nearest,
    surface_mask_26,
)
from .ops.image_sdf import false_color_preview, image_sdf
from . import collision_map_ops, io, scene, sparse, viz

__version__ = "0.1.0"

__all__ = [
    "CollisionMap",
    "GridMeta",
    "SdfGrid",
    "TaggedCollisionMap",
    "make_origin_transform",
    "extract_signed_distance_field",
    "signed_field_from_masks",
    "signed_field_virtual_border",
    "squared_edt",
    "estimate_distance",
    "gradient",
    "grid_aligned_gradient",
    "full_gradient",
    "smooth_gradient",
    "autodiff_gradient",
    "distance_to_boundary",
    "project_out_of_collision",
    "project_into_valid_volume",
    "render_depth",
    "camera_rays",
    "voxelize_points",
    "soft_voxelize_points",
    "image_to_occupancy",
    "sdf_from_occupancy_st",
    "image_sdf",
    "false_color_preview",
    "collision_map_ops",
    "io",
    "scene",
    "sparse",
    "viz",
]
