#!/usr/bin/env python
"""Pointcloud -> voxel grid -> SDF + gradient demo.

Mirrors the reference's scripts/3d_sdf_demo_rviz.py (random two-box cloud,
voxelize, SDF + dense gradient) with PLY output instead of rviz.
Run: JAX_PLATFORMS=cpu python examples/pointcloud_demo.py
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import numpy as np
import jax.numpy as jnp

from sdf_tools_tpu import viz
from sdf_tools_tpu.grid import GridMeta, make_origin_transform
from sdf_tools_tpu.ops import edt, query, voxelize

rng = np.random.default_rng(0)
# two random boxes of points (reference: :15-19)
cloud = np.concatenate([
    rng.uniform([0.6, 0.6, 0.6], [1.4, 1.4, 1.4], (4000, 3)),
    rng.uniform([2.0, 1.8, 0.8], [2.6, 2.6, 1.6], (4000, 3)),
]).astype(np.float32)

res = 0.05
meta = GridMeta.create(make_origin_transform([0.0, 0.0, 0.0]), res, (64, 64, 48))
occ = voxelize.voxelize_points(jnp.asarray(cloud), meta)
print("occupied voxels:", int(occ.sum()))

sdf, _ = edt.extract_signed_distance_field(occ > 0.5, meta, oob_value=np.inf)
grad = query.full_gradient(sdf, enable_edge_gradients=True)
print("sdf range:", float(sdf.values.min()), float(sdf.values.max()))

centers, colors = viz.sdf_display_collision_only(sdf, alpha=1.0)
viz.save_ply("/tmp/sdf_demo.ply", centers, colors)
print("wrote /tmp/sdf_demo.ply with", len(centers), "points")
