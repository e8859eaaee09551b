#!/usr/bin/env python
"""Tutorial: the canonical usage walkthrough of sdf_tools_tpu.

Mirrors the reference's sdf_tools_tutorial
(/root/reference/src/sdf_tools_tutorial.cpp): build a 10x10x10 m collision
map at 0.25 m resolution, fill an octant, query cells, update connected
components, extract the SDF (unknown_is_filled=True), and query gradients.
Run: JAX_PLATFORMS=cpu python examples/tutorial.py
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import numpy as np
import jax.numpy as jnp

from sdf_tools_tpu import collision_map_ops as cmo, viz
from sdf_tools_tpu.grid import CollisionMap, GridMeta, make_origin_transform
from sdf_tools_tpu.ops import query

res, side = 0.25, 10.0
n = int(side / res)
meta = GridMeta.create(make_origin_transform([0.0, 0.0, 0.0]), res, (n, n, n))

# occupancy: fill one octant (x > 5, y > 5, z > 5), unknown elsewhere (0.5)
occ = np.full((n, n, n), 0.0, np.float32)
occ[n // 2 :, n // 2 :, n // 2 :] = 1.0
cmap = CollisionMap.create(occ, meta, oob_occupancy=0.5)

# query by index and by world location
print("occupancy[30,30,30]:", float(cmap.occupancy[30, 30, 30]))
idx = meta.location_to_index(jnp.asarray([8.0, 8.0, 8.0]))
print("location (8,8,8)m -> index", np.asarray(idx))

cmap, n_comp = cmo.update_connected_components(cmap)
print("connected components:", int(n_comp))

sdf, (mx, mn) = cmo.extract_sdf(cmap, oob_value=np.inf, unknown_is_filled=True)
print(f"sdf extrema: max {float(mx):.3f} min {float(mn):.3f}")

g, ok = query.gradient(sdf, jnp.asarray([[20, 20, 20], [2, 2, 2]]), enable_edge_gradients=True)
print("gradients:", np.asarray(g))

d, ok = query.estimate_distance(sdf, jnp.asarray([[2.6, 2.6, 2.6]]))
print("estimate_distance at (2.6,2.6,2.6):", float(d[0]))

centers, colors = viz.sdf_display(sdf, alpha=0.5)
print("display export:", centers.shape, colors.shape)
