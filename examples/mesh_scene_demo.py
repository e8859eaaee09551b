#!/usr/bin/env python
"""Triangle mesh -> SdfBuilder -> SDF demo.

The reference's SDF_Builder ingests arbitrary MoveIt collision meshes by
per-voxel checkCollision (sdf_builder.cpp:339-358); here a watertight
icosphere mesh is solid-voxelized by vectorized ray parity
(ops/voxelize.mesh_to_occupancy) and combined with analytic primitives.
Run: JAX_PLATFORMS=cpu python examples/mesh_scene_demo.py
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import numpy as np
import jax.numpy as jnp

from sdf_tools_tpu import scene, viz
from sdf_tools_tpu.grid import GridMeta, make_origin_transform
from sdf_tools_tpu.ops import query


def icosphere(center, radius, subdivisions=2):
    """Watertight icosphere mesh (verts [V,3], faces [T,3])."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
         [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
         [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], float)
    faces = np.array(
        [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
         [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
         [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
         [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    for _ in range(subdivisions):
        cache, new_faces, vlist = {}, [], list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = vlist[a] + vlist[b]
                m /= np.linalg.norm(m)
                cache[key] = len(vlist)
                vlist.append(m)
            return cache[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, np.int64)
    return (verts * radius + np.asarray(center)).astype(np.float32), faces.astype(np.int32)


res = 0.05
meta = GridMeta.create(make_origin_transform([0.0, 0.0, 0.0]), res, (64, 64, 48))
builder = scene.SdfBuilder(meta, oob_value=np.inf, backend="auto")

verts, faces = icosphere([1.0, 1.0, 1.2], 0.5, subdivisions=2)
builder.add_mesh(verts, faces)
builder.add_primitive(scene.Primitive.box([2.4, 2.2, 0.8], [0.7, 0.7, 1.2]))
print(f"mesh: {len(verts)} verts, {len(faces)} tris")

cmap = builder.update_collision_map()
print("occupied voxels:", int(np.asarray(cmap.occupancy).sum()))
sdf = builder.update_sdf(scene.UpdateMode.USE_FULL_PLANNING_SCENE)

v = np.asarray(sdf.values)
ci = tuple(np.asarray(meta.location_to_index(jnp.asarray([1.0, 1.0, 1.2], jnp.float32))))
print(f"sdf at icosphere center: {v[ci]:.3f} (expect ~ -0.5)")
gi = meta.location_to_index(jnp.asarray([[1.6, 1.0, 1.2]], jnp.float32))
g, _ = query.gradient(sdf, gi)
print("gradient just outside the sphere:", np.round(np.asarray(g)[0], 3), "(expect ~ +x)")

centers, colors = viz.sdf_display_collision_only(sdf, alpha=1.0)
viz.save_ply("/tmp/mesh_scene.ply", centers, colors)
print("wrote /tmp/mesh_scene.ply with", len(centers), "points")
