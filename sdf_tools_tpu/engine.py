"""SdfEngine: precompiled end-to-end serving API.

Production deployment wrapper: fixes grid/ray shapes up front, jit-compiles
every pipeline stage once (voxelize -> EDT -> SDF -> queries/render), and
exposes batched, shape-stable entry points so serving traffic never
triggers recompilation. This is the "framework runtime" layer the reference
lacks entirely (its Python path rebuilds per-voxel objects per call,
``/root/reference/src/sdf_tools/utils_3d.py:62-67``).

Typical use::

    engine = SdfEngine(shape=(256, 256, 256), resolution=0.05)
    engine.warmup()                       # compile everything once
    sdf = engine.sdf_from_points(points)  # [N,3] -> SdfGrid
    d, ok = engine.query(sdf, query_pts)  # batched trilinear distances
    depth = engine.render(sdf, cam, look_at)
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .grid import GridMeta, SdfGrid, make_origin_transform
from .ops import edt, query, render, voxelize

Array = jax.Array


class SdfEngine:
    def __init__(
        self,
        shape: Tuple[int, int, int],
        resolution: float,
        origin=None,
        oob_value: float = 1e3,
        backend: Optional[str] = None,
        image_hw: Tuple[int, int] = (256, 256),
        fov_deg: float = 50.0,
        render_t_max: Optional[float] = None,
        render_max_steps: int = 96,
        render_eps: float = 1e-3,
        render_backend: str = "auto",
        render_up: Tuple[float, float, float] = (0.0, 0.0, 1.0),
    ):
        if origin is None:
            origin = make_origin_transform([0.0, 0.0, 0.0])
        self.meta = GridMeta.create(origin, resolution, shape)
        self.oob_value = float(oob_value)
        self.backend = edt.resolve_backend("auto" if backend is None else backend)
        self.image_hw = image_hw
        self.fov_deg = fov_deg
        extent = max(shape) * resolution
        self.render_t_max = render_t_max if render_t_max is not None else 4.0 * extent
        self.render_max_steps = render_max_steps

        meta = self.meta
        oob = self.oob_value
        be = self.backend

        @jax.jit
        def _sdf_from_mask(mask):
            vals, mx, mn = edt.signed_field_from_masks(mask, meta.resolution, be)
            return vals, mx, mn

        @jax.jit
        def _voxelize(points):
            return voxelize.voxelize_points(points, meta)

        @jax.jit
        def _soft_voxelize(points):
            return voxelize.soft_voxelize_points(points, meta, temperature=0.5)

        @jax.jit
        def _query(values, points):
            s = SdfGrid.create(values, meta, oob)
            return query.estimate_distance(s, points)

        @jax.jit
        def _query_with_grad(values, points):
            s = SdfGrid.create(values, meta, oob)
            d, ok = query.estimate_distance(s, points)
            g = query.autodiff_gradient(s, points)
            return d, g, ok

        h, w = image_hw
        t_max = self.render_t_max
        msteps = self.render_max_steps
        fov = self.fov_deg
        self.render_eps = float(render_eps)
        self.render_backend = render_backend
        self.render_up = tuple(float(u) for u in render_up)

        @partial(jax.jit, static_argnames=("eps", "backend"))
        def _render(values, cam, look_at, up, eps, backend):
            s = SdfGrid.create(values, meta, oob)
            o, v = render.camera_rays(cam, look_at, up, fov, h, w)
            out = render.render_depth(
                s, o, v, t_max=t_max, eps=eps, max_steps=msteps, backend=backend
            )
            return out.depth, out.hit

        self._sdf_from_mask = _sdf_from_mask
        self._voxelize = _voxelize
        self._soft_voxelize = _soft_voxelize
        self._query = _query
        self._query_with_grad = _query_with_grad
        self._render = _render

    # -- public API ----------------------------------------------------------

    def sdf_from_occupancy(self, occupancy) -> SdfGrid:
        vals, _, _ = self._sdf_from_mask(jnp.asarray(occupancy) > 0.5)
        return SdfGrid.create(vals, self.meta, self.oob_value)

    def sdf_from_points(self, points) -> SdfGrid:
        occ = self._voxelize(jnp.asarray(points))
        return self.sdf_from_occupancy(occ)

    def query(self, sdf: SdfGrid, points) -> Tuple[Array, Array]:
        return self._query(sdf.values, jnp.asarray(points))

    def query_with_grad(self, sdf: SdfGrid, points):
        return self._query_with_grad(sdf.values, jnp.asarray(points))

    def render(
        self,
        sdf: SdfGrid,
        camera_pos,
        look_at,
        up=None,
        eps: Optional[float] = None,
        backend: Optional[str] = None,
    ) -> Tuple[Array, Array]:
        """Render a depth image. ``up``/``eps``/``backend`` default to the
        engine's construction-time settings; overriding ``eps`` or
        ``backend`` compiles a new variant (cached per distinct value)."""
        up = self.render_up if up is None else up
        return self._render(
            sdf.values,
            jnp.asarray(camera_pos, jnp.float32),
            jnp.asarray(look_at, jnp.float32),
            jnp.asarray(up, jnp.float32),
            self.render_eps if eps is None else float(eps),
            self.render_backend if backend is None else backend,
        )

    def warmup(self, n_points: int = 1024, n_queries: int = 1024):
        """Compile every stage once with representative shapes."""
        extent = np.asarray(self.meta.sizes)
        rng = np.random.default_rng(0)
        pts = jnp.asarray(rng.uniform(0, extent, (n_points, 3)), jnp.float32)
        sdf = self.sdf_from_points(pts)
        q = jnp.asarray(rng.uniform(0, extent, (n_queries, 3)), jnp.float32)
        jax.block_until_ready(self.query(sdf, q))
        jax.block_until_ready(self.query_with_grad(sdf, q))
        cam = jnp.asarray(-0.5 * extent, jnp.float32)
        center = jnp.asarray(0.5 * extent, jnp.float32)
        jax.block_until_ready(self.render(sdf, cam, center))
        return sdf
