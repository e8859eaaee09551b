"""Dynamic spatial-hashed collision map: sparse chunked occupancy.

JAX analogue of ``DynamicSpatialHashedCollisionMapGrid``
(``/root/reference/include/sdf_tools/dynamic_spatial_hashed_collision_map.hpp``,
``src/sdf_tools/dynamic_spatial_hashed_collision_map.cpp:125-186``): space is
divided into fixed-size chunks; a chunk is absent, uniformly filled with one
value (chunk-level set), or a dense cell array (cell-level set).

Design: the chunk *directory* is a host-side dict (like the reference's
unordered_map — pure control plane), while chunk payloads are dense jnp
arrays, so any region of interest can be densified into a ``CollisionMap``
(``densify_region``) and fed to the device EDT/render pipeline. This follows the
framework rule: irregular pointer structures stay on host, bulk math on
device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from .grid import CollisionMap, GridMeta

CHUNK_UNINITIALIZED = 0
CHUNK_FILLED = 1  # uniform value for the whole chunk
CHUNK_CELLWISE = 2  # dense per-cell values


@dataclasses.dataclass
class _Chunk:
    state: int
    fill_occupancy: float = 0.0
    cells: Optional[np.ndarray] = None  # [cs, cs, cs] float32 when CELLWISE


class DynamicSpatialHashedCollisionMap:
    """Sparse chunked occupancy map with chunk- and cell-level writes."""

    def __init__(
        self,
        origin_transform,
        resolution: float,
        chunk_cells: int = 16,
        default_occupancy: float = 0.0,
        oob_occupancy: float = 0.0,
        frame: str = "world",
    ):
        self.origin = np.asarray(origin_transform, np.float64)
        self.inv_origin = np.linalg.inv(self.origin)
        self.resolution = float(resolution)
        self.chunk_cells = int(chunk_cells)
        self.chunk_size = self.resolution * self.chunk_cells
        self.default_occupancy = float(default_occupancy)
        self.oob_occupancy = float(oob_occupancy)
        self.frame = frame
        self.chunks: Dict[Tuple[int, int, int], _Chunk] = {}

    # -- coordinate helpers --------------------------------------------------

    def _grid_frame(self, p) -> np.ndarray:
        q = self.inv_origin @ np.array([p[0], p[1], p[2], 1.0])
        return q[:3]

    def _chunk_key(self, p) -> Tuple[int, int, int]:
        g = self._grid_frame(p)
        return tuple(int(np.floor(c / self.chunk_size)) for c in g)

    def _cell_index(self, p, key) -> Tuple[int, int, int]:
        g = self._grid_frame(p)
        local = g - np.asarray(key) * self.chunk_size
        idx = np.floor(local / self.resolution).astype(int)
        return tuple(int(np.clip(i, 0, self.chunk_cells - 1)) for i in idx)

    # -- reference API (Get / SetCellValue / SetChunkValue) ------------------

    def get(self, p) -> Tuple[float, int]:
        """(occupancy, state): state tells chunk/cell/uninitialized, matching
        the reference's FOUND_IN_CHUNK / FOUND_IN_CELL / NOT_FOUND."""
        key = self._chunk_key(p)
        chunk = self.chunks.get(key)
        if chunk is None:
            return self.oob_occupancy, CHUNK_UNINITIALIZED
        if chunk.state == CHUNK_FILLED:
            return chunk.fill_occupancy, CHUNK_FILLED
        return float(chunk.cells[self._cell_index(p, key)]), CHUNK_CELLWISE

    def set_chunk(self, p, occupancy: float):
        """Fill the whole chunk containing p with one value."""
        key = self._chunk_key(p)
        self.chunks[key] = _Chunk(CHUNK_FILLED, float(occupancy))

    def set_cell(self, p, occupancy: float):
        """Set one cell; converts a uniform chunk to cell-wise storage."""
        key = self._chunk_key(p)
        chunk = self.chunks.get(key)
        cs = self.chunk_cells
        if chunk is None or chunk.state != CHUNK_CELLWISE:
            base = (
                chunk.fill_occupancy
                if chunk is not None and chunk.state == CHUNK_FILLED
                else self.default_occupancy
            )
            chunk = _Chunk(
                CHUNK_CELLWISE, 0.0, np.full((cs, cs, cs), base, np.float32)
            )
            self.chunks[key] = chunk
        chunk.cells[self._cell_index(p, key)] = occupancy

    # -- densification -------------------------------------------------------

    def densify_region(self, lo_key, hi_key) -> CollisionMap:
        """Materialize chunks in [lo_key, hi_key) as a dense CollisionMap."""
        lo = np.asarray(lo_key, int)
        hi = np.asarray(hi_key, int)
        span = hi - lo
        cs = self.chunk_cells
        shape = tuple(int(s) * cs for s in span)
        occ = np.full(shape, self.default_occupancy, np.float32)
        for key, chunk in self.chunks.items():
            k = np.asarray(key)
            if np.any(k < lo) or np.any(k >= hi):
                continue
            off = (k - lo) * cs
            sl = tuple(slice(int(o), int(o) + cs) for o in off)
            if chunk.state == CHUNK_FILLED:
                occ[sl] = chunk.fill_occupancy
            else:
                occ[sl] = chunk.cells
        # region origin = origin shifted by lo * chunk_size in grid frame
        shift = np.eye(4)
        shift[:3, 3] = lo * self.chunk_size
        region_origin = self.origin @ shift
        meta = GridMeta.create(region_origin, self.resolution, shape, self.frame)
        return CollisionMap.create(occ, meta, oob_occupancy=self.oob_occupancy)

    def bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        """(lo_key, hi_key) covering all current chunks (hi exclusive)."""
        if not self.chunks:
            return np.zeros(3, int), np.zeros(3, int)
        keys = np.asarray(list(self.chunks.keys()))
        return keys.min(axis=0), keys.max(axis=0) + 1

    def densify(self) -> CollisionMap:
        lo, hi = self.bounds()
        return self.densify_region(lo, hi)

    def display_export(self):
        """(centers [N,3], colors [N,4]) for chunk-level + cell-level content
        (reference ExportForDisplay walks chunks and emits chunk-level or
        cell-level cubes)."""
        pts, cols = [], []
        for key, chunk in self.chunks.items():
            k = np.asarray(key, float)
            if chunk.state == CHUNK_FILLED:
                center_g = (k + 0.5) * self.chunk_size
                center_w = (self.origin @ np.append(center_g, 1.0))[:3]
                pts.append(center_w[None, :])
                c = [1.0, 0.0, 0.0, 0.5] if chunk.fill_occupancy > 0.5 else [0.0, 1.0, 0.0, 0.1]
                cols.append(np.asarray([c], np.float32))
            elif chunk.state == CHUNK_CELLWISE:
                cs = self.chunk_cells
                ii = np.stack(
                    np.meshgrid(*([np.arange(cs)] * 3), indexing="ij"), -1
                ).reshape(-1, 3)
                centers_g = (k * cs + ii + 0.5) * self.resolution
                ones = np.ones((len(centers_g), 1))
                centers_w = (np.hstack([centers_g, ones]) @ self.origin.T)[:, :3]
                occ = chunk.cells.reshape(-1)
                keep = occ > 0.5
                pts.append(centers_w[keep])
                cols.append(
                    np.tile(np.asarray([[1.0, 0.0, 0.0, 0.5]], np.float32), (keep.sum(), 1))
                )
        if not pts:
            return np.zeros((0, 3), np.float32), np.zeros((0, 4), np.float32)
        return np.concatenate(pts).astype(np.float32), np.concatenate(cols)
