"""Topology ops: connected components, surfaces, holes/voids, watershed
extrema, convex segmentation.

JAX re-design of the reference's ``topology_computation.hpp`` and the
related CollisionMap/SDF member functions. The reference uses serial BFS
flood fill (``topology_computation.hpp:25-149``) and memoized serial gradient
walks (``sdf.cpp:23-207``); both are reformulated as bounded iterative
relaxations (SURVEY.md §7 step 7):

  * Connected components: iterative min-label propagation over 6-neighbors.
    Label numbering matches the reference's raster-scan discovery order
    because each component's representative is its minimum flat index — the
    first cell the reference's sweep would reach (labels are 1-based).
  * Holes/voids: surface-vertex census with the Chen & Rong genus formula
    #holes = 1 + (M5 + 2*M6 - M3)/8 (+ voids from vertex-graph
    connectivity), see ``topology_computation.hpp:326-640``. We use the
    geometrically-correct corner test: a vertex is a surface vertex of
    component c iff its 8 surrounding voxels contain both c and non-c
    (provably equivalent to the reference's exposed-corner rule; NOTE the
    reference has a copy-paste bug where the z+1 neighbor is fetched at z-1,
    ``topology_computation.hpp:385-390`` — we implement the correct
    geometry).
  * Local extrema map: the per-cell serial gradient walk becomes a dense
    one-step successor map + pointer doubling (log N gathers). Cycle cells
    resolve to the cycle member with the smallest flat index — the reference
    resolves them to whichever member its (processing-order-dependent) walk
    revisits first; our rule is the deterministic, order-free equivalent.
"""
from __future__ import annotations

from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..grid import CollisionMap, GridMeta, SdfGrid, TaggedCollisionMap
from . import query

Array = jax.Array

# np scalar, not jnp: a device constant at import time would initialize the
# XLA backend before jax.distributed.initialize can run (multi-host path)
_BIG = np.int32(2**30)

_DIRS6 = [
    (0, 1),  # +x
    (0, -1),
    (1, 1),
    (1, -1),
    (2, 1),
    (2, -1),
]


def _shift(a: Array, axis: int, sign: int, fill) -> Array:
    """Neighbor value in direction (axis, sign): out[i] = a[i + sign]."""
    n = a.shape[axis]
    pad = [(0, 0)] * a.ndim
    if sign > 0:
        pad[axis] = (0, 1)
        sl = tuple(
            slice(1, n + 1) if ax == axis else slice(None) for ax in range(a.ndim)
        )
    else:
        pad[axis] = (1, 0)
        sl = tuple(slice(0, n) if ax == axis else slice(None) for ax in range(a.ndim))
    return jnp.pad(a, pad, constant_values=fill)[sl]


# ---------------------------------------------------------------------------
# Connected components
# ---------------------------------------------------------------------------


def connected_components_from_adjacency(
    eligible: Array, conn: List[Array]
) -> Tuple[Array, Array]:
    """Min-label propagation CC.

    eligible: [nx,ny,nz] bool — cells that get a component (others -> 0).
    conn: 6 bool arrays (order: +x,-x,+y,-y,+z,-z); conn[d][i] == True means
    cell i is connected to its neighbor in direction d (must be symmetric).

    Returns (labels uint32 [nx,ny,nz] 1-based, n_components int32). Matches
    the reference's raster-scan label order (topology_computation.hpp:93-149).
    """
    shape = eligible.shape
    N = int(np.prod(shape))
    flat = jnp.arange(N, dtype=jnp.int32).reshape(shape)
    label0 = jnp.where(eligible, flat, _BIG)

    def cond(state):
        label, done = state
        return ~done

    def body(state):
        label, _ = state
        new = label
        for d, (axis, sign) in enumerate(_DIRS6):
            cand = _shift(label, axis, sign, _BIG)
            cand = jnp.where(conn[d], cand, _BIG)
            new = jnp.minimum(new, cand)
        done = jnp.all(new == label)
        return new, done

    done0 = jnp.all(label0 != label0)
    label, _ = lax.while_loop(cond, body, (label0, done0))

    # dense 1-based ranks in discovery (min-flat-index) order
    is_rep = (label == flat) & eligible
    ranks = jnp.cumsum(is_rep.reshape(-1).astype(jnp.int32)).reshape(shape)
    safe_label = jnp.clip(label, 0, N - 1)
    comp = jnp.where(eligible, ranks.reshape(-1)[safe_label.reshape(-1)].reshape(shape), 0)
    n_components = jnp.sum(is_rep.astype(jnp.int32))
    return comp.astype(jnp.uint32), n_components


def _symmetric_conn(eligible: Array, same_class: List[Array]) -> List[Array]:
    conn = []
    for d, (axis, sign) in enumerate(_DIRS6):
        nb_ok = _shift(eligible, axis, sign, False)
        conn.append(eligible & nb_ok & same_class[d])
    return conn


def connected_components_by_key(eligible: Array, key: Array) -> Tuple[Array, Array]:
    """CC where two 6-adjacent eligible cells connect iff key values match."""
    same = []
    for axis, sign in _DIRS6:
        nb = _shift(key, axis, sign, -1)
        same.append(nb == key)
    conn = _symmetric_conn(eligible, same)
    return connected_components_from_adjacency(eligible, conn)


def update_connected_components(cmap: CollisionMap) -> Tuple[CollisionMap, Array]:
    """Reference ``CollisionMapGrid::UpdateConnectedComponents``
    (collision_map.cpp:564-618): 6-connectivity, same binary occupancy
    (occupancy > 0.5), every cell labeled."""
    binary = (cmap.occupancy > 0.5).astype(jnp.int32)
    eligible = jnp.ones_like(binary, bool)
    comp, n = connected_components_by_key(eligible, binary)
    import dataclasses

    return dataclasses.replace(cmap, component=comp, components_valid=True), n


# ---------------------------------------------------------------------------
# Surface predicates (reference collision_map.hpp:45-119, 549-619)
# ---------------------------------------------------------------------------


def surface_mask_26(filled: Array) -> Array:
    """IsSurfaceIndex: filled cell with >=1 of 26 neighbors not filled, or on
    the grid border (collision_map.hpp:45-92)."""
    f = jnp.asarray(filled, bool)
    all_nb = jnp.ones_like(f)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                if dx == dy == dz == 0:
                    continue
                nb = f
                for axis, s in ((0, dx), (1, dy), (2, dz)):
                    if s != 0:
                        nb = _shift(nb, axis, s, False)
                all_nb = all_nb & nb
    return f & ~all_nb


def component_surface_mask(labels: Array) -> Array:
    """IsConnectedComponentSurfaceIndex: cell with >=1 of 6 neighbors in a
    different component, or on the grid border (collision_map.hpp:94-119;
    the reference's z-edge off-by-one bug is fixed here)."""
    lab = jnp.asarray(labels).astype(jnp.int32)
    on_surface = jnp.zeros(lab.shape, bool)
    for axis, sign in _DIRS6:
        nb = _shift(lab, axis, sign, -1)
        on_surface = on_surface | (nb != lab)
    return on_surface


def candidate_corner_mask(labels: Array) -> Array:
    """CheckIfCandidateCorner: >=2 of the 6 neighbors differ in component
    (collision_map.hpp:549-619). Out-of-grid neighbors are NOT counted as
    different (the reference only counts neighbors whose GetImmutable
    succeeds), so grid-border cells need >=2 genuinely different in-bounds
    neighbors."""
    lab = jnp.asarray(labels).astype(jnp.int32)
    in_bounds = jnp.ones(lab.shape, bool)
    count = jnp.zeros(lab.shape, jnp.int32)
    for axis, sign in _DIRS6:
        nb = _shift(lab, axis, sign, -1)
        nb_valid = _shift(in_bounds, axis, sign, False)
        count = count + (nb_valid & (nb != lab)).astype(jnp.int32)
    return count >= 2


# ---------------------------------------------------------------------------
# Holes / voids (genus) census
# ---------------------------------------------------------------------------


def _vertex_cube_labels(labels: Array) -> Array:
    """[nx+1, ny+1, nz+1, 8] labels of the 8 voxels around each vertex
    (out-of-grid -> -1)."""
    lab = jnp.asarray(labels, jnp.int32)
    p = jnp.pad(lab, 1, constant_values=-1)  # [nx+2, ny+2, nz+2]
    nx, ny, nz = lab.shape
    cubes = []
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                cubes.append(p[dx : dx + nx + 1, dy : dy + ny + 1, dz : dz + nz + 1])
    return jnp.stack(cubes, axis=-1)


def _edge_groups():
    """For each of the 6 vertex edges, the 4 cube-slot indices around it.

    Cube slot k = (dx,dy,dz) with k = dx*4 + dy*2 + dz; voxel at offset
    (x-1+dx, y-1+dy, z-1+dz). Edge z- involves the 4 voxels with dz=0,
    z+ those with dz=1, y-/y+ by dy, x-/x+ by dx — matching the reference's
    4-voxel groups (topology_computation.hpp:502-608).
    """
    groups = []
    for axis, val in ((2, 0), (2, 1), (1, 0), (1, 1), (0, 0), (0, 1)):
        g = []
        for k in range(8):
            dx, dy, dz = (k >> 2) & 1, (k >> 1) & 1, k & 1
            if (dx, dy, dz)[axis] == val:
                g.append(k)
        groups.append(g)
    return groups


_EDGE_GROUPS = _edge_groups()


def vertex_edge_exposure(labels: Array, component) -> Tuple[Array, Array, Array]:
    """Per-vertex edge exposure for one component.

    Returns (edge_bits int32 [nx+1,ny+1,nz+1], is_surface_vertex bool,
    exposed_edge_count int32).
    An edge is exposed iff its 4 surrounding voxels are mixed (some == c,
    some != c); a vertex is a surface vertex iff its 8-cube is mixed.
    """
    cubes = _vertex_cube_labels(labels)  # [..., 8]
    c = jnp.asarray(component, jnp.int32)
    is_c = cubes == c
    mixed_cube = jnp.any(is_c, -1) & ~jnp.all(is_c, -1)
    bits = jnp.zeros(cubes.shape[:-1], jnp.int32)
    count = jnp.zeros(cubes.shape[:-1], jnp.int32)
    for e, group in enumerate(_EDGE_GROUPS):
        g = is_c[..., group]
        mixed = jnp.any(g, -1) & ~jnp.all(g, -1)
        bits = bits | (mixed.astype(jnp.int32) << e)
        count = count + mixed.astype(jnp.int32)
    return jnp.where(mixed_cube, bits, 0), mixed_cube, jnp.where(mixed_cube, count, 0)


def component_holes_and_voids(labels: Array, component) -> Tuple[Array, Array]:
    """(#holes, #voids) of one component: Chen & Rong formula + vertex-graph
    connectivity (reference topology_computation.hpp:326-640)."""
    bits, is_sv, count = vertex_edge_exposure(labels, component)
    M3 = jnp.sum((count == 3).astype(jnp.int32))
    M5 = jnp.sum((count == 5).astype(jnp.int32))
    M6 = jnp.sum((count == 6).astype(jnp.int32))

    # vertex-graph connected components: vertices connect along exposed edges
    vshape = bits.shape
    Nv = int(np.prod(vshape))
    flat = jnp.arange(Nv, dtype=jnp.int32).reshape(vshape)
    label0 = jnp.where(is_sv, flat, _BIG)
    # edge e connects vertex v to neighbor in direction: order matches
    # _EDGE_GROUPS: z-, z+, y-, y+, x-, x+
    edge_dirs = [(2, -1), (2, 1), (1, -1), (1, 1), (0, -1), (0, 1)]

    def cond(state):
        label, done = state
        return ~done

    def body(state):
        label, _ = state
        new = label
        for e, (axis, sign) in enumerate(edge_dirs):
            has_edge = (bits >> e) & 1
            cand = _shift(label, axis, sign, _BIG)
            cand = jnp.where(has_edge == 1, cand, _BIG)
            new = jnp.minimum(new, cand)
        done = jnp.all(new == label)
        return new, done

    done0 = jnp.all(label0 != label0)
    vlabel, _ = lax.while_loop(cond, body, (label0, done0))
    n_surfaces = jnp.sum(((vlabel == flat) & is_sv).astype(jnp.int32))
    n_voids = jnp.maximum(n_surfaces - 1, 0)
    raw_holes = 1 + (M5 + 2 * M6 - M3) // 8
    return raw_holes + n_voids, n_voids


def component_topology_census(labels: Array, n_components: int) -> Array:
    """One-pass (holes, voids) census for ALL components — [n, 2] int32.

    Replaces the per-component loop (each a full-grid pass — the reference's
    ``collision_map.cpp:620-671`` is likewise serial) with a single pass whose
    cost is independent of n_components: each vertex's 8-voxel cube holds the
    labels of every component the vertex can be a surface vertex of, so the
    M3/M5/M6 exposure census runs per (vertex, distinct-cube-label) pair and
    reduces into per-label histograms, and ONE joint min-label propagation
    over (vertex, cube-slot) nodes counts each component's disjoint surface
    sets (voids). Equal output to :func:`component_holes_and_voids` looped
    over 1..n (tests/test_topology.py::test_census_matches_per_component).

    ``n_components`` only sizes the output histograms, so the jitted body
    uses a power-of-two PADDED bound as its static shape and threads the true
    count in as data: scene loops with varying component counts compile
    O(log n) kernels total, not one per distinct count.
    """
    n = int(n_components)
    if n <= 0:
        return jnp.zeros((0, 2), jnp.int32)
    n_bound = 8
    while n_bound < n:
        n_bound *= 2
    return _census_padded(labels, jnp.int32(n), n_bound)[:n]


@partial(jax.jit, static_argnums=(2,))
def _census_padded(labels: Array, n_dyn: Array, n_bound: int) -> Array:
    """Census body at a static padded bound; rows past n_dyn are zeros."""
    cubes = _vertex_cube_labels(labels)  # [vx, vy, vz, 8], -1 = out of grid
    vshape = cubes.shape[:-1]
    Nv = int(np.prod(vshape))
    slot = [cubes[..., k] for k in range(8)]

    # eq[k][j] = slot k and slot j hold the same label
    eq = [[slot[k] == slot[j] for j in range(8)] for k in range(8)]
    # first occurrence of this label within the cube -> the node's canonical slot
    first = []
    for k in range(8):
        f = jnp.ones(vshape, bool)
        for j in range(k):
            f = f & ~eq[k][j]
        first.append(f)

    # per-(vertex, slot) exposed-edge census w.r.t. that slot's label
    # edge e exposed <=> its 4 surrounding voxels are mixed (some ==c, some !=c)
    exposure = []  # [8][6] bool arrays
    count = [jnp.zeros(vshape, jnp.int32) for _ in range(8)]
    mixed_cube = []
    for k in range(8):
        all_same = jnp.ones(vshape, bool)
        for j in range(8):
            all_same = all_same & eq[k][j]
        mixed_cube.append(~all_same)
        exp_k = []
        for e, group in enumerate(_EDGE_GROUPS):
            any_c = jnp.zeros(vshape, bool)
            all_c = jnp.ones(vshape, bool)
            for j in group:
                any_c = any_c | eq[k][j]
                all_c = all_c & eq[k][j]
            mixed_e = any_c & ~all_c
            exp_k.append(mixed_e)
            count[k] = count[k] + mixed_e.astype(jnp.int32)
        exposure.append(exp_k)

    n = n_dyn  # traced true component count; n_bound is the static shape
    valid = [
        first[k] & (slot[k] >= 1) & (slot[k] <= n) & mixed_cube[k] for k in range(8)
    ]
    comp_of = [jnp.clip(slot[k], 0, n) for k in range(8)]

    def hist(pred):
        h = jnp.zeros(n_bound + 1, jnp.int32)
        for k in range(8):
            w = (valid[k] & pred[k]).astype(jnp.int32)
            h = h + jnp.bincount(
                comp_of[k].reshape(-1), weights=w.reshape(-1), length=n_bound + 1
            ).astype(jnp.int32)
        return h[1:]

    M3 = hist([count[k] == 3 for k in range(8)])
    M5 = hist([count[k] == 5 for k in range(8)])
    M6 = hist([count[k] == 6 for k in range(8)])

    # joint surface-vertex CC: node = (vertex, cube label); nodes connect
    # along exposed vertex edges to the SAME label at the neighbor vertex.
    # Sentinel must exceed every node id (vertex*8 + slot): use int32 max.
    BIGN = np.int32(np.iinfo(np.int32).max)
    flatv = jnp.arange(Nv, dtype=jnp.int32).reshape(vshape) * 8
    # canonical node id per slot: vertex*8 + first slot holding this label
    canon_node = []
    for k in range(8):
        node = jnp.full(vshape, 7, jnp.int32)
        for j in range(7, -1, -1):
            node = jnp.where(eq[k][j], jnp.int32(j), node)
        canon_node.append(node)
    lab0 = []
    for k in range(8):
        active = (slot[k] >= 1) & (slot[k] <= n) & mixed_cube[k]
        lab0.append(jnp.where(active, flatv + canon_node[k], BIGN))

    edge_dirs = [(2, -1), (2, 1), (1, -1), (1, 1), (0, -1), (0, 1)]

    def body(state):
        labs, _ = state
        new = list(labs)
        for e, (axis, sign) in enumerate(edge_dirs):
            lab_nb = [_shift(labs[j], axis, sign, BIGN) for j in range(8)]
            slot_nb = [_shift(slot[j], axis, sign, -2) for j in range(8)]
            for k in range(8):
                cand = jnp.full(vshape, BIGN, jnp.int32)
                for j in range(8):
                    m = slot[k] == slot_nb[j]
                    cand = jnp.minimum(cand, jnp.where(m, lab_nb[j], BIGN))
                cand = jnp.where(exposure[k][e], cand, BIGN)
                new[k] = jnp.minimum(new[k], cand)
        # within-vertex canonicalization: same-label slots share the min
        canon = list(new)
        for k in range(8):
            for j in range(8):
                if j == k:
                    continue
                canon[k] = jnp.minimum(
                    canon[k], jnp.where(eq[k][j], new[j], BIGN)
                )
        done = jnp.array(True)
        for k in range(8):
            done = done & jnp.all(canon[k] == labs[k])
        return tuple(canon), done

    def cond(state):
        _, done = state
        return ~done

    labs0 = tuple(lab0)
    done0 = jnp.array(False)
    labs, _ = lax.while_loop(cond, body, (labs0, done0))

    # roots: active node whose label equals its own id -> one per surface set
    # (count only at the canonical slot so each node is counted once)
    n_surf = jnp.zeros(n_bound + 1, jnp.int32)
    for k in range(8):
        is_root = valid[k] & (labs[k] == flatv + canon_node[k])
        n_surf = n_surf + jnp.bincount(
            comp_of[k].reshape(-1),
            weights=is_root.astype(jnp.int32).reshape(-1),
            length=n_bound + 1,
        ).astype(jnp.int32)
    n_voids = jnp.maximum(n_surf[1:] - 1, 0)
    holes = 1 + (M5 + 2 * M6 - M3) // 8 + n_voids
    out = jnp.stack([holes, n_voids], axis=-1)
    # zero the padding rows (they would otherwise read holes=1)
    real = (jnp.arange(n_bound, dtype=jnp.int32) < n)[:, None]
    return jnp.where(real, out, 0)


def compute_component_topology(labels: Array, n_components: int) -> np.ndarray:
    """Host utility: [(holes, voids)] for components 1..n_components.

    Mirrors ``CollisionMapGrid::ComputeComponentTopology``
    (collision_map.cpp:620-671) but in ONE device pass for all components
    (the reference loops components serially; see
    :func:`component_topology_census`).
    """
    n = int(n_components)
    if n <= 0:
        return np.zeros((0, 2), np.int32)
    return np.asarray(component_topology_census(jnp.asarray(labels), n))


# ---------------------------------------------------------------------------
# Local extrema (watershed) map via pointer doubling
# ---------------------------------------------------------------------------


def local_extrema_map(sdf: SdfGrid) -> Array:
    """Dense [nx,ny,nz,3] map of the local extremum each cell's gradient walk
    reaches (reference ``ComputeLocalExtremaMap``, sdf.cpp:186-207).

    Semantics mirrored from sdf.cpp:23-183: world-frame gradient with edge
    gradients; step = sign(component) where |g| > res*0.06125 per axis (sign
    flipped inside obstacles); flat gradient => terminal at the cell's
    grid-frame center; stepping off-grid => (+inf,+inf,+inf). Cycles resolve
    to the minimum-flat-index cycle member (see module docstring).
    """
    shape = sdf.shape
    nx, ny, nz = shape
    N = nx * ny * nz
    res = sdf.resolution

    ix = jnp.arange(nx, dtype=jnp.int32)[:, None, None]
    iy = jnp.arange(ny, dtype=jnp.int32)[None, :, None]
    iz = jnp.arange(nz, dtype=jnp.int32)[None, None, :]
    idx = jnp.stack(jnp.broadcast_arrays(ix, iy, iz), axis=-1)  # [...,3]

    grad, _ = query.gradient(sdf, idx, enable_edge_gradients=True)
    thresh = res * 0.06125
    flat_grad = jnp.all(jnp.abs(grad) <= thresh, axis=-1)
    wg = jnp.where((sdf.values < 0.0)[..., None], -grad, grad)
    step = jnp.where(wg > thresh, 1, jnp.where(wg < -thresh, -1, 0)).astype(jnp.int32)
    nxt = idx + step
    off = ~sdf.meta.index_in_bounds(nxt)

    # terminal classification
    # 0 = walk, 1 = flat terminal, 2 = off-grid terminal
    terminal = jnp.where(flat_grad, 1, jnp.where(off, 2, 0)).astype(jnp.int32)
    nxt_flat = (nxt[..., 0] * ny + nxt[..., 1]) * nz + nxt[..., 2]
    self_flat = (idx[..., 0] * ny + idx[..., 1]) * nz + idx[..., 2]
    ptr = jnp.where(terminal != 0, self_flat, nxt_flat).reshape(-1)
    term = terminal.reshape(-1)

    # pointer doubling: carry (ptr, term-of-root-so-far)
    n_steps = int(np.ceil(np.log2(max(N, 2)))) + 1
    for _ in range(n_steps):
        t_at_ptr = term[ptr]
        new_ptr = jnp.where(t_at_ptr != 0, ptr, ptr[ptr])
        ptr = new_ptr

    # cells whose root is a terminal adopt its extremum; others are cyclic
    root_term = term[ptr]
    cyclic = root_term == 0

    # canonicalize cycles: min flat index over the cycle via min-doubling
    mptr = ptr
    mval = jnp.where(cyclic, ptr, _BIG)
    p2 = ptr
    for _ in range(n_steps):
        mval = jnp.minimum(mval, mval[p2])
        p2 = p2[p2]
    cycle_root = mval  # min flat index over reachable set (cycle)
    root = jnp.where(cyclic, cycle_root, ptr)

    # extremum value per root
    centers = sdf.meta.index_to_location_grid_frame(idx).reshape(-1, 3)
    root_is_off = term[root] == 2
    ext = jnp.where(root_is_off[:, None], jnp.inf, centers[root])
    return ext.reshape(shape + (3,))


# ---------------------------------------------------------------------------
# Convex segmentation (reference UpdateConvexSegments,
# tagged_object_collision_map.cpp:552-654)
# ---------------------------------------------------------------------------


def convex_segments(
    tmap: TaggedCollisionMap,
    sdf: SdfGrid,
    connected_threshold,
) -> Tuple[Array, Array]:
    """Label convex segments. Returns (segment labels uint32, count).

    Connectivity: 6-adjacent cells with the same object_id whose watershed
    extrema are within ``connected_threshold`` (Euclidean). Eligible cells:
    free (occupancy < 0.5) or object cells (object_id > 0), with finite
    extrema. The SDF should be the virtual-border or free+named variant the
    reference uses (caller's choice; see tagged_object_collision_map.cpp:556).
    """
    extrema = local_extrema_map(sdf)
    finite = jnp.all(jnp.isfinite(extrema), axis=-1)
    eligible = ((tmap.occupancy < 0.5) | (tmap.object_id > 0)) & finite

    same = []
    for axis, sign in _DIRS6:
        nb_obj = _shift(tmap.object_id, axis, sign, jnp.uint32(2**31))
        nb_ext = _shift(extrema, axis, sign, jnp.inf)
        dist = jnp.linalg.norm(nb_ext - extrema, axis=-1)
        same.append((nb_obj == tmap.object_id) & (dist < connected_threshold))
    conn = _symmetric_conn(eligible, same)
    return connected_components_from_adjacency(eligible, conn)


# ---------------------------------------------------------------------------
# Misc: resample (collision_map.cpp:673-695)
# ---------------------------------------------------------------------------


def resample_nearest(values: Array, meta: GridMeta, new_resolution) -> Tuple[Array, GridMeta]:
    """Resample a grid to a new resolution by nearest-location copy."""
    new_shape = tuple(
        max(1, int(np.ceil(s * float(meta.resolution) / float(new_resolution) - 1e-4)))
        for s in meta.shape
    )
    new_meta = GridMeta.create(
        meta.origin_transform, new_resolution, new_shape, meta.frame
    )
    ix = jnp.arange(new_shape[0])[:, None, None]
    iy = jnp.arange(new_shape[1])[None, :, None]
    iz = jnp.arange(new_shape[2])[None, None, :]
    idx = jnp.stack(jnp.broadcast_arrays(ix, iy, iz), axis=-1)
    loc = new_meta.index_to_location(idx)
    old_idx = meta.location_to_index(loc)
    old_idx = jnp.clip(old_idx, 0, jnp.asarray(meta.shape) - 1)
    _, ny, nz = meta.shape
    flat = (old_idx[..., 0] * ny + old_idx[..., 1]) * nz + old_idx[..., 2]
    return values.reshape(-1)[flat], new_meta
