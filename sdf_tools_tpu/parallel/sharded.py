"""Multi-device volume sharding for the EDT and render pipeline.

The reference is single-process/single-thread (SURVEY.md §2: no parallelism
of any kind); this module is the new first-class scaling layer mandated by
BASELINE.json: the voxel volume is tiled over a ``jax.sharding.Mesh`` and the
separable EDT runs with collectives between per-axis sweeps.

Two exact strategies (SURVEY.md §7 asks to measure both):
  * ``sharded_squared_edt`` (boundary-summary method, default): the volume is
    sharded on the x axis and the pass ORDER is chosen so the sharded axis
    runs the *binary* line pass: its cross-shard influence reduces to two
    scalars per line per shard (distance from each shard boundary to its
    nearest local seed), resolved with one tiny ``all_gather`` —
    communication is O(surface), independent of volume AND iteration count.
    The parabolic envelope passes then run along the unsharded y/z axes,
    which are entirely local. Exact by construction.
  * ``sharded_envelope_axis0_halo`` (halo method): runs the odd-weight
    relaxation along the sharded axis with a K-cell halo exchanged via
    ``ppermute`` every K iterations. Traffic scales with iteration count /
    K. Provided for measurement and for future 2-D meshes where two of the
    three axes are sharded.

All functions are written to run inside ``shard_map`` over a mesh axis named
``"x"`` (optionally nested under a data-parallel axis).
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import edt

Array = jax.Array


def make_mesh(axis_sizes: dict[str, int], devices=None) -> Mesh:
    """Build a mesh from {axis_name: size}; sizes must multiply to #devices."""
    if devices is None:
        devices = jax.devices()
    names = tuple(axis_sizes.keys())
    sizes = tuple(axis_sizes.values())
    total = int(np.prod(sizes))
    if total > len(devices):
        raise ValueError(f"need {total} devices, have {len(devices)}")
    dev = np.asarray(devices[:total]).reshape(sizes)
    return Mesh(dev, names)


# ---------------------------------------------------------------------------
# Inside-shard_map building blocks (axis name "x" shards array axis 0)
# ---------------------------------------------------------------------------


def _square_line_d2(d: Array) -> Array:
    """Linear line distance (1<<24 sentinel) -> squared d^2 (INF_D2
    sentinel) — the one canonical copy of the sentinel-squaring math."""
    no_seed = d >= jnp.int32(1 << 24)
    return jnp.where(no_seed, edt.INF_D2, d * d).astype(jnp.int32)


def _local_line_d2_sharded_axis0(mask_local: Array, axis_name: str) -> Array:
    """Binary line-distance pass along the SHARDED axis 0.

    Each shard computes distance to its local nearest seed with the cummax
    trick, then the cross-shard influence is resolved by exchanging, per
    line, the distance-to-nearest-seed measured from each shard boundary.
    Implemented as: compute global via transpose-free two-scan over shards
    using associative prefix mins through ``lax.all_gather`` of per-shard
    line summaries (cheap: 2 scalars per line per shard).
    """
    n_local = mask_local.shape[0]
    idx = lax.axis_index(axis_name)
    d_local = edt.line_distance_to_seed(mask_local, 0)  # sentinel ~2^24
    SENT = jnp.int32(1 << 24)
    # per-line: distance from the low boundary (cell 0 of this shard) to the
    # nearest local seed, and from the high boundary
    iota = jnp.arange(n_local, dtype=jnp.int32)[:, None, None]
    has = mask_local.astype(jnp.int32)
    first_seed = jnp.min(jnp.where(mask_local, iota, SENT), axis=0)  # [ny,nz]
    last_seed = jnp.max(jnp.where(mask_local, iota, -SENT), axis=0)
    dist_from_low = jnp.where(first_seed >= SENT, SENT, first_seed)
    dist_from_high = jnp.where(last_seed <= -SENT, SENT, n_local - 1 - last_seed)
    # gather all shards' summaries: [P, ny, nz]
    lows = lax.all_gather(dist_from_low, axis_name)
    highs = lax.all_gather(dist_from_high, axis_name)
    P_ = lows.shape[0]
    # nearest seed below my shard (in cells, measured from my cell 0):
    # for shard j < idx: distance = (idx - j - 1)*n_local + highs[j]
    sh = jnp.arange(P_, dtype=jnp.int32)[:, None, None]
    below = jnp.where(
        sh < idx, (idx - sh - 1) * n_local + highs + 1, SENT
    )  # +1: boundary crossing
    best_below = jnp.min(below, axis=0)  # [ny,nz] distance from my cell 0 - 1... see use
    above = jnp.where(sh > idx, (sh - idx - 1) * n_local + lows + 1, SENT)
    best_above = jnp.min(above, axis=0)  # distance from my cell n_local-1 + 1
    d_from_below = best_below[None] + iota[:, :, :]  # dist via low boundary
    d_from_above = best_above[None] + (n_local - 1 - iota)
    d = jnp.minimum(d_local, jnp.minimum(d_from_below, d_from_above))
    return jnp.minimum(d, SENT)


def _sharded_line_pass_d2(mask_local: Array, axis_name: str) -> Array:
    return _square_line_d2(_local_line_d2_sharded_axis0(mask_local, axis_name))


def sharded_squared_edt(
    mask_local: Array, axis_name: str = "x", backend: str = "auto",
    interpret: bool = False,
) -> Array:
    """Exact squared EDT of an x-sharded volume; call inside shard_map.

    mask_local: [nx_local, ny, nz] bool — this shard's x-slab.
    Returns the local slab of the exact global d^2 (int32).

    Pass order: line pass along sharded x (boundary-summary exchange, exact),
    then local envelope passes along y and z — both have their full axis
    extents locally, so no further communication is needed.
    """
    env = edt._envelope_fn(edt.resolve_backend(backend, interpret), interpret)
    f = _sharded_line_pass_d2(mask_local, axis_name)
    f = env(f, 1)
    f = env(f, 2)
    return f


def _local_line_d2_dual_sharded_axis0(
    mask_local: Array, axis_name: str
) -> Tuple[Array, Array]:
    """Both fields' line distances along the sharded axis 0 with ONE
    stacked boundary-summary all_gather (the two-field counterpart of
    `_local_line_d2_sharded_axis0`). Returns LINEAR distances with the
    1<<24 sentinel for (seeds=mask, seeds=~mask).
    """
    n_local = mask_local.shape[0]
    idx = lax.axis_index(axis_name)
    da = edt.line_distance_to_seed(mask_local, 0)
    db = edt.line_distance_to_seed(~mask_local, 0)
    SENT = jnp.int32(1 << 24)
    iota = jnp.arange(n_local, dtype=jnp.int32)[:, None, None]

    def summaries(m):
        first_seed = jnp.min(jnp.where(m, iota, SENT), axis=0)
        last_seed = jnp.max(jnp.where(m, iota, -SENT), axis=0)
        low = jnp.where(first_seed >= SENT, SENT, first_seed)
        high = jnp.where(last_seed <= -SENT, SENT, n_local - 1 - last_seed)
        return low, high

    low_a, high_a = summaries(mask_local)
    low_b, high_b = summaries(~mask_local)
    # one collective for all four per-line summaries: [P, 4, ny, nz]
    packed = jnp.stack([low_a, high_a, low_b, high_b], axis=0)
    allp = lax.all_gather(packed, axis_name)
    P_ = allp.shape[0]
    sh = jnp.arange(P_, dtype=jnp.int32)[:, None, None]

    def combine(d_local, lows, highs):
        below = jnp.where(sh < idx, (idx - sh - 1) * n_local + highs + 1, SENT)
        best_below = jnp.min(below, axis=0)
        above = jnp.where(sh > idx, (sh - idx - 1) * n_local + lows + 1, SENT)
        best_above = jnp.min(above, axis=0)
        d = jnp.minimum(
            d_local,
            jnp.minimum(
                best_below[None] + iota[:, :, :],
                best_above[None] + (n_local - 1 - iota),
            ),
        )
        return jnp.minimum(d, SENT)

    da = combine(da, allp[:, 0], allp[:, 1])
    db = combine(db, allp[:, 2], allp[:, 3])
    return da, db


def sharded_signed_field(
    filled_local: Array,
    resolution,
    axis_name: str = "x",
    backend: str = "auto",
    interpret: bool = False,
) -> Array:
    """Sharded two-field signed combine (local slab of the global SDF).

    On the pallas backend the two fields run together end to end, mirroring
    the single-device route: one stacked boundary collective, the two-field
    y envelope, and the z envelope with the signed combine as the kernel
    epilogue. Bitwise identical to the separate per-field path.
    """
    if (
        edt.resolve_backend(backend, interpret) == "pallas"
        and filled_local.ndim == 3
    ):
        from ..ops import edt_pallas

        da, db = _local_line_d2_dual_sharded_axis0(filled_local, axis_name)
        fa = _square_line_d2(da)
        fb = _square_line_d2(db)
        fa, fb = edt_pallas.envelope_dual_pallas(fa, fb, 1, interpret=interpret)
        return edt_pallas.envelope_dual_combine_pallas(
            fa, fb, resolution, interpret=interpret
        )
    d2f = sharded_squared_edt(filled_local, axis_name, backend, interpret)
    d2e = sharded_squared_edt(~filled_local, axis_name, backend, interpret)
    return edt.d2_to_distance(d2f, resolution) - edt.d2_to_distance(d2e, resolution)


# ---------------------------------------------------------------------------
# Halo variant (for measurement; BASELINE names halo exchange explicitly)
# ---------------------------------------------------------------------------


def _halo_exchange(d_local: Array, axis_name: str, width: int) -> Tuple[Array, Array]:
    """Fetch `width` cells from the axis-0 neighbors via ppermute.

    Returns (lo_halo [width,...], hi_halo [width,...]) filled with INF at the
    volume boundary.
    """
    n_dev = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    send_up = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    send_dn = [(i, (i - 1) % n_dev) for i in range(n_dev)]
    top = d_local[-width:]
    bot = d_local[:width]
    lo_halo = lax.ppermute(top, axis_name, send_up)  # from idx-1
    hi_halo = lax.ppermute(bot, axis_name, send_dn)  # from idx+1
    INF = jnp.int32(edt.INF_D2)
    lo_halo = jnp.where(idx == 0, INF, lo_halo)
    hi_halo = jnp.where(idx == n_dev - 1, INF, hi_halo)
    return lo_halo, hi_halo


def sharded_envelope_axis0_halo(
    f_local: Array, axis_name: str = "x", halo: int = 16
) -> Array:
    """Exact envelope along the SHARDED axis 0 via halo-iterated relaxation.

    Runs the odd-weight 3-tap relaxation; every `halo` iterations the shards
    exchange `halo` boundary cells, so information crosses shard boundaries
    correctly. Iterates until global quiescence (psum convergence flag).
    """
    n_local = f_local.shape[0]
    # a halo wider than the shard would slice short and misalign the
    # interior window; clamp (multi-hop influence still converges because
    # the outer while_loop keeps iterating until global quiescence)
    halo = min(halo, n_local)
    n_dev = lax.axis_size(axis_name)
    n_total = n_local * n_dev

    def cond(state):
        t, d, done = state
        return jnp.logical_and(~done, t <= n_total)

    def body(state):
        t, d, _ = state
        lo, hi = _halo_exchange(d, axis_name, halo)
        ext = jnp.concatenate([lo, d, hi], axis=0)

        def one(k, e):
            c = 2 * (t + k) - 1
            up = jnp.concatenate(
                [jnp.full_like(e[:1], edt.INF_D2), e[:-1]], axis=0
            )
            dn = jnp.concatenate(
                [e[1:], jnp.full_like(e[:1], edt.INF_D2)], axis=0
            )
            return jnp.minimum(e, jnp.minimum(up, dn) + c)

        new_ext = lax.fori_loop(0, halo, one, ext)
        new_d = new_ext[halo : halo + n_local]
        changed = jnp.any(new_d != d)
        any_changed = lax.psum(changed.astype(jnp.int32), axis_name) > 0
        return t + halo, new_d, ~any_changed

    # init flags derived from f_local so their varying-axis types match the
    # body's data-dependent values under shard_map (multi-axis meshes)
    done0 = lax.psum(jnp.any(f_local != f_local).astype(jnp.int32), axis_name) > 0
    t0 = jnp.int32(1) + jnp.zeros((), jnp.int32) * f_local.reshape(-1)[0]
    _, d_final, _ = lax.while_loop(cond, body, (t0, f_local, done0))
    return d_final


# ---------------------------------------------------------------------------
# 2-D mesh volume sharding: (x, y) tiles (SURVEY §7 "hard parts": measure
# reshard-between-passes vs halo on multi-axis meshes)
# ---------------------------------------------------------------------------


def _all_to_all_swap(f_local: Array, axis_name: str, split_axis: int, concat_axis: int) -> Array:
    """all_to_all resharding: split ``split_axis`` over the mesh axis and
    gather ``concat_axis`` — the volume transpose between envelope passes."""
    n_dev = lax.axis_size(axis_name)
    return lax.all_to_all(
        f_local, axis_name, split_axis=split_axis, concat_axis=concat_axis, tiled=True
    )


def sharded_squared_edt_2d(
    mask_local: Array,
    axis_x: str = "x",
    axis_y: str = "y",
    backend: str = "auto",
    method: str = "reshard",
    interpret: bool = False,
) -> Array:
    """Exact squared EDT of a volume sharded over a 2-D mesh (x, y) tiles.

    mask_local: [nx_loc, ny_loc, nz] — this device's tile; call inside
    shard_map with in_specs P(axis_x, axis_y).

    Two exact strategies (SURVEY §7 asks to measure both):
      * ``method="reshard"``: x line pass with boundary summaries over
        ``axis_x`` (O(surface) comm); z envelope locally (z is unsharded);
        then ONE ``all_to_all`` over ``axis_y`` swaps the y and z shardings
        so the y envelope also runs locally. Output tiles are [nx_loc, ny,
        nz/Py] — resharded back to the input layout with a second
        ``all_to_all`` so callers see the tiling they provided. Comm:
        2 x volume/P all_to_all + O(surface).
      * ``method="halo"``: y envelope runs in place via K-step halo-iterated
        relaxation over ``axis_y`` (comm scales with iteration count / K);
        z envelope local; no resharding.
    """
    env = edt._envelope_fn(edt.resolve_backend(backend, interpret), interpret)
    f = _sharded_line_pass_d2(mask_local, axis_x)
    if method == "reshard":
        f = env(f, 2)  # z is fully local on the input tiling
        f = _all_to_all_swap(f, axis_y, split_axis=2, concat_axis=1)  # [nxl, ny, nzl]
        f = env(f, 1)  # y now fully local
        f = _all_to_all_swap(f, axis_y, split_axis=1, concat_axis=2)  # back to input tiling
        return f
    elif method == "halo":
        # move the sharded y axis to position 0 for the halo relaxation
        fy = jnp.moveaxis(f, 1, 0)
        fy = sharded_envelope_axis0_halo(fy, axis_y, halo=16)
        f = jnp.moveaxis(fy, 0, 1)
        f = env(f, 2)
        return f
    raise ValueError(method)


def sharded_signed_field_2d(
    filled_local: Array,
    resolution,
    axis_x: str = "x",
    axis_y: str = "y",
    backend: str = "auto",
    method: str = "reshard",
    interpret: bool = False,
) -> Array:
    """Signed field on a 2-D (x, y) tile mesh (local tile of the global SDF).

    The pallas + reshard route runs both fields together: one stacked
    boundary collective over axis_x, the two-field z envelope, ONE stacked
    all_to_all carrying both fields, the two-field y envelope, and the
    combine BEFORE resharding back — so the return all_to_all moves one f32
    volume instead of two i32 volumes (2/3 of the reshard traffic of the
    per-field path in total). Bitwise identical to the per-field route.
    """
    if (
        edt.resolve_backend(backend, interpret) == "pallas"
        and method == "reshard"
        and filled_local.ndim == 3
    ):
        from ..ops import edt_pallas

        da, db = _local_line_d2_dual_sharded_axis0(filled_local, axis_x)
        fa = _square_line_d2(da)
        fb = _square_line_d2(db)
        fa, fb = edt_pallas.envelope_dual_pallas(fa, fb, 2, interpret=interpret)
        packed = jnp.stack([fa, fb])
        packed = _all_to_all_swap(packed, axis_y, split_axis=3, concat_axis=2)
        fa, fb = packed[0], packed[1]
        fa, fb = edt_pallas.envelope_dual_pallas(fa, fb, 1, interpret=interpret)
        dist = edt.d2_to_distance(fa, resolution) - edt.d2_to_distance(
            fb, resolution
        )
        return _all_to_all_swap(dist, axis_y, split_axis=1, concat_axis=2)
    d2f = sharded_squared_edt_2d(
        filled_local, axis_x, axis_y, backend, method, interpret
    )
    d2e = sharded_squared_edt_2d(
        ~filled_local, axis_x, axis_y, backend, method, interpret
    )
    return edt.d2_to_distance(d2f, resolution) - edt.d2_to_distance(d2e, resolution)


# ---------------------------------------------------------------------------
# Sharded rendering without the full-volume all_gather (round-2 redesign).
#
# Each device sphere-traces ALL rays but only inside its own x-slab: the
# slab's own AABB gives per-ray entry/exit, a 2-cell halo (differentiable
# ppermute) makes boundary trilinear queries exact, and a min-composite over
# the mesh axis picks each ray's first hit. Communication per step is
# O(rays + halo surface) — never O(volume). Each device gets the FULL step
# budget: a ray near-parallel to the slab faces traverses its whole length
# inside one slab (the in-slab path is 1/n_dev only for slab-perpendicular
# rays), and the march clamps marching to the slab AABB anyway, so rays that
# exit early are frozen and cost nothing extra per step.
# ---------------------------------------------------------------------------


def exchange_slab_halo(values_local: Array, axis_name: str, width: int) -> Array:
    """Extend an x-slab with ``width`` cells from each x neighbor.

    Differentiable (ppermute transposes route halo cotangents back to the
    owning shard). At the global volume ends the halo replicates the edge
    plane, matching the reference's edge-clamped trilinear interpolation
    (sdf.hpp:798-833 clamps corner cells at the grid border).
    """
    n_dev = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    send_up = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    send_dn = [(i, (i - 1) % n_dev) for i in range(n_dev)]
    top = values_local[-width:]
    bot = values_local[:width]
    lo_halo = lax.ppermute(top, axis_name, send_up)  # from idx-1
    hi_halo = lax.ppermute(bot, axis_name, send_dn)  # from idx+1
    edge_lo = jnp.broadcast_to(values_local[:1], lo_halo.shape)
    edge_hi = jnp.broadcast_to(values_local[-1:], hi_halo.shape)
    lo_halo = jnp.where(idx == 0, edge_lo, lo_halo)
    hi_halo = jnp.where(idx == n_dev - 1, edge_hi, hi_halo)
    return jnp.concatenate([lo_halo, values_local, hi_halo], axis=0)


def sharded_render_depth(
    values_local: Array,
    full_meta,
    oob_value,
    origins: Array,
    directions: Array,
    axis_name: str = "x",
    halo: int = 2,
    t_min: float = 0.0,
    t_max: float = 10.0,
    eps: float = 1e-3,
    max_steps: int = 96,
    min_step=None,
    backend: str = "auto",
):
    """Render depth for all rays over an x-sharded SDF; call inside shard_map.

    values_local: [nx_local, ny, nz] — this shard's slab of the global SDF.
    Returns (depth, hit) REPLICATED across ``axis_name`` (each ray's value
    comes from the shard whose slab contains its first surface crossing).
    """
    from ..grid import GridMeta, SdfGrid
    from ..ops import render as render_ops

    n_dev = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    nx_local = values_local.shape[0]
    res = full_meta.resolution

    ext = exchange_slab_halo(values_local, axis_name, halo)

    # Boundary shards: the ring exchange wraps the far SIDE of the volume
    # into the outer halo, so a ray entering through an obstacle at the
    # global x face would see wrapped below-eps values halo cells early and
    # report its entry hit displaced by exactly halo cells.
    # Fill the outer halos with 2*res: after the -res/2 corner correction
    # that is above every hit/graze/near-miss threshold, and it is a safe
    # sphere-trace step (the nearest in-volume surface is >= 1 cell from
    # any halo cell; overshoot <= res/2 is within the march's existing
    # bracketing semantics).
    xi = lax.broadcasted_iota(jnp.int32, ext.shape, 0)
    pad_val = jnp.asarray(2.0 * res, ext.dtype)
    outer = ((idx == 0) & (xi < halo)) | (
        (idx == n_dev - 1) & (xi >= halo + nx_local)
    )
    ext = jnp.where(outer, pad_val, ext)

    # slab meta: origin composed with a translation of (slab start - halo)
    # cells along the grid frame's own x axis
    x_off = (idx * nx_local - halo).astype(jnp.float32) * res
    T = jnp.eye(4, dtype=full_meta.origin_transform.dtype).at[0, 3].set(x_off)
    slab_transform = jnp.matmul(
        full_meta.origin_transform, T, precision=lax.Precision.HIGHEST
    )
    slab_meta = GridMeta.create(
        slab_transform,
        res,
        (nx_local + 2 * halo, values_local.shape[1], values_local.shape[2]),
        full_meta.frame,
    )
    slab_sdf = SdfGrid.create(ext, slab_meta, oob_value)

    # Full step budget per shard: a ray whose direction is dominated by y/z
    # travels its entire length inside ONE slab, so capping at max_steps //
    # n_dev silently turned long in-slab paths into misses (ADVICE r2).
    # Slab-perpendicular rays exit the slab AABB early and are frozen.
    result = render_ops.render_depth(
        slab_sdf,
        origins,
        directions,
        t_min=t_min,
        t_max=t_max,
        eps=eps,
        max_steps=max_steps,
        min_step=min_step,
        backend=backend,
    )
    depth_local = jnp.where(result.hit, result.depth, jnp.full_like(result.depth, t_max))

    # min-composite: the first surface crossing along each ray wins. Winner
    # selection is stop-gradded; cotangents flow to winning shards via psum
    # (ties share the cotangent equally — same surface, same dt/dvalues).
    depth_min = lax.pmin(lax.stop_gradient(depth_local), axis_name)
    win = lax.stop_gradient(depth_local) <= depth_min
    n_win = lax.psum(win.astype(depth_local.dtype), axis_name)
    weight = win.astype(depth_local.dtype) / jnp.maximum(n_win, 1.0)
    depth = lax.psum(weight * depth_local, axis_name)
    hit = lax.psum(result.hit.astype(jnp.int32), axis_name) > 0
    depth = jnp.where(hit, depth, jnp.full_like(depth, t_max))
    return depth, hit


def sharded_render_depth_2d(
    values_local: Array,
    full_meta,
    oob_value,
    origins: Array,
    directions: Array,
    axis_x: str = "x",
    axis_y: str = "y",
    halo: int = 2,
    t_min: float = 0.0,
    t_max: float = 10.0,
    eps: float = 1e-3,
    max_steps: int = 96,
    min_step=None,
    backend: str = "auto",
):
    """Render depth over a volume sharded as 2-D (x, y) TILES; call inside
    shard_map with the values in P(axis_x, axis_y) layout.

    The slab renderer generalized to tiles: a halo exchange along x first,
    then along y ON THE X-EXTENDED tile (so the y neighbors contribute their
    own x halos and the tile corners are exact for trilinear queries), each
    device traces all rays inside its tile AABB, and the min-composite runs
    over BOTH mesh axes. Communication is O(rays + halo surface) — the tiled
    volume is never gathered.
    """
    from ..grid import GridMeta, SdfGrid
    from ..ops import render as render_ops

    nx_local, ny_local = values_local.shape[0], values_local.shape[1]
    res = full_meta.resolution
    n_x, n_y = lax.axis_size(axis_x), lax.axis_size(axis_y)
    ix, iy = lax.axis_index(axis_x), lax.axis_index(axis_y)

    ext = exchange_slab_halo(values_local, axis_x, halo)
    ext = jnp.moveaxis(
        exchange_slab_halo(jnp.moveaxis(ext, 1, 0), axis_y, halo), 0, 1
    )

    # outer-halo fill on the volume boundary faces (same rationale as the
    # 1-D slab renderer above: the ring exchange wraps the far side in)
    xi = lax.broadcasted_iota(jnp.int32, ext.shape, 0)
    yi = lax.broadcasted_iota(jnp.int32, ext.shape, 1)
    outer = (
        ((ix == 0) & (xi < halo))
        | ((ix == n_x - 1) & (xi >= halo + nx_local))
        | ((iy == 0) & (yi < halo))
        | ((iy == n_y - 1) & (yi >= halo + ny_local))
    )
    ext = jnp.where(outer, jnp.asarray(2.0 * res, ext.dtype), ext)

    x_off = (ix * nx_local - halo).astype(jnp.float32) * res
    y_off = (iy * ny_local - halo).astype(jnp.float32) * res
    T = (
        jnp.eye(4, dtype=full_meta.origin_transform.dtype)
        .at[0, 3].set(x_off)
        .at[1, 3].set(y_off)
    )
    tile_meta = GridMeta.create(
        jnp.matmul(full_meta.origin_transform, T, precision=lax.Precision.HIGHEST),
        res, ext.shape, full_meta.frame,
    )
    tile_sdf = SdfGrid.create(ext, tile_meta, oob_value)

    result = render_ops.render_depth(
        tile_sdf,
        origins,
        directions,
        t_min=t_min,
        t_max=t_max,
        eps=eps,
        max_steps=max_steps,
        min_step=min_step,
        backend=backend,
    )
    depth_local = jnp.where(
        result.hit, result.depth, jnp.full_like(result.depth, t_max)
    )

    axes = (axis_x, axis_y)
    depth_min = lax.pmin(lax.stop_gradient(depth_local), axes)
    win = lax.stop_gradient(depth_local) <= depth_min
    n_win = lax.psum(win.astype(depth_local.dtype), axes)
    weight = win.astype(depth_local.dtype) / jnp.maximum(n_win, 1.0)
    depth = lax.psum(weight * depth_local, axes)
    hit = lax.psum(result.hit.astype(jnp.int32), axes) > 0
    depth = jnp.where(hit, depth, jnp.full_like(depth, t_max))
    return depth, hit
