"""Pallas (Triton route) kernel for the parabolic-envelope EDT pass on Hopper.

The envelope pass computes, along one axis of an int32 volume,

    out[i] = min_j f[j] + (i - j)^2

exactly (the second and third passes of the separable EDT; ``ops/edt.py``).
The plain XLA version (``edt.envelope_pass_stencil``) relaxes the WHOLE
volume once per unit of distance: each iteration reads and writes every
cell and reduces a convergence flag over all of them, for as many
iterations as the volume's largest winning distance.

Kernel design:
  * One program owns a tile of whole lines: the scanned axis is never split,
    so no state crosses programs and nothing carries between them.
  * The tile is relaxed by a direct windowed minimum in order of increasing
    offset s = 1, 2, ...: ``acc[i] = min(acc[i], f[i-s] + s^2, f[i+s] + s^2)``
    with the shifted values read from the immutable input (L1/L2 resident
    after the first touch), so there is no in-kernel write-back and no
    barrier.
  * Per-tile exact early exit: a source further than s from cell i costs at
    least ``min_line(f) + (s+1)^2``, so once every cell of the tile has
    ``acc - min_line(f) <= (s+1)^2`` no later offset can improve it. The
    tile's work is its own largest remaining distance, not the volume's.
  * ``SHIFTS`` offsets run between two such checks (the check is a
    reduction over the whole tile).
  * The two-field variants relax the filled and the free field in one
    program; the last-axis variant writes the signed f32 distance as its
    epilogue (one f32 write instead of two int32 fields and a separate
    combine pass).

Layouts: the array is viewed as [A, n, B] around the scanned axis. For the
last axis (B == 1) a tile is [lines, n] with lines contiguous in memory along
its minor dim; otherwise a tile is [n, B-chunk], with the contiguous B axis
minor, so every load of the tile is coalesced.

``interpret=True`` runs the same kernel in the Pallas interpreter (CPU
tests); the compiled route is Triton, for the GPU only.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

INF_D2 = 1 << 29  # python int: kernels must not capture traced constants

# Cells per program tile (powers of two; a tile always holds whole lines, so
# lines longer than the tile get one line per program). Swept at 512^3 on an
# H100 (scripts/tune_envelope.py; PERF.md): the strided layout wants wide
# rows of lines for coalescing, the contiguous layout wants few lines per
# tile so that each tile's early exit follows its own lines.
TILE_STRIDED = 8192
TILE_CONTIGUOUS = 512

# Offsets relaxed between two tile-wide exit checks.
SHIFTS = 4

# Warps per program.
NUM_WARPS = 8


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def _out_struct(x, shape, dtype):
    """ShapeDtypeStruct carrying the input's varying-manual-axes type so the
    kernel composes with shard_map(check_vma=True) (sharded EDT paths)."""
    vma = jax.typeof(x).vma
    if vma:
        return jax.ShapeDtypeStruct(shape, dtype, vma=vma)
    return jax.ShapeDtypeStruct(shape, dtype)


def _geometry(shape, axis: int, tile: int):
    """(n, B, R, C, pdim, n_lines, grid) of the [A, n, B] tiling."""
    n = shape[axis]
    A = int(np.prod(shape[:axis], dtype=np.int64))
    B = int(np.prod(shape[axis + 1 :], dtype=np.int64))
    tn = _next_pow2(n)
    if tile is None:
        tile = TILE_CONTIGUOUS if B == 1 else TILE_STRIDED
    if tile <= 0 or tile & (tile - 1):
        raise ValueError(f"tile must be a power of two, got {tile}")
    if B == 1:
        # tile [lines, n]: positions on the minor (contiguous) dim
        R, C, pdim = max(1, tile // tn), tn, 1
        grid = (pl.cdiv(A, R),)
    else:
        # tile [n, B-chunk]: the contiguous B axis on the minor dim
        R, C, pdim = tn, max(1, min(tile // tn, _next_pow2(B))), 0
        grid = (A * pl.cdiv(B, C),)
    return n, B, R, C, pdim, A * B, grid


def _relax(f_ref, flat, valid, i, n: int, stride: int, pdim: int, shifts: int):
    """Exact envelope of the tile at flat indices ``flat`` (see module doc)."""
    f = pltriton.load(f_ref.at[flat], mask=valid, other=INF_D2)
    # per-line minimum along the scanned axis (invalid cells read INF)
    fmin = jnp.min(f, axis=pdim, keepdims=True)

    def cond(state):
        return jnp.logical_not(state[2])

    def body(state):
        s, acc, _ = state
        for u in range(1, shifts + 1):
            sh = s + u
            up = pltriton.load(
                f_ref.at[flat - sh * stride], mask=valid & (i >= sh), other=INF_D2
            )
            dn = pltriton.load(
                f_ref.at[flat + sh * stride], mask=valid & (i + sh < n), other=INF_D2
            )
            acc = jnp.minimum(acc, jnp.minimum(up, dn) + sh * sh)
        s = s + shifts
        gap = jnp.max(jnp.where(valid, acc - fmin, 0))
        done = (gap <= (s + 1) * (s + 1)) | (s >= n - 1)
        return s, acc, done

    _, acc, _ = lax.while_loop(cond, body, (jnp.int32(0), f, jnp.bool_(False)))
    return acc


def _envelope_kernel(
    n: int, B: int, R: int, C: int, pdim: int, n_lines: int, shifts: int,
    n_fields: int, combine: bool, *refs,
):
    """One tile of whole lines for ``n_fields`` fields; with ``combine``
    (two fields) the epilogue writes sqrt(a)*res - sqrt(b)*res in f32, the
    op sequence of ``edt.d2_to_distance(a) - edt.d2_to_distance(b)``."""
    t = pl.program_id(0)
    i = lax.broadcasted_iota(jnp.int32, (R, C), pdim)
    l = lax.broadcasted_iota(jnp.int32, (R, C), 1 - pdim)
    if B == 1:
        line = t * R + l
        flat = line * n + i
        line_ok = line < n_lines
        stride = 1
    else:
        nb = pl.cdiv(B, C)
        a = t // nb
        b = (t % nb) * C + l
        flat = a * (n * B) + i * B + b
        line_ok = b < B
        stride = B
    valid = line_ok & (i < n)
    if combine:
        res_ref, fa_ref, fb_ref, out_ref = refs
        da = _relax(fa_ref, flat, valid, i, n, stride, pdim, shifts)
        db = _relax(fb_ref, flat, valid, i, n, stride, pdim, shifts)
        res = pltriton.load(res_ref.at[0])
        va = jnp.sqrt(jnp.where(da >= INF_D2, jnp.inf, da.astype(jnp.float32)))
        vb = jnp.sqrt(jnp.where(db >= INF_D2, jnp.inf, db.astype(jnp.float32)))
        pltriton.store(out_ref.at[flat], va * res - vb * res, mask=valid)
        return
    ins, outs = refs[:n_fields], refs[n_fields:]
    for f_ref, o_ref in zip(ins, outs):
        d = _relax(f_ref, flat, valid, i, n, stride, pdim, shifts)
        pltriton.store(o_ref.at[flat], d, mask=valid)


def _call(fields, axis, interpret, tile, shifts, num_warps, resolution=None):
    shape = fields[0].shape
    for f in fields:
        if f.shape != shape:
            raise ValueError(f"field shapes differ: {[g.shape for g in fields]}")
    if not -len(shape) <= axis < len(shape):
        raise ValueError(f"axis {axis} out of range for shape {shape}")
    axis %= len(shape)
    size = int(np.prod(shape, dtype=np.int64))
    if size >= 2**31:
        raise ValueError(f"volume of {size} cells exceeds int32 indexing")
    shifts = SHIFTS if shifts is None else shifts
    n, B, R, C, pdim, n_lines, grid = _geometry(shape, axis, tile)
    combine = resolution is not None
    kernel = functools.partial(
        _envelope_kernel, n, B, R, C, pdim, n_lines, shifts, len(fields), combine
    )
    flat = [f.astype(jnp.int32).reshape(-1) for f in fields]
    if combine:
        out_shape = _out_struct(fields[0], (size,), jnp.float32)
        args = [jnp.asarray(resolution, jnp.float32).reshape(1)] + flat
    else:
        out_shape = [_out_struct(f, (size,), jnp.int32) for f in fields]
        args = flat
    out = pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=grid,
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=NUM_WARPS if num_warps is None else num_warps, num_stages=1
        ),
        interpret=interpret,
        name=f"sdf_envelope_{len(fields)}f{'_combine' if combine else ''}",
    )(*args)
    if combine:
        return out.reshape(shape)
    return tuple(o.reshape(shape) for o in out)


_STATIC = ("interpret", "tile", "shifts", "num_warps")


@functools.partial(jax.jit, static_argnames=("axis",) + _STATIC)
def envelope_pass_pallas(
    f: jax.Array, axis: int, interpret: bool = False,
    tile: int | None = None, shifts: int | None = None,
    num_warps: int | None = None,
) -> jax.Array:
    """Exact envelope transform of ``f`` along ``axis`` (any axis, any rank)."""
    if f.shape[axis] == 1:
        return f
    (out,) = _call((f,), axis, interpret, tile, shifts, num_warps)
    return out


@functools.partial(jax.jit, static_argnames=("axis",) + _STATIC)
def envelope_dual_pallas(
    fa: jax.Array, fb: jax.Array, axis: int, interpret: bool = False,
    tile: int | None = None, shifts: int | None = None,
    num_warps: int | None = None,
):
    """(out_a, out_b): exact envelopes of two fields along ``axis`` from one
    kernel launch; identical to two ``envelope_pass_pallas`` calls."""
    if fa.shape[axis] == 1:
        return fa, fb
    return _call((fa, fb), axis, interpret, tile, shifts, num_warps)


@functools.partial(jax.jit, static_argnames=_STATIC)
def envelope_dual_combine_pallas(
    fa: jax.Array, fb: jax.Array, resolution, interpret: bool = False,
    tile: int | None = None, shifts: int | None = None,
    num_warps: int | None = None,
) -> jax.Array:
    """f32 signed distances: the last-axis envelope of both d^2 fields with
    the signed combine ``sqrt(a)*res - sqrt(b)*res`` as the epilogue
    (``resolution`` is a scalar; INF_D2 maps to +/-inf)."""
    if fa.shape[-1] == 1:
        from . import edt

        res = jnp.asarray(resolution, jnp.float32)
        return edt.d2_to_distance(fa, res) - edt.d2_to_distance(fb, res)
    return _call(
        (fa, fb), -1, interpret, tile, shifts, num_warps, resolution=resolution
    )
