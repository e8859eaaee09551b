"""Sweep the envelope kernel's tile, shifts and warps on the GPU.

Builds the 512^3 random-sphere scene and times, warmed (median, with
block_until_ready on the full result):
  * the x line pass of both fields (XLA cummax, and lax.associative_scan);
  * the XLA stencil signed field;
  * the two-field y pass (strided layout) at each tile/shifts/warps setting;
  * the two-field z pass with the signed combine (contiguous layout) at each
    setting, fed with the stencil's y-pass output.
Every kernel output is checked bitwise against the stencil. One JSON line per
measurement.

    python scripts/tune_envelope.py [--n 512] [--reps 5]
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def timed(fn, *args, reps: int):
    import jax

    out = jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return out, float(np.median(times))


def _ints(s):
    return [int(v) for v in s.split(",")]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--tiles-y", default="4096,8192,16384")
    ap.add_argument("--tiles-z", default="512,1024,2048")
    ap.add_argument("--shifts", default="2,4")
    ap.add_argument("--warps", default="2,4,8")
    args = ap.parse_args()

    from sdf_tools_tpu import devices

    print("compile cache:", devices.setup_compile_cache())
    import jax
    import jax.numpy as jnp
    from jax import lax

    devices.require_gpu()
    print("device:", json.dumps(devices.device_info()))
    print("card:", devices.card_name_and_power_limit())

    from bench import make_scene
    from sdf_tools_tpu.ops import edt, edt_pallas

    res = 0.05
    mask = jnp.asarray(make_scene(args.n))
    line = jax.jit(lambda m: (edt._line_d2(m, 0), edt._line_d2(~m, 0)))
    (fa, fb), t_line = timed(line, mask, reps=args.reps)

    def line_assoc(m):
        n = m.shape[0]
        iota = lax.broadcasted_iota(jnp.int32, m.shape, 0)
        NEG = jnp.int32(-(1 << 30))

        def one(s):
            last = lax.associative_scan(jnp.maximum, jnp.where(s, iota, NEG), axis=0)
            nxt = -lax.associative_scan(
                jnp.maximum, jnp.where(s, -iota, NEG), axis=0, reverse=True
            )
            d = jnp.minimum(jnp.minimum(iota - last, nxt - iota), 1 << 24)
            return jnp.where(d >= (1 << 24), edt.INF_D2, d * d)

        return one(m), one(~m)

    (la, lb), t_assoc = timed(jax.jit(line_assoc), mask, reps=args.reps)
    stencil = jax.jit(
        lambda m: edt.signed_field_from_masks(m, res, backend="stencil")[0]
    )
    ref, t_stencil = timed(stencil, mask, reps=args.reps)
    sy = jax.jit(
        lambda a, b: (edt.envelope_pass_stencil(a, 1), edt.envelope_pass_stencil(b, 1))
    )
    (ya, yb), t_sy = timed(sy, fa, fb, reps=1)
    print(json.dumps({
        "n": args.n, "line_pass_cummax_s": t_line,
        "line_pass_assoc_s": t_assoc,
        "assoc_equal": bool(jnp.array_equal(la, fa) & jnp.array_equal(lb, fb)),
        "stencil_signed_s": t_stencil, "stencil_y_s": t_sy,
    }), flush=True)

    for tile, shifts, warps in itertools.product(
        _ints(args.tiles_y), _ints(args.shifts), _ints(args.warps)
    ):
        kw = dict(tile=tile, shifts=shifts, num_warps=warps)
        f = jax.jit(lambda a, b, kw=kw: edt_pallas.envelope_dual_pallas(a, b, 1, **kw))
        (oa, ob), t = timed(f, fa, fb, reps=args.reps)
        eq = bool(jnp.array_equal(oa, ya) & jnp.array_equal(ob, yb))
        print(json.dumps({"pass": "y_dual", **kw, "s": t, "bitwise_equal_stencil": eq}), flush=True)

    for tile, shifts, warps in itertools.product(
        _ints(args.tiles_z), _ints(args.shifts), _ints(args.warps)
    ):
        kw = dict(tile=tile, shifts=shifts, num_warps=warps)
        f = jax.jit(
            lambda a, b, kw=kw: edt_pallas.envelope_dual_combine_pallas(a, b, res, **kw)
        )
        out, t = timed(f, ya, yb, reps=args.reps)
        eq = bool(jnp.array_equal(out, ref))
        print(json.dumps({"pass": "z_combine", **kw, "s": t, "bitwise_equal_stencil": eq}), flush=True)


if __name__ == "__main__":
    main()
