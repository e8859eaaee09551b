"""Trace the 512^3 two-field signed field on the GPU and split its device
time by kernel.

Warms the jitted signed field (the default backend, i.e. the Pallas
kernel on the GPU), traces ``--calls`` calls with jax.profiler, and prints
one JSON line per kernel (name, device ms per call, share of the window)
plus the device busy and idle share of the traced window. The trace is
written under ``--out`` (default chiprun_out/trace_edt).

    python scripts/trace_edt.py [--n 512] [--calls 3] [--backend auto]
"""
from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def device_events(xplane_path: str, device: str = "/device:GPU:0"):
    """(name, start_ns, end_ns) of every kernel event on ``device``."""
    from jax.profiler import ProfileData

    out = []
    for plane in ProfileData.from_file(xplane_path).planes:
        if plane.name != device:
            continue
        for line in plane.lines:
            for e in line.events:
                out.append((e.name, e.start_ns, e.end_ns))
    return out


def busy_ns(events) -> int:
    """Length of the union of the events' intervals."""
    total, cur_s, cur_e = 0, None, None
    for _, s, e in sorted(events, key=lambda t: t[1]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--out", default="chiprun_out/trace_edt")
    args = ap.parse_args()

    from sdf_tools_tpu import devices

    devices.setup_compile_cache()
    import jax
    import jax.numpy as jnp

    devices.require_gpu()
    print("card:", devices.card_name_and_power_limit())
    from bench import make_scene
    from sdf_tools_tpu.ops import edt

    mask = jnp.asarray(make_scene(args.n))
    f = jax.jit(lambda m: edt.signed_field_from_masks(m, 0.05, backend=args.backend))
    jax.block_until_ready(f(mask))
    jax.block_until_ready(f(mask))
    with jax.profiler.trace(args.out):
        for _ in range(args.calls):
            jax.block_until_ready(f(mask))
    path = sorted(glob.glob(os.path.join(args.out, "plugins/profile/*/*.xplane.pb")))[-1]
    events = device_events(path)
    if not events:
        raise RuntimeError(f"no device events in {path}")
    window = max(e for _, _, e in events) - min(s for _, s, _ in events)
    busy = busy_ns(events)
    per = collections.defaultdict(int)
    for name, s, e in events:
        per[name] += e - s
    for name, ns in sorted(per.items(), key=lambda kv: -kv[1])[:20]:
        print(json.dumps({"kernel": name[:120], "ms_per_call": ns / args.calls / 1e6,
                          "share_of_busy": ns / busy}))
    print(json.dumps({"n": args.n, "backend": args.backend, "calls": args.calls,
                      "window_ms": window / 1e6, "busy_ms": busy / 1e6,
                      "idle_share": 1 - busy / window, "trace": path}))


if __name__ == "__main__":
    main()
