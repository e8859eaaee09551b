#!/usr/bin/env python
"""Quantify the reference bucket-queue EDT's deviation from the exact EDT.

The reference's 26-neighbor brushfire (sdf_generation.hpp:95-207) is a pure
relaxation that can only err UPWARD (docs/NOTES.md §2). This measures the
rate and magnitude at the BASELINE scene scales (VERDICT round-1 item 6);
results go to docs/RESULTS.md.

Runs entirely on the host (native C++ lib).
"""
import sys
import time

import numpy as np

sys.path.insert(0, "/root/repo")
import bench
from sdf_tools_tpu import native

assert native.available(), "native lib required"

print("| n | field | deviating cells | rate | max d2 err | max |d| err (cells) |")
print("|---|---|---|---|---|---|")
for n in (64, 256, 512):
    mask = bench.make_scene(n)
    for field, m in (("filled", mask), ("free", ~mask)):
        t0 = time.time()
        ref = native.edt_reference(m)
        t1 = time.time()
        exact = native.edt_exact(m)
        t2 = time.time()
        finite = exact < np.int64(1) << 40
        dev = (ref != exact) & finite
        cnt = int(dev.sum())
        if cnt:
            d2err = (ref[dev] - exact[dev]).astype(np.int64)
            assert (d2err > 0).all(), "reference must only overestimate"
            derr = np.sqrt(ref[dev].astype(np.float64)) - np.sqrt(
                exact[dev].astype(np.float64)
            )
            mx, dmx = int(d2err.max()), float(derr.max())
        else:
            mx, dmx = 0, 0.0
        print(
            f"| {n}^3 | {field} | {cnt} | {cnt / dev.size:.2e} | {mx} | {dmx:.4f} |"
            f"  <!-- ref {t1-t0:.1f}s exact {t2-t1:.1f}s -->"
        )
