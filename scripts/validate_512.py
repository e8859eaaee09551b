#!/usr/bin/env python
"""512^3 bit-accuracy validation on the GPU: the Pallas kernel route vs the
native C++ exact EDT.

Both d^2 fields must equal the exact EDT everywhere (int32), the two-field
kernel route must equal the per-field route, and the f32 signed field must
be within 2 ulp of the float64 combine. Fails without a GPU.

    python scripts/validate_512.py [n]
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sdf_tools_tpu import devices  # noqa: E402

devices.setup_compile_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bench import make_scene  # noqa: E402
from sdf_tools_tpu import native  # noqa: E402
from sdf_tools_tpu.ops import edt  # noqa: E402

devices.require_gpu()
print("card:", devices.card_name_and_power_limit())
n = int(sys.argv[1]) if len(sys.argv) > 1 else 512
res = 0.05
mask = make_scene(n)
m = jnp.asarray(mask)
backend = edt.resolve_backend("auto")

t0 = time.time()
fa, fb = (np.asarray(a) for a in jax.jit(lambda x: edt.squared_edt_both(x, backend))(m))
print(f"{backend} d2 (both fields, incl. compile): {time.time() - t0:.2f}s")
t0 = time.time()
ref_a, ref_b = native.edt_exact(mask), native.edt_exact(~mask)
print(f"native exact d2: {time.time() - t0:.2f}s")
for name, got, ref in (("filled", fa, ref_a), ("free", fb, ref_b)):
    bad = int((got.astype(np.int64) != np.minimum(ref, int(edt.INF_D2))).sum())
    print(f"d2 {name} mismatches: {bad} / {mask.size}")
    assert bad == 0, f"{name} field is not exact"

single = np.asarray(jax.jit(lambda x: edt.squared_edt(x, backend))(m))
assert np.array_equal(single, fa), "two-field route deviates from the per-field route"

vals = np.asarray(jax.jit(lambda x: edt.signed_field_from_masks(x, res, backend)[0])(m))
f64 = (np.sqrt(ref_a.astype(np.float64)) - np.sqrt(ref_b.astype(np.float64))) * res
ulp = np.abs(vals - f64) / np.spacing(np.abs(f64).astype(np.float32))
print(f"signed combine: max ulp error vs f64 = {ulp.max():.2f}")
assert ulp.max() <= 2.0
print(f"PASS: bit-exact d2 at {n}^3; signed field within 2 ulp of f64")
