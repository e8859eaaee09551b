#!/usr/bin/env python
"""Flagship differentiable pipeline demo: carve an occupancy grid from depth.

occupancy logits -> sigmoid -> exact EDT (straight-through) -> sphere-traced
depth -> L2 loss -> gradients back to the occupancy. This is the pixel-
gradients-to-occupancy path BASELINE.json's north star names; the sharded
variant of the same pipeline (with gradients to point positions via soft
voxelization) lives in sdf_tools_tpu/parallel/train.py.

Run: JAX_PLATFORMS=cpu python examples/train_points.py
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from sdf_tools_tpu.grid import GridMeta, SdfGrid, make_origin_transform
from sdf_tools_tpu.ops import diff, render

n, res = 24, 0.1
meta = GridMeta.create(make_origin_transform([0.0, 0.0, 0.0]), res, (n, n, n))
center = np.full(3, 0.5 * n * res)

# several viewpoints so the carving is constrained from multiple sides
cams = [
    center - np.array([1.5 * n * res, 0.0, 0.0]),
    center + np.array([1.5 * n * res, 0.0, 0.0]),
    center - np.array([0.0, 1.5 * n * res, 0.0]),
    center + np.array([0.0, 0.3, 1.5 * n * res]),
]
rays = [
    render.camera_rays(
        jnp.asarray(c, jnp.float32), jnp.asarray(center, jnp.float32),
        jnp.asarray([0.0, 0.0, 1.0] if abs(c[2] - center[2]) < 1 else [0.0, 1.0, 0.0]),
        40.0, 20, 20,
    )
    for c in cams
]


# surrogate choice: "ft" (feature-routed, default — cotangents land on the
# actual nearest boundary cells) or "st" (diagonal straight-through)
SURROGATE = _sys.argv[1] if len(_sys.argv) > 1 else "ft"
_sdf_fn = diff.sdf_from_occupancy_ft if SURROGATE == "ft" else diff.sdf_from_occupancy_st


def forward(occ):
    values = _sdf_fn(occ, jnp.float32(res), "stencil")
    sdf = SdfGrid.create(values, meta, oob_value=1e3)
    outs = [render.render_depth(sdf, o, d, t_max=10.0, max_steps=48) for o, d in rays]
    return [jnp.where(r.hit, r.depth, 10.0) for r in outs]


# ground truth: a solid sphere of radius 0.7
ii = np.arange(n)
d2 = ((ii[:, None, None] - (n - 1) / 2) ** 2 + (ii[None, :, None] - (n - 1) / 2) ** 2
      + (ii[None, None, :] - (n - 1) / 2) ** 2)
occ_true = (d2 <= (0.7 / res) ** 2).astype(np.float32)
targets = forward(jnp.asarray(occ_true))

# init: a solid box (wrong shape, right neighborhood)
logits = np.full((n, n, n), -3.0, np.float32)
logits[6:18, 6:18, 6:18] = 3.0
logits = jnp.asarray(logits)


@jax.jit
def step(lg):
    def loss_fn(lg):
        occ = jax.nn.sigmoid(lg)
        preds = forward(occ)
        return sum(jnp.mean((p - t) ** 2) for p, t in zip(preds, targets))

    loss, g = jax.value_and_grad(loss_fn)(lg)
    return lg - 300.0 * g, loss


def iou(lg):
    pred = np.asarray(jax.nn.sigmoid(lg)) > 0.5
    inter = (pred & (occ_true > 0.5)).sum()
    union = (pred | (occ_true > 0.5)).sum()
    return inter / union


print(f"surrogate: {SURROGATE}")
print(f"start: IoU vs target sphere {iou(logits):.3f}")
for it in range(60):
    logits, loss = step(logits)
    if it % 10 == 0:
        print(f"iter {it:3d}: loss {float(loss):.4f}  IoU {iou(logits):.3f}")
print(f"final: loss {float(loss):.4f}  IoU {iou(logits):.3f}")
