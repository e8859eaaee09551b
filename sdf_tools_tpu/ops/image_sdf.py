"""2D image SDF: the standalone image->SDF pipeline.

JAX equivalent of the reference's ``image_2d_sdf_node``
(``/root/reference/src/image_2d_sdf_node.cpp``): a binary image produces a
two-channel float field (|d+| distance to filled, |d-| distance to free, in
PIXELS — no resolution scaling, ``:100-117``), the combined signed field,
and a false-color preview (``:228-308``).

The reference node uses an approximate two-pass 8SSEDT; we compute the exact
EDT (the node's own docstring calls 8SSEDT an approximation), so values can
differ from the node by sub-pixel amounts on rare diagonal configurations —
always in our favor (exact Euclidean distances).
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import edt

Array = jax.Array


def image_sdf(image: Array, threshold: float = 0.5) -> Tuple[Array, Array, Array]:
    """image [h, w] (nonzero/>threshold = filled) ->
    (signed [h, w], d_plus [h, w], d_minus [h, w]) in pixel units.

    signed = d_plus - d_minus: positive outside obstacles (distance to
    nearest filled pixel), negative inside (distance to nearest free pixel),
    matching the reference's field combination (image_2d_sdf_node.cpp:100-117)
    but exact.
    """
    img = jnp.asarray(image)
    filled = (img > threshold)[:, :, None]  # [h, w, 1]
    d2f = edt.squared_edt(filled, backend="stencil")
    d2e = edt.squared_edt(~filled, backend="stencil")
    d_plus = edt.d2_to_distance(d2f, 1.0)[:, :, 0]
    d_minus = edt.d2_to_distance(d2e, 1.0)[:, :, 0]
    return d_plus - d_minus, d_plus, d_minus


def false_color_preview(signed: Array) -> np.ndarray:
    """uint8 [h, w, 3] preview: blue outside scaled by distance, red inside,
    white at the zero crossing (image_2d_sdf_node.cpp:228-308 styling)."""
    s = np.asarray(signed)
    finite = np.isfinite(s)
    vmax = max(float(s[finite & (s > 0)].max(initial=1e-6)), 1e-6)
    vmin = min(float(s[finite & (s < 0)].min(initial=-1e-6)), -1e-6)
    out = np.zeros(s.shape + (3,), np.float32)
    pos = s > 0
    neg = s < 0
    out[pos, 2] = 0.2 + 0.8 * (s[pos] / vmax)
    out[neg, 0] = 0.2 + 0.8 * (s[neg] / vmin)
    out[~pos & ~neg] = 1.0
    return (np.clip(out, 0, 1) * 255).astype(np.uint8)
