"""Drop-in equivalent of the reference's ``sdf_tools.utils_3d``
(``/root/reference/src/sdf_tools/utils_3d.py``), backed by the JAX engine.

Axis quirk preserved: the input environment is indexed ``env[y, x, z]``
("Yes, it goes y,x,z", utils_3d.py:22) and outputs transpose back the same
way. Also provides a natively-batched, jit-friendly variant
(:func:`compute_sdf_and_gradient_batched`) replacing the reference's
TensorFlow loop wrapper (``utils_3d_tensorflow.py``).
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .grid import GridMeta, SdfGrid, make_origin_transform
from .ops import edt, query


def _meta_from(env_shape, res, origin_point, frame="world"):
    y_shape, x_shape, z_shape = env_shape
    origin = make_origin_transform(
        [origin_point[0], origin_point[1], origin_point[2]]
    )
    return GridMeta.create(origin, res, (x_shape, y_shape, z_shape), frame)


def compute_sdf(env, res, origin_point) -> SdfGrid:
    """env[y, x, z] of 0/1 -> SdfGrid (utils_3d.py:5-36)."""
    env = np.asarray(env)
    meta = _meta_from(env.shape, res, origin_point)
    occ = jnp.asarray(env.transpose(1, 0, 2) == 1)
    sdf, _ = edt.extract_signed_distance_field(occ, meta, oob_value=-10000.0)
    return sdf


def compute_sdf_and_gradient(env, res, origin_point):
    """(sdf[y,x,z] float32, gradient[y,x,z,3] float32) (utils_3d.py:39-97)."""
    sdf = compute_sdf(env, res, origin_point)
    grad = query.full_gradient(sdf, enable_edge_gradients=True)
    np_sdf = np.asarray(sdf.values).transpose(1, 0, 2).astype(np.float32)
    np_grad = np.asarray(grad).transpose(1, 0, 2, 3).astype(np.float32)
    return np_sdf, np_grad


def get_gradient(sdf: SdfGrid, dtype=np.float64):
    """Dense gradient [nx, ny, nz, 3] (utils_3d.py:100-108)."""
    return np.asarray(
        query.full_gradient(sdf, enable_edge_gradients=True), dtype=dtype
    )


def compute_sdf_and_gradient_batched(envs, res, origin_point, backend="auto"):
    """Natively-batched differentiable variant (replaces
    utils_3d_tensorflow.py's per-element Python loop with one vmapped jit).

    envs: [b, y, x, z] of 0/1 -> (sdf [b,y,x,z], gradient [b,y,x,z,3]).
    """
    envs = jnp.asarray(envs)
    meta = _meta_from(envs.shape[1:], res, origin_point)

    @jax.jit
    def one(env):
        occ = jnp.transpose(env, (1, 0, 2)) == 1
        vals, _, _ = edt.signed_field_from_masks(occ, meta.resolution, backend)
        sdf = SdfGrid.create(vals, meta, oob_value=-10000.0)
        grad = query.full_gradient(sdf, enable_edge_gradients=True)
        return (
            jnp.transpose(vals, (1, 0, 2)),
            jnp.transpose(grad, (1, 0, 2, 3)),
        )

    return jax.vmap(one)(envs)
