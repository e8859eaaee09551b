"""Card-only tests: the envelope kernel as Triton compiles it for the GPU.

Each test takes the ``gpu`` fixture (tests/conftest.py), which skips it where
JAX has no GPU. ``python chip_smoke.py`` runs them on the card.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sdf_tools_tpu.ops import edt, edt_pallas

pytestmark = pytest.mark.gpu

# odd, degenerate and 2-D shapes, lines longer than one tile, and a volume
# with a seedless line
SHAPES = [(8, 40, 1), (5, 7, 9), (1, 16, 128), (33, 64, 129), (64, 64, 64), (16, 1030, 3)]


@pytest.mark.parametrize("shape", SHAPES)
def test_compiled_signed_field_matches_stencil(gpu, shape):
    rng = np.random.default_rng(sum(shape))
    mask = rng.random(shape) < 0.1
    mask.flat[0] = True
    mask.flat[-1] = False
    m = jnp.asarray(mask)
    got, _, _ = edt.signed_field_from_masks(m, 0.05, backend="pallas")
    want, _, _ = edt.signed_field_from_masks(m, 0.05, backend="stencil")
    np.testing.assert_array_equal(
        np.asarray(got).view(np.uint32), np.asarray(want).view(np.uint32)
    )


@pytest.mark.parametrize("tile,shifts", [(256, 1), (512, 4), (8192, 8), (16384, 2)])
def test_compiled_envelope_matches_brute(gpu, tile, shifts):
    rng = np.random.default_rng(tile + shifts)
    f = rng.integers(0, 900, (6, 96, 160)).astype(np.int32)
    f[rng.random(f.shape) < 0.7] = int(edt.INF_D2)
    fj = jnp.asarray(f)
    for axis in (0, 1, 2):
        got = edt_pallas.envelope_pass_pallas(fj, axis, tile=tile, shifts=shifts)
        np.testing.assert_array_equal(
            np.asarray(got), np.asarray(edt.envelope_pass_brute(fj, axis))
        )


def test_compiled_kernel_inside_shard_map(gpu):
    """The sharded signed field on a one-card mesh runs the compiled kernel
    under shard_map(check_vma=True) and equals the single-device field."""
    from jax.sharding import PartitionSpec as P

    from sdf_tools_tpu.parallel import sharded

    rng = np.random.default_rng(3)
    mask = rng.random((32, 48, 40)) < 0.1
    mesh = sharded.make_mesh({"x": 1}, gpu[:1])
    f = jax.jit(
        jax.shard_map(
            lambda m: sharded.sharded_signed_field(m, 0.1, "x"),
            mesh=mesh, in_specs=P("x"), out_specs=P("x"),
        )
    )
    got = f(jnp.asarray(mask))
    want, _, _ = edt.signed_field_from_masks(jnp.asarray(mask), 0.1)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
