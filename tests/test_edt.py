"""EDT correctness: all backends vs brute-force ground truth and the
reference-faithful oracle (see sdf_tools_tpu/oracle/reference_edt.py).

Pinned semantics from /root/reference/test/test_bindings.py and
sdf_generation.hpp: filled cells = -res, free neighbors = +res, etc.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sdf_tools_tpu.ops import edt
from sdf_tools_tpu.oracle import reference_edt as oracle
from sdf_tools_tpu.grid import GridMeta, make_origin_transform

BACKENDS = ["stencil", "brute", "scan"]


def _random_mask(rng, shape, p):
    m = rng.random(shape) < p
    if not m.any():
        m[tuple(0 for _ in shape)] = True
    return m


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize(
    "shape,p",
    [
        ((8, 8, 8), 0.1),
        ((12, 9, 7), 0.05),
        ((16, 16, 1), 0.2),
        ((1, 20, 14), 0.3),
        ((6, 30, 6), 0.5),
        ((5, 5, 5), 0.9),
    ],
)
def test_squared_edt_exact(backend, shape, p):
    rng = np.random.default_rng(hash((shape, int(p * 100))) % (2**31))
    mask = _random_mask(rng, shape, p)
    ours = np.asarray(edt.squared_edt(jnp.asarray(mask), backend=backend))
    truth = oracle.brute_force_d2(shape, mask)
    np.testing.assert_array_equal(ours, truth)


@pytest.mark.parametrize("backend", BACKENDS)
def test_squared_edt_no_seeds(backend):
    mask = np.zeros((4, 5, 6), bool)
    ours = np.asarray(edt.squared_edt(jnp.asarray(mask), backend=backend))
    assert (ours >= int(edt.INF_D2)).all()


@pytest.mark.parametrize("backend", BACKENDS)
def test_squared_edt_all_seeds(backend):
    mask = np.ones((4, 5, 6), bool)
    ours = np.asarray(edt.squared_edt(jnp.asarray(mask), backend=backend))
    assert (ours == 0).all()


def test_reference_oracle_only_overestimates():
    """The reference bucket-queue EDT is not exact; it can only err upward.

    This pins the relationship our bit-accuracy claims rest on: where the
    reference and the exact EDT disagree, the reference's d^2 is larger
    (it is a relaxation that terminates early in rare configurations).
    """
    rng = np.random.default_rng(42)
    total = 0
    mismatched = 0
    for shape in [(8, 8, 8), (10, 10, 4)]:
        for p in [0.05, 0.1, 0.3]:
            mask = _random_mask(rng, shape, p)
            ref = oracle.build_distance_field(shape, mask)
            truth = oracle.brute_force_d2(shape, mask)
            assert (ref >= truth).all()
            mismatched += int((ref != truth).sum())
            total += truth.size
    # deviations must be rare
    assert mismatched <= total * 0.001


@pytest.mark.parametrize("backend", BACKENDS)
def test_signed_field_matches_reference_combine(backend):
    rng = np.random.default_rng(7)
    shape = (10, 12, 6)
    mask = _random_mask(rng, shape, 0.15)
    res = 0.05
    ours, mx, mn = edt.signed_field_from_masks(jnp.asarray(mask), res, backend=backend)
    ours = np.asarray(ours)
    ref, ref_mx, ref_mn = oracle.extract_sdf_reference(mask, res)
    # exact d^2 everywhere the reference is exact; f32 sqrt/multiply match
    exact_d2f = oracle.brute_force_d2(shape, mask)
    exact_d2e = oracle.brute_force_d2(shape, ~mask)
    ref_exact = (
        np.sqrt(exact_d2f.astype(np.float64)) * res
        - np.sqrt(exact_d2e.astype(np.float64)) * res
    ).astype(np.float32)
    np.testing.assert_allclose(ours, ref_exact, rtol=1e-6, atol=1e-7)
    # and the oracle agrees except on its rare overestimates
    agree = np.isclose(ours, ref, rtol=1e-6, atol=1e-7)
    assert agree.mean() > 0.999


def test_test_bindings_semantics():
    """Replicates /root/reference/test/test_bindings.py through the core API."""
    res = 0.05
    # 20 wide (x) by 40 tall (y); obstacle at x=3, y=1 (reference grid indexing)
    mask = np.zeros((20, 40, 1), bool)
    mask[3, 1, 0] = True
    sdf, _, _ = edt.signed_field_from_masks(jnp.asarray(mask), res, backend="stencil")
    sdf = np.asarray(sdf)
    assert np.isclose(sdf[3, 1, 0], -res)
    assert np.isclose(sdf[3, 2, 0], res)
    assert np.isclose(sdf[3, 0, 0], res)
    assert np.isclose(sdf[2, 1, 0], res)
    assert np.isclose(sdf[4, 1, 0], res)
    assert sdf[6, 3, 0] > 3 * res


@pytest.mark.parametrize("backend", ["stencil", "scan"])
def test_virtual_border(backend):
    rng = np.random.default_rng(3)
    shape = (9, 8, 7)
    mask = _random_mask(rng, shape, 0.2)
    res = 0.1
    ours, mx, mn = edt.signed_field_virtual_border(jnp.asarray(mask), res, backend=backend)
    ref, ref_mx, ref_mn = oracle.extract_sdf_virtual_border_reference(mask, res)
    agree = np.isclose(np.asarray(ours), ref, rtol=1e-6, atol=1e-7)
    assert agree.mean() > 0.995  # oracle inexactness can leak into rare cells
    assert np.isclose(mx, ref_mx, rtol=1e-5) or mx <= ref_mx  # ref overestimates
    assert np.isclose(mn, ref_mn, rtol=1e-5) or mn >= ref_mn


def test_virtual_border_flat_axis():
    # 2D grid (z has one cell): border only grows x/y
    mask = np.zeros((6, 6, 1), bool)
    mask[2:4, 2:4, 0] = True
    ours, _, _ = edt.signed_field_virtual_border(jnp.asarray(mask), 1.0)
    ref, _, _ = oracle.extract_sdf_virtual_border_reference(mask, 1.0)
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=1e-6)


def test_extract_entrypoint():
    mask = np.zeros((8, 8, 8), bool)
    mask[3:5, 3:5, 3:5] = True
    meta = GridMeta.create(make_origin_transform([0.0, 0.0, 0.0]), 0.25, (8, 8, 8))
    sdf, (mx, mn) = edt.extract_signed_distance_field(jnp.asarray(mask), meta, oob_value=-10000.0)
    assert sdf.values.shape == (8, 8, 8)
    assert float(mn) <= -0.25 and float(mx) > 0

    sdf_jit = jax.jit(
        lambda m: edt.extract_signed_distance_field(m, meta, oob_value=-10000.0)[0].values
    )(jnp.asarray(mask))
    np.testing.assert_allclose(np.asarray(sdf_jit), np.asarray(sdf.values))


@pytest.mark.parametrize(
    "shape,p",
    [((8, 16, 8), 0.1), ((16, 8, 32), 0.05), ((8, 8, 1), 0.3), ((4, 1, 16), 0.2)],
)
def test_pallas_backend_exact(shape, p):
    """Pallas kernel (interpret mode on CPU) vs brute-force ground truth."""
    rng = np.random.default_rng(hash((shape, int(p * 100))) % (2**31))
    mask = _random_mask(rng, shape, p)
    ours = np.asarray(
        edt.squared_edt(jnp.asarray(mask), backend="pallas", interpret=True)
    )
    truth = oracle.brute_force_d2(shape, mask)
    np.testing.assert_array_equal(ours, truth)


def test_signed_field_lowmem_matches_fused():
    rng = np.random.default_rng(11)
    mask = rng.random((16, 12, 8)) < 0.15
    mask[0, 0, 0] = True
    fused, _, _ = edt.signed_field_from_masks(jnp.asarray(mask), 0.05, backend="stencil")
    lowmem = edt.signed_field_lowmem(jnp.asarray(mask), 0.05, backend="stencil")
    np.testing.assert_allclose(np.asarray(lowmem), np.asarray(fused), rtol=1e-6)


@pytest.mark.parametrize("n_slabs", [2, 4])
def test_signed_field_slabbed_matches_fused(n_slabs):
    rng = np.random.default_rng(12)
    mask = rng.random((16, 12, 8)) < 0.15
    mask[0, 0, 0] = True
    fused, _, _ = edt.signed_field_from_masks(jnp.asarray(mask), 0.05, backend="stencil")
    slabbed = edt.signed_field_slabbed(mask, 0.05, n_slabs=n_slabs, backend="stencil")
    np.testing.assert_allclose(slabbed, np.asarray(fused), rtol=1e-6)


def test_reference_strict_parity_backend():
    """backend='reference' reproduces the reference bucket-queue outputs
    bit-for-bit (including its rare overestimates) via the native lib."""
    from sdf_tools_tpu import native

    if not native.available():
        pytest.skip("native toolchain unavailable")
    rng = np.random.default_rng(31)
    mask = rng.random((24, 20, 16)) < 0.08
    mask[0, 0, 0] = True
    got = np.asarray(edt.squared_edt(jnp.asarray(mask), backend="reference"))
    want = np.minimum(native.edt_reference(mask), int(edt.INF_D2)).astype(np.int32)
    np.testing.assert_array_equal(got, want)
    # only-upward property vs our exact transform
    exact = np.asarray(edt.squared_edt(jnp.asarray(mask), backend="stencil"))
    assert (got >= exact).all()
    # full signed-field path accepts the backend too
    vals, _, _ = edt.signed_field_from_masks(jnp.asarray(mask), 0.1, backend="reference")
    assert np.isfinite(np.asarray(vals)).all()


def test_slabbed_rejects_non_divisible_slab_count():
    mask = np.zeros((10, 8, 8), bool)
    mask[0, 0, 0] = True
    with pytest.raises(ValueError, match="divisible"):
        list(edt.squared_edt_slabbed(mask, n_slabs=3, backend="stencil"))
    with pytest.raises(ValueError, match="divisible"):
        edt.signed_field_slabbed(mask, 0.05, n_slabs=3, backend="stencil")


@pytest.mark.parametrize("shifts", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("tile", [256, 4096])
def test_pallas_tile_and_shifts_exact(tile, shifts):
    """The kernel at other tile sizes and shift counts per quiescence check
    vs brute force, in both layouts (strided and contiguous scanned axis),
    incl. shapes that are not powers of two, lines longer than the tile,
    lines shorter than the shift count, and all-INF lines."""
    from sdf_tools_tpu.ops import edt_pallas

    rng = np.random.default_rng(1000 * shifts + tile)
    for shape in [(8, 32, 128), (4, 24, 300), (3, 40, 128), (8, 5, 128), (8, 16, 1)]:
        f = rng.integers(0, 900, shape).astype(np.int32)
        f[rng.random(shape) < 0.6] = int(edt.INF_D2)
        f[0, 0, :] = int(edt.INF_D2)
        fj = jnp.asarray(f)
        for axis in (0, 1, 2):
            if shape[axis] == 1:
                continue
            truth = np.asarray(edt.envelope_pass_brute(fj, axis))
            got = np.asarray(
                edt_pallas.envelope_pass_pallas(
                    fj, axis, interpret=True, tile=tile, shifts=shifts
                )
            )
            np.testing.assert_array_equal(got, truth)


@pytest.mark.parametrize(
    "shape",
    [(16, 24, 32), (8, 40, 1), (1, 16, 128), (5, 7, 9), (33, 64, 129)],
)
def test_pallas_dual_field_fused(shape):
    """The two-field kernel (both signed-extraction fields in one launch
    per axis) is bit-identical to two separate squared_edt calls, including
    degenerate/odd shapes."""
    from sdf_tools_tpu.ops import edt_pallas

    rng = np.random.default_rng(sum(shape))
    m = rng.random(shape) < 0.12
    if not m.any():
        m.flat[0] = True
    mj = jnp.asarray(m)
    a1 = edt.squared_edt(mj, "stencil")
    b1 = edt.squared_edt(~mj, "stencil")
    fa, fb = edt._line_d2(mj, 0), edt._line_d2(~mj, 0)
    fa, fb = edt_pallas.envelope_dual_pallas(fa, fb, 1, interpret=True)
    fa, fb = edt_pallas.envelope_dual_pallas(fa, fb, 2, interpret=True)
    np.testing.assert_array_equal(np.asarray(fa), np.asarray(a1))
    np.testing.assert_array_equal(np.asarray(fb), np.asarray(b1))
    # the public entry point routes through the same two-field kernel
    a2, b2 = edt.squared_edt_both(mj, "pallas", interpret=True)
    np.testing.assert_array_equal(np.asarray(a2), np.asarray(a1))
    np.testing.assert_array_equal(np.asarray(b2), np.asarray(b1))
    # signed field with the combine as the z-pass epilogue: bitwise
    # identical to d2_to_distance(a) - d2_to_distance(b)
    dist, _, _ = edt.signed_field_from_masks(mj, 0.07, "pallas", interpret=True)
    ref = edt.d2_to_distance(a1, 0.07) - edt.d2_to_distance(b1, 0.07)
    np.testing.assert_array_equal(
        np.asarray(dist).view(np.uint32), np.asarray(ref).view(np.uint32)
    )


def test_resolve_backend_cpu():
    """CPU: "auto" is the stencil; the kernel runs only interpreted."""
    assert jax.default_backend() == "cpu"
    assert edt.resolve_backend("auto") == "stencil"
    assert edt.resolve_backend("auto", interpret=True) == "stencil"
    assert edt.resolve_backend("pallas", interpret=True) == "pallas"
    for exact in ("stencil", "scan", "brute", "reference"):
        assert edt.resolve_backend(exact) == exact
    with pytest.raises(ValueError, match="interpret=True"):
        edt.resolve_backend("pallas")
    with pytest.raises(ValueError, match="interpret=True"):
        edt.squared_edt(jnp.zeros((4, 4, 4), bool), backend="pallas")


def test_resolve_backend_gpu(monkeypatch):
    """GPU: "auto" is the compiled kernel; interpret mode is refused."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert edt.resolve_backend("auto") == "pallas"
    assert edt.resolve_backend("pallas") == "pallas"
    assert edt.resolve_backend("stencil") == "stencil"
    with pytest.raises(ValueError, match="interpret"):
        edt.resolve_backend("pallas", interpret=True)
    with pytest.raises(ValueError, match="interpret"):
        edt.resolve_backend("auto", interpret=True)


@pytest.mark.parametrize("platform", ["rocm", "METAL", "neuron"])
def test_resolve_backend_unknown_platform(monkeypatch, platform):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        edt.resolve_backend("auto")


@pytest.mark.parametrize("backend", ["cht", "no_such_backend"])
def test_removed_or_unknown_envelope_backend_raises(backend):
    with pytest.raises(ValueError, match=backend):
        edt.squared_edt(jnp.zeros((4, 4, 4), bool), backend=backend)


@pytest.mark.parametrize(
    "shape", [(100, 90, 60), (33, 130, 7), (256, 100, 1), (65, 64, 129)]
)
def test_pallas_odd_shapes(shape):
    """Odd and 2D shapes: line lengths that are not powers of two, a tile
    holding many short lines, and lines longer than one tile."""
    from sdf_tools_tpu import native

    if not native.available():
        pytest.skip("needs the native exact oracle (too big for brute force)")
    rng = np.random.default_rng(5)
    mask = _random_mask(rng, shape, 0.1)
    ours = np.asarray(
        edt.squared_edt(jnp.asarray(mask), backend="pallas", interpret=True)
    )
    truth = native.edt_exact(mask)
    np.testing.assert_array_equal(ours.astype(np.int64), truth)
