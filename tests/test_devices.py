"""Device plumbing: compile-cache rule, the GPU requirement of the chip
scripts, and the envelope kernel wrapper's tiling choices."""
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from sdf_tools_tpu import devices
from sdf_tools_tpu.ops import edt_pallas

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_uses_env_dir(monkeypatch, restore_cache_dir, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert devices.setup_compile_cache() == str(tmp_path)
    # the env var is left to JAX itself: nothing is set in code
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_defaults_to_repo_dir(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = devices.setup_compile_cache()
    assert got == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
    # fixed path: a second call names the same directory
    assert devices.setup_compile_cache() == got


def test_require_gpu_refuses_cpu_devices():
    with pytest.raises(RuntimeError, match="no GPU"):
        devices.require_gpu(jax.devices())
    with pytest.raises(RuntimeError, match="no GPU"):
        devices.require_gpu([])


def test_device_info_reports_jax_view():
    info = devices.device_info(jax.devices())
    assert info == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                    "count": len(jax.devices())}


def test_chip_smoke_device_phase_refuses_cpu():
    sys.path.insert(0, REPO)
    import chip_smoke

    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.phase_device()


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable] + args, cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_chip_scripts_exit_nonzero_without_gpu(script):
    r = _run([script], REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], str(tmp_path))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.parametrize(
    "shape,axis,want",
    [
        # last axis: contiguous layout, [lines, n] tiles
        ((512, 512, 512), 2, dict(B=1, R=1, C=512, pdim=1, grid=(262144,))),
        ((8, 16, 100), 2, dict(B=1, R=4, C=128, pdim=1, grid=(32,))),
        # trailing size-1 dims also give the contiguous layout
        ((8, 40, 1), 1, dict(B=1, R=8, C=64, pdim=1, grid=(1,))),
        # strided layout: [n, B-chunk] tiles, the chunk capped by B
        ((512, 512, 512), 1, dict(B=512, R=512, C=16, pdim=0, grid=(512 * 32,))),
        ((5, 7, 9), 1, dict(B=9, R=8, C=16, pdim=0, grid=(5,))),
        ((4, 1030, 3), 1, dict(B=3, R=2048, C=4, pdim=0, grid=(4,))),
        ((6, 96, 160), 0, dict(B=96 * 160, R=8, C=1024, pdim=0, grid=(15,))),
    ],
)
def test_envelope_tiling(shape, axis, want):
    n, B, R, C, pdim, n_lines, grid = edt_pallas._geometry(shape, axis, None)
    assert n == shape[axis] and n_lines == int(np.prod(shape)) // n
    assert dict(B=B, R=R, C=C, pdim=pdim, grid=grid) == want
    # every line fits its tile whole, and tiles are powers of two
    assert (R if pdim == 0 else C) >= n
    assert R & (R - 1) == 0 and C & (C - 1) == 0


@pytest.mark.parametrize("tile", [0, 3, 1000])
def test_envelope_tile_must_be_power_of_two(tile):
    with pytest.raises(ValueError, match="power of two"):
        edt_pallas._geometry((4, 8, 16), 2, tile)
