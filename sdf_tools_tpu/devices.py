"""Device plumbing shared by chip_smoke.py, bench.py and the validators:
the persistent compile cache, the GPU requirement and the card's identity.
"""
from __future__ import annotations

import os
import subprocess

import jax

# One fixed cache path inside the checkout (git-ignored): the path is part
# of the cache key, so a moving directory would never hit.
_REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def setup_compile_cache() -> str:
    """Enable JAX's persistent compile cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is (JAX reads it
    itself) and no other cache is set in code; otherwise the cache lives at
    ``<repo>/.jax_cache``.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", _REPO_CACHE)
    return _REPO_CACHE


def require_gpu(devices=None) -> list:
    """The device list, or RuntimeError unless JAX's first device is a GPU."""
    devices = jax.devices() if devices is None else devices
    if not devices or devices[0].platform != "gpu":
        found = devices[0].platform if devices else "none"
        raise RuntimeError(f"no GPU found: JAX's first device is {found!r}")
    return devices


def device_info(devices=None) -> dict:
    """{"platform", "kind", "count"} as JAX reports its devices."""
    devices = jax.devices() if devices is None else devices
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def card_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of each card, one per line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()
