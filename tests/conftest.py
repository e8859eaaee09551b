import os

import pytest

# Tests run on a virtual 8-device CPU mesh so sharding paths are exercised
# without a GPU. chip_smoke.py runs the card-only tests (marker ``gpu``) in
# its own process on the GPU and sets SDFT_TEST_PLATFORM=gpu for that.
if os.environ.get("SDFT_TEST_PLATFORM") != "gpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

    import jax  # noqa: E402

    # jax may already be imported (and its config read) before this file
    # loads; backends initialize lazily, so updating the config still works
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)


@pytest.fixture
def gpu():
    """The GPU device list; skips the test where JAX has no GPU."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip("needs a GPU (run by chip_smoke.py on the card)")
    return devices
