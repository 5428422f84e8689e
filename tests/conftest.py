"""Test configuration.

By default the suite runs on the CPU backend with 8 virtual devices (the
sharding tests build meshes over them). Tests that need the card are marked
`gpu` and skip here; run them on a GPU host in ONE process, since a JAX
process reserves most of the card's memory when it first uses it:

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -p no:xdist

With JAX_PLATFORMS naming an accelerator the CPU set-up is left out and the
persistent compile cache is enabled (tlfea.utils.compile_cache).
"""

import os

import pytest

ON_CPU = os.environ.get("JAX_PLATFORMS", "cpu") in ("", "cpu")

if ON_CPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
else:
    from tlfea.utils.compile_cache import enable_compile_cache

    enable_compile_cache()


def pytest_configure(config):
    if not ON_CPU and getattr(config.option, "numprocesses", None):
        raise pytest.UsageError(
            "the accelerator tests run in one process per card: pass -p no:xdist"
        )


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip `gpu`-marked tests unless JAX's default device is a GPU."""
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (JAX_PLATFORMS=cuda, see tests/conftest.py)")
