"""Test harness: JAX on a virtual 8-device CPU mesh by default.

Multi-device sharding (tests/test_parallel.py) needs several devices, so
unless JAX_PLATFORMS names another platform the tests pin the CPU backend
with 8 virtual devices — before any backend is initialized. Tests marked
`gpu` need an NVIDIA GPU and skip elsewhere; on a machine with a card they
run with

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu

Both device requirements (`gpu`, `needs_devices(n)`) are decided in the
autouse fixture below, never at import or collection time, so every
pytest-xdist worker collects the same tests.
"""

import os

import pytest

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")


def pytest_collection_modifyitems(config, items):
    # `slow` tests (multi-process pods, interpret-mode dense-capacity
    # kernel sweeps, multi-Mbp tiling) run on HG_TEST_SLOW=1 or via an
    # explicit -m expression; the default lane skips them so
    # `pytest tests/ -q` stays a short iteration loop
    run_slow = (
        os.environ.get("HG_TEST_SLOW") == "1"
        or bool(config.getoption("-m"))
    )
    if run_slow:
        return
    for item in items:
        if item.get_closest_marker("slow"):
            item.add_marker(pytest.mark.skip(
                reason="slow lane: set HG_TEST_SLOW=1 or pass -m slow"
            ))


@pytest.fixture(autouse=True)
def _device_requirements(request):
    import jax

    if (request.node.get_closest_marker("gpu")
            and jax.default_backend() != "gpu"):
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda "
                    "python -m pytest tests/ -m gpu")
    m = request.node.get_closest_marker("needs_devices")
    if m and jax.device_count() < m.args[0]:
        pytest.skip(
            f"needs {m.args[0]} devices, backend has {jax.device_count()}"
        )
