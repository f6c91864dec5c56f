"""Test configuration: force the JAX CPU backend with 8 virtual devices so
multi-device sharding tests run anywhere (SURVEY.md §4 strategy).

``jax.config.update`` is used as well as the env vars because jax may
already be imported when this file runs; it works as long as no backend
has initialized.

Markers: ``gpu`` marks a test that needs an NVIDIA GPU; under this file's
CPU backend it skips with its reason (the checks that need the card run in
``python chip_smoke.py``). ``slow`` marks a test that the tier-1 run
(``-m 'not slow'``) leaves out.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
assert len(jax.devices()) == 8, (
    "expected 8 virtual CPU devices; a backend initialized too early: "
    f"{jax.devices()}")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips on the CPU backend")
    config.addinivalue_line(
        "markers", "slow: left out of the tier-1 run (-m 'not slow')")
