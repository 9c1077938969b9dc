"""Test-session environment hooks.

``JASDA_FORCE_HOST_DEVICES=N`` splits the CPU backend into N virtual XLA
devices (``--xla_force_host_platform_device_count``) so the mesh-sharded
auction suite (tests/test_sharded_auction.py) can exercise real multi-device
shard_map dispatches on a plain CPU runner.  The flag must land in XLA_FLAGS
before the FIRST jax import, which is why this lives in conftest.py (pytest
imports it before any test module).  Unset (the default) leaves the device
topology alone — single-device runs skip the multi-device parity tests.

The marker ``card`` tags the tests that need a CUDA card; each checks for
one in a fixture and skips without it (``python -m pytest -m card`` runs
them on a card).
"""
import os

_n = os.environ.get("JASDA_FORCE_HOST_DEVICES")
if _n:
    _flags = os.environ.get("XLA_FLAGS", "")
    if "--xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            f"--xla_force_host_platform_device_count={int(_n)} " + _flags
        ).strip()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")
