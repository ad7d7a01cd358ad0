"""Test configuration: an 8-device virtual CPU mesh, and the ``gpu``
fixture for card-only tests.

Multi-device sharding logic is validated on virtual CPU devices (run with
``JAX_PLATFORMS=cpu``); XLA_FLAGS is parsed once per process, so it must
be in the environment before the first backend client exists.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided per test, at run
    time — never while modules are collected)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU (run on the card: "
                    "python -m pytest tests -m gpu)")
