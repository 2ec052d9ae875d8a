"""Test configuration.

Tests run on a virtual 8-device CPU mesh so multi-device sharding paths
are exercised without a GPU, and with x64 enabled so host-side golden
index math stays in float64 (the analogue of the reference disabling numba
JIT under test, /root/reference/tests/conftest.py:1-3 — kernels run in their
debuggable/interpretable form, goldens are defined by float64 semantics).

``JAX_PLATFORMS`` defaults to ``cpu``.  The ``gpu``-marked tests run on a
card with ``JAX_PLATFORMS=cuda``; there x64 stays off, as in production.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_ON_CPU = os.environ["JAX_PLATFORMS"] == "cpu"
if _ON_CPU:
    os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax  # noqa: E402

jax.config.update("jax_num_cpu_devices", 8)
if _ON_CPU:
    jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh_reproject_plan_cache():
    """The device-reproject plan memo is keyed on geometry + env flags;
    tests that monkeypatch tier builders must never see another test's
    cached tier function."""
    yield
    from xcube_resampling_tpu import reproject

    reproject._DEVICE_FN_CACHE.clear()
