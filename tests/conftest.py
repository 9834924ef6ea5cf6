"""tests/ conftest: the tier-1 mesh contract.

The root conftest forces an 8-device virtual CPU platform
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``) for every test run.
Mesh-sharded paths used to guard themselves with ``skipif device_count < 8``,
which meant a broken forcing (an env var override, a jax upgrade changing
flag handling) silently SKIPPED the multi-device byte-identity proofs while
tier-1 still went green. The ``mesh8`` fixture inverts that: mesh tests
REQUIRE the 8 devices and fail loudly when the platform lost them — the
sharded fold, gather lanes and query scans run on every tier-1 pass.
"""

import importlib.util
import os

import jax
import numpy as np
import pytest

# tools/regen_golden_metrics.py puts tests/ AHEAD of the repo root on
# sys.path, so `import conftest` resolves HERE instead of the root conftest
# some test modules pull helpers from — re-export them by loading the root
# module explicitly (under pytest the root conftest wins the name and this
# indirection is never consulted)
_root_path = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "conftest.py")
_spec = importlib.util.spec_from_file_location("_root_conftest", _root_path)
_root_conftest = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_root_conftest)
free_ports = _root_conftest.free_ports


@pytest.fixture
def mesh8():
    """An 8-device 1-D ``data`` mesh over the forced host platform. FAILS
    (never skips) when fewer than 8 devices exist — tier-1 must always
    exercise the mesh paths."""
    devs = jax.devices()
    assert len(devs) >= 8, (
        f"tier-1 requires 8 forced host devices (got {len(devs)}): the root "
        "conftest sets XLA_FLAGS=--xla_force_host_platform_device_count=8 — "
        "check nothing overrode XLA_FLAGS/JAX_PLATFORMS before jax "
        "initialized")
    return jax.sharding.Mesh(np.array(devs[:8]), ("data",))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (and JAX, like every test "
                   "here); skips without one")
