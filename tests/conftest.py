"""Test configuration.

By default the suite runs on the CPU with 8 virtual devices, which is
where the multi-device sharding tests run.  ``JAX_PLATFORMS`` is set to
``cpu`` only where it is unset, so ``JAX_PLATFORMS=cuda python -m
pytest -m gpu tests/`` runs the tests marked ``gpu`` on a card.  These
env vars must be set before jax imports.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

# Keep the persistent spectra cache out of ~/.cache during tests (its
# own tests point FOLVE_SPECTRA_CACHE at per-test tmp dirs).
import tempfile  # noqa: E402

os.environ.setdefault(
    "FOLVE_SPECTRA_CACHE", tempfile.mkdtemp(prefix="folve_spectra_test_")
)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0xF01BE)


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided here, at run
    time, so every test worker collects the same tests)."""
    import jax

    d = jax.devices()[0]
    if d.platform != "gpu":
        pytest.skip(
            f"needs a GPU (JAX found {d.platform}); run "
            "`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/` on a card"
        )
    return d
