"""Test configuration: force an 8-device virtual CPU platform + float64.

The reference test suite asserts 1e-14 tolerances (double precision); we run
tests on CPU with ``jax_enable_x64`` and 8 virtual devices so multi-device
sharding paths are exercised without accelerator hardware (JAX_PLATFORMS,
when set, picks the platform instead).  Tests that need a GPU carry the
``gpu`` marker and take the ``gpu`` fixture, which skips them when JAX
finds none (decided at run time, never at import).
"""

import os

# Must happen before the first jax backend initialization.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# The suite is compile-dominated (hundreds of jitted solver/shard_map
# graphs on tiny operands).  A persistent on-disk compile cache makes
# repeat runs load instead of recompile; entries are keyed by HLO hash,
# so code changes invalidate exactly the affected programs.
from sigma_tpu.utils.util import configure_compile_cache  # noqa: E402

configure_compile_cache(
    os.path.join(os.path.dirname(os.path.dirname(__file__)), ".jax_cache")
)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX finds none."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform {devices[0].platform!r})")
    return devices[0]


def laplacian_2d(nx: int) -> np.ndarray:
    """Dense 5-point Dirichlet Laplacian on an nx*nx grid — the shared test
    operator (single definition; drift between copies produced a real bug
    in an earlier revision of __graft_entry__)."""
    n = nx * nx
    idx = np.arange(n).reshape(nx, nx)
    d = 4 * np.eye(n)
    for ax in range(2):
        s = np.take(idx, np.arange(nx - 1), axis=ax).ravel()
        t = np.take(idx, np.arange(1, nx), axis=ax).ravel()
        d[s, t] = -1
        d[t, s] = -1
    return d
