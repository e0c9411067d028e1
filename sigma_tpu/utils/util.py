"""Small utilities mirroring ``/root/reference/src/util.f90``.

* ``order`` (:18): sorting permutation (insertion sort there; stable argsort
  here).
* ``determinant`` (:49): via LU (LAPACK ``dgetrf`` there; ``lu`` or
  ``slogdet`` on device here).
* ``init_seed`` (:72): RNG seeding (date/time there; explicit or
  entropy-seeded ``jax.random.PRNGKey`` here — explicit by default because
  reproducibility is a feature, not a bug).
"""

from __future__ import annotations

import os
import time

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["order", "determinant", "init_seed", "configure_compile_cache"]


def configure_compile_cache(default_dir: str) -> str:
    """Point JAX's persistent compilation cache at one fixed directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is set here.  Otherwise the cache goes to ``default_dir``, a
    fixed path (part of each entry's key: a path that moves never hits).
    Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", default_dir)
    return default_dir


def order(x) -> np.ndarray:
    """Stable sorting permutation p with x[p] ascending (``order:18``)."""
    return np.argsort(np.asarray(x), kind="stable")


def determinant(A) -> float:
    """Determinant via LU with partial pivoting (``determinant:49``)."""
    A = jnp.asarray(A)
    sign, logabs = jnp.linalg.slogdet(A)
    return float(sign * jnp.exp(logabs))


def init_seed(seed: int | None = None) -> jax.Array:
    """PRNG key; clock-seeded when ``seed`` is None (``init_seed:72``)."""
    if seed is None:
        seed = time.time_ns() % (2**31)
    return jax.random.PRNGKey(int(seed))
