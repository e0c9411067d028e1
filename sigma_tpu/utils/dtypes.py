"""Dtype policy helpers.

The reference library (SiGMA) is double-precision Fortran throughout.  On the
device the default is float32 (bandwidth-bound SpMV); float64 is available
under ``jax_enable_x64`` (the CPU tests run the reference's 1e-14-tolerance
problems in it).  Everything in sigma_tpu is dtype-generic; these helpers
only pick defaults.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

# Index dtype: int32 everywhere (half the index bytes of int64).
index_dtype = jnp.int32


def default_real_dtype():
    """float64 when x64 is enabled (CPU test runs), else float32."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def as_index_array(x) -> jax.Array:
    return jnp.asarray(x, dtype=index_dtype)


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to a multiple of ``m``."""
    return ((x + m - 1) // m) * m


def np_index(x) -> np.ndarray:
    return np.asarray(x, dtype=np.int32)


def hmatmul(a, b):
    """``a @ b`` at ``Precision.HIGHEST``.  A float32 product at the default
    precision may run in TF32 on the GPU (about three decimal digits), which
    is too coarse for Krylov and eigensolver panel algebra: Gram matrices,
    Gram-Schmidt projections and basis combinations."""
    return jnp.matmul(a, b, precision=lax.Precision.HIGHEST)
