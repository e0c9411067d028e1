"""Numerical-safety instrumentation: the device-side analogue of the
reference's debug builds.

The reference's only sanitizers are compiler flags (``-fbounds-check``,
``CMakeLists.txt:8-12``) and a valgrind recommendation (``README.md:37``);
its runtime error handling is ``print + exit(1)``.  Under XLA the
equivalent hazards are silent NaN/Inf propagation through fused device
loops, so this module wires jax's machinery into the library surface
(SURVEY §5 "race detection / sanitizers" row):

* :func:`checked` — wrap any jittable function with ``checkify`` float
  checks (NaN/Inf produced anywhere inside, including ``while_loop``
  solver bodies); returns the payload and RAISES ``FloatingPointError``
  host-side with the offending primitive's location.
* :func:`checked_solve` — convenience wrapper for solver entry points.
* :func:`debug_nans` — context manager for ``jax_debug_nans`` (eager
  re-execution of the op that produced the first NaN; heavyweight,
  development-only).
* :func:`validate_matrix` — host-side structural validation of a frozen
  matrix (index bounds, padding invariants) — the bounds checking the
  reference documents as absent (``README.md:74-77``).
"""

from __future__ import annotations

import contextlib

import jax
import numpy as np
from jax.experimental import checkify

__all__ = ["checked", "checked_solve", "debug_nans", "validate_matrix"]


def checked(fn, errors=checkify.float_checks):
    """Wrap ``fn``: run with checkify float checks and raise
    ``FloatingPointError`` (via ``err.throw()``) if any NaN/Inf was
    produced on-device.  The wrapped function is jittable."""
    cfn = checkify.checkify(fn, errors=errors)

    def wrapped(*args, **kwargs):
        err, out = cfn(*args, **kwargs)
        err.throw()
        return out

    return wrapped


def checked_solve(solver_fn, A, b, *args, **kwargs):
    """Run a solve (e.g. ``cg_solve``) under float checks: any NaN/Inf
    generated inside the jitted iteration raises host-side instead of
    silently contaminating the result."""
    return checked(lambda A, b: solver_fn(A, b, *args, **kwargs))(A, b)


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Temporarily toggle ``jax_debug_nans`` (development aid: re-runs the
    producing op eagerly and points at it)."""
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", bool(enable))
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def validate_matrix(A) -> None:
    """Host-side structural validation of a frozen matrix: all stored
    index arrays in range, padded slots value-0, finite values.  Raises
    ``ValueError`` with a specific message on the first violation."""
    n, m = A.shape
    rows, cols, vals = A.entries()
    if rows.size:
        if rows.min() < 0 or rows.max() >= n:
            raise ValueError(
                f"row index out of range [0, {n}): "
                f"[{rows.min()}, {rows.max()}]"
            )
        if cols.min() < 0 or cols.max() >= m:
            raise ValueError(
                f"column index out of range [0, {m}): "
                f"[{cols.min()}, {cols.max()}]"
            )
    data = np.asarray(A.data, dtype=np.float64)
    if not np.all(np.isfinite(data)):
        bad = int(np.count_nonzero(~np.isfinite(data)))
        raise ValueError(f"matrix holds {bad} non-finite value slot(s)")
    # padding invariant: padded slots must carry EXACT zeros — compare
    # the stored-nonzero COUNT against the true-entry nonzero count
    # (review fix: the old abs-sum isclose at rtol=1e-5 let a padded
    # slot hide ~1e-5 x the total magnitude — precisely the corruption
    # this validator exists to catch)
    true_nonzeros = int(np.count_nonzero(np.asarray(vals, np.float64)))
    if int(np.count_nonzero(data)) > true_nonzeros:
        raise ValueError(
            "padded slots carry nonzero values (padding invariant broken)"
        )
