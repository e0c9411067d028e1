"""Observability tests: residual histories, slice accessors, profiling."""

import jax.numpy as jnp
import numpy as np

from sigma_tpu import CSRMatrix
from sigma_tpu.solvers import bicgstab_solve, cg_solve
from sigma_tpu.utils.profiling import SolverLog, spmv_throughput


def spd(rng, n):
    d = 2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1) + np.eye(n)
    return d


def test_cg_history(rng):
    n = 60
    dA = spd(rng, n)
    A = CSRMatrix.from_dense(dA)
    b = jnp.asarray(dA @ np.ones(n))
    x, info = cg_solve(A, b, tol=1e-13, history=True)
    h = np.asarray(info.history)
    k = int(info.iterations)
    assert np.isfinite(h[:k]).all() and np.isnan(h[k:]).all()
    # monotone-ish decrease overall: final << initial
    assert h[k - 1] < h[0]
    assert abs(h[k - 1] - float(info.residual_norm)) < 1e-12
    log = SolverLog(info)
    assert log.residuals().size == k
    assert "iterations" in log.report()


def test_cg_no_history_default(rng):
    n = 40
    dA = spd(rng, n)
    A = CSRMatrix.from_dense(dA)
    b = jnp.asarray(dA @ np.ones(n))
    x, info = cg_solve(A, b, tol=1e-13)
    assert info.history is None


def test_bicgstab_history(rng):
    n = 50
    dA = spd(rng, n) + 0.2 * (np.eye(n, k=1) - np.eye(n, k=-1))
    A = CSRMatrix.from_dense(dA)
    b = jnp.asarray(dA @ np.ones(n))
    x, info = bicgstab_solve(A, b, tol=1e-12, history=True)
    h = np.asarray(info.history)
    k = int(info.iterations)
    assert np.isfinite(h[:k]).all()
    assert np.max(np.abs(np.asarray(x) - 1.0)) < 1e-8


def test_row_col_accessors(rng):
    d = np.where(rng.random((12, 9)) < 0.3, rng.standard_normal((12, 9)), 0.0)
    d[4, 7] = 2.5
    A = CSRMatrix.from_dense(d)
    cols, vals = A.get_row(4)
    assert np.allclose(d[4, cols], vals)
    assert (d[4, np.setdiff1d(np.arange(9), cols)] == 0).all()
    rows, vals = A.get_column(7)
    assert np.allclose(d[rows, 7], vals)
    assert A.row_degree(4) == len(cols)


def test_spmv_throughput_positive(rng):
    d = spd(rng, 256)
    A = CSRMatrix.from_dense(d)
    rate = spmv_throughput(A, iters=4)
    assert rate > 0


def test_solver_log_without_history(rng):
    """SolverLog must degrade gracefully when the solve ran with the
    default history=False."""
    n = 30
    dA = spd(rng, n)
    A = CSRMatrix.from_dense(dA)
    x, info = cg_solve(A, jnp.asarray(dA @ np.ones(n)), tol=1e-12)
    log = SolverLog(info)
    assert log.residuals().size == 0
    assert "iterations" in log.report()


def test_checked_solve_flags_nan(rng):
    """checkify float checks surface a NaN produced inside the jitted
    solver loop as a host-side FloatingPointError (SURVEY §5 sanitizer
    analogue)."""
    import jax.numpy as jnp
    import pytest

    from sigma_tpu import CSRMatrix, checked_solve
    from sigma_tpu.solvers import cg_solve

    n = 16
    dense = 2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    A = CSRMatrix.from_dense(dense)
    b = jnp.asarray(rng.standard_normal(n))
    # clean solve passes through
    x, info = checked_solve(cg_solve, A, b, tol=1e-12)
    assert bool(info.converged)
    # poisoned matrix raises
    bad = A.with_data(A.data.at[0].set(jnp.nan))
    with pytest.raises(Exception) as ei:
        checked_solve(cg_solve, bad, b, tol=1e-12, maxiter=4)
    assert "nan" in str(ei.value).lower()


def test_validate_matrix(rng):
    from sigma_tpu import CSRMatrix, validate_matrix

    n = 12
    dense = np.eye(n) * 3.0
    dense[0, 5] = 1.0
    A = CSRMatrix.from_dense(dense)
    validate_matrix(A)  # clean
    import jax.numpy as jnp
    import pytest

    bad = A.with_data(A.data.at[0].set(jnp.inf))
    with pytest.raises(ValueError):
        validate_matrix(bad)


def test_debug_nans_context():
    import jax

    from sigma_tpu import debug_nans

    prev = jax.config.jax_debug_nans
    with debug_nans(True):
        assert jax.config.jax_debug_nans
    assert jax.config.jax_debug_nans == prev
