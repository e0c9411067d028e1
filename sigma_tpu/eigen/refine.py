"""Mixed-precision eigenpair refinement: inverse iteration through the
f64-residual / f32-Krylov pipeline, then an exact Rayleigh-Ritz.

Why it exists (the 10.1M-row Dirichlet Laplacian): f32 LOBPCG stagnates with
vector-limited eigenvalue errors of 1-2% for eigenvalues near
``eps * ||A||`` — and its own f32 Ritz printout UNDERSTATES that error
(rounding happened to land toward the exact values), which only a
working-precision Rayleigh quotient exposes.  One refined
inverse-iteration step per vector — ``y = A^{-1} x`` amplifies mode q
by ``1/lambda_q``, suppressing the stagnation's high-mode contamination
by ``~lambda_min/lambda_q`` — followed by a working-precision
Rayleigh-Ritz on the block, recovered six digits (3e-5 relative vs the
analytic spectrum) in one step, with all Krylov work on the f32 kernels
(:func:`sigma_tpu.solvers.refine.refined_solve`).

The reference's eigensolver is all-f64 LAPACK at toy sizes
(``eigensolver.f90``); this is the mixed-precision discipline that reaches
reference-grade eigenvalues at scales it never touched.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from sigma_tpu.utils.dtypes import hmatmul

__all__ = ["refine_eigenpairs", "RefinedEigenpairs"]


# module-level jits: per-call ``jax.jit(lambda ...)`` objects are fresh
# trace caches, so a second refine_eigenpairs call would re-trace and
# re-look-up every compiled program (the refined_solve lesson,
# solvers/refine.py::_inner_jit)
_rq_jit = jax.jit(
    lambda A_, V_: jnp.sum(V_ * A_.matmat(V_), axis=0)
    / jnp.sum(V_ * V_, axis=0)
)
_gram_jit = jax.jit(
    lambda A_, V_: (hmatmul(V_.T, V_), hmatmul(V_.T, A_.matmat(V_)))
)


@functools.lru_cache(maxsize=None)
def _fixed_col_jit(sweeps, inner_tol, inner_maxiter, inner_dtype):
    """One jitted inverse-iteration column solve per static-knob tuple:
    the whole refinement ladder (working-precision residual sweeps +
    low-precision inner CG) as one device program, normalized output.
    ``inner_dtype`` arrives as a dtype NAME (hashable cache key)."""
    from sigma_tpu.solvers.refine import refined_solve_fixed

    inner_dtype = jnp.dtype(inner_dtype)

    def col(A_, Al_, b_, M_):
        y = refined_solve_fixed(
            A_, b_, A_lo=Al_, sweeps=sweeps, inner_rtol=inner_tol,
            inner_maxiter=inner_maxiter, M=M_, inner_dtype=inner_dtype,
        )
        return y / jnp.linalg.norm(y)

    return jax.jit(col)


class RefinedEigenpairs(NamedTuple):
    eigenvalues: np.ndarray  # (m,) ascending, working precision
    eigenvectors: jax.Array  # (n, m) working precision, B-orthonormal
    rayleigh_before: np.ndarray  # working-precision RQ of the INPUT block


def refine_eigenpairs(
    A,
    V,
    *,
    M_lo=None,
    inner_solve=None,
    steps: int = 1,
    rtol: float = 1e-12,
    max_outer: int = 8,
    inner_tol: float = 1e-6,
    inner_maxiter: int = 300,
    A_lo=None,
    inner_dtype=jnp.float32,
    use_fixed: bool = True,
) -> RefinedEigenpairs:
    """Refine approximate eigenvectors ``V`` (n, m) of SPD ``A`` toward
    the LOWEST eigenpairs.

    ``A`` is the working-precision operator (e.g. f64); each of the
    ``steps`` sweeps applies one inverse-iteration step per column via
    the mixed-precision refinement ladder (low-precision inner Krylov,
    optionally preconditioned by ``M_lo``; or a custom
    ``inner_solve(r_lo) -> d_lo``), then a working-precision
    Rayleigh-Ritz on the refined block separates the low cluster.

    By default (``use_fixed=True``, no custom ``inner_solve``) each
    column's ENTIRE inverse-iteration solve runs as one jitted device
    program (:func:`sigma_tpu.solvers.refine.refined_solve_fixed`,
    ``max_outer`` fixed sweeps) — the host-loop form pays a dispatch and
    a host round trip per outer step per column.  Pass
    ``use_fixed=False`` for the early-exit host loop, or ``A_lo`` to
    reuse an existing low-precision operator instead of casting ``A``.

    Returns working-precision eigenvalues (ascending), the Ritz vectors,
    and the Rayleigh quotients of the INPUT block — the honest accuracy
    of what was passed in (an f32 eigensolver's own Ritz values can
    understate their error)."""
    from sigma_tpu.solvers.refine import refined_solve, refined_solve_fixed

    V = jnp.asarray(V, dtype=getattr(A, "dtype", jnp.float64))
    n, m = V.shape

    solve_fx = None
    if inner_solve is None and use_fixed:
        if A_lo is None:
            A_lo = A.astype(inner_dtype)
        # each sweep contracts the residual by ~inner_tol, so the sweep
        # count follows from the tolerance ratio (+1 margin), capped at
        # the host loop's max_outer
        if rtol <= 0.0:
            # rtol=0 is the solver layer's "absolute tol only" sentinel:
            # run the full sweep budget (log(0) would overflow below)
            sweeps = max_outer
        else:
            sweeps = min(
                max_outer,
                int(np.ceil(np.log(rtol) / np.log(min(inner_tol, 0.5)))) + 1,
            )
        # one cached trace serves all columns, steps, AND calls; the
        # operator, low operator, and preconditioner are pytree ARGUMENTS
        solve_fx = _fixed_col_jit(sweeps, inner_tol, inner_maxiter,
                                  jnp.dtype(inner_dtype).name)

    # working-precision RQ of the input block (diagnostic).  JITTED: an
    # eager f64 matmat at north-star scale dispatches each diagonal's
    # ops separately with 300 MB intermediates; jitted it is one fused
    # program
    rq_before = np.sort(np.asarray(_rq_jit(A, V)))

    for step in range(max(steps, 1)):
        cols = []
        for j in range(m):
            if solve_fx is not None:
                cols.append(solve_fx(A, A_lo, V[:, j], M_lo))
                continue
            y, _ = refined_solve(
                A,
                V[:, j],
                tol=0.0,
                rtol=rtol,
                M_lo=M_lo,
                A_lo=A_lo,
                inner_dtype=inner_dtype,
                inner_solve=inner_solve,
                max_outer=max_outer,
                inner_tol=inner_tol,
                inner_maxiter=inner_maxiter,
            )
            cols.append(y / jnp.linalg.norm(y))
        V = jnp.stack(cols, axis=1)
        if steps > 1:
            # re-orthogonalize between sweeps: per-column inverse
            # iteration collapses the block toward the lowest mode,
            # and a singular V^T V breaks the final generalized
            # Rayleigh-Ritz (review regression)
            V, _ = jnp.linalg.qr(V)

    # working-precision Rayleigh-Ritz on the refined block (same jit
    # reasoning as the RQ above; only the m x m Gram matrices come home)
    import scipy.linalg as sla

    Gd, Hd = _gram_jit(A, V)
    G = np.asarray(Gd)
    H = np.asarray(Hd)
    H = 0.5 * (H + H.T)
    w, Q = sla.eigh(H, G)
    order = np.argsort(w)
    w = w[order]
    Vr = hmatmul(V, jnp.asarray(Q[:, order], V.dtype))
    Vr = Vr / jnp.linalg.norm(Vr, axis=0, keepdims=True)
    return RefinedEigenpairs(
        eigenvalues=w, eigenvectors=Vr, rayleigh_before=rq_before
    )
