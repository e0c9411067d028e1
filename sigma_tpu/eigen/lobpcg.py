"""LOBPCG: locally-optimal block preconditioned conjugate gradient
eigensolver.

No reference analogue (the reference has only Lanczos) — included because
it is the *multi-vector* eigensolver: every iteration is one SpMM over the
whole (n, m) block plus small dense Rayleigh-Ritz algebra, and
it accepts any preconditioner from the solver layer (AMG, Chebyshev,
ILDU...), tying the framework's pieces together.  Finds the lowest m
eigenpairs of symmetric A (or the pencil via preconditioning).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from sigma_tpu.operators.linear_operator import LinearOperator
from sigma_tpu.utils.dtypes import hmatmul

__all__ = ["lobpcg", "LOBPCGResult"]


class LOBPCGResult(NamedTuple):
    eigenvalues: jax.Array  # (m,) ascending
    eigenvectors: jax.Array  # (n, m)
    iterations: jax.Array
    residual_norms: jax.Array  # (m,) — of the RETURNED eigenvectors
    converged: jax.Array  # bool: max residual <= tol at exit


def _orthonormalize(S):
    """QR-based orthonormalization with a tiny-column guard."""
    Q, R = jnp.linalg.qr(S)
    # flip signs for determinism; degenerate columns stay (harmless in RR)
    signs = jnp.sign(jnp.diagonal(R))
    signs = jnp.where(signs == 0, 1.0, signs)
    return Q * signs[None, :]


@partial(jax.jit, static_argnames=("m", "maxiter"))
def _lobpcg_loop(A, M, X0, m, maxiter, tol):
    n = X0.shape[0]

    def rayleigh_ritz(S):
        AS = A.matmat(S)
        G = hmatmul(S.T, AS)
        lam, C = jnp.linalg.eigh((G + G.T) / 2)
        return lam[:m], hmatmul(S, C[:, :m]), hmatmul(AS, C[:, :m])

    X = _orthonormalize(X0)
    lam, X, AX = rayleigh_ritz(X)
    P = jnp.zeros_like(X)

    def body(state):
        X, AX, lam, P, k, _ = state
        R = AX - X * lam[None, :]
        resn = jnp.linalg.norm(R, axis=0)
        W = M.matmat(R) if M is not None else R  # blockwise pc apply
        # subspace: current block, preconditioned residuals, prior direction
        S = _orthonormalize(jnp.concatenate([X, W, P], axis=1))
        lam_new, X_new, AX_new = rayleigh_ritz(S)
        P = X_new - hmatmul(X, hmatmul(X.T, X_new))
        return X_new, AX_new, lam_new, P, k + 1, resn

    def cond(state):
        _, _, _, _, k, resn = state
        return (jnp.max(resn) > tol) & (k < maxiter)

    R0 = AX - X * lam[None, :]
    state = (X, AX, lam, P, jnp.asarray(0, jnp.int32),
             jnp.linalg.norm(R0, axis=0))
    X, AX, lam, P, k, _ = lax.while_loop(cond, body, state)
    # residuals of the returned iterate (the loop-carried value is one
    # iteration stale: body pairs the new X with the incoming residual)
    resn = jnp.linalg.norm(AX - X * lam[None, :], axis=0)
    return lam, X, k, resn


def lobpcg(
    A: LinearOperator,
    X0=None,
    m: int = 4,
    *,
    M: Optional[LinearOperator] = None,
    tol: float = 1e-6,
    maxiter: int = 200,
    key=None,
) -> LOBPCGResult:
    """Lowest-m eigenpairs of symmetric A; ``M`` is an (approximate)
    inverse preconditioner applied blockwise to the residuals.

    ROUTING: in f32 at north-star scale LOBPCG stalls near 1e-2
    residuals even GMG-preconditioned —
    for accurate extreme eigenpairs of huge SPD operators use
    :func:`sigma_tpu.eigen.shift_invert_lanczos` (host-f64 recurrence
    + f32 ladder solves: 1e-12 residuals at 1M rows) or
    :func:`sigma_tpu.eigen.refine_eigenpairs` on this function's
    output when the spectrum is isolated.  LOBPCG stays the right tool
    for moderate-accuracy blocks and as the matmat-throughput
    eigensolver (its block matvecs ride the SpMM kernels).

    Check ``result.converged``: without soft locking, the basic iteration
    stagnates near residual ~1e-8 in float64 (converged columns make the
    [X, W, P] trial basis numerically rank-deficient), so tolerances much
    below ~1e-7 typically exhaust ``maxiter`` instead of converging."""
    n = A.shape[0]
    if X0 is None:
        if key is None:
            key = jax.random.PRNGKey(0)
        X0 = jax.random.normal(key, (n, m), dtype=getattr(A, "dtype", jnp.float64))
    else:
        X0 = jnp.asarray(X0)
        m = X0.shape[1]
    if 3 * m >= n:
        raise ValueError(f"block size {m} too large for n={n} (need 3m < n)")
    lam, X, k, resn = _lobpcg_loop(A, M, X0, int(m), int(maxiter), tol)
    return LOBPCGResult(
        eigenvalues=lam,
        eigenvectors=X,
        iterations=k,
        residual_norms=resn,
        converged=jnp.max(resn) <= tol,
    )
