"""Lanczos eigensolvers.

Reference: ``/root/reference/src/eigensolver.f90`` — ``lanczos:27`` (n-step
Lanczos, random unit start vector, **full re-orthogonalization** against all
previous vectors at :74-76), ``generalized_lanczos:95`` (A x = lam B x;
every step applies ``B%solve`` at :140, so B must carry an attached solver),
``eigensolve:160`` / ``generalized_eigensolve:189`` (tridiagonal eigenproblem
via LAPACK ``dstev`` :174,202, then Ritz vectors V*Q with sign normalization
:178-180).

Data-parallel redesign
----------------------
The iteration is a ``lax.fori_loop`` over a static step count with a dense
``(n, k+1)`` basis carried in the loop state; full re-orthogonalization is a
*matmul* ``w -= V (V^T w)`` (two passes — "twice is enough") rather than a
scalar loop over previous vectors, run at ``Precision.HIGHEST`` (a TF32
projection loses orthogonality).
Unfilled basis columns are zero, so the projector automatically restricts to
the filled prefix — no dynamic slicing.  The small (k x k) tridiagonal
eigenproblem runs as a dense ``jnp.linalg.eigh`` (the ``dstev`` analogue).
The whole pipeline (including the nested CG solve inside generalized
Lanczos) is one jit-compilable program.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from sigma_tpu.operators.linear_operator import LinearOperator
from sigma_tpu.utils.dtypes import default_real_dtype, hmatmul

__all__ = [
    "LanczosResult",
    "lanczos",
    "generalized_lanczos",
    "eigensolve",
    "generalized_eigensolve",
]

_BREAKDOWN = 1e-300  # guard against division by ~0 at invariant subspaces


class LanczosResult(NamedTuple):
    """Tridiagonal coefficients + orthonormal basis.

    ``alpha`` (k,): diagonal of T; ``beta`` (k,): off-diagonals, where
    ``beta[j]`` couples columns j and j+1 and ``beta[k-1]`` is the norm of
    the final residual; ``V`` (n, k): the Lanczos basis; ``v_next`` (n,):
    the (k+1)-th vector completing the three-term recurrence
    ``A V = V T + beta[k-1] v_next e_k^T``.
    """

    alpha: jax.Array
    beta: jax.Array
    V: jax.Array
    v_next: jax.Array

    def tridiagonal(self) -> jax.Array:
        """Materialize T as a dense (k, k) symmetric tridiagonal."""
        k = self.alpha.shape[0]
        T = jnp.diag(self.alpha)
        if k > 1:
            T = T + jnp.diag(self.beta[: k - 1], 1) + jnp.diag(self.beta[: k - 1], -1)
        return T


def _start_vector(n, v0, key, dtype):
    if v0 is not None:
        return jnp.asarray(v0, dtype=dtype)
    if key is None:
        key = jax.random.PRNGKey(0)
    return jax.random.normal(key, (n,), dtype=dtype)


def _safe_normalize(w, norm):
    return jnp.where(norm > _BREAKDOWN, 1.0 / norm, 0.0) * w


@partial(jax.jit, static_argnames=("k", "reorth_passes"))
def _lanczos_loop(matvec_operand, k, v_start, reorth_passes):
    A = matvec_operand
    n = v_start.shape[0]
    dtype = v_start.dtype
    v0 = v_start / jnp.linalg.norm(v_start)
    restart_key = jax.random.PRNGKey(17)

    Vb = jnp.zeros((n, k + 1), dtype=dtype).at[:, 0].set(v0)
    alpha = jnp.zeros((k,), dtype=dtype)
    beta = jnp.zeros((k,), dtype=dtype)

    def body(j, carry):
        Vb, alpha, beta = carry
        v = Vb[:, j]
        w = A.matvec(v)
        a = jnp.vdot(v, w)
        w = w - a * v
        # full re-orthogonalization as matmuls (eigensolver.f90:74-76);
        # zero columns of Vb act as a no-op in the projector
        for _ in range(reorth_passes):
            w = w - hmatmul(Vb, hmatmul(Vb.T, w))
        b = jnp.linalg.norm(w)
        # breakdown threshold scaled by the RUNNING recurrence magnitude
        # |a| + beta_prev, NOT max(|a|, 1): an O(1) floor mistakes every
        # step of a small-scaled operator (e.g. an h^3-scaled FEM mass
        # pencil in f32, where a ~ 1e-4 < eps*n) for a breakdown and
        # silently replaces the whole basis with random restarts
        beta_prev = jnp.where(j > 0, beta[jnp.maximum(j - 1, 0)], 0.0)
        tol_b = (
            jnp.asarray(jnp.finfo(dtype).eps, dtype)
            * (jnp.abs(a) + beta_prev)
            * n
        )

        # breakdown (invariant subspace found): beta stays ~0 but the
        # basis RESTARTS with a fresh orthogonalized random direction
        # instead of zero-filling — zero columns would surface as
        # spurious eigenvalue-0 Ritz pairs sorted to the front.  The
        # fresh vector lives inside lax.cond: building it
        # unconditionally doubled the dominant reorthogonalization
        # work of every NORMAL step (review fix)
        def _restart(_):
            fresh = jax.random.normal(
                jax.random.fold_in(restart_key, j), (n,), dtype
            )
            for _ in range(reorth_passes):
                fresh = fresh - hmatmul(Vb, hmatmul(Vb.T, fresh))
            return fresh / jnp.maximum(
                jnp.linalg.norm(fresh), _BREAKDOWN
            )

        v_next = lax.cond(
            b > tol_b, lambda _: _safe_normalize(w, b), _restart, None
        )
        b_eff = jnp.where(b > tol_b, b, jnp.zeros_like(b))
        Vb = Vb.at[:, j + 1].set(v_next)
        return Vb, alpha.at[j].set(a), beta.at[j].set(b_eff)

    Vb, alpha, beta = lax.fori_loop(0, k, body, (Vb, alpha, beta))
    return LanczosResult(alpha=alpha, beta=beta, V=Vb[:, :k], v_next=Vb[:, k])


def lanczos(
    A: LinearOperator,
    k: Optional[int] = None,
    v0=None,
    *,
    key=None,
    reorth_passes: int = 2,
) -> LanczosResult:
    """k-step symmetric Lanczos process on operator A (``lanczos:27``).

    Defaults to k = n (the reference always runs the full process).
    """
    n = A.shape[0]
    if A.shape[0] != A.shape[1]:
        raise ValueError(f"lanczos needs a square operator, got {A.shape}")
    if k is None:
        k = n
    if not 1 <= k <= n:
        raise ValueError(f"k={k} out of range [1, {n}]")
    dtype = getattr(A, "dtype", None) or default_real_dtype()
    v_start = _start_vector(n, v0, key, dtype)
    return _lanczos_loop(A, int(k), v_start, int(reorth_passes))


@partial(jax.jit, static_argnames=("k", "reorth_passes"))
def _generalized_lanczos_loop(A, B, k, v_start, reorth_passes):
    n = v_start.shape[0]
    dtype = v_start.dtype

    def b_norm_sq(w, Bw):
        return jnp.vdot(w, Bw)

    Bv0 = B.matvec(v_start)
    nrm = jnp.sqrt(b_norm_sq(v_start, Bv0))
    v0 = _safe_normalize(v_start, nrm)

    Vb = jnp.zeros((n, k + 1), dtype=dtype).at[:, 0].set(v0)
    alpha = jnp.zeros((k,), dtype=dtype)
    beta = jnp.zeros((k,), dtype=dtype)

    restart_key = jax.random.PRNGKey(23)

    def body(j, carry):
        Vb, alpha, beta = carry
        v = Vb[:, j]
        u = A.matvec(v)
        a = jnp.vdot(u, v)  # <B^-1 A v, v>_B = v^T A v
        w = B.solve(u)  # the per-step B%solve (eigensolver.f90:140)
        w = w - a * v
        # full B-re-orthogonalization: w -= V (V^T B w)
        for _ in range(reorth_passes):
            w = w - hmatmul(Vb, hmatmul(Vb.T, B.matvec(w)))
        Bw = B.matvec(w)
        b = jnp.sqrt(jnp.maximum(b_norm_sq(w, Bw), 0.0))
        # scale-free breakdown threshold (see the standard loop): the
        # pencil's recurrence runs at |a| ~ 1/mu, which for an h^3-scaled
        # mass matrix is FAR below 1 — an O(1) floor zeroed every beta in
        # f32 and returned trace-average garbage Ritz values
        beta_prev = jnp.where(j > 0, beta[jnp.maximum(j - 1, 0)], 0.0)
        tol_b = (
            jnp.asarray(jnp.finfo(dtype).eps, dtype)
            * (jnp.abs(a) + beta_prev)
            * n
        )

        # breakdown restart inside lax.cond: the fresh direction costs
        # reorth_passes + 2 extra B applications, paid only on actual
        # breakdown now (review fix — see the standard loop)
        def _restart(_):
            fresh = jax.random.normal(
                jax.random.fold_in(restart_key, j), (n,), dtype
            )
            for _ in range(reorth_passes):
                fresh = fresh - hmatmul(Vb, hmatmul(Vb.T, B.matvec(fresh)))
            fb = jnp.sqrt(
                jnp.maximum(b_norm_sq(fresh, B.matvec(fresh)), 0.0)
            )
            return _safe_normalize(fresh, fb)

        Vb = Vb.at[:, j + 1].set(
            lax.cond(
                b > tol_b, lambda _: _safe_normalize(w, b), _restart, None
            )
        )
        b_eff = jnp.where(b > tol_b, b, jnp.zeros_like(b))
        return Vb, alpha.at[j].set(a), beta.at[j].set(b_eff)

    Vb, alpha, beta = lax.fori_loop(0, k, body, (Vb, alpha, beta))
    return LanczosResult(alpha=alpha, beta=beta, V=Vb[:, :k], v_next=Vb[:, k])


def generalized_lanczos(
    A: LinearOperator,
    B: LinearOperator,
    k: Optional[int] = None,
    v0=None,
    *,
    key=None,
    reorth_passes: int = 2,
) -> LanczosResult:
    """k-step Lanczos for the pencil A x = lam B x (``generalized_lanczos:95``).

    Every step applies ``B.solve`` (``eigensolver.f90:140``) — attach a
    solver with ``sigma_tpu.attach_solver(B, cg(...))`` to control it; a
    bare operator falls back to the default CG facade.  The basis is
    B-orthonormal: ``V^T B V = I``; the recurrence is
    ``B^{-1} A V = V T + beta[k-1] v_next e_k^T``.
    """
    n = A.shape[0]
    if A.shape != B.shape or A.shape[0] != A.shape[1]:
        raise ValueError(f"pencil shape mismatch A={A.shape}, B={B.shape}")
    if k is None:
        k = n
    if not 1 <= k <= n:
        raise ValueError(f"k={k} out of range [1, {n}]")
    dtype = getattr(A, "dtype", None) or default_real_dtype()
    v_start = _start_vector(n, v0, key, dtype)
    return _generalized_lanczos_loop(A, B, int(k), v_start, int(reorth_passes))


def _ritz(result: LanczosResult):
    """Tridiagonal eigendecomposition + Ritz vectors with sign normalization
    (``eigensolve:160``: dstev -> V*Q, sign fix at :178-180)."""
    T = result.tridiagonal()
    lam, Q = jnp.linalg.eigh(T)  # dstev analogue; k x k dense, host-scale
    V = hmatmul(result.V, Q)
    # sign normalization: largest-|.| component of each Ritz vector positive
    idx = jnp.argmax(jnp.abs(V), axis=0)
    signs = jnp.sign(V[idx, jnp.arange(V.shape[1])])
    signs = jnp.where(signs == 0, 1.0, signs)
    return lam, V * signs


def eigensolve(
    A: LinearOperator, k: Optional[int] = None, v0=None, *, key=None
):
    """Eigenvalues + Ritz vectors of symmetric A via Lanczos
    (``eigensolve:160``).  Returns (lam ascending, V columns)."""
    return _ritz(lanczos(A, k, v0, key=key))


def generalized_eigensolve(
    A: LinearOperator, B: LinearOperator, k: Optional[int] = None, v0=None, *, key=None
):
    """Generalized eigenvalues of A x = lam B x (``generalized_eigensolve:189``).
    Ritz vectors are B-orthonormal."""
    return _ritz(generalized_lanczos(A, B, k, v0, key=key))
