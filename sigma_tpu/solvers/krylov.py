"""Functional Krylov solver kernels as jit-compiled ``lax.while_loop``s.

Reference lineage: CG (``/root/reference/src/solver/cg_solvers.f90:116-194``,
unpreconditioned + left-preconditioned), BiCG-stab
(``bicgstab_solvers.f90:121-233`` incl. the NaN-omega breakdown guard
at :163), and GMRES — which the reference does NOT have (named extension).

Device-first shape: the iteration is one ``lax.while_loop`` whose carried state
is a pytree of device arrays; all dot products are ``jnp.vdot`` reductions
(which GSPMD turns into ``psum`` when operands are sharded over a mesh), and
the operator/preconditioner are pytrees closed over by the traced body — so
one compiled program runs the entire solve on-device with zero host round
trips per iteration (the reference pays a dynamic dispatch per matvec).

All kernels take ``A`` and optional ``M`` as LinearOperators (``M`` applies
the *inverse* preconditioner, z = M^{-1} r).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from sigma_tpu.utils.dtypes import hmatmul

__all__ = ["SolveInfo", "cg_solve", "cg_fused_solve", "bicgstab_solve", "minres_solve", "gmres_solve", "cgls_solve", "stationary_solve", "block_cg_solve"]


class SolveInfo(NamedTuple):
    iterations: jax.Array  # int32
    residual_norm: jax.Array
    converged: jax.Array  # bool
    history: Optional[jax.Array] = None  # (maxiter,) per-iteration residual
    # norms when the solve was called with history=True (NaN beyond the
    # final iteration); None otherwise.  The observability surface the
    # reference lacks (SURVEY §5).


def _identity_apply(x):
    return x


def _apply(M):
    return M.matvec if M is not None else _identity_apply


def cg_solve(
    A, b, x0=None, *, tol=1e-15, rtol=0.0, maxiter=None, M=None, history=False,
    flexible=False,
):
    """Preconditioned conjugate gradients (SPD A).

    Mirrors ``cg_solve``/``cg_solve_pc`` (cg_solvers.f90:116-194): left
    preconditioning with z = M^{-1} r, absolute residual-norm stopping rule
    (reference default tol 1e-16), iteration counter in the returned info.
    ``history=True`` additionally records the residual norm after every
    iteration into ``info.history``.

    ``flexible=True`` uses the Polak-Ribiere beta
    ``z_{k+1}^T (r_{k+1} - r_k) / z_k^T r_k`` (flexible CG), REQUIRED when
    M is a *variable* preconditioner — e.g. a truncated inner Krylov solve
    from ``LinearSolver.setup`` — where fixed-M CG breaks down (NaN).
    """
    n = A.shape[0]
    x0 = jnp.zeros_like(b) if x0 is None else x0
    maxiter = 10 * n if maxiter is None else maxiter
    apply_M = _apply(M)
    matvec = A.matvec
    tol_eff = jnp.maximum(jnp.asarray(tol, b.dtype), rtol * jnp.linalg.norm(b))

    r0 = b - matvec(x0)
    z0 = apply_M(r0)
    rho0 = jnp.vdot(r0, z0)
    res0 = jnp.vdot(r0, r0)
    hist0 = (
        jnp.full((int(maxiter),), jnp.nan, dtype=b.dtype) if history else None
    )

    def cond(state):
        _, _, _, _, _, res2, k, _ = state
        return (jnp.sqrt(res2) > tol_eff) & (k < maxiter)

    def body(state):
        x, r, z, p, rho, _, k, hist = state
        q = matvec(p)
        alpha = rho / jnp.vdot(p, q)
        x = x + alpha * p
        r_new = r - alpha * q
        z = apply_M(r_new)
        if flexible:
            # Polak-Ribiere: robust to variable (nonlinear) preconditioners
            rho_new = jnp.vdot(r_new, z)
            beta = jnp.vdot(z, r_new - r) / rho
        else:
            rho_new = jnp.vdot(r_new, z)
            beta = rho_new / rho
        p = z + beta * p
        res2 = jnp.vdot(r_new, r_new)
        if hist is not None:
            hist = hist.at[k].set(jnp.sqrt(res2))
        return (x, r_new, z, p, rho_new, res2, k + 1, hist)

    x, r, _, _, _, res2, k, hist = lax.while_loop(
        cond,
        body,
        (x0, r0, z0, z0, rho0, res0, jnp.asarray(0, jnp.int32), hist0),
    )
    resn = jnp.sqrt(res2)
    return x, SolveInfo(k, resn, resn <= tol_eff, hist)


def cg_fused_solve(
    A, b, x0=None, *, tol=1e-15, rtol=0.0, maxiter=None, M=None, history=False
):
    """Chronopoulos-Gear (single-reduction) preconditioned CG.

    Mathematically the same Krylov iterates as :func:`cg_solve`
    (cg_solvers.f90:116-194) reorganized for memory-bound hardware: the
    search-direction matvec is replaced by the recurrence
    ``s_{k+1} = w_{k+1} + beta s_k`` (with ``w = A z``, exact by
    linearity of A), so one iteration is

        ONE matvec (on z, the freshest vector) -> all dot products
        (gamma = r.z, delta = w.z, ||r||^2) in one reduction point ->
        one elementwise block updating x, r, p, s together

    instead of classic CG's dot -> update -> dot -> update chain.  The
    elementwise block fuses into a single memory pass under XLA
    (~19n words/iteration vs ~21n classic) and halves the number of
    reduction barriers between matvecs.  The alpha recurrence
    ``alpha = gamma / (delta - beta * gamma / alpha_prev)`` is algebraic
    CG (Chronopoulos & Gear 1989, s-step methods literature); in exact
    arithmetic iterates match classic CG, in f32 the residual histories
    track each other to the usual Krylov rounding (pinned by
    tests/test_solvers.py::test_cg_fused_matches_classic).

    Use when the per-iteration wall-clock is HBM/latency bound (large n,
    distributed meshes — fewer psum barriers); classic ``cg_solve``
    remains the default for maximum numerical robustness.
    """
    n = A.shape[0]
    x0 = jnp.zeros_like(b) if x0 is None else x0
    maxiter = 10 * n if maxiter is None else maxiter
    apply_M = _apply(M)
    matvec = A.matvec
    tol_eff = jnp.maximum(jnp.asarray(tol, b.dtype), rtol * jnp.linalg.norm(b))

    r0 = b - matvec(x0)
    z0 = apply_M(r0)
    w0 = matvec(z0)
    gamma0 = jnp.vdot(r0, z0)
    delta0 = jnp.vdot(w0, z0)
    res0 = jnp.vdot(r0, r0)
    # first step is steepest descent: alpha = gamma/delta, beta = 0
    alpha0 = gamma0 / delta0
    hist0 = (
        jnp.full((int(maxiter),), jnp.nan, dtype=b.dtype) if history else None
    )

    def cond(state):
        res2, k = state[8], state[9]
        return (jnp.sqrt(res2) > tol_eff) & (k < maxiter)

    def body(state):
        x, r, z, w, p, s, gamma, alpha, _, k, hist = state
        # fused elementwise block: x, r advance; p, s fold in the fresh
        # z, w (s = A p by linearity — no second matvec)
        x = x + alpha * p
        r = r - alpha * s
        z_new = apply_M(r)
        w_new = matvec(z_new)
        gamma_new = jnp.vdot(r, z_new)
        delta_new = jnp.vdot(w_new, z_new)
        res2 = jnp.vdot(r, r)
        beta = gamma_new / gamma
        alpha_new = gamma_new / (delta_new - beta * gamma_new / alpha)
        p = z_new + beta * p
        s = w_new + beta * s
        if hist is not None:
            hist = hist.at[k].set(jnp.sqrt(res2))
        return (x, r, z_new, w_new, p, s, gamma_new, alpha_new, res2, k + 1, hist)

    state0 = (
        x0, r0, z0, w0, z0, w0, gamma0, alpha0, res0,
        jnp.asarray(0, jnp.int32), hist0,
    )
    out = lax.while_loop(cond, body, state0)
    x, res2, k, hist = out[0], out[8], out[9], out[10]
    resn = jnp.sqrt(res2)
    return x, SolveInfo(k, resn, resn <= tol_eff, hist)


def bicgstab_solve(
    A, b, x0=None, *, tol=1e-12, rtol=0.0, maxiter=None, M=None, history=False
):
    """Preconditioned BiCG-stab for nonsymmetric A.

    Mirrors ``bicgstab_solve``/``_pc`` (bicgstab_solvers.f90:121-233): the
    8-vector working set becomes a while_loop carry; the reference's NaN
    omega guard (:163, t = 0 breakdown) is the ``jnp.where`` on omega.
    """
    n = A.shape[0]
    x0 = jnp.zeros_like(b) if x0 is None else x0
    maxiter = 10 * n if maxiter is None else maxiter
    apply_M = _apply(M)
    matvec = A.matvec
    tol_eff = jnp.maximum(jnp.asarray(tol, b.dtype), rtol * jnp.linalg.norm(b))

    r0 = b - matvec(x0)
    rhat = r0
    one = jnp.asarray(1.0, b.dtype)
    zeros = jnp.zeros_like(b)

    hist0 = (
        jnp.full((int(maxiter),), jnp.nan, dtype=b.dtype) if history else None
    )

    def cond(state):
        _, r, *_ = state
        k = state[7]
        return (jnp.linalg.norm(r) > tol_eff) & (k < maxiter)

    def body(state):
        x, r, p, v, rho, alpha, omega, k, hist = state
        rho_new = jnp.vdot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        phat = apply_M(p)
        v = matvec(phat)
        alpha = rho_new / jnp.vdot(rhat, v)
        s = r - alpha * v
        shat = apply_M(s)
        t = matvec(shat)
        tt = jnp.vdot(t, t)
        omega_raw = jnp.vdot(t, s) / tt
        # breakdown guard (bicgstab_solvers.f90:163): t≈0 → omega NaN → 0
        omega = jnp.where(jnp.isfinite(omega_raw), omega_raw, jnp.zeros_like(omega_raw))
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        if hist is not None:
            hist = hist.at[k].set(jnp.linalg.norm(r))
        return (x, r, p, v, rho_new, alpha, omega, k + 1, hist)

    state0 = (
        x0, r0, zeros, zeros, one, one, one, jnp.asarray(0, jnp.int32), hist0
    )
    out = lax.while_loop(cond, body, state0)
    x, r, k, hist = out[0], out[1], out[7], out[8]
    resn = jnp.linalg.norm(r)
    return x, SolveInfo(k, resn, resn <= tol_eff, hist)


def minres_solve(
    A, b, x0=None, *, tol=1e-12, rtol=0.0, maxiter=None, M=None, history=False
):
    """MINRES for symmetric (possibly INDEFINITE) A, optional SPD M.

    Not present in the reference (its symmetric path is CG-only,
    ``cg_solvers.f90``) — a named extension that closes the
    symmetric-indefinite gap: CG breaks down on indefinite systems
    (saddle-point / Helmholtz-shifted operators) where MINRES still
    minimizes the residual over the same Krylov space.

    Device-first shape, same as :func:`cg_solve`: one ``lax.while_loop``
    over a short-recurrence Lanczos + on-the-fly Givens QR of the
    tridiagonal — three vector FMAs, one matvec, one M-apply per step,
    no growing basis (unlike GMRES), so the carried state is O(n) and
    the whole solve is a single compiled program.  The running residual
    estimate ``phibar`` is exact for the preconditioned residual norm,
    so stopping costs no extra reduction.
    """
    n = A.shape[0]
    x0 = jnp.zeros_like(b) if x0 is None else x0
    maxiter = 10 * n if maxiter is None else maxiter
    apply_M = _apply(M)
    matvec = A.matvec
    tol_eff = jnp.maximum(jnp.asarray(tol, b.dtype), rtol * jnp.linalg.norm(b))
    tiny = jnp.asarray(jnp.finfo(b.dtype).tiny, b.dtype)

    r1 = b - matvec(x0)
    y0 = apply_M(r1)
    beta1 = jnp.sqrt(jnp.abs(jnp.vdot(r1, y0)))
    zero = jnp.zeros((), b.dtype)
    hist0 = (
        jnp.full((int(maxiter),), jnp.nan, dtype=b.dtype) if history else None
    )
    zvec = jnp.zeros_like(b)

    def cond(state):
        phibar, k = state[8], state[12]
        return (phibar > tol_eff) & (k < maxiter)

    def body(state):
        (x, y, r1_, r2, w, w2, oldb, beta, phibar, dbar, epsln, cs_sn, k,
         hist) = state
        cs, sn = cs_sn
        v = y / jnp.where(beta > tiny, beta, 1.0)
        y = matvec(v)
        # k is 0-based; the beta/oldb correction applies from step 2 on
        y = y - jnp.where(k > 0, beta / jnp.where(oldb > tiny, oldb, 1.0),
                          zero) * r1_
        alfa = jnp.vdot(v, y).real
        y = y - (alfa / jnp.where(beta > tiny, beta, 1.0)) * r2
        r1_, r2 = r2, y
        y = apply_M(r2)
        oldb, beta = beta, jnp.sqrt(jnp.abs(jnp.vdot(r2, y)))
        # previous rotations applied to the new tridiagonal column, then
        # the new Givens rotation annihilating beta
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln = sn * beta
        dbar = -cs * beta
        gamma = jnp.maximum(jnp.sqrt(gbar * gbar + beta * beta), tiny)
        cs = gbar / gamma
        sn = beta / gamma
        phi = cs * phibar
        phibar = sn * phibar
        w1, w2 = w2, w
        w = (v - oldeps * w1 - delta * w2) / gamma
        x = x + phi * w
        if hist is not None:
            hist = hist.at[k].set(jnp.abs(phibar))
        return (x, y, r1_, r2, w, w2, oldb, beta, jnp.abs(phibar), dbar,
                epsln, (cs, sn), k + 1, hist)

    state0 = (
        x0, y0, r1, r1, zvec, zvec, zero, beta1, beta1, zero, zero,
        (-jnp.ones((), b.dtype), zero), jnp.asarray(0, jnp.int32), hist0,
    )
    out = lax.while_loop(cond, body, state0)
    x, phibar, k, hist = out[0], out[8], out[12], out[13]
    return x, SolveInfo(k, phibar, phibar <= tol_eff, hist)


def _cgs2_column(V, w, j, m, eps_break):
    """One CGS2 Arnoldi column: project ``w`` against the first ``j+1``
    basis vectors twice (two (m+1, n) matmuls per pass — the
    matmul form with MGS-grade orthogonality), append the
    normalized vector, and return ``(V, h)`` with the Hessenberg column
    ``h`` (breakdown -> zero column).  Shared by GMRES and FGMRES — a
    fix here serves both (review dedup)."""
    valid = jnp.arange(V.shape[0]) <= j
    h1 = jnp.where(valid, hmatmul(V, w), 0.0)
    w = w - hmatmul(V.T, h1)
    h2 = jnp.where(valid, hmatmul(V, w), 0.0)
    w = w - hmatmul(V.T, h2)
    h = h1 + h2
    wn = jnp.linalg.norm(w)
    ok = wn > eps_break * 10
    V = V.at[j + 1].set(jnp.where(ok, w / jnp.where(ok, wn, 1.0), 0.0))
    h = h.at[j + 1].set(jnp.where(ok, wn, 0.0))
    return V, h


def _givens_update(h, R, cs, sn, g, j, m):
    """Apply the j previous Givens rotations to the new Hessenberg
    column, generate the rotation annihilating ``h[j+1]``, and fold it
    into (R, cs, sn, g).  Returns the updated quadruple; ``|g[j+1]|``
    is the running residual estimate."""

    def rot(i, h):
        hi, hi1 = h[i], h[i + 1]
        active = i < j
        c, s_ = cs[i], sn[i]
        h = h.at[i].set(jnp.where(active, c * hi + s_ * hi1, hi))
        return h.at[i + 1].set(jnp.where(active, -s_ * hi + c * hi1, hi1))

    h = lax.fori_loop(0, m, rot, h)
    denom = jnp.sqrt(h[j] ** 2 + h[j + 1] ** 2)
    safe = denom > 0
    c_new = jnp.where(safe, h[j] / jnp.where(safe, denom, 1.0), 1.0)
    s_new = jnp.where(safe, h[j + 1] / jnp.where(safe, denom, 1.0), 0.0)
    cs = cs.at[j].set(c_new)
    sn = sn.at[j].set(s_new)
    gj = g[j]
    g = g.at[j].set(c_new * gj).at[j + 1].set(-s_new * gj)
    R = R.at[:, j].set(h.at[j].set(denom)[: R.shape[0]])
    return R, cs, sn, g


def _solve_hessenberg(R, g, j, m, dtype):
    """Back-substitute on the first ``j`` triangularized columns; unused
    columns padded with a unit diagonal and zero rhs so their y entries
    are exactly 0."""
    used = jnp.arange(m) < j
    Rp = jnp.where(used[None, :] & used[:, None], R, jnp.eye(m, dtype=dtype))
    return jax.scipy.linalg.solve_triangular(
        Rp, jnp.where(used, g[:m], 0.0), lower=False
    )



def gmres_solve(
    A, b, x0=None, *, tol=1e-12, rtol=0.0, restart=32, maxiter=None, M=None
):
    """Restarted GMRES(m) with right preconditioning.

    Not present in the reference (``grep -ri gmres`` finds nothing) — a
    named extension.  Arnoldi uses CGS2 (classical Gram-Schmidt with one
    full reorthogonalization pass): two (m+1, n) matmuls per step instead
    of a sequential MGS sweep — the matmul form with MGS-grade
    orthogonality.  The Hessenberg column is triangularized on the fly by
    Givens rotations, so every Arnoldi step has a running residual-norm
    estimate; the inner loop is a ``while_loop`` that STOPS at convergence
    (no wasted matvecs after the estimate drops below tol), and
    ``info.iterations`` is the true Arnoldi step count — not cycles*m.
    """
    # b (possibly padded/sharded) sizes the Krylov basis: a distributed
    # operator's shape is the UNPADDED n, and a basis sized by it fails
    # on any mesh where n % n_devices != 0 (latent until round 5 — the
    # dryrun's sizes happened to divide evenly)
    n = b.shape[0]
    x0 = jnp.zeros_like(b) if x0 is None else x0
    m = min(restart, n)
    maxiter = 10 * n if maxiter is None else int(maxiter)
    apply_M = _apply(M)
    matvec = A.matvec
    tol_eff = jnp.maximum(jnp.asarray(tol, b.dtype), rtol * jnp.linalg.norm(b))
    eps_break = jnp.asarray(jnp.finfo(b.dtype).eps, b.dtype)

    def cycle(x, k_total):
        r = b - matvec(x)
        beta = jnp.linalg.norm(r)
        V = jnp.zeros((m + 1, n), dtype=b.dtype).at[0].set(
            r / jnp.where(beta > 0, beta, 1.0)
        )
        R = jnp.zeros((m, m), dtype=b.dtype)  # triangularized Hessenberg
        cs = jnp.zeros((m,), dtype=b.dtype)
        sn = jnp.zeros((m,), dtype=b.dtype)
        g = jnp.zeros(m + 1, dtype=b.dtype).at[0].set(beta)

        def icond(st):
            V, R, cs, sn, g, j, est = st
            return (est > tol_eff) & (j < m) & (k_total + j < maxiter)

        def ibody(st):
            V, R, cs, sn, g, j, _ = st
            w = matvec(apply_M(V[j]))
            V, h = _cgs2_column(V, w, j, m, eps_break)
            R, cs, sn, g = _givens_update(h, R, cs, sn, g, j, m)
            return (V, R, cs, sn, g, j + 1, jnp.abs(g[j + 1]))

        V, R, cs, sn, g, j, est = lax.while_loop(
            icond, ibody, (V, R, cs, sn, g, jnp.asarray(0, jnp.int32), beta)
        )
        y = _solve_hessenberg(R, g, j, m, b.dtype)
        x = x + apply_M(hmatmul(V[:m].T, y))
        return x, k_total + j

    def cond(state):
        x, beta, k, prog = state
        return (beta > tol_eff) & (k < maxiter) & prog

    def body(state):
        x, _, k, _ = state
        x, k_new = cycle(x, k)
        beta = jnp.linalg.norm(b - matvec(x))
        return (x, beta, k_new, k_new > k)  # no Arnoldi progress → stop

    beta0 = jnp.linalg.norm(b - matvec(x0))
    x, beta, k, _ = lax.while_loop(
        cond, body, (x0, beta0, jnp.asarray(0, jnp.int32), True)
    )
    return x, SolveInfo(k, beta, beta <= tol_eff)


def fgmres_solve(
    A, b, x0=None, *, tol=1e-12, rtol=0.0, restart=32, maxiter=None, M=None
):
    """Flexible GMRES(m): right preconditioning with a preconditioner
    that may CHANGE between Arnoldi steps — each preconditioned vector
    ``z_j = M(v_j)`` is stored in a second (m, n) basis Z, and the
    update is ``x += Z y`` (Saad '93), so M can be an inner iterative
    solve (e.g. a fixed-iteration GMG-CG cycle via ``attach_solver`` /
    a lambda) instead of a fixed linear operator.  With a fixed linear
    M it reproduces :func:`gmres_solve` up to roundoff (tested).

    ``M`` may be (dispatch in this order):

    - an :class:`~sigma_tpu.operators.linear_operator.OperatorWithSolver`
      (``attach_solver(A_inner, cg(...), preconditioner=...)``) — its
      ``solve`` is the preconditioner application (NOT ``matvec``,
      which would apply the bare inner operator);
    - a plain callable ``z = M(v)``;
    - any LinearOperator (``matvec`` is used — a fixed linear M).

    Inner solves must be jit-compatible with a STATIC iteration count —
    data-dependent inner stopping would change the traced program.
    Pass big inner operators as jit ARGUMENTS, not closures (a closure
    embeds them in the compiled program as constants)::

        step = jax.jit(lambda A_, Ms_, b_: fgmres_solve(
            A_, b_, rtol=1e-8, M=Ms_))
        x, info = step(A, attach_solver(A, cg(rtol=1e-6),
                                        preconditioner=Mg), b)

    This is the missing composition piece for nonsymmetric systems: the
    reference's entire nonsymmetric story is plain BiCG-stab
    (``/root/reference/src/solver/bicgstab_solvers.f90:36``); here the
    library's strongest preconditioners (multigrid V-cycles wrapped in
    inner Krylov smoothing) compose with a nonsymmetric outer method.
    Arnoldi/CGS2/Givens machinery matches :func:`gmres_solve` (matmuls,
    early-exit inner while_loop).
    """
    n = b.shape[0]  # b's (possibly padded/sharded) length sizes the basis
    x0 = jnp.zeros_like(b) if x0 is None else x0
    m = min(restart, n)
    maxiter = 10 * n if maxiter is None else int(maxiter)
    if M is not None and hasattr(M, "solve") and hasattr(M, "solver"):
        # attach_solver facade: the preconditioner application IS the
        # attached solve (matvec would apply the bare inner operator —
        # a silent no-op preconditioner, review regression)
        _M = M

        def apply_M(v):
            out = _M.solve(v)
            return out[0] if isinstance(out, tuple) else out

    elif callable(M) and not hasattr(M, "matvec"):
        apply_M = M
    else:
        apply_M = _apply(M)
    matvec = A.matvec
    tol_eff = jnp.maximum(jnp.asarray(tol, b.dtype), rtol * jnp.linalg.norm(b))
    eps_break = jnp.asarray(jnp.finfo(b.dtype).eps, b.dtype)

    def cycle(x, k_total):
        r = b - matvec(x)
        beta = jnp.linalg.norm(r)
        V = jnp.zeros((m + 1, n), dtype=b.dtype).at[0].set(
            r / jnp.where(beta > 0, beta, 1.0)
        )
        Z = jnp.zeros((m, n), dtype=b.dtype)
        R = jnp.zeros((m, m), dtype=b.dtype)
        cs = jnp.zeros((m,), dtype=b.dtype)
        sn = jnp.zeros((m,), dtype=b.dtype)
        g = jnp.zeros(m + 1, dtype=b.dtype).at[0].set(beta)

        def icond(st):
            V, Z, R, cs, sn, g, j, est = st
            return (est > tol_eff) & (j < m) & (k_total + j < maxiter)

        def ibody(st):
            V, Z, R, cs, sn, g, j, _ = st
            z = apply_M(V[j])
            Z = Z.at[j].set(z)
            w = matvec(z)
            V, h = _cgs2_column(V, w, j, m, eps_break)
            R, cs, sn, g = _givens_update(h, R, cs, sn, g, j, m)
            return (V, Z, R, cs, sn, g, j + 1, jnp.abs(g[j + 1]))

        V, Z, R, cs, sn, g, j, est = lax.while_loop(
            icond, ibody,
            (V, Z, R, cs, sn, g, jnp.asarray(0, jnp.int32), beta),
        )
        y = _solve_hessenberg(R, g, j, m, b.dtype)
        # flexible update: the STORED preconditioned basis, not M(V y)
        x = x + hmatmul(Z.T, y)
        return x, k_total + j

    def cond(state):
        x, beta, k, prog = state
        return (beta > tol_eff) & (k < maxiter) & prog

    def body(state):
        x, _, k, _ = state
        x, k_new = cycle(x, k)
        beta = jnp.linalg.norm(b - matvec(x))
        return (x, beta, k_new, k_new > k)

    beta0 = jnp.linalg.norm(b - matvec(x0))
    x, beta, k, _ = lax.while_loop(
        cond, body, (x0, beta0, jnp.asarray(0, jnp.int32), True)
    )
    return x, SolveInfo(k, beta, beta <= tol_eff)


def cgls_solve(
    A, b, x0=None, *, tol=1e-12, rtol=0.0, maxiter=None, M=None, history=False
):
    """CGLS: conjugate gradients on the normal equations A^T A x = A^T b,
    without ever forming A^T A — the least-squares companion to
    :func:`cg_solve` for RECTANGULAR (or square nonsymmetric full-rank)
    operators, which the reference's solver layer cannot address at all
    (every solver in ``/root/reference/src/solver`` requires a square
    operator; rectangular matrices exist only as data,
    ``graph_interfaces.f90:21`` bipartite graphs).

    Minimizes ``||b - A x||_2``; for consistent underdetermined systems
    with ``x0 = 0`` it converges to the minimum-norm solution.  Each
    iteration is one ``matvec`` + one ``rmatvec`` — on a distributed
    operator those are the forward and reversed halo exchanges, so the
    solver runs unchanged over a device mesh.

    ``M``, if given, applies a symmetric positive preconditioner on the
    column space (z = M s with s = A^T r) — e.g. an (approximate) inverse
    of diag(A^T A).  The stopping rule is on the *normal-equations*
    residual ``||A^T r||`` (the gradient of the LS objective — the only
    residual that vanishes at the LS solution when the system is
    inconsistent); ``info.residual_norm`` reports it, and ``tol_eff =
    max(tol, rtol * ||A^T b||)``.
    """
    maxiter = 10 * A.shape[1] if maxiter is None else maxiter
    apply_M = _apply(M)
    matvec, rmatvec = A.matvec, A.rmatvec

    # domain-shape template from rmatvec(b), NOT jnp.zeros(A.shape[1]):
    # a distributed operator's local domain vector is padded/sharded, and
    # when x0 = 0 XLA CSEs this with s0 below (r0 = b) so it costs nothing
    Atb = rmatvec(b)
    x0 = jnp.zeros_like(Atb) if x0 is None else x0

    r0 = b - matvec(x0)
    s0 = rmatvec(r0)
    z0 = apply_M(s0)
    gamma0 = jnp.vdot(s0, z0)
    tol_eff = jnp.maximum(
        jnp.asarray(tol, b.dtype), rtol * jnp.linalg.norm(Atb)
    )
    hist0 = (
        jnp.full((int(maxiter),), jnp.nan, dtype=b.dtype) if history else None
    )

    def cond(state):
        _, _, _, gamma, snorm, k, _ = state
        return (snorm > tol_eff) & (k < maxiter)

    def body(state):
        x, r, p, gamma, _, k, hist = state
        q = matvec(p)
        alpha = gamma / jnp.vdot(q, q)
        x = x + alpha * p
        r = r - alpha * q
        s = rmatvec(r)
        z = apply_M(s)
        gamma_new = jnp.vdot(s, z)
        beta = gamma_new / gamma
        p = z + beta * p
        snorm = jnp.sqrt(jnp.abs(jnp.vdot(s, s)))
        if hist is not None:
            hist = hist.at[k].set(snorm)
        return (x, r, p, gamma_new, snorm, k + 1, hist)

    snorm0 = jnp.sqrt(jnp.abs(jnp.vdot(s0, s0)))
    x, r, _, _, snorm, k, hist = lax.while_loop(
        cond,
        body,
        (x0, r0, z0, gamma0, snorm0, jnp.asarray(0, jnp.int32), hist0),
    )
    return x, SolveInfo(k, snorm, snorm <= tol_eff, hist)


def stationary_solve(A, b, M, x0=None, *, steps: int):
    """Fixed-count stationary (Richardson) iteration x += M^{-1}(b - A x) —
    how the reference tests exercise Jacobi / IC(0) as standalone solvers
    (solver_test_jacobi.f90: 10n steps)."""
    n = A.shape[0]
    x0 = jnp.zeros_like(b) if x0 is None else x0
    apply_M = _apply(M)

    def body(_, x):
        return x + apply_M(b - A.matvec(x))

    x = lax.fori_loop(0, steps, body, x0)
    r = b - A.matvec(x)
    resn = jnp.linalg.norm(r)
    # a fixed-step stationary iteration has no tolerance: "converged" here
    # only certifies the result is finite (no breakdown)
    return x, SolveInfo(jnp.asarray(steps, jnp.int32), resn, jnp.isfinite(resn))


def block_cg_solve(
    A, B, X0=None, *, tol=1e-12, rtol=0.0, maxiter=None, M=None,
    panels="cols",
):
    """Block (multi-RHS) conjugate gradients: solve A X = B for an (n, s)
    block of right-hand sides simultaneously.

    No reference analogue — the reference names multi-vector operations as
    a missing critical optimization (README.md:83).  Every iteration does
    ONE SpMM (``A.matmat``) instead of s SpMVs, sharing the matrix traffic
    across all right-hand sides (the whole point of the multi-vector
    layout), plus small (s, s) Gram solves.

    ``panels`` selects the resident panel layout for the loop:

    - ``"cols"`` (default): column-major (n, s) blocks.
    - ``"interleaved"``: panels interleaved into (s*ceil(n/128), 128)
      (:func:`sigma_tpu.matrix.panels.interleave_panels`), applied via
      ``A.matmat_interleaved``.  The Gram / panel-combination algebra
      runs directly on the layout, so the (n, s) transposes are paid once
      at entry/exit, not per iteration.

    Uses the **breakdown-free** block recurrences (BFBCG, Ji & Li style):
    the direction block P is kept column-orthonormal (Cholesky-QR — two
    GEMMs + an (s, s) factorization, distribution-friendly), so the
    per-step Gram matrix W = P^T A P inherits A's conditioning instead of
    degenerating as RHS columns converge — the plain recurrence diverges
    in f32, this one does not.  SPD A and M assumed; stops on the
    Frobenius norm of the block residual.  The panel products run at
    ``Precision.HIGHEST`` (see :func:`sigma_tpu.utils.dtypes.hmatmul`).

    **Wrap the call in ``jax.jit`` for production** (A and B are pytree
    arguments; tol/maxiter close over): the pre/post-loop panel ops
    otherwise dispatch eagerly, one launch each.
    """
    n, s = B.shape
    X0 = jnp.zeros_like(B) if X0 is None else X0
    maxiter = 10 * n if maxiter is None else maxiter
    hi = lax.Precision.HIGHEST

    if panels == "interleaved":
        from sigma_tpu.matrix.panels import (
            deinterleave_panels,
            interleave_panels,
        )

        Sy = -(-n // 128)
        to_layout = lambda Z: interleave_panels(Z.T, n)
        from_layout = lambda Zp: deinterleave_panels(Zp, s, n).T
        matmat = A.matmat_interleaved
        if M is None:
            apply_M = lambda R: R
        elif hasattr(M, "matmat_interleaved"):
            apply_M = M.matmat_interleaved
        else:
            apply_M = lambda R: to_layout(M.matmat(from_layout(R)))

        def gram(Xp, Yp):
            return jnp.einsum(
                "ral,rbl->ab", Xp.reshape(Sy, s, 128),
                Yp.reshape(Sy, s, 128), precision=hi,
            )

        def comb(Xp, C):
            return jnp.einsum(
                "ral,ab->rbl", Xp.reshape(Sy, s, 128), C.astype(Xp.dtype),
                precision=hi,
            ).reshape(Sy * s, 128)

        def scale_cols(Xp, w):
            return (Xp.reshape(Sy, s, 128) * w[None, :, None]).reshape(
                Sy * s, 128
            )

        def colnorms(Xp):
            X3 = Xp.reshape(Sy, s, 128)
            return jnp.sqrt(jnp.sum(X3 * X3, axis=(0, 2)))

    elif panels == "cols":
        to_layout = from_layout = lambda Z: Z
        matmat = A.matmat
        apply_M = (lambda R: M.matmat(R)) if M is not None else (lambda R: R)
        gram = lambda Xp, Yp: hmatmul(Xp.T, Yp)
        comb = lambda Xp, C: hmatmul(Xp, C.astype(Xp.dtype))
        scale_cols = lambda Xp, w: Xp * w[None, :]
        colnorms = lambda Xp: jnp.sqrt(jnp.sum(Xp * Xp, axis=0))
    else:
        raise ValueError(f"panels must be cols|interleaved: {panels!r}")

    tol_eff = jnp.maximum(
        jnp.asarray(tol, B.dtype), rtol * jnp.linalg.norm(B)
    )
    eps = jnp.asarray(jnp.finfo(B.dtype).eps, B.dtype)
    tiny = jnp.asarray(jnp.finfo(B.dtype).tiny, B.dtype)

    shift = jnp.sqrt(eps)  # shifted CholQR ridge (bounds column amplification to eps^-1/4)
    eye = jnp.eye(s, dtype=B.dtype)

    def _orth(P):
        # column-normalized shifted Cholesky-QR: P <- P L^{-T} — two GEMMs
        # + an (s, s) factorization, distribution-friendly (no tall-skinny
        # Householder).  Columns are unit-normalized FIRST: without this a
        # scale-disparate panel has its small columns crushed below the
        # ridge and comes out rank-deficient (f32 divergence).
        cn = colnorms(P)
        P = scale_cols(P, 1.0 / jnp.where(cn > tiny, cn, 1.0))
        G = gram(P, P)
        L = jnp.linalg.cholesky(G + shift * eye)
        # P @ L^{-T} via the explicit (s, s) triangular inverse: one tiny
        # host-free inversion + a panel combination in EITHER layout (a
        # tall triangular solve would force the column-major form)
        Linv = jax.scipy.linalg.solve_triangular(L, eye, lower=True)
        return comb(P, Linv.T)

    def _solve_w(W, C):
        scale = jnp.max(jnp.abs(jnp.diagonal(W))) + tiny
        return jnp.linalg.solve(W + (eps * scale) * eye, C)

    Bp = to_layout(B)
    X0p = to_layout(X0)
    R0 = Bp - matmat(X0p)
    P0 = _orth(apply_M(R0))

    res0 = jnp.linalg.norm(R0)
    big = jnp.asarray(1e4, B.dtype)

    def cond(state):
        X, R, P, k, Xb, rb = state
        resn = jnp.linalg.norm(R)
        # stop on convergence, breakdown (non-finite), or runaway
        # divergence past any hope of recovery (precision floor reached;
        # the best iterate is returned below) — the block-form analogue of
        # the reference's NaN-omega breakdown handling
        # (bicgstab_solvers.f90:163)
        alive = jnp.isfinite(resn) & (resn < big * (rb + tol_eff))
        return alive & (resn > tol_eff) & (k < maxiter)

    def body(state):
        X, R, P, k, Xb, rb = state
        Q = matmat(P)
        W = gram(P, Q)
        alpha = _solve_w(W, gram(P, R))
        X = X + comb(P, alpha)
        R = R - comb(Q, alpha)
        resn = jnp.linalg.norm(R)
        better = jnp.isfinite(resn) & (resn < rb)
        Xb = jnp.where(better, X, Xb)
        rb = jnp.where(better, resn, rb)
        Z = apply_M(R)
        beta = _solve_w(W, gram(Q, Z))
        P = _orth(Z - comb(P, beta))
        return (X, R, P, k + 1, Xb, rb)

    X, R, _, k, Xb, rb = lax.while_loop(
        cond, body, (X0p, R0, P0, jnp.asarray(0, jnp.int32), X0p, res0)
    )
    # return the best iterate (== the final one in ordinary runs)
    resn = jnp.linalg.norm(R)
    final_better = jnp.isfinite(resn) & (resn <= rb)
    X = jnp.where(final_better, X, Xb)
    resn = jnp.where(final_better, resn, rb)
    return from_layout(X), SolveInfo(k, resn, resn <= tol_eff)
