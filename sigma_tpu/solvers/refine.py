"""Mixed-precision iterative refinement: f64 accuracy at f32 speed.

Low-precision SpMV streams fewer bytes (f32 or bf16 values), yet the
reference's test problems pin 1e-14 tolerances.  Classic iterative
refinement closes the gap:

    repeat:  r = b - A x          (working precision — the matrix dtype)
             solve  A_lo d = r    (low-precision inner Krylov, fast kernels)
             x = x + d

Each outer sweep contracts the error by roughly the inner solve's
relative accuracy (~1e-6 for a well-converged f32 CG), so a handful of
outer iterations reach working-precision residuals while ~all matvecs run
through the low-precision kernels.  The residual computation is the only
working-precision work per sweep — one SpMV and an axpy.

No reference analogue (the reference is all-double); this is the
precision discipline SURVEY §7 names among the hard parts
("bit-tolerance-equal convergence ... dtype discipline"), packaged.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from sigma_tpu.solvers.krylov import SolveInfo, cg_solve

__all__ = ["refined_solve", "refined_solve_fixed"]


@functools.lru_cache(maxsize=None)
def _inner_jit(inner_tol, inner_maxiter, with_M, solver):
    """Module-cached jitted inner solves: a fresh ``jax.jit(lambda ...)``
    per refined_solve call is a fresh trace cache, so every call paid a
    re-trace + compile-cache lookup.  Keyed by the static solver knobs (including the
    solver function itself); the operator and preconditioner stay pytree
    ARGUMENTS."""
    import jax

    if with_M:
        return jax.jit(
            lambda A, r, M: solver(
                A, r, tol=0.0, rtol=inner_tol, maxiter=inner_maxiter, M=M
            )[0]
        )
    return jax.jit(
        lambda A, r: solver(
            A, r, tol=0.0, rtol=inner_tol, maxiter=inner_maxiter
        )[0]
    )


class _DtypePinned:
    """Preconditioner adapter pinning the APPLICATION output dtype: a
    working-precision M inside a low-precision inner solve would
    otherwise promote every downstream Krylov vector (numpy promotion
    rules) and silently run the inner loop at emulated working
    precision."""

    def __init__(self, inner, dtype_name):
        self.inner = inner
        self.dtype_name = dtype_name

    def matvec(self, r):
        return self.inner.matvec(r).astype(jnp.dtype(self.dtype_name))


def _dtype_pinned_flatten(m):
    return (m.inner,), m.dtype_name


def _dtype_pinned_unflatten(aux, children):
    return _DtypePinned(inner=children[0], dtype_name=aux)


import jax as _jax  # noqa: E402  (local alias for the registration)

_jax.tree_util.register_pytree_node(
    _DtypePinned, _dtype_pinned_flatten, _dtype_pinned_unflatten
)


def refined_solve_fixed(
    A,
    b,
    A_lo=None,
    *,
    sweeps: int = 3,
    inner_rtol: float = 1e-3,
    inner_maxiter: int = 200,
    M=None,
    inner_solver=cg_solve,
    inner_dtype=None,
):
    """Fixed-sweep iterative refinement with NO host synchronisation —
    jit the whole thing (``jax.jit(lambda A, A_lo, b: refined_solve_fixed
    (A, b, A_lo=A_lo))``) so all ``sweeps`` outer residuals and inner
    Krylov solves run as one device program.  :func:`refined_solve`'s
    host loop pays a dispatch and a host round trip per step, which is
    the right trade only when the early-exit test saves whole sweeps; at
    a known sweep count this form is the one to use (same lesson as
    block_cg_solve: eager dispatch adds a launch per op).

    The canonical use is a bf16-valued ``A_lo`` (``A.astype(bfloat16)``)
    with f32 ``b``: every inner matvec streams half the HBM bytes
    (~2-3x the SpMV rate) and each outer sweep contracts the error by
    ~max(inner_rtol, bf16 value rounding) — three sweeps reach f32-grade
    residuals.  Returns ``x`` only (jit-friendly); compute the residual
    outside if needed.

    **Routing rule for bf16 (benchmarks/bf16_routing.py)**:

    1. bf16 in PRECONDITIONERS (GMG ``level_dtype``, Chebyshev): the
       iteration count moves +-2 and the outer Krylov's f32 matvec
       keeps the residual f32-grade.  Try that first; it needs no
       refinement ladder at all.
    2. The bf16-OPERATOR ladder (this function with ``A_lo`` bf16)
       reaches f32-grade residuals only when the cast is EXACT
       (``A.astype_exact(bfloat16)`` succeeds — integer/dyadic stencil
       coefficients): 4.9e-7 rel residual at the 10.1M-row Poisson
       north star.  On
       INEXACTLY representable values (random mesh weights, ~4e-3
       rounding) the sweep contraction stalls at a residual FLOOR
       measured ~3-5e-5 at kappa ~ 1e3 regardless of sweeps — use it
       for rtol >= ~1e-4 targets there, never for f32-grade
       (pinned by ``test_bf16_ladder_floor_vs_exact``).

    ``inner_solver`` defaults to CG (SPD A); pass ``bicgstab_solve`` or
    ``gmres_solve`` for nonsymmetric systems — any solver with the
    ``(A, b, *, tol, rtol, maxiter, M) -> (x, info)`` contract works.

    ``inner_dtype`` additionally casts the inner Krylov VECTORS (e.g.
    f64 working precision with an f32 inner — the f64-grade-at-f32-speed
    ladder of :func:`refined_solve`, but as one device program); without
    it the inner vectors follow ``b``'s dtype and only the operator
    values are low-precision.  ``M`` is the INNER preconditioner and is
    dtype-pinned when ``inner_dtype`` is set: its output is cast back
    to the inner dtype, so a working-precision M cannot silently
    promote the whole inner Krylov loop back to (slow, emulated)
    working precision (review fix)."""
    if A_lo is None:
        A_lo = A if inner_dtype is None else A.astype(inner_dtype)
    if M is not None and inner_dtype is not None:
        M = _DtypePinned(inner=M, dtype_name=jnp.dtype(inner_dtype).name)
    x = jnp.zeros_like(b)
    one = jnp.asarray(1.0, b.dtype)
    for _ in range(sweeps):  # static unroll — sweeps is small
        r = b - A.matvec(x)
        rn = jnp.linalg.norm(r)
        scale = jnp.where(rn > 0, rn, one)
        r_lo = r / scale
        if inner_dtype is not None:
            r_lo = r_lo.astype(inner_dtype)
        d, _ = inner_solver(
            A_lo, r_lo, tol=0.0, rtol=inner_rtol,
            maxiter=inner_maxiter, M=M,
        )
        x = x + scale * d.astype(b.dtype)
    return x


def refined_solve(
    A,
    b,
    *,
    tol: float = 1e-12,
    rtol: float = 0.0,
    max_outer: int = 20,
    inner_dtype=jnp.float32,
    inner_solve=None,
    inner_tol: float = 1e-6,
    inner_maxiter: int = 400,
    M_lo=None,
    A_lo=None,
    inner_solver=cg_solve,
):
    """Solve A x = b to working-precision ``tol`` with low-precision inner
    solves.

    ``A`` must provide ``matvec`` in working precision and ``astype`` (any
    SparseMatrix) — or pass a ready low-precision operator/solver pair via
    ``inner_solve(r_lo) -> d_lo``.  The outer loop runs host-side (a few
    iterations; each dispatches jitted device work).

    ``A_lo`` overrides the inner operator independently of the inner
    VECTOR dtype: pass ``A.astype(jnp.bfloat16)`` with the default
    ``inner_dtype=float32`` to stream bf16 matrix values (the dominant
    HBM term, ~2x SpMV) while the Krylov recurrences keep f32 vectors —
    bf16 dot products would stall CG, but a bf16-valued OPERATOR is just
    a ~4e-3 perturbation the outer sweeps contract through.

    ``inner_solver`` defaults to CG (SPD A); pass ``bicgstab_solve`` or
    ``gmres_solve`` for nonsymmetric systems.

    Returns ``(x, SolveInfo)`` where ``info.iterations`` counts OUTER
    refinement sweeps.
    """
    work_dtype = b.dtype
    if inner_solve is None:
        if A_lo is None:
            A_lo = A.astype(inner_dtype)
        # the inner solve is jitted ONCE per (tol, maxiter, M?) via the
        # module cache, with the operator/preconditioner as PYTREE
        # ARGUMENTS: an eager Krylov call pays a dispatch per op outside
        # its while_loop, a per-call jax.jit(lambda) re-traces every
        # call, and closing over large device arrays embeds them in the
        # compiled program
        _inner = _inner_jit(
            inner_tol, inner_maxiter, M_lo is not None, inner_solver
        )
        if M_lo is None:
            inner_solve = lambda r_lo: _inner(A_lo, r_lo)
        else:
            inner_solve = lambda r_lo: _inner(A_lo, r_lo, M_lo)

    x = jnp.zeros_like(b)
    bn = float(jnp.linalg.norm(b))
    tol_eff = max(tol, rtol * bn)
    resn = bn
    k = 0
    for k in range(1, max_outer + 1):
        r = b - A.matvec(x)  # working precision
        resn = float(jnp.linalg.norm(r))
        if not np.isfinite(resn) or resn <= tol_eff:
            break
        # scale the residual to unit norm before the low-precision solve:
        # once outer sweeps contract r below ~1e-12, an UNSCALED f32 inner
        # CG underflows its inner products (rz ~ ||r||^2 ~ 1e-24 -> 0/0 =
        # NaN, observed in eigenpair refinement); unit scaling keeps the
        # inner solve in f32's healthy range at every sweep
        d = inner_solve((r / resn).astype(inner_dtype))
        x = x + resn * d.astype(work_dtype)
    else:
        r = b - A.matvec(x)
        resn = float(jnp.linalg.norm(r))
    return x, SolveInfo(
        jnp.asarray(k, jnp.int32),
        jnp.asarray(resn, work_dtype),
        jnp.asarray(resn <= tol_eff),
    )
