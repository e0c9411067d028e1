"""Incomplete LDU(0) / IC(0) factorization + level-scheduled triangular solves.

Reference: ``/root/reference/src/solver/ldu_solvers.f90`` — zero-fill ILDU
with unit-triangular L, U stored as *strict* CSR (holds L−I and U−I,
:287-289), diagonal D; ``ldu_solve:160`` = forward sweep → D^{-1} → backward
sweep; fill level > 0 aborts there (:414-417) but is implemented here as
level-of-fill ILU(k); reduces to incomplete Cholesky for
SPD A.  For SPD problems this solver *is* the reference's "incomplete
Cholesky" (test/solver_test_incomplete_cholesky.f90).

The reference's triangular sweeps are strictly sequential
(``lower_triangular_solve:208``, ``upper_triangular_solve:243`` — the main
parallelization obstacle named in SURVEY §3.3).  The data-parallel redesign is
**level scheduling**: rows are grouped into dependency levels of the
triangular DAG (for a multicolor-ordered matrix, levels = colors — the
reference's own intended remedy, ``permutations.f90:6-8``); each level is one
batched gather·multiply·scatter over static padded arrays, and the whole
solve is a ``lax.fori_loop`` over levels living inside the jitted Krylov
iteration.

Factorization (numeric ILU(0) on the static pattern, mirroring
``sparse_static_pattern_ldu_factorization:275``) runs on host at setup time.

ROUTING: the level-scheduled apply steps through every dependency level
(hundreds at 1M rows of 3-D Poisson), each a latency-bound gather/scatter
step, so ILDU(0) wins the iteration count but can lose the wall clock to
Chebyshev and structured GMG (benchmarks/ildu3d.py measures it).  At scale
prefer
:func:`sigma_tpu.solvers.chebyshev` or
:func:`sigma_tpu.solvers.structured_pair_amg`; this module is the right
tool on CPU, at small n, and as the shard-local factorization inside
:func:`sigma_tpu.parallel.distributed_block_ildu` (where per-block level
counts stay small).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sigma_tpu.operators.linear_operator import LinearOperator
from sigma_tpu.solvers.base import LinearSolver
from sigma_tpu.solvers.krylov import SolveInfo
from sigma_tpu.utils.dtypes import index_dtype

__all__ = [
    "ildu0_factorize",
    "iluk_factorize",
    "TriangularLevels",
    "ILDUPreconditioner",
    "LDUSolver",
    "ldu",
    "incomplete_cholesky",
]


def _csr_arrays(A) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(indptr, indices, data) numpy CSR of any SparseMatrix (shared
    implementation: graph.host_csr)."""
    from sigma_tpu.graph.graph import host_csr

    rows, cols, vals = A.entries()
    indptr, indices, data = host_csr(rows, cols, A.shape[0], vals)
    return indptr, indices, np.asarray(data, dtype=np.float64)


def _ilu0_numpy(indptr, indices, data, n):
    """numpy fallback for the native ILU(0) kernel: classic SPARSKIT ikj
    with a position-marker work array; the inner update over row k's upper
    entries is vectorized.  Returns (lu, diag)."""
    lu = data.copy()
    diag = np.zeros(n, dtype=np.float64)
    ipos = np.full(n, -1, dtype=np.int64)  # column -> position in current row
    diag_pos = np.full(n, -1, dtype=np.int64)

    for i in range(n):
        s, e = indptr[i], indptr[i + 1]
        cols_i = indices[s:e]
        ipos[cols_i] = np.arange(s, e)
        for p in range(s, e):
            k = indices[p]
            if k >= i:
                break
            # l_ik = a_ik / u_kk
            lik = lu[p] / diag[k]
            lu[p] = lik
            # a_ij -= l_ik * u_kj for j > k in row k's pattern ∩ row i's pattern
            ks, ke = diag_pos[k] + 1, indptr[k + 1]
            js = indices[ks:ke]
            pos = ipos[js]
            valid = pos >= 0
            if valid.any():
                lu[pos[valid]] -= lik * lu[ks:ke][valid]
        dp = np.searchsorted(cols_i, i) + s
        if dp >= e or indices[dp] != i or lu[dp] == 0.0:
            raise ZeroDivisionError(
                f"zero or missing pivot at row {i} in ILDU(0) factorization"
            )
        diag_pos[i] = dp
        diag[i] = lu[dp]
        ipos[cols_i] = -1
    return lu, diag


def ildu0_factorize(A):
    """Zero-fill LDU factorization A ≈ L·D·U (L, U unit triangular).

    Returns (L_csr, d, U_csr) with L/U = (indptr, indices, data) holding the
    *strict* parts only (the reference's L−I / U−I storage).  The numeric
    sweep runs in the compiled host core (``sigma_host.cpp::ilu0_factorize``
    — the all-compiled setup of ``ldu_solvers.f90:275-417``) with a numpy
    fallback.
    """
    from sigma_tpu import native

    n = A.shape[0]
    if A.shape[0] != A.shape[1]:
        raise ValueError("ILDU requires a square matrix")
    indptr, indices, data = _csr_arrays(A)
    res = native.ilu0_factorize(indptr, indices, data)
    if res is not None:
        lu, diag = res
    else:
        lu, diag = _ilu0_numpy(indptr, indices, data, n)

    return _split_ldu(indptr, indices, lu, diag, n)


def _iluk_symbolic_numpy(indptr, indices, n, k):
    """numpy/python fallback of the C++ level-of-fill symbolic pass (same
    recurrence: lev(fill l via j) = lev(i,j) + lev(j,l) + 1, keep <= k).
    Per-row dict merge — fine at test sizes; the compiled core carries
    production sizes."""
    import heapq

    INF = 1 << 60
    urows = []  # per row: sorted [(col, lev)] of the strict upper factor
    fptr = np.zeros(n + 1, dtype=np.int64)
    fcols = []
    for i in range(n):
        lev = {int(c): 0 for c in indices[indptr[i] : indptr[i + 1]]}
        # ascending traversal over kept columns j < i, with insertions
        heap = [c for c in lev if c < i]
        heapq.heapify(heap)
        seen = set(heap)
        while heap:
            j = heapq.heappop(heap)
            levij = lev[j]
            if levij > k:
                continue
            for l, lvl_jl in urows[j]:
                nl = levij + lvl_jl + 1
                cur = lev.get(l, INF)
                if nl < cur:
                    lev[l] = nl
                    if nl <= k and l < i and l not in seen:
                        heapq.heappush(heap, l)
                        seen.add(l)
        kept = sorted(c for c, v in lev.items() if v <= k)
        fcols.extend(kept)
        fptr[i + 1] = len(fcols)
        urows.append([(c, lev[c]) for c in kept if c > i])
    return fptr, np.asarray(fcols, dtype=np.int64)


def iluk_factorize(A, k: int):
    """Level-of-fill ILU(k) factorization A ≈ L·D·U.

    The symbolic pattern expansion (Saad §10.3.3) runs in the compiled host
    core (``sigma_host.cpp::iluk_symbolic``); the numeric phase is the
    existing ILU(0) sweep on the expanded pattern with value-0 fill slots —
    ILU(k) *is* ILU(0) on the level-k pattern.  Goes beyond the reference,
    which aborts for fill level > 0 (``ldu_solvers.f90:414-417``).
    Returns the same (L_csr, d, U_csr) triple as :func:`ildu0_factorize`.
    """
    from sigma_tpu import native

    if A.shape[0] != A.shape[1]:
        raise ValueError("ILDU requires a square matrix")
    if k == 0:
        return ildu0_factorize(A)
    n = A.shape[0]
    indptr, indices, data = _csr_arrays(A)
    sym = native.iluk_symbolic(indptr, indices, k)
    if sym is None:
        sym = _iluk_symbolic_numpy(indptr, indices, n, k)
    fptr, fcol = sym
    # scatter A's values into the expanded pattern (fill slots stay 0)
    fdata = np.zeros(fcol.size, dtype=np.float64)
    rows_a = np.repeat(np.arange(n), np.diff(indptr))
    rows_f = np.repeat(np.arange(n), np.diff(fptr))
    # position of each A entry in F: F rows are sorted supersets of A rows
    keys_f = rows_f * n + fcol
    keys_a = rows_a * n + indices
    pos = np.searchsorted(keys_f, keys_a)
    fdata[pos] = data
    res = native.ilu0_factorize(fptr, fcol, fdata)
    if res is not None:
        lu, diag = res
    else:
        lu, diag = _ilu0_numpy(fptr, fcol, fdata, n)
    return _split_ldu(fptr, fcol, lu, diag, n)


def _split_ldu(indptr, indices, lu, diag, n):
    """Split a factorized in-place pattern into strict L (unit), D, and
    strict unit-U (u_ij / d_i) CSR triples."""
    rows_all = np.repeat(np.arange(n), np.diff(indptr))
    lower = indices < rows_all
    upper = indices > rows_all
    Lp = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows_all[lower], minlength=n), out=Lp[1:])
    Up = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows_all[upper], minlength=n), out=Up[1:])
    Uvals = lu[upper] / diag[rows_all[upper]]
    return (
        (Lp, indices[lower], lu[lower]),
        diag,
        (Up, indices[upper], Uvals),
    )


def _levels(indptr, indices, n, reverse: bool) -> np.ndarray:
    """Dependency levels of a strict triangular system (host-side).

    lower (reverse=False): row i depends on cols j < i.
    upper (reverse=True):  row i depends on cols j > i — process n-1..0.
    """
    from sigma_tpu import native

    res = native.triangular_levels(indptr, indices, reverse=reverse)
    if res is not None:
        return res[0]
    level = np.zeros(n, dtype=np.int64)
    order = range(n - 1, -1, -1) if reverse else range(n)
    for i in order:
        js = indices[indptr[i] : indptr[i + 1]]
        js = js[js > i] if reverse else js[js < i]  # direction filter (= C++)
        if js.size:
            level[i] = level[js].max() + 1
    return level


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, repr=False)
class TriangularLevels:
    """A strict unit-triangular system packed by dependency level.

    ``rows[l]`` are the rows solvable at level l (pad sentinel n → scatter
    dropped); ``cols``/``vals`` are their strict entries (pad col 0, val 0).
    ``solve(b)`` runs one batched update per level.
    """

    rows: jax.Array  # (nlev, max_rows) int32
    cols: jax.Array  # (nlev, max_rows, width) int32
    vals: jax.Array  # (nlev, max_rows, width)
    n: int = dataclasses.field(metadata=dict(static=True))

    @classmethod
    def from_csr(cls, indptr, indices, data, n, reverse: bool, dtype):
        from sigma_tpu import native

        level = _levels(indptr, indices, n, reverse)
        nlev = int(level.max()) + 1 if n else 1
        counts = np.bincount(level, minlength=nlev)
        max_rows = max(int(counts.max()), 1)
        deg = np.diff(indptr)
        width = max(int(deg.max()) if n else 0, 1)
        packed = native.pack_levels(
            indptr, indices, data, level, nlev, max_rows, width
        )
        if packed is not None:
            rows, cols, vals = packed
        else:
            rows = np.full((nlev, max_rows), n, dtype=np.int64)
            cols = np.zeros((nlev, max_rows, width), dtype=np.int64)
            vals = np.zeros((nlev, max_rows, width), dtype=np.float64)
            slot = np.zeros(nlev, dtype=np.int64)
            for i in range(n):
                l = level[i]
                s_ = slot[l]
                rows[l, s_] = i
                d = deg[i]
                cols[l, s_, :d] = indices[indptr[i] : indptr[i + 1]]
                vals[l, s_, :d] = data[indptr[i] : indptr[i + 1]]
                slot[l] += 1
        return cls(
            rows=jnp.asarray(rows, dtype=index_dtype),
            cols=jnp.asarray(cols, dtype=index_dtype),
            vals=jnp.asarray(vals, dtype=dtype),
            n=int(n),
        )

    @property
    def nlev(self) -> int:
        return self.rows.shape[0]

    def solve(self, b: jax.Array) -> jax.Array:
        """x solving (I + T) x = b, batched per level."""
        nm1 = max(self.n - 1, 0)

        def body(l, x):
            rows = self.rows[l]
            acc = (self.vals[l] * x[self.cols[l]]).sum(axis=-1)
            xi = b[jnp.minimum(rows, nm1)] - acc
            return x.at[rows].set(xi)  # sentinel rows (= n) dropped

        return jax.lax.fori_loop(0, self.nlev, body, jnp.zeros_like(b))

    def solve_t(self, b: jax.Array) -> jax.Array:
        """x solving (I + T)^T x = b — the SAME packed levels, walked in
        reverse with scatter instead of gather: a row r at level l is final
        once every level > l has scattered (any entry T_{j,r} lives in a
        row j of strictly higher level), so no transpose pattern is ever
        built.  Unlocks ILDU-preconditioned adjoint/A^T solves
        (the reference has no analogue; its sweeps are rows-only)."""
        nm1 = max(self.n - 1, 0)

        def body(i, x):
            l = self.nlev - 1 - i
            rows = self.rows[l]
            xi = x[jnp.minimum(rows, nm1)]  # final at this level
            # sentinel/padded slots carry val 0 -> scatter contributes 0
            return x.at[self.cols[l]].add(-self.vals[l] * xi[:, None])

        return jax.lax.fori_loop(0, self.nlev, body, b)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, repr=False)
class ILDUPreconditioner(LinearOperator):
    """Applies z = (L D U)^{-1} r via two level-scheduled sweeps + a diagonal
    scale — the jit-resident form of ``ldu_solve`` (ldu_solvers.f90:160)."""

    lower: TriangularLevels
    dinv: jax.Array
    upper: TriangularLevels

    @property
    def shape(self):
        return (self.dinv.shape[0], self.dinv.shape[0])

    def matvec(self, r):
        y = self.lower.solve(r)
        return self.upper.solve(self.dinv * y)

    def rmatvec(self, r):
        """z = (L D U)^{-T} r = L^{-T} D^{-1} U^{-T} r via the reverse-order
        scatter sweeps (``TriangularLevels.solve_t``) — so an ILDU-
        preconditioned adjoint solve composes like any other operator."""
        y = self.upper.solve_t(r)
        return self.lower.solve_t(self.dinv * y)


@dataclasses.dataclass(frozen=True)
class LDUSolver(LinearSolver):
    """Factory object mirroring ``ldu(incomplete, level)``
    (ldu_solvers.f90:73).  incomplete=True, level=0 → ILDU(0)/IC(0);
    level > 0 → level-of-fill ILU(k) (the reference aborts there,
    :414-417 — this goes beyond it); incomplete=False → dense LU fallback
    (the reference's unimplemented TODO at :143-145)."""

    incomplete: bool = True
    level: int = 0

    def setup(self, A) -> LinearOperator:
        if not self.incomplete:
            from sigma_tpu.operators.linear_operator import MatvecOperator
            import jax.scipy.linalg as jsl

            lu_and_piv = jsl.lu_factor(jnp.asarray(A.to_dense()))
            return MatvecOperator(
                params=lu_and_piv,
                mv=lambda lu_piv, b: jsl.lu_solve(lu_piv, b),
                rmv=None,
                shape=A.shape,
            )
        if self.level < 0:
            raise ValueError(f"fill level must be >= 0, got {self.level}")
        (Lp, Li, Lx), d, (Up, Ui, Ux) = iluk_factorize(A, self.level)
        n = A.shape[0]
        dtype = A.data.dtype
        return ILDUPreconditioner(
            lower=TriangularLevels.from_csr(Lp, Li, Lx, n, reverse=False, dtype=dtype),
            dinv=jnp.asarray(1.0 / d, dtype=dtype),
            upper=TriangularLevels.from_csr(Up, Ui, Ux, n, reverse=True, dtype=dtype),
        )

    def solve_info(self, A, b, x0=None, M=None):
        op = self.setup(A)
        x = op.matvec(b)
        r = b - A.matvec(x)
        rn = jnp.linalg.norm(r)
        return x, SolveInfo(jnp.asarray(1, jnp.int32), rn, jnp.isfinite(rn))


def ldu(incomplete: bool = True, level: int = 0) -> LDUSolver:
    return LDUSolver(incomplete=incomplete, level=level)


def incomplete_cholesky() -> LDUSolver:
    """IC(0): the SPD specialization is the same zero-fill LDU factorization
    (cf. test/solver_test_incomplete_cholesky.f90 driving ldu)."""
    return LDUSolver(incomplete=True, level=0)
