"""Composable linear operators as JAX pytrees.

The reference builds a small C*-algebra of operators: an abstract
``linear_operator`` with deferred ``matvec_add``/``matvec_t_add`` plus lazy
refcounted sum / product / adjoint composites
(``/root/reference/src/linear_operator/linear_operator_interface.f90``,
``linear_operator_sums.f90``, ``linear_operator_products.f90``,
``linear_operator_adjoints.f90``).  Here the same algebra is immutable
pytrees: ``A + B``, ``A @ B``, ``alpha * A``, ``A.T`` build lazy composite
nodes whose ``matvec`` recurses into children — fully jit-traceable, and
garbage collection replaces the reference's manual ``add_reference``
refcounts (``linear_operator_interface.f90:134-162``).

Multi-vector products (``matmat``) are first-class — the capability the
reference names as a missing critical optimization (``README.md:83``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "LinearOperator",
    "SumOperator",
    "ProductOperator",
    "AdjointOperator",
    "ScaledOperator",
    "IdentityOperator",
    "DiagonalOperator",
    "DenseOperator",
    "MatvecOperator",
    "OperatorWithSolver",
    "aslinearoperator",
    "attach_solver",
]


class LinearOperator:
    """Protocol: anything with a shape, ``matvec`` and ``rmatvec``.

    Subclasses are registered dataclass pytrees so operators flow through
    ``jax.jit``/``grad``/``vmap`` like any other array container.
    """

    shape: Tuple[int, int]

    # -- core products -------------------------------------------------------
    def matvec(self, x: jax.Array) -> jax.Array:
        raise NotImplementedError

    def rmatvec(self, x: jax.Array) -> jax.Array:
        """Transpose product A^T x (``matvec_t``)."""
        raise NotImplementedError

    def matmat(self, X: jax.Array) -> jax.Array:
        """Multi-vector product A @ X for X of shape (m, k)."""
        return jax.vmap(self.matvec, in_axes=1, out_axes=1)(X)

    def rmatmat(self, X: jax.Array) -> jax.Array:
        return jax.vmap(self.rmatvec, in_axes=1, out_axes=1)(X)

    def dot(self, x: jax.Array) -> jax.Array:
        """matvec for 1-D x, matmat for 2-D x."""
        if x.ndim == 1:
            return self.matvec(x)
        if x.ndim == 2:
            return self.matmat(x)
        raise ValueError(f"operand must be 1- or 2-D, got shape {x.shape}")

    # -- probes ---------------------------------------------------------------
    def get_value(self, i: int, j: int):
        """Entry probe via a basis-vector matvec, the generic fallback of
        ``linear_operator_interface.f90:167-180``.  Matrices override this
        with an O(1) lookup."""
        e = jnp.zeros(self.shape[1]).at[j].set(1.0)
        return self.matvec(e)[i]

    def to_dense(self) -> np.ndarray:
        eye = jnp.eye(self.shape[1])
        return np.asarray(self.matmat(eye))

    # -- algebra sugar ---------------------------------------------------------
    def __add__(self, other: "LinearOperator") -> "LinearOperator":
        return SumOperator.of(self, other)

    def __sub__(self, other: "LinearOperator") -> "LinearOperator":
        return SumOperator.of(self, ScaledOperator(jnp.asarray(-1.0), other))

    def __mul__(self, alpha) -> "LinearOperator":
        return ScaledOperator(jnp.asarray(alpha), self)

    __rmul__ = __mul__

    def __neg__(self) -> "LinearOperator":
        return ScaledOperator(jnp.asarray(-1.0), self)

    def __matmul__(self, other):
        if isinstance(other, LinearOperator):
            return ProductOperator.of(self, other)
        return self.dot(jnp.asarray(other))

    @property
    def T(self) -> "LinearOperator":
        return AdjointOperator(self)

    adjoint = T

    # -- solve façade (linear_operator_interface.f90:213-254) -----------------
    def solve(self, b: jax.Array, solver=None, preconditioner=None, **kw):
        """Solve A x = b.  Uses the given solver object (anything with a
        ``solve(A, b, M=...)`` method, see :mod:`sigma_tpu.solvers`) or
        defaults to CG; ``**kw`` configures the DEFAULT solver only —
        combining it with an explicit ``solver`` raises (silently
        dropping tol=/maxiter= would return under-converged results
        with no error, the OperatorWithSolver.solve contract)."""
        if solver is None:
            from sigma_tpu.solvers import cg as _cg

            solver = _cg(**kw)
        elif kw:
            raise TypeError(
                f"solver parameters {sorted(kw)} must be set on the "
                "passed solver object (they configure the default CG "
                "only; dropping them silently would under-converge)"
            )
        return solver.solve(self, b, M=preconditioner)

    def __repr__(self) -> str:
        return f"{type(self).__name__}(shape={self.shape})"


def _check_same_shape(ops: Sequence[LinearOperator]) -> Tuple[int, int]:
    shape = ops[0].shape
    for op in ops[1:]:
        if op.shape != shape:
            raise ValueError(
                f"operator shape mismatch in sum: {shape} vs {op.shape}"
            )
    return shape


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, repr=False)
class SumOperator(LinearOperator):
    """Lazy A + B (+ ...) — ``linear_operator_sums.f90``; matvec is the
    sequential accumulation of child matvecs (:94-107)."""

    terms: Tuple[LinearOperator, ...]

    @classmethod
    def of(cls, *ops: LinearOperator) -> "SumOperator":
        flat: list[LinearOperator] = []
        for op in ops:
            if isinstance(op, SumOperator):
                flat.extend(op.terms)
            else:
                flat.append(op)
        _check_same_shape(flat)
        return cls(terms=tuple(flat))

    @property
    def shape(self):
        return self.terms[0].shape

    def matvec(self, x):
        y = self.terms[0].matvec(x)
        for op in self.terms[1:]:
            y = y + op.matvec(x)
        return y

    def rmatvec(self, x):
        y = self.terms[0].rmatvec(x)
        for op in self.terms[1:]:
            y = y + op.rmatvec(x)
        return y

    def matmat(self, X):
        Y = self.terms[0].matmat(X)
        for op in self.terms[1:]:
            Y = Y + op.matmat(X)
        return Y

    def rmatmat(self, X):
        Y = self.terms[0].rmatmat(X)
        for op in self.terms[1:]:
            Y = Y + op.rmatmat(X)
        return Y


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, repr=False)
class ProductOperator(LinearOperator):
    """Lazy A @ B (@ ...) — ``linear_operator_products.f90``; matvec applies
    factors right-to-left (:96-107), rmatvec left-to-right (:136-145).  The
    reference's preallocated scratch vectors z1/z2 are unnecessary under XLA
    (the compiler buffers intermediates)."""

    factors: Tuple[LinearOperator, ...]

    @classmethod
    def of(cls, *ops: LinearOperator) -> "ProductOperator":
        flat: list[LinearOperator] = []
        for op in ops:
            if isinstance(op, ProductOperator):
                flat.extend(op.factors)
            else:
                flat.append(op)
        for a, b in zip(flat[:-1], flat[1:]):
            if a.shape[1] != b.shape[0]:
                raise ValueError(
                    f"operator product dimension mismatch: {a.shape} @ {b.shape}"
                )
        return cls(factors=tuple(flat))

    @property
    def shape(self):
        return (self.factors[0].shape[0], self.factors[-1].shape[1])

    def matvec(self, x):
        for op in reversed(self.factors):
            x = op.matvec(x)
        return x

    def rmatvec(self, x):
        for op in self.factors:
            x = op.rmatvec(x)
        return x

    def matmat(self, X):
        for op in reversed(self.factors):
            X = op.matmat(X)
        return X

    def rmatmat(self, X):
        for op in self.factors:
            X = op.rmatmat(X)
        return X


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, repr=False)
class AdjointOperator(LinearOperator):
    """Lazy transpose — ``linear_operator_adjoints.f90``: matvec ↔ rmatvec."""

    op: LinearOperator

    @property
    def shape(self):
        n, m = self.op.shape
        return (m, n)

    def matvec(self, x):
        return self.op.rmatvec(x)

    def rmatvec(self, x):
        return self.op.matvec(x)

    def matmat(self, X):
        return self.op.rmatmat(X)

    def rmatmat(self, X):
        # delegate to the wrapped operator's FAST multi-RHS path (the
        # base-class fallback is a per-column vmap — review fix)
        return self.op.matmat(X)

    @property
    def T(self):
        return self.op


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, repr=False)
class ScaledOperator(LinearOperator):
    """alpha * A (alpha is traced data, so it can be differentiated)."""

    alpha: jax.Array
    op: LinearOperator

    @property
    def shape(self):
        return self.op.shape

    def matvec(self, x):
        return self.alpha * self.op.matvec(x)

    def rmatvec(self, x):
        return self.alpha * self.op.rmatvec(x)

    def matmat(self, X):
        return self.alpha * self.op.matmat(X)

    def rmatmat(self, X):
        return self.alpha * self.op.rmatmat(X)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, repr=False)
class IdentityOperator(LinearOperator):
    n: int = dataclasses.field(metadata=dict(static=True))

    @property
    def shape(self):
        return (self.n, self.n)

    def matvec(self, x):
        return x

    rmatvec = matvec

    def matmat(self, X):
        return X


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, repr=False)
class DiagonalOperator(LinearOperator):
    diag: jax.Array

    @property
    def shape(self):
        return (self.diag.shape[0], self.diag.shape[0])

    def matvec(self, x):
        return self.diag * x

    rmatvec = matvec

    def matmat(self, X):
        return self.diag[:, None] * X


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, repr=False)
class DenseOperator(LinearOperator):
    """Dense matrix as an operator (used by tests/oracles)."""

    mat: jax.Array

    @property
    def shape(self):
        return self.mat.shape

    def matvec(self, x):
        return self.mat @ x

    def rmatvec(self, x):
        return self.mat.T @ x

    def matmat(self, X):
        return self.mat @ X

    def to_dense(self):
        return np.asarray(self.mat)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, repr=False)
class MatvecOperator(LinearOperator):
    """Wrap arbitrary (jit-traceable) matvec/rmatvec callables."""

    params: Any  # pytree closed over by the callables
    mv: Any = dataclasses.field(metadata=dict(static=True))
    rmv: Any = dataclasses.field(metadata=dict(static=True))
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))

    def matvec(self, x):
        return self.mv(self.params, x)

    def rmatvec(self, x):
        if self.rmv is None:
            raise NotImplementedError("no rmatvec supplied")
        return self.rmv(self.params, x)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, repr=False)
class OperatorWithSolver(LinearOperator):
    """Operator with an attached solver — the reference's
    ``A%set_solver``/``A%solve`` facade (``linear_operator_interface.f90:
    213-272``).  Used e.g. for the B operand of generalized Lanczos."""

    op: LinearOperator
    solver: Any = dataclasses.field(metadata=dict(static=True))
    # a pytree CHILD, not static: preconditioners are array-bearing
    # pytrees (AMG hierarchies run to GBs at the north star) — a static
    # field would embed them as jaxpr constants, which a) lands the
    # whole hierarchy in the compiled program as constants and b) hashes
    # arrays
    preconditioner: Any = None

    @property
    def shape(self):
        return self.op.shape

    def matvec(self, x):
        return self.op.matvec(x)

    def rmatvec(self, x):
        return self.op.rmatvec(x)

    def matmat(self, X):
        return self.op.matmat(X)

    # explicit-disable sentinel: preconditioner=None must mean "solve
    # UNPRECONDITIONED", not "fall back to the attached one" (and a
    # truthiness test crashes on raw-array preconditioners)
    _UNSET = object()

    def solve(self, b, solver=None, preconditioner=_UNSET):
        # no **kw: solver parameters live on the attached solver config —
        # silently dropping tol=/maxiter= overrides here would return
        # under-converged results with no error
        M = (
            self.preconditioner
            if preconditioner is OperatorWithSolver._UNSET
            else preconditioner
        )
        return (self.solver if solver is None else solver).solve(
            self.op, b, M=M
        )


def attach_solver(op: LinearOperator, solver, preconditioner=None) -> OperatorWithSolver:
    return OperatorWithSolver(op=op, solver=solver, preconditioner=preconditioner)


def aslinearoperator(A) -> LinearOperator:
    if isinstance(A, LinearOperator):
        return A
    A = jnp.asarray(A)
    if A.ndim != 2:
        raise ValueError("expected a 2-D array or LinearOperator")
    return DenseOperator(A)
