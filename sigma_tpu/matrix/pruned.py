"""Pruned block-DIA matrix: the unstructured-sparsity flagship format.

The DIA recipe for general sparsity (RCM reorder -> store every diagonal
of the band, :mod:`sigma_tpu.matrix.banded`) pays ``n_diags * n`` slots
of memory traffic even though after RCM the band is only locally narrow:
on an irregular mesh most of the band's slots are structural zeros.  This
format stores only the ACTIVE (row-tile x diagonal) blocks, packed
linearly (:mod:`sigma_tpu.matrix.pruned_plan`), so the value stream
shrinks to the packed size, and the 10M-row RCM band, which would not fit
one device in full DIA, fits in its packed form.

Re-designs the reference's any-pattern CSR kernel
(``/root/reference/src/matrix/formats/cs_matrices.f90:600-622``): CSR
adapts per row, this format adapts per row tile.

Like :class:`sigma_tpu.matrix.symmetric.SymmetricDIAMatrix` this is a
frozen :class:`LinearOperator` (compose with every solver), not a mutable
SparseMatrix — structural edits go back through COO.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sigma_tpu.operators.linear_operator import LinearOperator

__all__ = [
    "PrunedDIAMatrix",
    "SymmetricPrunedDIAMatrix",
    "check_symmetric_triples",
]


def check_symmetric_triples(n, rows, cols, vals, rtol=1e-12):
    """Raise ValueError unless the COO triples are numerically symmetric
    (pattern AND values, entry-by-entry within ``rtol`` of the largest
    off-diagonal).  Shared by the single-device and distributed
    symmetric-pruned constructors.

    Duplicate keys are canonicalized LAST-VALUE-WINS first — the same
    semantics the packing applies — so the check judges the matrix the
    operator will actually hold (an unstable sort over raw duplicates
    could pair mismatched values either way)."""

    def _canon(k, v):
        # stable sort + take the last entry of each equal-key run
        o = np.argsort(k, kind="stable")
        ks, vs = k[o], v[o]
        last = np.ones(ks.size, dtype=bool)
        last[:-1] = ks[1:] != ks[:-1]
        return ks[last], vs[last]

    rows = np.asarray(rows, dtype=np.int64).ravel()
    cols = np.asarray(cols, dtype=np.int64).ravel()
    vals = np.asarray(vals).ravel()
    up = cols > rows
    lo = cols < rows
    ku, vu = _canon(rows[up] * np.int64(n) + cols[up], vals[up])
    kl, vl = _canon(cols[lo] * np.int64(n) + rows[lo], vals[lo])
    if ku.size != kl.size or not np.array_equal(ku, kl):
        raise ValueError(
            "matrix pattern is not symmetric (upper/lower mirrors "
            "differ); pass validate=False only for known-symmetric "
            "triples"
        )
    scale = max(float(np.abs(vu).max(initial=0.0)), 1e-300)
    if float(np.abs(vu - vl).max(initial=0.0)) > rtol * scale:
        raise ValueError("matrix values are not symmetric")


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, repr=False)
class PrunedDIAMatrix(LinearOperator):
    """Packed active (row-tile x diagonal) blocks of a banded matrix.

    ``data[l, c]`` is the (T, 128) value block of one (tile, offset)
    pair; ``tile``/``first`` index each step's row tile;
    ``rowoff``/``laneoff`` give each slot's x-window position
    (``q = halo*128 + offset``).  Slots are ordered by (tile, offset).
    """

    data: jax.Array  # (L, C, T, 128) packed value blocks
    tile: jax.Array  # (L,) int32 row tile per step
    first: jax.Array  # (L,) int32 1 = first step of its tile
    rowoff: jax.Array  # (L*C,) int32 window sublane offset per slot
    laneoff: jax.Array  # (L*C,) int32 window lane offset per slot
    n: int = dataclasses.field(metadata=dict(static=True))
    m: int = dataclasses.field(metadata=dict(static=True))
    halo: int = dataclasses.field(metadata=dict(static=True))  # E sublanes
    nnz: int = dataclasses.field(metadata=dict(static=True))
    # optional transposed-plan twin (see with_transpose): carried as a
    # pytree child so rmatvec/rmatmat work INSIDE jit when present —
    # the plan build is a host operation and cannot run under a tracer
    t: "PrunedDIAMatrix" = None

    format: ClassVar[str] = "dia_pruned"
    is_get_row_fast: ClassVar[bool] = False
    is_get_column_fast: ClassVar[bool] = False

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.m)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def tile_rows(self) -> int:
        return self.data.shape[2] * 128

    @property
    def group(self) -> int:
        return self.data.shape[1]

    @property
    def n_steps(self) -> int:
        return self.data.shape[0]

    @property
    def stored_slots(self) -> int:
        """Packed slot count = the value words each matvec streams."""
        return int(self.data.size)

    # -- construction ------------------------------------------------------
    @classmethod
    def from_coo(
        cls, n, m, rows, cols, vals, *, dtype=None,
        tile_rows: int = 16384, group: int | None = None,
        assume_unique=False,
    ) -> "PrunedDIAMatrix":
        """Pack COO entries (duplicate entries: last value wins, matching
        ``SparseMatrix.set_values``).  ``tile_rows`` is the pruning
        granularity; ``group`` the slots per step.
        ``assume_unique`` skips the nnz-dedup sort (pass it when the
        triples come from ``entries()``, which is already canonical —
        saves an O(nnz log nnz) host pass at 10M-row scale)."""
        from sigma_tpu.matrix.pruned_plan import build_pruned_plan

        dt = jnp.dtype(dtype or np.asarray(vals).dtype)
        if dt == jnp.float64 and not jax.config.read("jax_enable_x64"):
            dt = jnp.dtype(jnp.float32)
        if group is None:
            group = 16 if dt == jnp.bfloat16 else 8
        # low-precision targets build the plan in f32 (the C++ fast path)
        # and cast on device — numpy has no native bf16 scatter anyway
        plan_dt = np.float32 if dt == jnp.bfloat16 else dt
        plan = build_pruned_plan(
            n, m, rows, cols, vals, tile_rows=tile_rows, group=group,
            dtype=plan_dt,
        )
        rows = np.asarray(rows)
        if assume_unique:
            nnz = rows.size
        else:
            key = rows.astype(np.int64) * int(m) + np.asarray(cols)
            nnz = int(np.unique(key).size)
        return cls(
            data=jnp.asarray(
                plan.data.reshape(plan.L, plan.C, plan.T, 128)
            ).astype(dt),
            tile=jnp.asarray(plan.tile),
            first=jnp.asarray(plan.first),
            rowoff=jnp.asarray(plan.rowoff),
            laneoff=jnp.asarray(plan.laneoff),
            n=int(plan.n), m=int(plan.m), halo=int(plan.E),
            nnz=int(nnz),
        )

    @classmethod
    def from_dia(cls, A, **kw) -> "PrunedDIAMatrix":
        """Repack a (wide-band) DIAMatrix; drops its structural zeros."""
        rows, cols, vals = A.entries()
        vals = np.asarray(vals)
        keep = vals != 0
        return cls.from_coo(
            A.shape[0], A.shape[1], np.asarray(rows)[keep],
            np.asarray(cols)[keep], vals[keep],
            dtype=np.asarray(A.data).dtype, **kw,
        )

    @classmethod
    def from_dense(cls, dense, **kw) -> "PrunedDIAMatrix":
        dense = np.asarray(dense)
        rows, cols = np.nonzero(dense)
        return cls.from_coo(
            dense.shape[0], dense.shape[1], rows, cols, dense[rows, cols],
            dtype=dense.dtype, **kw,
        )

    # -- introspection -----------------------------------------------------
    def entries(self):
        """(rows, cols, vals) of the stored nonzeros (host numpy).

        The pattern is reconstructed from nonzero VALUES (padding slots
        are indistinguishable from stored zeros in the packed layout), so
        explicitly-stored zero entries are dropped — ``transpose()``,
        ``get_value()`` and entries-based round-trips lose them, and
        ``nnz`` (set at construction) can then exceed ``len(vals)``.
        Keep the original COO triples when an exact structural
        round-trip matters."""
        T = self.data.shape[2]
        E = self.halo
        data = np.asarray(self.data).reshape(-1, T * 128)
        ro = np.asarray(self.rowoff).astype(np.int64)
        lo = np.asarray(self.laneoff).astype(np.int64)
        offs = (ro - E) * 128 + lo
        starts = np.repeat(np.asarray(self.tile, dtype=np.int64), self.group)
        starts = starts * (T * 128)
        slots, locs = np.nonzero(data)
        rows = starts[slots] + locs
        cols = rows + offs[slots]
        vals = data[slots, locs]
        ok = (rows < self.n) & (cols >= 0) & (cols < self.m)
        return rows[ok], cols[ok], vals[ok]

    def to_dense(self) -> np.ndarray:
        rows, cols, vals = self.entries()
        out = np.zeros(self.shape, dtype=np.asarray(self.data).dtype)
        out[rows, cols] = vals
        return out

    def astype(self, dtype) -> "PrunedDIAMatrix":
        """Per-value cast (bf16 halves the dominant value stream)."""
        return dataclasses.replace(
            self,
            data=self.data.astype(dtype),
            t=None if self.t is None else self.t.astype(dtype),
        )

    def transpose(self) -> "PrunedDIAMatrix":
        """Host rebuild of the transposed matrix (pruned layout is
        orientation-specific, like CSR<->CSC in the reference)."""
        rows, cols, vals = self.entries()
        return PrunedDIAMatrix.from_coo(
            self.m, self.n, cols, rows, vals,
            dtype=np.asarray(self.data).dtype,
            tile_rows=self.tile_rows, group=self.group,
            assume_unique=True,
        )

    def with_transpose(self) -> "PrunedDIAMatrix":
        """Return a copy carrying the transposed plan as a pytree child,
        making ``rmatvec``/``rmatmat`` usable INSIDE jit (transpose-
        consuming solvers: ``cgls_solve``, adjoint operators).  The plan
        build is host work, so do this at setup time::

            P = PrunedDIAMatrix.from_coo(...).with_transpose()
            x, info = jax.jit(cgls_solve)(P, b)
        """
        if self.t is not None:
            return self
        return dataclasses.replace(self, t=self.transpose())

    # -- compute -------------------------------------------------------
    def _plan_kwargs(self):
        return dict(
            T=self.data.shape[2], E=self.halo, C=self.group,
            n=self.n, m=self.m,
        )

    def matvec(self, x):
        from sigma_tpu.matrix.pruned_plan import pruned_matvec_reference

        if x.ndim != 1:
            raise ValueError("matvec expects a vector; use matmat")
        return pruned_matvec_reference(
            self.data, x, self.tile, self.rowoff, self.laneoff,
            **self._plan_kwargs(),
        )

    def rmatvec(self, x):
        """Transpose apply through the transposed plan (the pruned
        layout is row-tile oriented; the reference's CSR<->CSC kernel
        duality, ``cs_matrices.f90:148-149``, becomes an explicit
        transposed plan here).  Inside jit the plan must already be
        attached — call :meth:`with_transpose` at setup."""
        return self._transposed().matvec(x)

    def _transposed(self) -> "PrunedDIAMatrix":
        if self.t is not None:
            return self.t
        if isinstance(self.data, jax.core.Tracer):
            raise NotImplementedError(
                "rmatvec inside jit needs the transposed plan attached: "
                "build the operator with "
                "PrunedDIAMatrix.from_coo(...).with_transpose() (a host "
                "setup step; a traced value cannot be repacked)"
            )
        cached = getattr(self, "_t_cache", None)
        if cached is None:
            cached = self.transpose()
            object.__setattr__(self, "_t_cache", cached)
        return cached

    def matmat_rhs_major(self, XT):
        """Multi-RHS apply on an RHS-major block: ``XT`` is (k, m),
        returns (k, n) — the multi-vector capability the reference names
        as a missing critical optimization (``README.md:83``).  The slot
        index arrays do not depend on x, so under ``vmap`` they are built
        once for all k."""
        return jax.vmap(self.matvec)(XT)

    def matmat(self, X):
        """Multi-vector product A @ X for X (m, k)."""
        return self.matmat_rhs_major(X.T).T

    def rmatmat(self, X):
        """A.T @ X through the transposed plan (see :meth:`rmatvec`)."""
        return self._transposed().matmat(X)

    def get_value(self, i: int, j: int):
        rows, cols, vals = self.entries()
        hit = (rows == i) & (cols == j)
        return float(vals[hit][0]) if hit.any() else 0.0


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, repr=False)
class SymmetricPrunedDIAMatrix(PrunedDIAMatrix):
    """Symmetric-storage pruned block-DIA: packs only the UPPER-triangle
    (offset >= 0) active blocks — half the value stream of
    :class:`PrunedDIAMatrix` on an SPD operator — and applies the lower
    triangle as a scatter-add mirror pass
    (:func:`sigma_tpu.matrix.pruned_plan.pruned_sym_matvec_reference`).

    This closes the last of the reference's three named missing
    "critical optimizations" (``/root/reference/README.md:81-87``) for
    the unstructured flagship format: symmetric storage existed for
    full-band DIA (:class:`~sigma_tpu.matrix.symmetric.
    SymmetricDIAMatrix`) but the pruned format — the
    designated general-sparsity path — streamed both triangles.

    Same frozen-pytree/LinearOperator contract as the full pruned
    format; ``nnz`` counts BOTH triangles; ``transpose()`` is the
    identity and ``rmatvec`` = ``matvec``.
    """

    format: ClassVar[str] = "dia_pruned_sym"

    # -- construction ------------------------------------------------------
    @classmethod
    def from_coo(
        cls, n, m, rows, cols, vals, *, dtype=None,
        tile_rows: int = 16384, group: int | None = None,
        assume_unique=False, validate: bool = True, rtol: float = 1e-12,
    ) -> "SymmetricPrunedDIAMatrix":
        """Pack the upper triangle of FULL (both-triangle) COO triples.
        ``validate`` checks numeric symmetry entry-by-entry (mirroring
        :meth:`SymmetricDIAMatrix.from_dia`'s contract) — pass
        ``validate=False`` for triples known symmetric (e.g. an SPD
        assembly) to skip the O(nnz log nnz) host check."""
        from sigma_tpu.matrix.pruned_plan import build_pruned_plan

        if int(n) != int(m):
            raise ValueError("symmetric storage requires a square matrix")
        n = int(n)
        rows = np.asarray(rows, dtype=np.int64).ravel()
        cols = np.asarray(cols, dtype=np.int64).ravel()
        vals = np.asarray(vals).ravel()
        if validate:
            check_symmetric_triples(n, rows, cols, vals, rtol=rtol)
        keep = cols >= rows
        urows, ucols, uvals = rows[keep], cols[keep], vals[keep]
        dt = jnp.dtype(dtype or vals.dtype)
        if dt == jnp.float64 and not jax.config.read("jax_enable_x64"):
            dt = jnp.dtype(jnp.float32)
        if group is None:
            group = 12
        plan_dt = np.float32 if dt == jnp.bfloat16 else dt
        plan = build_pruned_plan(
            n, n, urows, ucols, uvals, tile_rows=tile_rows, group=group,
            dtype=plan_dt,
        )
        if assume_unique:
            n_up = urows.size
            n_diag = int((urows == ucols).sum())
        else:
            key = urows * np.int64(n) + ucols
            uk = np.unique(key)
            n_up = int(uk.size)
            n_diag = int((uk // n == uk % n).sum())
        return cls(
            data=jnp.asarray(
                plan.data.reshape(plan.L, plan.C, plan.T, 128)
            ).astype(dt),
            tile=jnp.asarray(plan.tile),
            first=jnp.asarray(plan.first),
            rowoff=jnp.asarray(plan.rowoff),
            laneoff=jnp.asarray(plan.laneoff),
            n=n, m=n, halo=int(plan.E),
            nnz=2 * n_up - n_diag,
        )

    @classmethod
    def from_pruned(cls, A: PrunedDIAMatrix, *, tile_rows=None,
                    group=None, validate: bool = True,
                    rtol: float = 1e-12):
        """Fold a full-storage pruned matrix into symmetric storage
        (``tile_rows`` defaults to the source matrix's)."""
        rows, cols, vals = A.entries()
        return cls.from_coo(
            A.shape[0], A.shape[1], rows, cols, vals,
            dtype=np.asarray(A.data).dtype,
            tile_rows=A.tile_rows if tile_rows is None else tile_rows,
            group=group, assume_unique=True, validate=validate,
            rtol=rtol,
        )

    # -- introspection -----------------------------------------------------
    def entries(self):
        """Both-triangle (rows, cols, vals): the stored upper entries
        plus their mirrors (same explicit-zero caveat as the parent)."""
        r, c, v = super().entries()
        off = c > r
        return (
            np.concatenate([r, c[off]]),
            np.concatenate([c, r[off]]),
            np.concatenate([v, v[off]]),
        )

    def _upper_counts(self):
        # entries() pulls the FULL packed buffer to the host (~GBs at
        # the north star) — memoize so both count properties cost one
        # pull total
        cached = getattr(self, "_upper_counts_cache", None)
        if cached is None:
            r, c, _ = super().entries()
            cached = (int(r.size), int((r == c).sum()))
            object.__setattr__(self, "_upper_counts_cache", cached)
        return cached

    @property
    def stored_upper(self) -> int:
        """Stored upper-triangle entry count (incl. main diagonal),
        reconstructed from the packed values — like :meth:`entries`
        this DROPS explicitly-stored zeros, so it can undercount vs the
        construction-time ``nnz`` (which keeps them); both count
        properties are derived from one memoized entries() pull so they
        stay mutually consistent."""
        return self._upper_counts()[0]

    @property
    def n_diag_entries(self) -> int:
        """Stored main-diagonal entry count (same explicit-zero-drop
        caveat as :meth:`entries` / :attr:`stored_upper`)."""
        return self._upper_counts()[1]

    def transpose(self) -> "SymmetricPrunedDIAMatrix":
        return self

    def with_transpose(self) -> "SymmetricPrunedDIAMatrix":
        return self

    # -- compute -------------------------------------------------------
    def matvec(self, x):
        from sigma_tpu.matrix.pruned_plan import pruned_sym_matvec_reference

        if x.ndim != 1:
            raise ValueError("matvec expects a vector; use matmat")
        return pruned_sym_matvec_reference(
            self.data, x, self.tile, self.rowoff, self.laneoff,
            **self._plan_kwargs(),
        )

    rmatvec = matvec

    def matmat(self, X):
        return self.matmat_rhs_major(X.T).T

    rmatmat = matmat
