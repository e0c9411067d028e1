"""Explicit (materialized) sparse matrix algebra: sum, SpGEMM, PtAP, RARt.

Reference: ``/root/reference/src/matrix/sparse_matrix_algebra.f90`` —
``sparse_matrix_sum:25``, ``sparse_matrix_product:154``, ``PtAP:425``,
``RARt:543``.  The reference runs a *symbolic* phase (accumulate the result
sparsity in a mutable ll_graph) followed by a *numeric* phase (re-traverse
edges, ``add_value`` each contribution), dispatching on the
``is_get_row_fast`` / ``is_get_column_fast`` capability flags
(``sparse_matrix_algebra.f90:178-187``).

Whole-array redesign
--------------------
Per-edge cursor traversal is an anti-pattern under XLA.  Here both phases are
whole-array:

* **symbolic** (host, numpy): the result sparsity and, crucially, a flat
  *contribution map* — for every scalar product ``A_ik * B_kj`` in the
  result, the source positions in ``A.data`` / ``B.data`` and the target
  position in ``C.data``.  Built by vectorized CSR-row expansion
  (``np.repeat`` over row degrees), not edge batches of 64.
* **numeric** (device, jit): ``C.data = segment_sum(A.data[pa] * B.data[pb],
  target)`` — one gather-multiply-scatter XLA program.

The numeric phase is packaged as a reusable *plan* (:class:`SpGEMMPlan`,
:class:`SparseSumPlan`, :class:`PtAPPlan`): for a fixed sparsity pattern
(e.g. re-assembled FEM matrices, Galerkin coarse operators rebuilt each
nonlinear step) re-running the product with new values is a single jitted
device call — a capability the serial reference cannot express.

The reference's capability-flag dispatch becomes unnecessary: every operand
is normalized to a host CSR view with a single lexsort, so the "never do
it, ever" row x column worst case (``README.md:90-91``) costs one host
re-sort instead of a deep format copy, regardless of operand orientation.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Type

import jax
import jax.numpy as jnp
import numpy as np

from sigma_tpu.matrix.base import SparseMatrix

__all__ = [
    "sparse_add",
    "sparse_matmul",
    "ptap",
    "rart",
    "SparseSumPlan",
    "SpGEMMPlan",
    "PtAPPlan",
]


# ---------------------------------------------------------------------------
# host-side symbolic helpers
# ---------------------------------------------------------------------------

def _pos_array(pos):
    """Device index array for a plan gather.  Without jax_enable_x64,
    jnp.asarray silently WRAPS int64 -> int32, so flat positions past
    2^31 (a wide-DIA operand at 10M rows spans billions of slots) would
    gather garbage — fail loudly instead (review fix)."""
    pos = np.asarray(pos)
    if pos.size and int(pos.max()) > np.iinfo(np.int32).max and not (
        jax.config.read("jax_enable_x64")
    ):
        raise ValueError(
            f"plan position {int(pos.max())} exceeds int32 and "
            "jax_enable_x64 is off: this operand's flat data space is "
            "too large for a device-side plan gather — use the native "
            "host algebra (sparse_matmul/sparse_add/ptap) or a packed "
            "format instead"
        )
    return jnp.asarray(pos)


def _coo_of(A: SparseMatrix) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(rows, cols, flat data positions) of the true (unpadded) entries."""
    from sigma_tpu.graph.graph import CSRGraph

    rows, cols = A.graph.edges_numpy()
    if type(A.graph) is CSRGraph:
        # the CSR layout IS row-major sorted COO: flat position p holds
        # edge p — skip edge_positions' keys-build + searchsorted pass
        # (the CSRMatrix.entries() lesson: ~45 s at 1M-row AMG setup on
        # this page-fault-bound host; review fix)
        return rows, cols, np.arange(rows.size, dtype=np.int64)
    pos = A.graph.edge_positions(rows, cols)
    return rows, cols, pos


def _csr_arrays(rows, cols, pos, n):
    """(ptr, cols, pos) host CSR view — the 'fast row slices' normal form
    (single shared implementation: graph.host_csr)."""
    from sigma_tpu.graph.graph import host_csr

    return host_csr(rows, cols, n, pos)


def _host_csr_view(A: SparseMatrix) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(indptr, cols, vals_f64) row-sorted host CSR view of A.  Free for
    CSR (the stored layout IS this form); one lexsort otherwise."""
    from sigma_tpu.matrix.formats import CSRMatrix

    if isinstance(A, CSRMatrix):
        g = A.graph
        indptr = np.asarray(g.indptr, dtype=np.int64)
        cols = np.asarray(g.indices, dtype=np.int64)[: g.nnz]
        vals = np.asarray(A.data, dtype=np.float64).reshape(-1)[: g.nnz]
        return indptr, cols, vals
    rows, cols, vals = A.entries()
    return _csr_arrays(rows, cols, vals, A.shape[0])


def _from_host_csr(
    cls: Type[SparseMatrix], n, m, cptr, ccol, cval, A: SparseMatrix
) -> SparseMatrix:
    """Materialize a compiled-host-algebra result (sorted, deduplicated CSR
    arrays) as ``cls``, skipping the re-sort for CSR."""
    from sigma_tpu.matrix.formats import CSRMatrix

    if cls is CSRMatrix:
        return CSRMatrix.from_csr_arrays(n, m, cptr, ccol, cval, dtype=A.dtype)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(cptr))
    kw = A._format_kwargs() if cls is type(A) else {}
    return cls.from_coo(
        n, m, rows, ccol, cval, dtype=A.dtype, sum_duplicates=False, **kw
    )


def _result_type(A: SparseMatrix, out_format) -> Type[SparseMatrix]:
    if out_format is None:
        return type(A)
    if isinstance(out_format, str):
        from sigma_tpu.matrix.factory import choose_matrix_type

        return choose_matrix_type(out_format)
    return out_format


def _freeze(cls, n, m, rows, cols, A: SparseMatrix) -> SparseMatrix:
    """Build a zero matrix of ``cls`` with sparsity {(rows, cols)}."""
    kw = A._format_kwargs() if cls is type(A) else {}
    g = cls._graph_class().from_coo(n, m, rows, cols, **kw)
    return cls.from_graph(g, dtype=A.dtype)


# ---------------------------------------------------------------------------
# numeric-phase plans (jittable pytrees)
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SparseSumPlan:
    """Reusable numeric phase of C = alpha*A + beta*B on fixed sparsity."""

    template: SparseMatrix  # zero-valued result matrix (holds the graph)
    a_pos: jax.Array  # positions into A.data flat
    a_seg: jax.Array  # target positions into C.data flat
    b_pos: jax.Array
    b_seg: jax.Array

    def __call__(self, A: SparseMatrix, B: SparseMatrix, alpha=1.0, beta=1.0):
        a = A.data.reshape(-1)[self.a_pos] * alpha
        b = B.data.reshape(-1)[self.b_pos] * beta
        nnz_flat = self.template.data.size
        flat = jax.ops.segment_sum(a, self.a_seg, num_segments=nnz_flat)
        flat = flat + jax.ops.segment_sum(b, self.b_seg, num_segments=nnz_flat)
        return self.template.with_data(
            flat.reshape(self.template.data.shape).astype(self.template.dtype)
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SpGEMMPlan:
    """Reusable numeric phase of C = A @ B on fixed sparsity patterns.

    ``C.data[seg] += A.data[a_pos] * B.data[b_pos]`` over all contributing
    scalar products — one gather-multiply-segment_sum XLA program
    (the device form of ``sparse_matrix_algebra.f90:372-418``).
    """

    template: SparseMatrix
    a_pos: jax.Array  # (n_contrib,) into A.data flat
    b_pos: jax.Array  # (n_contrib,) into B.data flat
    seg: jax.Array  # (n_contrib,) into C.data flat

    def __call__(self, A: SparseMatrix, B: SparseMatrix) -> SparseMatrix:
        prod = A.data.reshape(-1)[self.a_pos] * B.data.reshape(-1)[self.b_pos]
        flat = jax.ops.segment_sum(
            prod, self.seg, num_segments=self.template.data.size
        )
        return self.template.with_data(
            flat.reshape(self.template.data.shape).astype(self.template.dtype)
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PtAPPlan:
    """Reusable numeric phase of B = P^T A P (or R A R^T) on fixed sparsity.

    Three-index contraction B_ij = sum_kl P_ki A_kl P_lj flattened into one
    contribution map (the device form of
    ``sparse_matrix_algebra.f90:470-536``'s outer-product loop).
    """

    template: SparseMatrix
    left_pos: jax.Array  # into P.data (or R.data) flat — the left factor
    a_pos: jax.Array  # into A.data flat
    right_pos: jax.Array  # into P.data (or R.data) flat — the right factor
    seg: jax.Array  # into B.data flat

    def __call__(self, A: SparseMatrix, P: SparseMatrix) -> SparseMatrix:
        p = P.data.reshape(-1)
        prod = p[self.left_pos] * A.data.reshape(-1)[self.a_pos] * p[self.right_pos]
        flat = jax.ops.segment_sum(
            prod, self.seg, num_segments=self.template.data.size
        )
        return self.template.with_data(
            flat.reshape(self.template.data.shape).astype(self.template.dtype)
        )


# ---------------------------------------------------------------------------
# symbolic-phase builders
# ---------------------------------------------------------------------------

def plan_sparse_add(
    A: SparseMatrix, B: SparseMatrix, out_format=None
) -> SparseSumPlan:
    """Symbolic phase of A + B: edge-union sparsity + contribution map
    (``sparse_matrix_algebra.f90:56-100``)."""
    if A.shape != B.shape:
        raise ValueError(f"shape mismatch {A.shape} vs {B.shape}")
    n, m = A.shape
    ar, ac, apos = _coo_of(A)
    br, bc, bpos = _coo_of(B)
    rows = np.concatenate([ar, br])
    cols = np.concatenate([ac, bc])
    ukeys = np.unique(rows * m + cols)
    urows, ucols = ukeys // m, ukeys % m

    cls = _result_type(A, out_format)
    template = _freeze(cls, n, m, urows, ucols, A)
    a_seg = template.graph.edge_positions(ar, ac)
    b_seg = template.graph.edge_positions(br, bc)
    return SparseSumPlan(
        template=template,
        a_pos=_pos_array(apos),
        a_seg=jnp.asarray(a_seg),
        b_pos=_pos_array(bpos),
        b_seg=jnp.asarray(b_seg),
    )


def sparse_add(
    A: SparseMatrix, B: SparseMatrix, alpha=1.0, beta=1.0, out_format=None
) -> SparseMatrix:
    """Materialized C = alpha*A + beta*B (``sparse_matrix_sum:25``).

    One-shot calls run in the compiled host core (``native.csr_add``,
    O(nnz(C)) memory) when it is available and the scalars are concrete;
    re-evaluating a fixed sparsity with new values on device is what
    :func:`plan_sparse_add` is for."""
    from sigma_tpu import native

    if A.shape != B.shape:
        raise ValueError(f"shape mismatch {A.shape} vs {B.shape}")
    try:
        a, b = float(alpha), float(beta)
    except TypeError:
        a = b = None  # traced scalars -> device plan path
    if a is not None and native.available():
        aptr, acol, aval = _host_csr_view(A)
        bptr, bcol, bval = _host_csr_view(B)
        res = native.csr_add(aptr, acol, aval, bptr, bcol, bval, a, b)
        if res is not None:
            cls = _result_type(A, out_format)
            n, m = A.shape
            return _from_host_csr(cls, n, m, *res, A)
    return plan_sparse_add(A, B, out_format)(A, B, alpha, beta)


def plan_sparse_matmul(
    A: SparseMatrix, B: SparseMatrix, out_format=None
) -> SpGEMMPlan:
    """Symbolic phase of C = A @ B.

    Vectorized CSR-row expansion: for every entry (i, k) of A, expand over
    row k of B.  ``np.repeat`` over B's row degrees replaces the reference's
    nested edge-cursor loops (``sparse_matrix_algebra.f90:310-368``).

    The reference's capability-flag dispatch (row-driven vs column-driven
    traversal, ``sparse_matrix_algebra.f90:178-187``) is intentionally NOT
    reproduced: B is normalized to a host CSR view with one lexsort, which
    costs less than any orientation-specific traversal here — the "never
    do it, ever" row x column worst case (README.md:90-91) reduces to that
    same single sort.
    """
    if A.shape[1] != B.shape[0]:
        raise ValueError(f"inner dim mismatch {A.shape} @ {B.shape}")
    n, k_dim, m = A.shape[0], A.shape[1], B.shape[1]

    ar, ac, apos = _coo_of(A)
    br, bc, bpos = _coo_of(B)

    # Normal-form: B rows sliceable (host CSR of B over the inner index).
    bptr, bcols, bposs = _csr_arrays(br, bc, bpos, k_dim)

    # Expand: each A entry (i, k) contributes deg_B(k) products.
    counts = (bptr[ac + 1] - bptr[ac]).astype(np.int64)
    total = int(counts.sum())
    # flat indices into B's row-sorted arrays for every contribution
    starts = bptr[ac]
    expand = np.repeat(starts + counts - np.cumsum(counts), counts) + np.arange(
        total, dtype=np.int64
    )
    out_rows = np.repeat(ar, counts)
    out_cols = bcols[expand]
    a_contrib = np.repeat(apos, counts)
    b_contrib = bposs[expand]

    ukeys = np.unique(out_rows * m + out_cols)
    urows, ucols = ukeys // m, ukeys % m
    cls = _result_type(A, out_format)
    template = _freeze(cls, n, m, urows, ucols, A)
    seg = template.graph.edge_positions(out_rows, out_cols)
    return SpGEMMPlan(
        template=template,
        a_pos=_pos_array(a_contrib),
        b_pos=_pos_array(b_contrib),
        seg=jnp.asarray(seg),
    )


def sparse_matmul(
    A: SparseMatrix, B: SparseMatrix, out_format=None
) -> SparseMatrix:
    """Materialized C = A @ B (``sparse_matrix_product:154``).

    One-shot calls run in the compiled host core (``native.spgemm``,
    Gustavson sparse accumulator, O(nnz(C)) memory) when available — the
    plan path's contribution map costs ~10x the result's bytes, which this
    VM's page-fault-bound host memory turns into minutes at scale."""
    from sigma_tpu import native

    if A.shape[1] != B.shape[0]:
        raise ValueError(f"inner dim mismatch {A.shape} @ {B.shape}")
    if native.available():
        aptr, acol, aval = _host_csr_view(A)
        bptr, bcol, bval = _host_csr_view(B)
        res = native.spgemm(aptr, acol, aval, bptr, bcol, bval, B.shape[1])
        if res is not None:
            cls = _result_type(A, out_format)
            return _from_host_csr(cls, A.shape[0], B.shape[1], *res, A)
    return plan_sparse_matmul(A, B, out_format)(A, B)


def plan_ptap(A: SparseMatrix, P: SparseMatrix, out_format=None) -> PtAPPlan:
    """Symbolic phase of B = P^T A P (Galerkin triple product, ``PtAP:425``).

    For each entry (k, l) of A, the outer product row_P(k) x row_P(l)
    contributes to B — built by a double vectorized expansion.
    """
    if A.shape[0] != P.shape[0] or A.shape[1] != P.shape[0]:
        raise ValueError(f"PtAP shape mismatch A={A.shape}, P={P.shape}")
    return _plan_triple(A, P, transpose_left=True, out_format=out_format)


def ptap(A: SparseMatrix, P: SparseMatrix, out_format=None) -> SparseMatrix:
    """Materialized B = P^T A P.  One-shot calls run as two compiled host
    SpGEMMs (P^T (A P)) — same O(nnz) advantage as :func:`sparse_matmul`."""
    res = _native_triple(A, P, transpose_left=True, out_format=out_format)
    if res is not None:
        return res
    return plan_ptap(A, P, out_format)(A, P)


def plan_rart(A: SparseMatrix, R: SparseMatrix, out_format=None) -> PtAPPlan:
    """Symbolic phase of B = R A R^T (``RARt:543``)."""
    if A.shape[0] != R.shape[1] or A.shape[1] != R.shape[1]:
        raise ValueError(f"RARt shape mismatch A={A.shape}, R={R.shape}")
    return _plan_triple(A, R, transpose_left=False, out_format=out_format)


def rart(A: SparseMatrix, R: SparseMatrix, out_format=None) -> SparseMatrix:
    """Materialized B = R A R^T (two compiled host SpGEMMs when available)."""
    res = _native_triple(A, R, transpose_left=False, out_format=out_format)
    if res is not None:
        return res
    return plan_rart(A, R, out_format)(A, R)


def _native_triple(
    A: SparseMatrix, P: SparseMatrix, transpose_left: bool, out_format
) -> SparseMatrix | None:
    """Compiled-host Galerkin triple product, or None if native is off.
    PtAP = (P^T)(A P); RARt = (R A)(R^T) — two Gustavson SpGEMMs plus one
    counting-sort transpose, all O(nnz) memory."""
    from sigma_tpu import native

    if transpose_left:
        if A.shape[0] != P.shape[0] or A.shape[1] != P.shape[0]:
            raise ValueError(f"PtAP shape mismatch A={A.shape}, P={P.shape}")
    else:
        if A.shape[0] != P.shape[1] or A.shape[1] != P.shape[1]:
            raise ValueError(f"RARt shape mismatch A={A.shape}, P={P.shape}")
    if not native.available():
        return None
    aptr, acol, aval = _host_csr_view(A)
    pptr, pcol, pval = _host_csr_view(P)
    tp = native.csr_transpose(pptr, pcol, pval, P.shape[1])
    if tp is None:
        return None
    if transpose_left:
        # (n_c, n_c) = P^T @ (A @ P)
        ap = native.spgemm(aptr, acol, aval, pptr, pcol, pval, P.shape[1])
        res = native.spgemm(*tp, *ap, P.shape[1])
        n_out = P.shape[1]
    else:
        # (n_c, n_c) = (R @ A) @ R^T
        ra = native.spgemm(pptr, pcol, pval, aptr, acol, aval, A.shape[1])
        res = native.spgemm(*ra, *tp, P.shape[0])
        n_out = P.shape[0]
    cls = _result_type(A, out_format)
    return _from_host_csr(cls, n_out, n_out, *res, A)


def _plan_triple(
    A: SparseMatrix, P: SparseMatrix, transpose_left: bool, out_format
) -> PtAPPlan:
    """Shared symbolic core of PtAP / RARt.

    PtAP: B_ij = sum_{(k,l) in A} P_ki A_kl P_lj  — contract over P *rows*
    indexed by A's row and column (P as (n_fine, n_coarse)).
    RARt: B_ij = sum_{(k,l) in A} R_ik A_kl R_jl — contract over R rows too,
    but the roles of R's row/col swap: R is (n_coarse, n_fine), and we need
    for each fine k the set {(i, pos)} of coarse rows hitting k — i.e. R's
    *columns*.  Normalizing both to 'for inner index t, list (outer, pos)':
    PtAP uses host-CSR of P over rows; RARt uses host-CSR of R over columns.
    """
    ar, ac, apos = _coo_of(A)
    pr, pc, ppos = _coo_of(P)
    if transpose_left:
        # map: fine row k -> [(coarse col i, pos)]
        inner, outer = pr, pc
        n_out = P.shape[1]
        inner_dim = P.shape[0]
    else:
        # map: fine col k -> [(coarse row i, pos)]
        inner, outer = pc, pr
        n_out = P.shape[0]
        inner_dim = P.shape[1]
    ptr, outs, poss = _csr_arrays(inner, outer, ppos, inner_dim)

    # First expansion: A entries (k, l) x slices at k.
    c1 = (ptr[ar + 1] - ptr[ar]).astype(np.int64)
    t1 = int(c1.sum())
    e1 = np.repeat(ptr[ar] + c1 - np.cumsum(c1), c1) + np.arange(t1, dtype=np.int64)
    rows1 = outs[e1]  # B row index i
    left1 = poss[e1]  # position of P_ki (or R_ik)
    a1 = np.repeat(apos, c1)
    l1 = np.repeat(ac, c1)  # carries A's column l forward

    # Second expansion: x slices at l.
    c2 = (ptr[l1 + 1] - ptr[l1]).astype(np.int64)
    t2 = int(c2.sum())
    e2 = np.repeat(ptr[l1] + c2 - np.cumsum(c2), c2) + np.arange(t2, dtype=np.int64)
    out_rows = np.repeat(rows1, c2)
    out_cols = outs[e2]
    left = np.repeat(left1, c2)
    right = poss[e2]
    a_contrib = np.repeat(a1, c2)

    ukeys = np.unique(out_rows * n_out + out_cols)
    urows, ucols = ukeys // n_out, ukeys % n_out
    cls = _result_type(A, out_format)
    template = _freeze(cls, n_out, n_out, urows, ucols, A)
    seg = template.graph.edge_positions(out_rows, out_cols)
    return PtAPPlan(
        template=template,
        left_pos=_pos_array(left),
        a_pos=_pos_array(a_contrib),
        right_pos=_pos_array(right),
        seg=jnp.asarray(seg),
    )
