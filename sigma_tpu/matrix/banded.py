"""Banded-DIA conversion: a structural recipe for general sparsity.

Gather-based SpMV (CSR/ELL) reads an index per nonzero and gathers x;
the DIA window apply reads neither.  So for general sparsity one move is
*structural*: bandwidth-reduce with the BFS (Cuthill-McKee-style) ordering
(``permutations.f90:22``'s stated purpose) and store ALL diagonals of the
band in DIA, which pays off when the band occupancy is high enough that
streaming the band's zeros costs less than the gather (which format wins
on the GPU is an open question, ROADMAP 1.3).

This is classic banded-matrix computing (LAPACK's GB format), composed
entirely from existing pieces: reorder -> re-freeze.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from sigma_tpu.graph.permutations import breadth_first_search
from sigma_tpu.matrix.base import SparseMatrix
from sigma_tpu.matrix.formats import DIAMatrix

__all__ = [
    "to_banded_dia",
    "to_pruned_dia",
    "reorder_triples_rcm",
    "bandwidth",
    "band_occupancy",
]


def bandwidth(A) -> int:
    """max |i - j| over stored entries."""
    rows, cols = A.graph.edges_numpy() if hasattr(A, "graph") else A.edges_numpy()
    return int(np.abs(rows - cols).max()) if rows.size else 0


def band_occupancy(A: SparseMatrix) -> float:
    """true (nonzero) entries / (n * number of distinct diagonals) — the
    DIA fill ratio this matrix has or would have."""
    rows, cols, vals = A.entries()
    n_diag = np.unique(cols - rows).size
    true_nnz = int(np.count_nonzero(vals))
    return true_nnz / (A.shape[0] * max(n_diag, 1))


def _keep_better_order(rows, cols, vals, p):
    """THE keep-better-order rule (one implementation for both the
    SparseMatrix and raw-triples pipelines, per the contract below):
    compare the input vs reordered order lexicographically on
    (distinct-diagonal count, band reach), ties to the reordering;
    return ``(rows, cols, vals, p)`` with ``p`` the identity when the
    input order wins."""
    d_new = (p[cols] - p[rows]).astype(np.int32)
    d_in = (cols - rows).astype(np.int32)
    key_new = (_n_distinct(d_new), int(np.abs(d_new).max(initial=0)))
    key_in = (_n_distinct(d_in), int(np.abs(d_in).max(initial=0)))
    if key_new <= key_in:
        return p[rows], p[cols], vals, p
    return rows, cols, vals, np.arange(p.size, dtype=p.dtype)


def _reordered_triples(A: SparseMatrix, reorder: bool, method: str):
    """Shared reorder + keep-better-order rule for the banded/pruned
    conversions: returns ``(rows, cols, vals, p)`` with ``p`` in scatter
    form (identity when the input order is kept, None when
    ``reorder=False``).  The rule is a measured contract — better of
    INPUT vs reordered order, judged lexicographically on
    (distinct-diagonal count, band reach), ties to the reordering — and
    lives in exactly one place so the two pipelines can never diverge."""
    if A.shape[0] != A.shape[1]:
        raise ValueError("banded conversion expects a square matrix")
    rows, cols, vals = A.entries()
    p = None
    if reorder:
        if method == "rcm":
            from sigma_tpu.graph.permutations import reverse_cuthill_mckee

            p = reverse_cuthill_mckee(A.graph)
        elif method == "bfs":
            p = breadth_first_search(A.graph)
        else:
            raise ValueError(f"unknown reorder method {method!r}")
        rows, cols, vals, p = _keep_better_order(rows, cols, vals, p)
    return rows, cols, vals, p


def reorder_triples_rcm(n, rows, cols, vals, method: str = "rcm"):
    """Host-only RCM reordering of duplicate-free COO triples:
    ``(pr, pc, vals, p)`` with the same keep-better-order contract as
    :func:`to_banded_dia` (``p`` in scatter form, identity when the
    input order is kept).

    This is the no-device-bounce setup path for the pruned pipeline:
    the :class:`SparseMatrix` route stores graph arrays on the device,
    so ``_reordered_triples`` pays a device round-trip per ``entries()``
    and the RCM wrapper another for indptr/indices.  Here the adjacency is
    built with the C++ counting sort (``native.csr_from_coo``, numpy
    fallback) and RCM runs on it directly; nothing touches a device.
    The pruned pack does its own (tile, offset) radix sort, so the
    returned triples are NOT re-sorted.
    """
    from sigma_tpu import native

    rows = np.asarray(rows, dtype=np.int64).ravel()
    cols = np.asarray(cols, dtype=np.int64).ravel()
    vals = np.asarray(vals).ravel()
    n = int(n)
    # bounds check BEFORE the C++ counting sort: adjacency_from_coo
    # scatters through indptr[rows[e]+1] with no guard, so an
    # out-of-range index would corrupt the heap rather than raise
    # (the numpy fallback fails loudly — behavior must not diverge by
    # build)
    if rows.size:
        lo = min(int(rows.min()), int(cols.min()))
        hi = max(int(rows.max()), int(cols.max()))
        if lo < 0 or hi >= n:
            raise ValueError(
                f"COO index out of range for n={n}: min {lo}, max {hi}"
            )
    # adjacency only (counting sort by row, no dedup/column sort): the
    # orderings' quality is within-row-order independent, so the radix
    # CSR build's extra passes are wasted here.  Triples MUST be
    # duplicate-free (this function's contract).
    adj = native.adjacency_from_coo(n, rows, cols)
    if adj is not None:
        cs_, indptr = adj
    else:
        order = np.argsort(rows, kind="stable")
        cs_ = cols[order]
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    if method == "rcm":
        p = native.rcm_order(indptr, cs_)
        if p is None:
            from sigma_tpu.graph.graph import CSRGraph
            from sigma_tpu.graph.permutations import reverse_cuthill_mckee

            p = reverse_cuthill_mckee(CSRGraph.from_csr(n, n, indptr, cs_))
    elif method == "bfs":
        p = native.bfs_order(indptr, cs_)
        if p is None:
            from sigma_tpu.graph.graph import CSRGraph

            p = breadth_first_search(CSRGraph.from_csr(n, n, indptr, cs_))
    else:
        raise ValueError(f"unknown reorder method {method!r}")
    p = np.asarray(p, dtype=np.int64)
    return _keep_better_order(rows, cols, vals, p)


def _n_distinct(d: np.ndarray) -> int:
    """Distinct-count of int32 offsets: bincount over the value range
    when it is small (post-RCM bands: a few hundred — microseconds),
    sort-based ``np.unique`` only for genuinely wide ranges (the
    shuffled input order) — each avoided 70M-element sort is ~5 s on
    this page-fault-bound host."""
    if d.size == 0:
        return 0
    lo, hi = int(d.min()), int(d.max())
    if hi - lo < 1 << 22:
        return int(np.count_nonzero(np.bincount(d - lo, minlength=hi - lo + 1)))
    return int(np.unique(d).size)


def to_banded_dia(
    A: SparseMatrix, reorder: bool = True, method: str = "rcm"
) -> Tuple[DIAMatrix, Optional[np.ndarray]]:
    """Convert a (square) sparse matrix to DIA, optionally after a
    bandwidth-reducing reordering of rows and columns (``method``:
    ``"rcm"`` reverse Cuthill-McKee, the default; ``"bfs"`` the plain
    BFS level order the reference provides).

    Returns ``(D, p)`` with ``p`` in scatter form (``None`` when
    ``reorder=False``): ``D[p[i], p[j]] == A[i, j]``.  To solve A x = b in
    the permuted frame: ``b_p[p] = b``, solve ``D x_p = b_p``, then
    ``x = x_p[p]``.

    When reordering, the better of the INPUT and the reordered order is
    kept, judged lexicographically on (distinct-diagonal count, band
    reach): DIA memory and SpMV time are ∝ the diagonal count, and the
    kernels' halo fit is ∝ the reach — RCM can worsen an already-banded
    natural order (measured on the natural-order mesh generator), while
    an input order that merely TIES on diagonal count but spreads them
    over a huge reach would defeat the narrow band the reordering
    exists to provide.  Ties go to the reordering.  ``p`` is the
    identity permutation when the input order is kept, so callers never
    branch.
    """
    rows, cols, vals, p = _reordered_triples(A, reorder, method)
    D = DIAMatrix.from_coo(
        A.shape[0], A.shape[1], rows, cols, vals, dtype=A.dtype
    )
    return D, p


def to_pruned_dia(
    A: SparseMatrix,
    reorder: bool = True,
    method: str = "rcm",
    tile_rows: int = 16384,
    group: int | None = None,
    symmetric: bool = False,
    validate: bool = True,
    rtol: float = 1e-12,
):
    """RCM-reorder and pack directly into the PRUNED block-DIA layout
    (:class:`sigma_tpu.matrix.pruned.PrunedDIAMatrix`) — the full DIA
    band is never materialized, so memory is the packed size (e.g. a
    10M-row RCM band that would store 10+ GB in full DIA packs into
    ~1-2 GB).  Same return/permutation contract as :func:`to_banded_dia`;
    same order-keeping rule (better of input vs reordered order, judged
    on (diagonal count, reach)).

    The pruned layout streams only the active (row-tile x diagonal)
    blocks instead of the whole band.

    ``symmetric=True`` packs only the upper triangle into a
    :class:`~sigma_tpu.matrix.pruned.SymmetricPrunedDIAMatrix` — half
    the value stream (the symmetry of the VALUES is
    validated; the permutation is symmetric so reordering preserves
    symmetry).  Use for matvec-dominated SPD solves; keep full storage
    for multi-RHS block solvers (see the class docstring's routing
    note).
    """
    from sigma_tpu.matrix.pruned import (
        PrunedDIAMatrix,
        SymmetricPrunedDIAMatrix,
    )

    rows, cols, vals, p = _reordered_triples(A, reorder, method)
    if symmetric:
        # validate/rtol forwarded: the check is an O(nnz log nnz) host
        # sort — skippable for known-SPD assemblies at the 10M scale
        P = SymmetricPrunedDIAMatrix.from_coo(
            A.shape[0], A.shape[1], rows, cols, vals, dtype=A.dtype,
            tile_rows=tile_rows, group=group, assume_unique=True,
            validate=validate, rtol=rtol,
        )
    else:
        P = PrunedDIAMatrix.from_coo(
            A.shape[0], A.shape[1], rows, cols, vals, dtype=A.dtype,
            tile_rows=tile_rows, group=group, assume_unique=True,
        )
    return P, p
