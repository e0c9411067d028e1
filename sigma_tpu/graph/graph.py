"""Frozen, static-shape graph (sparsity topology) formats.

SiGMA's central premise is that the connectivity of a sparse matrix is a
first-class *graph* object and a matrix is "a graph + an array of values"
(``/root/reference/README.md:6-7``, ``src/graph/graph_interfaces.f90``).  We
keep that premise but replace the reference's mutable OOP formats + batch-64
edge-cursor protocol (``graph_interfaces.f90:138-144,267``) with **immutable
pytrees of static-shape arrays** — the thing XLA can actually compile —
plus whole-array vectorized exports instead of cursors.

Format lineage (reference file → this module):

* ``cs_graphs.f90``       → :class:`CSRGraph` / :class:`CSCGraph`
  (compressed sparse; two-pass counting-sort build happens in numpy)
* ``ellpack_graphs.f90``  → :class:`ELLGraph`
  (dense ``(n, max_d)`` index array; rows padded with *duplicates of real
  neighbors* exactly like ``ellpack_graphs.f90:393-400`` so gathers never
  read garbage; padded matrix values are zero so arithmetic is unaffected)
* ``coo_graphs.f90``      → :class:`COOGraph`
* (absent in reference; README.md:84 "There is as yet no block matrix
  format") → :class:`BSRGraph`, block compressed rows for block-sparse
  matmul kernels.

Mutation (``add_edge``/``delete_edge``) is *not* on the frozen types: in the
reference every compressed-format mutation is already a full rebuild
(``cs_graphs.f90:400-494``); here rebuild goes through
:class:`~sigma_tpu.graph.builder.GraphBuilder` explicitly.

Permutation convention: ``permute_rows(p)`` relabels row ``i`` as ``p[i]``
(scatter convention), matching the reference's ``left_permute``; the
resulting dense mirror satisfies ``new[p[i], j] == old[i, j]``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import ClassVar, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sigma_tpu.utils.dtypes import index_dtype, np_index, round_up

__all__ = [
    "Graph",
    "CSRGraph",
    "CSCGraph",
    "COOGraph",
    "ELLGraph",
    "BSRGraph",
    "compress_coo",
]

# Padding granularity for flat nonzero arrays (keeps lane-dim friendly sizes).
NNZ_PAD = 8


def compress_coo(
    rows, cols, n: int, m: int, dedup: bool = True
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sort COO row-major and optionally deduplicate.

    Returns (rows, cols, indptr) with indptr the CSR row pointer.  This is
    the numpy equivalent of the reference's two-pass counting-sort build
    (``cs_graphs.f90:109-197``).
    """
    rows = np.asarray(rows, dtype=np.int64).ravel()
    cols = np.asarray(cols, dtype=np.int64).ravel()
    # range validation (review fix): the linearized key rows*m + cols
    # would silently ALIAS an out-of-range column into the next row —
    # an off-by-one assembly bug became a numerically wrong matrix with
    # no error
    if rows.size:
        if int(rows.min()) < 0 or int(rows.max()) >= n:
            raise ValueError(
                f"row index out of range [0, {n}): "
                f"[{int(rows.min())}, {int(rows.max())}]"
            )
        if int(cols.min()) < 0 or int(cols.max()) >= m:
            raise ValueError(
                f"column index out of range [0, {m}): "
                f"[{int(cols.min())}, {int(cols.max())}]"
            )
    # note: the native radix sort (native.csr_from_coo) loses to numpy's
    # SIMD introsort on this machine class, so the hot freeze path stays
    # numpy; the native core earns its keep on the *sequential* algorithms
    # (BFS, coloring, level scheduling) where python/numpy cannot vectorize.
    keys = rows * m + cols
    if dedup:
        keys = np.unique(keys)
    else:
        keys = np.sort(keys)
    rows, cols = keys // m, keys % m
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return rows, cols, indptr


def host_csr(rows, cols, n: int, *carry):
    """Row-major host CSR view of a COO edge set: (indptr, sorted cols,
    *carry arrays re-ordered the same way).  THE single implementation of
    the lexsort+bincount+cumsum idiom — reordering, algebra, and
    factorization setup all call this."""
    rows = np.asarray(rows, dtype=np.int64).ravel()
    cols = np.asarray(cols, dtype=np.int64).ravel()
    order = np.lexsort((cols, rows))
    rows_s = rows[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows_s, minlength=n), out=indptr[1:])
    return (indptr, cols[order]) + tuple(
        np.asarray(c).ravel()[order] for c in carry
    )


def _pad1d(arr: np.ndarray, total: int, fill) -> np.ndarray:
    # np.empty + two region writes, NOT np.full + overwrite: every
    # extra full-array touch of a fresh buffer costs a page-fault pass
    out = np.empty(total, dtype=arr.dtype)
    out[: arr.size] = arr
    out[arr.size :] = fill
    return out


class Graph:
    """Common interface over frozen topology formats.

    Mirrors the query surface of ``graph_interfaces.f90:21-133`` minus
    mutation; all bulk operations are whole-array, not cursor batches.
    """

    # concrete classes define: shape (static), nnz (static), edges_numpy()
    shape: Tuple[int, int]
    nnz: int
    format: ClassVar[str] = "abstract"

    # -- static/meta queries ------------------------------------------------
    @property
    def num_edges(self) -> int:  # get_num_edges (graph_interfaces.f90)
        return self.nnz

    def edges_numpy(self) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def degrees_numpy(self) -> np.ndarray:
        rows, _ = self.edges_numpy()
        return np.bincount(rows, minlength=self.shape[0])

    @property
    def max_degree(self) -> int:  # get_max_degree
        d = self.degrees_numpy()
        return int(d.max()) if d.size else 0

    def degree(self, i: int) -> int:  # get_degree
        return int(self.degrees_numpy()[i])

    def neighbors(self, i: int) -> np.ndarray:  # get_neighbors
        rows, cols = self.edges_numpy()
        return cols[rows == i]

    def has_edge(self, i: int, j: int) -> bool:  # connected
        return bool(self.edge_positions([i], [j])[0] >= 0)

    def edge_positions(self, rows, cols) -> np.ndarray:
        """Positions of edges (i, j) in this format's value array; -1 if
        absent.  Replaces the reference's ``find_edge`` + per-entry value
        mutators with one vectorized lookup (host-side)."""
        raise NotImplementedError

    def to_dense(self) -> np.ndarray:  # to_dense_graph (graph_interfaces.f90:368)
        rows, cols = self.edges_numpy()
        d = np.zeros(self.shape, dtype=np.int64)
        d[rows, cols] = 1
        return d

    # -- structural transforms ---------------------------------------------
    def transpose(self) -> "Graph":
        rows, cols = self.edges_numpy()
        return type(self).from_coo(self.shape[1], self.shape[0], cols, rows)

    def permute_rows(self, p) -> "Graph":  # left_permute
        p = np.asarray(p)
        rows, cols = self.edges_numpy()
        return type(self).from_coo(self.shape[0], self.shape[1], p[rows], cols)

    def permute_cols(self, p) -> "Graph":  # right_permute
        p = np.asarray(p)
        rows, cols = self.edges_numpy()
        return type(self).from_coo(self.shape[0], self.shape[1], rows, p[cols])

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_coo(cls, n: int, m: Optional[int], rows, cols) -> "Graph":
        raise NotImplementedError

    @classmethod
    def from_builder(cls, b) -> "Graph":
        rows, cols = b.edges()
        return cls.from_coo(b.n, b.m, rows, cols)

    @classmethod
    def from_dense(cls, dense) -> "Graph":
        dense = np.asarray(dense)
        rows, cols = np.nonzero(dense)
        return cls.from_coo(dense.shape[0], dense.shape[1], rows, cols)

    def __repr__(self) -> str:
        return f"{type(self).__name__}(shape={self.shape}, nnz={self.nnz})"


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, repr=False)
class CSRGraph(Graph):
    """Compressed sparse row topology (``cs_graphs.f90`` row orientation).

    ``indices`` is padded to a multiple of ``NNZ_PAD``; padded slots carry
    column 0 and ``row_ids`` sentinel ``n`` (dropped by segment reductions).
    ``row_ids`` (the COO expansion of ``indptr``) is precomputed because the
    XLA-native SpMV is a gather + ``segment_sum`` over it.
    """

    indptr: jax.Array  # (n+1,) int32
    indices: jax.Array  # (nnz_pad,) int32, sorted within rows
    row_ids: jax.Array  # (nnz_pad,) int32, pad = n
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))

    format: ClassVar[str] = "csr"

    @classmethod
    def from_coo(cls, n, m, rows, cols) -> "CSRGraph":
        n, m = int(n), int(m if m is not None else n)
        rows, cols, indptr = compress_coo(rows, cols, n, m)
        nnz = rows.size
        pad = round_up(max(nnz, 1), NNZ_PAD)
        return cls(
            indptr=jnp.asarray(indptr, dtype=index_dtype),
            indices=jnp.asarray(_pad1d(np_index(cols), pad, 0), dtype=index_dtype),
            row_ids=jnp.asarray(_pad1d(np_index(rows), pad, n), dtype=index_dtype),
            shape=(n, m),
            nnz=int(nnz),
        )

    @classmethod
    def from_sorted_coo(cls, n, m, rows, cols) -> "CSRGraph":
        """Trusted constructor from row-major-sorted, deduplicated COO
        edges: skips the ``compress_coo`` re-sort (a full ``np.unique``
        pass — measured seconds at the 1M-row AMG setup).  Callers that
        just deduplicated with ``np.unique(rows*m + cols)`` are already in
        this form.

        TRUSTED means unvalidated: ``indptr`` is built from bincount
        (order-insensitive) while ``indices``/``row_ids`` keep the given
        order, so edges that are NOT row-major sorted produce a silently
        inconsistent graph (indptr claims a sorted layout the arrays don't
        have).  Set ``SIGMA_TPU_DEBUG=1`` to assert the contract."""
        n, m = int(n), int(m)
        rows = np.asarray(rows, dtype=np.int64).ravel()
        cols = np.asarray(cols, dtype=np.int64).ravel()
        if os.environ.get("SIGMA_TPU_DEBUG", "") not in ("", "0", "false", "False"):
            if rows.size and not (np.diff(rows) >= 0).all():
                raise ValueError(
                    "from_sorted_coo: rows are not sorted (contract "
                    "violation would silently corrupt the graph); use "
                    "from_coo for unsorted edges"
                )
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
        nnz = rows.size
        pad = round_up(max(nnz, 1), NNZ_PAD)
        return cls(
            indptr=jnp.asarray(indptr, dtype=index_dtype),
            indices=jnp.asarray(_pad1d(np_index(cols), pad, 0), dtype=index_dtype),
            row_ids=jnp.asarray(_pad1d(np_index(rows), pad, n), dtype=index_dtype),
            shape=(n, m),
            nnz=int(nnz),
        )

    @classmethod
    def from_csr(cls, n, m, indptr, indices) -> "CSRGraph":
        """Trusted constructor from host CSR arrays: rows already sorted and
        deduplicated (no validation, no re-sort).  The freeze path for
        results of the compiled host algebra (``native.spgemm`` etc.), which
        emits this form directly."""
        n, m = int(n), int(m)
        indptr = np.asarray(indptr, dtype=np.int64)
        indices = np.asarray(indices, dtype=np.int64).ravel()
        nnz = indices.size
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        pad = round_up(max(nnz, 1), NNZ_PAD)
        return cls(
            indptr=jnp.asarray(indptr, dtype=index_dtype),
            indices=jnp.asarray(_pad1d(np_index(indices), pad, 0), dtype=index_dtype),
            row_ids=jnp.asarray(_pad1d(np_index(rows), pad, n), dtype=index_dtype),
            shape=(n, m),
            nnz=int(nnz),
        )

    def edges_numpy(self):
        return (
            np.asarray(self.row_ids)[: self.nnz].astype(np.int64),
            np.asarray(self.indices)[: self.nnz].astype(np.int64),
        )

    def degrees_numpy(self) -> np.ndarray:
        ptr = np.asarray(self.indptr)
        return ptr[1:] - ptr[:-1]

    def neighbors(self, i: int) -> np.ndarray:
        ptr = np.asarray(self.indptr)
        return np.asarray(self.indices)[ptr[i] : ptr[i + 1]].astype(np.int64)

    def has_edge(self, i: int, j: int) -> bool:
        # O(deg) row slice instead of the base path's full-device
        # readback + O(nnz) key build per query (review fix)
        return bool(np.isin(j, self.neighbors(i)).item())

    def edge_positions(self, rows, cols) -> np.ndarray:
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        in_range = (
            (rows >= 0) & (rows < self.shape[0])
            & (cols >= 0) & (cols < self.shape[1])
        )
        r, c = self.edges_numpy()
        if r.size == 0:
            return np.full(rows.shape, -1, dtype=np.int64)
        keys = r * self.shape[1] + c  # sorted ascending by construction
        # out-of-range queries must not alias another entry through the
        # linearized key r*m + c
        q = np.where(in_range, rows * self.shape[1] + cols, -1)
        pos = np.searchsorted(keys, q)
        pos_c = np.clip(pos, 0, keys.size - 1)
        hit = in_range & (keys[pos_c] == q)
        return np.where(hit, pos_c, -1)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, repr=False)
class CSCGraph(Graph):
    """Compressed sparse column topology (``cs_graphs.f90`` column
    orientation).  Stored as the CSR compression of the transpose: values
    attached to this graph are ordered column-major, so a CSC matvec is the
    transpose-matvec of the stored arrays — the same kernel duality the
    reference exploits (``cs_matrices.f90:148-149,192-193``)."""

    indptr: jax.Array  # (m+1,) int32, per-column
    indices: jax.Array  # (nnz_pad,) int32 row indices, sorted within columns
    col_ids: jax.Array  # (nnz_pad,) int32, pad = m
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))

    format: ClassVar[str] = "csc"

    @classmethod
    def from_coo(cls, n, m, rows, cols) -> "CSCGraph":
        n, m = int(n), int(m if m is not None else n)
        # compress by column: sort (col, row)
        cols2, rows2, indptr = compress_coo(cols, rows, m, n)
        nnz = rows2.size
        pad = round_up(max(nnz, 1), NNZ_PAD)
        return cls(
            indptr=jnp.asarray(indptr, dtype=index_dtype),
            indices=jnp.asarray(_pad1d(np_index(rows2), pad, 0), dtype=index_dtype),
            col_ids=jnp.asarray(_pad1d(np_index(cols2), pad, m), dtype=index_dtype),
            shape=(n, m),
            nnz=int(nnz),
        )

    def edges_numpy(self):
        return (
            np.asarray(self.indices)[: self.nnz].astype(np.int64),
            np.asarray(self.col_ids)[: self.nnz].astype(np.int64),
        )

    def edge_positions(self, rows, cols) -> np.ndarray:
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        in_range = (
            (rows >= 0) & (rows < self.shape[0])
            & (cols >= 0) & (cols < self.shape[1])
        )
        r, c = self.edges_numpy()
        if r.size == 0:
            return np.full(rows.shape, -1, dtype=np.int64)
        keys = c * self.shape[0] + r  # column-major sorted
        q = np.where(in_range, cols * self.shape[0] + rows, -1)
        pos = np.searchsorted(keys, q)
        pos_c = np.clip(pos, 0, keys.size - 1)
        hit = in_range & (keys[pos_c] == q)
        return np.where(hit, pos_c, -1)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, repr=False)
class COOGraph(Graph):
    """Coordinate topology (``coo_graphs.f90``), sorted row-major and
    deduplicated at freeze time; padded slots carry the sentinel row ``n``."""

    rows: jax.Array  # (nnz_pad,) int32, pad = n
    cols: jax.Array  # (nnz_pad,) int32, pad = 0
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))

    format: ClassVar[str] = "coo"

    @classmethod
    def from_coo(cls, n, m, rows, cols) -> "COOGraph":
        n, m = int(n), int(m if m is not None else n)
        rows, cols, _ = compress_coo(rows, cols, n, m)
        nnz = rows.size
        pad = round_up(max(nnz, 1), NNZ_PAD)
        return cls(
            rows=jnp.asarray(_pad1d(np_index(rows), pad, n), dtype=index_dtype),
            cols=jnp.asarray(_pad1d(np_index(cols), pad, 0), dtype=index_dtype),
            shape=(n, m),
            nnz=int(nnz),
        )

    def edges_numpy(self):
        return (
            np.asarray(self.rows)[: self.nnz].astype(np.int64),
            np.asarray(self.cols)[: self.nnz].astype(np.int64),
        )

    def edge_positions(self, rows, cols) -> np.ndarray:
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        in_range = (
            (rows >= 0) & (rows < self.shape[0])
            & (cols >= 0) & (cols < self.shape[1])
        )
        r, c = self.edges_numpy()
        if r.size == 0:
            return np.full(rows.shape, -1, dtype=np.int64)
        keys = r * self.shape[1] + c
        q = np.where(in_range, rows * self.shape[1] + cols, -1)
        pos = np.searchsorted(keys, q)
        pos_c = np.clip(pos, 0, keys.size - 1)
        hit = in_range & (keys[pos_c] == q)
        return np.where(hit, pos_c, -1)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, repr=False)
class ELLGraph(Graph):
    """ELLPACK topology: dense ``(n, max_d)`` neighbor array.

    The closest reference format to a device layout ("especially suited to SIMD
    architectures", ``README.md:71-73``; ``ellpack_graphs.f90``).  Row ``i``'s
    slots beyond ``degrees[i]`` duplicate its *first* real neighbor (or 0 for
    empty rows) so gathers are branch-free, exactly the padding rule of
    ``ellpack_graphs.f90:393-400``; matrices store value 0 there.
    """

    cols: jax.Array  # (n, width) int32
    degrees: jax.Array  # (n,) int32
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))

    format: ClassVar[str] = "ell"

    @property
    def width(self) -> int:
        return self.cols.shape[1]

    @classmethod
    def from_coo(cls, n, m, rows, cols, min_width: int = 1) -> "ELLGraph":
        n, m = int(n), int(m if m is not None else n)
        rows, cols, indptr = compress_coo(rows, cols, n, m)
        nnz = rows.size
        deg = (indptr[1:] - indptr[:-1]).astype(np.int64)
        width = max(int(deg.max()) if n else 0, min_width)
        node = np.zeros((n, width), dtype=np.int64)
        if nnz:
            slot = np.arange(nnz) - indptr[rows]  # position within row
            node[rows, slot] = cols
            # duplicate-padding: copy each row's first neighbor into empty slots
            first = np.zeros(n, dtype=np.int64)
            first[deg > 0] = node[deg > 0, 0]
            pad_mask = np.arange(width)[None, :] >= deg[:, None]
            node = np.where(pad_mask, first[:, None], node)
        return cls(
            cols=jnp.asarray(node, dtype=index_dtype),
            degrees=jnp.asarray(deg, dtype=index_dtype),
            shape=(n, m),
            nnz=int(nnz),
        )

    def degrees_numpy(self) -> np.ndarray:
        return np.asarray(self.degrees).astype(np.int64)

    def edges_numpy(self):
        node = np.asarray(self.cols).astype(np.int64)
        deg = self.degrees_numpy()
        mask = np.arange(self.width)[None, :] < deg[:, None]
        rows = np.broadcast_to(np.arange(self.shape[0])[:, None], node.shape)
        return rows[mask], node[mask]

    def neighbors(self, i: int) -> np.ndarray:
        node = np.asarray(self.cols)
        return node[i, : int(self.degrees_numpy()[i])].astype(np.int64)

    def edge_positions(self, rows, cols) -> np.ndarray:
        """Flat positions into the (n, width) value array (= i*width + slot).

        Vectorized: broadcast-compare each queried row's slots against the
        wanted column (O(q*width) numpy, no per-edge python loop — assembly
        paths call this with q = nnz batches)."""
        rows = np.asarray(rows, dtype=np.int64).ravel()
        cols = np.asarray(cols, dtype=np.int64).ravel()
        node = np.asarray(self.cols).astype(np.int64)
        deg = self.degrees_numpy()
        rows_c = np.clip(rows, 0, self.shape[0] - 1)
        slots = node[rows_c]  # (q, width)
        valid = np.arange(self.width)[None, :] < deg[rows_c][:, None]
        hit = (slots == cols[:, None]) & valid
        any_hit = hit.any(axis=1) & (rows >= 0) & (rows < self.shape[0])
        first = hit.argmax(axis=1)
        return np.where(any_hit, rows_c * self.width + first, -1)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, repr=False)
class BSRGraph(Graph):
    """Block compressed sparse row topology — the block format the reference
    names as missing (``README.md:84``).  Element edges are grouped into
    dense ``(bh, bw)`` blocks (block-CSR over block rows); ``mask`` records
    which slots are true edges so element-level graph semantics (degree,
    neighbors, exact sparsity) survive blocking.  Matrices built on this
    store explicit zeros at masked-off slots, making SpMV/SpMM dense
    block-matmuls."""

    indptr: jax.Array  # (nb_rows+1,) int32 over block rows
    indices: jax.Array  # (nnzb_pad,) int32 block-column indices
    block_rows: jax.Array  # (nnzb_pad,) int32 block-row ids, pad = nb_rows
    mask: jax.Array  # (nnzb_pad, bh, bw) bool, true-edge slots
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    block_shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))
    nnzb: int = dataclasses.field(metadata=dict(static=True))

    format: ClassVar[str] = "bsr"

    @property
    def nb_rows(self) -> int:
        return -(-self.shape[0] // self.block_shape[0])

    @property
    def nb_cols(self) -> int:
        return -(-self.shape[1] // self.block_shape[1])

    @classmethod
    def from_coo(cls, n, m, rows, cols, block_shape: Tuple[int, int] = (8, 8)) -> "BSRGraph":
        n, m = int(n), int(m if m is not None else n)
        bh, bw = map(int, block_shape)
        rows, cols, _ = compress_coo(rows, cols, n, m)
        nnz = rows.size
        nbr, nbc = -(-n // bh), -(-m // bw)
        bi, bj = rows // bh, cols // bw
        bkeys_all = bi * nbc + bj
        bkeys = np.unique(bkeys_all)
        nnzb = bkeys.size
        pad = round_up(max(nnzb, 1), NNZ_PAD)
        brows, bcols = bkeys // nbc, bkeys % nbc
        indptr = np.zeros(nbr + 1, dtype=np.int64)
        np.cumsum(np.bincount(brows, minlength=nbr), out=indptr[1:])
        mask = np.zeros((pad, bh, bw), dtype=bool)
        slot = np.searchsorted(bkeys, bkeys_all)
        mask[slot, rows % bh, cols % bw] = True
        return cls(
            indptr=jnp.asarray(indptr, dtype=index_dtype),
            indices=jnp.asarray(_pad1d(np_index(bcols), pad, 0), dtype=index_dtype),
            block_rows=jnp.asarray(_pad1d(np_index(brows), pad, nbr), dtype=index_dtype),
            mask=jnp.asarray(mask),
            shape=(n, m),
            block_shape=(bh, bw),
            nnz=int(nnz),
            nnzb=int(nnzb),
        )

    def edges_numpy(self):
        mask = np.asarray(self.mask)[: self.nnzb]
        brows = np.asarray(self.block_rows)[: self.nnzb].astype(np.int64)
        bcols = np.asarray(self.indices)[: self.nnzb].astype(np.int64)
        b, oi, oj = np.nonzero(mask)
        rows = brows[b] * self.block_shape[0] + oi
        cols = bcols[b] * self.block_shape[1] + oj
        order = np.lexsort((cols, rows))
        return rows[order], cols[order]

    def transpose(self) -> "BSRGraph":
        rows, cols = self.edges_numpy()
        return BSRGraph.from_coo(
            self.shape[1], self.shape[0], cols, rows,
            block_shape=(self.block_shape[1], self.block_shape[0]),
        )

    def permute_rows(self, p) -> "BSRGraph":
        p = np.asarray(p)
        rows, cols = self.edges_numpy()
        return BSRGraph.from_coo(
            self.shape[0], self.shape[1], p[rows], cols, block_shape=self.block_shape
        )

    def permute_cols(self, p) -> "BSRGraph":
        p = np.asarray(p)
        rows, cols = self.edges_numpy()
        return BSRGraph.from_coo(
            self.shape[0], self.shape[1], rows, p[cols], block_shape=self.block_shape
        )

    def edge_positions(self, rows, cols) -> np.ndarray:
        """Flat positions into the (nnzb_pad, bh, bw) value array."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        in_range = (
            (rows >= 0) & (rows < self.shape[0])
            & (cols >= 0) & (cols < self.shape[1])
        )
        bh, bw = self.block_shape
        brows = np.asarray(self.block_rows)[: self.nnzb].astype(np.int64)
        bcols = np.asarray(self.indices)[: self.nnzb].astype(np.int64)
        if brows.size == 0:
            return np.full(rows.shape, -1, dtype=np.int64)
        bkeys = brows * self.nb_cols + bcols  # sorted by construction
        q = np.where(in_range, (rows // bh) * self.nb_cols + (cols // bw), -1)
        pos = np.searchsorted(bkeys, q)
        pos_c = np.clip(pos, 0, bkeys.size - 1)
        hit = in_range & (bkeys[pos_c] == q)
        flat = pos_c * (bh * bw) + (rows % bh) * bw + (cols % bw)
        # only slots that are true edges count as present
        mask = np.asarray(self.mask).reshape(-1)
        present = hit & mask[np.clip(flat, 0, mask.size - 1)]
        return np.where(present, flat, -1)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, repr=False)
class DIAGraph(Graph):
    """Diagonal (DIA) topology: the sparsity is a set of matrix diagonals.

    Purpose-built for accelerators: stencil operators (the reference's solver-test
    Laplacians, the 3-D north-star operator) have a handful of constant
    offsets, and a diagonal layout makes SpMV completely **gather-free** —
    each diagonal contributes ``val_d * x[i + offset_d]``, a statically
    shifted window, so the kernel is pure multiply-add over contiguous
    vectors (VPU speed-of-light) with zero index traffic.  No reference
    analogue (closest: the banded structures of
    ``test/solver_test_diffusion_1d.f90``); absent formats named in
    ``README.md:81-87`` motivated adding it.

    Entry (i, j) is present iff ``j - i`` is in ``offsets`` and in-range.
    Value layout: ``(n_diags, n)``; slot ``(d, i)`` holds A[i, i+offset_d],
    zero where i+offset_d is out of range.
    """

    offsets: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))

    format: ClassVar[str] = "dia"

    @property
    def n_diags(self) -> int:
        return len(self.offsets)

    @property
    def stride(self) -> int:
        """Row stride of the value layout: n rounded up to a whole number of
        128-element rows, so each diagonal is a clean (stride/128, 128)
        grid."""
        return -(-self.shape[0] // 128) * 128

    @classmethod
    def from_coo(cls, n, m, rows, cols) -> "DIAGraph":
        n, m = int(n), int(m if m is not None else n)
        rows = np.asarray(rows, dtype=np.int64).ravel()
        cols = np.asarray(cols, dtype=np.int64).ravel()
        offsets = tuple(int(o) for o in np.unique(cols - rows))
        nnz = sum(
            max(0, min(n, m - o) - max(0, -o)) for o in offsets
        )
        return cls(offsets=offsets, shape=(n, m), nnz=int(nnz))

    def _valid_range(self, o: int) -> Tuple[int, int]:
        n, m = self.shape
        return max(0, -o), min(n, m - o)

    def edges_numpy(self):
        rr, cc = [], []
        for o in self.offsets:
            lo, hi = self._valid_range(o)
            r = np.arange(lo, hi, dtype=np.int64)
            rr.append(r)
            cc.append(r + o)
        if not rr:
            return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
        rows = np.concatenate(rr)
        cols = np.concatenate(cc)
        order = np.lexsort((cols, rows))
        return rows[order], cols[order]

    def degrees_numpy(self) -> np.ndarray:
        deg = np.zeros(self.shape[0], dtype=np.int64)
        for o in self.offsets:
            lo, hi = self._valid_range(o)
            deg[lo:hi] += 1
        return deg

    def transpose(self) -> "DIAGraph":
        return DIAGraph(
            offsets=tuple(sorted(-o for o in self.offsets)),
            shape=(self.shape[1], self.shape[0]),
            nnz=self.nnz,
        )

    def edge_positions(self, rows, cols) -> np.ndarray:
        rows = np.asarray(rows, dtype=np.int64).ravel()
        cols = np.asarray(cols, dtype=np.int64).ravel()
        offs = np.asarray(self.offsets, dtype=np.int64)
        n, m = self.shape
        diff = cols - rows
        d = np.searchsorted(offs, diff)
        d_ok = (d < offs.size) & (offs[np.clip(d, 0, offs.size - 1)] == diff)
        in_range = (rows >= 0) & (rows < n) & (cols >= 0) & (cols < m)
        return np.where(d_ok & in_range, d * self.stride + rows, -1)
