"""Concrete sparse matrix formats with XLA-native compute kernels.

Reference lineage:

* ``cs_matrices.f90`` (CSR :112-151 / CSC :156-195; hot kernels
  ``csr_matvec_add:600-622`` row dot-accumulate, ``csc_matvec_add:627-647``
  column scatter; the CSR/CSC transpose-kernel duality at :148-149,192-193)
  → :class:`CSRMatrix` / :class:`CSCMatrix`
* ``ellpack_matrices.f90`` (fixed-trip-count matvec :640-665 — the
  reference's closest analogue of a device kernel) → :class:`ELLMatrix`
* ``coo`` value layout → :class:`COOMatrix`
* block format (absent in reference, README.md:84) → :class:`BSRMatrix`,
  dense (bh, bw) blocks whose SpMV/SpMM are batched small matmuls.

All kernels here are whole-array XLA programs (gather + multiply +
``segment_sum`` scatter, or shifted windows for DIA) — no cursors, no
per-edge control flow.

Padding is always value-0 at structurally padded slots, so no masking is
ever needed in arithmetic.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import jax
import jax.numpy as jnp
from jax import lax
import numpy as np

from sigma_tpu.graph.graph import (
    BSRGraph,
    DIAGraph,
    COOGraph,
    CSCGraph,
    CSRGraph,
    ELLGraph,
)
from sigma_tpu.matrix.base import SparseMatrix

__all__ = ["CSRMatrix", "CSCMatrix", "COOMatrix", "ELLMatrix", "BSRMatrix", "DIAMatrix"]


def _segment_sum(vals, ids, n):
    # ids out of range [0, n) are dropped — padding carries sentinel ids.
    return jax.ops.segment_sum(vals, ids, num_segments=n)


def zero_padded_window(x, o: int, length: int, total: int):
    """Zero-padded window x[o : o + length] padded to ``total`` — built by
    concatenation (not one shared padded buffer), so XLA can fuse the
    concats into the consuming FMA instead of materializing a padded copy
    of x.  Shared by the DIA applies and the distributed DIA layout."""
    m = x.shape[0]
    lo, hi = max(0, o), min(m, length + o)
    if hi <= lo:
        return jnp.zeros((total,) + x.shape[1:], dtype=x.dtype)
    parts = []
    left = lo - o
    right = total - (left + hi - lo)
    if left:
        parts.append(jnp.zeros((left,) + x.shape[1:], dtype=x.dtype))
    parts.append(x[lo:hi])
    if right:
        parts.append(jnp.zeros((right,) + x.shape[1:], dtype=x.dtype))
    return jnp.concatenate(parts) if len(parts) > 1 else parts[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, repr=False)
class CSRMatrix(SparseMatrix):
    """Row-compressed matrix.  matvec: gather x at column indices, multiply,
    segment-sum by row (the vectorized form of ``csr_matvec_add``)."""

    graph: CSRGraph
    data: jax.Array  # (nnz_pad,)

    format: ClassVar[str] = "csr"
    is_get_row_fast: ClassVar[bool] = True
    is_get_column_fast: ClassVar[bool] = False

    @classmethod
    def _graph_class(cls):
        return CSRGraph

    @classmethod
    def _data_shape(cls, graph):
        return graph.indices.shape

    @classmethod
    def from_csr_arrays(cls, n, m, indptr, cols, vals, dtype=None) -> "CSRMatrix":
        """Trusted constructor from host CSR arrays (rows sorted and
        deduplicated — no re-sort).  Pairs with the compiled host algebra
        (``native.spgemm``/``csr_add``/``csr_transpose``), whose outputs are
        already in this form."""
        g = CSRGraph.from_csr(n, m, indptr, cols)
        vals = np.asarray(vals).ravel()
        flat = np.zeros(g.indices.shape[0], dtype=vals.dtype)
        flat[: vals.size] = vals
        from sigma_tpu.utils.dtypes import default_real_dtype

        return cls(graph=g, data=jnp.asarray(flat, dtype=dtype or default_real_dtype()))

    def entries(self):
        # the stored layout IS row-major sorted COO: flat position p holds
        # edge (row_ids[p], indices[p]) — skip base's edge_positions lookup
        # (a full keys-build + searchsorted pass, ~45 s at 1M-row AMG setup)
        g = self.graph
        rows = np.asarray(g.row_ids)[: g.nnz].astype(np.int64)
        cols = np.asarray(g.indices)[: g.nnz].astype(np.int64)
        vals = np.asarray(self.data).reshape(-1)[: g.nnz]
        return rows, cols, vals

    def diagonal(self) -> jax.Array:
        # HOST-SIDE contract (like entries()): reads self.data via
        # np.asarray, so it forces a device->host readback and cannot be
        # called on a traced matrix under jax.jit — unlike
        # DIAMatrix.diagonal, which is pure jnp.  Chosen deliberately: the
        # AMG setup reads a diagonal per level on the host, and masking the
        # stored int32 index arrays in numpy beats base's edge_positions
        # (which builds int64 keys over all nnz)
        g = self.graph
        rid = np.asarray(g.row_ids)[: g.nnz]
        cid = np.asarray(g.indices)[: g.nnz]
        mask = rid == cid
        k = min(self.shape)
        d = np.zeros(k, dtype=np.asarray(self.data).dtype)
        d[rid[mask]] = np.asarray(self.data).reshape(-1)[: g.nnz][mask]
        return jnp.asarray(d, dtype=self.dtype)

    def matvec(self, x):
        g = self.graph
        prod = self.data * x[g.indices]
        return _segment_sum(prod, g.row_ids, g.shape[0])

    def rmatvec(self, x):
        g = self.graph
        # gather by row (clamped at pad; data=0 there), scatter-add by column
        prod = self.data * x[jnp.minimum(g.row_ids, g.shape[0] - 1)]
        return jnp.zeros(g.shape[1], dtype=prod.dtype).at[g.indices].add(prod)

    def matmat(self, X):
        g = self.graph
        prod = self.data[:, None] * X[g.indices, :]
        return _segment_sum(prod, g.row_ids, g.shape[0])

    def rmatmat(self, X):
        g = self.graph
        prod = self.data[:, None] * X[jnp.minimum(g.row_ids, g.shape[0] - 1), :]
        return jnp.zeros((g.shape[1],) + X.shape[1:], dtype=prod.dtype).at[
            g.indices
        ].add(prod)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, repr=False)
class CSCMatrix(SparseMatrix):
    """Column-compressed matrix: the stored arrays are the CSR compression of
    A^T, so matvec/rmatvec are CSR's kernels swapped — the same duality the
    reference wires up at ``cs_matrices.f90:148-149,192-193``."""

    graph: CSCGraph
    data: jax.Array  # (nnz_pad,) column-major order

    format: ClassVar[str] = "csc"
    is_get_row_fast: ClassVar[bool] = False
    is_get_column_fast: ClassVar[bool] = True

    @classmethod
    def _graph_class(cls):
        return CSCGraph

    @classmethod
    def _data_shape(cls, graph):
        return graph.indices.shape

    def matvec(self, x):
        g = self.graph
        prod = self.data * x[jnp.minimum(g.col_ids, g.shape[1] - 1)]
        return jnp.zeros(g.shape[0], dtype=prod.dtype).at[g.indices].add(prod)

    def rmatvec(self, x):
        g = self.graph
        prod = self.data * x[g.indices]
        return _segment_sum(prod, g.col_ids, g.shape[1])

    def matmat(self, X):
        g = self.graph
        prod = self.data[:, None] * X[jnp.minimum(g.col_ids, g.shape[1] - 1), :]
        return jnp.zeros((g.shape[0],) + X.shape[1:], dtype=prod.dtype).at[
            g.indices
        ].add(prod)

    def rmatmat(self, X):
        g = self.graph
        prod = self.data[:, None] * X[g.indices, :]
        return _segment_sum(prod, g.col_ids, g.shape[1])


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, repr=False)
class COOMatrix(SparseMatrix):
    """Coordinate matrix (sorted row-major at freeze time)."""

    graph: COOGraph
    data: jax.Array  # (nnz_pad,)

    format: ClassVar[str] = "coo"
    is_get_row_fast: ClassVar[bool] = False
    is_get_column_fast: ClassVar[bool] = False

    @classmethod
    def _graph_class(cls):
        return COOGraph

    @classmethod
    def _data_shape(cls, graph):
        return graph.rows.shape

    def matvec(self, x):
        g = self.graph
        prod = self.data * x[g.cols]
        return _segment_sum(prod, g.rows, g.shape[0])

    def rmatvec(self, x):
        g = self.graph
        prod = self.data * x[jnp.minimum(g.rows, g.shape[0] - 1)]
        return jnp.zeros(g.shape[1], dtype=prod.dtype).at[g.cols].add(prod)

    def matmat(self, X):
        g = self.graph
        prod = self.data[:, None] * X[g.cols, :]
        return _segment_sum(prod, g.rows, g.shape[0])

    def rmatmat(self, X):
        g = self.graph
        prod = self.data[:, None] * X[jnp.minimum(g.rows, g.shape[0] - 1), :]
        return jnp.zeros((g.shape[1],) + X.shape[1:], dtype=prod.dtype).at[
            g.cols
        ].add(prod)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, repr=False)
class ELLMatrix(SparseMatrix):
    """ELLPACK matrix: values in a dense (n, width) array mirroring the
    topology layout.  matvec is a fixed-trip-count gather/multiply/row-sum —
    the regular shape ``ellpack_matvec_add`` (``ellpack_matrices.f90:
    640-665``) was built for, realized as one whole-array XLA program."""

    graph: ELLGraph
    data: jax.Array  # (n, width)

    format: ClassVar[str] = "ell"
    is_get_row_fast: ClassVar[bool] = True
    is_get_column_fast: ClassVar[bool] = False

    @classmethod
    def _graph_class(cls):
        return ELLGraph

    @classmethod
    def _data_shape(cls, graph):
        return graph.cols.shape

    def matvec(self, x):
        g = self.graph
        return (self.data * x[g.cols]).sum(axis=1)

    def rmatvec(self, x):
        g = self.graph
        prod = self.data * x[:, None]
        return jnp.zeros(g.shape[1], dtype=prod.dtype).at[g.cols].add(prod)

    def matmat(self, X):
        g = self.graph
        # (n, w, k) gather; contiguous over k
        return (self.data[:, :, None] * X[g.cols, :]).sum(axis=1)

    def rmatmat(self, X):
        g = self.graph
        prod = self.data[:, :, None] * X[:, None, :]
        return jnp.zeros((g.shape[1],) + X.shape[1:], dtype=prod.dtype).at[
            g.cols
        ].add(prod)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, repr=False)
class BSRMatrix(SparseMatrix):
    """Block CSR matrix with dense (bh, bw) value blocks.

    SpMV = batched block matmul + block-row segment sum; SpMM contracts each
    block against a (bw, k) slab.  This is the format the
    reference lists as a missing critical optimization (``README.md:84``).
    """

    graph: BSRGraph
    data: jax.Array  # (nnzb_pad, bh, bw)

    format: ClassVar[str] = "bsr"
    is_get_row_fast: ClassVar[bool] = True
    is_get_column_fast: ClassVar[bool] = False

    @classmethod
    def _graph_class(cls):
        return BSRGraph

    @classmethod
    def _data_shape(cls, graph):
        return (graph.indices.shape[0],) + graph.block_shape

    def _format_kwargs(self):
        return dict(block_shape=self.graph.block_shape)

    def _format_kwargs_transposed(self):
        bh, bw = self.graph.block_shape
        return dict(block_shape=(bw, bh))

    @classmethod
    def _coerce_graph(cls, graph):
        if isinstance(graph, BSRGraph):
            return graph
        rows, cols = graph.edges_numpy()
        return BSRGraph.from_coo(graph.shape[0], graph.shape[1], rows, cols)

    def _coerce_graph_from_builder(self, b):
        rows, cols = b.edges()
        return BSRGraph.from_coo(
            b.n, b.m, rows, cols, block_shape=self.graph.block_shape
        )

    def _padded_x(self, x):
        g = self.graph
        bw = g.block_shape[1]
        mp = g.nb_cols * bw
        if x.shape[0] != mp:
            x = jnp.pad(x, [(0, mp - x.shape[0])] + [(0, 0)] * (x.ndim - 1))
        return x

    def matvec(self, x):
        g = self.graph
        bh, bw = g.block_shape
        xb = self._padded_x(x).reshape(g.nb_cols, bw)
        gathered = xb[g.indices]  # (nnzb_pad, bw)
        yb = jnp.einsum(
            "bij,bj->bi", self.data, gathered.astype(self.dtype),
            precision=jax.lax.Precision.HIGHEST,
        )
        y = _segment_sum(yb, g.block_rows, g.nb_rows)
        return y.reshape(-1)[: g.shape[0]]

    def grouped(self, group: int = 8):
        """Grouped layout (host-side regroup,
        :class:`sigma_tpu.matrix.grouped_bsr.GroupedBSR`): each group of
        ``group`` blocks of a block row applies as one wide matmul."""
        from sigma_tpu.matrix.grouped_bsr import GroupedBSR

        return GroupedBSR.from_bsr(self, group=group)

    def rmatvec(self, x):
        g = self.graph
        bh, bw = g.block_shape
        np_rows = g.nb_rows * bh
        xp = jnp.pad(x, (0, np_rows - x.shape[0])).reshape(g.nb_rows, bh)
        gathered = xp[jnp.minimum(g.block_rows, g.nb_rows - 1)]
        yb = jnp.einsum(
            "bij,bi->bj", self.data, gathered.astype(self.dtype),
            precision=jax.lax.Precision.HIGHEST,
        )
        y = jnp.zeros((g.nb_cols, bw), dtype=yb.dtype).at[g.indices].add(yb)
        return y.reshape(-1)[: g.shape[1]]

    def matmat(self, X):
        g = self.graph
        bh, bw = g.block_shape
        k = X.shape[1]
        Xb = self._padded_x(X).reshape(g.nb_cols, bw, k)
        gathered = Xb[g.indices]  # (nnzb_pad, bw, k)
        Yb = jnp.einsum(
            "bij,bjk->bik", self.data, gathered.astype(self.dtype),
            precision=jax.lax.Precision.HIGHEST,
        )
        Y = _segment_sum(Yb, g.block_rows, g.nb_rows)
        return Y.reshape(-1, k)[: g.shape[0]]

    def rmatmat(self, X):
        g = self.graph
        bh, bw = g.block_shape
        k = X.shape[1]
        np_rows = g.nb_rows * bh
        Xp = jnp.pad(X, ((0, np_rows - X.shape[0]), (0, 0))).reshape(
            g.nb_rows, bh, k
        )
        gathered = Xp[jnp.minimum(g.block_rows, g.nb_rows - 1)]
        Yb = jnp.einsum(
            "bij,bik->bjk", self.data, gathered.astype(self.dtype),
            precision=jax.lax.Precision.HIGHEST,
        )
        Y = jnp.zeros((g.nb_cols, bw, k), dtype=Yb.dtype).at[g.indices].add(Yb)
        return Y.reshape(-1, k)[: g.shape[1]]


def _padded_frame(x, offsets, length: int):
    """(xp, off_arr): zero-padded frame such that the window for
    diagonal d is ``xp[off_arr[d] : off_arr[d] + length]`` — shared by
    every scan path (O(1) program size for wide bands)."""
    o_min = min(min(offsets), 0)
    o_max = max(max(offsets), 0)
    left = -o_min
    L = length + (o_max - o_min)
    right = L - left - x.shape[0]
    xp = jnp.concatenate(
        [
            jnp.zeros((left,) + x.shape[1:], x.dtype),
            x,
            jnp.zeros((max(right, 0),) + x.shape[1:], x.dtype),
        ]
    )
    off_arr = jnp.asarray(np.asarray(offsets) - o_min, dtype=jnp.int32)
    return xp, off_arr


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, repr=False)
class DIAMatrix(SparseMatrix):
    """Diagonal-format matrix: ``data[d, i]`` = A[i, i + offset_d].

    The stencil format (no reference analogue; see
    :class:`sigma_tpu.graph.graph.DIAGraph`).  SpMV is **gather-free**:
    one statically-shifted contiguous window multiply-add per diagonal —
    no index array is even stored, so the memory traffic per nonzero is
    value + x-read only, below what any indexed format can reach.
    Out-of-range slots hold value 0.

    DTYPE CONVENTION: every DIA apply computes in the OPERAND's dtype
    (matrix values cast to x.dtype) — the mixed-precision contract that
    bf16-valued operators on f32 vectors rely on.  This differs from the
    gather formats (CSR/ELL promote by numpy rules); apply an f64
    operand if f64 accumulation is wanted."""

    graph: "DIAGraph"
    data: jax.Array  # (n_diags, stride/128, 128); flat element order is
    # (diagonal, row), so flat-position machinery (set_values/entries/
    # edge_positions) is layout-agnostic; use :attr:`data2d` for
    # per-diagonal row views.

    format: ClassVar[str] = "dia"
    is_get_row_fast: ClassVar[bool] = True
    is_get_column_fast: ClassVar[bool] = True

    @classmethod
    def _graph_class(cls):
        from sigma_tpu.graph.graph import DIAGraph

        return DIAGraph

    @classmethod
    def _data_shape(cls, graph):
        return (graph.n_diags, graph.stride // 128, 128)

    @property
    def data2d(self) -> jax.Array:
        """(n_diags, stride) view: data2d[d, i] = A[i, i + offsets[d]]."""
        return self.data.reshape(self.graph.n_diags, self.graph.stride)

    def _window(self, x, o: int, length: int, total: int):
        return zero_padded_window(x, o, length, total)

    # above this many diagonals the unrolled static-window formulation is
    # replaced by a lax.scan with dynamic slices (bounded compile time for
    # wide bands, e.g. RCM-reordered general matrices -> banded DIA)
    _SCAN_THRESHOLD: ClassVar[int] = 24

    def matvec(self, x):
        """Gather-free SpMV: per diagonal, a shifted contiguous window
        FMA, unrolled so XLA fuses every diagonal into one elementwise
        pass (one read of each value, x and y)."""
        n, m = self.shape
        offs = self.graph.offsets
        if not offs:
            return jnp.zeros((n,), dtype=x.dtype)
        if len(offs) > self._SCAN_THRESHOLD:
            return self._matvec_scan(x)
        s = self.graph.stride
        y2 = jnp.zeros((s // 128, 128), dtype=x.dtype)
        for d, o in enumerate(offs):
            w = self._window(x, o, n, s).reshape(s // 128, 128)
            y2 = y2 + self.data[d].astype(x.dtype) * w
        return y2.reshape(-1)[:n]

    def _matvec_scan(self, x):
        """Many-diagonal path: a lax.scan whose step dynamic-slices the
        padded x for its offset — O(1) program size."""
        s = self.graph.stride
        xp, off_arr = _padded_frame(x, self.graph.offsets, s)

        def step(y, inp):
            start, drow = inp
            w = lax.dynamic_slice(xp, (start,), (s,))
            return y + drow.astype(y.dtype) * w, None

        y, _ = lax.scan(
            step, jnp.zeros((s,), x.dtype), (off_arr, self.data2d)
        )
        return y[: self.shape[0]]

    def rmatvec(self, x):
        """Transpose: y[i+o] += data[d, i] * x[i] — same windows, with the
        product shifted by -o into the output frame (scan form for wide
        bands, like matvec)."""
        n, m = self.shape
        offs = self.graph.offsets
        if not offs:
            return jnp.zeros((m,), dtype=x.dtype)
        if len(offs) > self._SCAN_THRESHOLD:
            return self._rmatvec_scan(x)
        s = -(-m // 128) * 128
        y2 = jnp.zeros((s // 128, 128), dtype=x.dtype)
        for d, o in enumerate(offs):
            z = self.data2d[d, :n].astype(x.dtype) * x
            w = self._window(z, -o, m, s).reshape(s // 128, 128)
            y2 = y2 + w
        return y2.reshape(-1)[:m]

    def _rmatvec_scan(self, x):
        """y^T form: accumulate each diagonal's product into a shifted slot
        of a padded output frame via dynamic_update_slice inside lax.scan."""
        n, m = self.shape
        offs = self.graph.offsets
        o_min = min(min(offs), 0)
        o_max = max(max(offs), 0)
        left = -o_min
        L = n + (o_max - o_min) + max(m - n, 0)
        off_arr = jnp.asarray(np.asarray(offs) - o_min, dtype=jnp.int32)

        def step(acc, inp):
            start, drow = inp
            z = drow[:n].astype(x.dtype) * x
            win = lax.dynamic_slice(acc, (start,), (n,))
            return lax.dynamic_update_slice(acc, win + z, (start,)), None

        acc, _ = lax.scan(
            step, jnp.zeros((L,), x.dtype), (off_arr, self.data2d)
        )
        # frame position t holds y[t + o_min]
        return lax.dynamic_slice(acc, (left,), (m,))

    def matmat_rhs_major(self, XT):
        """RHS-major SpMM: XT (k, m) -> (k, n)."""
        return self.matmat(XT.T).T

    def matmat_interleaved(self, XI):
        """Multi-RHS apply on INTERLEAVED panels: XI is (k*ceil(m/128),
        128) from :func:`sigma_tpu.matrix.panels.interleave_panels`;
        returns the product in the same layout ((k*ceil(n/128), 128))."""
        from sigma_tpu.matrix.panels import (
            deinterleave_panels,
            interleave_panels,
        )

        n, m = self.shape
        k = XI.shape[0] // max(-(-m // 128), 1)
        XT = deinterleave_panels(XI, k, m)
        return interleave_panels(self.matmat(XT.T).T, n)

    def matmat(self, X):
        n, m = self.shape
        offs = self.graph.offsets
        k = X.shape[1]
        if not offs:
            return jnp.zeros((n, k), dtype=X.dtype)
        if len(offs) > self._SCAN_THRESHOLD:
            Xp, off_arr = _padded_frame(X, offs, n)

            def step(Y, inp):
                start, drow = inp
                W = lax.dynamic_slice(Xp, (start, jnp.asarray(0, start.dtype)), (n, k))
                return Y + drow[:n, None].astype(X.dtype) * W, None

            Y, _ = lax.scan(
                step, jnp.zeros((n, k), X.dtype), (off_arr, self.data2d)
            )
            return Y
        Y = jnp.zeros((n, k), dtype=X.dtype)
        for d, o in enumerate(offs):
            W = self._window(X, o, n, n)
            Y = Y + self.data2d[d, :n, None].astype(X.dtype) * W
        return Y

    def rmatmat(self, X):
        n, m = self.shape
        offs = self.graph.offsets
        k = X.shape[1]
        if not offs:
            return jnp.zeros((m, k), dtype=X.dtype)
        if len(offs) > self._SCAN_THRESHOLD:
            o_min = min(min(offs), 0)
            o_max = max(max(offs), 0)
            left = -o_min
            L = n + (o_max - o_min) + max(m - n, 0)
            off_arr = jnp.asarray(
                np.asarray(offs) - o_min, dtype=jnp.int32
            )

            def step(acc, inp):
                start, drow = inp
                Z = drow[:n, None].astype(X.dtype) * X
                zero = jnp.asarray(0, start.dtype)
                win = lax.dynamic_slice(acc, (start, zero), (n, k))
                return lax.dynamic_update_slice(acc, win + Z, (start, zero)), None

            acc, _ = lax.scan(
                step, jnp.zeros((L, k), X.dtype), (off_arr, self.data2d)
            )
            return lax.dynamic_slice(acc, (left, 0), (m, k))
        Y = jnp.zeros((m, k), dtype=X.dtype)
        for d, o in enumerate(offs):
            Z = self.data2d[d, :n, None].astype(X.dtype) * X
            Y = Y + self._window(Z, -o, m, m)
        return Y

    @property
    def offsets(self):
        return self.graph.offsets

    def diagonal(self) -> jax.Array:
        if 0 in self.graph.offsets:
            d = self.graph.offsets.index(0)
            return self.data2d[d, : min(self.shape)]
        return jnp.zeros((min(self.shape),), dtype=self.dtype)
