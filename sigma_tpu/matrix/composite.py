"""Composite block matrix: a matrix of matrices.

Reference: ``/root/reference/src/matrix/sparse_matrix_composites.f90`` — the
non-abstract ``sparse_matrix`` type is simultaneously (a) a block "matrix of
matrices" with per-block storage formats and (b), in the 1x1 case, a
format-strategy wrapper around a single leaf.  Its block-wise matvec over
vector slices (":1076-1129", annotated "This loop can be parallelized") is
the reference's designated distribution seam.

Pytree redesign
---------------
:class:`BlockMatrix` is an immutable registered pytree: a (br x bc) grid of
optional leaf operators plus static row/col partition offsets.  matvec
splits x at column offsets, applies every present block, and concatenates
row-segment sums — all inside one jit trace, so XLA fuses and schedules the
block kernels; absent blocks cost nothing (they are pytree ``None``'s, not
zero matrices).  The same structure sharded over a device mesh is the
distributed matrix in :mod:`sigma_tpu.parallel` (off-diagonal blocks =
halo couplings).

Global<->local index mapping (``get_owning_row_matrix:1235``, ptr offsets
:44) is vectorized with ``np.searchsorted``.  Capability flags AND-reduce
over blocks exactly as in the reference (:1190-1227).  Shared-graph blocks
(one topology reused by several blocks, ``matrix_test_composite.f90:168-186``)
work for free: graphs are immutable pytrees, sharing is structural.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sigma_tpu.matrix.base import SparseMatrix
from sigma_tpu.operators.linear_operator import LinearOperator

__all__ = ["BlockMatrix"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, repr=False)
class BlockMatrix(LinearOperator):
    """Block "matrix of matrices" over fixed row/column partitions.

    ``blocks[i][j]`` is a leaf :class:`LinearOperator` (usually a
    :class:`SparseMatrix` in any format) of shape
    ``(row_sizes[i], col_sizes[j])``, or ``None`` for a structurally zero
    block.
    """

    blocks: Tuple[Tuple[Optional[LinearOperator], ...], ...]
    row_sizes: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    col_sizes: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))

    # -- construction ----------------------------------------------------------
    @classmethod
    def from_blocks(cls, blocks: Sequence[Sequence[Optional[LinearOperator]]]):
        """Build from a nested sequence (rows of blocks); sizes inferred.

        Every row must have the same number of blocks; each present block
        pins the sizes of its row/column slot, and inconsistencies raise.
        """
        grid = [list(row) for row in blocks]
        if not grid or not grid[0]:
            raise ValueError("empty block grid")
        bc = len(grid[0])
        if any(len(row) != bc for row in grid):
            raise ValueError("ragged block grid")
        row_sizes = [None] * len(grid)
        col_sizes = [None] * bc
        for i, row in enumerate(grid):
            for j, blk in enumerate(row):
                if blk is None:
                    continue
                r, c = blk.shape
                if row_sizes[i] is None:
                    row_sizes[i] = int(r)
                elif row_sizes[i] != r:
                    raise ValueError(
                        f"block ({i},{j}) row size {r} != {row_sizes[i]}"
                    )
                if col_sizes[j] is None:
                    col_sizes[j] = int(c)
                elif col_sizes[j] != c:
                    raise ValueError(
                        f"block ({i},{j}) col size {c} != {col_sizes[j]}"
                    )
        if any(s is None for s in row_sizes) or any(s is None for s in col_sizes):
            raise ValueError(
                "every block row/column needs at least one present block to "
                "pin its size; pass explicit zero matrices otherwise"
            )
        return cls(
            blocks=tuple(tuple(row) for row in grid),
            row_sizes=tuple(row_sizes),
            col_sizes=tuple(col_sizes),
        )

    @classmethod
    def empty(cls, row_sizes: Sequence[int], col_sizes: Sequence[int]):
        """All-zero block grid with fixed partition (``set_num_blocks:203`` +
        ``set_block_sizes:226``)."""
        grid = tuple(tuple(None for _ in col_sizes) for _ in range(len(row_sizes)))
        return cls(
            blocks=grid,
            row_sizes=tuple(int(s) for s in row_sizes),
            col_sizes=tuple(int(s) for s in col_sizes),
        )

    @classmethod
    def wrap(cls, leaf: LinearOperator) -> "BlockMatrix":
        """1x1 strategy wrapper (``matrix_test_strategy.f90`` usage)."""
        return cls.from_blocks([[leaf]])

    def set_block(self, i: int, j: int, block: Optional[LinearOperator]):
        """Functional block insert (``set_submatrix:1031``)."""
        if block is not None:
            want = (self.row_sizes[i], self.col_sizes[j])
            if tuple(block.shape) != want:
                raise ValueError(f"block shape {block.shape} != slot {want}")
        grid = [list(row) for row in self.blocks]
        grid[i][j] = block
        return dataclasses.replace(
            self, blocks=tuple(tuple(row) for row in grid)
        )

    # -- shape/meta ------------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, int]:
        return (sum(self.row_sizes), sum(self.col_sizes))

    @property
    def block_shape(self) -> Tuple[int, int]:
        return (len(self.row_sizes), len(self.col_sizes))

    @property
    def row_offsets(self) -> np.ndarray:  # row_ptr (composites :44)
        return np.concatenate([[0], np.cumsum(self.row_sizes)])

    @property
    def col_offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.col_sizes)])

    def get_block(self, i: int, j: int) -> Optional[LinearOperator]:
        return self.blocks[i][j]

    @property
    def nnz(self) -> int:
        # duck-typed: PrunedDIAMatrix / SymmetricDIAMatrix / nested
        # BlockMatrix leaves are LinearOperators with .nnz, not
        # SparseMatrix (review fix — the isinstance filter reported 0
        # for exactly the composites the repo advertises)
        return sum(
            getattr(blk, "nnz", 0)
            for row in self.blocks
            for blk in row
            if blk is not None
        )

    @property
    def is_get_row_fast(self) -> bool:  # AND-reduce, composites :1190-1227
        return all(
            getattr(blk, "is_get_row_fast", False)
            for row in self.blocks
            for blk in row
            if blk is not None
        )

    @property
    def is_get_column_fast(self) -> bool:
        return all(
            getattr(blk, "is_get_column_fast", False)
            for row in self.blocks
            for blk in row
            if blk is not None
        )

    # -- compute ---------------------------------------------------------------
    def _split_cols(self, x: jax.Array):
        out, off = [], 0
        for s in self.col_sizes:
            out.append(x[off : off + s])
            off += s
        return out

    def _split_rows(self, x: jax.Array):
        out, off = [], 0
        for s in self.row_sizes:
            out.append(x[off : off + s])
            off += s
        return out

    def matvec(self, x: jax.Array) -> jax.Array:
        """Block-wise y_i = sum_j A_ij x_j (``composite_matvec_add:1076`` —
        the "can be parallelized" loop, here unrolled into one XLA graph)."""
        xs = self._split_cols(x)
        ys = []
        for i, row in enumerate(self.blocks):
            acc = None
            for j, blk in enumerate(row):
                if blk is None:
                    continue
                t = blk.matvec(xs[j])
                acc = t if acc is None else acc + t
            if acc is None:
                acc = jnp.zeros((self.row_sizes[i],), dtype=x.dtype)
            ys.append(acc)
        return jnp.concatenate(ys)

    def rmatvec(self, x: jax.Array) -> jax.Array:
        xs = self._split_rows(x)
        ys = []
        for j in range(len(self.col_sizes)):
            acc = None
            for i, row in enumerate(self.blocks):
                blk = row[j]
                if blk is None:
                    continue
                t = blk.rmatvec(xs[i])
                acc = t if acc is None else acc + t
            if acc is None:
                acc = jnp.zeros((self.col_sizes[j],), dtype=x.dtype)
            ys.append(acc)
        return jnp.concatenate(ys)

    def rmatmat(self, X: jax.Array) -> jax.Array:
        # blockwise transpose multi-RHS (review fix: the base-class
        # fallback vmaps rmatvec per column, bypassing leaf fast paths)
        rows_off = self.row_offsets
        ys = []
        for j in range(len(self.col_sizes)):
            acc = None
            for i, row in enumerate(self.blocks):
                blk = row[j]
                if blk is None:
                    continue
                t = blk.rmatmat(X[rows_off[i] : rows_off[i + 1]])
                acc = t if acc is None else acc + t
            if acc is None:
                acc = jnp.zeros(
                    (self.col_sizes[j], X.shape[1]), dtype=X.dtype
                )
            ys.append(acc)
        return jnp.concatenate(ys)

    def matmat(self, X: jax.Array) -> jax.Array:
        cols_off = self.col_offsets
        ys = []
        for i, row in enumerate(self.blocks):
            acc = None
            for j, blk in enumerate(row):
                if blk is None:
                    continue
                t = blk.matmat(X[cols_off[j] : cols_off[j + 1]])
                acc = t if acc is None else acc + t
            if acc is None:
                acc = jnp.zeros((self.row_sizes[i], X.shape[1]), dtype=X.dtype)
            ys.append(acc)
        return jnp.concatenate(ys)

    # -- global index routing (get_owning_row_matrix :1235-1263) ---------------
    def _owners(self, rows, cols):
        rows = np.asarray(rows).ravel()
        cols = np.asarray(cols).ravel()
        n, m = self.shape
        if ((rows < 0) | (rows >= n) | (cols < 0) | (cols >= m)).any():
            raise IndexError(
                f"global index out of range for shape {self.shape}"
            )
        ro, co = self.row_offsets, self.col_offsets
        bi = np.searchsorted(ro, rows, side="right") - 1
        bj = np.searchsorted(co, cols, side="right") - 1
        return bi, bj, rows - ro[bi], cols - co[bj]

    def get_values(self, rows, cols) -> np.ndarray:
        bi, bj, li, lj = self._owners(rows, cols)
        out = np.zeros(li.shape, dtype=float)
        for (i, j) in {(int(a), int(b)) for a, b in zip(bi, bj)}:
            blk = self.blocks[i][j]
            sel = (bi == i) & (bj == j)
            if blk is None:
                continue
            if isinstance(blk, SparseMatrix) or isinstance(blk, BlockMatrix):
                out[sel] = blk.get_values(li[sel], lj[sel])
            else:
                out[sel] = [blk.get_value(a, b) for a, b in zip(li[sel], lj[sel])]
        return out

    def get_value(self, i: int, j: int) -> float:
        return float(self.get_values([i], [j])[0])

    def _route_update(self, rows, cols, vals, add: bool) -> "BlockMatrix":
        bi, bj, li, lj = self._owners(rows, cols)
        vals = np.asarray(vals).ravel()
        new = self
        for (i, j) in sorted({(int(a), int(b)) for a, b in zip(bi, bj)}):
            blk = new.blocks[i][j]
            if blk is None or not isinstance(blk, (SparseMatrix, BlockMatrix)):
                raise ValueError(
                    f"cannot set values in absent/non-sparse block ({i},{j})"
                )
            sel = (bi == i) & (bj == j)
            blk = (
                blk.add_values(li[sel], lj[sel], vals[sel])
                if add
                else blk.set_values(li[sel], lj[sel], vals[sel])
            )
            new = new.set_block(i, j, blk)
        return new

    def set_values(self, rows, cols, vals) -> "BlockMatrix":
        """Global batched set routed to owning blocks (:786-831)."""
        return self._route_update(rows, cols, vals, add=False)

    def add_values(self, rows, cols, vals) -> "BlockMatrix":
        return self._route_update(rows, cols, vals, add=True)

    # -- export ----------------------------------------------------------------
    def entries(self):
        """Global (rows, cols, vals) across blocks, offset by block origin
        (the composite cursor, :671-734, vectorized)."""
        ro, co = self.row_offsets, self.col_offsets
        rr, cc, vv = [], [], []
        for i, row in enumerate(self.blocks):
            for j, blk in enumerate(row):
                if blk is None:
                    continue
                if hasattr(blk, "entries"):
                    # duck-typed (review fix): pruned/symmetric leaves
                    # have cheap triple extraction; the dense fallback
                    # would materialize an (n, n) array per block
                    r, c, v = blk.entries()
                else:
                    d = blk.to_dense()
                    r, c = np.nonzero(d)
                    v = d[r, c]
                rr.append(r + ro[i])
                cc.append(c + co[j])
                vv.append(v)
        if not rr:
            return (
                np.empty(0, dtype=np.int64),
                np.empty(0, dtype=np.int64),
                np.empty(0),
            )
        return np.concatenate(rr), np.concatenate(cc), np.concatenate(vv)

    def to_dense(self) -> np.ndarray:
        rows, cols, vals = self.entries()
        d = np.zeros(self.shape)
        np.add.at(d, (rows, cols), vals)
        return d

    def __repr__(self) -> str:
        return (
            f"BlockMatrix(block_shape={self.block_shape}, shape={self.shape}, "
            f"nnz={self.nnz})"
        )
