"""Grouped-layout BSR SpMV/SpMM.

Layout (:class:`GroupedBSR`, built host-side at freeze): each block row's
blocks are padded to a multiple of ``group`` = B (zero blocks pointing at
column-block 0 — harmless in arithmetic, the ellpack padding trick); rows
with no blocks get one zero group.  Group g stores

* ``gdata[g]``: (bh, B*bw) — its B value blocks side by side, so the
  whole group's contribution is ONE (bh, B*bw) @ (B*bw, nrhs) matmul;
* ``gcols[g, j]``: the column-block index of slice j;
* ``grow[g]``: the owning block row (ascending).

Grouping turns B small matvecs into one wide matmul, and each gather of
x moves a whole contiguous (bw, k) row of x.

Reference lineage: the block format itself is the optimization the
reference names as missing (``/root/reference/README.md:84``).
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sigma_tpu.operators.linear_operator import LinearOperator

__all__ = ["GroupedBSR"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, repr=False)
class GroupedBSR(LinearOperator):
    """BSR matrix in the grouped layout (see module doc).

    Built once from a :class:`sigma_tpu.matrix.formats.BSRMatrix` via
    :meth:`from_bsr`; apply with ``matvec``/``matmat`` (gather + one
    einsum per group + segment-sum by block row).
    """

    gdata: jax.Array  # (n_groups, bh, B*bw)
    gcols: jax.Array  # (n_groups, B) int32
    grow: jax.Array  # (n_groups,) int32, ascending
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    block_shape: Tuple[int, int] = dataclasses.field(
        metadata=dict(static=True)
    )
    group: int = dataclasses.field(metadata=dict(static=True))

    format: ClassVar[str] = "bsr_grouped"

    @property
    def nb_rows(self) -> int:
        return -(-self.shape[0] // self.block_shape[0])

    @property
    def nb_cols(self) -> int:
        return -(-self.shape[1] // self.block_shape[1])

    @property
    def dtype(self):
        return self.gdata.dtype

    @classmethod
    def from_bsr(cls, A, group: int = 8) -> "GroupedBSR":
        """Host-side regrouping of a BSRMatrix (freeze-time, like all
        layout decisions)."""
        g = A.graph
        bh, bw = g.block_shape
        nbr = g.nb_rows
        brows = np.asarray(g.block_rows)[: g.nnzb].astype(np.int64)
        bcols = np.asarray(g.indices)[: g.nnzb].astype(np.int64)
        data = np.asarray(A.data)[: g.nnzb]

        deg = np.bincount(brows, minlength=nbr)
        groups_per_row = np.maximum(-(-deg // group), 1)
        n_groups = int(groups_per_row.sum())
        row_gstart = np.concatenate([[0], np.cumsum(groups_per_row)])

        gdata = np.zeros((n_groups, bh, group * bw), dtype=data.dtype)
        gcols = np.zeros((n_groups, group), dtype=np.int32)
        grow = np.repeat(
            np.arange(nbr, dtype=np.int32), groups_per_row
        )
        # slot of each block within its row (brows is sorted)
        indptr = np.concatenate([[0], np.cumsum(deg)])
        slot = np.arange(brows.size) - indptr[brows]
        gidx = row_gstart[brows] + slot // group
        lane = slot % group
        gcols[gidx, lane] = bcols
        for j in range(group):
            sel = lane == j
            gdata[gidx[sel], :, j * bw : (j + 1) * bw] = data[sel]
        return cls(
            gdata=jnp.asarray(gdata),
            gcols=jnp.asarray(gcols),
            grow=jnp.asarray(grow),
            shape=A.shape,
            block_shape=(bh, bw),
            group=int(group),
        )

    def _pad_x(self, x):
        bw = self.block_shape[1]
        mp = self.nb_cols * bw
        if x.shape[0] != mp:
            x = jnp.pad(x, [(0, mp - x.shape[0])] + [(0, 0)] * (x.ndim - 1))
        return x


    def _apply(self, X):
        Xp = self._pad_x(X)
        bh, bw = self.block_shape
        k = Xp.shape[1]
        X3 = Xp.reshape(self.nb_cols, bw, k)
        gath = X3[self.gcols]  # (n_groups, B, bw, k)
        gath = gath.reshape(self.gdata.shape[0], self.group * bw, k)
        # matrix values cast UP to the operand dtype (the DIA contract):
        # a bf16-valued operator on f32 vectors must accumulate in f32,
        # not silently downcast the RHS to bf16
        Yg = jnp.einsum(
            "ghc,gck->ghk", self.gdata.astype(Xp.dtype), gath,
            precision=jax.lax.Precision.HIGHEST,
        )
        Y = jax.ops.segment_sum(
            Yg, self.grow, num_segments=self.nb_rows
        ).reshape(self.nb_rows * bh, k)
        return Y[: self.shape[0]]

    def matvec(self, x):
        return self._apply(x[:, None])[:, 0]

    def matmat(self, X):
        return self._apply(X)

    def __repr__(self) -> str:
        return (
            f"GroupedBSR(shape={self.shape}, block={self.block_shape}, "
            f"groups={self.gdata.shape[0]} x {self.group})"
        )
