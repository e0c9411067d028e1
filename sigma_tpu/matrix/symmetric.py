"""Symmetric DIA storage: upper diagonals only (half the value memory).

The reference names symmetric storage as one of three "critical
optimizations" it never built (``/root/reference/README.md:81-87``; the
other two — multi-vector products and a block format — exist here as
SpMM and BSR).  For the DIA stencil format the symmetric form is natural:
store only the diagonals with offset >= 0; the lower triangle is the
mirror ``A[i, i-o] = data[o][i-o]``, applied as one extra shifted-window
FMA per stored off-diagonal:

    y  =  sum_o  data[o] * win(x, +o)          (upper + main)
        + sum_{o>0}  win(data[o] * x, -o)      (mirror)

so SpMV stays gather-free.  Storage halves (7-pt 3-D Laplacian: 4 stored
diagonals instead of 7); the unrolled window form reads x twice per
stored off-diagonal, so whether the halved value stream wins depends on
how well XLA fuses the two windows.

This is a :class:`LinearOperator` (matvec/matmat/solve compose with every
Krylov solver and preconditioner), not a mutable SparseMatrix — convert
with :meth:`from_dia` / :meth:`to_dia` for structural edits.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sigma_tpu.matrix.formats import DIAMatrix, zero_padded_window
from sigma_tpu.operators.linear_operator import LinearOperator

__all__ = ["SymmetricDIAMatrix"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, repr=False)
class SymmetricDIAMatrix(LinearOperator):
    """data[d, i] = A[i, i + offsets[d]] with offsets[d] >= 0 only."""

    data: jax.Array  # (n_upper_diags, stride/128, 128), like DIAMatrix.data
    offsets: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    n: int = dataclasses.field(metadata=dict(static=True))

    format: ClassVar[str] = "dia_sym"

    def __post_init__(self):
        if any(o < 0 for o in self.offsets):
            raise ValueError(
                f"symmetric DIA stores offsets >= 0 only, got {self.offsets}"
            )

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def data2d(self) -> jax.Array:
        """(n_upper_diags, stride) view: data2d[d, i] = A[i, i+offsets[d]]."""
        return self.data.reshape(self.data.shape[0], -1)

    @property
    def nnz(self) -> int:
        n = self.n
        return sum(
            (n - o) * (1 if o == 0 else 2) for o in self.offsets
        )

    # -- construction -----------------------------------------------------
    @classmethod
    def from_dia(cls, A: DIAMatrix, *, rtol: float = 1e-12):
        """Fold a full DIAMatrix into symmetric storage; raises if A is
        not numerically symmetric (per-diagonal mirror comparison)."""
        n, m = A.shape
        if n != m:
            raise ValueError("symmetric storage requires a square matrix")
        offs = A.graph.offsets
        data = np.asarray(A.data2d)
        rows = {}
        for d, o in enumerate(offs):
            rows[o] = data[d]
        for o in offs:
            if -o not in rows:
                raise ValueError(f"offset {o} present without mirror {-o}")
            if o > 0:
                # A[i, i+o] = data[o][i]  must equal  A[i+o, i] = data[-o][i+o]
                upper = rows[o][: n - o]
                lower = rows[-o][o:n]
                scale = max(float(np.abs(upper).max(initial=0.0)), 1e-300)
                if float(np.abs(upper - lower).max(initial=0.0)) > rtol * scale:
                    raise ValueError(
                        f"matrix is not symmetric on diagonal +-{o}"
                    )
        keep = sorted(o for o in offs if o >= 0)
        sel = [offs.index(o) for o in keep]
        return cls(
            data=jnp.asarray(data[sel].reshape(len(keep), -1, 128)),
            offsets=tuple(keep),
            n=int(n),
        )

    @classmethod
    def from_coo(cls, n, m, rows, cols, vals, dtype=None, **kw):
        return cls.from_dia(
            DIAMatrix.from_coo(n, m, rows, cols, vals, dtype=dtype, **kw)
        )

    @classmethod
    def from_dense(cls, dense, **kw):
        return cls.from_dia(DIAMatrix.from_dense(dense), **kw)

    def to_dia(self) -> DIAMatrix:
        """Expand back to full (two-triangle) DIA storage."""
        from sigma_tpu.graph.graph import DIAGraph

        n = self.n
        full = sorted(set(self.offsets) | {-o for o in self.offsets})
        g = DIAGraph(offsets=tuple(full), shape=(n, n), nnz=self.nnz)
        s = g.stride
        data = np.zeros((len(full), s), dtype=np.asarray(self.data).dtype)
        host = np.asarray(self.data2d)
        for d, o in enumerate(full):
            if o >= 0:
                data[d] = host[self.offsets.index(o)]
            else:
                src = host[self.offsets.index(-o)]
                data[d, -o : n] = src[: n + o]
        return DIAMatrix(graph=g, data=jnp.asarray(data.reshape(len(full), -1, 128)))

    # -- compute ----------------------------------------------------------
    def matvec(self, x):
        n = self.n
        if len(self.offsets) > DIAMatrix._SCAN_THRESHOLD:
            return self._matvec_scan(x)
        s = self.data.shape[1] * 128
        d2 = self.data2d
        y2 = jnp.zeros((s // 128, 128), dtype=x.dtype)
        for d, o in enumerate(self.offsets):
            w = zero_padded_window(x, o, n, s).reshape(s // 128, 128)
            y2 = y2 + self.data[d].astype(x.dtype) * w
            if o > 0:
                z = d2[d, :n].astype(x.dtype) * x
                y2 = y2 + zero_padded_window(z, -o, n, s).reshape(
                    s // 128, 128
                )
        return y2.reshape(-1)[:n]

    def _matvec_scan(self, x):
        """Wide-band path: one lax.scan step per stored upper
        diagonal (O(1) program size — the unrolled window form above is a
        compile-size hazard at hundreds of diagonals).  Per step, the
        upper term reads a forward window of the padded x and the mirror
        term scatters ``data_o * x`` into a padded output frame."""
        from jax import lax

        n = self.n
        o_max = max(self.offsets)
        xp = jnp.concatenate([x, jnp.zeros((o_max,), x.dtype)])
        off_arr = jnp.asarray(np.asarray(self.offsets), jnp.int32)

        def step(F, inp):
            off, drow = inp
            d = drow[:n].astype(x.dtype)
            t1 = d * lax.dynamic_slice(xp, (off,), (n,))
            # upper + main: y[i] += d[i] * x[i+o]   (frame slot i)
            head = lax.dynamic_slice(F, (jnp.asarray(0, off.dtype),), (n,))
            F = lax.dynamic_update_slice(
                F, head + t1, (jnp.asarray(0, off.dtype),)
            )
            # mirror (o > 0 only): y[i+o] += d[i] * x[i]
            z = jnp.where(off > 0, d * x, jnp.zeros_like(x))
            win = lax.dynamic_slice(F, (off,), (n,))
            return lax.dynamic_update_slice(F, win + z, (off,)), None

        F, _ = lax.scan(
            step,
            jnp.zeros((n + o_max,), x.dtype),
            (off_arr, self.data2d),
        )
        return F[:n]

    rmatvec = matvec  # symmetric

    def matmat_rhs_major(self, XT):
        """RHS-major multi-RHS apply (k, n) -> (k, n)."""
        return self.matmat(XT.T).T

    def matmat_interleaved(self, XI):
        """Multi-RHS apply on INTERLEAVED panels (k*S, 128) -> (k*S, 128)
        (see :meth:`DIAMatrix.matmat_interleaved`)."""
        from sigma_tpu.matrix.panels import (
            deinterleave_panels,
            interleave_panels,
        )

        n = self.n
        k = XI.shape[0] // self.data.shape[1]
        XT = deinterleave_panels(XI, k, n)
        return interleave_panels(self.matmat(XT.T).T, n)

    def matmat(self, X):
        n = self.n
        k = X.shape[1]
        if len(self.offsets) > DIAMatrix._SCAN_THRESHOLD:
            # wide-band path: column-wise scan matvec (O(1)
            # program size, like _matvec_scan)
            return jnp.stack(
                [self._matvec_scan(X[:, j]) for j in range(k)], axis=1
            )
        Y = jnp.zeros((n, k), dtype=X.dtype)
        d2 = self.data2d
        for d, o in enumerate(self.offsets):
            W = zero_padded_window(X, o, n, n)
            Y = Y + d2[d, :n, None].astype(X.dtype) * W
            if o > 0:
                Z = d2[d, :n, None].astype(X.dtype) * X
                Y = Y + zero_padded_window(Z, -o, n, n)
        return Y

    rmatmat = matmat

    def diagonal(self) -> jax.Array:
        if 0 in self.offsets:
            return self.data2d[self.offsets.index(0), : self.n]
        return jnp.zeros((self.n,), dtype=self.dtype)

    def to_dense(self) -> np.ndarray:
        return self.to_dia().to_dense()

    def memory_bytes(self) -> int:
        return int(self.data.size) * self.data.dtype.itemsize

    def __repr__(self) -> str:
        return (
            f"SymmetricDIAMatrix(n={self.n}, offsets={self.offsets}, "
            f"dtype={self.dtype})"
        )
