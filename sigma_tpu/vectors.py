"""Block (multi-field) vectors.

Reference: ``/root/reference/src/vectors.f90`` — the ``vector`` type keeps a
flat ``val(:)`` array plus per-field pointers (``init_multi_vector:55``) so a
vector over multiple physical fields (e.g. velocity components on a grid)
can be addressed either flat or by (field, index)
(``vec_get_value_multi_index:92``).

Pytree redesign: :class:`BlockVector` is a frozen pytree of one flat
``jax.Array`` plus *static* field offsets.  Field views are zero-copy
slices; all mutators are functional.  The flat layout is exactly what the
solvers and the distributed layer consume, so a BlockVector drops into
``cg_solve`` / ``DistributedMatrix.matvec`` via ``.values`` with no copies.

The *multi-vector* (many right-hand sides) is deliberately NOT this class:
n_rhs-wide SpMM uses plain ``(n, k)`` arrays (``matmat``), the capability
the reference names as missing (``README.md:83``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sigma_tpu.utils.dtypes import default_real_dtype

__all__ = ["BlockVector"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, repr=False)
class BlockVector:
    """Flat storage + static field partition (the multi-field ``vector``)."""

    values: jax.Array  # (sum(field_sizes),)
    field_sizes: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))

    # -- construction ----------------------------------------------------------
    @classmethod
    def zeros(cls, field_sizes: Sequence[int], dtype=None) -> "BlockVector":
        sizes = tuple(int(s) for s in field_sizes)
        return cls(
            values=jnp.zeros(sum(sizes), dtype=dtype or default_real_dtype()),
            field_sizes=sizes,
        )

    @classmethod
    def from_fields(cls, fields: Sequence) -> "BlockVector":
        arrs = [jnp.asarray(f) for f in fields]
        return cls(
            values=jnp.concatenate(arrs),
            field_sizes=tuple(int(a.shape[0]) for a in arrs),
        )

    @classmethod
    def from_flat(cls, values, field_sizes: Sequence[int]) -> "BlockVector":
        values = jnp.asarray(values)
        sizes = tuple(int(s) for s in field_sizes)
        if values.shape[0] != sum(sizes):
            raise ValueError(
                f"flat length {values.shape[0]} != sum of fields {sum(sizes)}"
            )
        return cls(values=values, field_sizes=sizes)

    # -- meta ------------------------------------------------------------------
    @property
    def num_fields(self) -> int:
        return len(self.field_sizes)

    @property
    def size(self) -> int:
        return sum(self.field_sizes)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.field_sizes)])

    def _slice(self, field: int) -> slice:
        off = self.offsets
        return slice(int(off[field]), int(off[field + 1]))

    # -- access (flat and multi-index, vectors.f90:92-…) -----------------------
    def field(self, field: int) -> jax.Array:
        """Zero-copy view of one field (the field pointer ``ptr(:)``)."""
        return self.values[self._slice(field)]

    def get(self, index: int, field: int = None) -> float:
        if field is None:
            return float(self.values[index])
        return float(self.field(field)[index])

    def _flat_index(self, index, field):
        if field is None:
            return index
        # normalize negative indices WITHIN the field: offsets[field] +
        # (-1) used to wrap to the flat array end and silently write the
        # previous/next field's element (review regression)
        sl = self._slice(field)
        size = sl.stop - sl.start
        if not -size <= index < size:
            raise IndexError(
                f"index {index} out of range for field {field} "
                f"(size {size})"
            )
        return sl.start + (index % size)

    def set(self, index, value, field: int = None) -> "BlockVector":
        flat = self._flat_index(index, field)
        return dataclasses.replace(self, values=self.values.at[flat].set(value))

    def add(self, index, value, field: int = None) -> "BlockVector":
        flat = self._flat_index(index, field)
        return dataclasses.replace(self, values=self.values.at[flat].add(value))

    def with_field(self, field: int, values) -> "BlockVector":
        values = jnp.asarray(values)
        sl = self._slice(field)
        if values.shape[0] != sl.stop - sl.start:
            raise ValueError("field size mismatch")
        return dataclasses.replace(self, values=self.values.at[sl].set(values))

    # -- arithmetic (pytree-friendly) ------------------------------------------
    def __add__(self, other):
        return dataclasses.replace(
            self, values=self.values + self._vals_of(other)
        )

    def __sub__(self, other):
        return dataclasses.replace(
            self, values=self.values - self._vals_of(other)
        )

    def __mul__(self, alpha):
        return dataclasses.replace(self, values=self.values * alpha)

    __rmul__ = __mul__

    def dot(self, other) -> jax.Array:
        return jnp.vdot(self.values, self._vals_of(other))

    def norm(self) -> jax.Array:
        return jnp.linalg.norm(self.values)

    def _vals_of(self, other):
        if isinstance(other, BlockVector):
            if other.field_sizes != self.field_sizes:
                raise ValueError("field partition mismatch")
            return other.values
        return jnp.asarray(other)

    def to_numpy(self) -> np.ndarray:
        return np.asarray(self.values)

    def __repr__(self) -> str:
        return f"BlockVector(fields={self.field_sizes}, dtype={self.dtype})"
