"""Distributed pruned block-DIA: the unstructured flagship format over a
device mesh, plus its multilevel preconditioner.

Row-partitions a banded (RCM-reordered) general matrix into equal shard
blocks; each shard holds its OWN pruned plan (packed active (row-tile x
diagonal) blocks of its row slab, :mod:`sigma_tpu.matrix.pruned_plan`),
padded to a common step count so one shard_map program serves every
shard.  The SpMV communication is two nearest-neighbor ``ppermute``
halo exchanges (the band reach never exceeds a shard), issued before the
local apply so XLA overlaps the halo hop with compute — the same
halo-before-local ordering as :class:`~sigma_tpu.parallel.dist.
DistributedDIAMatrix`.

``distributed_pruned_pair_amg`` builds the 1-D pair-aggregation
hierarchy of :func:`sigma_tpu.solvers.gmg.pruned_pair_amg` with every
level a :class:`DistributedPrunedMatrix`: shard blocks are powers of two
times 128, so pair aggregates never straddle a shard boundary and every
reshape-pair transfer is shard-local under GSPMD; the coarsest dense
inverse is replicated.  Same numerics as the single-device hierarchy
built over the same padded index space (``pad_to=n_pad``) — iteration
parity is asserted in tests and the driver dry run.

This closes the reference's distribution seam for its any-pattern
matrices (``sparse_matrix_composites.f90:1076-1129`` — "This loop can be
parallelized" — over ``cs_matrices.f90:600-622``-class operators): the
strongest unstructured preconditioner in the library now distributes.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from sigma_tpu.matrix.pruned_plan import (
    pruned_matvec_reference,
    pruned_sym_matvec_reference,
)
from sigma_tpu.operators.linear_operator import LinearOperator
from sigma_tpu.parallel.dist import distribute_vector, undistribute_vector

__all__ = [
    "DistributedPrunedMatrix",
    "distribute_pruned",
    "distributed_pruned_pair_amg",
]

_LANES = 128


def _exchange_halos(x_local, Hw, D, axis, *, forward_only=False):
    """(left, right) neighbor halo blocks of a row-sharded local block
    (vector or matrix — leading-axis slices).  Ring wrap at the edge
    shards delivers finite garbage that only ever multiplies
    structurally-zero packed slots; ``forward_only`` (symmetric
    storage: upper windows never read backward x) replaces the left
    hop with zeros.  ONE implementation for all four apply paths
    (review dedup — a halo fix must not need four edits)."""
    zshape = (Hw,) + x_local.shape[1:]
    if D == 1:
        z = jnp.zeros(zshape, x_local.dtype)
        return z, z
    right = lax.ppermute(
        x_local[:Hw], axis, [(sh, (sh - 1) % D) for sh in range(D)]
    )
    if forward_only:
        left = jnp.zeros(zshape, x_local.dtype)
    else:
        left = lax.ppermute(
            x_local[-Hw:], axis, [(sh, (sh + 1) % D) for sh in range(D)]
        )
    return left, right


def _ship_forward(blk, D, axis):
    """Send a block to the NEXT shard on the ring (the mirror-spill
    hop; edge wrap carries exact zeros — no columns exist past n)."""
    return lax.ppermute(blk, axis, [(sh, (sh + 1) % D) for sh in range(D)])


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, repr=False)
class DistributedPrunedMatrix(LinearOperator):
    """Row-sharded pruned block-DIA (see module docstring).

    Leading axes of ``data``/``tile``/``first``/``rowoff``/``laneoff``
    are sharded over ``mesh[axis]``; each shard's slice is its local
    plan (padded to the common ``Lmax`` steps with zero-value slots).
    Local matrices are rectangular ``(block, block + 2*halo_words)``:
    column index ``c_loc = c_global - shard_start + halo_words``.
    """

    data: jax.Array  # (D*Lmax, C, T, 128)
    tile: jax.Array  # (D*Lmax,)
    first: jax.Array  # (D*Lmax,)
    rowoff: jax.Array  # (D*Lmax*C,)
    laneoff: jax.Array  # (D*Lmax*C,)
    mesh: Mesh = dataclasses.field(metadata=dict(static=True))
    axis: str = dataclasses.field(metadata=dict(static=True))
    n: int = dataclasses.field(metadata=dict(static=True))
    block: int = dataclasses.field(metadata=dict(static=True))
    halo_words: int = dataclasses.field(metadata=dict(static=True))
    halo_E: int = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))
    # optional transpose plan (distribute_pruned(with_transpose=True)):
    # per-shard plans of the local (block + 2*halo, block) transposed
    # blocks; rmatvec needs them (pytree children, None otherwise)
    tdata: jax.Array = None
    ttile: jax.Array = None
    tfirst: jax.Array = None
    trowoff: jax.Array = None
    tlaneoff: jax.Array = None
    t_halo_E: int = dataclasses.field(metadata=dict(static=True), default=0)
    # symmetric=True: shards pack only their UPPER-triangle (global
    # c >= r) entries; apply = the symmetric pruned reference with
    # sym_shift=Hw, one forward x-halo ppermute in, one mirror-spill
    # ppermute out (see distribute_pruned(symmetric=True))
    symmetric: bool = dataclasses.field(
        metadata=dict(static=True), default=False
    )

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    @property
    def n_shards(self) -> int:
        return self.mesh.shape[self.axis]

    @property
    def n_pad(self) -> int:
        return self.block * self.n_shards

    @property
    def dtype(self):
        return self.data.dtype

    def astype(self, dtype) -> "DistributedPrunedMatrix":
        """Cast the packed VALUES only (bf16 halves each shard's
        dominant value stream; iterate vectors keep the caller's dtype).
        The transpose plan, when present, is cast too so forward and
        transpose applies run at the same precision."""
        return dataclasses.replace(
            self,
            data=self.data.astype(dtype),
            tdata=None if self.tdata is None else self.tdata.astype(dtype),
        )

    def _matvec_sym(self, x: jax.Array) -> jax.Array:
        """Symmetric-storage distributed SpMV: each shard applies its
        upper-triangle pruned plan with the mirror pass
        (``sym_shift=Hw``), then ships the mirror SPILL (contributions
        past its last row) to the NEXT shard on the ring — upper
        storage reads only the FORWARD x halo, so the two x-halo hops
        of the full layout become one x hop plus one spill hop (same
        total words, half the packed value stream)."""
        D = self.n_shards
        Hw = self.halo_words
        blk = self.block
        C, T = self.data.shape[1], self.data.shape[2]
        E = self.halo_E
        EL = E * _LANES
        kw = dict(
            T=T, E=E, C=C, n=blk, m=blk + 2 * Hw, sym_shift=Hw,
        )

        def local(x_local, data, tile, first, ro, lo_):
            left, right = _exchange_halos(
                x_local, Hw, D, self.axis, forward_only=True
            )
            x_ext = jnp.concatenate([left, x_local, right])
            y, spill = pruned_sym_matvec_reference(
                data, x_ext, tile, ro, lo_, with_spill=True, **kw
            )
            if D > 1:
                # mirror contributions to the NEXT shard's head rows
                # (EL <= T*128 <= block always)
                y = y.at[:EL].add(_ship_forward(spill, D, self.axis))
            return y

        f = shard_map(
            local,
            mesh=self.mesh,
            in_specs=(
                P(self.axis), P(self.axis), P(self.axis), P(self.axis),
                P(self.axis), P(self.axis),
            ),
            out_specs=P(self.axis),
        )
        return f(
            x, self.data, self.tile, self.first, self.rowoff, self.laneoff
        )

    def _matmat_sym(self, X: jax.Array) -> jax.Array:
        D = self.n_shards
        Hw = self.halo_words
        blk = self.block
        C, T = self.data.shape[1], self.data.shape[2]
        E = self.halo_E
        EL = E * _LANES
        kw = dict(
            T=T, E=E, C=C, n=blk, m=blk + 2 * Hw, sym_shift=Hw,
        )

        def local(X_local, data, tile, first, ro, lo_):
            left, right = _exchange_halos(
                X_local, Hw, D, self.axis, forward_only=True
            )
            XT = jnp.concatenate([left, X_local, right], axis=0).T
            Y, spill = jax.vmap(
                lambda xt: pruned_sym_matvec_reference(
                    data, xt, tile, ro, lo_, with_spill=True, **kw
                )
            )(XT)
            if D > 1:
                Y = Y.at[:, :EL].add(_ship_forward(spill, D, self.axis))
            return Y.T

        f = shard_map(
            local,
            mesh=self.mesh,
            in_specs=(
                P(self.axis), P(self.axis), P(self.axis), P(self.axis),
                P(self.axis), P(self.axis),
            ),
            out_specs=P(self.axis),
        )
        return f(
            X, self.data, self.tile, self.first, self.rowoff, self.laneoff
        )

    def matvec(self, x: jax.Array) -> jax.Array:
        if self.symmetric:
            return self._matvec_sym(x)
        D = self.n_shards
        Hw = self.halo_words
        C, T = self.data.shape[1], self.data.shape[2]
        kw = dict(
            T=T, E=self.halo_E, C=C, n=self.block,
            m=self.block + 2 * Hw,
        )

        def local(x_local, data, tile, first, ro, lo_):
            # nearest-neighbor halos FIRST (no dependency on the local
            # work -> XLA overlaps the halo hop with the local compute)
            left, right = _exchange_halos(x_local, Hw, D, self.axis)
            x_ext = jnp.concatenate([left, x_local, right])
            return pruned_matvec_reference(data, x_ext, tile, ro, lo_, **kw)

        f = shard_map(
            local,
            mesh=self.mesh,
            in_specs=(
                P(self.axis), P(self.axis), P(self.axis), P(self.axis),
                P(self.axis), P(self.axis),
            ),
            out_specs=P(self.axis),
        )
        return f(
            x, self.data, self.tile, self.first, self.rowoff, self.laneoff
        )

    def matmat(self, X: jax.Array) -> jax.Array:
        """Distributed multi-RHS apply: ``X`` is (n_pad, k) row-sharded;
        the halo exchange ships (halo_words, k) blocks and the local
        compute runs the pruned SpMM (packed values streamed once for
        all k) — block solvers (block_cg_solve) work unchanged over the
        mesh."""
        if self.symmetric:
            return self._matmat_sym(X)
        D = self.n_shards
        Hw = self.halo_words
        C, T = self.data.shape[1], self.data.shape[2]
        kw = dict(
            T=T, E=self.halo_E, C=C, n=self.block,
            m=self.block + 2 * Hw,
        )

        def local(X_local, data, tile, first, ro, lo_):
            left, right = _exchange_halos(X_local, Hw, D, self.axis)
            XT = jnp.concatenate([left, X_local, right], axis=0).T
            return jax.vmap(
                lambda xt: pruned_matvec_reference(
                    data, xt, tile, ro, lo_, **kw
                )
            )(XT).T

        f = shard_map(
            local,
            mesh=self.mesh,
            in_specs=(
                P(self.axis), P(self.axis), P(self.axis), P(self.axis),
                P(self.axis), P(self.axis),
            ),
            out_specs=P(self.axis),
        )
        return f(
            X, self.data, self.tile, self.first, self.rowoff, self.laneoff
        )

    def rmatvec(self, x: jax.Array) -> jax.Array:
        """Transpose apply: each shard applies its local transposed
        block (the pre-built transpose plan) producing contributions to
        its own columns PLUS the two halo column ranges, which ship to
        the owning neighbors on REVERSED rings and are added there (the
        gather/scatter duality of ``cs_matrices.f90:148-149`` at the
        distributed layout level).  Requires
        ``distribute_pruned(..., with_transpose=True)``."""
        if self.symmetric:
            return self._matvec_sym(x)
        if self.tdata is None:
            raise NotImplementedError(
                "distributed rmatvec needs the transpose plan: build "
                "the matrix with distribute_pruned(..., "
                "with_transpose=True)"
            )
        D = self.n_shards
        Hw = self.halo_words
        blk = self.block
        C, T = self.tdata.shape[1], self.tdata.shape[2]
        kw = dict(
            T=T, E=self.t_halo_E, C=C, n=blk + 2 * Hw, m=blk,
        )

        def local(x_local, data, tile, first, ro, lo_):
            z = pruned_matvec_reference(data, x_local, tile, ro, lo_, **kw)
            y = z[Hw : Hw + blk]
            if D > 1:
                # head: contributions to the PREVIOUS shard's tail
                # columns; tail: to the NEXT shard's head columns.
                # Edge wraps carry exact zeros (no entries exist beyond
                # the global index range, so those plan slots are 0).
                from_next = lax.ppermute(
                    z[:Hw], self.axis,
                    [(s, (s - 1) % D) for s in range(D)],
                )
                from_prev = lax.ppermute(
                    z[Hw + blk :], self.axis,
                    [(s, (s + 1) % D) for s in range(D)],
                )
                y = y.at[blk - Hw :].add(from_next)
                y = y.at[:Hw].add(from_prev)
            return y

        f = shard_map(
            local,
            mesh=self.mesh,
            in_specs=(
                P(self.axis), P(self.axis), P(self.axis), P(self.axis),
                P(self.axis), P(self.axis),
            ),
            out_specs=P(self.axis),
        )
        return f(
            x, self.tdata, self.ttile, self.tfirst, self.trowoff,
            self.tlaneoff,
        )

    def diagonal(self) -> jax.Array:
        """Main-diagonal entries as a sharded (n_pad,) vector (host
        extraction at setup time is the intended path; this exists for
        operator-generic preconditioners)."""
        raise NotImplementedError(
            "extract the diagonal from the COO triples at setup time"
        )

    def shard_vector(self, x) -> jax.Array:
        return distribute_vector(x, self.mesh, self.axis, self.n_pad)

    def unshard_vector(self, x: jax.Array) -> np.ndarray:
        return undistribute_vector(x, self.n)

    def __repr__(self) -> str:
        return (
            f"DistributedPrunedMatrix(n={self.n}, shards={self.n_shards}, "
            f"block={self.block}, halo={self.halo_words}, "
            f"steps/shard={self.data.shape[0] // self.n_shards})"
        )


def _next_pow2(v: int) -> int:
    return 1 << max(int(v) - 1, 0).bit_length()


def distribute_pruned(
    n,
    rows,
    cols,
    vals,
    mesh: Mesh,
    *,
    axis: str = "rows",
    tile_rows: int = 16384,
    group: int | None = None,
    block: int | None = None,
    dtype=None,
    assume_unique: bool = False,
    with_transpose: bool = False,
    symmetric: bool = False,
    validate: bool = True,
) -> DistributedPrunedMatrix:
    """Build a row-sharded pruned matrix from (RCM-ordered) COO triples.

    ``block`` (rows per shard) defaults to the smallest power-of-two
    multiple of 128 covering ``ceil(n / n_shards)`` — the power-of-two
    choice keeps pair-aggregation levels shard-aligned
    (:func:`distributed_pruned_pair_amg`).  The band reach must not
    exceed ``block`` (one-neighbor halo exchange).  Pass
    ``with_transpose=True`` to also build the per-shard transposed
    plans, enabling :meth:`DistributedPrunedMatrix.rmatvec`.

    ``symmetric=True`` packs only the upper triangle per shard (half
    the per-shard value stream; apply = the symmetric reference with a
    forward mirror-spill ppermute, see :meth:`DistributedPrunedMatrix.
    _matvec_sym`); pass FULL both-triangle triples — ``validate``
    (default on) checks numeric symmetry on the host, disable it for
    known-symmetric large assemblies.
    """
    from sigma_tpu.matrix.pruned_plan import build_pruned_plan

    D = mesh.shape[axis]
    rows = np.asarray(rows, dtype=np.int64).ravel()
    cols = np.asarray(cols, dtype=np.int64).ravel()
    vals = np.asarray(vals).ravel()
    dt = jnp.dtype(dtype or vals.dtype)
    if dt == jnp.float64 and not jax.config.read("jax_enable_x64"):
        dt = jnp.dtype(jnp.float32)
    if symmetric and with_transpose:
        raise ValueError(
            "symmetric storage needs no transpose plan (rmatvec = matvec)"
        )
    if group is None:
        # the single-device defaults (PrunedDIAMatrix.from_coo)
        if symmetric:
            group = 12
        else:
            group = 16 if dt == jnp.bfloat16 else 8
    # bf16 targets: build plans in f32 (the C++ fast path), cast on device
    plan_dt = np.dtype(np.float32) if dt == jnp.bfloat16 else np.dtype(dt)
    n = int(n)
    if block is None:
        # floor 1024: the pruned plan's minimum tile (8 sublanes x 128)
        block = max(128 * _next_pow2(-(-n // (D * 128))), 1024)
    if block % 1024:
        raise ValueError("block must be a multiple of 1024 (minimum tile)")
    offs = cols - rows
    reach = int(max(offs.max(initial=0), -offs.min(initial=0)))
    Hw = (reach // _LANES + 1) * _LANES
    # guard on the actual EXCHANGED width (Hw, lane-rounded), not the raw
    # reach: any reach in (block-127, block] rounds Hw above block and
    # x_local[-Hw:] would under-deliver rows — an opaque trace-time shape
    # error instead of this message
    if Hw > block:
        raise ValueError(
            f"band reach {reach} (halo width {Hw}) exceeds the shard "
            f"block {block}: halo exchange is nearest-neighbor only — "
            "raise block or reduce bandwidth (RCM)"
        )
    tr = min(tile_rows, block)

    if symmetric:
        # the symmetric apply's cross-shard mirror SPILL is emitted for
        # rows past the last TILE, so tiles must align with the shard
        # block exactly (G*T*128 == block) — otherwise mirror
        # contributions landing between block and the tile end would be
        # silently dropped.  Round tr down to the largest multiple of
        # 1024 that DIVIDES block (review fix: a pure power-of-two
        # rounding spuriously rejected legal non-pow2 blocks like 3072).
        for d in range(tr // 1024, 0, -1):
            if block % (d * 1024) == 0:
                tr = d * 1024
                break
        if validate:
            from sigma_tpu.matrix.pruned import check_symmetric_triples

            check_symmetric_triples(n, rows, cols, vals)
        keep = cols >= rows
        rows, cols, vals = rows[keep], cols[keep], vals[keep]

    order = np.argsort(rows // block, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    bounds = np.searchsorted(rows // block, np.arange(D + 1))
    plans = []
    for s in range(D):
        sl = slice(bounds[s], bounds[s + 1])
        plans.append(
            build_pruned_plan(
                block, block + 2 * Hw,
                rows[sl] - s * block,
                cols[sl] - s * block + Hw,
                vals[sl],
                tile_rows=tr, group=group, dtype=plan_dt,
                min_reach=reach + Hw,
            )
        )
    T, E, C = plans[0].T, plans[0].E, plans[0].C
    assert all((p.T, p.E, p.C) == (T, E, C) for p in plans)
    if symmetric and (T * _LANES > block or block % (T * _LANES)):
        # the plan widened T past the shard block (band reach needs a
        # halo the requested tile cannot hold): the mirror spill would
        # no longer align with the shard boundary — fail loudly instead
        # of dropping cross-shard contributions
        raise ValueError(
            f"band reach {reach} forces {T * _LANES}-row tiles, which "
            f"do not tile the shard block {block}: raise block (or "
            "reduce bandwidth) for symmetric distributed storage"
        )
    Lmax = max(p.L for p in plans)
    G = -(-(block // _LANES) // T)
    data = np.zeros((D * Lmax, C, T, _LANES), plan_dt)
    tile = np.full(D * Lmax, G - 1, np.int32)
    first = np.zeros(D * Lmax, np.int32)
    rowoff = np.full(D * Lmax * C, E, np.int32)
    laneoff = np.zeros(D * Lmax * C, np.int32)
    for s, p in enumerate(plans):
        data[s * Lmax : s * Lmax + p.L] = p.data.reshape(p.L, C, T, _LANES)
        tile[s * Lmax : s * Lmax + p.L] = p.tile
        first[s * Lmax : s * Lmax + p.L] = p.first
        rowoff[s * Lmax * C : s * Lmax * C + p.L * C] = p.rowoff
        laneoff[s * Lmax * C : s * Lmax * C + p.L * C] = p.laneoff

    shard = NamedSharding(mesh, P(axis))
    if assume_unique:
        n_stored = rows.size
        n_diag = int((rows == cols).sum())
    else:
        key = rows * np.int64(n) + cols
        uk = np.unique(key)
        n_stored = int(uk.size)
        n_diag = int((uk // n == uk % n).sum())
    # symmetric: stored = upper incl. diagonal; nnz counts both triangles
    nnz = 2 * n_stored - n_diag if symmetric else n_stored

    textra = {}
    if with_transpose:
        # per-shard transposed blocks: (block + 2*Hw, block) with
        # entries (c_loc, r_loc) — all offsets r_loc - c_loc are in
        # [-(Hw + reach), -(Hw - reach)], one common reach via min_reach
        tplans = []
        for s_ in range(D):
            sl = slice(bounds[s_], bounds[s_ + 1])
            tplans.append(
                build_pruned_plan(
                    block + 2 * Hw, block,
                    cols[sl] - s_ * block + Hw,
                    rows[sl] - s_ * block,
                    vals[sl],
                    tile_rows=tr, group=group, dtype=plan_dt,
                    min_reach=reach + Hw,
                )
            )
        Tt, Et, Ct = tplans[0].T, tplans[0].E, tplans[0].C
        assert all((p.T, p.E, p.C) == (Tt, Et, Ct) for p in tplans)
        Lt = max(p.L for p in tplans)
        Gt = -(-((block + 2 * Hw) // _LANES) // Tt)
        tdata = np.zeros((D * Lt, Ct, Tt, _LANES), plan_dt)
        ttile = np.full(D * Lt, Gt - 1, np.int32)
        tfirst = np.zeros(D * Lt, np.int32)
        trowoff = np.full(D * Lt * Ct, Et, np.int32)
        tlaneoff = np.zeros(D * Lt * Ct, np.int32)
        for s_, p in enumerate(tplans):
            tdata[s_ * Lt : s_ * Lt + p.L] = p.data.reshape(
                p.L, Ct, Tt, _LANES
            )
            ttile[s_ * Lt : s_ * Lt + p.L] = p.tile
            tfirst[s_ * Lt : s_ * Lt + p.L] = p.first
            trowoff[s_ * Lt * Ct : s_ * Lt * Ct + p.L * Ct] = p.rowoff
            tlaneoff[s_ * Lt * Ct : s_ * Lt * Ct + p.L * Ct] = p.laneoff
        textra = dict(
            tdata=jax.device_put(tdata, shard).astype(dt),
            ttile=jax.device_put(ttile, shard),
            tfirst=jax.device_put(tfirst, shard),
            trowoff=jax.device_put(trowoff, shard),
            tlaneoff=jax.device_put(tlaneoff, shard),
            t_halo_E=int(Et),
        )

    return DistributedPrunedMatrix(
        data=jax.device_put(data, shard).astype(dt),
        tile=jax.device_put(tile, shard),
        first=jax.device_put(first, shard),
        rowoff=jax.device_put(rowoff, shard),
        laneoff=jax.device_put(laneoff, shard),
        mesh=mesh, axis=axis, n=n, block=int(block),
        halo_words=int(Hw), halo_E=int(E),
        nnz=nnz, symmetric=bool(symmetric), **textra,
    )


def distributed_pruned_pair_amg(
    n,
    rows,
    cols,
    vals,
    mesh: Mesh,
    *,
    axis: str = "rows",
    coarse_size: int = 4096,
    omega: float = 2.0 / 3.0,
    n_smooth: int = 1,
    smoother: str = "chebyshev",
    level_dtype=None,
    tile_rows: int = 16384,
    group: int | None = None,
    fine_A: DistributedPrunedMatrix | None = None,
    symmetric: bool = False,
):
    """Distributed 1-D pair-aggregation AMG over COO triples: every level
    a :class:`DistributedPrunedMatrix`, transfers shard-local (see module
    docstring), coarsest dense inverse replicated.  Numerically identical
    to ``pruned_pair_amg(..., pad_to=fine.n_pad)`` — the dry run asserts
    iteration parity."""
    from sigma_tpu.solvers.gmg import (
        StructuredAMGPreconditioner,
        _SLevel,
    )

    if smoother not in ("jacobi", "chebyshev"):
        raise ValueError(f"unknown smoother {smoother!r}")
    if coarse_size > 8192:
        raise ValueError("coarse_size above ~8K is dense-inverted")

    D = mesh.shape[axis]
    rows = np.asarray(rows, dtype=np.int64).ravel()
    cols = np.asarray(cols, dtype=np.int64).ravel()
    vals = np.asarray(vals).ravel()
    dtype = np.dtype(vals.dtype)
    if dtype == np.float64 and not jax.config.read("jax_enable_x64"):
        dtype = np.dtype(np.float32)
        vals = vals.astype(dtype)
    lvl_np = np.dtype(level_dtype) if level_dtype is not None else dtype
    n = int(n)

    if fine_A is not None:
        block = fine_A.block
    else:
        # same 1024 floor as distribute_pruned: a sub-1024 block is
        # below the pruned plan's minimum tile and would silently skip
        # every smoothing level (review regression)
        block = max(128 * _next_pow2(-(-n // (D * 128))), 1024)
    if block & (block - 1) or block % 128:
        raise ValueError("shard block must be a power-of-two multiple of 128")
    n_pad = D * block

    from sigma_tpu.solvers.gmg import _coo_dinv_lmax, _pair_coarsen_coo

    rep = NamedSharding(mesh, P())
    levels = []
    nl, blk = n_pad, block
    r, c, v = rows, cols, vals
    # blk >= 1024: the pruned plan's minimum tile is 8 sublanes x 128
    # lanes; once shard blocks reach 512 the remainder goes to the
    # replicated dense coarse solve (n_shards * 512 rows)
    while nl > coarse_size and blk >= 1024:
        if not levels and fine_A is not None:
            Alvl = fine_A
            if lvl_np != np.dtype(fine_A.data.dtype):
                Alvl = fine_A.astype(lvl_np)
        else:
            # validate=False on symmetric levels: pair Galerkin
            # coarsening preserves the fine level's asserted symmetry.
            # assume_unique on levels > 0: coarsened triples are
            # canonical, skip the per-level dedup sort
            Alvl = distribute_pruned(
                nl, r, c, v, mesh, axis=axis,
                tile_rows=min(tile_rows, blk), group=group,
                block=blk, dtype=lvl_np,
                symmetric=symmetric, validate=False,
                assume_unique=bool(levels),
            )
        dinv, lmax = _coo_dinv_lmax(
            nl, r, c, v, dtype, smoother == "chebyshev"
        )
        levels.append(
            _SLevel(
                A=Alvl,
                dinv=distribute_vector(dinv, mesh, axis, nl),
                dims=(nl,),
                axes=(0,),
                omega=float(omega),
                lmax=None if lmax is None
                else jax.device_put(np.asarray(lmax, dtype), rep),
            )
        )
        nc = nl // 2  # n_pad is a power of two: exact halving every level
        r, c, v = _pair_coarsen_coo(r, c, v, nc, dtype)
        nl, blk = nc, blk // 2

    if nl > coarse_size:
        # the shard-block floor (1024 rows) stopped coarsening BEFORE
        # the requested coarse size: the hierarchy would silently
        # differ from the single-device twin (breaking the parity
        # contract) and, past ~8K, dense-invert an intractable coarse
        # matrix.  Fail loudly with the achievable floor (review fix:
        # the old `nl > 8192` guard let nl == 8192 through silently at
        # 16+ shards).
        raise ValueError(
            f"the {D}-shard 1024-row block floor stops pair-coarsening "
            f"at {nl} rows, above the requested coarse_size "
            f"{coarse_size}: pass coarse_size >= {min(nl, 8192)} "
            f"(<= 8192 — the dense coarse solve's limit) or use fewer "
            f"shards; replicated-tail levels below the block floor are "
            f"not implemented"
        )
    coarse = np.zeros((nl, nl), np.float64)
    coarse[r, c] = v.astype(np.float64)
    coarse += 1e-12 * np.eye(nl)
    cinv = jax.device_put(np.linalg.inv(coarse).astype(dtype), rep)

    return StructuredAMGPreconditioner(
        levels=tuple(levels),
        coarse_inv=cinv,
        n_smooth=n_smooth,
        smoother=smoother,
    )
