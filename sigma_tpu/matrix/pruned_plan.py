"""Packed layout of :class:`~sigma_tpu.matrix.pruned.PrunedDIAMatrix`.

After an RCM reorder an irregular mesh has a band that is globally wide
(hundreds of diagonals) but locally narrow.  The pruned layout keeps only
the ACTIVE (row-tile, diagonal) blocks, packed linearly as
``data[slot, T, 128]`` in (tile, offset) order, so the value stream is
exactly the compacted size.  :func:`build_pruned_plan` packs COO triples
into that layout on the host; :func:`pruned_matvec_reference` and
:func:`pruned_sym_matvec_reference` apply it as whole-array XLA programs
(one gather of x per packed slot, segment-sum by row tile).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "PrunedPlan",
    "build_pruned_plan",
    "pruned_matvec_reference",
    "pruned_sym_matvec_reference",
]

_LANES = 128


class PrunedPlan:
    """Host-side product of :func:`build_pruned_plan` — the packed value
    array plus the per-step tile and per-slot window arrays.  Plain numpy;
    the matrix class owns moving these to device."""

    __slots__ = (
        "data", "tile", "first", "rowoff", "laneoff",
        "T", "E", "C", "L", "n", "m", "n_slots_active",
    )

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw[k])


def _pick_halo(T: int, hrows: int):
    """Halo block height E (sublane rows): smallest multiple of 8 that
    covers the band's one-sided reach and tiles T exactly (E | T), or
    E == T when the reach needs the whole-tile halo.  None when the
    reach exceeds one tile — callers must raise T."""
    for e in range(8, T + 1, 8):
        if e >= hrows and T % e == 0:
            return e
    if T >= hrows:
        return T
    return None


def build_pruned_plan(
    n, m, rows, cols, vals, *, tile_rows=16384, group=8, dtype=np.float32,
    min_reach=0,
) -> PrunedPlan:
    """Pack COO entries into the pruned block-DIA layout.

    ``tile_rows``: pruning granularity (rows per tile; multiple of 1024).
    Finer tiles store fewer zeros but index more slots.
    ``group``: slots per step (per-tile slot counts are padded up to a
    multiple; padding slots hold zero values, so they are numerically
    inert).

    Ordering contract: slots are sorted by (tile, diagonal offset), the
    same per-row accumulation order as :class:`DIAMatrix`'s window loop.

    ``min_reach``: floor on the band reach used to size the halo (E) —
    the distributed layer passes a mesh-global reach so every shard's
    plan shares one (T, E, C) and stacks into a single shard_map
    program.
    """
    if tile_rows % 1024:
        raise ValueError("tile_rows must be a multiple of 1024")
    rows = np.asarray(rows, dtype=np.int64).ravel()
    cols = np.asarray(cols, dtype=np.int64).ravel()
    vals = np.asarray(vals).ravel()
    n, m = int(n), int(m if m is not None else n)
    offs = cols - rows
    reach = int(max(offs.max(initial=0), -offs.min(initial=0), min_reach))
    hrows = reach // _LANES + 2
    T = tile_rows // _LANES
    while _pick_halo(T, hrows) is None:
        T *= 2  # band reach exceeds the tile: widen until the halo fits
    E = _pick_halo(T, hrows)
    C = int(group)
    S = -(-n // _LANES)  # sublane rows of y
    G = -(-S // T)  # row tiles

    if np.dtype(dtype) == np.float32:
        # C++ fast path: radix sort + one-pass fill (the numpy
        # np.unique/scatter construction below is sort-bound at 10M rows)
        from sigma_tpu import native

        packed = native.pack_pruned(
            rows, cols, vals, tile_rows=T * _LANES, group=C, reach=reach,
            n_tiles=G, E=E,
        )
        if packed is not None:
            data, tile, first, rowoff, laneoff, L, n_active = packed
            return PrunedPlan(
                data=data.reshape(L * C, T, _LANES), tile=tile,
                first=first, rowoff=rowoff, laneoff=laneoff,
                T=T, E=E, C=C, L=L, n=n, m=m,
                n_slots_active=n_active,
            )

    tile_of = rows // (T * _LANES)
    # unique (tile, offset) pairs in (tile, offset) order
    key = tile_of * (4 * (reach + 1) + 1) + (offs + reach)
    ukey, inv = np.unique(key, return_inverse=True)
    utile = ukey // (4 * (reach + 1) + 1)
    uoff = ukey % (4 * (reach + 1) + 1) - reach
    # slot index per unique pair, padded per tile to a multiple of C;
    # tiles with no active pair still get one (all-padding) step
    cnt = np.bincount(utile, minlength=G)
    steps = np.maximum(-(-cnt // C), 1)
    slot_base = np.concatenate([[0], np.cumsum(steps * C)])[:-1]
    L = int(steps.sum())
    Lc = L * C
    within = np.arange(ukey.size) - np.concatenate([[0], np.cumsum(cnt)])[:-1][utile]
    uslot = slot_base[utile] + within

    rowoff = np.full(Lc, E, dtype=np.int32)  # padding slots: offset 0
    laneoff = np.zeros(Lc, dtype=np.int32)
    q = E * _LANES + uoff
    rowoff[uslot] = (q // _LANES).astype(np.int32)
    laneoff[uslot] = (q % _LANES).astype(np.int32)

    step_tile = np.repeat(np.arange(G, dtype=np.int32), steps)
    first = np.zeros(L, dtype=np.int32)
    first[np.concatenate([[0], np.cumsum(steps)])[:-1]] = 1

    data = np.zeros((Lc, T, _LANES), dtype=dtype)
    r_local = rows - tile_of * (T * _LANES)
    flat = uslot[inv] * (T * _LANES) + r_local
    data.reshape(-1)[flat] = vals.astype(dtype)

    return PrunedPlan(
        data=data, tile=step_tile, first=first,
        rowoff=rowoff, laneoff=laneoff,
        T=T, E=E, C=C, L=L, n=n, m=m, n_slots_active=int(ukey.size),
    )


def pruned_matvec_reference(
    data, x, tile, rowoff, laneoff, *, T, E, C, n, m
):
    """Gather-based pruned SpMV (jit-safe): one gather of x per packed
    slot, a sum over each step's ``C`` slots and a segment-sum by row
    tile.  The apply of :class:`sigma_tpu.matrix.pruned.PrunedDIAMatrix`
    and of each shard of the distributed pruned layout."""
    L, C_, T_, _ = data.shape
    assert (C_, T_) == (C, T)
    S = -(-n // _LANES)
    G = -(-S // T)
    o = (rowoff.astype(jnp.int32) - np.int32(E)) * np.int32(_LANES) + (
        laneoff.astype(jnp.int32)
    )
    # int32 is exact here for any n, m < 2**31 (idx max = m + reach)
    starts = jnp.repeat(tile.astype(jnp.int32), C) * np.int32(T * _LANES)
    idx = (
        starts[:, None]
        + jnp.arange(T * _LANES, dtype=jnp.int32)[None, :]
        + o[:, None]
    )
    ok = (idx >= 0) & (idx < m)
    xg = jnp.where(ok, x[jnp.clip(idx, 0, m - 1)], jnp.zeros((), x.dtype))
    contrib = data.reshape(L * C, T * _LANES).astype(x.dtype) * xg
    per_step = contrib.reshape(L, C, T * _LANES).sum(axis=1)
    y = jax.ops.segment_sum(per_step, tile, num_segments=G)
    return y.reshape(-1)[:n]


def pruned_sym_matvec_reference(
    data, x, tile, rowoff, laneoff, *, T, E, C, n, m, sym_shift=0,
    with_spill=False,
):
    """Gather/scatter reference for the SYMMETRIC pruned SpMV (any
    backend; jit-safe): the upper/main pass of
    :func:`pruned_matvec_reference` plus a scatter-add mirror pass
    (``y[i + om] += d[i] * x[i + sym_shift]`` for mirror offsets
    ``om = offset - sym_shift > 0``).  The apply of
    :class:`sigma_tpu.matrix.pruned.SymmetricPrunedDIAMatrix`.  Returns the FULL y (spill
    folded); with ``with_spill=True`` returns ``(y, spill)`` where
    ``spill`` (E*128,) holds the mirror contributions past row ``n``
    — the distributed layer's cross-shard halo."""
    L, C_, T_, _ = data.shape
    assert (C_, T_) == (C, T)
    EL = E * _LANES
    o = (rowoff.astype(jnp.int32) - np.int32(E)) * np.int32(_LANES) + (
        laneoff.astype(jnp.int32)
    )
    starts = jnp.repeat(tile.astype(jnp.int32), C) * np.int32(T * _LANES)
    ar = jnp.arange(T * _LANES, dtype=jnp.int32)[None, :]
    y = pruned_matvec_reference(
        data, x, tile, rowoff, laneoff, T=T, E=E, C=C, n=n, m=m
    )
    d = data.reshape(L * C, T * _LANES).astype(x.dtype)
    om = o - np.int32(sym_shift)
    zidx = starts[:, None] + ar + np.int32(sym_shift)
    okz = (zidx >= 0) & (zidx < m) & (om[:, None] > 0)
    z = d * jnp.where(
        okz, x[jnp.clip(zidx, 0, m - 1)], jnp.zeros((), x.dtype)
    )
    out_idx = starts[:, None] + ar + om[:, None]
    oko = okz & (out_idx >= 0) & (out_idx < n + EL)
    ym = jnp.zeros((n + EL,), x.dtype).at[
        jnp.clip(out_idx, 0, n + EL - 1).ravel()
    ].add(jnp.where(oko, z, jnp.zeros((), x.dtype)).ravel())
    if with_spill:
        return y + ym[:n], ym[n:]
    return y + ym[:n]
