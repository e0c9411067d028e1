"""Interleaved-panel layout for blocks of right-hand sides.

A block of k vectors of length m, held RHS-major as (k, m), is stored
interleaved as (k*ceil(m/128), 128): row ``s*k + j`` holds element-row
``s`` (elements ``s*128 .. s*128+127``, zero-padded past m) of vector j.
``block_cg_solve(..., panels="interleaved")`` keeps its panels in this
layout for the whole loop and applies ``A.matmat_interleaved``.  Each
conversion is one XLA transpose: do it once per solve, not per product.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

__all__ = [
    "interleave_panels",
    "deinterleave_panels",
    "interleave_panels_grouped",
    "deinterleave_panels_grouped",
]

_LANES = 128


@functools.partial(jax.jit, static_argnames=("m",))
def interleave_panels(XT, m=None):
    """(k, m) RHS-major panels -> interleaved (k*ceil(m/128), 128)."""
    k, m_in = XT.shape
    m = m_in if m is None else m
    if m < m_in:
        raise ValueError(f"m={m} smaller than the panel width {m_in}")
    Sx = -(-m // _LANES)
    # pad from the INPUT width to the lane-rounded target
    if Sx * _LANES != m_in:
        XT = jnp.concatenate(
            [XT, jnp.zeros((k, Sx * _LANES - m_in), XT.dtype)], axis=1
        )
    return jnp.transpose(XT.reshape(k, Sx, _LANES), (1, 0, 2)).reshape(
        k * Sx, _LANES
    )


@functools.partial(jax.jit, static_argnames=("k", "n"))
def deinterleave_panels(YI, k, n):
    """Inverse of :func:`interleave_panels`: (k*S, 128) -> (k, n)."""
    S = YI.shape[0] // k
    return jnp.transpose(YI.reshape(S, k, _LANES), (1, 0, 2)).reshape(
        k, S * _LANES
    )[:, :n]


@functools.partial(jax.jit, static_argnames=("kb", "m"))
def interleave_panels_grouped(XT, kb, m=None):
    """(k, m) RHS-major panels -> grouped-interleaved (KO, kb*Sx, 128):
    group j's slab is ``interleave_panels(XT[j*kb:(j+1)*kb])``.  k is
    zero-padded up to KO*kb panels, m up to Sx*128 elements."""
    k, m_in = XT.shape
    m = m_in if m is None else m
    Sx = -(-m // _LANES)
    KO = -(-k // kb)
    if Sx * _LANES != m_in:
        XT = jnp.concatenate(
            [XT, jnp.zeros((k, Sx * _LANES - m_in), XT.dtype)], axis=1
        )
    if KO * kb != k:
        XT = jnp.concatenate(
            [XT, jnp.zeros((KO * kb - k, Sx * _LANES), XT.dtype)], axis=0
        )
    return jnp.transpose(
        XT.reshape(KO, kb, Sx, _LANES), (0, 2, 1, 3)
    ).reshape(KO, kb * Sx, _LANES)


@functools.partial(jax.jit, static_argnames=("kb", "k", "n"))
def deinterleave_panels_grouped(YG, kb, k, n):
    """Inverse of :func:`interleave_panels_grouped`: (KO, kb*S, 128) ->
    (k, n) RHS-major panels (padding groups/rows trimmed)."""
    KO = YG.shape[0]
    S = YG.shape[1] // kb
    out = jnp.transpose(
        YG.reshape(KO, S, kb, _LANES), (0, 2, 1, 3)
    ).reshape(KO * kb, S * _LANES)
    return out[:k, :n]
