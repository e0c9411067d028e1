"""Ising model via multicolor-parallel Metropolis dynamics.

Reference: ``/root/reference/apps/ising.f90`` — sequential single-site
Metropolis sweeps over a graph medium (:140-166: per site, sum neighbor
spins, flip with probability ``min(1, exp(-beta * dE))``), reporting running
magnetization each sweep.  The reference file even carries a commented-out
``greedy_coloring`` call (:124-126) — the parallelization it never did.

Data-parallel redesign: that coloring IS the algorithm here.  Sites of one
color class are mutually non-adjacent, so updating them *simultaneously*
is a valid Metropolis sweep.  One sweep =

    for each color c:  h = A @ s            (ELL SpMV — the local fields)
                       dE = 2 s h           (vectorized, all sites)
                       flip sites of color c where U < exp(-beta * dE)

jit-compiled as a ``lax.fori_loop`` over sweeps with ``jax.random``
counters; the whole simulation runs on device, and the per-sweep cost is
n_colors SpMVs instead of n sequential neighbor gathers.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from sigma_tpu.graph.permutations import greedy_coloring
from sigma_tpu.matrix.formats import ELLMatrix

__all__ = ["ising_metropolis", "IsingResult"]


class IsingResult(NamedTuple):
    spins: jax.Array  # (n,) final +-1 configuration
    magnetization: jax.Array  # (sweeps,) mean spin after each sweep
    num_colors: int


@partial(jax.jit, static_argnames=("sweeps", "n_colors"))
def _run(A, colors, beta, spins0, key, sweeps, n_colors):
    n = spins0.shape[0]

    def sweep(carry, _):
        spins, key = carry

        def color_update(c, sk):
            spins, key = sk
            key, sub = jax.random.split(key)
            h = A.matvec(spins)  # local fields, all sites at once
            dE = 2.0 * spins * h
            accept = jax.random.uniform(sub, (n,)) < jnp.exp(-beta * dE)
            flip = (colors == c) & accept
            return jnp.where(flip, -spins, spins), key

        spins, key = lax.fori_loop(0, n_colors, color_update, (spins, key))
        return (spins, key), jnp.mean(spins)

    (spins, _), mags = lax.scan(sweep, (spins0, key), None, length=sweeps)
    return spins, mags


def ising_metropolis(
    g,
    beta: float = 1.0,
    sweeps: int = 100,
    seed: int = 0,
    hot_start: bool = False,
) -> IsingResult:
    """Run ``sweeps`` multicolor Metropolis sweeps of the Ising model on
    graph ``g`` at inverse temperature ``beta``.

    ``hot_start=False`` matches the reference's all-up initialization
    (``ising.f90:131-137``).
    """
    n = g.shape[0]
    colors_np, n_colors = greedy_coloring(g)
    A = ELLMatrix.from_graph(g, dtype=jnp.float32)
    rows, cols = g.edges_numpy()
    A = A.set_values(rows, cols, np.ones(rows.size, dtype=np.float32))

    key = jax.random.PRNGKey(seed)
    if hot_start:
        key, sub = jax.random.split(key)
        spins0 = jnp.where(
            jax.random.uniform(sub, (n,)) < 0.5, -1.0, 1.0
        ).astype(jnp.float32)
    else:
        spins0 = jnp.ones((n,), dtype=jnp.float32)

    spins, mags = _run(
        A,
        jnp.asarray(colors_np, dtype=jnp.int32),
        jnp.float32(beta),
        spins0,
        key,
        int(sweeps),
        int(n_colors),
    )
    return IsingResult(spins=spins, magnetization=mags, num_colors=int(n_colors))
