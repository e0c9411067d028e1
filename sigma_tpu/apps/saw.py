"""Self-avoiding walks, batched.

Reference: ``/root/reference/apps/self_avoiding_walk.f90`` — repeated trials
of: random start vertex; repeatedly move to a uniformly-chosen unvisited
neighbor until stuck; histogram the walk lengths (:118-160).

Data-parallel redesign: the trials are embarrassingly parallel, so ALL walks
run at once — walker state is a ``(W, n)`` visited matrix plus ``(W,)``
current vertices, a step is one batched ELL-row gather + masked categorical
draw, and the whole ensemble advances in a single ``lax.while_loop`` until
every walker is stuck.  10^4 walkers cost barely more than 1.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from sigma_tpu.graph.graph import ELLGraph

__all__ = ["self_avoiding_walks", "SAWResult"]


class SAWResult(NamedTuple):
    lengths: jax.Array  # (walkers,) number of steps before each got stuck
    histogram: np.ndarray  # (n+1,) counts of walk lengths


@partial(jax.jit, static_argnames=("n", "max_steps"))
def _run(node, degrees, starts, key, n, max_steps):
    W = starts.shape[0]
    width = node.shape[1]

    visited = jnp.zeros((W, n), dtype=bool)
    visited = visited.at[jnp.arange(W), starts].set(True)

    def cond(state):
        _, _, _, alive, _, step = state
        return jnp.logical_and(alive.any(), step < max_steps)

    def body(state):
        cur, visited, lengths, alive, key, step = state
        key, sub = jax.random.split(key)
        nbrs = node[cur]  # (W, width) neighbor candidates
        slot_ok = (
            jnp.arange(width)[None, :] < degrees[cur][:, None]
        )  # real (non-padding) slots
        unvis = ~visited[jnp.arange(W)[:, None], nbrs]
        ok = slot_ok & unvis
        any_ok = ok.any(axis=1)
        # masked uniform choice among ok slots (Gumbel trick)
        gumbel = jax.random.gumbel(sub, (W, width))
        pick = jnp.argmax(jnp.where(ok, gumbel, -jnp.inf), axis=1)
        nxt = nbrs[jnp.arange(W), pick]
        move = alive & any_ok
        cur = jnp.where(move, nxt, cur)
        visited = visited.at[jnp.arange(W), cur].set(True)
        lengths = lengths + move.astype(lengths.dtype)
        alive = move
        return cur, visited, lengths, alive, key, step + 1

    state = (
        starts,
        visited,
        jnp.zeros((W,), dtype=jnp.int32),
        jnp.ones((W,), dtype=bool),
        key,
        jnp.asarray(0, jnp.int32),
    )
    cur, visited, lengths, alive, key, step = lax.while_loop(cond, body, state)
    return lengths


def self_avoiding_walks(g, walkers: int = 10000, seed: int = 0) -> SAWResult:
    """Run ``walkers`` independent self-avoiding walks on ``g``; returns
    per-walk lengths and the length histogram (the reference's output)."""
    n = g.shape[0]
    ell = g if isinstance(g, ELLGraph) else ELLGraph.from_coo(
        n, n, *g.edges_numpy()
    )
    key = jax.random.PRNGKey(seed)
    key, sub = jax.random.split(key)
    starts = jax.random.randint(sub, (walkers,), 0, n)
    lengths = _run(
        ell.cols, ell.degrees, starts, key, int(n), int(n)
    )
    hist = np.bincount(np.asarray(lengths), minlength=n + 1)
    return SAWResult(lengths=lengths, histogram=hist)
