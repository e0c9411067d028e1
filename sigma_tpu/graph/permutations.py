"""Vertex reordering algorithms (host-side, build-time).

Mirrors ``/root/reference/src/graph/permutations.f90``:
``breadth_first_search`` (:22, Cuthill-McKee-style level order),
``greedy_coloring`` (:83) and ``greedy_color_ordering`` (:167).  Here
these are pure numpy build-time utilities; their product — multicolor
orderings — is what turns the strictly sequential incomplete-factorization
triangular sweeps (``ldu_solvers.f90:208-253``) into batched per-color
parallel updates (see :mod:`sigma_tpu.solvers.ildu`).

Convention: every permutation ``p`` returned here is in *scatter* form —
``p[i]`` is the new label of old vertex ``i`` — matching the reference's
``left_permute``/``right_permute`` inputs.
"""

from __future__ import annotations

from collections import deque
from typing import Tuple

import numpy as np

__all__ = [
    "breadth_first_search",
    "reverse_cuthill_mckee",
    "greedy_coloring",
    "greedy_color_ordering",
]


def _adjacency(g) -> Tuple[np.ndarray, np.ndarray]:
    """CSR (indptr, indices) of a square graph, as numpy."""
    from sigma_tpu.graph.graph import CSRGraph, host_csr

    n, m = g.shape
    if n != m:
        raise ValueError("reordering requires a square graph")
    if isinstance(g, CSRGraph):
        # the stored layout IS the row-major CSR view — skip the
        # edges_numpy + lexsort round trip (fault-bound at 1M+ rows)
        indptr = np.asarray(g.indptr, dtype=np.int64)
        indices = np.asarray(g.indices, dtype=np.int64)[: g.nnz]
        return indptr, indices
    rows, cols = g.edges_numpy()
    return host_csr(rows, cols, n)


def breadth_first_search(g, start: int = 0) -> np.ndarray:
    """BFS level ordering (permutations.f90:22).

    Visits vertices breadth-first from ``start`` (restarting at the lowest
    unvisited vertex for disconnected graphs) and returns ``p`` with ``p[i]``
    the BFS visit rank of vertex ``i`` — the Cuthill-McKee-style bandwidth
    reducing relabeling.
    """
    n = g.shape[0]
    indptr, indices = _adjacency(g)
    from sigma_tpu import native

    res = native.bfs_order(indptr, indices, start)
    if res is not None:
        return res
    p = np.full(n, -1, dtype=np.int64)
    rank = 0
    q: deque[int] = deque()
    # first component from `start`, then the LOWEST unvisited vertex —
    # the documented (and native-path) restart order (review fix: the
    # fallback used a rotated order for start > 0, and the native fast
    # path was gated to start == 0 although the C++ accepts any start)
    for s in [start] + list(range(n)):
        if p[s] >= 0:
            continue
        p[s] = rank
        rank += 1
        q.append(s)
        while q:
            u = q.popleft()
            for v in indices[indptr[u] : indptr[u + 1]]:
                if p[v] < 0:
                    p[v] = rank
                    rank += 1
                    q.append(int(v))
    return p


def reverse_cuthill_mckee(g) -> np.ndarray:
    """Reverse Cuthill-McKee bandwidth-reducing permutation (scatter form).

    BFS from a minimum-degree vertex per component, visiting neighbors in
    ascending-degree order, with the final ranks reversed — the standard
    sharpening of the plain BFS ordering the reference provides
    (``permutations.f90:22``); typically a tighter band for the
    banded-DIA recipe (:func:`sigma_tpu.matrix.banded.to_banded_dia`).
    Runs in the compiled core with a numpy fallback.
    """
    n = g.shape[0]
    indptr, indices = _adjacency(g)
    from sigma_tpu import native

    res = native.rcm_order(indptr, indices)
    if res is not None:
        return res
    deg = indptr[1:] - indptr[:-1]
    p = np.full(n, -1, dtype=np.int64)
    rank = 0
    # components in order of their minimum-degree vertex
    for s in np.lexsort((np.arange(n), deg)):
        if p[s] >= 0:
            continue
        q: deque[int] = deque([int(s)])
        p[s] = rank
        rank += 1
        while q:
            u = q.popleft()
            nbrs = indices[indptr[u] : indptr[u + 1]]
            nbrs = nbrs[p[nbrs] < 0]
            # ascending degree, ties by vertex id (matches the C++ core)
            for v in nbrs[np.lexsort((nbrs, deg[nbrs]))]:
                if p[v] < 0:
                    p[v] = rank
                    rank += 1
                    q.append(int(v))
        # ranks assigned at push time, matching the C++?  No: the C++
        # assigns at POP time — but push order == pop order in a FIFO
        # queue seeded one component at a time, so the labels agree.
    return (n - 1) - p  # reverse


def greedy_coloring(g) -> Tuple[np.ndarray, int]:
    """Greedy vertex coloring (permutations.f90:83).

    Returns (colors, num_colors) with colors in 0..num_colors-1 such that no
    stored edge (i, j), i != j, has colors[i] == colors[j].  The stored
    sparsity is symmetrized first, so the guarantee holds in BOTH
    directions even for nonsymmetric patterns (e.g. triangular factors —
    the multicolor-ILDU use case).
    """
    from sigma_tpu.graph.graph import host_csr

    n = g.shape[0]
    if g.shape[0] != g.shape[1]:
        raise ValueError("coloring requires a square graph")
    r, c = g.edges_numpy()
    indptr, indices = host_csr(
        np.concatenate([r, c]), np.concatenate([c, r]), n
    )
    from sigma_tpu import native

    res = native.greedy_coloring(indptr, indices)
    if res is not None:
        return res
    colors = np.full(n, -1, dtype=np.int64)
    for u in range(n):
        nbr_colors = set(colors[indices[indptr[u] : indptr[u + 1]]].tolist())
        c = 0
        while c in nbr_colors:
            c += 1
        colors[u] = c
    return colors, int(colors.max()) + 1 if n else 0


def greedy_color_ordering(g) -> Tuple[np.ndarray, np.ndarray]:
    """Color-block permutation (permutations.f90:167).

    Returns (p, ptr): ``p`` relabels vertices so that all vertices of color c
    occupy the contiguous new-index range ``[ptr[c], ptr[c+1])``.  Within a
    color, every vertex is independent of every other — the multicolor
    parallel seam.
    """
    colors, nc = greedy_coloring(g)
    counts = np.bincount(colors, minlength=nc)
    ptr = np.zeros(nc + 1, dtype=np.int64)
    np.cumsum(counts, out=ptr[1:])
    # stable order within colors
    order = np.argsort(colors, kind="stable")  # new -> old
    p = np.empty(g.shape[0], dtype=np.int64)
    p[order] = np.arange(g.shape[0])  # old -> new (scatter form)
    return p, ptr
