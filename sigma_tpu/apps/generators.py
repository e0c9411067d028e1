"""Graph generators (the media for the Ising / walk apps).

Mirrors ``/root/reference/apps/regular_graphs.f90`` (``torus:12``,
``petersen:41``, ``flower_snark:70``, ``hypercube:133``) and
``random_graphs.f90`` (``erdos_renyi:16``, ``watts_strogatz:49``,
``barabasi_albert:127``) — re-expressed as vectorized numpy edge-list
constructions (0-based) that freeze directly into any topology format.
"""

from __future__ import annotations

import numpy as np


__all__ = [
    "torus",
    "petersen",
    "flower_snark",
    "hypercube",
    "erdos_renyi",
    "watts_strogatz",
    "barabasi_albert",
    "named_graph",
    "irregular_mesh_laplacian",
    "irregular_mesh_laplacian_coo",
    "laplacian_3d_dia",
]


def _freeze(n, rows, cols, frmt):
    sym_rows = np.concatenate([rows, cols])  # symmetrize
    sym_cols = np.concatenate([cols, rows])
    from sigma_tpu.graph.factory import choose_graph_type

    return choose_graph_type(frmt).from_coo(n, n, sym_rows, sym_cols)


def torus(nx: int, ny: int, frmt="csr"):
    """2-torus grid: each (x, y) joined to (x, y+1) and (x+1, y) mod sizes."""
    x, y = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    i = (x * ny + y).ravel()
    right = (x * ny + (y + 1) % ny).ravel()
    down = (((x + 1) % nx) * ny + y).ravel()
    rows = np.concatenate([i, i])
    cols = np.concatenate([right, down])
    return _freeze(nx * ny, rows, cols, frmt)


def petersen(n: int, k: int, frmt="csr"):
    """Generalized Petersen graph GP(n, k): outer cycle, spokes, inner
    k-step cycle."""
    i = np.arange(n)
    rows = np.concatenate([i, i, i + n])
    cols = np.concatenate([(i + 1) % n, i + n, (i + k) % n + n])
    return _freeze(2 * n, rows, cols, frmt)


def flower_snark(n: int, frmt="csr"):
    """Flower snark J_n on 4n vertices: n stars (A_k center; B, C, D leaves),
    B-cycle, C-path and D-path cross-linked at the ends."""
    k = np.arange(n)
    A, B, C, D = 4 * k, 4 * k + 1, 4 * k + 2, 4 * k + 3
    rows = [A, A, A]  # star edges
    cols = [B, C, D]
    rows.append(B)  # B cycle
    cols.append(np.roll(B, -1))
    rows.append(C[:-1])  # C path
    cols.append(C[1:])
    rows.append(D[:-1])  # D path
    cols.append(D[1:])
    rows.append(np.array([C[-1], D[-1]]))  # cross links C_n-D_1, D_n-C_1
    cols.append(np.array([D[0], C[0]]))
    return _freeze(4 * n, np.concatenate(rows), np.concatenate(cols), frmt)


def hypercube(k: int, frmt="csr"):
    """k-dimensional hypercube on 2^k vertices: i ~ i xor 2^b."""
    n = 2**k
    i = np.repeat(np.arange(n), k)
    b = np.tile(np.arange(k), n)
    j = i ^ (1 << b)
    return _freeze(n, i, j, frmt)


def erdos_renyi(n: int, p: float, rng=None, frmt="csr"):
    """G(n, p): each unordered pair independently with probability p.

    O(E) construction: the edge count is Binomial(C(n,2), p) and the
    edges a uniform sample of distinct pairs — the same distribution as
    the dense triu mask without the O(n^2) random matrix (20 GB at
    n=50K on this page-fault-bound host; review fix).  Small n keeps
    the dense form so existing seeded graphs are reproducible."""
    rng = rng or np.random.default_rng()
    if n <= 4096:
        mask = np.triu(rng.random((n, n)) < p, 1)
        rows, cols = np.nonzero(mask)
        return _freeze(n, rows, cols, frmt)
    n_pairs = n * (n - 1) // 2
    e = int(rng.binomial(n_pairs, min(max(p, 0.0), 1.0)))
    picked = np.empty(0, dtype=np.int64)
    while picked.size < e:
        extra = rng.integers(0, n_pairs, int((e - picked.size) * 1.2) + 8)
        picked = np.unique(np.concatenate([picked, extra]))[: ]
        if picked.size > e:
            picked = rng.permutation(picked)[:e]
            picked.sort()
    # pair index -> (i, j), i < j, via the triangular-number inverse
    i = ((np.sqrt(8.0 * picked + 1.0) - 1.0) / 2.0).astype(np.int64)
    # float inverse can be off by one at the boundaries — correct it
    i = np.where(i * (i + 1) // 2 > picked, i - 1, i)
    i = np.where((i + 1) * (i + 2) // 2 <= picked, i + 1, i)
    j = picked - i * (i + 1) // 2
    # (j, i+1) with j <= i < n: map to (row=j, col=i+1)
    return _freeze(n, j, i + 1, frmt)


def watts_strogatz(n: int, k: int, p: float, rng=None, frmt="csr"):
    """Small-world: ring with k forward neighbors, each edge rewired with
    probability p to a uniform non-duplicate endpoint."""
    rng = rng or np.random.default_rng()
    i = np.repeat(np.arange(n), k)
    j = (i + np.tile(np.arange(1, k + 1), n)) % n
    edges = set(zip(i.tolist(), j.tolist())) | set(zip(j.tolist(), i.tolist()))
    rewire = rng.random(i.size) < p
    for e in np.nonzero(rewire)[0]:
        a, b = int(i[e]), int(j[e])
        edges.discard((a, b))
        edges.discard((b, a))
        # candidate endpoints that keep the graph simple; when a is already
        # adjacent to everything (k >= n-1 saturation) the edge is kept —
        # an unbounded retry loop would hang
        l = b
        for _ in range(4 * n):
            cand = int(rng.integers(n))
            if cand != a and cand != b and (a, cand) not in edges:
                l = cand
                break
        edges.add((a, l))
        edges.add((l, a))
    arr = np.array(sorted(edges), dtype=np.int64).reshape(-1, 2)
    from sigma_tpu.graph.factory import choose_graph_type

    return choose_graph_type(frmt).from_coo(n, n, arr[:, 0], arr[:, 1])


def barabasi_albert(n: int, k: int, rng=None, frmt="csr"):
    """Scale-free preferential attachment: new vertices attach k edges with
    probability proportional to current degree."""
    rng = rng or np.random.default_rng()
    deg = np.zeros(n, dtype=np.int64)
    rows, cols = [], []
    for i in range(k - 1):  # seed path
        rows.append(i)
        cols.append(i + 1)
        deg[i] += 1
        deg[i + 1] += 1
    for i in range(k, n):
        w = deg[:i].astype(float)
        tot = w.sum()
        probs = np.full(i, 1.0 / i) if tot == 0 else w / tot
        targets = rng.choice(i, size=min(k, i), replace=False, p=probs)
        for j in targets:
            rows.append(i)
            cols.append(int(j))
            deg[i] += 1
            deg[j] += 1
    return _freeze(n, np.array(rows), np.array(cols), frmt)


def irregular_mesh_laplacian(
    H: int, W: int, rng=None, shift: float = 1.0, dtype=np.float64
):
    """Weighted graph Laplacian (+ ``shift``·I) of a randomly triangulated
    H x W quad mesh — the *unstructured-sparsity* model problem: grid
    edges plus ONE randomly oriented diagonal per quad, random positive
    edge weights in [0.5, 1.5).  Interior vertex degrees vary 4..8 and no
    two rows share a stencil, so the matrix has no constant diagonal
    structure (unlike the north-star stencils) while keeping the *local*
    connectivity of a finite-element mesh — which is what lets reverse
    Cuthill-McKee produce an O(min(H, W)) bandwidth.  SPD for shift > 0.

    The reference exercises its solvers on exactly this matrix class —
    irregular SPD Laplacians (``test/solver_test_jacobi.f90``,
    ``solver_test_incomplete_cholesky.f90`` build random-graph
    Laplacian + I); this generator is the scaled-up mesh-local version
    whose RCM band stays narrow at millions of rows.

    Returns a :class:`~sigma_tpu.matrix.formats.CSRMatrix`.  For the 10M-row setup pipeline use
    :func:`irregular_mesh_laplacian_coo`, which never builds the (device-
    resident) CSR matrix at all.
    """
    from sigma_tpu.matrix.formats import CSRMatrix

    n, rows, cols, vals = irregular_mesh_laplacian_coo(
        H, W, rng=rng, shift=shift
    )
    return CSRMatrix.from_coo(n, n, rows, cols, vals, dtype=dtype)


def irregular_mesh_laplacian_coo(
    H: int, W: int, rng=None, shift: float = 1.0, shuffle: bool = False
):
    """Host-only COO form of :func:`irregular_mesh_laplacian`:
    ``(n, rows, cols, vals)`` numpy arrays, duplicate-free by
    construction, written straight into the final preallocated buffers
    (one first-touch pass: every avoided temporary is worth seconds at
    10M rows).

    ``shuffle=True`` applies a random vertex permutation in place (the
    "shuffled mesh" north-star preprocessing) without materializing a
    second triple set.  Feed the result to
    :func:`sigma_tpu.matrix.banded.reorder_triples_rcm` +
    ``PrunedDIAMatrix.from_coo(..., assume_unique=True)`` for the
    host-only setup path (the CSR-matrix route pays two device
    round-trips of the triples that this path never takes)."""
    rng = rng or np.random.default_rng()
    n = H * W
    idx = np.arange(n, dtype=np.int64).reshape(H, W)
    Eh = H * (W - 1)
    Ev = (H - 1) * W
    Ed = (H - 1) * (W - 1)
    E = Eh + Ev + Ed
    total = n + 2 * E
    rows = np.empty(total, dtype=np.int64)
    cols = np.empty(total, dtype=np.int64)
    vals = np.empty(total, dtype=np.float64)
    # edge endpoints written directly into their final slices: rows/cols
    # [n : n+E] hold (u, v), [n+E :] hold (v, u)
    u = rows[n : n + E]
    v = cols[n : n + E]
    u[:Eh] = idx[:, :-1].ravel()
    v[:Eh] = u[:Eh] + 1
    u[Eh : Eh + Ev] = idx[:-1, :].ravel()
    v[Eh : Eh + Ev] = u[Eh : Eh + Ev] + W
    flip = rng.random(Ed) < 0.5  # per-quad diagonal choice
    np.copyto(
        u[Eh + Ev :],
        np.where(flip, idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel()),
    )
    v[Eh + Ev :] = u[Eh + Ev :] + np.where(flip, W + 1, W - 1)
    w = rng.random(E) + 0.5
    diag = (
        shift
        + np.bincount(u, weights=w, minlength=n)
        + np.bincount(v, weights=w, minlength=n)
    )
    rows[:n] = idx.ravel()
    cols[:n] = rows[:n]
    vals[:n] = diag
    vals[n : n + E] = -w
    vals[n + E :] = -w
    rows[n + E :] = v
    cols[n + E :] = u
    if shuffle:
        sh = rng.permutation(n)
        rows[:] = sh[rows]
        cols[:] = sh[cols]
    return n, rows, cols, vals


def named_graph(name: str, n: int, k: int, p: float = 0.25, rng=None, frmt="csr"):
    """Dispatch by the reference apps' ``--graph`` names (``ising.f90:68-110``)."""
    name = name.lower().replace("_", "-")
    if name == "torus":
        return torus(n, k, frmt)
    if name == "petersen":
        return petersen(n, k, frmt)
    if name in ("snark", "flower-snark", "flowersnark"):
        return flower_snark(n, frmt)
    if name == "hypercube":
        return hypercube(min(n, 10), frmt)
    if name in ("erdos-renyi", "erdosrenyi", "er"):
        return erdos_renyi(n, k / n, rng, frmt)
    if name in ("watts-strogatz", "wattsstrogatz", "ws", "small-world", "smallworld"):
        return watts_strogatz(n, k, p, rng, frmt)
    if name in ("barabasi-albert", "barabasialbert", "ba", "scale-free", "scalefree"):
        return barabasi_albert(n, k, rng, frmt)
    raise ValueError(f"unknown graph family {name!r}")


def laplacian_3d_dia(nx, dtype=np.float32, shift: float = 1.0):
    """7-point Dirichlet Laplacian (+ ``shift``·I) on an nx^3 grid, built
    directly in DIA layout from analytic boundary masks — no COO sort, no
    device round trip: returns ``(n, offsets, data, nnz)`` with ``data``
    of shape (7, stride), ``data[d, i] = A[i, i + offsets[d]]``."""
    n = nx * nx * nx
    stride = -(-n // 128) * 128
    offsets = (-nx * nx, -nx, -1, 0, 1, nx, nx * nx)
    data = np.zeros((7, stride), dtype)
    i = np.arange(n)
    iz = i % nx
    iy = (i // nx) % nx
    ix = i // (nx * nx)
    data[3, :n] = 6.0 + shift
    data[4, :n] = np.where(iz < nx - 1, -1.0, 0.0)
    data[2, :n] = np.where(iz > 0, -1.0, 0.0)
    data[5, :n] = np.where(iy < nx - 1, -1.0, 0.0)
    data[1, :n] = np.where(iy > 0, -1.0, 0.0)
    data[6, :n] = np.where(ix < nx - 1, -1.0, 0.0)
    data[0, :n] = np.where(ix > 0, -1.0, 0.0)
    nnz = int(np.count_nonzero(data))
    return n, offsets, data, nnz
