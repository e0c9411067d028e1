#!/usr/bin/env python
"""Elasticity-like 3x3-block north star: a coupled 3-field (vector)
operator at 10M dof on one chip, stored FIELD-BLOCKED — a BlockMatrix of
9 DIA stencil blocks — so every block runs the gather-free blocked
kernel.

Operator: A = C ⊗ L + I, with L the 7-point 3-D Laplacian and C a dense
SPD 3x3 coupling (Lamé-like cross-field terms).  This is the field-blocked
layout decision for multi-DOF PDE: the reference's composite block
matrix (sparse_matrix_composites.f90:41-162, "the primary means by which
parallelism is enabled") carries the FIELDS, and each block keeps its
scalar stencil structure — versus node-major (3,3)-block BSR, whose tiny
blocks waste the 128-wide lanes.  Measures SpMV, multi-RHS SpMM, and a
block-Jacobi-preconditioned CG solve with manufactured solution.

Prints one JSON line per measurement.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=150, help="grid (3*nx^3 dof)")
    ap.add_argument("--iters", type=int, default=150)
    ap.add_argument("--nrhs", type=int, default=4)
    ap.add_argument("--node-major", action="store_true",
                    help="also measure the node-major wide-band DIA "
                         "layouts (measured NEGATIVE at 10M dof — kept "
                         "as the completed layout comparison)")
    args = ap.parse_args()


    import jax
    import jax.numpy as jnp
    from jax import lax

    from bench import laplacian_3d_dia, timeit_loop
    from sigma_tpu import DIAMatrix
    from sigma_tpu.graph.graph import DIAGraph
    from sigma_tpu.matrix.composite import BlockMatrix
    from sigma_tpu.solvers import cg_solve

    nx = args.nx
    n, offsets, data, nnz_blk = laplacian_3d_dia(nx)
    # laplacian_3d_dia returns Lap + I on the center diagonal; strip the
    # shift to get the pure Laplacian stencil
    ctr = offsets.index(0)
    data[ctr, :n] -= 1.0

    C = np.array([[2.0, 0.5, 0.3], [0.5, 2.0, 0.4], [0.3, 0.4, 2.0]])
    assert np.all(np.linalg.eigvalsh(C) > 0)

    g = DIAGraph(offsets=offsets, shape=(n, n), nnz=nnz_blk)

    def blk_exact(i, j):
        d = C[i, j] * np.asarray(data)
        if i == j:
            d[ctr, :n] += 1.0
        return DIAMatrix(
            graph=g, data=jnp.asarray(d.reshape(len(offsets), -1, 128))
        )

    t0 = time.time()
    A = BlockMatrix.from_blocks(
        [[blk_exact(i, j) for j in range(3)] for i in range(3)]
    )
    N = A.shape[0]
    nnz = 9 * nnz_blk
    print(
        f"# elasticity-like block operator: 3x{n} = {N} dof, "
        f"{nnz} nnz in 9 DIA blocks  [build {time.time()-t0:.1f}s]",
        file=sys.stderr,
    )

    x = jnp.ones((N,), jnp.float32)

    def mk(K):
        @jax.jit
        def f(A, x):
            def body(i, vv):
                return A.matvec(vv) * jnp.asarray(0.1, vv.dtype)

            return lax.fori_loop(0, K, body, x)

        return f

    t = timeit_loop(mk, A, x, K=25)
    ok = t > 1e-9  # clamp floor => workload below launch jitter
    print(json.dumps({
        "metric": "elasticity_block_spmv",
        "dof": N,
        "nnz": int(nnz),
        "gnnz_s": round(nnz / t / 1e9, 2) if ok else None,
        "achieved_gbps_values_stream": (
            round(nnz * 4 / t / 1e9, 1) if ok else None
        ),
        "ms_per_spmv": round(t * 1e3, 3) if ok else None,
        "layout": "BlockMatrix of 9 DIA stencil blocks (field-blocked)",
    }))

    # multi-RHS through the composite (block-wise matmat)
    X = jnp.ones((N, args.nrhs), jnp.float32)

    def mkm(K):
        @jax.jit
        def f(A, X):
            def body(i, V):
                return A.matmat(V) * jnp.asarray(0.1, V.dtype)

            return lax.fori_loop(0, K, body, X)

        return f

    tm = timeit_loop(mkm, A, X, K=15)
    okm = tm > 1e-9
    print(json.dumps({
        "metric": "elasticity_block_spmm",
        "nrhs": args.nrhs,
        "eff_gnnz_s": (
            round(args.nrhs * nnz / tm / 1e9, 2) if okm else None
        ),
        "ms_per_apply": round(tm * 1e3, 3) if okm else None,
    }))

    # CG with the field-diagonal Jacobi preconditioner
    xstar = jnp.asarray(
        np.tile(np.sin(np.arange(n) * 0.001), 3).astype(np.float32)
    )
    b = A.matvec(xstar)
    dinv = 1.0 / jnp.concatenate(
        [jnp.full((n,), C[i, i] * 6.0 + 1.0, jnp.float32) for i in range(3)]
    )
    from sigma_tpu.operators.linear_operator import MatvecOperator

    M = MatvecOperator(
        params=dinv, mv=lambda d, r: d * r, rmv=None, shape=(N, N)
    )
    solve = jax.jit(
        lambda A, b, M: cg_solve(
            A, b, tol=0.0, rtol=1e-6, maxiter=args.iters, M=M
        )
    )
    xs, info = solve(A, b, M)
    float(info.residual_norm)
    t1 = time.time()
    xs, info = solve(A, b, M)
    resn = float(info.residual_norm)
    t_warm = time.time() - t1
    err = float(jnp.max(jnp.abs(xs - xstar)))
    print(json.dumps({
        "metric": "elasticity_block_cg",
        "iterations": int(info.iterations),
        "relative_residual": f"{resn / float(jnp.linalg.norm(b)):.2e}",
        "max_err_vs_manufactured": f"{err:.2e}",
        "wall_s_warm": round(t_warm, 2),
        "s_per_iteration": round(t_warm / max(int(info.iterations), 1), 4),
    }))

    # ---- NODE-MAJOR wide-band DIA probe (round 5, measured NEGATIVE)
    # Hypothesis: interleaving the fields (dof 3i+a) turns the operator
    # into ONE DIA matrix with ~31 constant diagonals — one kernel
    # pass, x streamed once, and symmetric upper-only storage halves
    # the values.  MEASURED at 10.1M dof: 0.91x (full) / 0.93x (sym)
    # the field-blocked composite, and sym ~= full — the node-major
    # REACH is 3x the per-block reach (67.5K vs 22.5K), so the chunked
    # kernel's per-slab halo windows dominate the traffic and halving
    # the value stream doesn't move the wall.  Field-blocked stays the
    # measured layout for multi-DOF PDE (this probe completes the
    # round-3 comparison, which only tested node-major BSR).  At small
    # nx the conclusion INVERTS (2x for node-major at nx=48) — tiny
    # chains there are launch-jitter dominated; trust the 10M numbers.
    if not args.node_major:
        return
    t0 = time.time()
    from collections import defaultdict

    node_vals = defaultdict(lambda: np.zeros(N, np.float32))
    Ld = np.asarray(data)
    for si, o_sp in enumerate(offsets):
        for a in range(3):
            for fb in range(3):  # NOT `b` — that's the live RHS vector
                o_node = 3 * o_sp + (fb - a)
                # dval[3i+a] = C[a,fb] * L[i, i+o_sp]; DIA row-indexed
                # storage: entry at node row r=3i+a on diagonal o_node
                node_vals[o_node][a::3] = (
                    node_vals[o_node][a::3] + C[a, fb] * Ld[si, :n]
                )
    # + I on the main diagonal
    node_vals[0][:] += 1.0
    offs_node = tuple(sorted(node_vals))
    Sx = -(-N // 128)
    nd = np.zeros((len(offs_node), Sx * 128), np.float32)
    for d, o in enumerate(offs_node):
        nd[d, :N] = node_vals[o]
        # clamp out-of-range tails (row + o >= N) to zero
        if o > 0:
            nd[d, N - o : N] = 0.0
        elif o < 0:
            nd[d, : -o] = 0.0
    g_node = DIAGraph(offsets=offs_node, shape=(N, N), nnz=nnz)
    A_node = DIAMatrix(
        graph=g_node,
        data=jnp.asarray(nd.reshape(len(offs_node), -1, 128)),
    )
    t_build = time.time() - t0

    # parity vs the composite: node index 3i+a <-> field index a*n+i
    perm = (
        np.tile(np.arange(n), 3) * 3
        + np.repeat(np.arange(3), n)
    )  # field-blocked position a*n+i -> node position 3i+a
    xv = np.random.default_rng(0).standard_normal(N).astype(np.float32)
    y_blk = np.asarray(A.matvec(jnp.asarray(xv)))
    xn = np.empty_like(xv)
    xn[perm] = xv
    y_node = np.asarray(A_node.matvec(jnp.asarray(xn)))
    rel = float(
        np.abs(y_node[perm] - y_blk).max() / max(np.abs(y_blk).max(), 1e-30)
    )

    t_node = timeit_loop(mk, A_node, jnp.asarray(xn), K=25)
    print(json.dumps({
        "metric": "elasticity_node_major_spmv",
        "n_diagonals": len(offs_node),
        "reach": int(max(abs(o) for o in offs_node)),
        "build_s": round(t_build, 1),
        "gnnz_s": round(nnz / t_node / 1e9, 2),
        "ms_per_spmv": round(t_node * 1e3, 3),
        "speedup_vs_field_blocked": round(t / t_node, 2),
        "rel_err_vs_composite": f"{rel:.2e}",
        "layout": "ONE wide-band DIA (chunked kernel, x streamed once)",
    }))

    # symmetric upper-only storage of the node-major operator
    from sigma_tpu.matrix.symmetric import SymmetricDIAMatrix

    t0 = time.time()
    # build from the HOST nd array (from_dia would pull the multi-GB
    # device data back to the host); symmetry is exact by
    # construction (C and L both symmetric)
    keep_up = [d for d, o in enumerate(offs_node) if o >= 0]
    A_sym = SymmetricDIAMatrix(
        data=jnp.asarray(nd[keep_up].reshape(len(keep_up), -1, 128)),
        offsets=tuple(offs_node[d] for d in keep_up),
        n=N,
    )
    t_symb = time.time() - t0
    y_sym = np.asarray(A_sym.matvec(jnp.asarray(xn)))
    rel_s = float(
        np.abs(y_sym[perm] - y_blk).max() / max(np.abs(y_blk).max(), 1e-30)
    )
    t_sym = timeit_loop(mk, A_sym, jnp.asarray(xn), K=25)
    print(json.dumps({
        "metric": "elasticity_node_major_sym_spmv",
        "n_upper_diagonals": len(A_sym.offsets),
        "build_s": round(t_symb, 1),
        "gnnz_s": round(nnz / t_sym / 1e9, 2),
        "ms_per_spmv": round(t_sym * 1e3, 3),
        "speedup_vs_field_blocked": round(t / t_sym, 2),
        "rel_err_vs_composite": f"{rel_s:.2e}",
    }))

    # CG on the node-major operators (same Jacobi preconditioner,
    # permuted) — the solve-wall comparison that matters
    dinv_node = jnp.asarray(np.asarray(dinv)[np.argsort(perm)])
    M_node = MatvecOperator(
        params=dinv_node, mv=lambda d, r: d * r, rmv=None, shape=(N, N)
    )
    b_node = jnp.asarray(np.asarray(b)[np.argsort(perm)])
    for tag, Aop in (("node_major", A_node), ("node_major_sym", A_sym)):
        xs2, info2 = solve(Aop, b_node, M_node)
        float(info2.residual_norm)
        t1 = time.time()
        xs2, info2 = solve(Aop, b_node, M_node)
        float(info2.residual_norm)
        tw = time.time() - t1
        print(json.dumps({
            "metric": f"elasticity_{tag}_cg",
            "iterations": int(info2.iterations),
            "wall_s_warm": round(tw, 2),
            "s_per_iteration": round(
                tw / max(int(info2.iterations), 1), 4
            ),
            "speedup_vs_field_blocked_cg": round(t_warm / max(tw, 1e-9), 2),
        }))


if __name__ == "__main__":
    main()
