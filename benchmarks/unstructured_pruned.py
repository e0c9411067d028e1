#!/usr/bin/env python
"""Unstructured north star through the PRUNED block-DIA pipeline, at any
scale up to 10M+ rows on one chip: shuffled irregular-mesh Laplacian ->
RCM -> PrunedDIAMatrix (the full DIA band is never built) -> pruned
SpMV / CG / pruned-pair-AMG-preconditioned CG, f32 and bf16; ``--sym``
adds the symmetric-storage rows (upper-triangle packing, round 5).

The full-band pipeline (benchmarks/unstructured.py) stops at ~1M rows:
245 stored diagonals x 10.1M rows = 10.3 GB of DIA values (HBM + an
int32 flat-position overflow); the pruned layout packs the same matrix
into ~1-2 GB.  Setup is the HOST-ONLY path (round 5): COO straight into
preallocated buffers, C++ counting-sort adjacency + RCM, C++ pack —
no CSR device round-trips.
Prints one JSON line per measurement, including a setup_total row.
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
    ap.add_argument("--height", type=int, default=157696)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--iters", type=int, default=300, help="CG maxiter")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tile-rows", type=int, default=16384)
    ap.add_argument("--group", type=int, default=8)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--gmg", action="store_true")
    ap.add_argument("--sym", action="store_true")
    ap.add_argument("--shift", type=float, default=1.0)
    ap.add_argument("--coarse-size", type=int, default=4096)
    args = ap.parse_args()


    import jax
    import jax.numpy as jnp
    from jax import lax

    from bench import timeit_loop
    from sigma_tpu.apps.generators import irregular_mesh_laplacian_coo
    from sigma_tpu.matrix.banded import _n_distinct, reorder_triples_rcm
    from sigma_tpu.matrix.pruned import (
        PrunedDIAMatrix,
        SymmetricPrunedDIAMatrix,
    )
    from sigma_tpu.solvers import cg_solve, pruned_pair_amg

    H, W = args.height, args.width
    rng = np.random.default_rng(args.seed)
    setup = {}
    t0 = time.time()
    n, rows, cols, vals = irregular_mesh_laplacian_coo(
        H, W, rng=rng, shift=args.shift, shuffle=True
    )
    nnz = rows.size
    setup["gen_s"] = round(time.time() - t0, 1)
    t0 = time.time()
    pr, pc, vals, p = reorder_triples_rcm(n, rows, cols, vals)
    setup["rcm_s"] = round(time.time() - t0, 1)
    del rows, cols
    offs = (pc - pr).astype(np.int32)
    n_diags = _n_distinct(offs)
    bw = int(np.abs(offs).max())
    del offs
    occ = nnz / (float(n_diags) * n)
    print(json.dumps({
        "metric": "unstructured_pruned_band",
        "n": n, "nnz": nnz,
        "bandwidth_after_rcm": bw, "n_diags": n_diags,
        "occupancy": round(occ, 5),
        "full_dia_gb": round(n_diags * (-(-n // 128) * 128) * 4 / 1e9, 2),
        **setup,
    }))

    t0 = time.time()
    P = PrunedDIAMatrix.from_coo(
        n, n, pr, pc, vals, dtype=np.float32,
        tile_rows=args.tile_rows, group=args.group, assume_unique=True,
    )
    jax.block_until_ready(P.data)
    setup["pack_s"] = round(time.time() - t0, 1)
    print(json.dumps({
        "metric": "unstructured_pruned_pack",
        "tile_rows": args.tile_rows, "group": args.group,
        "steps": P.n_steps, "stored_slots_M": round(P.stored_slots / 1e6, 1),
        "packed_gb": round(P.stored_slots * 4 / 1e9, 2),
        "local_occupancy": round(nnz / P.stored_slots, 4),
        "pack_s": setup["pack_s"],
    }))

    S = None
    if args.sym:
        t0 = time.time()
        S = SymmetricPrunedDIAMatrix.from_coo(
            n, n, pr, pc, vals, dtype=np.float32,
            tile_rows=args.tile_rows, group=12, assume_unique=True,
            validate=False,
        )
        jax.block_until_ready(S.data)
        setup["sym_pack_s"] = round(time.time() - t0, 1)
        print(json.dumps({
            "metric": "unstructured_pruned_sym_pack",
            "stored_slots_M": round(S.stored_slots / 1e6, 1),
            "packed_gb": round(S.stored_slots * 4 / 1e9, 2),
            "vs_full_slots": round(P.stored_slots / S.stored_slots, 2),
            "pack_s": setup["sym_pack_s"],
        }))

    x = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    mats = [("f32", P)]
    if args.bf16:
        mats.append(("bf16", P.astype(jnp.bfloat16)))
    if S is not None:
        mats.append(("sym_f32", S))
        if args.bf16:
            mats.append(("sym_bf16", S.astype(jnp.bfloat16)))
    times = {}
    for name, M in mats:
        def mk(K):
            @jax.jit
            def f(M_, x_):
                def body(i, vv):
                    return M_.matvec(vv) * jnp.asarray(0.1, vv.dtype)

                return lax.fori_loop(0, K, body, x_)

            return f

        t = timeit_loop(mk, M, x, K=200)
        times[name] = t
        print(json.dumps({
            "metric": f"unstructured_pruned_spmv_{name}",
            "true_gnnz_s": round(nnz / t / 1e9, 3),
            "slot_gnnz_s": round(M.stored_slots / t / 1e9, 2),
            "ms_per_spmv": round(t * 1e3, 3),
        }))

    # CG in the permuted frame (manufactured solution)
    xstar = np.sin(np.arange(n) * 0.001).astype(np.float32)
    xstar_p = np.empty_like(xstar)
    xstar_p[p] = xstar
    b_p = jnp.asarray(np.asarray(P.matvec(jnp.asarray(xstar_p))))
    bnorm = float(np.linalg.norm(np.asarray(b_p)))
    solve = jax.jit(
        lambda M_, bb: cg_solve(M_, bb, tol=0.0, rtol=1e-6,
                                maxiter=args.iters)
    )
    cg_ops = [("", P)] + ([("_sym", S)] if S is not None else [])
    t_warm = None
    for tag, Mop in cg_ops:
        xp, info = solve(Mop, b_p)
        float(info.residual_norm)
        t0 = time.time()
        xp, info = solve(Mop, b_p)
        resn = float(info.residual_norm)
        tw = time.time() - t0
        if tag == "":
            t_warm = tw
        err = float(np.abs(np.asarray(xp)[p] - xstar).max())
        it0 = int(info.iterations)
        print(json.dumps({
            "metric": f"unstructured_pruned_cg{tag}",
            "iterations": it0,
            "relative_residual": f"{resn / bnorm:.3e}",
            "max_err_vs_manufactured": f"{err:.3e}",
            "wall_s_warm": round(tw, 2),
            "s_per_iteration": round(tw / max(it0, 1), 4),
        }))

    if args.gmg:
        gmg_cfgs = [("", dict(), P, args.group)]
        if args.bf16:
            gmg_cfgs.append(
                ("_bf16levels", dict(level_dtype=jnp.bfloat16), P,
                 args.group)
            )
        if S is not None:
            # validate=False: the Laplacian triples are symmetric by
            # construction; the check is an O(nnz log nnz) host sort
            gmg_cfgs.append(
                ("_sym", dict(symmetric=True, validate=False), S, 12)
            )
        for tag, kw, fineA, grp in gmg_cfgs:
            t0 = time.time()
            Mg = pruned_pair_amg(
                n, pr, pc, vals, coarse_size=args.coarse_size,
                smoother="chebyshev",
                tile_rows=args.tile_rows, group=grp, fine_A=fineA, **kw,
            )
            setup_g = time.time() - t0
            if tag == "":
                setup["gmg_s"] = round(setup_g, 1)
            if tag == "_sym":
                setup["gmg_sym_s"] = round(setup_g, 1)
            solve_g = jax.jit(
                lambda M_, bb, Mg_: cg_solve(
                    M_, bb, tol=0.0, rtol=1e-6, maxiter=args.iters, M=Mg_
                )
            )
            xg, infog = solve_g(fineA, b_p, Mg)
            float(infog.residual_norm)
            t0 = time.time()
            xg, infog = solve_g(fineA, b_p, Mg)
            resg = float(infog.residual_norm)
            tg = time.time() - t0
            print(json.dumps({
                "metric": f"unstructured_pruned_cg_gmg{tag}",
                "levels": len(Mg.levels),
                "setup_s": round(setup_g, 1),
                "iterations": int(infog.iterations),
                "relative_residual": f"{resg / bnorm:.3e}",
                "wall_s_warm": round(tg, 2),
                "speedup_vs_plain": round(
                    (t_warm or tg) / max(tg, 1e-9), 2
                ),
            }))

    total = sum(
        v for k, v in setup.items() if k not in ("gmg_sym_s", "sym_pack_s")
    )
    sym_total = (
        setup["gen_s"] + setup["rcm_s"]
        + setup.get("sym_pack_s", 0) + setup.get("gmg_sym_s", 0)
    )
    print(json.dumps({
        "metric": "unstructured_pruned_setup_total",
        **setup,
        "total_s_full_pipeline": round(total, 1),
        "total_s_sym_pipeline": round(sym_total, 1) if args.sym else None,
    }))


if __name__ == "__main__":
    main()
