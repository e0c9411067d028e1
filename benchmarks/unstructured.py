#!/usr/bin/env python
"""Unstructured-sparsity north star: the general-sparsity recipe measured
end-to-end on hardware at >= 1M rows.

The reference's hot kernel serves ANY sparsity pattern
(/root/reference/src/matrix/formats/cs_matrices.f90:600-622).  The
structural recipe here is RCM-reorder -> to_banded_dia -> DIA SpMV, whose
ceiling is  occupancy x DIA-rate.  This script measures every term of
that law on one device:

  - the problem: a randomly triangulated H x W mesh Laplacian
    (irregular degrees 4..8, random weights — no constant stencil),
  - the reorder: RCM bandwidth before/after, diagonal count, occupancy,
  - the kernel: banded-DIA SpMV Gnnz/s (true-nnz rate AND slot rate),
  - the floor it replaces: the same matrix through the gather path
    (CSR segment-sum / ELL), measured, not assumed,
  - the solve: jitted CG in the permuted frame, wall clock per iteration.

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
    ap.add_argument("--height", type=int, default=16384)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--iters", type=int, default=200, help="CG iterations")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--gather", action="store_true",
        help="also measure the gather-path floor (CSR segment-sum SpMV)",
    )
    ap.add_argument(
        "--symmetric", action="store_true",
        help="also measure upper-only symmetric storage (half the value "
        "stream)",
    )
    ap.add_argument(
        "--nrhs", type=int, default=0,
        help="also measure the chunked multi-RHS SpMM at this panel count",
    )
    ap.add_argument(
        "--bf16", action="store_true",
        help="also measure bf16 matrix values through the chunked kernels "
        "(halves the dominant HBM stream; values round at ~4e-3) and a "
        "mixed-precision refined CG that recovers f32-grade residuals "
        "with every inner matvec streaming bf16",
    )
    ap.add_argument(
        "--shift", type=float, default=1.0,
        help="diagonal shift of the mesh Laplacian (small = ill-"
        "conditioned, where multilevel preconditioning matters)",
    )
    ap.add_argument(
        "--gmg", action="store_true",
        help="also run CG with the 1-D banded pair-GMG preconditioner "
        "(structured_pair_amg over the RCM order: every level stays "
        "banded DIA, gather-free) and with Chebyshev, vs plain CG",
    )
    ap.add_argument(
        "--no-shuffle", action="store_true",
        help="keep the generator's natural (already banded) vertex order "
        "instead of shuffling labels before the RCM step",
    )
    args = ap.parse_args()


    import jax
    import jax.numpy as jnp
    from jax import lax

    from bench import timeit_loop
    from sigma_tpu.apps.generators import irregular_mesh_laplacian
    from sigma_tpu.matrix.banded import bandwidth, to_banded_dia

    t0 = time.time()
    H, W = args.height, args.width
    rng = np.random.default_rng(args.seed)
    A = irregular_mesh_laplacian(H, W, rng=rng, dtype=jnp.float32,
                                 shift=args.shift)
    n = A.shape[0]
    if not args.no_shuffle:
        # matrices arrive in whatever order the mesh generator / partitioner
        # produced; shuffle the labels so the RCM step has real work to do
        # (without this the generator's natural row-major order is already
        # near-optimally banded and to_banded_dia keeps it)
        from sigma_tpu.matrix.formats import CSRMatrix

        rr, cc, vv = A.entries()
        sh = rng.permutation(n)
        A = CSRMatrix.from_coo(n, n, sh[rr], sh[cc], vv, dtype=jnp.float32)
    nnz = A.graph.nnz
    deg = np.diff(np.asarray(A.graph.indptr))
    print(
        f"# {H}x{W} mesh: n={n}, nnz={nnz}, degrees "
        f"{deg.min()}..{deg.max()} (mean {deg.mean():.2f})  "
        f"[build {time.time()-t0:.1f}s]",
        file=sys.stderr,
    )

    bw0 = bandwidth(A)
    t1 = time.time()
    D, p = to_banded_dia(A)
    t_reorder = time.time() - t1
    n_diags = D.graph.n_diags
    occ = nnz / (n * n_diags)
    bw1 = max(abs(o) for o in D.graph.offsets)
    print(json.dumps({
        "metric": "unstructured_band",
        "n": n,
        "nnz": int(nnz),
        "bandwidth_before": int(bw0),
        "bandwidth_after_rcm": int(bw1),
        "n_diags": int(n_diags),
        "occupancy": round(occ, 5),
        "dia_data_mb": round(n_diags * D.graph.stride * 4 / 1e6, 1),
        "reorder_build_s": round(t_reorder, 2),
    }))

    x = jnp.ones((n,), jnp.float32)

    def mk(K):
        @jax.jit
        def f(A, x):
            def body(i, vv):
                return A.matvec(vv) * jnp.asarray(0.1, vv.dtype)

            return lax.fori_loop(0, K, body, x)

        return f

    t = timeit_loop(mk, D, x, K=50)
    slots = n_diags * n
    print(json.dumps({
        "metric": "unstructured_dia_spmv",
        "true_gnnz_s": round(nnz / t / 1e9, 3),
        "slot_gnnz_s": round(slots / t / 1e9, 2),
        "achieved_gbps": round(slots * 4 / t / 1e9, 1),
        "ms_per_spmv": round(t * 1e3, 3),
        "occupancy": round(occ, 5),
        "law_check": "true_rate = occupancy x slot_rate (identity); "
        "slot_rate vs the structured-stencil DIA rate is the kernel "
        "efficiency at this band",
    }))

    if args.symmetric:
        # upper-only storage (the matrix is SPD): half the dominant
        # value stream through the chunked SYMMETRIC kernel
        from sigma_tpu.matrix.symmetric import SymmetricDIAMatrix

        Ds = SymmetricDIAMatrix.from_dia(D)

        def mky(K):
            @jax.jit
            def f(Ds, x):
                def body(i, vv):
                    return Ds.matvec(vv) * jnp.asarray(0.1, vv.dtype)

                return lax.fori_loop(0, K, body, x)

            return f

        tsym = timeit_loop(mky, Ds, x, K=50)
        up_slots = len(Ds.offsets) * n
        print(json.dumps({
            "metric": "unstructured_dia_sym_spmv",
            "n_upper_diags": len(Ds.offsets),
            "true_gnnz_s": round(nnz / tsym / 1e9, 3),
            "stored_slot_gnnz_s": round(up_slots / tsym / 1e9, 2),
            "ms_per_spmv": round(tsym * 1e3, 3),
            "speedup_vs_full_storage": round(t / tsym, 2),
        }))

        if args.nrhs:
            XTs = jnp.ones((args.nrhs, n), jnp.float32)

            def mksm(K):
                @jax.jit
                def f(Ds, XT):
                    def body(i, V):
                        return Ds.matmat_rhs_major(V) * jnp.asarray(
                            0.1, V.dtype
                        )

                    return lax.fori_loop(0, K, body, XT)

                return f

            tss = timeit_loop(mksm, Ds, XTs, K=25)
            print(json.dumps({
                "metric": "unstructured_dia_sym_spmm",
                "nrhs": args.nrhs,
                "true_eff_gnnz_s": round(args.nrhs * nnz / tss / 1e9, 3),
                "ms_per_apply": round(tss * 1e3, 3),
                "per_rhs_speedup_vs_sym_spmv": round(
                    args.nrhs * tsym / tss, 2
                ),
            }))

    if args.nrhs:
        # wide-band multi-RHS SpMM (dia_spmm_rhs_major_chunked through
        # DIAMatrix.matmat_rhs_major): the data slabs stream once for all
        # k right-hand sides
        XT = jnp.ones((args.nrhs, n), jnp.float32)

        def mks(K):
            @jax.jit
            def f(D_, XT):
                def body(i, V):
                    return D_.matmat_rhs_major(V) * jnp.asarray(0.1, V.dtype)

                return lax.fori_loop(0, K, body, XT)

            return f

        ts = timeit_loop(mks, D, XT, K=25)
        print(json.dumps({
            "metric": "unstructured_dia_spmm",
            "nrhs": args.nrhs,
            "true_eff_gnnz_s": round(args.nrhs * nnz / ts / 1e9, 3),
            "slot_eff_gnnz_s": round(args.nrhs * slots / ts / 1e9, 1),
            "ms_per_apply": round(ts * 1e3, 3),
            "per_rhs_speedup_vs_spmv": round(args.nrhs * t / ts, 2),
        }))

    if args.bf16:
        # bf16 matrix values: the diagonal stream (the n_diags*n-word
        # dominant term) at half the bytes.  Mesh weights are random, so
        # this is astype (rounding ~4e-3), NOT astype_exact — kernel-rate
        # row here; the refined-CG row below shows the accuracy story.
        Db = D.astype(jnp.bfloat16)

        def mkb(K):
            @jax.jit
            def f(Db_, x_):
                def body(i, vv):
                    # f32 vectors through bf16 values: the apply casts
                    # data to x.dtype inside the fused pass, so memory
                    # still streams 2-byte values
                    return Db_.matvec(vv) * jnp.asarray(0.1, vv.dtype)

                return lax.fori_loop(0, K, body, x_)

            return f

        tb = timeit_loop(mkb, Db, x, K=50)
        print(json.dumps({
            "metric": "unstructured_dia_bf16_spmv",
            "true_gnnz_s": round(nnz / tb / 1e9, 3),
            "slot_gnnz_s": round(slots / tb / 1e9, 2),
            "ms_per_spmv": round(tb * 1e3, 3),
            "speedup_vs_f32": round(t / tb, 2),
        }))

        if args.symmetric:
            from sigma_tpu.matrix.symmetric import SymmetricDIAMatrix

            Dsb = SymmetricDIAMatrix(
                data=Ds.data.astype(jnp.bfloat16), offsets=Ds.offsets, n=n
            )
            tsb = timeit_loop(mkb, Dsb, x, K=50)
            print(json.dumps({
                "metric": "unstructured_dia_sym_bf16_spmv",
                "true_gnnz_s": round(nnz / tsb / 1e9, 3),
                "ms_per_spmv": round(tsb * 1e3, 3),
                "speedup_vs_full_f32": round(t / tsb, 2),
            }))

    if args.gather:
        # the floor this recipe replaces: per-element gather + segment-sum
        def mkg(K):
            @jax.jit
            def f(A, x):
                def body(i, vv):
                    return A.matvec(vv) * jnp.asarray(0.1, vv.dtype)

                return lax.fori_loop(0, K, body, x)

            return f

        tg = timeit_loop(mkg, A, x, K=10)
        print(json.dumps({
            "metric": "unstructured_gather_floor",
            "gnnz_s": round(nnz / tg / 1e9, 4),
            "ms_per_spmv": round(tg * 1e3, 2),
            "speedup_structural": round(tg / t, 1),
        }))

    # CG in the permuted frame: D x_p = b_p, x = x_p[p]
    from sigma_tpu.solvers import cg_solve

    xstar = np.sin(np.arange(n) * 0.001).astype(np.float32)
    b = np.asarray(A.matvec(jnp.asarray(xstar)))
    b_p = np.empty_like(b)
    b_p[p] = b
    solve = jax.jit(
        lambda Dm, bb: cg_solve(Dm, bb, tol=0.0, rtol=1e-6, maxiter=args.iters)
    )
    t1 = time.time()
    xp, info = solve(D, jnp.asarray(b_p))
    resn = float(info.residual_norm)
    t_cold = time.time() - t1
    t1 = time.time()
    xp, info = solve(D, jnp.asarray(b_p))
    resn = float(info.residual_norm)
    t_warm = time.time() - t1
    x_sol = np.asarray(xp)[p]
    err = float(np.abs(x_sol - xstar).max())
    iters = int(info.iterations)
    print(json.dumps({
        "metric": "unstructured_cg",
        "iterations": iters,
        "relative_residual": f"{resn / float(np.linalg.norm(b)):.3e}",
        "max_err_vs_manufactured": f"{err:.3e}",
        "wall_s_incl_compile": round(t_cold, 2),
        "wall_s_warm": round(t_warm, 2),
        "s_per_iteration": round(t_warm / max(iters, 1), 4),
    }))

    if args.bf16:
        # mixed-precision refinement, FULLY JITTED (refined_solve_fixed):
        # EVERY inner matvec streams bf16 values while all Krylov
        # vectors stay f32; each f32-residual
        # outer sweep contracts the error by ~max(inner_rtol, bf16 value
        # rounding ~4e-3), so three sweeps land f32-grade residuals.  One
        # device program — the host-loop refined_solve pays a dispatch
        # and a host round trip per outer step.
        from sigma_tpu.solvers.refine import refined_solve_fixed

        Db = D.astype(jnp.bfloat16)
        solve_rf = jax.jit(
            lambda Dm, Dl, bb: refined_solve_fixed(
                Dm, bb, A_lo=Dl, sweeps=3, inner_rtol=1e-3,
                inner_maxiter=args.iters,
            )
        )
        t1 = time.time()
        xr = solve_rf(D, Db, jnp.asarray(b_p))
        rr = float(jnp.linalg.norm(b_p - D.matvec(xr)))
        t_ref_cold = time.time() - t1
        t1 = time.time()
        xr = solve_rf(D, Db, jnp.asarray(b_p))
        rr = float(jnp.linalg.norm(b_p - D.matvec(xr)))
        t_ref = time.time() - t1
        err_r = float(np.abs(np.asarray(xr)[p] - xstar).max())
        print(json.dumps({
            "metric": "unstructured_cg_bf16_refined",
            "outer_sweeps": 3,
            "relative_residual": f"{rr / float(np.linalg.norm(b)):.3e}",
            "max_err_vs_manufactured": f"{err_r:.3e}",
            "wall_s_warm": round(t_ref, 2),
            "wall_s_incl_compile": round(t_ref_cold, 2),
            "vs_plain_f32_cg": round(t_warm / max(t_ref, 1e-9), 2),
        }))

    if args.gmg:
        # 1-D banded pair-GMG: pair consecutive RCM indices — closed-form
        # Galerkin on the diagonal value grids, so EVERY level stays
        # banded DIA (gather-free at any width via the chunked kernel)
        from sigma_tpu.solvers import chebyshev, structured_pair_amg

        t1 = time.time()
        Mg = structured_pair_amg(D, (n,), coarse_size=4096)
        setup_g = time.time() - t1
        solve_g = jax.jit(
            lambda Dm, bb, M: cg_solve(
                Dm, bb, tol=0.0, rtol=1e-6, maxiter=args.iters, M=M
            )
        )
        xg, infog = solve_g(D, jnp.asarray(b_p), Mg)
        float(infog.residual_norm)
        t1 = time.time()
        xg, infog = solve_g(D, jnp.asarray(b_p), Mg)
        resg = float(infog.residual_norm)
        tg_warm = time.time() - t1
        print(json.dumps({
            "metric": "unstructured_cg_banded_gmg",
            "levels": len(Mg.levels),
            "setup_s": round(setup_g, 2),
            "iterations": int(infog.iterations),
            "relative_residual": f"{resg / float(np.linalg.norm(b)):.3e}",
            "wall_s_warm": round(tg_warm, 2),
            "speedup_vs_plain": round(t_warm / max(tg_warm, 1e-9), 2),
        }))

        # Chebyshev needs a spectral interval; Gershgorin upper bound
        row_abs = float(
            np.abs(np.asarray(D.data2d)).sum(axis=0).max()
        )
        Mc = chebyshev(D, degree=4, lmax=row_abs, lmin=row_abs / 30)
        solve_c = jax.jit(
            lambda Dm, bb, M: cg_solve(
                Dm, bb, tol=0.0, rtol=1e-6, maxiter=args.iters, M=M,
                flexible=True,
            )
        )
        xc, infoc = solve_c(D, jnp.asarray(b_p), Mc)
        float(infoc.residual_norm)
        t1 = time.time()
        xc, infoc = solve_c(D, jnp.asarray(b_p), Mc)
        resc = float(infoc.residual_norm)
        tc_warm = time.time() - t1
        print(json.dumps({
            "metric": "unstructured_cg_chebyshev",
            "iterations": int(infoc.iterations),
            "relative_residual": f"{resc / float(np.linalg.norm(b)):.3e}",
            "wall_s_warm": round(tc_warm, 2),
            "speedup_vs_plain": round(t_warm / max(tc_warm, 1e-9), 2),
        }))


if __name__ == "__main__":
    main()
