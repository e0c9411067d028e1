#!/usr/bin/env python
"""Where does the bf16 ladder PAY?

Compares, on the ill-conditioned unstructured north star (pruned format,
pair-GMG preconditioner), at matched f32-grade final residuals:

  a. plain f32 GMG-CG (rtol 1e-6) — the baseline;
  b. bf16 LEVELS only (f32 fine matvec, bf16 V-cycle) — same CG;
  c. the full bf16 ladder: refined_solve_fixed with bf16 fine operator
     AND bf16 levels — every inner matvec streams half the bytes, three
     f32-residual sweeps recover the accuracy;
  d. (control) the unpreconditioned bf16 ladder vs plain f32 CG — the
     regime where the ladder was measured to LOSE in round 3.

The measured crossover becomes the routing rule documented in
solvers/refine.py.  One JSON line per configuration.
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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shift", type=float, default=1e-3)
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--sweeps", type=int, default=3)
    ap.add_argument("--inner-rtol", type=float, default=1e-2)
    ap.add_argument("--inner-maxiter", type=int, default=20)
    ap.add_argument("--stencil", type=int, default=0,
                    help="also run the EXACT-bf16 stencil case at this "
                    "grid edge (e.g. 216 = the 10.1M-row north star)")
    args = ap.parse_args()


    import jax
    import jax.numpy as jnp

    from sigma_tpu.apps.generators import irregular_mesh_laplacian
    from sigma_tpu.graph.permutations import reverse_cuthill_mckee
    from sigma_tpu.matrix.formats import CSRMatrix
    from sigma_tpu.matrix.pruned import PrunedDIAMatrix
    from sigma_tpu.solvers import cg_solve, pruned_pair_amg
    from sigma_tpu.solvers.refine import refined_solve_fixed

    rng = np.random.default_rng(args.seed)
    A = irregular_mesh_laplacian(args.height, args.width, rng=rng,
                                 dtype=np.float32, shift=args.shift)
    n = A.shape[0]
    rr, cc, vv = A.entries()
    sh = rng.permutation(n)
    A = CSRMatrix.from_coo(n, n, sh[rr], sh[cc], vv, dtype=np.float32)
    nnz = int(A.graph.nnz)
    p = reverse_cuthill_mckee(A.graph)
    rows, cols, vals = A.entries()
    pr, pc = p[rows], p[cols]
    P = PrunedDIAMatrix.from_coo(n, n, pr, pc, vals, dtype=np.float32)
    Pb = P.astype(jnp.bfloat16)
    Mg = pruned_pair_amg(n, pr, pc, vals, coarse_size=4096,
                         smoother="chebyshev", fine_A=P)
    Mgb = pruned_pair_amg(n, pr, pc, vals, coarse_size=4096,
                          smoother="chebyshev",
                          level_dtype=jnp.bfloat16, fine_A=P)
    print(f"# n={n} nnz={nnz}", file=sys.stderr)

    xstar = np.sin(np.arange(n) * 0.001).astype(np.float32)
    b = np.asarray(A.matvec(jnp.asarray(xstar)))
    b_p = np.empty_like(b)
    b_p[p] = b
    b_p = jnp.asarray(b_p)
    bnorm = float(np.linalg.norm(b))

    resid = jax.jit(lambda P_, b_, x: jnp.linalg.norm(b_ - P_.matvec(x)))

    def run(tag, fn, *ops):
        f = jax.jit(fn)
        out = f(*ops)  # compile + first run
        x = out[0] if isinstance(out, tuple) else out
        jax.block_until_ready(x)
        t0 = time.time()
        out = f(*ops)
        x = out[0] if isinstance(out, tuple) else out
        float(x[0])
        wall = time.time() - t0
        rres = float(resid(P, b_p, x)) / bnorm
        rec = {"metric": "bf16_routing", "config": tag,
               "wall_s_warm": round(wall, 3),
               "relative_residual": f"{rres:.3e}"}
        if isinstance(out, tuple) and hasattr(out[1], "iterations"):
            rec["iterations"] = int(out[1].iterations)
        print(json.dumps(rec))
        return wall

    w_a = run(
        "a_f32_gmg_cg",
        lambda P_, b_, M_: cg_solve(P_, b_, tol=0.0, rtol=1e-6,
                                    maxiter=args.iters, M=M_),
        P, b_p, Mg,
    )
    run(
        "b_bf16_levels_gmg_cg",
        lambda P_, b_, M_: cg_solve(P_, b_, tol=0.0, rtol=1e-6,
                                    maxiter=args.iters, M=M_),
        P, b_p, Mgb,
    )
    run(
        "c_full_bf16_ladder_gmg",
        lambda P_, Pb_, b_, M_: refined_solve_fixed(
            P_, b_, A_lo=Pb_, sweeps=args.sweeps,
            inner_rtol=args.inner_rtol, inner_maxiter=args.inner_maxiter,
            M=M_,
        ),
        P, Pb, b_p, Mgb,
    )
    w_d0 = run(
        "d0_f32_plain_cg",
        lambda P_, b_: cg_solve(P_, b_, tol=0.0, rtol=1e-6,
                                maxiter=args.iters),
        P, b_p,
    )
    run(
        "d1_bf16_ladder_plain",
        lambda P_, Pb_, b_: refined_solve_fixed(
            P_, b_, A_lo=Pb_, sweeps=args.sweeps, inner_rtol=1e-2,
            inner_maxiter=args.iters,
        ),
        P, Pb, b_p,
    )

    if args.stencil:
        # the EXACT-value case: integer-coefficient stencil -> bf16 is a
        # lossless cast (astype_exact), the ladder has no rounding floor
        # and every inner matvec + V-cycle streams half the bytes
        from bench import laplacian_3d_dia
        from sigma_tpu import DIAMatrix
        from sigma_tpu.graph.graph import DIAGraph
        from sigma_tpu.solvers import structured_pair_amg

        nx = args.stencil
        ns, offsets, sdata, nnzs = laplacian_3d_dia(nx)
        sdata[3, :ns] = 6.0
        gs = DIAGraph(offsets=offsets, shape=(ns, ns), nnz=nnzs)
        As = DIAMatrix(graph=gs, data=jnp.asarray(sdata.reshape(7, -1, 128)))
        Asb = As.astype_exact(jnp.bfloat16)
        Ms = structured_pair_amg(As, (nx, nx, nx), smoother="chebyshev",
                                 pairs_per_level=3, host_data=sdata)
        Msb = structured_pair_amg(As, (nx, nx, nx), smoother="chebyshev",
                                  pairs_per_level=3,
                                  level_dtype=jnp.bfloat16,
                                  host_data=sdata)
        us = np.sin(np.arange(ns) * 0.001).astype(np.float32)
        bs = jnp.asarray(np.asarray(As.matvec(jnp.asarray(us))))
        bsn = float(jnp.linalg.norm(bs))

        resid_s = resid  # operators passed as ARGS (a closure over the
        # 10.1M-row matrix embeds it in the program as a constant)

        def run_s(tag, fn, *ops):
            f = jax.jit(fn)
            out = f(*ops)
            x = out[0] if isinstance(out, tuple) else out
            float(x[0])
            t0 = time.time()
            out = f(*ops)
            x = out[0] if isinstance(out, tuple) else out
            float(x[0])
            wall = time.time() - t0
            rec = {"metric": "bf16_routing_stencil", "config": tag,
                   "n": ns,
                   "wall_s_warm": round(wall, 3),
                   "relative_residual": f"{float(resid_s(As, bs, x)) / bsn:.3e}"}
            if isinstance(out, tuple) and hasattr(out[1], "iterations"):
                rec["iterations"] = int(out[1].iterations)
            print(json.dumps(rec))

        run_s(
            "s0_f32_gmg_cg",
            lambda A_, b_, M_: cg_solve(A_, b_, tol=0.0, rtol=1e-6,
                                        maxiter=400, M=M_),
            As, bs, Ms,
        )
        run_s(
            "s1_bf16exact_ladder_gmg",
            lambda A_, Ab_, b_, M_: refined_solve_fixed(
                A_, b_, A_lo=Ab_, sweeps=args.sweeps,
                inner_rtol=args.inner_rtol,
                inner_maxiter=args.inner_maxiter, M=M_,
            ),
            As, Asb, bs, Msb,
        )


if __name__ == "__main__":
    main()
