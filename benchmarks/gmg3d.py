"""North-star multigrid benchmark: pure 3-D Dirichlet Poisson at nx^3
(default 216 -> 10.1M rows), f32, one chip.

Unlike benchmarks/cg3d.py (Laplacian + I, kappa ~ 60, 17 CG iterations)
this drops the identity shift: kappa ~ 4(nx/pi)^2 ~ 1.9e4, the regime
where a preconditioner decides the wall clock.  Compares jitted plain CG
against CG + structured pair-aggregation AMG (solvers/gmg.py) — the
gather-free multilevel hierarchy whose every level is a DIA stencil.

Usage: python benchmarks/gmg3d.py [--nx 216] [--rtol 1e-6] [--nsmooth 1]
"""

import argparse
import functools
import json
import os
import sys
import time

sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
)

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=216)
    ap.add_argument("--rtol", type=float, default=1e-6)
    ap.add_argument("--nsmooth", type=int, default=1)
    ap.add_argument("--smoother", default="jacobi",
                    choices=("jacobi", "chebyshev"),
                    help="level smoother: weighted-Jacobi sweeps or a "
                    "degree-nsmooth Chebyshev polynomial in D^-1 A "
                    "(Gershgorin-bounded interval)")
    ap.add_argument("--ppl", type=int, default=3,
                    help="axis pairings fused per level (3 = 2x2x2 aggregates)")
    ap.add_argument("--symmetric", action="store_true",
                    help="use SymmetricDIAMatrix as the operator: level-0 "
                    "smoothing and the CG matvec run the half-traffic "
                    "symmetric kernel")
    ap.add_argument("--bf16-levels", action="store_true",
                    help="store level matrices in bfloat16 (halves the "
                    "V-cycle's dominant HBM stream; preconditioner quality "
                    "is value-precision-insensitive)")
    ap.add_argument("--maxiter", type=int, default=3000)
    ap.add_argument("--refine", action="store_true",
                    help="also run mixed-precision iterative refinement: "
                    "f64 working precision (residuals only) with f32 "
                    "GMG-CG inner solves -> rtol 1e-12 at "
                    "north-star scale")
    args = ap.parse_args()

    import jax

    if args.refine:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    print("devices:", jax.devices(), file=sys.stderr, flush=True)

    from bench import laplacian_3d_dia
    from sigma_tpu import DIAMatrix
    from sigma_tpu.graph.graph import DIAGraph
    from sigma_tpu.solvers import cg_solve, structured_pair_amg

    nx = args.nx
    n, offsets, data, nnz = laplacian_3d_dia(nx)
    data[3, :n] = 6.0  # drop the +I shift: pure Dirichlet Laplacian
    g = DIAGraph(offsets=offsets, shape=(n, n), nnz=nnz)
    A = DIAMatrix(graph=g, data=jnp.asarray(data.reshape(7, -1, 128)))
    host = data
    if args.symmetric:
        from sigma_tpu.matrix.symmetric import SymmetricDIAMatrix

        keep = [d for d, o in enumerate(offsets) if o >= 0]
        A = SymmetricDIAMatrix(
            data=jnp.asarray(data[keep].reshape(len(keep), -1, 128)),
            offsets=tuple(offsets[d] for d in keep),
            n=n,
        )
        host = data[keep]

    t0 = time.perf_counter()
    M = structured_pair_amg(
        A,
        (nx, nx, nx),
        n_smooth=args.nsmooth,
        smoother=args.smoother,
        pairs_per_level=args.ppl,
        level_dtype=jnp.bfloat16 if args.bf16_levels else None,
        host_data=host,
    )
    t_setup = time.perf_counter() - t0
    print(
        json.dumps(
            {
                "metric": "gmg_setup_s",
                "value": round(t_setup, 2),
                "levels": len(M.levels) + 1,
                "level_diags": [
                    len(getattr(l.A, "graph", l.A).offsets)
                    for l in M.levels
                ],
            }
        ),
        flush=True,
    )

    # random manufactured solution: the RHS carries ALL spectral modes (a
    # smooth RHS lets plain CG converge far faster than kappa suggests,
    # understating what the preconditioner buys)
    xstar = jnp.asarray(
        np.random.default_rng(0).standard_normal(n).astype(np.float32)
    )
    b = A.matvec(xstar)

    def timed(solve, *extra):
        t0 = time.perf_counter()
        x, info = solve(A, b, *extra)
        resn = float(info.residual_norm)
        t_cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        x, info = solve(A, b, *extra)
        resn = float(info.residual_norm)
        t_warm = time.perf_counter() - t0
        return x, info, resn, t_cold, t_warm

    nb = float(jnp.linalg.norm(b))

    plain = jax.jit(
        functools.partial(
            cg_solve, tol=0.0, rtol=args.rtol, maxiter=args.maxiter
        )
    )
    x0, i0, r0, c0, w0 = timed(plain)
    print(
        json.dumps(
            {
                "metric": "poisson_cg_plain",
                "iterations": int(i0.iterations),
                "relative_residual": f"{r0 / nb:.3e}",
                "wall_s_warm": round(w0, 3),
                "s_per_iteration": round(w0 / max(int(i0.iterations), 1), 5),
            }
        ),
        flush=True,
    )

    # M must be a jit ARGUMENT: closing over it would embed the whole
    # hierarchy (~350 MB with level-0 A) in the program as constants
    pre = jax.jit(
        lambda A, b, M: cg_solve(
            A, b, tol=0.0, rtol=args.rtol, maxiter=args.maxiter, M=M
        )
    )
    x1, i1, r1, c1, w1 = timed(pre, M)
    print(
        json.dumps(
            {
                "metric": "poisson_cg_structured_amg",
                "iterations": int(i1.iterations),
                "relative_residual": f"{r1 / nb:.3e}",
                "wall_s_warm": round(w1, 3),
                "s_per_iteration": round(w1 / max(int(i1.iterations), 1), 5),
                "speedup_vs_plain": round(w0 / w1, 2) if w1 > 0 else None,
            }
        ),
        flush=True,
    )

    err = float(jnp.max(jnp.abs(x1 - x0)))
    print(f"# solutions max-abs diff: {err:.3e}", file=sys.stderr, flush=True)

    if args.refine:
        # f64-grade solve on an f32 chip: outer loop computes the residual
        # in (emulated) float64 — one SpMV + axpy per sweep — while all
        # Krylov work runs the fast f32 kernels with the GMG V-cycle
        from sigma_tpu.solvers import cg_solve as _cg
        from sigma_tpu.solvers.refine import refined_solve

        A64 = DIAMatrix(
            graph=g,
            data=jnp.asarray(data.astype(np.float64).reshape(7, -1, 128)),
        )
        b64 = A64.matvec(xstar.astype(jnp.float64))
        nb64 = float(jnp.linalg.norm(b64))

        A32 = A  # f32 operand built above
        inner = jax.jit(
            lambda A, r, M: _cg(
                A, r, tol=0.0, rtol=1e-6, maxiter=200, M=M
            )[0]
        )

        t0 = time.perf_counter()
        x64, info = refined_solve(
            A64,
            b64,
            tol=0.0,
            rtol=1e-12,
            inner_solve=lambda r_lo: inner(A32, r_lo, M),
            max_outer=8,
        )
        t_ref = time.perf_counter() - t0
        rel = float(info.residual_norm) / nb64
        print(
            json.dumps(
                {
                    "metric": "poisson_refined_f64",
                    "outer_sweeps": int(info.iterations),
                    "relative_residual": f"{rel:.3e}",
                    "wall_s": round(t_ref, 2),
                    "note": "f64 residuals (emulated) + f32 GMG-CG inner",
                }
            ),
            flush=True,
        )

        # the same ladder as ONE device program: refined_solve_fixed jits
        # every f64 residual sweep and f32 inner solve together — no
        # eager f64 axpy/norm dispatches between sweeps (each a launch
        # plus an 80 MB intermediate at 10.1M rows)
        from sigma_tpu.solvers.refine import refined_solve_fixed

        solve_fx = jax.jit(
            lambda A64_, A32_, b_, M_: refined_solve_fixed(
                A64_, b_, A_lo=A32_, sweeps=4, inner_rtol=1e-6,
                inner_maxiter=200, M=M_, inner_dtype=jnp.float32,
            )
        )
        xfx = solve_fx(A64, A32, b64, M)
        relx = float(jnp.linalg.norm(b64 - A64.matvec(xfx))) / nb64
        t0 = time.perf_counter()
        xfx = solve_fx(A64, A32, b64, M)
        relx = float(jnp.linalg.norm(b64 - A64.matvec(xfx))) / nb64
        t_fx = time.perf_counter() - t0
        print(
            json.dumps(
                {
                    "metric": "poisson_refined_f64_fixed",
                    "outer_sweeps": 4,
                    "relative_residual": f"{relx:.3e}",
                    "wall_s_warm": round(t_fx, 2),
                    "speedup_vs_host_loop": round(t_ref / max(t_fx, 1e-9), 2),
                    "note": "refined_solve_fixed: whole ladder jitted",
                }
            ),
            flush=True,
        )


if __name__ == "__main__":
    main()
