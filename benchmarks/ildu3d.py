#!/usr/bin/env python
"""ILDU routing verdict by measurement.

The reference's flagship preconditioner is ILDU(0)/IC(0) with sequential
triangular sweeps (ldu_solvers.f90:160-243).  Here it exists as
level-scheduled sweeps (solvers/ildu.py) — correct and distributed-tested,
but each level is a latency-bound gather/scatter step.  This script
measures, on one device at >= 1M rows of 3-D Poisson:

  - ILDU(0) setup wall and PER-APPLY wall (forward+D+backward sweeps),
  - the same for Jacobi, Chebyshev and structured-GMG preconditioners,
  - full PCG: iterations and warm wall for each.

The outcome routes users between polynomial/multigrid preconditioning
and level-scheduled ILDU at scale.  Prints one JSON line per row.
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
    ap.add_argument("--nx", type=int, default=100, help="grid (nx^3 rows)")
    ap.add_argument("--iters", type=int, default=200, help="max CG iters")
    ap.add_argument("--rtol", type=float, default=1e-6)
    ap.add_argument(
        "--skip", default="", help="comma-list of rows to skip (e.g. ildu)"
    )
    args = ap.parse_args()
    skip = set(filter(None, args.skip.split(",")))


    import jax
    import jax.numpy as jnp
    from jax import lax

    from bench import laplacian_3d_coo, timeit_loop
    from sigma_tpu import CSRMatrix, DIAMatrix
    from sigma_tpu.solvers import cg_solve

    nx = args.nx
    n, r, c, v = laplacian_3d_coo(nx)
    nnz = r.size
    print(f"# {nx}^3 = {n} rows, {nnz} nnz", file=sys.stderr)

    A_dia = DIAMatrix.from_coo(n, n, r, c, v, dtype=jnp.float32)
    xstar = np.sin(np.arange(n) * 0.001).astype(np.float32)
    b = jnp.asarray(np.asarray(A_dia.matvec(jnp.asarray(xstar))))

    def time_apply(M):
        def mk(K):
            @jax.jit
            def f(M, r):
                def body(i, vv):
                    return M.matvec(vv) * jnp.asarray(0.5, vv.dtype)

                return lax.fori_loop(0, K, body, r)

            return f

        return timeit_loop(mk, M, b, K=15)

    def run_pcg(name, M, A=A_dia, extra=None, flexible=False):
        solve = jax.jit(
            lambda A, bb, M: cg_solve(
                A, bb, tol=0.0, rtol=args.rtol, maxiter=args.iters, M=M,
                flexible=flexible,
            )
        )
        xs, info = solve(A, b, M)
        float(info.residual_norm)
        t1 = time.time()
        xs, info = solve(A, b, M)
        resn = float(info.residual_norm)
        t_warm = time.time() - t1
        row = {
            "metric": f"pcg_{name}",
            "n": n,
            "iterations": int(info.iterations),
            "relative_residual": f"{resn / float(jnp.linalg.norm(b)):.2e}",
            "wall_s_warm": round(t_warm, 3),
            "s_per_iteration": round(t_warm / max(int(info.iterations), 1), 4),
        }
        if extra:
            row.update(extra)
        print(json.dumps(row))

    # -- Jacobi (the baseline preconditioner) ------------------------------
    if "jacobi" not in skip:
        from sigma_tpu.solvers.base import JacobiSolver

        Mj = JacobiSolver().setup(A_dia)
        tj = time_apply(Mj)
        run_pcg("jacobi", Mj, extra={"apply_ms": round(tj * 1e3, 3)})

    # -- Chebyshev ---------------------------------------------------------
    if "chebyshev" not in skip:
        from sigma_tpu.solvers import chebyshev

        Mc = chebyshev(A_dia, degree=4, lmax=13.0, lmin=0.4)
        tc = time_apply(Mc)
        run_pcg(
            "chebyshev", Mc,
            extra={"apply_ms": round(tc * 1e3, 3)},
            flexible=True,
        )

    # -- structured GMG ----------------------------------------------------
    if "gmg" not in skip:
        from sigma_tpu.solvers import structured_pair_amg

        t0 = time.time()
        Mg = structured_pair_amg(A_dia, (nx, nx, nx), coarse_size=4096)
        setup_g = time.time() - t0
        tg = time_apply(Mg)
        run_pcg(
            "gmg", Mg,
            extra={
                "apply_ms": round(tg * 1e3, 3),
                "setup_s": round(setup_g, 2),
                "levels": len(Mg.levels),
            },
        )

    # -- ILDU(0) level-scheduled sweeps -------------------------------------
    if "ildu" not in skip:
        from sigma_tpu.solvers.ildu import LDUSolver

        A_csr = CSRMatrix.from_coo(n, n, r, c, v, dtype=jnp.float32)
        t0 = time.time()
        Mi = LDUSolver().setup(A_csr)
        setup_i = time.time() - t0
        nlev = (Mi.lower.nlev, Mi.upper.nlev)
        ti = time_apply(Mi)
        run_pcg(
            "ildu0", Mi,
            extra={
                "apply_ms": round(ti * 1e3, 3),
                "setup_s": round(setup_i, 2),
                "levels_fwd_bwd": nlev,
            },
        )


if __name__ == "__main__":
    main()
