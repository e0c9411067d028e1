#!/usr/bin/env python
"""Measure the FMG claim: where does the
full-multigrid initial guess pay?

Pseudo-timestepping on the 10.1M-row 3-D Poisson north star: a sequence
of solves  A x_t = b_t  with a slowly drifting right-hand side
(b_t = A @ u_t for a manufactured u_t whose phase advances by ``drift``
per step — the classic implicit-time-integration workload).  Per-step
strategies, all solved by GMG-preconditioned CG to the same rtol:

  cold       x0 = 0                    (the round-3 baseline)
  fmg        x0 = M.fmg(b_t)           (nested-iteration guess)
  warm       x0 = x_{t-1}              (previous solution)
  warm+fmg   x0 = x_{t-1} + M.fmg(r)   (FMG on the residual)

Reports iterations and wall per step.  One JSON line per strategy.
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
    ap.add_argument("--nx", type=int, default=216)
    ap.add_argument("--rtol", type=float, default=1e-6)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--drift", type=float, default=0.05,
                    help="phase advance of the manufactured solution per "
                    "step (small = strongly warm-startable)")
    ap.add_argument("--ppl", type=int, default=3)
    ap.add_argument("--smoother", default="chebyshev")
    args = ap.parse_args()


    import jax
    import jax.numpy as jnp

    from bench import laplacian_3d_dia
    from sigma_tpu import DIAMatrix
    from sigma_tpu.graph.graph import DIAGraph
    from sigma_tpu.solvers import cg_solve, structured_pair_amg

    nx = args.nx
    n, offsets, data, nnz = laplacian_3d_dia(nx)
    data[3, :n] = 6.0
    g = DIAGraph(offsets=offsets, shape=(n, n), nnz=nnz)
    A = DIAMatrix(graph=g, data=jnp.asarray(data.reshape(7, -1, 128)))
    t0 = time.time()
    M = structured_pair_amg(
        A, (nx, nx, nx), smoother=args.smoother,
        pairs_per_level=args.ppl, host_data=data,
    )
    print(f"# n={n} setup {time.time()-t0:.0f}s", file=sys.stderr)

    idx = np.arange(n, dtype=np.float64)

    def u_t(t):
        return np.sin(0.001 * idx + args.drift * t).astype(np.float32)

    solve = jax.jit(
        lambda A_, b_, M_, x0: cg_solve(
            A_, b_, x0=x0, tol=0.0, rtol=args.rtol, maxiter=400, M=M_
        )
    )
    fmg = jax.jit(lambda M_, b_: M_.fmg(b_))
    mv = jax.jit(lambda A_, x_: A_.matvec(x_))

    bs = []
    for t in range(args.steps):
        bs.append(jnp.asarray(np.asarray(mv(A, jnp.asarray(u_t(t))))))

    zero = jnp.zeros((n,), jnp.float32)
    # warm up all programs
    x, info = solve(A, bs[0], M, zero)
    float(info.residual_norm)
    xf = fmg(M, bs[0])
    float(xf[0])

    for strat in ("cold", "fmg", "warm", "warm_fmg"):
        iters, wall = [], 0.0
        x_prev = None
        for t in range(args.steps):
            t1 = time.time()
            if strat == "cold":
                x0 = zero
            elif strat == "fmg":
                x0 = fmg(M, bs[t])
            elif strat == "warm":
                x0 = x_prev if x_prev is not None else zero
            else:
                if x_prev is None:
                    x0 = fmg(M, bs[t])
                else:
                    r = bs[t] - mv(A, x_prev)
                    x0 = x_prev + fmg(M, r)
            x, info = solve(A, bs[t], M, x0)
            it = int(info.iterations)
            wall += time.time() - t1
            iters.append(it)
            x_prev = x
        print(json.dumps({
            "metric": "fmg_sequence",
            "strategy": strat,
            "steps": args.steps,
            "drift": args.drift,
            "iterations_per_step": iters,
            "mean_iterations": round(float(np.mean(iters)), 2),
            "wall_s_total": round(wall, 2),
            "wall_s_per_step": round(wall / args.steps, 3),
        }))


if __name__ == "__main__":
    main()
