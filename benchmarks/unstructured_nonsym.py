#!/usr/bin/env python
"""Nonsymmetric unstructured solve at scale: the reference's
skew-perturbed solver test (``solver_test_jacobi.f90`` adds a skew
perturbation and re-solves with BiCG-stab) scaled to the 1M+-row
irregular mesh through the pruned pipeline.

Operator: A = L + beta * (W - W^T) on the mesh edges (L the shifted
Laplacian, W the upper-edge weights) — diagonally dominant, genuinely
nonsymmetric.  Solvers: BiCG-stab plain vs pruned-pair-GMG
preconditioned (the closed-form Galerkin coarsening is value-agnostic,
so it coarsens nonsymmetric operators directly, as structured GMG does
on advection-diffusion).
One JSON line per configuration.
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
    ap.add_argument("--beta", type=float, default=0.3)
    ap.add_argument("--shift", type=float, default=1e-3)
    ap.add_argument("--iters", type=int, default=500)
    args = ap.parse_args()


    import jax
    import jax.numpy as jnp

    from sigma_tpu.apps.generators import irregular_mesh_laplacian
    from sigma_tpu.graph.permutations import reverse_cuthill_mckee
    from sigma_tpu.matrix.formats import CSRMatrix
    from sigma_tpu.matrix.pruned import PrunedDIAMatrix
    from sigma_tpu.solvers import (
        auto_pruned_preconditioner,
        bicgstab_solve,
        fgmres_solve,
        pruned_pair_amg,
        skew_dominance,
    )

    rng = np.random.default_rng(args.seed)
    A = irregular_mesh_laplacian(args.height, args.width, rng=rng,
                                 dtype=np.float32, shift=args.shift)
    n = A.shape[0]
    rr, cc, vv = A.entries()
    # skew perturbation along the stored edges: +beta*v above the
    # diagonal, -beta*v below (keeps diagonal dominance for |beta| < 1)
    vv = np.asarray(vv).copy()
    off = np.asarray(cc) - np.asarray(rr)
    vv = vv + args.beta * np.sign(off) * np.abs(vv)
    sh = rng.permutation(n)
    A = CSRMatrix.from_coo(n, n, sh[rr], sh[cc], vv, dtype=np.float32)
    nnz = int(A.graph.nnz)
    p = reverse_cuthill_mckee(A.graph)
    rows, cols, vals = A.entries()
    pr, pc = p[rows], p[cols]
    P = PrunedDIAMatrix.from_coo(n, n, pr, pc, vals, dtype=np.float32,
                                 assume_unique=True)
    t0 = time.time()
    Mg = pruned_pair_amg(n, pr, pc, vals, coarse_size=4096,
                         smoother="jacobi", fine_A=P)
    t_setup = time.time() - t0
    t0 = time.time()
    s_dom = skew_dominance(pr, pc, vals)
    t_skew = time.time() - t0
    # the in-code route (auto_pruned_preconditioner re-derives it; here
    # we report the statistic + decision without paying a second setup)
    route = "plain" if s_dom > 0.05 else "pruned_gmg"
    print(json.dumps({
        "metric": "unstructured_nonsym_route",
        "beta": args.beta,
        "skew_dominance": round(s_dom, 4),
        "route": route,
        "skew_stat_s": round(t_skew, 2),
    }))
    print(f"# n={n} nnz={nnz} beta={args.beta} setup {t_setup:.0f}s "
          f"skew_dom {s_dom:.3f} -> {route}", file=sys.stderr)

    xstar = np.sin(np.arange(n) * 0.001).astype(np.float32)
    b = np.asarray(A.matvec(jnp.asarray(xstar)))
    b_p = np.empty_like(b)
    b_p[p] = b
    b_p = jnp.asarray(b_p)
    bnorm = float(np.linalg.norm(b))

    solve_plain = jax.jit(
        lambda A_, bb: bicgstab_solve(
            A_, bb, tol=0.0, rtol=1e-6, maxiter=args.iters
        )
    )
    # M as an ARGUMENT: a captured hierarchy is embedded in the program
    # as constants
    solve_pc = jax.jit(
        lambda A_, bb, M_: bicgstab_solve(
            A_, bb, tol=0.0, rtol=1e-6, maxiter=args.iters, M=M_
        )
    )
    M_auto = None if route == "plain" else Mg
    for tag, M in (
        ("plain", None),
        ("pruned_gmg", Mg),
        ("auto_route", M_auto),
    ):
        solve = (lambda A_, bb: solve_pc(A_, bb, M)) if M is not None \
            else solve_plain
        x, info = solve(P, b_p)
        float(info.residual_norm)
        t0 = time.time()
        x, info = solve(P, b_p)
        resn = float(info.residual_norm)
        t_warm = time.time() - t0
        err = float(np.abs(np.asarray(x)[p] - xstar).max())
        print(json.dumps({
            "metric": "unstructured_nonsym_bicgstab",
            "config": tag,
            "iterations": int(info.iterations),
            "relative_residual": f"{resn / bnorm:.3e}",
            "max_err_vs_manufactured": f"{err:.3e}",
            "wall_s_warm": round(t_warm, 3),
        }))

    # FGMRES with an inner fixed-iteration BiCG-stab preconditioner —
    # the flexible composition for nonsymmetric systems
    solve_fg = jax.jit(
        lambda A_, bb: fgmres_solve(
            A_, bb, tol=0.0, rtol=1e-6, restart=32, maxiter=args.iters,
            M=lambda v: bicgstab_solve(A_, v, tol=0.0, rtol=0.0,
                                       maxiter=4)[0],
        )
    )
    x, info = solve_fg(P, b_p)
    float(info.residual_norm)
    t0 = time.time()
    x, info = solve_fg(P, b_p)
    resn = float(info.residual_norm)
    t_warm = time.time() - t0
    err = float(np.abs(np.asarray(x)[p] - xstar).max())
    print(json.dumps({
        "metric": "unstructured_nonsym_fgmres_inner_bicgstab",
        "outer_iterations": int(info.iterations),
        "inner_per_outer": 4,
        "relative_residual": f"{resn / bnorm:.3e}",
        "max_err_vs_manufactured": f"{err:.3e}",
        "wall_s_warm": round(t_warm, 3),
    }))


if __name__ == "__main__":
    main()
