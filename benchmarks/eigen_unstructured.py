#!/usr/bin/env python
"""Eigenpairs of an UNSTRUCTURED operator at scale: LOBPCG on the
1M-row irregular-mesh Laplacian through the round-4 pruned machinery —
block matvecs ride the pruned SpMM (values streamed once per 16-wide
pass) and the preconditioner is the pruned-pair-GMG V-cycle applied
blockwise.

The reference's eigensolver (eigensolver.f90) runs Lanczos on any-format
matrices at CPU rates; this is the same capability for matrices with no
stencil structure on the device.  Accuracy oracle: residual norms
||A v - lambda v|| (no closed-form spectrum exists for a random mesh).
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
    ap.add_argument("--m", type=int, default=8, help="eigenpairs")
    ap.add_argument("--maxiter", type=int, default=60)
    ap.add_argument("--shift", type=float, default=1e-3)
    ap.add_argument("--refine", action="store_true",
                    help="f64 Rayleigh-Ritz refinement of the lowest 3 "
                         "Ritz pairs")
    args = ap.parse_args()


    import jax

    # NOTE: --refine runs its f64 work on the HOST (numpy bincount
    # matvecs) with f32 device inner solves.
    import jax.numpy as jnp

    from sigma_tpu.apps.generators import irregular_mesh_laplacian
    from sigma_tpu.graph.permutations import reverse_cuthill_mckee
    from sigma_tpu.matrix.formats import CSRMatrix
    from sigma_tpu.matrix.pruned import PrunedDIAMatrix
    from sigma_tpu.eigen import lobpcg
    from sigma_tpu.solvers import pruned_pair_amg

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
    P = PrunedDIAMatrix.from_coo(n, n, pr, pc, vals, dtype=np.float32,
                                 assume_unique=True)
    t0 = time.time()
    Mg = pruned_pair_amg(n, pr, pc, vals, coarse_size=4096,
                         smoother="chebyshev", fine_A=P)
    t_setup = time.time() - t0
    print(f"# n={n} nnz={nnz} gmg setup {t_setup:.0f}s", file=sys.stderr)

    X0 = jnp.asarray(
        rng.standard_normal((n, args.m)).astype(np.float32)
    )
    run_plain = jax.jit(
        lambda A_, X_: lobpcg(A_, X_, tol=1e-5, maxiter=args.maxiter)
    )
    run_pc = jax.jit(
        lambda A_, X_, M_: lobpcg(A_, X_, M=M_, tol=1e-5,
                                  maxiter=args.maxiter)
    )
    for tag, M in (("plain", None), ("gmg_preconditioned", Mg)):
        run = (lambda A_, X_: run_pc(A_, X_, M)) if M is not None \
            else run_plain
        res = run(P, X0)
        jax.block_until_ready(res.eigenvalues)
        t0 = time.time()
        res = run(P, X0)
        lam = np.asarray(res.eigenvalues, dtype=np.float64)
        t_warm = time.time() - t0
        V = res.eigenvectors
        R = P.matmat(V) - V * res.eigenvalues[None, :]
        rn = np.asarray(jnp.linalg.norm(R, axis=0) / jnp.linalg.norm(V, axis=0))
        print(json.dumps({
            "metric": "eigen_unstructured_lobpcg",
            "config": tag,
            "m": args.m,
            "iterations": int(res.iterations),
            "eigenvalues_low3": [float(f"{v:.6e}") for v in lam[:3]],
            "max_residual_norm": f"{rn.max():.3e}",
            "wall_s_warm": round(t_warm, 2),
        }))

    # the at-scale recipe (same as benchmarks/geneigen3d.py): INVERSE
    # Lanczos on the pencil (I, A) — each step solves A w = v with
    # pruned-GMG-CG, so the Krylov space targets the LOWEST eigenvalues
    # directly; pencil eigenvalues are 1/mu
    from sigma_tpu.eigen import generalized_lanczos
    from sigma_tpu.operators import IdentityOperator, attach_solver
    from sigma_tpu.solvers import cg

    Ps = attach_solver(P, cg(tolerance=0.0, rtol=1e-7), preconditioner=Mg)
    I = IdentityOperator(n=n)
    v0 = rng.standard_normal(n).astype(np.float32)
    k = 24
    run_l = jax.jit(lambda I_, Ps_: generalized_lanczos(I_, Ps_, k, v0=v0))
    res_l = run_l(I, Ps)
    float(res_l.alpha[0])
    t0 = time.time()
    res_l = run_l(I, Ps)
    float(res_l.alpha[0])
    t_l = time.time() - t0
    T = np.asarray(res_l.tridiagonal(), dtype=np.float64)
    theta, Q = np.linalg.eigh(T)
    mus = np.sort(1.0 / theta[theta > 0])[:3]
    # honest residuals: f64 Rayleigh quotients of the Ritz vectors
    V = np.asarray(res_l.V, dtype=np.float64)
    order = np.argsort(-theta)
    rq = []
    for j in order[:3]:
        v = V @ Q[:, j]
        v = v / np.linalg.norm(v)
        Av = np.asarray(P.matvec(jnp.asarray(v.astype(np.float32))),
                        dtype=np.float64)
        lam_j = float(v @ Av)
        rq.append((lam_j, float(np.linalg.norm(Av - lam_j * v))))
    print(json.dumps({
        "metric": "eigen_unstructured_inverse_lanczos",
        "k_steps": k,
        "lowest3_pencil": [float(f"{m_:.6e}") for m_ in mus],
        "lowest3_rayleigh": [float(f"{a:.6e}") for a, _ in rq],
        "residual_norms": [f"{r:.3e}" for _, r in rq],
        "wall_s_warm": round(t_l, 2),
    }))

    if args.refine:
        # f64-grade eigenpairs over the PRUNED operator:
        # inverse-iteration refinement of the inverse-Lanczos
        # Ritz block — each column solve is the classic mixed-precision
        # ladder with the f64 residual/Rayleigh work in HOST numpy
        # (bincount matvec over the COO triples) and every Krylov
        # matvec on the f32 pruned kernels with GMG preconditioning;
        # block QR per step keeps the columns from collapsing onto the
        # dominant inverse mode; exact f64 Rayleigh-Ritz at the end.
        vals64 = vals.astype(np.float64)
        from sigma_tpu.solvers import cg_solve

        inner = jax.jit(
            lambda A_, M_, r_: cg_solve(
                A_, r_, tol=0.0, rtol=1e-6, maxiter=400, M=M_
            )[0]
        )

        # Shift-invert Lanczos design space (iteration behaviour at 1M
        # rows): the mesh's low spectrum is a
        # near-continuum above lambda_1 = shift, so (a) inverse
        # ITERATION floors at max_q c0*(l1/lq)^k*(lq-l1) ~
        # 0.37*c0*l1/k (stuck at ~1e-5 after 6 steps); (b) plain
        # B = A^{-1} Lanczos contracts at only ~0.81/step; (c) an
        # AGGRESSIVE shift (sigma = 0.99*l1, gap ratio ~0.5) breaks
        # the f32 INNER solves instead (kappa(M^-1(A-sigma)) ~ 100,
        # ladder sweeps max out without converging).  The working
        # point is sigma = 0.9*l1: the ladder still converges to
        # 1e-13 in 3 sweeps and the Lanczos contracts at a measured
        # ~0.83/step — ~80 f64-grade steps reach the 1e-8 residuals.
        # (l1 here is the f32 Rayleigh estimate, accurate to
        # res^2/gap ~ 1e-7 — 0.9x is a certain lower bound.)
        from sigma_tpu.eigen import shift_invert_lanczos

        sigma = 0.9 * float(mus[0])
        vals_sig = vals64.copy()
        vals_sig[pr == pc] -= sigma
        P_sig = PrunedDIAMatrix.from_coo(
            n, n, pr, pc, vals_sig.astype(np.float32),
            dtype=np.float32, assume_unique=True,
        )
        t0 = time.time()
        res_r = shift_invert_lanczos(
            n, pr, pc, vals64, sigma=sigma, m=3, k=84, sweeps=3,
            inner_solve=lambda r32: np.asarray(
                inner(P_sig, Mg, jnp.asarray(r32))
            ),
        )
        t_ref = time.time() - t0
        print(json.dumps({
            "metric": "eigen_unstructured_refined",
            "sigma": float(f"{sigma:.6e}"),
            "lanczos_steps": int(res_r.steps),
            "lowest3_refined": [
                float(f"{w_:.12e}") for w_ in res_r.eigenvalues
            ],
            "ritz_residuals": [
                f"{r_:.3e}" for r_ in res_r.residuals
            ],
            "refine_s": round(t_ref, 1),
        }))


if __name__ == "__main__":
    main()
