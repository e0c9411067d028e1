#!/usr/bin/env python
"""The unstructured-at-scale recipe end-to-end at example size (no
reference analogue — this is the round-5 capability set the other
solver examples build toward): an irregular SPD mesh through

1. the host-only setup pipeline (COO -> RCM reorder, no device bounces),
2. SYMMETRIC pruned block-DIA storage (upper triangle + in-kernel
   mirror; half the value stream of full pruned),
3. the symmetric pruned multilevel preconditioner,
4. the in-code skew router for a nonsymmetric variant (pair-AMG helps
   elliptic-dominant operators and HURTS strongly skewed ones — the
   router measures ||A - A^T||_F / ||A + A^T||_F and decides), and
5. FGMRES with an inner Krylov solve as the preconditioner.

At the real north star (10M rows) the same calls pack 1.0 GB where full
DIA would need 9.9 GB — see benchmarks/unstructured_pruned.py.
"""

import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import _common  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np

from sigma_tpu.apps import irregular_mesh_laplacian_coo
from sigma_tpu.matrix.banded import reorder_triples_rcm
from sigma_tpu.matrix.pruned import (
    PrunedDIAMatrix,
    SymmetricPrunedDIAMatrix,
)
from sigma_tpu.solvers import (
    auto_pruned_preconditioner,
    bicgstab_solve,
    cg_solve,
    fgmres_solve,
    pruned_pair_amg,
)


def main():
    rng = np.random.default_rng(0)
    # 1. shuffled irregular mesh -> RCM, all on the host
    n, rows, cols, vals = irregular_mesh_laplacian_coo(
        96, 32, rng=rng, shift=1e-2, shuffle=True
    )
    pr, pc, vals, p = reorder_triples_rcm(n, rows, cols, vals)
    vals = vals.astype(np.float32)  # one dtype end-to-end
    print(f"mesh: n={n}, nnz={rows.size}, "
          f"bandwidth after RCM={int(np.abs(pc - pr).max())}")

    # 2. symmetric pruned storage (the SPD fast path)
    S = SymmetricPrunedDIAMatrix.from_coo(
        n, n, pr, pc, vals, dtype=np.float32, tile_rows=1024, group=4
    )
    P = PrunedDIAMatrix.from_coo(
        n, n, pr, pc, vals, dtype=np.float32, tile_rows=1024, group=4
    )
    print(f"packed slots: full {P.stored_slots}, "
          f"symmetric {S.stored_slots} "
          f"({P.stored_slots / S.stored_slots:.2f}x fewer)")

    # 3. symmetric multilevel preconditioner + CG (in the RCM frame:
    #    permute b in, solution out)
    M = pruned_pair_amg(n, pr, pc, vals, coarse_size=512, tile_rows=1024,
                        group=4, symmetric=True, validate=False)
    xstar = rng.standard_normal(n).astype(np.float32)
    b = np.asarray(S.matvec(jnp.asarray(xstar)))
    x_pl, info_pl = jax.jit(
        lambda A_, b_: cg_solve(A_, b_, tol=0.0, rtol=1e-8, maxiter=500)
    )(S, jnp.asarray(b))
    x_mg, info_mg = jax.jit(
        lambda A_, M_, b_: cg_solve(A_, b_, tol=0.0, rtol=1e-8,
                                    maxiter=500, M=M_)
    )(S, M, jnp.asarray(b))
    print(f"CG plain: {int(info_pl.iterations)} iterations; "
          f"+sym-GMG: {int(info_mg.iterations)}; "
          f"err {float(np.abs(np.asarray(x_mg) - xstar).max()):.2e}")

    # 4. a nonsymmetric variant through the skew router
    skew = (vals + 0.05 * np.sign(pc - pr) * np.abs(vals)).astype(np.float32)
    Mn, route = auto_pruned_preconditioner(
        n, pr, pc, skew, coarse_size=512, tile_rows=1024, group=4,
        smoother="jacobi",
    )
    print(f"router: skew_dominance={route['skew_dominance']:.4f} -> "
          f"{route['route']}")
    Pn = PrunedDIAMatrix.from_coo(n, n, pr, pc, skew, dtype=np.float32,
                                  tile_rows=1024, group=4)
    bn = np.asarray(Pn.matvec(jnp.asarray(xstar)))
    if Mn is not None:
        xn, infon = jax.jit(
            lambda A_, M_, b_: bicgstab_solve(A_, b_, tol=0.0, rtol=1e-8,
                                              maxiter=500, M=M_)
        )(Pn, Mn, jnp.asarray(bn))
    else:
        xn, infon = jax.jit(
            lambda A_, b_: bicgstab_solve(A_, b_, tol=0.0, rtol=1e-8,
                                          maxiter=500)
        )(Pn, jnp.asarray(bn))
    print(f"BiCG-stab via route: {int(infon.iterations)} iterations, "
          f"err {float(np.abs(np.asarray(xn) - xstar).max()):.2e}")

    # 5. FGMRES with an inner fixed-iteration Krylov preconditioner
    xf, infof = jax.jit(
        lambda A_, b_: fgmres_solve(
            # rtol 1e-6: f32 FGMRES residuals floor near 1e-7 — a
            # tighter target just exhausts maxiter after converging
            A_, b_, tol=0.0, rtol=1e-6, restart=30, maxiter=300,
            M=lambda v: bicgstab_solve(A_, v, tol=0.0, maxiter=4)[0],
        )
    )(Pn, jnp.asarray(bn))
    print(f"FGMRES(inner BiCG-stab x4): {int(infof.iterations)} outer "
          f"iterations, err {float(np.abs(np.asarray(xf) - xstar).max()):.2e}")


if __name__ == "__main__":
    main()
