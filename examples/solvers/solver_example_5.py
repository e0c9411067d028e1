#!/usr/bin/env python
"""The unstructured-at-scale recipe (no reference analogue — this is
where the framework goes beyond the reference's serial CSR solve): any-pattern matrix -> RCM -> pruned block-DIA -> CG with the
pair-AMG multilevel preconditioner, all in the permuted frame.
"""

import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import _common  # noqa: F401

import jax.numpy as jnp
import numpy as np

from sigma_tpu import CSRMatrix
from sigma_tpu.matrix.banded import to_pruned_dia
from sigma_tpu.solvers import cg_solve, pruned_pair_amg


def main():
    rng = np.random.default_rng(7)
    # an irregular SPD operator: mesh-local couplings, shuffled labels
    from sigma_tpu.apps.generators import irregular_mesh_laplacian

    A0 = irregular_mesh_laplacian(96, 32, rng=rng, shift=1e-2,
                                  dtype=np.float32)
    n = A0.shape[0]
    rr, cc, vv = A0.entries()
    sh = rng.permutation(n)
    A = CSRMatrix.from_coo(n, n, sh[rr], sh[cc], vv, dtype=np.float32)

    # pack: RCM reorder + only the active (row-tile x diagonal) blocks
    P, p = to_pruned_dia(A, tile_rows=1024, group=4)
    print(f"n={n}: packed {P.stored_slots} slots for {P.nnz} nonzeros "
          f"(local occupancy {P.nnz / P.stored_slots:.2f})")

    xstar = rng.standard_normal(n).astype(np.float32)
    b = np.asarray(A.matvec(jnp.asarray(xstar)))
    b_p = np.empty_like(b)
    b_p[p] = b  # into the permuted frame

    x0, info0 = cg_solve(P, jnp.asarray(b_p), tol=0.0, rtol=1e-8,
                         maxiter=2000)
    rows, cols, vals = A.entries()
    M = pruned_pair_amg(n, p[rows], p[cols], vals, coarse_size=256,
                        tile_rows=1024, group=4, fine_A=P)
    x1, info1 = cg_solve(P, jnp.asarray(b_p), tol=0.0, rtol=1e-8,
                         maxiter=2000, M=M)
    err = np.abs(np.asarray(x1)[p] - xstar).max()
    print(f"plain CG:      {int(info0.iterations)} iterations")
    print(f"pair-AMG CG:   {int(info1.iterations)} iterations "
          f"({len(M.levels)} pruned levels), max err {err:.2e}")


if __name__ == "__main__":
    main()
