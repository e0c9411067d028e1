#!/usr/bin/env python
"""Gather-free multigrid on a structured grid (no reference analogue; the
multilevel intent of /root/reference/src/solver/README.md realized
gather-free): a 3-D Dirichlet Poisson problem in DIA form, solved with
plain CG, then CG preconditioned by structured pair-aggregation
multigrid — aggregates are grid-cell pairs, transfers are
reshapes/repeats, the Galerkin coarse operators are computed in closed
form on the diagonal value grids (a 7-point stencil stays 7-point on
every level), and the whole preconditioned solve compiles to one XLA
program.
"""

import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import _common  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np

from sigma_tpu import DIAMatrix
from sigma_tpu.solvers import cg_solve, structured_pair_amg


def poisson_3d(nx):
    """Pure Dirichlet Laplacian on an nx^3 grid, directly in DIA form."""
    n = nx**3
    i = np.arange(n)
    iz, iy, ix = i % nx, (i // nx) % nx, i // (nx * nx)
    offs = (-nx * nx, -nx, -1, 0, 1, nx, nx * nx)
    rows, cols, vals = [i], [i], [np.full(n, 6.0)]
    for o, mk in (
        (1, iz < nx - 1), (-1, iz > 0),
        (nx, iy < nx - 1), (-nx, iy > 0),
        (nx * nx, ix < nx - 1), (-nx * nx, ix > 0),
    ):
        rows.append(i[mk])
        cols.append(i[mk] + o)
        vals.append(np.full(mk.sum(), -1.0))
    return DIAMatrix.from_coo(
        n, n, np.concatenate(rows), np.concatenate(cols),
        np.concatenate(vals), dtype=jnp.float64,
    )


def main():
    nx = 24
    dims = (nx, nx, nx)
    A = poisson_3d(nx)
    n = A.shape[0]
    rng = np.random.default_rng(0)
    xstar = rng.standard_normal(n)
    b = A.matvec(jnp.asarray(xstar))

    x, info = cg_solve(A, b, tol=0.0, rtol=1e-10, maxiter=2000)
    print(f"plain CG:        {int(info.iterations):4d} iterations, "
          f"err {np.max(np.abs(np.asarray(x) - xstar)):.2e}")

    # pairwise aggregates (2 cells per aggregate, deepest hierarchy)
    M = structured_pair_amg(A, dims)
    x, info = cg_solve(A, b, tol=0.0, rtol=1e-10, M=M, maxiter=2000)
    print(f"CG + MG (pairs): {int(info.iterations):4d} iterations, "
          f"err {np.max(np.abs(np.asarray(x) - xstar)):.2e}, "
          f"{len(M.levels)} levels")

    # 2x2x2 cube aggregates: 3x shallower hierarchy, similar quality —
    # the setting chip_smoke.py uses at the 10M-row north star
    M8 = structured_pair_amg(A, dims, pairs_per_level=3)
    solve = jax.jit(
        lambda A, b, M: cg_solve(A, b, tol=0.0, rtol=1e-10, M=M, maxiter=2000)
    )
    x, info = solve(A, b, M8)  # whole solve = one compiled program
    print(f"CG + MG (cubes): {int(info.iterations):4d} iterations, "
          f"err {np.max(np.abs(np.asarray(x) - xstar)):.2e}, "
          f"{len(M8.levels)} levels (jitted end-to-end)")


if __name__ == "__main__":
    main()
