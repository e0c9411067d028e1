#!/usr/bin/env python
"""North-star benchmark: CG on a 10M-row 3-D Laplacian, one chip.

The single-device measurement; the multi-device path is validated on the
virtual CPU mesh by tests/test_parallel.py and
__graft_entry__.dryrun_multichip, and on four GPUs by
``chip_smoke.py --chips 4``.

Prints one JSON line per measurement:
  - spmv_gnnz_s: DIA SpMV throughput at 10M rows
  - spmm_gnnz_s: multi-vector (8-wide) SpMM effective throughput
  - cg: iterations + relative residual of a jitted CG solve (f32)
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def laplacian_3d_coo_padded_strides(nx, stride):
    """7-point Laplacian + I on an nx^3 grid embedded with padded index
    strides (1, stride, stride^2), so the DIA offsets (+-1, +-stride,
    +-stride^2) are multiples of the 128-lane width when ``stride`` is.

    Kept as an option for studying layout effects; default off.
    """
    n_pad = ((nx - 1) * stride + (nx - 1)) * stride + nx  # last index + 1
    i = np.arange(nx, dtype=np.int64)
    idx = (i[:, None, None] * stride + i[None, :, None]) * stride + i[None, None, :]
    rows = [idx.ravel()]
    cols = [idx.ravel()]
    vals = [np.full(idx.size, 7.0)]
    for axis in range(3):
        for shift in (1, -1):
            sl_src = [slice(None)] * 3
            sl_dst = [slice(None)] * 3
            if shift == 1:
                sl_src[axis] = slice(0, nx - 1)
                sl_dst[axis] = slice(1, nx)
            else:
                sl_src[axis] = slice(1, nx)
                sl_dst[axis] = slice(0, nx - 1)
            src = idx[tuple(sl_src)].ravel()
            dst = idx[tuple(sl_dst)].ravel()
            rows.append(src)
            cols.append(dst)
            vals.append(np.full(src.size, -1.0))
    return (
        int(n_pad),
        np.concatenate(rows),
        np.concatenate(cols),
        np.concatenate(vals),
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=216, help="grid size (nx^3 rows)")
    ap.add_argument("--iters", type=int, default=100, help="CG iterations")
    ap.add_argument("--nrhs", type=int, default=8)
    ap.add_argument(
        "--pad-strides", type=int, default=0,
        help="pad grid index strides to this (0 = natural strides)",
    )
    ap.add_argument(
        "--symmetric", action="store_true",
        help="use SymmetricDIAMatrix (upper diagonals only, ~7.5n vs ~10n "
        "words/SpMV — the fastest path)",
    )
    ap.add_argument(
        "--fused", action="store_true",
        help="use Chronopoulos-Gear fused CG (one reduction point + one "
        "fused update block per iteration)",
    )
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from jax import lax

    from bench import laplacian_3d_coo, timeit_loop
    from sigma_tpu import DIAMatrix
    from sigma_tpu.solvers import cg_fused_solve, cg_solve

    nx = args.nx
    if args.pad_strides and args.pad_strides > nx:
        n, r, c, v = laplacian_3d_coo_padded_strides(nx, args.pad_strides)
    else:
        n, r, c, v = laplacian_3d_coo(nx)
    nnz = r.size
    print(
        f"# {nx}^3 grid = {nx**3} true rows (embedded n={n}), {nnz} nnz",
        file=sys.stderr,
    )

    A = DIAMatrix.from_coo(n, n, r, c, v, dtype=jnp.float32)
    if args.symmetric:
        from sigma_tpu.matrix.symmetric import SymmetricDIAMatrix

        A = SymmetricDIAMatrix.from_dia(A)
    x = jnp.ones((n,), jnp.float32)

    # SpMV throughput
    def mk(K):
        @jax.jit
        def f(A, x):
            def body(i, vv):
                return A.matvec(vv) * jnp.asarray(0.1, vv.dtype)

            return lax.fori_loop(0, K, body, x)

        return f

    t = timeit_loop(mk, A, x, K=100)
    spmv_val = round(nnz / t / 1e9, 2) if t > 1e-9 else None
    print(json.dumps({"metric": "spmv_gnnz_s", "value": spmv_val, "n": n}))

    # multi-vector SpMM (the capability the reference lacks, README.md:83)
    X = jnp.ones((n, args.nrhs), jnp.float32)
    apply = lambda A, V: A.matmat(V)

    def mkm(K):
        @jax.jit
        def f(A, X):
            def body(i, V):
                return apply(A, V) * jnp.asarray(0.1, V.dtype)

            return lax.fori_loop(0, K, body, X)

        return f

    t = timeit_loop(mkm, A, X, K=25)
    # a slope at the clamp floor means the workload is smaller than launch
    # jitter (tiny --nx smoke runs): report null rather than a fiction
    spmm_val = round(args.nrhs * nnz / t / 1e9, 2) if t > 1e-9 else None
    print(json.dumps({
        "metric": "spmm_gnnz_s",
        "value": spmm_val,
        "nrhs": args.nrhs,
    }))

    # CG solve: manufactured RHS, fixed iteration budget, f32
    xstar = jnp.asarray(
        np.sin(np.arange(n, dtype=np.float32) * 0.001), dtype=jnp.float32
    )
    b = A.matvec(xstar)
    solve = jax.jit(
        lambda A, b: (cg_fused_solve if args.fused else cg_solve)(
            A, b, tol=0.0, rtol=1e-6, maxiter=args.iters
        )
    )
    t0 = time.perf_counter()
    xs, info = solve(A, b)
    resn = float(info.residual_norm)  # sync
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    xs, info = solve(A, b)
    resn = float(info.residual_norm)
    t_warm = time.perf_counter() - t0
    iters = int(info.iterations)
    rel = resn / float(jnp.linalg.norm(b))
    print(json.dumps({
        "metric": "cg_10m",
        "iterations": iters,
        "relative_residual": f"{rel:.3e}",
        "wall_s_incl_compile": round(t_cold, 2),
        "wall_s_warm": round(t_warm, 2),
        "s_per_iteration": round(t_warm / max(iters, 1), 4),
    }))


if __name__ == "__main__":
    main()
