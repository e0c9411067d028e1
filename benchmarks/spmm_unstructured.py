#!/usr/bin/env python
"""Multi-RHS SpMM on the unstructured north star:
symmetric chunked SpMM with the uncapped mirror-scratch kernel, and the
pruned SpMM, at several RHS counts.  One JSON line per measurement.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--height", type=int, default=16384)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ks", default="4,8,16")
    ap.add_argument("--bf16", action="store_true")
    args = ap.parse_args()


    import jax
    import jax.numpy as jnp
    from jax import lax

    from bench import timeit_loop
    from sigma_tpu.apps.generators import irregular_mesh_laplacian
    from sigma_tpu.matrix.banded import to_banded_dia, to_pruned_dia
    from sigma_tpu.matrix.formats import CSRMatrix
    from sigma_tpu.matrix.symmetric import SymmetricDIAMatrix

    rng = np.random.default_rng(args.seed)
    A = irregular_mesh_laplacian(args.height, args.width, rng=rng,
                                 dtype=np.float32)
    n = A.shape[0]
    rr, cc, vv = A.entries()
    sh = rng.permutation(n)
    A = CSRMatrix.from_coo(n, n, sh[rr], sh[cc], vv, dtype=np.float32)
    nnz = int(A.graph.nnz)
    D, p = to_banded_dia(A)
    Ds = SymmetricDIAMatrix.from_dia(D)
    P, _ = to_pruned_dia(A)
    print(f"# n={n} nnz={nnz} diags={D.graph.n_diags} "
          f"upper={len(Ds.offsets)}", file=sys.stderr)

    def loop(fn):
        def mk(K):
            @jax.jit
            def f(op, V):
                def body(i, vv):
                    return fn(op, vv) * jnp.asarray(0.1, vv.dtype)

                return lax.fori_loop(0, K, body, V)

            return f

        return mk

    x = jnp.ones((n,), jnp.float32)
    t_sym1 = timeit_loop(loop(lambda M, v: M.matvec(v)), Ds, x, K=200)
    t_pr1 = timeit_loop(loop(lambda M, v: M.matvec(v)), P, x, K=200)
    print(json.dumps({
        "metric": "spmv_baselines",
        "sym_ms": round(t_sym1 * 1e3, 3),
        "pruned_ms": round(t_pr1 * 1e3, 3),
    }))

    mats = [("f32", Ds, P)]
    if args.bf16:
        Dsb = SymmetricDIAMatrix(
            data=Ds.data.astype(jnp.bfloat16), offsets=Ds.offsets, n=n
        )
        mats.append(("bf16", Dsb, P.astype(jnp.bfloat16)))

    for k in [int(s) for s in args.ks.split(",")]:
        XT = jnp.ones((k, n), jnp.float32)
        for dname, Dsym, Ppr in mats:
            # symmetric chunked SpMM (uncapped mirror-scratch kernel)
            try:
                t = timeit_loop(
                    loop(lambda M, V: M.matmat_rhs_major(V)), Dsym, XT,
                    K=120,
                )
                print(json.dumps({
                    "metric": "sym_spmm", "k": k, "dtype": dname,
                    "ms": round(t * 1e3, 3),
                    "true_eff_gnnz_s": round(k * nnz / t / 1e9, 3),
                    "per_rhs_speedup_vs_sym_spmv": round(k * t_sym1 / t, 2),
                }))
            except Exception as e:
                print(json.dumps({
                    "metric": "sym_spmm", "k": k, "dtype": dname,
                    "error": f"{type(e).__name__}: {e}"[:200],
                }))
            # pruned SpMM
            try:
                t = timeit_loop(
                    loop(lambda M, V: M.matmat_rhs_major(V)), Ppr, XT,
                    K=120,
                )
                print(json.dumps({
                    "metric": "pruned_spmm", "k": k, "dtype": dname,
                    "ms": round(t * 1e3, 3),
                    "true_eff_gnnz_s": round(k * nnz / t / 1e9, 3),
                    "per_rhs_speedup_vs_pruned_spmv": round(
                        k * t_pr1 / t, 2
                    ),
                }))
            except Exception as e:
                print(json.dumps({
                    "metric": "pruned_spmm", "k": k, "dtype": dname,
                    "error": f"{type(e).__name__}: {e}"[:200],
                }))


if __name__ == "__main__":
    main()
