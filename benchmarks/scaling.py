#!/usr/bin/env python
"""Scaling-efficiency harness (BASELINE.json measurement points: 1 chip ->
1 host -> N hosts).

On real multi-device hardware this measures distributed CG wall-clock at
each device count and reports parallel efficiency
``t_1 / (D * t_D)`` (weak scaling keeps rows/device constant; strong
scaling keeps the global problem fixed).  The >85% 2-host target lives
here.  On a single-chip or virtual-CPU environment it still runs (the
driver's dryrun path), reporting the correctness + the per-count timings —
labelled simulated, since virtual devices share one physical machine.

Usage: python benchmarks/scaling.py [--rows-per-device 250000] [--mode weak]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def laplacian_1d_coo(n):
    i = np.arange(n)
    rows = np.concatenate([i, i[:-1], i[1:]])
    cols = np.concatenate([i, i[1:], i[:-1]])
    vals = np.concatenate([np.full(n, 2.5), np.full(n - 1, -1.0), np.full(n - 1, -1.0)])
    return rows, cols, vals


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows-per-device", type=int, default=250_000)
    ap.add_argument("--mode", choices=["weak", "strong"], default="weak")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--virtual", type=int, default=0,
                    help="force N virtual CPU devices (0 = use real devices)")
    # multi-host plumbing: launch one process per host with identical
    # args plus --coordinator/--num-processes/--process-id
    ap.add_argument("--sym", action="store_true",
                    help="with --pruned: symmetric-storage shards "
                         "(upper triangle + mirror-spill ppermute)")
    ap.add_argument("--pruned", action="store_true",
                    help="also scale the UNSTRUCTURED pruned path "
                    "(DistributedPrunedMatrix CG, same protocol)")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 for "
                    "jax.distributed.initialize (multi-host runs)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    args = ap.parse_args()

    if args.virtual:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.virtual}"
        ).strip()
        import jax

        jax.config.update("jax_platforms", "cpu")
    else:
        import jax

        if args.coordinator:
            jax.distributed.initialize(
                coordinator_address=args.coordinator,
                num_processes=args.num_processes,
                process_id=args.process_id,
            )

    import jax.numpy as jnp

    from sigma_tpu import CSRMatrix
    from sigma_tpu.parallel import distribute_matrix_dia, make_mesh
    from sigma_tpu.solvers import cg_solve

    devices = jax.devices()
    simulated = args.virtual > 0 or len(devices) == 1
    counts = [d for d in (1, 2, 4, 8, len(devices)) if d <= len(devices)]
    counts = sorted(set(counts))

    results = []
    t1 = None
    for D in counts:
        n = args.rows_per_device * (D if args.mode == "weak" else 1)
        r, c, v = laplacian_1d_coo(n)
        A = CSRMatrix.from_coo(n, n, r, c, v, dtype=jnp.float32)
        mesh = make_mesh(D)
        Ad = distribute_matrix_dia(A, mesh)
        b = Ad.shard_vector(np.ones(n, dtype=np.float32))

        solve = jax.jit(
            lambda Ad, b: cg_solve(Ad, b, tol=0.0, maxiter=args.iters)[0]
        )
        x = solve(Ad, b)
        float(x.ravel()[0])  # sync (compile + run once)
        t0 = time.perf_counter()
        x = solve(Ad, b)
        float(x.ravel()[0])
        t = time.perf_counter() - t0

        if t1 is None:
            t1 = t
        if args.mode == "weak":
            eff = t1 / t  # same per-device work: ideal time constant
        else:
            eff = t1 / (D * t)
        results.append({"devices": D, "n": n, "seconds": round(t, 4),
                        "efficiency": round(eff, 3)})

    print(json.dumps({
        "metric": f"{args.mode}_scaling_cg",
        "simulated": simulated,
        "iters": args.iters,
        "points": results,
    }))

    if args.pruned:
        # the UNSTRUCTURED flagship over the mesh: banded random-band
        # matrix through DistributedPrunedMatrix (per-shard packed
        # plans, two neighbor ppermute halos) — same weak/strong
        # protocol, so a real multi-host launch measures the pruned
        # path with the same flags
        from sigma_tpu.parallel import distribute_pruned

        rng = np.random.default_rng(0)
        results_p = []
        t1p = None
        for D in counts:
            n = args.rows_per_device * (D if args.mode == "weak" else 1)
            ne = 6 * n
            rr = rng.integers(0, n, ne)
            cc = np.clip(rr + rng.integers(-60, 61, ne), 0, n - 1)
            vv = -np.abs(rng.standard_normal(ne)).astype(np.float32)
            key = rr * n + cc
            _, idx = np.unique(key, return_index=True)
            rr, cc, vv = rr[idx], cc[idx], vv[idx]
            offd = rr != cc  # the diagonal is added below
            rr, cc, vv = rr[offd], cc[offd], vv[offd]
            diag = np.zeros(n, np.float32)
            np.add.at(diag, rr, np.abs(vv))
            if args.sym:
                # symmetrize (upper + mirror) so the symmetric-storage
                # shards are exercised with the same protocol
                up = cc >= rr
                ru, cu, vu = rr[up], cc[up], vv[up]
                off = cu > ru
                rr = np.concatenate([ru, cu[off]])
                cc = np.concatenate([cu, ru[off]])
                vv = np.concatenate([vu, vu[off]])
                diag = np.zeros(n, np.float32)
                np.add.at(diag, rr, np.abs(vv))
            rr = np.concatenate([rr, np.arange(n)])
            cc = np.concatenate([cc, np.arange(n)])
            vv = np.concatenate([vv, diag + 1.0])
            mesh = make_mesh(D)
            Ad = distribute_pruned(n, rr, cc, vv, mesh, tile_rows=16384,
                                   group=12 if args.sym else 8,
                                   assume_unique=True,
                                   symmetric=args.sym, validate=False)
            b = Ad.shard_vector(np.ones(n, dtype=np.float32))
            solve = jax.jit(
                lambda Ad, b: cg_solve(Ad, b, tol=0.0,
                                       maxiter=args.iters)[0]
            )
            x = solve(Ad, b)
            float(x.ravel()[0])
            t0 = time.perf_counter()
            x = solve(Ad, b)
            float(x.ravel()[0])
            t = time.perf_counter() - t0
            if t1p is None:
                t1p = t
            eff = t1p / t if args.mode == "weak" else t1p / (D * t)
            results_p.append({"devices": D, "n": n,
                              "seconds": round(t, 4),
                              "efficiency": round(eff, 3)})
        print(json.dumps({
            "metric": f"{args.mode}_scaling_pruned_cg"
                      + ("_sym" if args.sym else ""),
            "simulated": simulated,
            "points": results_p,
        }))


if __name__ == "__main__":
    main()
