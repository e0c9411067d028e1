#!/usr/bin/env python
"""Smoke test of the library's main path on NVIDIA GPUs, at full size.

    python chip_smoke.py              # S1, S2, U1, E1 on one GPU
    python chip_smoke.py --chips 4    # the distributed phases on 4 GPUs

Every flow goes through the public API (analytic DIA or COO builder ->
format -> jitted solver) and is checked against a plain float64 scipy
reference on the host:

* S1  7-point 3-D Laplacian + I at nx=216 (10,077,696 rows): DIAMatrix and
      SymmetricDIAMatrix SpMV against a scipy CSR product, with the time of
      one SpMV beside a >= 1 GiB device copy timed in the same process.
* S2  CG on that matrix; CG + structured_pair_amg on the pure Dirichlet
      Poisson operator; block CG with 8 right-hand sides.
* U1  shuffled irregular-mesh Laplacian (1,048,576 rows) through RCM into
      PrunedDIAMatrix / SymmetricPrunedDIAMatrix (and the RCM-banded
      DIAMatrix): SpMV, CG, and CG + pruned_pair_amg.
* E1  Lanczos for the lowest eigenvalues of the nx=64 Dirichlet Laplacian
      against the analytic spectrum.

With ``--chips 4`` only the distributed solves run (distributed DIA CG,
distributed structured GMG-CG, distributed pruned CG), each beside the
same solve on one card.

Each measurement prints one JSON line; the card's name and power limit
(nvidia-smi) precede the last line, which is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
A bound that fails raises, so the script exits non-zero and prints no
last line.  Without a GPU it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Bounds (see each phase for the reason)
DIA_SPMV_RTOL = 1e-6  # stencil values exact in f32; <= 7 terms per row
PRUNED_SPMV_RTOL = 1e-5  # random edge weights; <= ~9 terms per row
SOLVE_RESID = 1e-5  # 10x the solver rtol 1e-6: f32 recurrence drift
EIG_RTOL = 1e-4
DIST_RTOL = 1e-4  # distributed vs one-card solution (psum order varies)


def _check(ok, what):
    if not ok:
        raise RuntimeError(f"bound failed: {what}")


def _report(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _compile(fn, *args):
    """(compiled, compile_s) for ``jax.jit(fn)`` at these arguments."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled, time.perf_counter() - t0


def _run(compiled, *args, reps=1):
    """(out, median seconds over reps), each run ended by
    block_until_ready."""
    import jax

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    return out, float(np.median(times))


def _chain(op, K):
    """K applications of ``op.matvec`` in one program (scaled so the
    iterate stays bounded)."""
    import jax.numpy as jnp
    from jax import lax

    def f(A, x):
        return lax.fori_loop(
            0, K, lambda i, v: A.matvec(v) * jnp.asarray(0.1, v.dtype), x
        )

    return f


def spmv_time(op, x, K=20, reps=3):
    """Seconds per SpMV: a compiled chain of K matvecs, median of reps."""
    compiled, _ = _compile(_chain(op, K), op, x)
    _run(compiled, op, x)
    return _run(compiled, op, x, reps=reps)[1] / K


def copy_rate(nbytes=1 << 30, K=10, reps=3):
    """Bytes/s of a device copy of ``nbytes`` (read + write) — the
    same-process bandwidth witness SpMV rates are compared with."""
    import jax.numpy as jnp
    from jax import lax

    a = jnp.zeros((nbytes // 4,), jnp.float32)
    compiled, _ = _compile(
        lambda a: lax.fori_loop(0, K, lambda i, v: v + 1.0, a), a
    )
    _run(compiled, a)
    t = _run(compiled, a, reps=reps)[1]
    return 2 * nbytes * K / t


def csr_from_dia(data2d, offsets, n, m=None):
    """scipy float64 CSR of a DIA layout (``data2d[d, i] = A[i, i+o_d]``)."""
    import scipy.sparse as sps

    m = n if m is None else m
    rows, cols, vals = [], [], []
    for d, o in enumerate(offsets):
        lo, hi = max(0, -o), min(n, m - o)
        r = np.arange(lo, hi, dtype=np.int64)
        rows.append(r)
        cols.append(r + o)
        vals.append(np.asarray(data2d[d, lo:hi], np.float64))
    A = sps.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, m),
    ).tocsr()
    A.eliminate_zeros()
    return A


def _rel_inf(y, ref):
    y = np.asarray(y, np.float64)
    return float(np.max(np.abs(y - ref)) / max(np.max(np.abs(ref)), 1e-300))


def _host_resid(csr, x, b):
    x = np.asarray(x, np.float64)
    return float(np.linalg.norm(b - csr @ x) / np.linalg.norm(b))


def _stencil(nx, shift):
    """(DIAMatrix, host data, scipy CSR) of the 3-D Laplacian + shift*I."""
    import jax.numpy as jnp

    from sigma_tpu import DIAMatrix
    from sigma_tpu.apps.generators import laplacian_3d_dia
    from sigma_tpu.graph.graph import DIAGraph

    n, offsets, data, nnz = laplacian_3d_dia(nx, shift=shift)
    g = DIAGraph(offsets=offsets, shape=(n, n), nnz=nnz)
    A = DIAMatrix(graph=g, data=jnp.asarray(data.reshape(7, -1, 128)))
    return A, data, csr_from_dia(data, offsets, n)


def _solve(name, phase, solve, args, csr, b64, setup_s=0.0, extra=None,
           to_host=np.asarray):
    """Compile + run one jitted solve, check convergence and the host
    float64 relative residual (``to_host`` gathers a sharded iterate)."""
    compiled, compile_s = _compile(solve, *args)
    (x, info), run_s = _run(compiled, *args)
    resid = _host_resid(csr, to_host(x), b64)
    _report(
        phase, what=name, setup_s=setup_s, compile_s=compile_s, run_s=run_s,
        iterations=int(info.iterations), converged=bool(info.converged),
        host_rel_residual=resid, peak_bytes_in_use=_peak_bytes(),
        **(extra or {}),
    )
    _check(bool(info.converged), f"{phase} {name} converged")
    _check(resid <= SOLVE_RESID, f"{phase} {name} residual {resid:.3e}")
    return x, info


def phase_s1(nx=216, seed=0, reps=3, copy_bytes=1 << 30):
    """Structured SpMV: full and symmetric DIA against scipy CSR (f64)."""
    import jax.numpy as jnp

    from sigma_tpu.matrix.symmetric import SymmetricDIAMatrix

    t0 = time.perf_counter()
    A, data, csr = _stencil(nx, shift=1.0)
    n = A.shape[0]
    keep = [d for d, o in enumerate(A.graph.offsets) if o >= 0]
    S = SymmetricDIAMatrix(
        data=jnp.asarray(data[keep].reshape(len(keep), -1, 128)),
        offsets=tuple(A.graph.offsets[d] for d in keep), n=n,
    )
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    ref = csr @ x.astype(np.float64)
    setup_s = time.perf_counter() - t0
    bw = copy_rate(copy_bytes)
    _report("S1", what="device_copy", bytes=copy_bytes, gbps=bw / 1e9)
    out = {"copy_gbps": bw / 1e9}
    for name, op, streams in (
        ("dia", A, len(A.graph.offsets)),
        ("dia_sym", S, len(keep)),
    ):
        xd = jnp.asarray(x)
        compiled, compile_s = _compile(lambda A_, v: A_.matvec(v), op, xd)
        y, run_s = _run(compiled, op, xd)
        err = _rel_inf(y, ref)
        t = spmv_time(op, xd, reps=reps)
        nbytes = (streams + 2) * 4 * n  # values + one read of x + y
        _report(
            "S1", what=f"{name}_spmv", n=n, nnz=int(csr.nnz),
            setup_s=setup_s, compile_s=compile_s, run_s=run_s,
            max_rel_err=err, spmv_s=t, format_bytes=nbytes,
            gbps=nbytes / t / 1e9, copy_share=nbytes / t / bw,
            peak_bytes_in_use=_peak_bytes(),
        )
        _check(err <= DIA_SPMV_RTOL, f"S1 {name} SpMV error {err:.3e}")
        out[name] = {"err": err, "spmv_s": t}
    return out


def phase_s2(nx=216, seed=0, rtol=1e-6, nsmooth=1, ppl=3, k=8,
             maxiter=3000):
    """Structured solves: CG (Laplacian + I), GMG-CG (pure Dirichlet
    Poisson, structured_pair_amg), block CG with k right-hand sides."""
    import jax.numpy as jnp

    from sigma_tpu.solvers import block_cg_solve, cg_solve, structured_pair_amg

    rng = np.random.default_rng(seed)
    out = {}
    t0 = time.perf_counter()
    A1, _, csr1 = _stencil(nx, shift=1.0)
    n = A1.shape[0]
    # random manufactured solution: b carries every spectral mode
    xstar = rng.standard_normal(n).astype(np.float32)
    b64 = csr1 @ xstar.astype(np.float64)
    b = jnp.asarray(b64.astype(np.float32))
    setup_s = time.perf_counter() - t0
    _, info = _solve(
        "cg", "S2",
        lambda A, b: cg_solve(A, b, tol=0.0, rtol=rtol, maxiter=maxiter),
        (A1, b), csr1, b64, setup_s,
    )
    out["cg_iterations"] = int(info.iterations)

    t0 = time.perf_counter()
    A0, data0, csr0 = _stencil(nx, shift=0.0)
    b64 = csr0 @ xstar.astype(np.float64)
    b0 = jnp.asarray(b64.astype(np.float32))
    t1 = time.perf_counter()
    M = structured_pair_amg(
        A0, (nx, nx, nx), n_smooth=nsmooth, pairs_per_level=ppl,
        host_data=data0,
    )
    amg_s = time.perf_counter() - t1
    _, info = _solve(
        "gmg_cg", "S2",
        lambda A, b, M: cg_solve(
            A, b, tol=0.0, rtol=rtol, maxiter=maxiter, M=M
        ),
        (A0, b0, M), csr0, b64, time.perf_counter() - t0,
        extra={"amg_setup_s": amg_s, "levels": len(M.levels) + 1},
    )
    out["gmg_iterations"] = int(info.iterations)

    t0 = time.perf_counter()
    Xstar = rng.standard_normal((n, k)).astype(np.float32)
    B64 = csr1 @ Xstar.astype(np.float64)
    B = jnp.asarray(B64.astype(np.float32))
    setup_s = time.perf_counter() - t0
    compiled, compile_s = _compile(
        lambda A, B: block_cg_solve(
            A, B, tol=0.0, rtol=rtol, maxiter=maxiter
        ),
        A1, B,
    )
    (X, info), run_s = _run(compiled, A1, B)
    X = np.asarray(X, np.float64)
    resid = float(np.linalg.norm(B64 - csr1 @ X) / np.linalg.norm(B64))
    _report(
        "S2", what=f"block_cg_k{k}", setup_s=setup_s, compile_s=compile_s,
        run_s=run_s, iterations=int(info.iterations),
        converged=bool(info.converged), host_rel_residual=resid,
        peak_bytes_in_use=_peak_bytes(),
    )
    _check(bool(info.converged), "S2 block_cg converged")
    _check(resid <= SOLVE_RESID, f"S2 block_cg residual {resid:.3e}")
    out["block_cg_iterations"] = int(info.iterations)
    return out


def _mesh_triples(H, W, seed):
    """RCM-ordered triples of the shuffled irregular-mesh Laplacian + I
    and their scipy CSR."""
    import scipy.sparse as sps

    from sigma_tpu.apps.generators import irregular_mesh_laplacian_coo
    from sigma_tpu.matrix.banded import reorder_triples_rcm

    rng = np.random.default_rng(seed)
    n, rows, cols, vals = irregular_mesh_laplacian_coo(
        H, W, rng=rng, shift=1.0, shuffle=True
    )
    pr, pc, vals, _ = reorder_triples_rcm(n, rows, cols, vals)
    csr = sps.csr_matrix((vals, (pr, pc)), shape=(n, n))
    return n, pr, pc, vals, csr


def phase_u1(H=16384, W=64, seed=0, rtol=1e-6, maxiter=2000,
             coarse_size=4096, reps=3, copy_gbps=None):
    """Unstructured: RCM -> pruned / symmetric-pruned / banded DIA SpMV
    against scipy; CG and CG + pruned_pair_amg."""
    import jax.numpy as jnp

    from sigma_tpu import DIAMatrix
    from sigma_tpu.matrix.pruned import (
        PrunedDIAMatrix,
        SymmetricPrunedDIAMatrix,
    )
    from sigma_tpu.solvers import cg_solve, pruned_pair_amg

    t0 = time.perf_counter()
    n, pr, pc, vals, csr = _mesh_triples(H, W, seed)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    P = PrunedDIAMatrix.from_coo(
        n, n, pr, pc, vals, dtype=np.float32, assume_unique=True
    )
    S = SymmetricPrunedDIAMatrix.from_coo(
        n, n, pr, pc, vals, dtype=np.float32, assume_unique=True,
        validate=False,
    )
    D = DIAMatrix.from_coo(n, n, pr, pc, vals, dtype=jnp.float32)
    pack_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal(n).astype(np.float32)
    ref = csr @ x.astype(np.float64)
    if copy_gbps is None:
        copy_gbps = copy_rate() / 1e9
    out = {}
    for name, op, slots in (
        ("pruned", P, P.stored_slots),
        ("pruned_sym", S, S.stored_slots),
        ("banded_dia", D, D.graph.n_diags * D.graph.stride),
    ):
        xd = jnp.asarray(x)
        compiled, compile_s = _compile(lambda A_, v: A_.matvec(v), op, xd)
        y, run_s = _run(compiled, op, xd)
        err = _rel_inf(y, ref)
        t = spmv_time(op, xd, reps=reps)
        nbytes = 4 * slots + 8 * n  # value stream + one read of x + y
        _report(
            "U1", what=f"{name}_spmv", n=n, nnz=int(csr.nnz),
            stored_slots=int(slots), setup_s=gen_s + pack_s,
            compile_s=compile_s, run_s=run_s, max_rel_err=err, spmv_s=t,
            value_stream_bytes=nbytes, gbps=nbytes / t / 1e9,
            copy_share=nbytes / t / 1e9 / copy_gbps,
            peak_bytes_in_use=_peak_bytes(),
        )
        _check(err <= PRUNED_SPMV_RTOL, f"U1 {name} SpMV error {err:.3e}")
        out[name] = {"err": err, "spmv_s": t}
    del D

    xstar = rng.standard_normal(n).astype(np.float32)
    b64 = csr @ xstar.astype(np.float64)
    b = jnp.asarray(b64.astype(np.float32))
    _, info = _solve(
        "cg_pruned", "U1",
        lambda A, b: cg_solve(A, b, tol=0.0, rtol=rtol, maxiter=maxiter),
        (P, b), csr, b64, gen_s + pack_s,
    )
    out["cg_iterations"] = int(info.iterations)
    t0 = time.perf_counter()
    M = pruned_pair_amg(
        n, pr, pc, vals.astype(np.float32), coarse_size=coarse_size,
        smoother="chebyshev",
        fine_A=P,
    )
    amg_s = time.perf_counter() - t0
    _, info = _solve(
        "gmg_cg_pruned", "U1",
        lambda A, b, M: cg_solve(
            A, b, tol=0.0, rtol=rtol, maxiter=maxiter, M=M
        ),
        (P, b, M), csr, b64, gen_s + pack_s + amg_s,
        extra={"amg_setup_s": amg_s, "levels": len(M.levels) + 1},
    )
    out["gmg_iterations"] = int(info.iterations)
    return out


def lowest_distinct_eigenvalues(nx, count):
    """Lowest ``count`` DISTINCT eigenvalues of the nx^3 Dirichlet
    Laplacian: sums over three axes of 2 - 2 cos(q pi / (nx + 1))."""
    q = np.arange(1, min(nx, count + 2) + 1)
    w = 2.0 - 2.0 * np.cos(q * np.pi / (nx + 1))
    lam = (w[:, None, None] + w[None, :, None] + w[None, None, :]).ravel()
    lam = np.sort(lam)
    keep = np.concatenate([[True], np.diff(lam) > 1e-9 * lam[1:]])
    return lam[keep][:count]


def phase_e1(nx=64, count=4, steps=300, seed=0):
    """Lanczos (full reorthogonalization) for the lowest eigenvalues.
    A single-vector Lanczos sees each eigenspace once, so the lowest
    Ritz values are compared with the lowest DISTINCT analytic
    eigenvalues (the 3-D cube's are multiple).  Rounding can still let a
    second copy of a multiple eigenvalue converge; copies differ by
    rounding noise while the lowest distinct eigenvalues differ by more
    than 10%, so Ritz values within 1e-3 relative of each other count
    once."""
    import jax

    from sigma_tpu.eigen import eigensolve

    t0 = time.perf_counter()
    A, _, _ = _stencil(nx, shift=0.0)
    setup_s = time.perf_counter() - t0
    key = jax.random.PRNGKey(seed)
    compiled, compile_s = _compile(
        lambda A, key: eigensolve(A, steps, key=key)[0], A, key
    )
    lam, run_s = _run(compiled, A, key)
    lam = np.sort(np.asarray(lam, np.float64))
    keep = np.concatenate([[True], np.diff(lam) > 1e-3 * np.abs(lam[1:])])
    got = lam[keep][:count]
    exact = lowest_distinct_eigenvalues(nx, count)
    rel = np.abs(got - exact) / exact
    _report(
        "E1", what="lanczos_lowest", n=A.shape[0], steps=steps,
        setup_s=setup_s, compile_s=compile_s, run_s=run_s,
        eigenvalues=got.tolist(), analytic=exact.tolist(),
        rel_err=rel.tolist(), peak_bytes_in_use=_peak_bytes(),
    )
    _check(float(rel.max()) <= EIG_RTOL, f"E1 eigenvalue error {rel.max():.3e}")
    return {"rel_err": rel.tolist()}


def _compare_dist(name, Ad, xd, info_d, x1, info_1, n_devices):
    """Distributed vs one-card: the iterate is spread over every device,
    iteration counts agree within 1, solutions within DIST_RTOL.  The
    psum order of the distributed dots changes between runs (and GPU
    scatter-adds are atomic), so the exact-count parity of a CPU mesh is
    not demanded."""
    devs = xd.sharding.device_set
    shard_rows = {s.data.shape[0] for s in xd.addressable_shards}
    xs = Ad.unshard_vector(xd)
    x1 = np.asarray(x1, np.float64)
    diff = _rel_inf(xs, x1)
    it_d, it_1 = int(info_d.iterations), int(info_1.iterations)
    _report(
        "DIST", what=name, devices=len(devs), shard_rows=sorted(shard_rows),
        iterations=it_d, iterations_one_card=it_1, max_rel_diff=diff,
        converged=bool(info_d.converged),
    )
    _check(len(devs) == n_devices, f"{name} spans {len(devs)} devices")
    _check(len(shard_rows) == 1, f"{name} shards are equal")
    _check(bool(info_d.converged), f"{name} converged")
    _check(abs(it_d - it_1) <= 1, f"{name} iterations {it_d} vs {it_1}")
    _check(diff <= DIST_RTOL, f"{name} solution diff {diff:.3e}")


def phase_dist(n_devices=4, nx=216, H=16384, W=64, seed=0, rtol=1e-6,
               maxiter=3000):
    """Distributed DIA CG, distributed structured GMG-CG and distributed
    pruned CG over a 1-D mesh, each beside the same solve on one card."""
    import jax
    import jax.numpy as jnp

    from sigma_tpu.matrix.pruned import PrunedDIAMatrix
    from sigma_tpu.parallel import (
        distribute_matrix_dia,
        distribute_pruned,
        distribute_structured_amg,
        make_mesh,
    )
    from sigma_tpu.solvers import cg_solve, structured_pair_amg

    mesh = make_mesh(n_devices)
    _check(mesh.devices.size == n_devices, f"mesh has {mesh.devices.size}")
    rng = np.random.default_rng(seed)
    cg = lambda A, b: cg_solve(A, b, tol=0.0, rtol=rtol, maxiter=maxiter)
    cgm = lambda A, b, M: cg_solve(
        A, b, tol=0.0, rtol=rtol, maxiter=maxiter, M=M
    )

    def both(name, solve, one, dist, csr, b64, Ad):
        xd, info_d = _solve(f"{name}_dist", "DIST", solve, dist, csr, b64,
                            to_host=Ad.unshard_vector)
        x1, info_1 = _solve(f"{name}_one_card", "DIST", solve, one, csr, b64)
        _compare_dist(name, Ad, xd, info_d, x1, info_1, n_devices)

    A1, _, csr1 = _stencil(nx, shift=1.0)
    n = A1.shape[0]
    xstar = rng.standard_normal(n).astype(np.float32)
    b64 = csr1 @ xstar.astype(np.float64)
    t0 = time.perf_counter()
    Ad = distribute_matrix_dia(A1, mesh)
    _report("DIST", what="distribute_dia", setup_s=time.perf_counter() - t0)
    b = b64.astype(np.float32)
    both("dia_cg", cg, (A1, jnp.asarray(b)), (Ad, Ad.shard_vector(b)),
         csr1, b64, Ad)
    del Ad, A1

    A0, data0, csr0 = _stencil(nx, shift=0.0)
    b64 = csr0 @ xstar.astype(np.float64)
    b = b64.astype(np.float32)
    t0 = time.perf_counter()
    M1 = structured_pair_amg(
        A0, (nx, nx, nx), freeze_axes=(0,), pairs_per_level=2,
        host_data=data0,
    )
    A0d = distribute_matrix_dia(A0, mesh)
    Md = distribute_structured_amg(M1, mesh)
    _report("DIST", what="distribute_gmg", setup_s=time.perf_counter() - t0,
            levels=len(M1.levels) + 1)
    both("gmg_cg", cgm, (A0, jnp.asarray(b), M1),
         (A0d, A0d.shard_vector(b), Md), csr0, b64, A0d)
    del A0d, Md, M1, A0

    n, pr, pc, vals, csr = _mesh_triples(H, W, seed)
    P = PrunedDIAMatrix.from_coo(
        n, n, pr, pc, vals, dtype=np.float32, assume_unique=True
    )
    t0 = time.perf_counter()
    Pd = distribute_pruned(
        n, pr, pc, vals, mesh, dtype=np.float32, assume_unique=True
    )
    _report("DIST", what="distribute_pruned",
            setup_s=time.perf_counter() - t0)
    xstar = rng.standard_normal(n).astype(np.float32)
    b64 = csr @ xstar.astype(np.float64)
    b = b64.astype(np.float32)
    both("pruned_cg", cg, (P, jnp.asarray(b)), (Pd, Pd.shard_vector(b)),
         csr, b64, Pd)
    return {"devices": n_devices, "platform": jax.devices()[0].platform}


def card_lines():
    """nvidia-smi's name and power limit of every card (a child process
    that stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the distributed phases on 4 GPUs")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(REPO, "sigma_tpu")):
        print("chip_smoke.py: the sigma_tpu package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke.py: no GPU found (JAX platform "
              f"{devices[0].platform!r})", file=sys.stderr)
        return 1
    if len(devices) < args.chips:
        print(f"chip_smoke.py: --chips {args.chips} needs {args.chips} GPUs, "
              f"found {len(devices)}", file=sys.stderr)
        return 1

    from sigma_tpu import native
    from sigma_tpu.utils.util import configure_compile_cache

    cache = configure_compile_cache(os.path.join(REPO, ".jax_cache"))
    t0 = time.perf_counter()
    loaded = native.available()
    _report("setup", native_core_loaded=loaded,
            native_build_s=time.perf_counter() - t0, compile_cache=cache,
            device_kind=devices[0].device_kind, device_count=len(devices))

    if args.chips == 4:
        phase_dist(4)
    else:
        s1 = phase_s1()
        phase_s2()
        phase_u1(copy_gbps=s1["copy_gbps"])
        phase_e1()
    print(card_lines(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
