"""Headline benchmark: SpMV throughput (nnz/s) on one GPU, at the
north-star size (10M-row 7-point 3-D Laplacian).

``vs_baseline`` = DIA-achieved / (0.8 * speed-of-light), where
speed-of-light = the card's HBM bandwidth (``HBM_GBPS``, keyed by
``device_kind``) / DIA's minimal bytes-per-nonzero; 1.0 means exactly 80%
of speed-of-light.  The headline is the FULL-STORAGE f32 DIA SpMV scored
against the full-storage speed-of-light; symmetric-storage / bf16-value /
multi-RHS / BSR / unstructured variants are labeled detail rows.  A
same-run streaming-triad bandwidth is reported beside the spec figure.
Prints ONE JSON line ``{"metric": ..., "value": N, "unit": ...,
"vs_baseline": N, "detail": {...}}``.  Fails unless JAX finds a GPU
listed in ``HBM_GBPS``.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from sigma_tpu.apps.generators import laplacian_3d_dia  # noqa: E402,F401

# device_kind -> HBM bandwidth GB/s.  Source: NVIDIA H100 SXM data sheet
# (80 GB HBM3 at 3.35 TB/s).
HBM_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
}


def timeit_loop(make_f, *args, K=100, reps=3, samples=None):
    """Per-iteration seconds of a device-side loop: ``make_f(K)`` returns
    a jitted K-iteration chain, timed by ``block_until_ready`` after one
    compiling call; the median over ``reps`` runs, divided by K.  Each
    run's estimate is appended to ``samples`` (spread evidence)."""
    import jax

    f = make_f(K)
    jax.block_until_ready(f(*args))
    est = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        est.append((time.perf_counter() - t0) / K)
    if samples is not None:
        samples.extend(est)
    return float(np.median(est))


def _progress(msg, t0):
    print(f"# bench {time.time()-t0:6.0f}s  {msg}", file=sys.stderr, flush=True)


def measure_bandwidth_gbps(samples=None):
    """Rotating-buffer triad: per iteration write one fresh 256 MB buffer
    from two distinct ones, then rotate roles — 3 memory streams that XLA
    cannot elide or fold, on arrays far larger than the 50 MB L2."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    n = 67_108_864  # 256 MB per f32 array
    a = jnp.ones((n,), jnp.float32)
    b = jnp.full((n,), 0.5, jnp.float32)
    c = jnp.full((n,), 0.25, jnp.float32)

    def make(K):
        @jax.jit
        def triad(a, b, c):
            def body(i, carry):
                a, b, c = carry
                return (b, c, a + 0.5 * b)

            return lax.fori_loop(0, K, body, (a, b, c))

        return triad

    t = timeit_loop(make, a, b, c, K=20, samples=samples)
    return 3 * 4 * n / t / 1e9  # read a, read b, write new c per iter


def laplacian_3d_coo(nx):
    """7-point stencil Laplacian + I on an nx^3 grid as COO triples.

    Preallocates the exact-size output triples and fills them by axis
    slices — no boolean masks, np.roll copies, or concatenate temporaries."""
    n = nx * nx * nx
    per_axis = n - nx * nx  # bonded pairs along one axis
    total = n + 6 * per_axis
    rows = np.empty(total, dtype=np.int64)
    cols = np.empty(total, dtype=np.int64)
    vals = np.empty(total, dtype=np.float64)
    rows[:n] = np.arange(n, dtype=np.int64)
    cols[:n] = rows[:n]
    vals[:n] = 7.0
    vals[n:] = -1.0
    idx = rows[:n].reshape(nx, nx, nx)  # view, no copy
    off = n
    for axis in range(3):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[axis] = slice(0, nx - 1)
        hi[axis] = slice(1, nx)
        src = idx[tuple(lo)].reshape(-1)
        dst = idx[tuple(hi)].reshape(-1)
        rows[off : off + per_axis] = src
        cols[off : off + per_axis] = dst
        off += per_axis
        rows[off : off + per_axis] = dst
        cols[off : off + per_axis] = src
        off += per_axis
    return n, rows, cols, vals


def bench_spmv(A, nnz, K=100, samples=None, reps=3):
    import jax
    import jax.numpy as jnp
    from jax import lax

    n = A.shape[0]
    x = jnp.ones((n,), dtype=jnp.float32)

    def make(K):
        @jax.jit
        def many(A, x):
            def body(i, v):
                return A.matvec(v) * jnp.asarray(0.1, v.dtype)

            return lax.fori_loop(0, K, body, x)

        return many

    t = timeit_loop(make, A, x, K=K, samples=samples, reps=reps)
    return nnz / t


def bench_spmm_interleaved(A, nnz, k=8, K=50, samples=None, reps=3):
    """Effective nnz/s of the resident interleaved-panel SpMM (the block
    solvers' ``panels="interleaved"`` layout,
    :mod:`sigma_tpu.matrix.panels`)."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from sigma_tpu.matrix.panels import interleave_panels

    n = A.shape[0]
    XI = interleave_panels(jnp.ones((k, n), dtype=jnp.float32), n)

    def make(K):
        @jax.jit
        def many(A, XI):
            def body(i, V):
                return A.matmat_interleaved(V) * jnp.asarray(0.1, V.dtype)

            return lax.fori_loop(0, K, body, XI)

        return many

    t = timeit_loop(make, A, XI, K=K, samples=samples, reps=reps)
    return k * nnz / t


def main():
    t0 = time.time()
    import jax
    import jax.numpy as jnp

    from sigma_tpu import DIAMatrix
    from sigma_tpu.graph.graph import DIAGraph
    from sigma_tpu.matrix.symmetric import SymmetricDIAMatrix

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform!r}")
    kind = dev.device_kind
    if kind not in HBM_GBPS:
        raise SystemExit(
            f"no HBM bandwidth known for device kind {kind!r}; add it to "
            "HBM_GBPS with its source"
        )
    spec_bw = HBM_GBPS[kind]
    _progress(f"device {kind}", t0)

    triad_samples = []
    measured_bw = measure_bandwidth_gbps(samples=triad_samples)
    _progress(f"triad {measured_bw:.0f} GB/s", t0)

    nx = 216  # 10.1M rows — the north-star size
    n, offsets, data, nnz = laplacian_3d_dia(nx)
    g = DIAGraph(offsets=offsets, shape=(n, n), nnz=nnz)
    A_dia = DIAMatrix(graph=g, data=jnp.asarray(data.reshape(7, -1, 128)))
    _progress("matrix on device", t0)
    dia_samples = []
    dia_nnz_s = bench_spmv(A_dia, nnz, reps=10, samples=dia_samples)
    _progress(f"dia f32 {dia_nnz_s/1e9:.1f} Gnnz/s", t0)

    # symmetric storage (upper diagonals only): the same nnz off 4 of the
    # 7 value streams
    keep = [d for d, o in enumerate(offsets) if o >= 0]
    data_up = data[keep]
    A_sym = SymmetricDIAMatrix(
        data=jnp.asarray(data_up.reshape(len(keep), -1, 128)),
        offsets=tuple(offsets[d] for d in keep),
        n=n,
    )
    sym_samples = []
    sym_nnz_s = bench_spmv(A_sym, nnz, samples=sym_samples)
    _progress(f"dia sym {sym_nnz_s/1e9:.1f} Gnnz/s", t0)

    # bf16 matrix values halve the dominant value stream; the stencil
    # coefficients are bf16-exact (asserted)
    data_bf16 = data.astype(jnp.bfloat16)
    assert np.array_equal(data_bf16.astype(np.float32), data)
    A_bf16 = DIAMatrix(
        graph=g, data=jnp.asarray(data_bf16.reshape(7, -1, 128))
    )
    bf16_samples = []
    bf16_nnz_s = bench_spmv(A_bf16, nnz, samples=bf16_samples)
    _progress(f"dia bf16 {bf16_nnz_s/1e9:.1f} Gnnz/s", t0)

    data_symbf = data_up.astype(jnp.bfloat16)
    A_symbf = SymmetricDIAMatrix(
        data=jnp.asarray(data_symbf.reshape(len(keep), -1, 128)),
        offsets=tuple(offsets[d] for d in keep),
        n=n,
    )
    symbf_samples = []
    symbf_nnz_s = bench_spmv(A_symbf, nnz, samples=symbf_samples)
    _progress(f"dia sym+bf16 {symbf_nnz_s/1e9:.1f} Gnnz/s", t0)

    spmm_samples = []
    spmm_eff = bench_spmm_interleaved(A_dia, nnz, k=8, samples=spmm_samples)
    _progress(f"spmm interleaved k=8 {spmm_eff/1e9:.1f} G-eff", t0)

    # unstructured-sparsity recipe: shuffled irregular-mesh Laplacian ->
    # RCM -> banded DIA (scan path) and the pruned layouts
    from sigma_tpu.apps.generators import irregular_mesh_laplacian
    from sigma_tpu.matrix.banded import to_banded_dia
    from sigma_tpu.matrix.formats import CSRMatrix
    from sigma_tpu.matrix.pruned import (
        PrunedDIAMatrix,
        SymmetricPrunedDIAMatrix,
    )

    rng = np.random.default_rng(0)
    H, W = 8192, 64
    Au = irregular_mesh_laplacian(H, W, rng=rng, dtype=jnp.float32)
    nu = Au.shape[0]
    rr, cc, vv = Au.entries()
    sh = rng.permutation(nu)
    Au = CSRMatrix.from_coo(nu, nu, sh[rr], sh[cc], vv, dtype=jnp.float32)
    Du, pu = to_banded_dia(Au)
    nnz_u = Au.graph.nnz
    occ_u = nnz_u / (nu * Du.graph.n_diags)
    unst_samples = []
    true_rate = bench_spmv(Du, nnz_u, samples=unst_samples)
    unstructured = {
        "n": nu,
        "nnz": int(nnz_u),
        "n_diags": int(Du.graph.n_diags),
        "occupancy": round(occ_u, 5),
        "true_gnnz_s": round(true_rate / 1e9, 3),
        "slot_gnnz_s": round(true_rate / occ_u / 1e9, 1),
        "spread_true_gnnz_s": [
            round(nnz_u / t / 1e9, 2) for t in unst_samples
        ],
        "path": "DIAMatrix scan over the RCM band (XLA)",
    }
    _progress(f"unstructured {true_rate/1e9:.2f} Gnnz/s true", t0)
    Dsu = SymmetricDIAMatrix.from_dia(Du)
    Dsb = SymmetricDIAMatrix(
        data=Dsu.data.astype(jnp.bfloat16), offsets=Dsu.offsets, n=nu
    )
    symbf_rate = bench_spmv(Dsb, nnz_u)
    unstructured["sym_bf16_true_gnnz_s"] = round(symbf_rate / 1e9, 3)
    ru, cu, vu = Au.entries()
    Pu = PrunedDIAMatrix.from_coo(
        nu, nu, pu[ru], pu[cu], vu, dtype=jnp.float32, assume_unique=True,
    )
    pr_rate = bench_spmv(Pu, nnz_u)
    unstructured["pruned_true_gnnz_s"] = round(pr_rate / 1e9, 3)
    unstructured["pruned_local_occupancy"] = round(
        nnz_u / Pu.stored_slots, 4
    )
    Pb = PrunedDIAMatrix.from_coo(
        nu, nu, pu[ru], pu[cu], vu, dtype=jnp.bfloat16, assume_unique=True,
    )
    unstructured["pruned_bf16_true_gnnz_s"] = round(
        bench_spmv(Pb, nnz_u) / 1e9, 3
    )
    Su = SymmetricPrunedDIAMatrix.from_coo(
        nu, nu, pu[ru], pu[cu], vu, dtype=jnp.float32,
        assume_unique=True, validate=False,
    )
    unstructured["pruned_sym_true_gnnz_s"] = round(
        bench_spmv(Su, nnz_u) / 1e9, 3
    )
    _progress("unstructured rows done", t0)

    # grouped-BSR slot rate: synthetic block-banded operator, (8,128)
    # blocks, 67M stored slots
    from sigma_tpu.matrix.grouped_bsr import GroupedBSR

    nb_rows, bh, bw, grp = 8192, 8, 128, 8
    nbc = nb_rows * bh // bw
    rngb = np.random.default_rng(1)
    grow_b = np.arange(nb_rows, dtype=np.int32)
    center = (grow_b.astype(np.int64) * bh) // bw
    gcols_b = np.clip(
        center[:, None] + rngb.integers(-4, 5, size=(nb_rows, grp)),
        0, nbc - 1,
    ).astype(np.int32)
    gdata_b = rngb.standard_normal((nb_rows, bh, grp * bw)).astype(np.float32)
    G = GroupedBSR(
        gdata=jnp.asarray(gdata_b),
        gcols=jnp.asarray(gcols_b),
        grow=jnp.asarray(grow_b),
        shape=(nb_rows * bh, nb_rows * bh),
        block_shape=(bh, bw),
        group=grp,
    )
    slots = int(gdata_b.size)
    bsr_samples = []
    bsr_rate = bench_spmv(G, slots, samples=bsr_samples)
    bsr = {
        "n": nb_rows * bh,
        "slots": slots,
        "block": [bh, bw],
        "bsr_slot_gnnz_s": round(bsr_rate / 1e9, 1),
        "spread_slot_gnnz_s": [round(slots / t / 1e9, 1) for t in bsr_samples],
        "path": "GroupedBSR grouped einsum (XLA)",
    }
    _progress(f"bsr slot rate {bsr_rate/1e9:.0f} Gnnz/s", t0)

    # minimum possible traffic for DIA: each diagonal value read once
    # (4 B), x read once and y written once per row (amortized over the
    # row degree)
    value = dia_nnz_s
    bytes_per_nnz = 4 + (4 + 4) * n / nnz
    achieved_gbps = value * bytes_per_nnz / 1e9
    sol = spec_bw * 1e9 / bytes_per_nnz
    vs_baseline = value / (0.8 * sol)

    def _spread(s):
        return [round(nnz / x / 1e9, 1) for x in s]

    print(
        json.dumps(
            {
                "metric": "spmv_nnz_per_s",
                "value": round(value / 1e9, 4),
                "unit": "Gnnz/s",
                "vs_baseline": round(vs_baseline, 4),
                "detail": {
                    "device": kind,
                    "n": n,
                    "nnz": nnz,
                    "dia_gnnz_s": round(dia_nnz_s / 1e9, 4),
                    "dia_sym_gnnz_s": round(sym_nnz_s / 1e9, 4),
                    "dia_bf16data_gnnz_s": round(bf16_nnz_s / 1e9, 4),
                    "dia_sym_bf16data_gnnz_s": round(symbf_nnz_s / 1e9, 4),
                    "spmm_interleaved_k8_geff": round(spmm_eff / 1e9, 4),
                    "unstructured": unstructured,
                    "bsr": bsr,
                    "hbm_gbps_spec": spec_bw,
                    "hbm_gbps_triad_measured": round(measured_bw, 1),
                    "speed_of_light_gnnz_s": round(sol / 1e9, 3),
                    "achieved_gbps_from_spmv": round(achieved_gbps, 1),
                    "spread": {
                        "dia_gnnz_s": _spread(dia_samples),
                        "dia_sym_gnnz_s": _spread(sym_samples),
                        "dia_bf16_gnnz_s": _spread(bf16_samples),
                        "dia_sym_bf16_gnnz_s": _spread(symbf_samples),
                        "spmm_k8_geff": [
                            round(8 * nnz / t / 1e9, 1)
                            for t in spmm_samples
                        ],
                        "triad_gbps": [
                            round(3 * 4 * 67_108_864 / t / 1e9, 1)
                            for t in triad_samples
                        ],
                    },
                    "path": "DIAMatrix unrolled window FMA (XLA), "
                    "full-storage f32",
                },
            }
        )
    )


if __name__ == "__main__":
    main()
