"""PrunedDIAMatrix (packed active row-tile x diagonal blocks) tests.

Oracle style follows the reference's dense-mirror pattern
(``test/matrix_test_basics.f90``): build random banded-with-outliers
matrices, mirror them densely, and check every public operation, in f64
and in f32 through the gather apply every backend runs.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sigma_tpu.matrix.formats import DIAMatrix
from sigma_tpu.matrix.pruned import PrunedDIAMatrix
from sigma_tpu.matrix.pruned_plan import (
    build_pruned_plan,
    pruned_matvec_reference,
)


def _random_banded(rng, n, m, nnz, band=120, outliers=20):
    rows = rng.integers(0, n, nnz)
    cols = np.clip(rows + rng.integers(-band, band + 1, nnz), 0, m - 1)
    if outliers:
        cols[:outliers] = rng.integers(0, m, outliers)
    vals = rng.standard_normal(nnz)
    key = rows * m + cols
    _, idx = np.unique(key, return_index=True)
    rows, cols, vals = rows[idx], cols[idx], vals[idx]
    dense = np.zeros((n, m))
    dense[rows, cols] = vals
    return rows, cols, vals, dense


def test_matvec_dense_oracle_f64(rng):
    n, m = 3100, 3100
    rows, cols, vals, dense = _random_banded(rng, n, m, 25000)
    A = PrunedDIAMatrix.from_coo(n, m, rows, cols, vals, tile_rows=1024,
                                 group=4)
    x = rng.standard_normal(m)
    y = np.asarray(A.matvec(jnp.asarray(x)))
    assert np.abs(y - dense @ x).max() < 1e-10 * np.abs(dense @ x).max()


def test_rectangular_and_unaligned(rng):
    n, m = 2500, 3333  # m not a multiple of 128
    rows, cols, vals, dense = _random_banded(rng, n, m, 12000, band=300)
    A = PrunedDIAMatrix.from_coo(n, m, rows, cols, vals, tile_rows=1024,
                                 group=3)
    x = rng.standard_normal(m)
    y = np.asarray(A.matvec(jnp.asarray(x)))
    assert np.abs(y - dense @ x).max() < 1e-10 * np.abs(dense @ x).max()
    # rmatvec = transposed-plan matvec
    z = rng.standard_normal(n)
    yt = np.asarray(A.rmatvec(jnp.asarray(z)))
    assert np.abs(yt - dense.T @ z).max() < 1e-10 * np.abs(dense.T @ z).max()
    # matmat
    X = rng.standard_normal((m, 3))
    Y = np.asarray(A.matmat(jnp.asarray(X)))
    assert np.abs(Y - dense @ X).max() < 1e-10 * np.abs(dense @ X).max()


@pytest.mark.parametrize(
    "n,m,band,tile_rows,group",
    [
        (4000, 4000, 200, 1024, 8),
        (4000, 4000, 200, 2048, 1),
        (3333, 3333, 90, 1024, 5),
        (2500, 3100, 300, 1024, 3),
        (3100, 2500, 150, 2048, 4),
        (1500, 1500, 1400, 1024, 2),
    ],
)
def test_pruned_reference_f32_grid(rng, n, m, band, tile_rows, group):
    """The plan + gather reference against the dense oracle in f32:
    square, rectangular both ways, unaligned n, and a band wider than one
    tile (the halo-widening branch of build_pruned_plan)."""
    rows, cols, vals, dense = _random_banded(rng, n, m, 30000, band=band,
                                             outliers=0)
    vals32 = vals.astype(np.float32)
    plan = build_pruned_plan(n, m, rows, cols, vals32, tile_rows=tile_rows,
                             group=group, dtype=np.float32)
    data = jnp.asarray(plan.data.reshape(plan.L, plan.C, plan.T, 128))
    x = rng.standard_normal(m).astype(np.float32)
    y = np.asarray(pruned_matvec_reference(
        data, jnp.asarray(x), jnp.asarray(plan.tile),
        jnp.asarray(plan.rowoff), jnp.asarray(plan.laneoff),
        T=plan.T, E=plan.E, C=plan.C, n=n, m=m,
    ))
    ref = dense.astype(np.float32) @ x
    assert y.shape == (n,)
    assert np.abs(y - ref).max() < 1e-5 * np.abs(ref).max()
    assert plan.n_slots_active <= plan.L * plan.C


def test_parity_with_diamatrix_and_from_dia(rng):
    # same matrix through DIAMatrix (XLA scan path) and the pruned format
    n = 2000
    rows, cols, vals, dense = _random_banded(rng, n, n, 15000, band=80,
                                             outliers=0)
    D = DIAMatrix.from_coo(n, n, rows, cols, vals)
    P = PrunedDIAMatrix.from_dia(D, tile_rows=1024, group=4)
    x = rng.standard_normal(n)
    yd = np.asarray(D.matvec(jnp.asarray(x)))
    yp = np.asarray(P.matvec(jnp.asarray(x)))
    assert np.abs(yd - yp).max() < 1e-12 * np.abs(yd).max()
    assert P.nnz == np.count_nonzero(dense)


def test_entries_roundtrip_and_dense(rng):
    n, m = 1500, 1400
    rows, cols, vals, dense = _random_banded(rng, n, m, 8000)
    A = PrunedDIAMatrix.from_coo(n, m, rows, cols, vals, tile_rows=1024,
                                 group=2)
    assert np.abs(A.to_dense() - dense).max() == 0.0
    r2, c2, v2 = A.entries()
    d2 = np.zeros_like(dense)
    d2[r2, c2] = v2
    assert np.abs(d2 - dense).max() == 0.0
    # duplicate entries: last value wins (set_values semantics)
    rr = np.array([5, 5]); cc = np.array([7, 7]); vv = np.array([1.0, 2.0])
    B = PrunedDIAMatrix.from_coo(100, 100, rr, cc, vv)
    assert B.get_value(5, 7) == 2.0
    assert B.nnz == 1


def test_transpose_astype_getvalue(rng):
    n = 900
    rows, cols, vals, dense = _random_banded(rng, n, n, 5000)
    A = PrunedDIAMatrix.from_coo(n, n, rows, cols, vals, tile_rows=1024)
    At = A.transpose()
    assert np.abs(At.to_dense() - dense.T).max() == 0.0
    Ab = A.astype(jnp.float32)
    assert Ab.dtype == jnp.float32
    i, j = int(rows[0]), int(cols[0])
    assert A.get_value(i, j) == pytest.approx(dense[i, j])
    assert A.get_value(0, n - 1) == 0.0 or dense[0, n - 1] != 0.0


def test_solver_integration_cg(rng):
    # SPD banded system through CG with the pruned operator
    from sigma_tpu.solvers import cg_solve

    n = 1200
    main = 4.0 + rng.random(n)
    off = -rng.random(n - 1)
    dense = np.diag(main) + np.diag(off, 1) + np.diag(off, -1)
    rows, cols = np.nonzero(dense)
    A = PrunedDIAMatrix.from_coo(n, n, rows, cols, dense[rows, cols],
                                 tile_rows=1024, group=2)
    xstar = rng.standard_normal(n)
    b = jnp.asarray(dense @ xstar)
    x, info = cg_solve(A, b, tol=0.0, rtol=1e-14, maxiter=400)
    assert np.abs(np.asarray(x) - xstar).max() < 1e-9


def test_pruned_spmm_rhs_major(rng):
    # RHS-major multi-vector apply (vmap over the reference) + matmat
    n = 3000
    rows, cols, vals, dense = _random_banded_pair(rng, n)
    vals32 = vals.astype(np.float32)
    plan_mat = PrunedDIAMatrix.from_coo(
        n, n, rows, cols, vals32, dtype=np.float32, tile_rows=1024, group=4
    )
    k = 3
    XT = rng.standard_normal((k, n)).astype(np.float32)
    Y = np.asarray(plan_mat.matmat_rhs_major(jnp.asarray(XT)))
    ref = XT @ dense.astype(np.float32).T
    assert np.abs(Y - ref).max() < 1e-4 * max(np.abs(ref).max(), 1.0)
    # matmat matches the dense oracle
    X = rng.standard_normal((n, 2))
    A64 = PrunedDIAMatrix.from_coo(n, n, rows, cols, vals, tile_rows=1024)
    Y2 = np.asarray(A64.matmat(jnp.asarray(X)))
    assert np.abs(Y2 - dense @ X).max() < 1e-10 * np.abs(dense @ X).max()


def _random_banded_pair(rng, n):
    rows = rng.integers(0, n, 20000)
    cols = np.clip(rows + rng.integers(-150, 151, 20000), 0, n - 1)
    vals = rng.standard_normal(20000)
    key = rows * n + cols
    _, idx = np.unique(key, return_index=True)
    rows, cols, vals = rows[idx], cols[idx], vals[idx]
    dense = np.zeros((n, n))
    dense[rows, cols] = vals
    return rows, cols, vals, dense


def test_pruned_pair_amg_matches_structured(rng):
    # pruned-level hierarchy over COO == structured_pair_amg(D, (n,)):
    # same pair aggregation, same closed-form Galerkin, so the V-cycle
    # applications agree to roundoff and the CG win carries over
    from sigma_tpu.solvers import (
        cg_solve,
        pruned_pair_amg,
        structured_pair_amg,
    )

    n = 700
    dense = np.zeros((n, n))
    i = np.arange(n)
    for o in (1, 3, 7):
        v = -np.abs(rng.random(n - o)) * 0.5
        dense[i[:-o], i[:-o] + o] = v
        dense[i[:-o] + o, i[:-o]] = v
    dense[i, i] = np.abs(dense).sum(1) + 0.5
    rows, cols = np.nonzero(dense)
    vals = dense[rows, cols]
    D = DIAMatrix.from_coo(n, n, rows, cols, vals)
    r = rng.standard_normal(n)
    for sm in ("jacobi", "chebyshev"):
        M1 = structured_pair_amg(D, (n,), coarse_size=64, smoother=sm)
        M2 = pruned_pair_amg(n, rows, cols, vals, coarse_size=64,
                             smoother=sm, tile_rows=1024, group=2)
        assert len(M1.levels) == len(M2.levels)
        y1 = np.asarray(M1.matvec(jnp.asarray(r)))
        y2 = np.asarray(M2.matvec(jnp.asarray(r)))
        assert np.abs(y1 - y2).max() < 1e-10 * np.abs(y1).max()
    xstar = rng.standard_normal(n)
    b = jnp.asarray(dense @ xstar)
    x, info = cg_solve(D, b, tol=0.0, rtol=1e-12, maxiter=200, M=M2)
    x0, info0 = cg_solve(D, b, tol=0.0, rtol=1e-12, maxiter=200)
    assert int(info.iterations) < int(info0.iterations)
    assert np.abs(np.asarray(x) - xstar).max() < 1e-9


def test_pruned_pair_amg_guards():
    from sigma_tpu.solvers import pruned_pair_amg

    with pytest.raises(ValueError, match="coarse_size"):
        pruned_pair_amg(10, [0], [0], [1.0], coarse_size=100000)
    with pytest.raises(ValueError, match="smoother"):
        pruned_pair_amg(10, [0], [0], [1.0], smoother="sor")


def _banded_spd(rng, n, offs=(1, 2, 5, 11), shift=0.01):
    dense = np.zeros((n, n))
    i = np.arange(n)
    for o in offs:
        v = -np.abs(rng.random(n - o)) * 0.4
        dense[i[:-o], i[:-o] + o] = v
        dense[i[:-o] + o, i[:-o]] = v
    dense[i, i] = np.abs(dense).sum(1) + shift
    rows, cols = np.nonzero(dense)
    return dense, rows, cols, dense[rows, cols]


def test_distributed_pruned_matvec_and_cg_parity(rng):
    # row-sharded pruned matvec is BITWISE the single-device twin's
    # (same tiles, same per-tile slot order), and distributed CG matches
    # iterate + iteration count
    from sigma_tpu.parallel import distribute_pruned, make_mesh
    from sigma_tpu.solvers import cg_solve

    n = 6000
    dense, rows, cols, vals = _banded_spd(rng, n)
    mesh = make_mesh(8)
    Ad = distribute_pruned(n, rows, cols, vals, mesh, tile_rows=1024,
                           group=4)
    n_pad = Ad.n_pad
    P1 = PrunedDIAMatrix.from_coo(
        n_pad, n_pad, rows, cols, vals,
        tile_rows=min(1024, Ad.block), group=4,
    )
    x = rng.standard_normal(n)
    yd = Ad.unshard_vector(Ad.matvec(Ad.shard_vector(x)))
    xp = np.zeros(n_pad)
    xp[:n] = x
    y1 = np.asarray(P1.matvec(jnp.asarray(xp)))[:n]
    assert np.abs(yd - dense @ x).max() < 1e-10 * np.abs(dense @ x).max()
    assert np.abs(yd - y1).max() == 0.0

    b = dense @ rng.standard_normal(n)
    bp = np.zeros(n_pad)
    bp[:n] = b
    xd, infod = jax.jit(
        lambda A_, bb: cg_solve(A_, bb, tol=0.0, rtol=1e-8, maxiter=40)
    )(Ad, Ad.shard_vector(b))
    x1, info1 = jax.jit(
        lambda A_, bb: cg_solve(A_, bb, tol=0.0, rtol=1e-8, maxiter=40)
    )(P1, jnp.asarray(bp))
    assert int(infod.iterations) == int(info1.iterations)
    err = np.abs(Ad.unshard_vector(xd) - np.asarray(x1)[:n]).max()
    assert err < 1e-8


def test_distributed_pruned_pair_amg_parity(rng):
    # the distributed multilevel preconditioner for unstructured banded
    # matrices: exact iteration parity with the single-device hierarchy
    # over the same padded index space (VERDICT r03 item 3)
    from sigma_tpu.parallel import (
        distribute_pruned,
        distributed_pruned_pair_amg,
        make_mesh,
    )
    from sigma_tpu.solvers import cg_solve, pruned_pair_amg

    n = 6000
    dense, rows, cols, vals = _banded_spd(rng, n)
    mesh = make_mesh(4)
    Ad = distribute_pruned(n, rows, cols, vals, mesh, tile_rows=1024,
                           group=4)
    n_pad = Ad.n_pad
    P1 = PrunedDIAMatrix.from_coo(
        n_pad, n_pad, rows, cols, vals,
        tile_rows=min(1024, Ad.block), group=4,
    )
    Mg_d = distributed_pruned_pair_amg(
        n, rows, cols, vals, mesh, coarse_size=2048, tile_rows=1024,
        group=4, fine_A=Ad,
    )
    Mg_1 = pruned_pair_amg(
        n, rows, cols, vals, coarse_size=2048,
        tile_rows=min(1024, Ad.block), group=4, pad_to=n_pad, fine_A=P1,
    )
    assert len(Mg_d.levels) == len(Mg_1.levels)
    b = dense @ rng.standard_normal(n)
    bp = np.zeros(n_pad)
    bp[:n] = b
    solve = lambda A_, bb, M: cg_solve(
        A_, bb, tol=0.0, rtol=1e-8, maxiter=60, M=M
    )
    xg, infog = jax.jit(solve)(Ad, Ad.shard_vector(b), Mg_d)
    xg1, infog1 = jax.jit(solve)(P1, jnp.asarray(bp), Mg_1)
    x0, info0 = jax.jit(
        lambda A_, bb: cg_solve(A_, bb, tol=0.0, rtol=1e-8, maxiter=60)
    )(Ad, Ad.shard_vector(b))
    assert int(infog.iterations) == int(infog1.iterations)
    assert int(infog.iterations) < int(info0.iterations)  # multilevel wins
    errg = np.abs(Ad.unshard_vector(xg) - np.asarray(xg1)[:n]).max()
    assert errg < 1e-6 * max(1.0, np.abs(np.asarray(xg1)).max())


def test_distributed_pruned_matmat_and_block_cg(rng):
    # distributed multi-RHS apply + block CG over the mesh
    from sigma_tpu.parallel import distribute_pruned, make_mesh
    from sigma_tpu.solvers.krylov import block_cg_solve

    n = 4000
    dense, rows, cols, vals = _banded_spd(rng, n, shift=0.5)
    mesh = make_mesh(4)
    Ad = distribute_pruned(n, rows, cols, vals, mesh, tile_rows=1024,
                           group=4)
    n_pad = Ad.n_pad
    X = rng.standard_normal((n, 3))
    Xp = np.zeros((n_pad, 3))
    Xp[:n] = X
    Xd = jax.device_put(Xp, jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("rows", None)))
    Yd = np.asarray(Ad.matmat(Xd))[:n]
    assert np.abs(Yd - dense @ X).max() < 1e-10 * np.abs(dense @ X).max()

    B = dense @ rng.standard_normal((n, 3))
    Bp = np.zeros((n_pad, 3))
    Bp[:n] = B
    Bd = jax.device_put(Bp, jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("rows", None)))
    Xs, info = jax.jit(
        lambda A_, B_: block_cg_solve(A_, B_, tol=0.0, rtol=1e-10,
                                      maxiter=200)
    )(Ad, Bd)
    err = np.abs(
        np.asarray(Xs)[:n] - np.linalg.solve(dense, B)
    ).max()
    assert err < 1e-6


def test_distributed_pruned_rmatvec_and_cgls(rng):
    # transpose apply over the mesh (reversed halo combine) + jitted
    # distributed least squares
    from sigma_tpu.parallel import distribute_pruned, make_mesh
    from sigma_tpu.solvers import cgls_solve

    n = 6000
    dense = np.zeros((n, n))
    i = np.arange(n)
    for o in (1, 3, 9):
        dense[i[:-o], i[:-o] + o] = rng.standard_normal(n - o) * 0.2
        dense[i[:-o] + o, i[:-o]] = rng.standard_normal(n - o) * 0.2
    dense[i, i] = 3.0
    rows, cols = np.nonzero(dense)
    vals = dense[rows, cols]
    mesh = make_mesh(8)
    Ad = distribute_pruned(n, rows, cols, vals, mesh, tile_rows=1024,
                           group=4, with_transpose=True,
                           assume_unique=True)
    x = rng.standard_normal(n)
    yt = Ad.unshard_vector(
        jax.jit(lambda A_, v: A_.rmatvec(v))(Ad, Ad.shard_vector(x))
    )
    ref = dense.T @ x
    assert np.abs(yt - ref).max() < 1e-10 * np.abs(ref).max()
    # rmatvec without the plan: clear contract error
    Ad0 = distribute_pruned(n, rows, cols, vals, mesh, tile_rows=1024,
                            group=4, assume_unique=True)
    with pytest.raises(NotImplementedError, match="with_transpose"):
        Ad0.rmatvec(Ad0.shard_vector(x))
    # distributed least squares end-to-end
    b = dense @ rng.standard_normal(n)
    xs, info = jax.jit(
        lambda A_, b_: cgls_solve(A_, b_, tol=0.0, rtol=1e-10, maxiter=400)
    )(Ad, Ad.shard_vector(b))
    nr = np.linalg.norm(
        dense.T @ (b - dense @ Ad.unshard_vector(xs)[:n])
    )
    assert nr < 1e-5 * max(np.linalg.norm(b), 1.0)


def test_distributed_pruned_guards(rng):
    from sigma_tpu.parallel import distribute_pruned, make_mesh

    mesh = make_mesh(4)
    # band reach beyond the shard block: nearest-neighbor halo cannot
    # serve it
    with pytest.raises(ValueError, match="reach"):
        distribute_pruned(
            4096, [0], [4000], [1.0], mesh, block=1024
        )


def test_nonsymmetric_bicgstab_with_pruned_gmg(rng):
    # the reference's skew-perturbed solver test
    # (solver_test_jacobi.f90's BiCG-stab re-solve) on the pruned
    # format with the value-agnostic pair-AMG preconditioner
    from sigma_tpu.solvers import bicgstab_solve, pruned_pair_amg

    n = 2048
    dense, rows, cols, vals = _banded_spd(rng, n, shift=0.05)
    off = cols - rows
    vals = vals + 0.3 * np.sign(off) * np.abs(vals)  # skew part
    dense = np.zeros((n, n))
    dense[rows, cols] = vals
    A = PrunedDIAMatrix.from_coo(n, n, rows, cols, vals, tile_rows=1024,
                                 group=4)
    M = pruned_pair_amg(n, rows, cols, vals, coarse_size=256,
                        smoother="jacobi", tile_rows=1024, group=4,
                        fine_A=A)
    xstar = rng.standard_normal(n)
    b = jnp.asarray(dense @ xstar)
    x, info = bicgstab_solve(A, b, tol=0.0, rtol=1e-10, maxiter=400, M=M)
    x0, info0 = bicgstab_solve(A, b, tol=0.0, rtol=1e-10, maxiter=400)
    assert np.abs(np.asarray(x) - xstar).max() < 1e-6
    assert int(info.iterations) < int(info0.iterations)


def test_with_transpose_jit_safe(rng):
    # rmatvec/cgls inside jit need the transpose plan attached at setup
    # (a host rebuild cannot run under a tracer) — advisor round-4 item
    from sigma_tpu.solvers import cgls_solve

    n, m = 1500, 1200
    _, _, _, dense = _random_banded(rng, n, m, 6000)
    dense *= 0.1
    dense[np.arange(m), np.arange(m)] += 5.0  # well-conditioned LS
    rows, cols = np.nonzero(dense)
    vals = dense[rows, cols]
    A = PrunedDIAMatrix.from_coo(n, m, rows, cols, vals, tile_rows=1024,
                                 group=2)
    x = jnp.asarray(rng.standard_normal(n))
    with pytest.raises(NotImplementedError, match="with_transpose"):
        jax.jit(lambda A_, v: A_.rmatvec(v))(A, x)
    At = A.with_transpose()
    y = np.asarray(jax.jit(lambda A_, v: A_.rmatvec(v))(At, x))
    assert np.abs(y - dense.T @ np.asarray(x)).max() < 1e-10
    # least squares end-to-end, jitted (normal-equations residual check)
    b = np.asarray(dense @ rng.standard_normal(m))
    xs, info = jax.jit(
        lambda A_, b_: cgls_solve(A_, b_, tol=0.0, rtol=1e-12, maxiter=600)
    )(At, jnp.asarray(b))
    nr = np.linalg.norm(dense.T @ (b - dense @ np.asarray(xs)))
    assert nr < 1e-6 * max(np.linalg.norm(b), 1.0)


def test_block_matrix_of_pruned(rng):
    # the composite seam (sparse_matrix_composites.f90) over the round-4
    # format: a 2x2 multi-field operator with pruned blocks composes
    # with the generic BlockMatrix and solves under CG
    from sigma_tpu.matrix.composite import BlockMatrix
    from sigma_tpu.solvers import cg_solve

    n = 1200
    blocks = []
    dense = np.zeros((2 * n, 2 * n))
    for bi in range(2):
        row = []
        for bj in range(2):
            d, rows, cols, vals = _banded_spd(rng, n, shift=0.2)
            if bi != bj:
                d = 0.1 * d  # weak coupling keeps the 2x2 system SPD
                d = 0.5 * (d + d.T)
                rows, cols = np.nonzero(d)
                vals = d[rows, cols]
            dense[bi * n : (bi + 1) * n, bj * n : (bj + 1) * n] = d
            row.append(PrunedDIAMatrix.from_coo(
                n, n, rows, cols, vals, tile_rows=1024, group=2
            ))
        blocks.append(row)
    # symmetrize the off-diagonal pair
    dense[n:, :n] = dense[:n, n:].T
    blocks[1][0] = PrunedDIAMatrix.from_coo(
        n, n, *(list(np.nonzero(dense[n:, :n]))
                + [dense[n:, :n][np.nonzero(dense[n:, :n])]]),
        tile_rows=1024, group=2,
    )
    A = BlockMatrix.from_blocks(blocks)
    x = rng.standard_normal(2 * n)
    y = np.asarray(A.matvec(jnp.asarray(x)))
    assert np.abs(y - dense @ x).max() < 1e-10 * np.abs(dense @ x).max()
    xstar = rng.standard_normal(2 * n)
    b = jnp.asarray(dense @ xstar)
    xs, info = cg_solve(A, b, tol=0.0, rtol=1e-12, maxiter=600)
    assert np.abs(np.asarray(xs) - xstar).max() < 1e-7


def test_io_roundtrip_pruned(rng, tmp_path):
    # matrix-market + npz persistence through the COO boundary
    from sigma_tpu import io

    n = 900
    _, rows, cols, vals = _banded_spd(rng, n)
    A = PrunedDIAMatrix.from_coo(n, n, rows, cols, vals, tile_rows=1024)
    path = tmp_path / "A.mtx"
    io.write_matrix_market(A, path)
    B = io.read_matrix_market(path, frmt="csr")
    r2, c2, v2 = B.entries()
    B2 = PrunedDIAMatrix.from_coo(n, n, r2, c2, v2, tile_rows=1024)
    assert np.abs(B2.to_dense() - A.to_dense()).max() < 1e-12


def test_empty_tiles_and_tiny(rng):
    # rows concentrated in one tile; other tiles must still zero their y
    n = 5000
    rows = rng.integers(0, 900, 300)
    cols = np.clip(rows + rng.integers(-30, 31, 300), 0, n - 1)
    vals = rng.standard_normal(300)
    key = rows * n + cols
    _, idx = np.unique(key, return_index=True)
    rows, cols, vals = rows[idx], cols[idx], vals[idx]
    dense = np.zeros((n, n))
    dense[rows, cols] = vals
    A = PrunedDIAMatrix.from_coo(n, n, rows, cols, vals, tile_rows=1024)
    x = rng.standard_normal(n)
    y = np.asarray(A.matvec(jnp.asarray(x)))
    assert np.abs(y - dense @ x).max() < 1e-10
    assert np.all(y[2048:] == 0.0)


# ---------------------------------------------------------------------------
# Symmetric pruned storage (upper-triangle packing + in-kernel mirror)
# ---------------------------------------------------------------------------

def _random_sym(rng, n, nnz, band=150):
    rows = rng.integers(0, n, nnz)
    cols = np.clip(rows + rng.integers(-band, band + 1, nnz), 0, n - 1)
    vals = rng.standard_normal(nnz)
    keep = cols >= rows
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    key = rows * np.int64(n) + cols
    _, idx = np.unique(key, return_index=True)
    rows, cols, vals = rows[idx], cols[idx], vals[idx]
    off = cols > rows
    r2 = np.concatenate([rows, cols[off]])
    c2 = np.concatenate([cols, rows[off]])
    v2 = np.concatenate([vals, vals[off]])
    dense = np.zeros((n, n))
    dense[r2, c2] = v2
    return r2, c2, v2, dense


def test_sym_pruned_matvec_matmat_dense_oracle(rng):
    from sigma_tpu.matrix.pruned import SymmetricPrunedDIAMatrix

    n = 3100
    r, c, v, dense = _random_sym(rng, n, 20000)
    A = SymmetricPrunedDIAMatrix.from_coo(n, n, r, c, v, tile_rows=1024,
                                          group=4)
    assert A.nnz == np.count_nonzero(dense)
    # stored slots are ~half the full packing
    P = PrunedDIAMatrix.from_coo(n, n, r, c, v, tile_rows=1024, group=4)
    assert A.stored_slots < 0.62 * P.stored_slots
    x = rng.standard_normal(n)
    y = np.asarray(A.matvec(jnp.asarray(x)))
    assert np.abs(y - dense @ x).max() < 1e-10 * np.abs(dense @ x).max()
    # rmatvec is the identity route
    yr = np.asarray(A.rmatvec(jnp.asarray(x)))
    assert np.array_equal(y, yr)
    X = rng.standard_normal((n, 3))
    Y = np.asarray(A.matmat(jnp.asarray(X)))
    assert np.abs(Y - dense @ X).max() < 1e-10 * np.abs(dense @ X).max()
    # entries reconstruct both triangles
    rr, cc, vv = A.entries()
    d2 = np.zeros((n, n))
    d2[rr, cc] = vv
    assert np.abs(d2 - dense).max() == 0.0
    assert A.transpose() is A


def test_sym_pruned_validation_raises(rng):
    from sigma_tpu.matrix.pruned import SymmetricPrunedDIAMatrix

    n = 2000
    r, c, v, dense = _random_sym(rng, n, 8000)
    # break one value's mirror
    off = c > r
    v2 = v.copy()
    v2[np.nonzero(off)[0][0]] += 1.0
    with pytest.raises(ValueError, match="not symmetric"):
        SymmetricPrunedDIAMatrix.from_coo(n, n, r, c, v2, tile_rows=1024)
    # break the pattern
    with pytest.raises(ValueError, match="not symmetric"):
        SymmetricPrunedDIAMatrix.from_coo(
            n, n, r[:-1], c[:-1], v[:-1], tile_rows=1024
        )
    with pytest.raises(ValueError, match="square"):
        SymmetricPrunedDIAMatrix.from_coo(n, n + 128, r, c, v)


def test_sym_pruned_f32_matches_dense(rng):
    # f32 matvec + spmm; the spill of a whole square matrix is zero
    from sigma_tpu.matrix.pruned import SymmetricPrunedDIAMatrix
    from sigma_tpu.matrix.pruned_plan import pruned_sym_matvec_reference

    n = 4000
    r, c, v, dense = _random_sym(rng, n, 18000, band=200)
    A = SymmetricPrunedDIAMatrix.from_coo(
        n, n, r, c, v.astype(np.float32), dtype=np.float32,
        tile_rows=1024, group=6,
    )
    dense32 = dense.astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    y = A.matvec(jnp.asarray(x))
    _, spill = pruned_sym_matvec_reference(
        A.data, jnp.asarray(x), A.tile, A.rowoff, A.laneoff,
        with_spill=True, **A._plan_kwargs(),
    )
    ref = dense32 @ x
    assert np.abs(np.asarray(y) - ref).max() < 1e-5 * np.abs(ref).max()
    assert np.abs(np.asarray(spill)).max() == 0.0  # whole square matrix
    XT = rng.standard_normal((3, n)).astype(np.float32)
    Y = A.matmat_rhs_major(jnp.asarray(XT))
    Yref = XT @ dense32.T
    assert np.abs(np.asarray(Y) - Yref).max() < 1e-5 * np.abs(Yref).max()


def test_sym_pruned_reference_sym_shift(rng):
    # the distributed rectangular form: local block (blk, blk + 2*Hw)
    # with sym_shift=Hw; spill carries the mirror rows past blk
    from sigma_tpu.matrix.pruned_plan import pruned_sym_matvec_reference

    blk, Hw = 2048, 256
    n_up = 6000
    rng2 = np.random.default_rng(7)
    r = rng2.integers(0, blk, n_up)
    c = r + rng2.integers(0, 200, n_up)  # upper only, reach < Hw range
    v = rng2.standard_normal(n_up).astype(np.float32)
    key = r * np.int64(blk + 2 * Hw) + c
    _, idx = np.unique(key, return_index=True)
    r, c, v = r[idx], c[idx], v[idx]
    m = blk + 2 * Hw
    plan = build_pruned_plan(
        blk, m, r, c + Hw, v, tile_rows=1024, group=4,
        min_reach=int((c - r).max()) + Hw, dtype=np.float32,
    )
    data = jnp.asarray(plan.data.reshape(plan.L, plan.C, plan.T, 128))
    x = rng2.standard_normal(m).astype(np.float32)
    kw = dict(T=plan.T, E=plan.E, C=plan.C, n=blk, m=m, sym_shift=Hw)
    yr, spr = pruned_sym_matvec_reference(
        data, jnp.asarray(x), jnp.asarray(plan.tile),
        jnp.asarray(plan.rowoff), jnp.asarray(plan.laneoff),
        with_spill=True, **kw,
    )
    # dense oracle: global entries (r, c) upper + mirror, x frame offset
    dense = np.zeros((blk + plan.E * 128, m), np.float32)
    dense[r, c + Hw] = v
    mir = c > r
    dense[(c[mir]).astype(np.int64), r[mir] + Hw] += v[mir]
    full = dense @ x
    assert np.abs(np.asarray(yr) - full[:blk]).max() < 1e-4
    assert np.abs(np.asarray(spr) - full[blk:]).max() < 1e-4


def test_sym_pruned_cg_and_to_pruned_dia(rng):
    from sigma_tpu.matrix.banded import to_pruned_dia
    from sigma_tpu.matrix.pruned import SymmetricPrunedDIAMatrix
    from sigma_tpu.solvers import cg_solve

    n = 4000
    dense, rows, cols, vals = _banded_spd(rng, n)
    A = SymmetricPrunedDIAMatrix.from_coo(n, n, rows, cols, vals,
                                          tile_rows=1024, group=4)
    b = dense @ rng.standard_normal(n)
    x, info = jax.jit(
        lambda A_, b_: cg_solve(A_, b_, tol=0.0, rtol=1e-10, maxiter=200)
    )(A, jnp.asarray(b))
    r = np.abs(dense @ np.asarray(x) - b).max()
    assert r < 1e-8 * np.abs(b).max()
    # to_pruned_dia(symmetric=True) routing
    from sigma_tpu.matrix.formats import CSRMatrix

    C = CSRMatrix.from_coo(n, n, rows, cols, vals)
    S, p = to_pruned_dia(C, symmetric=True, tile_rows=1024)
    assert isinstance(S, SymmetricPrunedDIAMatrix)
    # permuted-frame contract: S[p[i], p[j]] == A[i, j]
    xs = rng.standard_normal(n)
    xp = np.empty(n)
    xp[p] = xs
    yp = np.asarray(S.matvec(jnp.asarray(xp)))
    assert np.abs(yp[p] - dense @ xs).max() < 1e-9 * np.abs(dense @ xs).max()


def test_distributed_sym_pruned_parity(rng):
    # distributed symmetric pruned: matvec/matmat match the dense oracle
    # and the single-device symmetric twin; CG iteration parity
    from sigma_tpu.matrix.pruned import SymmetricPrunedDIAMatrix
    from sigma_tpu.parallel import distribute_pruned, make_mesh
    from sigma_tpu.solvers import cg_solve

    n = 6000
    dense, rows, cols, vals = _banded_spd(rng, n)
    mesh = make_mesh(8)
    Ad = distribute_pruned(n, rows, cols, vals, mesh, tile_rows=1024,
                           group=4, symmetric=True)
    assert Ad.symmetric and Ad.nnz == np.count_nonzero(dense)
    n_pad = Ad.n_pad
    S1 = SymmetricPrunedDIAMatrix.from_coo(
        n_pad, n_pad, rows, cols, vals,
        tile_rows=min(1024, Ad.block), group=4, validate=False,
    )
    x = rng.standard_normal(n)
    yd = Ad.unshard_vector(Ad.matvec(Ad.shard_vector(x)))
    assert np.abs(yd - dense @ x).max() < 1e-10 * np.abs(dense @ x).max()
    xp = np.zeros(n_pad)
    xp[:n] = x
    y1 = np.asarray(S1.matvec(jnp.asarray(xp)))[:n]
    assert np.abs(yd - y1).max() < 1e-12 * np.abs(y1).max()
    # rmatvec = matvec on symmetric storage
    yr = Ad.unshard_vector(Ad.rmatvec(Ad.shard_vector(x)))
    assert np.array_equal(yd, yr)
    # matmat
    X = rng.standard_normal((n, 3))
    Xp = np.zeros((n_pad, 3))
    Xp[:n] = X
    Xd = jax.device_put(Xp, jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("rows", None)))
    Yd = np.asarray(Ad.matmat(Xd))
    assert np.abs(Yd[:n] - dense @ X).max() < 1e-10 * np.abs(dense @ X).max()
    # CG parity with the full-storage distributed operator
    Af = distribute_pruned(n, rows, cols, vals, mesh, tile_rows=1024,
                           group=4)
    b = dense @ rng.standard_normal(n)
    xd, infod = jax.jit(
        lambda A_, bb: cg_solve(A_, bb, tol=0.0, rtol=1e-8, maxiter=60)
    )(Ad, Ad.shard_vector(b))
    xf, infof = jax.jit(
        lambda A_, bb: cg_solve(A_, bb, tol=0.0, rtol=1e-8, maxiter=60)
    )(Af, Af.shard_vector(b))
    assert int(infod.iterations) == int(infof.iterations)
    assert np.abs(Ad.unshard_vector(xd) - Af.unshard_vector(xf)).max() < 1e-9


def test_sym_pruned_guards(rng):
    from sigma_tpu.parallel import distribute_pruned, make_mesh

    n = 6000
    dense, rows, cols, vals = _banded_spd(rng, n)
    mesh = make_mesh(8)
    with pytest.raises(ValueError, match="transpose"):
        distribute_pruned(n, rows, cols, vals, mesh, symmetric=True,
                          with_transpose=True)
    v2 = vals.copy()
    v2[np.nonzero(cols > rows)[0][0]] += 1.0
    with pytest.raises(ValueError, match="not symmetric"):
        distribute_pruned(n, rows, cols, v2, mesh, symmetric=True)


def test_pruned_pair_amg_symmetric_levels(rng):
    # symmetric level storage: identical hierarchy numerics (same COO
    # per level), so preconditioned CG matches the full-storage AMG's
    # iterate and iteration count
    from sigma_tpu.solvers import cg_solve
    from sigma_tpu.solvers.gmg import pruned_pair_amg

    n = 6000
    dense, rows, cols, vals = _banded_spd(rng, n)
    Mf = pruned_pair_amg(n, rows, cols, vals, coarse_size=512,
                         tile_rows=1024, group=4)
    Ms = pruned_pair_amg(n, rows, cols, vals, coarse_size=512,
                         tile_rows=1024, group=4, symmetric=True)
    A = PrunedDIAMatrix.from_coo(n, n, rows, cols, vals, tile_rows=1024,
                                 group=4)
    b = dense @ rng.standard_normal(n)
    xf, infof = jax.jit(
        lambda A_, M_, bb: cg_solve(A_, bb, M=M_, tol=0.0, rtol=1e-9,
                                    maxiter=60)
    )(A, Mf, jnp.asarray(b))
    xs, infos = jax.jit(
        lambda A_, M_, bb: cg_solve(A_, bb, M=M_, tol=0.0, rtol=1e-9,
                                    maxiter=60)
    )(A, Ms, jnp.asarray(b))
    assert int(infof.iterations) == int(infos.iterations)
    assert np.abs(np.asarray(xf) - np.asarray(xs)).max() < 1e-8


def test_distributed_pruned_pair_amg_symmetric_parity(rng):
    # distributed SYMMETRIC-storage multilevel: exact iteration parity
    # with (a) the single-device symmetric hierarchy and (b) the
    # full-storage distributed hierarchy (same numerics, half the
    # per-shard value streams)
    from sigma_tpu.matrix.pruned import SymmetricPrunedDIAMatrix
    from sigma_tpu.parallel import (
        distribute_pruned,
        distributed_pruned_pair_amg,
        make_mesh,
    )
    from sigma_tpu.solvers import cg_solve, pruned_pair_amg

    n = 6000
    dense, rows, cols, vals = _banded_spd(rng, n)
    mesh = make_mesh(4)
    Ads = distribute_pruned(n, rows, cols, vals, mesh, tile_rows=1024,
                            group=4, symmetric=True)
    n_pad = Ads.n_pad
    Mg_ds = distributed_pruned_pair_amg(
        n, rows, cols, vals, mesh, coarse_size=2048, tile_rows=1024,
        group=4, fine_A=Ads, symmetric=True,
    )
    S1 = SymmetricPrunedDIAMatrix.from_coo(
        n_pad, n_pad, rows, cols, vals, tile_rows=min(1024, Ads.block),
        group=4, validate=False,
    )
    Mg_1s = pruned_pair_amg(
        n, rows, cols, vals, coarse_size=2048,
        tile_rows=min(1024, Ads.block), group=4, pad_to=n_pad,
        fine_A=S1, symmetric=True,
    )
    Adf = distribute_pruned(n, rows, cols, vals, mesh, tile_rows=1024,
                            group=4)
    Mg_df = distributed_pruned_pair_amg(
        n, rows, cols, vals, mesh, coarse_size=2048, tile_rows=1024,
        group=4, fine_A=Adf,
    )
    b = dense @ rng.standard_normal(n)
    bp = np.zeros(n_pad)
    bp[:n] = b
    solve = lambda A_, bb, M: cg_solve(
        A_, bb, tol=0.0, rtol=1e-8, maxiter=60, M=M
    )
    xs, infos = jax.jit(solve)(Ads, Ads.shard_vector(b), Mg_ds)
    x1, info1 = jax.jit(solve)(S1, jnp.asarray(bp), Mg_1s)
    xf, infof = jax.jit(solve)(Adf, Adf.shard_vector(b), Mg_df)
    assert int(infos.iterations) == int(info1.iterations)
    assert int(infos.iterations) == int(infof.iterations)
    err = np.abs(Ads.unshard_vector(xs) - np.asarray(x1)[:n]).max()
    assert err < 1e-6 * max(1.0, np.abs(np.asarray(x1)).max())
    err2 = np.abs(Ads.unshard_vector(xs) - Adf.unshard_vector(xf)).max()
    assert err2 < 1e-6 * max(1.0, np.abs(np.asarray(x1)).max())


def test_gmres_fgmres_on_padded_distributed(rng):
    # regression (round 5): gmres/fgmres sized their Krylov basis by
    # A.shape[0] (the UNPADDED n) — broken on any mesh where
    # n % n_devices != 0; basis is now sized by b
    from sigma_tpu.parallel import distribute_pruned, make_mesh
    from sigma_tpu.solvers import fgmres_solve, gmres_solve

    n = 5000  # 8 shards -> block 1024, n_pad 8192 != n
    dense, rows, cols, vals = _banded_spd(rng, n, shift=0.5)
    mesh = make_mesh(8)
    Ad = distribute_pruned(n, rows, cols, vals, mesh, tile_rows=1024,
                           group=4)
    assert Ad.n_pad != n
    b = dense @ rng.standard_normal(n)
    for solver in (gmres_solve, fgmres_solve):
        x, info = jax.jit(
            lambda A_, bb: solver(A_, bb, tol=0.0, rtol=1e-8,
                                  restart=20, maxiter=200)
        )(Ad, Ad.shard_vector(b))
        r = dense @ Ad.unshard_vector(x) - b
        assert np.linalg.norm(r) < 1e-6 * np.linalg.norm(b)


def test_block_matrix_with_sym_pruned_diagonal_blocks(rng):
    # composite seam over the round-5 format: symmetric-storage pruned
    # DIAGONAL blocks + full pruned off-diagonal coupling, matvec vs
    # dense and CG solve
    from sigma_tpu.matrix.composite import BlockMatrix
    from sigma_tpu.matrix.pruned import SymmetricPrunedDIAMatrix
    from sigma_tpu.solvers import cg_solve

    n = 1200
    dense = np.zeros((2 * n, 2 * n))
    d0, r0, c0, v0 = _banded_spd(rng, n, shift=0.3)
    d1, r1, c1, v1 = _banded_spd(rng, n, offs=(2, 4, 9), shift=0.3)
    dc = 0.05 * _banded_spd(rng, n, offs=(1, 6), shift=0.0)[0]
    dc = 0.5 * (dc + dc.T)
    rc, cc_ = np.nonzero(dc)
    dense[:n, :n] = d0
    dense[n:, n:] = d1
    dense[:n, n:] = dc
    dense[n:, :n] = dc.T
    S0 = SymmetricPrunedDIAMatrix.from_coo(n, n, r0, c0, v0,
                                           tile_rows=1024, group=2)
    S1 = SymmetricPrunedDIAMatrix.from_coo(n, n, r1, c1, v1,
                                           tile_rows=1024, group=2)
    C = PrunedDIAMatrix.from_coo(n, n, rc, cc_, dc[rc, cc_],
                                 tile_rows=1024, group=2)
    Ct = PrunedDIAMatrix.from_coo(n, n, cc_, rc, dc[rc, cc_],
                                  tile_rows=1024, group=2)
    A = BlockMatrix.from_blocks([[S0, C], [Ct, S1]])
    x = rng.standard_normal(2 * n)
    y = np.asarray(A.matvec(jnp.asarray(x)))
    assert np.abs(y - dense @ x).max() < 1e-9 * np.abs(dense @ x).max()
    xstar = rng.standard_normal(2 * n)
    b = jnp.asarray(dense @ xstar)
    xs, info = cg_solve(A, b, tol=0.0, rtol=1e-12, maxiter=600)
    assert np.abs(np.asarray(xs) - xstar).max() < 1e-7


def test_distributed_sym_tile_block_alignment(rng):
    # review regression (round 5): with tile_rows not dividing the shard
    # block, the last tile extended past the block and cross-shard
    # mirror spill was silently dropped; tr now rounds to a pow2 divisor
    from sigma_tpu.parallel import distribute_pruned, make_mesh

    n = 14000
    dense, rows, cols, vals = _banded_spd(rng, n, offs=(1, 7, 300),
                                          shift=0.2)
    mesh = make_mesh(4)
    Ad = distribute_pruned(n, rows, cols, vals, mesh, tile_rows=3072,
                           group=4, block=4096, symmetric=True,
                           validate=False)
    x = rng.standard_normal(n)
    yd = Ad.unshard_vector(Ad.matvec(Ad.shard_vector(x)))
    assert np.abs(yd - dense @ x).max() < 1e-10 * np.abs(dense @ x).max()
    # band reach forcing tiles past the block must raise, not corrupt
    r2 = np.concatenate([rows, [0, 3500]])
    c2 = np.concatenate([cols, [3500, 0]])
    v2 = np.concatenate([vals, [1.0, 1.0]])
    with pytest.raises(ValueError, match="reach"):
        distribute_pruned(n, r2, c2, v2, mesh, tile_rows=1024,
                          group=4, block=4096, symmetric=True,
                          validate=False)


def test_check_symmetric_triples_duplicates(rng):
    # review regression: duplicate keys are canonicalized last-wins
    # BEFORE the mirror comparison (the packing's semantics)
    from sigma_tpu.matrix.pruned import check_symmetric_triples

    n = 10
    # symmetric after last-wins (1.0 then 2.0 both sides)
    r = np.array([0, 0, 1, 1, 0, 1])
    c = np.array([1, 1, 0, 0, 0, 1])
    v = np.array([1.0, 2.0, 1.0, 2.0, 1.0, 1.0])
    check_symmetric_triples(n, r, c, v)  # must not raise
    # asymmetric after last-wins (2.0 vs 1.0) even though the value
    # multisets match
    v2 = np.array([1.0, 2.0, 2.0, 1.0, 1.0, 1.0])
    with pytest.raises(ValueError, match="not symmetric"):
        check_symmetric_triples(n, r, c, v2)
