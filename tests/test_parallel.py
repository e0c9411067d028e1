"""Distributed (mesh-sharded) matrix tests on the virtual 8-device CPU mesh.

The reference is serial; its composite block matvec
(``sparse_matrix_composites.f90:1076-1129``, "This loop can be parallelized")
is the seam these tests exercise for real: row partition over a 1-D mesh,
cyclic-offset halo exchange via ppermute, solver dots psum'd by XLA.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sigma_tpu import CSRMatrix, DIAMatrix, ELLMatrix
from sigma_tpu.parallel import (
    distribute_matrix,
    distribute_vector,
    make_mesh,
)
from sigma_tpu.solvers import bicgstab_solve, cg_solve

TOL = 1e-13


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return make_mesh(8)


def laplacian_1d(n, wrap=False):
    d = 2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    if wrap:
        d[0, n - 1] = d[n - 1, 0] = -1.0
    return d


def test_banded_offsets_are_sparse(mesh):
    """A tridiagonal matrix on 8 shards stores only offsets {0, 1, D-1} —
    neighbor hops on the ring, never an all-gather."""
    n = 64
    A = CSRMatrix.from_dense(laplacian_1d(n) + np.eye(n))
    Ad = distribute_matrix(A, mesh)
    assert set(Ad.offsets) <= {0, 1, 7}


def test_spmv_matches_dense(mesh, rng):
    n = 200
    dense = laplacian_1d(n, wrap=True) + np.eye(n)
    Ad = distribute_matrix(CSRMatrix.from_dense(dense), mesh)
    x = rng.standard_normal(n)
    y = Ad.unshard_vector(Ad.matvec(Ad.shard_vector(x)))
    assert np.max(np.abs(y - dense @ x)) < TOL


def test_spmv_and_rmatvec_general_sparsity(mesh, rng):
    """Random (non-banded) sparsity exercises many ring offsets; one
    matrix serves both the forward and the transpose apply (a single
    compile — this suite is compile-dominated)."""
    n = 96
    dense = np.where(rng.random((n, n)) < 0.05, rng.standard_normal((n, n)), 0.0)
    dense += np.diag(np.full(n, 4.0))
    Ad = distribute_matrix(CSRMatrix.from_dense(dense), mesh)
    x = rng.standard_normal(n)

    @jax.jit
    def both(Ad, xs):
        return Ad.matvec(xs), Ad.rmatvec(xs)

    y, z = both(Ad, Ad.shard_vector(x))
    assert np.max(np.abs(Ad.unshard_vector(y) - dense @ x)) < TOL
    assert np.max(np.abs(Ad.unshard_vector(z) - dense.T @ x)) < TOL


def test_spmm_multivector(mesh, rng):
    n, nrhs = 160, 6
    dense = laplacian_1d(n) + np.eye(n)
    Ad = distribute_matrix(ELLMatrix.from_dense(dense), mesh)
    X = rng.standard_normal((n, nrhs))
    Xs = distribute_vector(X, Ad.mesh, Ad.axis, Ad.n_pad)
    Y = np.asarray(Ad.matmat(Xs))[:n]
    assert np.max(np.abs(Y - dense @ X)) < TOL


def test_distributed_cg(mesh, rng):
    """The unchanged cg_solve runs distributed: sharded operands, auto-psum
    dots, ppermute halo inside the matvec."""
    n = 500
    dense = laplacian_1d(n) + np.eye(n)
    Ad = distribute_matrix(CSRMatrix.from_dense(dense), mesh)
    xstar = rng.standard_normal(n)
    b = Ad.shard_vector(dense @ xstar)
    x, info = cg_solve(Ad, b, tol=1e-14)
    assert np.max(np.abs(Ad.unshard_vector(x) - xstar)) < 1e-9


def test_distributed_bicgstab(mesh, rng):
    n = 300
    dense = laplacian_1d(n) + np.eye(n)
    # nonsymmetric upwind term
    dense += 0.3 * (np.eye(n, k=1) - np.eye(n, k=-1))
    Ad = distribute_matrix(CSRMatrix.from_dense(dense), mesh)
    xstar = rng.standard_normal(n)
    b = Ad.shard_vector(dense @ xstar)
    x, info = bicgstab_solve(Ad, b, tol=1e-13, maxiter=600)
    assert np.max(np.abs(Ad.unshard_vector(x) - xstar)) < 1e-7


def test_jit_spmv(mesh, rng):
    n = 128
    dense = laplacian_1d(n) + np.eye(n)
    Ad = distribute_matrix(CSRMatrix.from_dense(dense), mesh)
    x = rng.standard_normal(n)
    xs = Ad.shard_vector(x)
    y = jax.jit(lambda M, v: M.matvec(v))(Ad, xs)
    assert np.max(np.abs(np.asarray(y)[:n] - dense @ x)) < TOL


def test_uneven_rows_padding(mesh, rng):
    """n not divisible by D: zero-row padding must not corrupt results."""
    n = 101
    dense = laplacian_1d(n) + np.eye(n)
    Ad = distribute_matrix(CSRMatrix.from_dense(dense), mesh)
    assert Ad.n_pad == 104
    x = rng.standard_normal(n)
    y = Ad.unshard_vector(Ad.matvec(Ad.shard_vector(x)))
    assert np.max(np.abs(y - dense @ x)) < TOL
    xstar = rng.standard_normal(n)
    b = Ad.shard_vector(dense @ xstar)
    xsol, _ = cg_solve(Ad, b, tol=1e-14)
    assert np.max(np.abs(Ad.unshard_vector(xsol) - xstar)) < 1e-9


def test_to_dense_roundtrip(mesh, rng):
    n = 40
    dense = np.where(rng.random((n, n)) < 0.1, rng.standard_normal((n, n)), 0.0)
    Ad = distribute_matrix(CSRMatrix.from_dense(dense), mesh)
    assert np.max(np.abs(Ad.to_dense() - dense)) < TOL


def test_distributed_diagonal(mesh, rng):
    n = 96
    dense = laplacian_1d(n) + 3.0 * np.eye(n)
    Ad = distribute_matrix(CSRMatrix.from_dense(dense), mesh)
    d = Ad.unshard_vector(Ad.diagonal())
    assert np.max(np.abs(d - 5.0)) < TOL


def test_distributed_jacobi_cg(mesh, rng):
    """Jacobi-preconditioned CG on a sharded operator: the preconditioner is
    an elementwise multiply of sharded vectors (zero-diagonal pad rows pass
    through safely)."""
    from sigma_tpu.solvers import jacobi

    n = 250  # not divisible by 8: exercises zero-diagonal padding rows
    dense = laplacian_1d(n) + np.diag(1.0 + np.arange(n) % 7)
    Ad = distribute_matrix(CSRMatrix.from_dense(dense), mesh)
    M = jacobi().setup(Ad)
    xstar = rng.standard_normal(n)
    b = Ad.shard_vector(dense @ xstar)
    x, info = cg_solve(Ad, b, tol=1e-13, M=M)
    assert np.max(np.abs(Ad.unshard_vector(x) - xstar)) < 1e-8


def test_distributed_lanczos(mesh, rng):
    """Lanczos runs unchanged on a distributed operator (n % D == 0):
    the matvec shard_maps, the dense basis ops stay GSPMD-managed."""
    from sigma_tpu.eigen import lanczos

    n = 64
    adj = np.triu(rng.random((n, n)) < 0.15, 1)
    adj = adj | adj.T
    dense = np.diag(adj.sum(1).astype(float)) - adj + np.eye(n)
    Ad = distribute_matrix(CSRMatrix.from_dense(dense), mesh)
    k = 12
    res = lanczos(Ad, k, v0=rng.standard_normal(n))
    V = np.asarray(res.V)
    T = np.asarray(res.tridiagonal())
    R = dense @ V - V @ T
    R[:, -1] -= float(res.beta[-1]) * np.asarray(res.v_next)
    assert np.max(np.abs(R)) < 1e-11
    assert np.linalg.norm(V.T @ V - np.eye(k)) < 1e-12


def test_distributed_dia_spmv(mesh, rng):
    """DIA local blocks: gather-free distributed stencil SpMV."""
    from sigma_tpu import DIAMatrix
    from sigma_tpu.parallel import distribute_matrix_dia

    n = 400
    dense = laplacian_1d(n, wrap=True) + np.eye(n)
    Ad = distribute_matrix_dia(DIAMatrix.from_dense(dense), mesh)
    # every local term is a pure diagonal: no index arrays exist at all
    assert all(isinstance(t, tuple) and len(t) == 2 for t in Ad.terms)
    x = rng.standard_normal(n)
    y = Ad.unshard_vector(Ad.matvec(Ad.shard_vector(x)))
    assert np.max(np.abs(y - dense @ x)) < TOL


def test_distributed_dia_cg_jacobi(mesh, rng):
    from sigma_tpu.parallel import distribute_matrix_dia
    from sigma_tpu.solvers import jacobi

    n = 501  # uneven: padded rows have zero diagonal
    dense = laplacian_1d(n) + np.diag(1.0 + np.arange(n) % 5)
    Ad = distribute_matrix_dia(CSRMatrix.from_dense(dense), mesh)
    xstar = rng.standard_normal(n)
    b = Ad.shard_vector(dense @ xstar)
    x, info = cg_solve(Ad, b, tol=1e-13, M=jacobi().setup(Ad))
    assert np.max(np.abs(Ad.unshard_vector(x) - xstar)) < 1e-8


def test_distributed_dia_general_sparsity(mesh, rng):
    """Non-banded matrices still work (every diagonal materialized locally
    is fine for moderate diagonal counts)."""
    from sigma_tpu.parallel import distribute_matrix_dia

    n = 64
    dense = np.zeros((n, n))
    for o in (-17, -3, 0, 5, 29):
        i = np.arange(max(0, -o), min(n, n - o))
        dense[i, i + o] = rng.standard_normal(i.size)
    Ad = distribute_matrix_dia(CSRMatrix.from_dense(dense), mesh)
    x = rng.standard_normal(n)
    y = Ad.unshard_vector(Ad.matvec(Ad.shard_vector(x)))
    assert np.max(np.abs(y - dense @ x)) < TOL


def test_balance_rows(mesh, rng):
    """Degree-aware row dealing equalizes per-shard work for skewed
    degree distributions (e.g. scale-free graphs)."""
    from sigma_tpu.parallel import balance_rows

    from sigma_tpu.apps import barabasi_albert

    n, D = 256, 8
    g = barabasi_albert(n, 4, rng)
    dense = np.zeros((n, n))
    r, c = g.edges_numpy()
    dense[r, c] = 1.0
    dense += np.eye(n) * 5
    A = CSRMatrix.from_dense(dense)
    p = balance_rows(A, D)
    assert np.array_equal(np.sort(p), np.arange(n))

    def shard_nnz(M):
        rows, _, _ = M.entries()
        nb = -(-n // D)
        return np.bincount(rows // nb, minlength=D)

    before = shard_nnz(A)
    Ab = A.permute_rows(p).permute_cols(p)
    after = shard_nnz(Ab)
    assert after.max() - after.min() <= before.max() - before.min()
    assert after.max() <= after.mean() * 1.3  # balanced within 30%
    # the permuted operator is exactly the symmetric reindexing of A
    # (row/col i of A lands at p[i]), so any solve on it maps back
    # through p; the distributed solve itself is test_distributed_cg's
    # job — repeating it here cost ~12 s of redundant shard_map compile
    P = np.zeros((n, n))
    P[np.arange(n), p] = 1.0
    assert np.max(np.abs(Ab.to_dense() - P.T @ dense @ P)) < TOL


def test_balance_rows_uneven_n(mesh):
    """n not divisible by n_shards must still yield a bijection on [0, n)
    with round-robin shard assignment."""
    from sigma_tpu.parallel import balance_rows

    n, D = 13, 4
    dense = np.eye(n) * 2 + np.diag(np.ones(n - 1), 1)
    A = CSRMatrix.from_dense(dense + dense.T)
    p = balance_rows(A, D)
    assert np.array_equal(np.sort(p), np.arange(n))
    # permutation applies cleanly
    Ab = A.permute_rows(p).permute_cols(p)
    assert Ab.nnz == A.nnz


def test_distributed_block_ildu(mesh, rng):
    """Block-Jacobi ILDU(0): per-shard factorization, collective-free
    application inside shard_map, big iteration cut on banded systems
    (exact per-block solve; only severed inter-shard couplings remain)."""
    from sigma_tpu.parallel import distribute_matrix_dia, distributed_block_ildu

    n = 500
    dense = laplacian_1d(n) + 0.02 * np.eye(n)
    A = CSRMatrix.from_dense(dense)
    Ad = distribute_matrix_dia(A, mesh)
    M = distributed_block_ildu(A, mesh)
    xstar = rng.standard_normal(n)
    b = Ad.shard_vector(dense @ xstar)
    x, info = cg_solve(Ad, b, tol=1e-12, M=M)
    assert np.max(np.abs(Ad.unshard_vector(x) - xstar)) < 1e-8
    _, plain = cg_solve(Ad, b, tol=1e-12)
    assert int(info.iterations) * 5 < int(plain.iterations)


@pytest.mark.slow
def test_distributed_block_ildu_uneven(mesh, rng):
    from sigma_tpu.parallel import distribute_matrix, distributed_block_ildu

    n = 333  # padded final shard exercises identity-on-padding
    dense = laplacian_1d(n) + np.diag(1.0 + np.arange(n) % 3)
    A = CSRMatrix.from_dense(dense)
    Ad = distribute_matrix(A, mesh)
    M = distributed_block_ildu(A, mesh)
    xstar = rng.standard_normal(n)
    b = Ad.shard_vector(dense @ xstar)
    x, info = cg_solve(Ad, b, tol=1e-12, M=M)
    assert np.max(np.abs(Ad.unshard_vector(x) - xstar)) < 1e-8


def test_rectangular_distribute_matvec(mesh, rng):
    """Rectangular distribution (the AMG prolongator shape): rows and
    columns partition over the same axis with independent block sizes;
    matvec / rmatvec / matmat / rmatmat against the dense oracle."""
    n, m = 120, 37
    dense = np.where(rng.random((n, m)) < 0.15, rng.standard_normal((n, m)), 0.0)
    Pd = distribute_matrix(CSRMatrix.from_coo(
        n, m, *np.nonzero(dense), dense[np.nonzero(dense)]), mesh)
    assert Pd.bcols != Pd.block
    xc = Pd.shard_domain_vector(rng.standard_normal(m))
    xf = Pd.shard_vector(rng.standard_normal(n))
    Xc = Pd.shard_domain_vector(rng.standard_normal((m, 3)))
    Xf = Pd.shard_vector(rng.standard_normal((n, 3)))

    # one jit = one compile for all four applies (wall-clock discipline)
    @jax.jit
    def all4(Pd, xc, xf, Xc, Xf):
        return Pd.matvec(xc), Pd.rmatvec(xf), Pd.matmat(Xc), Pd.rmatmat(Xf)

    y, z, Y, Z = all4(Pd, xc, xf, Xc, Xf)
    xc, xf, Xc, Xf = (np.asarray(a) for a in (xc, xf, Xc, Xf))
    assert np.max(np.abs(np.asarray(y)[:n] - dense @ xc[:m])) < TOL
    assert np.max(np.abs(np.asarray(z)[:m] - dense.T @ xf[:n])) < TOL
    assert np.max(np.abs(np.asarray(Y)[:n] - dense @ Xc[:m])) < TOL
    assert np.max(np.abs(np.asarray(Z)[:m] - dense.T @ Xf[:n])) < TOL


@pytest.mark.slow
def test_distributed_amg_matches_single_device(mesh, rng):
    """Distributed CG+AMG must converge in the same iterations as the
    single-device hierarchy (same numerics, different layout) — VERDICT
    round-1 item 3's acceptance test."""
    from sigma_tpu.parallel import distribute_amg
    from sigma_tpu.solvers.amg import smoothed_aggregation_amg
    from conftest import laplacian_2d

    nx = 13
    n = nx * nx
    dense = laplacian_2d(nx) + 0.1 * np.eye(n)
    A = CSRMatrix.from_dense(dense)
    b = rng.standard_normal(n)

    M = smoothed_aggregation_amg(A, coarse_size=16, max_levels=2)
    x_ref, info_ref = cg_solve(A, jnp.asarray(b), tol=1e-12, M=M)

    Ad = distribute_matrix(A, mesh)
    Md = distribute_amg(M, mesh)
    bd = Ad.shard_vector(b)
    x_d, info_d = cg_solve(Ad, bd, tol=1e-12, M=Md)

    assert abs(int(info_d.iterations) - int(info_ref.iterations)) <= 1
    assert bool(info_d.converged)
    err = np.max(np.abs(Ad.unshard_vector(x_d) - np.asarray(x_ref)))
    assert err < 1e-10
    # the solved iterates agreeing to 1e-10 after an identical iteration
    # count IS the V-cycle layout-invariance check (a separate standalone
    # Md.matvec jit would only add a compile to the suite)


def test_distributed_dia_rmatvec(mesh, rng):
    """DistributedDIAMatrix transpose apply vs the dense oracle (reversed
    ring + negated local offsets)."""
    from sigma_tpu.parallel import distribute_matrix_dia

    n = 192
    dense = np.zeros((n, n))
    for o in (0, 1, -1, 24, -24, 60):
        lo, hi = max(0, -o), min(n, n - o)
        idx = np.arange(lo, hi)
        dense[idx, idx + o] = rng.standard_normal(hi - lo)
    Ad = distribute_matrix_dia(CSRMatrix.from_dense(dense), mesh)
    x = rng.standard_normal(n)

    @jax.jit
    def both(Ad, xs):
        return Ad.matvec(xs), Ad.rmatvec(xs)

    y, z = both(Ad, Ad.shard_vector(x))
    assert np.max(np.abs(np.asarray(y)[:n] - dense @ x)) < TOL
    assert np.max(np.abs(np.asarray(z)[:n] - dense.T @ x)) < TOL


@pytest.mark.slow
def test_distributed_amg_vcycle_smoke(mesh, rng):
    """Distributed AMG V-cycle apply is layout-invariant vs the
    single-device hierarchy.  Slow-marked (69 s of shard_map compile on
    the virtual mesh): default-suite coverage of the distributed-AMG
    path is the driver's ``dryrun_multichip`` amg case; the full CG
    iteration-parity test is also in the slow set."""
    from sigma_tpu.parallel import distribute_amg
    from sigma_tpu.solvers.amg import smoothed_aggregation_amg
    from conftest import laplacian_2d

    nx = 8
    n = nx * nx
    dense = laplacian_2d(nx) + 0.1 * np.eye(n)
    A = CSRMatrix.from_dense(dense)
    M = smoothed_aggregation_amg(A, coarse_size=8, max_levels=2)
    Ad = distribute_matrix(A, mesh)
    Md = distribute_amg(M, mesh)
    r = rng.standard_normal(n)
    z1 = np.asarray(M.matvec(jnp.asarray(r)))
    z2 = Ad.unshard_vector(Md.matvec(Ad.shard_vector(r)))
    assert np.max(np.abs(z1 - z2)) < 1e-11


def _structured_pair(mesh):
    from sigma_tpu.parallel import (
        distribute_matrix_dia,
        distribute_structured_amg,
    )
    from sigma_tpu.solvers import structured_pair_amg
    from test_gmg import poisson

    dims = (16, 12, 10)  # axis 0 divides the 8-device mesh evenly
    Asp = poisson(dims)
    n = Asp.shape[0]
    coo = Asp.tocoo()
    A = DIAMatrix.from_coo(n, n, coo.row, coo.col, coo.data, dtype=jnp.float64)
    M = structured_pair_amg(
        A, dims, freeze_axes=(0,), pairs_per_level=2, coarse_size=128
    )
    assert all(0 not in lvl.axes for lvl in M.levels)
    Ad = distribute_matrix_dia(A, mesh)
    Md = distribute_structured_amg(M, mesh)
    return A, M, Ad, Md, n


def test_distributed_structured_gmg_vcycle_matches(mesh, rng):
    """Structured pair-aggregation multigrid over the mesh: axis 0 is
    frozen from pairing (slab-sharded), so every V-cycle transfer is
    shard-local; a distributed V-cycle application must reproduce the
    single-device one to rounding (same numerics, different layout)."""
    A, M, Ad, Md, n = _structured_pair(mesh)
    r = rng.standard_normal(n)
    z_ref = np.asarray(M.matvec(jnp.asarray(r)))
    z_d = Ad.unshard_vector(Md.matvec(Ad.shard_vector(r)))
    assert np.max(np.abs(z_d - z_ref)) / np.max(np.abs(z_ref)) < 1e-12


@pytest.mark.slow
def test_distributed_structured_gmg_cg_iteration_parity(mesh, rng):
    """Full CG + distributed structured multigrid: iteration count and
    iterates match the single-device hierarchy (the end-to-end form of
    the V-cycle equivalence above; two extra SPMD solve compiles)."""
    A, M, Ad, Md, n = _structured_pair(mesh)
    b = rng.standard_normal(n)
    x_ref, info_ref = cg_solve(A, jnp.asarray(b), tol=1e-11, M=M)
    assert bool(info_ref.converged)
    bd = Ad.shard_vector(b)
    x_d, info_d = cg_solve(Ad, bd, tol=1e-11, M=Md)
    assert abs(int(info_d.iterations) - int(info_ref.iterations)) <= 1
    assert bool(info_d.converged)
    err = np.max(np.abs(Ad.unshard_vector(x_d) - np.asarray(x_ref)))
    assert err < 1e-9


def test_distribute_structured_gmg_rejects_paired_shard_axis(mesh):
    """A hierarchy that paired axis 0 cannot be slab-sharded."""
    from sigma_tpu.parallel import distribute_structured_amg
    from sigma_tpu.solvers import structured_pair_amg
    from test_gmg import poisson

    dims = (16, 4, 4)
    Asp = poisson(dims)
    coo = Asp.tocoo()
    A = DIAMatrix.from_coo(
        Asp.shape[0], Asp.shape[0], coo.row, coo.col, coo.data,
        dtype=jnp.float64,
    )
    M = structured_pair_amg(A, dims, coarse_size=32)  # pairs axis 0
    with pytest.raises(ValueError, match="freeze_axes"):
        distribute_structured_amg(M, mesh)


@pytest.mark.slow
def test_distributed_structured_gmg_aliased_offsets(mesh, rng):
    """Cross-coupled (9-point) stencil coarsened to narrow grids produces
    level matrices with MERGED aliased diagonals; distributing them goes
    through A.entries() on the merged values — the path a duplicate-offset
    DIAGraph would silently corrupt.  Distributed V-cycle must equal the
    single-device one."""
    from sigma_tpu.parallel import (
        distribute_matrix_dia,
        distribute_structured_amg,
    )
    from sigma_tpu.solvers import structured_pair_amg
    from test_gmg import poisson9

    dims = (16, 6)
    Asp = poisson9(dims)
    n = Asp.shape[0]
    coo = Asp.tocoo()
    A = DIAMatrix.from_coo(n, n, coo.row, coo.col, coo.data, dtype=jnp.float64)
    M = structured_pair_amg(A, dims, freeze_axes=(0,), coarse_size=16)
    # the hierarchy must actually reach an extent-2 axis (aliasing regime)
    assert min(min(l.dims) for l in M.levels) <= 2
    Ad = distribute_matrix_dia(A, mesh)
    Md = distribute_structured_amg(M, mesh)
    r = rng.standard_normal(n)
    z_ref = np.asarray(M.matvec(jnp.asarray(r)))
    z_d = Ad.unshard_vector(Md.matvec(Ad.shard_vector(r)))
    assert np.max(np.abs(z_d - z_ref)) / np.max(np.abs(z_ref)) < 1e-12


def test_distributed_block_ildu_fill_level(mesh, rng):
    """Block-Jacobi ILU(k): higher per-block fill must not lose to ILDU(0)
    on a 2-D Laplacian (couplings inside a shard get denser factors)."""
    from sigma_tpu.parallel import distribute_matrix_dia, distributed_block_ildu
    from tests.conftest import laplacian_2d

    n = 16 * 16
    dense = laplacian_2d(16)
    A = CSRMatrix.from_dense(dense)
    Ad = distribute_matrix_dia(A, mesh)
    xstar = rng.standard_normal(n)
    b = Ad.shard_vector(dense @ xstar)
    iters = []
    for level in (0, 2):
        M = distributed_block_ildu(A, mesh, level=level)
        x, info = cg_solve(Ad, b, tol=1e-12, M=M)
        assert np.max(np.abs(Ad.unshard_vector(x) - xstar)) < 1e-8
        iters.append(int(info.iterations))
    assert iters[1] <= iters[0], iters


def test_distributed_cgls_rectangular(mesh, rng):
    """CGLS least-squares over the mesh: each iteration is one forward +
    one reversed halo exchange (matvec + rmatvec); minimizer matches the
    dense lstsq oracle."""
    from sigma_tpu.solvers import cgls_solve

    n, m = 96, 40
    dense = np.where(rng.random((n, m)) < 0.2, rng.standard_normal((n, m)), 0.0)
    dense[np.arange(m), np.arange(m)] += 3.0
    Ad = distribute_matrix(CSRMatrix.from_coo(
        n, m, *np.nonzero(dense), dense[np.nonzero(dense)]), mesh)
    b = Ad.shard_vector(rng.standard_normal(n))

    @jax.jit
    def solve(Ad, b):
        return cgls_solve(Ad, b, tol=1e-12, maxiter=300)

    x, info = solve(Ad, b)
    x_ref = np.linalg.lstsq(dense, np.asarray(b)[:n], rcond=None)[0]
    assert bool(info.converged)
    np.testing.assert_allclose(np.asarray(x)[:m], x_ref, atol=1e-8)


def test_distributed_wide_band_matvec(mesh, rng):
    """Wide-band (RCM-banded general sparsity) DistributedDIAMatrix: >24
    ring-0 terms through the windowed XLA path must match the dense
    oracle."""
    from sigma_tpu.parallel import distribute_matrix_dia

    n = 512
    dense = np.zeros((n, n))
    offs = sorted({0} | set(int(v) for v in rng.integers(-40, 40, 35)))
    for o in offs:
        lo, hi = max(0, -o), min(n, n - o)
        dense[np.arange(lo, hi), np.arange(lo, hi) + o] = rng.standard_normal(
            hi - lo
        )
    Ad = distribute_matrix_dia(CSRMatrix.from_dense(dense), mesh)
    assert sum(1 for k, _ in Ad.terms if k == 0) > 24
    x = rng.standard_normal(n)
    y = Ad.unshard_vector(
        jax.jit(lambda Ad, xs: Ad.matvec(xs))(Ad, Ad.shard_vector(x))
    )
    assert np.max(np.abs(y - dense @ x)) < TOL


def test_distributed_dia_bf16_values_refined(mesh, rng):
    """bf16-valued distributed operator (DistributedDIAMatrix.astype):
    the local diagonal streams are 2-byte while iterate vectors stay
    full precision, and refined_solve_fixed around the bf16 operator
    recovers working-precision residuals — the distributed mirror of
    the single-chip bf16 ladder (benchmarks/unstructured.py --bf16)."""
    from sigma_tpu.parallel import distribute_matrix_dia
    from sigma_tpu.solvers import refined_solve_fixed

    n = 400
    dense = laplacian_1d(n) + np.diag(
        1.0 + 0.1 * rng.standard_normal(n)
    )  # SPD, values genuinely round in bf16
    Ad = distribute_matrix_dia(DIAMatrix.from_dense(dense), mesh)
    Ab = Ad.astype(jnp.bfloat16)
    assert Ab.dtype == jnp.bfloat16 and Ab.terms == Ad.terms

    # matvec: bf16 values, full-precision vectors, ~4e-3 relative
    x = rng.standard_normal(n)
    y = Ab.unshard_vector(Ab.matvec(Ab.shard_vector(x)))
    ref = dense @ x
    assert np.max(np.abs(y - ref)) / np.max(np.abs(ref)) < 2e-2
    assert np.max(np.abs(y - ref)) > 1e-8  # the cast really rounded

    # refined solve: f32-grade residual through the bf16 operator
    xstar = rng.standard_normal(n)
    b = Ad.shard_vector(dense @ xstar)
    solve = jax.jit(
        lambda Am, Al, bb: refined_solve_fixed(
            Am, bb, A_lo=Al, sweeps=3, inner_rtol=1e-3, inner_maxiter=800
        )
    )
    xs = Ad.unshard_vector(solve(Ad, Ab, b))
    assert np.max(np.abs(xs - xstar)) < 1e-5
