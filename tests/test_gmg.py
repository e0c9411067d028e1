"""Structured pair-aggregation multigrid (solvers/gmg.py) tests.

Oracle style follows the reference's solver tests (manufactured
solutions, dense/scipy mirrors): the V-cycle is pinned bit-level against
an explicit-prolongator oracle, and CG iteration counts against the
unpreconditioned baseline.  Multilevel intent:
/root/reference/src/solver/README.md.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import scipy.sparse as sp

from sigma_tpu import DIAMatrix
from sigma_tpu.solvers import cg_solve, structured_pair_amg
from sigma_tpu.solvers.gmg import _W


def poisson(dims):
    """2*nd on the diagonal, -1 to each in-grid axis neighbor."""
    nd = len(dims)
    n = int(np.prod(dims))
    idx = np.arange(n)
    rem = idx.copy()
    coords = []
    for e in reversed(dims):
        coords.append(rem % e)
        rem //= e
    coords = coords[::-1]
    strides = [0] * nd
    stride = 1
    for ax in range(nd - 1, -1, -1):
        strides[ax] = stride
        stride *= dims[ax]
    rows = [idx]
    cols = [idx]
    vals = [np.full(n, 2.0 * nd)]
    for ax in range(nd):
        for s in (+1, -1):
            mk = (coords[ax] + s >= 0) & (coords[ax] + s < dims[ax])
            rows.append(idx[mk])
            cols.append(idx[mk] + s * strides[ax])
            vals.append(np.full(mk.sum(), -1.0))
    return sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n),
    )


def oracle_cycle(Asp, dims, r, omega=2.0 / 3.0, nsm=1, coarse_size=64):
    """Reference V-cycle with the prolongator built EXPLICITLY as a
    sparse matrix (same pairing rule: largest axis, weights 1/sqrt(2))."""
    n = Asp.shape[0]
    if n <= coarse_size or max(dims) < 2:
        return np.linalg.solve(Asp.toarray() + 1e-12 * np.eye(n), r)
    ax = int(np.argmax(dims))
    cc = (dims[ax] + 1) // 2
    idx = np.arange(n)
    rem = idx.copy()
    coords = []
    for e in reversed(dims):
        coords.append(rem % e)
        rem //= e
    coords = coords[::-1]
    cdims = tuple(cc if i == ax else e for i, e in enumerate(dims))
    agg = 0
    for i, e in enumerate(cdims):
        ci = coords[i] // 2 if i == ax else coords[i]
        agg = agg * e + ci
    P = sp.csr_matrix(
        (np.full(n, _W), (idx, agg)), shape=(n, int(np.prod(cdims)))
    )
    dinv = 1.0 / Asp.diagonal()
    x = np.zeros_like(r)
    for _ in range(nsm):
        x += omega * dinv * (r - Asp @ x)
    rc = P.T @ (r - Asp @ x)
    Ac = (P.T @ Asp @ P).tocsr()
    x += P @ oracle_cycle(Ac, cdims, rc, omega, nsm, coarse_size)
    for _ in range(nsm):
        x += omega * dinv * (r - Asp @ x)
    return x


@pytest.mark.parametrize(
    "dims", [(12, 12, 12), (8, 12, 10), (7, 9, 5), (64,), (24, 18)]
)
def test_vcycle_matches_explicit_prolongator(dims):
    """The reshape/repeat transfer path and the closed-form Galerkin
    coarsening must equal the explicitly materialized P^T A P cycle to
    rounding."""
    Asp = poisson(dims)
    n = Asp.shape[0]
    coo = Asp.tocoo()
    A = DIAMatrix.from_coo(n, n, coo.row, coo.col, coo.data, dtype=jnp.float64)
    cs = min(64, max(8, n // 8))
    M = structured_pair_amg(A, dims, coarse_size=cs)
    rng = np.random.default_rng(3)
    r = rng.standard_normal(n)
    z = np.asarray(M.matvec(jnp.asarray(r)))
    zo = oracle_cycle(Asp, dims, r, coarse_size=cs)
    assert np.max(np.abs(z - zo)) / np.max(np.abs(zo)) < 1e-12


def test_preconditioned_cg_iteration_cut():
    """3-D Dirichlet Poisson 16^3: structured pair-aggregation AMG must
    cut CG iterations at least 3x (measured 84 -> 21)."""
    dims = (16, 16, 16)
    Asp = poisson(dims)
    n = Asp.shape[0]
    coo = Asp.tocoo()
    A = DIAMatrix.from_coo(n, n, coo.row, coo.col, coo.data, dtype=jnp.float64)
    M = structured_pair_amg(A, dims)
    b = jnp.asarray(np.random.default_rng(5).standard_normal(n))
    x0, i0 = cg_solve(A, b, tol=1e-10, maxiter=2000)
    x1, i1 = cg_solve(A, b, tol=1e-10, M=M, maxiter=2000)
    assert bool(i1.converged)
    assert int(i1.iterations) * 3 <= int(i0.iterations)
    # solutions agree
    assert (
        np.max(np.abs(np.asarray(x0) - np.asarray(x1)))
        / np.max(np.abs(np.asarray(x0)))
        < 1e-7
    )


def test_fmg_initial_guess_cuts_iterations():
    """Full-multigrid nested iteration (M.fmg): the guess alone lands a
    residual ~1 digit below ||b|| (measured 0.13 on this problem), and
    CG started from it needs strictly fewer iterations than the zero
    start at the same tolerance, converging to the same solution."""
    dims = (16, 16, 16)
    Asp = poisson(dims)
    n = Asp.shape[0]
    coo = Asp.tocoo()
    A = DIAMatrix.from_coo(n, n, coo.row, coo.col, coo.data, dtype=jnp.float64)
    M = structured_pair_amg(A, dims)
    b = jnp.asarray(np.random.default_rng(7).standard_normal(n))
    xf = M.fmg(b)
    rel0 = float(jnp.linalg.norm(b - A.matvec(xf)) / jnp.linalg.norm(b))
    assert rel0 < 0.3  # the guess is already ~1 digit in
    x1, i1 = cg_solve(A, b, tol=1e-10, M=M, maxiter=2000)
    x2, i2 = cg_solve(A, b, xf, tol=1e-10, M=M, maxiter=2000)
    assert bool(i2.converged)
    assert int(i2.iterations) < int(i1.iterations)
    assert (
        np.max(np.abs(np.asarray(x2) - np.asarray(x1)))
        / np.max(np.abs(np.asarray(x1)))
        < 1e-7
    )


def test_solve_under_jit():
    """The whole preconditioned solve must trace and jit (the production
    calling convention — eager dispatch pays a launch per op)."""
    import jax

    dims = (8, 8, 8)
    Asp = poisson(dims)
    n = Asp.shape[0]
    coo = Asp.tocoo()
    A = DIAMatrix.from_coo(n, n, coo.row, coo.col, coo.data, dtype=jnp.float64)
    M = structured_pair_amg(A, dims, coarse_size=16)

    @jax.jit
    def solve(A, M, b):
        return cg_solve(A, b, tol=1e-10, M=M, maxiter=500)

    b = jnp.asarray(np.random.default_rng(7).standard_normal(n))
    x, info = solve(A, M, b)
    assert bool(info.converged)
    r = np.asarray(b) - Asp @ np.asarray(x)
    assert np.linalg.norm(r) < 1e-8


def test_rejects_non_stencil():
    """A flat-diagonal matrix whose diagonals wrap across grid lines with
    nonzero values is not a stencil for those dims."""
    n = 64
    dims = (8, 8)
    # offset +1 with NO boundary zeroing: wraps (i, 7) -> (i+1, 0)
    data = np.zeros((2, n))
    data[0, :] = 2.0
    data[1, : n - 1] = -1.0  # flat-valid everywhere, wraps at ic=7
    i = np.arange(n)
    rows = np.concatenate([i, i[:-1]])
    cols = np.concatenate([i, i[:-1] + 1])
    vals = np.concatenate([data[0], data[1, : n - 1]])
    A = DIAMatrix.from_coo(n, n, rows, cols, vals, dtype=jnp.float64)
    with pytest.raises(ValueError, match="stencil"):
        structured_pair_amg(A, dims)


def test_out_of_reach_offset_rejected():
    """An offset larger than any axis-decomposable stencil reach raises."""
    n = 16
    i = np.arange(n)
    rows = np.concatenate([i, i[: n - 9]])
    cols = np.concatenate([i, i[: n - 9] + 9])
    vals = np.concatenate([np.full(n, 2.0), np.full(n - 9, 1.0)])
    A = DIAMatrix.from_coo(n, n, rows, cols, vals, dtype=jnp.float64)
    with pytest.raises(ValueError):
        structured_pair_amg(A, (4, 4))


def test_bf16_level_storage():
    """level_dtype=bfloat16 halves level storage without changing the
    iteration count here (Poisson Galerkin values are dyadic, hence
    bf16-exact; generally a preconditioner tolerates low-precision
    operator values)."""
    dims = (12, 12, 12)
    Asp = poisson(dims)
    n = Asp.shape[0]
    coo = Asp.tocoo()
    A = DIAMatrix.from_coo(n, n, coo.row, coo.col, coo.data, dtype=jnp.float32)
    b = jnp.asarray(
        np.random.default_rng(9).standard_normal(n).astype(np.float32)
    )
    M32 = structured_pair_amg(A, dims, pairs_per_level=3)
    Mbf = structured_pair_amg(
        A, dims, pairs_per_level=3, level_dtype=jnp.bfloat16
    )
    assert Mbf.levels[0].A.dtype == jnp.bfloat16
    assert Mbf.levels[0].dinv.dtype == jnp.float32  # working precision
    x32, i32 = cg_solve(A, b, tol=0.0, rtol=1e-5, M=M32, maxiter=500)
    xbf, ibf = cg_solve(A, b, tol=0.0, rtol=1e-5, M=Mbf, maxiter=500)
    assert bool(ibf.converged)
    assert abs(int(ibf.iterations) - int(i32.iterations)) <= 2
    r = np.linalg.norm(np.asarray(b) - Asp @ np.asarray(xbf))
    assert r / np.linalg.norm(np.asarray(b)) < 2e-5


def poisson9(dims):
    """2-D 9-point (bilinear-FEM-like) Laplacian: 8 center, -1 to all 8
    in-grid neighbors including diagonals — cross-axis couplings whose
    displacements can ALIAS to one flat DIA offset on coarse grids."""
    a, b = dims
    n = a * b
    idx = np.arange(n)
    ia, ib = idx // b, idx % b
    rows = [idx]
    cols = [idx]
    vals = [np.full(n, 8.0)]
    for da in (-1, 0, 1):
        for db in (-1, 0, 1):
            if da == 0 and db == 0:
                continue
            mk = (
                (ia + da >= 0) & (ia + da < a)
                & (ib + db >= 0) & (ib + db < b)
            )
            rows.append(idx[mk])
            cols.append(idx[mk] + da * b + db)
            vals.append(np.full(mk.sum(), -1.0))
    return sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n),
    )


def test_cross_coupled_stencil_aliasing():
    """Coarsening a 9-point stencil produces displacement pairs that
    alias to ONE flat diagonal on narrow coarse grids (e.g. (1,-1) and
    (0,1) both flatten to +1 when the fast extent is 2): the level
    freeze must merge them by summation and the coarsest dense operator
    must accumulate, not overwrite.  The explicit-P oracle catches both."""
    dims = (16, 8)
    Asp = poisson9(dims)
    n = Asp.shape[0]
    coo = Asp.tocoo()
    A = DIAMatrix.from_coo(n, n, coo.row, coo.col, coo.data, dtype=jnp.float64)
    M = structured_pair_amg(A, dims, coarse_size=4)
    # hierarchy reaches extent-2 grids, where (1,-1) and (0,1) alias
    assert min(min(l.dims) for l in M.levels) <= 2
    rng = np.random.default_rng(13)
    r = rng.standard_normal(n)
    z = np.asarray(M.matvec(jnp.asarray(r)))
    zo = oracle_cycle(Asp, dims, r, coarse_size=4)
    assert np.max(np.abs(z - zo)) / np.max(np.abs(zo)) < 1e-12
    # flat offsets stay unique on every level (searchsorted consumers)
    for l in M.levels:
        offs = l.A.graph.offsets
        assert len(offs) == len(set(offs))
    # and the preconditioned solve converges
    b = jnp.asarray(rng.standard_normal(n))
    x, info = cg_solve(A, b, tol=1e-10, M=M, maxiter=2000)
    assert bool(info.converged)
    assert np.linalg.norm(np.asarray(b) - Asp @ np.asarray(x)) < 1e-8


def test_extent_two_axis_negative_offset():
    """A grid with an extent-2 axis: the -1 displacement along it ties
    with +1 in minimal-remainder terms; the decomposition must try both
    interpretations instead of spuriously rejecting a valid stencil."""
    dims = (8, 8, 2)
    Asp = poisson(dims)
    n = Asp.shape[0]
    coo = Asp.tocoo()
    A = DIAMatrix.from_coo(n, n, coo.row, coo.col, coo.data, dtype=jnp.float64)
    M = structured_pair_amg(A, dims, coarse_size=16)  # must not raise
    rng = np.random.default_rng(17)
    r = rng.standard_normal(n)
    z = np.asarray(M.matvec(jnp.asarray(r)))
    zo = oracle_cycle(Asp, dims, r, coarse_size=16)
    assert np.max(np.abs(z - zo)) / np.max(np.abs(zo)) < 1e-12


def test_refine_eigenpairs_and_scale_invariant_refinement():
    """Mixed-precision eigenpair refinement: f64 Rayleigh quotients expose
    the true error of rough f32 LOBPCG vectors, and one refined
    inverse-iteration step per vector + f64 Rayleigh-Ritz improves every
    eigenvalue (measured 100-300x at the 10M north star; >=3x here from a
    deliberately rough start).  Also pins refined_solve's residual
    scaling: an unscaled f32 inner CG underflows its inner products once
    outer sweeps contract r below ~1e-12 (0/0 = NaN, the bug this
    guards), so a 1e-10-scaled RHS must converge with identical sweeps."""
    import jax

    from sigma_tpu.eigen import lobpcg, refine_eigenpairs
    from sigma_tpu.solvers import structured_pair_amg
    from sigma_tpu.solvers.refine import refined_solve

    nx = 16
    dims = (nx, nx, nx)
    Asp = poisson(dims)
    n = Asp.shape[0]
    coo = Asp.tocoo()
    A64 = DIAMatrix.from_coo(n, n, coo.row, coo.col, coo.data, dtype=jnp.float64)
    A32 = A64.astype(jnp.float32)
    M = structured_pair_amg(A32, dims, pairs_per_level=3)

    # analytic lowest eigenvalues of the 3-D Dirichlet Laplacian
    q = np.arange(1, nx + 1)
    w = 4.0 * np.sin(np.pi * q / (2.0 * (nx + 1))) ** 2
    c = 6
    exact = np.sort(
        (w[:c, None, None] + w[None, :c, None] + w[None, None, :c]).ravel()
    )[:4]

    res = lobpcg(A32, m=4, M=M, tol=1e-1, maxiter=6)  # deliberately rough
    out = refine_eigenpairs(A64, res.eigenvectors, M_lo=M)
    before = np.abs(out.rayleigh_before - exact) / exact
    after = np.abs(out.eigenvalues - exact) / exact
    assert np.all(np.isfinite(out.eigenvalues))
    assert after[0] < 1e-4  # lambda_1 to 4+ digits from a rough start
    assert np.all(after < before)  # every eigenvalue improves
    # and substantially in aggregate
    assert np.exp(np.mean(np.log(after / before))) < 0.35

    # refined_solve scale invariance (the underflow guard)
    rng_l = np.random.default_rng(3)
    b = jnp.asarray(Asp @ rng_l.standard_normal(n))
    x1, i1 = refined_solve(A64, b, tol=0.0, rtol=1e-12, M_lo=M)
    x2, i2 = refined_solve(A64, b * 1e-10, tol=0.0, rtol=1e-12, M_lo=M)
    assert bool(i1.converged) and bool(i2.converged)
    assert int(i1.iterations) == int(i2.iterations)
    assert (
        np.max(np.abs(np.asarray(x2) * 1e10 - np.asarray(x1)))
        / np.max(np.abs(np.asarray(x1)))
        < 1e-9
    )


def test_symmetric_input_operator():
    """structured_pair_amg accepts SymmetricDIAMatrix directly: the
    Galerkin coarsening sees the mirrored full diagonals, while level 0
    keeps the symmetric operator itself (every fine smoothing sweep runs
    the symmetric apply).  The V-cycle must equal
    the full-storage hierarchy bit-for-bit."""
    from sigma_tpu.matrix.symmetric import SymmetricDIAMatrix

    dims = (12, 10, 8)
    Asp = poisson(dims)
    n = Asp.shape[0]
    coo = Asp.tocoo()
    A = DIAMatrix.from_coo(n, n, coo.row, coo.col, coo.data, dtype=jnp.float64)
    As = SymmetricDIAMatrix.from_dia(A)
    M_full = structured_pair_amg(A, dims, pairs_per_level=2)
    M_sym = structured_pair_amg(As, dims, pairs_per_level=2)
    assert isinstance(M_sym.levels[0].A, SymmetricDIAMatrix)
    r = jnp.asarray(np.random.default_rng(21).standard_normal(n))
    z_full = np.asarray(M_full.matvec(r))
    z_sym = np.asarray(M_sym.matvec(r))
    assert np.max(np.abs(z_full - z_sym)) / np.max(np.abs(z_full)) < 1e-14
    # and solves
    b = jnp.asarray(Asp @ np.random.default_rng(22).standard_normal(n))
    x, info = cg_solve(As, b, tol=1e-10, M=M_sym, maxiter=2000)
    assert bool(info.converged)


def test_structured_amg_factory():
    """The reference's factory idiom (cg()/jacobi()/ldu(), cg_solvers.f90:36):
    structured_amg(dims).setup(A) builds the V-cycle preconditioner."""
    from sigma_tpu.solvers import structured_amg

    dims = (10, 8, 6)
    Asp = poisson(dims)
    n = Asp.shape[0]
    coo = Asp.tocoo()
    A = DIAMatrix.from_coo(n, n, coo.row, coo.col, coo.data, dtype=jnp.float64)
    M = structured_amg(dims, pairs_per_level=3, coarse_size=16).setup(A)
    b = jnp.asarray(np.random.default_rng(31).standard_normal(n))
    x, info = cg_solve(A, b, tol=1e-10, M=M, maxiter=1000)
    assert bool(info.converged)
    assert np.linalg.norm(np.asarray(b) - Asp @ np.asarray(x)) < 1e-8


def test_chebyshev_smoother_cycle():
    """Chebyshev-smoothed V-cycle (degree-n_smooth polynomial in D^-1 A
    over the Gershgorin-bounded interval): symmetric preconditioner,
    converges, and at degree 3 needs no more CG iterations than the
    single-sweep Jacobi cycle."""
    dims = (16, 16, 16)
    Asp = poisson(dims)
    n = Asp.shape[0]
    coo = Asp.tocoo()
    A = DIAMatrix.from_coo(n, n, coo.row, coo.col, coo.data, dtype=jnp.float64)
    b = jnp.asarray(np.random.default_rng(7).standard_normal(n))

    M_j = structured_pair_amg(A, dims, smoother="jacobi", n_smooth=1)
    M_c = structured_pair_amg(A, dims, smoother="chebyshev", n_smooth=3)
    # Gershgorin bound on D^-1 A of a Jacobi-scaled Poisson stencil is 2
    assert all(abs(float(l.lmax) - 2.0) < 1e-12 for l in M_c.levels)

    xj, ij = cg_solve(A, b, tol=1e-10, M=M_j, maxiter=500)
    xc, ic = cg_solve(A, b, tol=1e-10, M=M_c, maxiter=500)
    assert bool(ic.converged)
    assert int(ic.iterations) <= int(ij.iterations)
    assert np.max(np.abs(np.asarray(xc) - np.asarray(xj))) / np.max(
        np.abs(np.asarray(xj))
    ) < 1e-7

    # symmetry of the cycle operator (required for CG): <Mu, v> == <u, Mv>
    rng = np.random.default_rng(11)
    u = jnp.asarray(rng.standard_normal(n))
    v = jnp.asarray(rng.standard_normal(n))
    lhs = float(jnp.vdot(M_c.matvec(u), v))
    rhs = float(jnp.vdot(u, M_c.matvec(v)))
    assert abs(lhs - rhs) < 1e-10 * max(abs(lhs), 1.0)


def test_chebyshev_smoother_distributed_parity():
    """Distributed Chebyshev-smoothed cycle: iteration parity with the
    single-device hierarchy (the smoother is collective-free by design)."""
    import jax
    from sigma_tpu.parallel import (
        distribute_matrix_dia,
        distribute_structured_amg,
        make_mesh,
    )

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    dims = (16, 8, 8)
    Asp = poisson(dims)
    n = Asp.shape[0]
    coo = Asp.tocoo()
    A = DIAMatrix.from_coo(n, n, coo.row, coo.col, coo.data, dtype=jnp.float64)
    M = structured_pair_amg(
        A, dims, smoother="chebyshev", n_smooth=2, freeze_axes=(0,)
    )
    rng = np.random.default_rng(3)
    xstar = rng.standard_normal(n)
    b = np.asarray(A.matvec(jnp.asarray(xstar)))
    _, info1 = cg_solve(A, b, M=M, tol=1e-10, maxiter=300)

    mesh = make_mesh(8)
    Ad = distribute_matrix_dia(A, mesh)
    Md = distribute_structured_amg(M, mesh)
    xd, info2 = cg_solve(Ad, Ad.shard_vector(b), M=Md, tol=1e-10, maxiter=300)
    assert abs(int(info1.iterations) - int(info2.iterations)) <= 1
    assert np.max(np.abs(Ad.unshard_vector(xd) - xstar)) < 1e-8


def test_strength_based_pairing_semicoarsening():
    """pair_by="strength" (semicoarsening) on anisotropic Poisson
    eps*u_xx + u_yy: pairing along the strong axis must beat extent-based
    pairing decisively (measured 106 -> 41 CG iterations at eps=0.01),
    and on an isotropic operator both rules must coincide."""
    nx, eps = 48, 0.01
    n = nx * nx
    idx = np.arange(n)
    iy, ix = idx % nx, idx // nx
    rows, cols, vals = [idx], [idx], [np.full(n, 2 * eps + 2.0)]
    for coord, stride, c in ((iy, 1, 1.0), (ix, nx, eps)):
        for s in (1, -1):
            ok = (coord + s >= 0) & (coord + s < nx)
            rows.append(idx[ok])
            cols.append(idx[ok] + s * stride)
            vals.append(np.full(ok.sum(), -c))
    A = DIAMatrix.from_coo(
        n, n, np.concatenate(rows), np.concatenate(cols),
        np.concatenate(vals), dtype=jnp.float64,
    )
    b = jnp.asarray(np.random.default_rng(4).standard_normal(n))
    iters = {}
    for pair_by in ("extent", "strength"):
        M = structured_pair_amg(A, (nx, nx), pair_by=pair_by)
        x, info = cg_solve(A, b, M=M, tol=1e-10, maxiter=2000)
        assert bool(info.converged)
        iters[pair_by] = int(info.iterations)
    assert iters["strength"] * 2 <= iters["extent"], iters

    # isotropic: strengths tie (within the 5% tolerance) -> same levels,
    # same iteration count as the extent rule
    Asp = poisson((24, 24))
    coo = Asp.tocoo()
    P = DIAMatrix.from_coo(
        Asp.shape[0], Asp.shape[0], coo.row, coo.col, coo.data,
        dtype=jnp.float64,
    )
    bp = jnp.asarray(np.random.default_rng(5).standard_normal(Asp.shape[0]))
    i_by = {
        pb: int(
            cg_solve(
                P, bp, M=structured_pair_amg(P, (24, 24), pair_by=pb),
                tol=1e-10, maxiter=500,
            )[1].iterations
        )
        for pb in ("extent", "strength")
    }
    assert i_by["extent"] == i_by["strength"], i_by


def test_nonsymmetric_stencil_gmg_bicgstab():
    """The closed-form Galerkin coarsening handles nonsymmetric stencils
    (upwinded advection-diffusion): GMG-preconditioned BiCG-stab must cut
    iterations at least 3x vs unpreconditioned (measured 85 -> 15 at
    32^3 with beta=10)."""
    from sigma_tpu.solvers import bicgstab_solve

    nx, bh = 16, 10.0 / 17.0
    n = nx ** 3
    idx = np.arange(n)
    iz, iy, ix = idx % nx, (idx // nx) % nx, idx // (nx * nx)
    rows, cols, vals = [idx], [idx], [np.full(n, 6.0 + 3 * bh)]
    for coord, stride in ((iz, 1), (iy, nx), (ix, nx * nx)):
        for s, c in ((1, 1.0), (-1, 1.0 + bh)):  # upwind carries the flux
            ok = (coord + s >= 0) & (coord + s < nx)
            rows.append(idx[ok])
            cols.append(idx[ok] + s * stride)
            vals.append(np.full(ok.sum(), -c))
    A = DIAMatrix.from_coo(
        n, n, np.concatenate(rows), np.concatenate(cols),
        np.concatenate(vals), dtype=jnp.float64,
    )
    xstar = np.random.default_rng(6).standard_normal(n)
    b = np.asarray(A.matvec(jnp.asarray(xstar)))
    _, i0 = bicgstab_solve(A, b, tol=1e-9, maxiter=1000)
    M = structured_pair_amg(A, (nx, nx, nx))
    x, i1 = bicgstab_solve(A, b, M=M, tol=1e-9, maxiter=1000)
    assert bool(i1.converged)
    assert int(i1.iterations) * 3 <= int(i0.iterations)
    assert np.abs(np.asarray(x) - xstar).max() < 1e-7


def test_banded_1d_gmg_for_unstructured(rng):
    """The unstructured multilevel recipe: RCM-band an irregular matrix,
    then structured_pair_amg over the 1-D index order — closed-form pair
    Galerkin keeps every level banded DIA (gather-free).  Must cut
    CG iterations substantially on an ill-conditioned mesh Laplacian."""
    from sigma_tpu import CSRMatrix
    from sigma_tpu.apps.generators import irregular_mesh_laplacian
    from sigma_tpu.matrix.banded import to_banded_dia

    A = irregular_mesh_laplacian(
        80, 24, rng=np.random.default_rng(3), dtype=jnp.float64, shift=0.01
    )
    n = A.shape[0]
    rr, cc, vv = A.entries()
    sh = np.random.default_rng(4).permutation(n)
    A = CSRMatrix.from_coo(n, n, sh[rr], sh[cc], vv, dtype=jnp.float64)
    D, p = to_banded_dia(A)

    M = structured_pair_amg(D, (n,), coarse_size=128)
    assert len(M.levels) >= 3
    b = rng.standard_normal(n)
    x0, i0 = cg_solve(D, jnp.asarray(b), tol=0.0, rtol=1e-8, maxiter=2000)
    x1, i1 = cg_solve(
        D, jnp.asarray(b), tol=0.0, rtol=1e-8, maxiter=2000, M=M
    )
    assert bool(i1.converged)
    r1 = np.linalg.norm(np.asarray(D.matvec(x1)) - b) / np.linalg.norm(b)
    assert r1 < 1e-7
    # a substantial iteration cut (measured ~4-5x at small sizes)
    assert int(i1.iterations) < int(i0.iterations) / 2


def test_bf16_ladder_floor_vs_exact(rng):
    # the measured bf16 routing rule (refine.py docstring): the
    # bf16-operator ladder reaches working-grade residuals when the cast
    # is EXACT, but stalls at a value-rounding floor on inexact values
    import jax.numpy as jnp

    from sigma_tpu.matrix.formats import DIAMatrix
    from sigma_tpu.solvers.refine import refined_solve_fixed

    n = 1536
    i = np.arange(n)
    # exact-bf16 stencil: integer coefficients
    dense_e = np.zeros((n, n))
    dense_e[i, i] = 4.0
    dense_e[i[:-1], i[:-1] + 1] = -1.0
    dense_e[i[:-1] + 1, i[:-1]] = -1.0
    # inexact: random weights (bf16 rounds at ~4e-3)
    dense_i = np.zeros((n, n))
    w = 0.5 + rng.random(n - 1)
    dense_i[i[:-1], i[:-1] + 1] = -w
    dense_i[i[:-1] + 1, i[:-1]] = -w
    dense_i[i, i] = np.abs(dense_i).sum(1) + 0.01  # ill-conditioned-ish

    for dense, exact in ((dense_e, True), (dense_i, False)):
        rows, cols = np.nonzero(dense)
        A = DIAMatrix.from_coo(n, n, rows, cols, dense[rows, cols],
                               dtype=np.float32)
        A_lo = (A.astype_exact(jnp.bfloat16) if exact
                else A.astype(jnp.bfloat16))
        xstar = rng.standard_normal(n)
        b = jnp.asarray((dense @ xstar).astype(np.float32))
        x = refined_solve_fixed(A, b, A_lo=A_lo, sweeps=4,
                                inner_rtol=1e-3, inner_maxiter=4000)
        rres = float(jnp.linalg.norm(b - A.matvec(x))) / float(
            jnp.linalg.norm(b)
        )
        if exact:
            assert rres < 5e-6, rres  # f32-grade through bf16 values
        else:
            assert rres > 1e-6, rres  # the floor: NOT f32-grade
