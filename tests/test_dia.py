"""DIA (diagonal) format tests — the gather-free stencil layout.

No reference analogue (README.md:81-87 lists missing formats); correctness
is pinned the reference way: dense-mirror oracles over random shapes plus
solver integration.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sigma_tpu import CSRMatrix, DIAMatrix, convert_matrix
from sigma_tpu.graph import DIAGraph
from sigma_tpu.solvers import cg_solve

TOL = 1e-13


def random_banded(rng, n, m, offsets):
    d = np.zeros((n, m))
    for o in offsets:
        i = np.arange(max(0, -o), min(n, m - o))
        d[i, i + o] = rng.standard_normal(i.size)
    return d


@pytest.mark.parametrize("shape", [(40, 40), (5, 9), (9, 5), (130, 130), (257, 64)])
def test_dense_mirror_ops(rng, shape):
    n, m = shape
    dA = np.where(rng.random((n, m)) < 0.25, rng.standard_normal((n, m)), 0.0)
    A = DIAMatrix.from_dense(dA)
    assert np.max(np.abs(A.to_dense() - dA)) < TOL
    x = rng.standard_normal(m)
    xt = rng.standard_normal(n)
    assert np.max(np.abs(np.asarray(A.matvec(jnp.asarray(x))) - dA @ x)) < TOL
    assert np.max(np.abs(np.asarray(A.rmatvec(jnp.asarray(xt))) - dA.T @ xt)) < TOL
    X = rng.standard_normal((m, 3))
    Xt = rng.standard_normal((n, 3))
    assert np.max(np.abs(np.asarray(A.matmat(jnp.asarray(X))) - dA @ X)) < TOL
    assert np.max(np.abs(np.asarray(A.rmatmat(jnp.asarray(Xt))) - dA.T @ Xt)) < TOL


def test_graph_semantics(rng):
    """DIA stores whole diagonals: presence = offset membership + range."""
    g = DIAGraph.from_coo(6, 6, [0, 3], [1, 4])  # single offset +1
    assert g.offsets == (1,)
    assert g.nnz == 5  # the full superdiagonal
    assert g.has_edge(2, 3) and not g.has_edge(0, 0)
    rows, cols = g.edges_numpy()
    assert (cols - rows == 1).all()
    assert g.stride == 128


def test_stride_layout(rng):
    """Values are stored in the kernel-native (n_diags, stride/128, 128)
    tile layout (stride = ceil(n/128)*128) with flat positions
    d*stride + i unchanged; data2d exposes the per-diagonal rows."""
    n = 200
    dA = random_banded(rng, n, n, [-1, 0, 2])
    A = DIAMatrix.from_dense(dA)
    assert A.graph.stride == 256
    assert A.data.shape == (3, 2, 128)
    assert A.data2d.shape == (3, 256)
    i, j = 57, 59  # offset +2
    pos = A.graph.edge_positions([i], [j])[0]
    d = A.graph.offsets.index(2)
    assert pos == d * 256 + i
    assert abs(A.get_value(i, j) - dA[i, j]) < TOL


def test_set_add_values(rng):
    n = 50
    dA = random_banded(rng, n, n, [-2, 0, 1])
    A = DIAMatrix.from_dense(dA)
    ii = np.array([3, 10, 20])
    jj = np.array([1, 10, 21])  # on offsets -2, 0, +1
    A2 = A.set_values(ii, jj, [5.0, 6.0, 7.0])
    assert np.allclose(A2.get_values(ii, jj), [5.0, 6.0, 7.0])
    A3 = A2.add_values(ii, jj, [1.0, 1.0, 1.0])
    assert np.allclose(A3.get_values(ii, jj), [6.0, 7.0, 8.0])


def test_fill_in_new_diagonal(rng):
    """Setting an entry off the stored offsets rebuilds with a new diagonal
    (the structural fill-in path)."""
    n = 30
    A = DIAMatrix.from_dense(np.eye(n))
    assert A.graph.offsets == (0,)
    A2 = A.set_values([4], [7], [2.5])
    assert 3 in A2.graph.offsets
    assert abs(A2.get_value(4, 7) - 2.5) < TOL
    assert abs(A2.get_value(9, 9) - 1.0) < TOL


def test_transpose_and_permute(rng):
    n = 64
    dA = random_banded(rng, n, n, [-3, 0, 5])
    A = DIAMatrix.from_dense(dA)
    assert np.max(np.abs(A.transpose_matrix().to_dense() - dA.T)) < TOL
    assert A.graph.transpose().offsets == (-5, 0, 3)


def test_conversion_roundtrip(rng):
    n = 48
    dA = random_banded(rng, n, n, [-1, 0, 1, 8])
    A = CSRMatrix.from_dense(dA)
    D = convert_matrix(A, "dia")
    assert isinstance(D, DIAMatrix)
    assert np.max(np.abs(D.to_dense() - dA)) < TOL
    back = convert_matrix(D, "csr")
    assert np.max(np.abs(back.to_dense() - dA)) < TOL


def test_tridiagonal_cg(rng):
    """solver_test_diffusion_1d in DIA: n=127 tridiagonal Laplacian, CG,
    exact parabola oracle, err < 1e-14 (the reference's tolerance)."""
    n = 127
    h = 1.0 / (n + 1)
    dA = (2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)) / h
    A = DIAMatrix.from_dense(dA)
    xg = np.linspace(h, 1 - h, n)
    b = np.full(n, 2.0 * h)
    u_exact = xg * (1 - xg)
    x, info = cg_solve(A, jnp.asarray(b), tol=1e-16)
    assert np.max(np.abs(np.asarray(x) - u_exact)) < 1e-14


def test_jit_and_grad(rng):
    n = 64
    dA = random_banded(rng, n, n, [-1, 0, 1])
    A = DIAMatrix.from_dense(dA)
    x = jnp.asarray(rng.standard_normal(n))
    y = jax.jit(lambda M, v: M.matvec(v))(A, x)
    assert np.max(np.abs(np.asarray(y) - dA @ np.asarray(x))) < TOL
    # matvec is differentiable through the pytree
    g = jax.grad(lambda d: jnp.sum(A.with_data(d).matvec(x)))(A.data)
    assert g.shape == A.data.shape


def test_diagonal_extraction(rng):
    n = 33
    dA = random_banded(rng, n, n, [-1, 0, 4])
    A = DIAMatrix.from_dense(dA)
    assert np.max(np.abs(np.asarray(A.diagonal()) - np.diag(dA))) < TOL
    B = DIAMatrix.from_dense(np.diag(np.ones(n - 1), 1))  # no main diagonal
    assert np.max(np.abs(np.asarray(B.diagonal()))) == 0.0


def test_banded_conversion(rng):
    """RCM/BFS reorder + DIA-ize: the general-sparsity recipe."""
    from sigma_tpu.matrix.banded import band_occupancy, bandwidth, to_banded_dia

    from sigma_tpu.fem import stiffness_2d, unit_square_mesh

    coords, ele = unit_square_mesh(12)
    A = stiffness_2d(coords, ele)
    D, p = to_banded_dia(A)
    assert bandwidth(D) <= bandwidth(A)
    x = rng.standard_normal(A.shape[0])
    xp = np.empty_like(x)
    xp[p] = x
    y = np.asarray(D.matvec(jnp.asarray(xp)))[np.asarray(p)]
    assert np.max(np.abs(y - np.asarray(A.matvec(jnp.asarray(x))))) < 1e-12
    assert 0 < band_occupancy(A) <= 1


def test_many_diagonal_scan_path(rng):
    """Matrices with > _SCAN_THRESHOLD diagonals take the lax.scan matvec;
    results must match the dense oracle exactly."""
    n = 150
    dA = np.where(rng.random((n, n)) < 0.4, rng.standard_normal((n, n)), 0.0)
    A = DIAMatrix.from_dense(dA)
    assert A.graph.n_diags > A._SCAN_THRESHOLD
    x = rng.standard_normal(n)
    y = np.asarray(A.matvec(jnp.asarray(x)))
    assert np.max(np.abs(y - dA @ x)) < 1e-12
    # jit + rectangular via the same path
    y2 = np.asarray(jax.jit(lambda M, v: M.matvec(v))(A, jnp.asarray(x)))
    assert np.max(np.abs(y2 - dA @ x)) < 1e-12


def test_astype_exact_bf16(rng):
    """The production bf16-data path: exact for stencil-constant
    coefficients (bit-identical round trip), refused for generic values."""
    import jax.numpy as jnp
    from sigma_tpu import DIAMatrix

    n = 300
    dense = (
        np.diag(np.full(n, 7.0))
        + np.diag(np.full(n - 1, -1.0), 1)
        + np.diag(np.full(n - 1, -1.0), -1)
    )
    A = DIAMatrix.from_dense(dense).astype(jnp.float32)
    Ab = A.astype_exact(jnp.bfloat16)
    assert Ab.dtype == jnp.bfloat16
    x = rng.standard_normal(n).astype(np.float32)
    y32 = np.asarray(A.matvec(jnp.asarray(x)))
    yb = np.asarray(Ab.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(yb, y32, rtol=0, atol=0)  # bit-identical

    dense[3, 3] = np.pi  # not representable in bf16
    with pytest.raises(ValueError):
        DIAMatrix.from_dense(dense).astype(jnp.float32).astype_exact(jnp.bfloat16)


def test_symmetric_dia(rng):
    """Symmetric DIA storage (the reference's named-missing symmetric
    optimization): half the diagonals, identical operator action."""
    import jax.numpy as jnp
    from sigma_tpu import DIAMatrix, SymmetricDIAMatrix
    from sigma_tpu.solvers import cg_solve

    n = 300
    dense = np.zeros((n, n))
    for o in (0, 2, 17, 130):
        lo, hi = max(0, -o), min(n, n - o)
        idx = np.arange(lo, hi)
        vals = rng.standard_normal(hi - lo)
        dense[idx, idx + o] = vals
        if o > 0:
            dense[idx + o, idx] = vals
    dense += np.diag(np.abs(dense).sum(1) + 1.0)
    S = SymmetricDIAMatrix.from_dense(dense)
    assert len(S.offsets) == 4 and all(o >= 0 for o in S.offsets)
    x = rng.standard_normal(n)
    np.testing.assert_allclose(
        np.asarray(S.matvec(jnp.asarray(x))), dense @ x, atol=1e-11
    )
    X = rng.standard_normal((n, 3))
    np.testing.assert_allclose(
        np.asarray(S.matmat(jnp.asarray(X))), dense @ X, atol=1e-11
    )
    # round trip + memory halving
    A = DIAMatrix.from_dense(dense)
    S2 = SymmetricDIAMatrix.from_dia(A)
    np.testing.assert_allclose(S2.to_dia().to_dense(), dense, atol=1e-14)
    assert S.data.size < A.data.size
    assert S.nnz == A.graph.nnz
    # solves compose
    b = rng.standard_normal(n)
    xs, info = cg_solve(S, jnp.asarray(b), tol=1e-13)
    np.testing.assert_allclose(
        np.asarray(xs), np.linalg.solve(dense, b), atol=1e-9
    )
    # asymmetric input is refused
    bad = dense.copy()
    bad[0, 2] *= 2.0
    with pytest.raises(ValueError):
        SymmetricDIAMatrix.from_dense(bad)


def test_bench_analytic_dia_matches_coo():
    """bench.laplacian_3d_dia (analytic boundary masks) must agree exactly
    with the COO-built DIA matrix."""
    import sys, os
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import jax.numpy as jnp
    from bench import laplacian_3d_coo, laplacian_3d_dia
    from sigma_tpu import DIAMatrix
    from sigma_tpu.graph.graph import DIAGraph

    nx = 7
    n, r, c, v = laplacian_3d_coo(nx)
    A = DIAMatrix.from_coo(n, n, r, c, v, dtype=jnp.float64)
    n2, offs, data, nnz = laplacian_3d_dia(nx, dtype=np.float64)
    assert n2 == n and offs == A.graph.offsets and nnz == r.size
    np.testing.assert_array_equal(np.asarray(A.data2d), data)
