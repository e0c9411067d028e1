"""Grouped-BSR layout tests: the grouped XLA apply against a dense oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

from sigma_tpu import BSRMatrix


def _random_block_matrix(rng, n, m, bh, bw, p=0.04):
    dense = np.where(rng.random((n, m)) < p, rng.standard_normal((n, m)), 0.0)
    A = BSRMatrix.from_coo(
        n, m, *np.nonzero(dense), dense[np.nonzero(dense)],
        block_shape=(bh, bw),
    )
    return dense, A


@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("shape,blk", [((500, 460), (8, 16)), ((260, 260), (4, 4))])
def test_grouped_matches_dense(rng, shape, blk, group):
    n, m = shape
    dense, A = _random_block_matrix(rng, n, m, *blk)
    G = A.grouped(group=group)
    x = rng.standard_normal(m)
    y = np.asarray(G.matvec(jnp.asarray(x)))
    assert np.abs(y - dense @ x).max() < 1e-12
    X = rng.standard_normal((m, 5))
    Y = np.asarray(G.matmat(jnp.asarray(X)))
    assert np.abs(Y - dense @ X).max() < 1e-12


def test_grouped_empty_and_multi_group_rows(rng):
    """f32 grouped apply with empty block rows and multi-group rows."""
    n, m = 384, 384
    dense = np.zeros((n, m))
    # dense band rows + some empty block rows
    dense[:64] = np.where(rng.random((64, m)) < 0.3, rng.standard_normal((64, m)), 0.0)
    dense[128:160, :32] = rng.standard_normal((32, 32))
    A = BSRMatrix.from_coo(
        n, m, *np.nonzero(dense), dense[np.nonzero(dense)], block_shape=(8, 16)
    )
    G = A.grouped(group=4)
    assert int((np.asarray(G.grow)[1:] == np.asarray(G.grow)[:-1]).sum()) > 0
    x = rng.standard_normal(m).astype(np.float32)
    y = G.matvec(jnp.asarray(x))
    ref = dense @ x
    scale = max(np.abs(ref).max(), 1.0)
    assert y.shape == (n,)
    assert np.abs(np.asarray(y) - ref).max() / scale < 1e-5


@pytest.mark.slow
def test_grouped_in_cg(rng):
    """GroupedBSR is a LinearOperator: usable directly in CG."""
    from sigma_tpu.solvers import cg_solve

    n = 128
    dense = np.where(rng.random((n, n)) < 0.05, rng.standard_normal((n, n)), 0.0)
    dense = dense + dense.T + np.diag(np.abs(dense).sum(1) + 1.0)
    A = BSRMatrix.from_dense(dense, block_shape=(8, 8))
    G = A.grouped(group=2)
    b = rng.standard_normal(n)
    x, info = cg_solve(G, jnp.asarray(b), tol=1e-12)
    assert np.abs(np.asarray(x) - np.linalg.solve(dense, b)).max() < 1e-9
