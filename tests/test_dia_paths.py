"""DIA and symmetric-DIA apply paths against per-diagonal oracles.

Every DIA product is an XLA program: the unrolled window loop for narrow
bands and a ``lax.scan`` over diagonals above ``_SCAN_THRESHOLD``.  These
grids cover both at sizes of a few hundred thousand rows (many 128-row
tiles), rectangular shapes both ways, unaligned n, several right-hand
sides, and the interleaved-panel layout helpers.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from sigma_tpu import DIAMatrix
from sigma_tpu.graph.graph import DIAGraph
from sigma_tpu.matrix.panels import (
    deinterleave_panels,
    deinterleave_panels_grouped,
    interleave_panels,
    interleave_panels_grouped,
)
from sigma_tpu.matrix.symmetric import SymmetricDIAMatrix


def _dia(rng, n, m, diags, dtype=np.float32):
    """(A, data2d) with random values on every in-range slot."""
    g = DIAGraph(offsets=tuple(diags), shape=(n, m), nnz=0)
    data = np.zeros((len(diags), g.stride), dtype)
    for d, o in enumerate(diags):
        lo, hi = max(0, -o), min(n, m - o)
        data[d, lo:hi] = rng.standard_normal(hi - lo)
    A = DIAMatrix(graph=g, data=jnp.asarray(data.reshape(len(diags), -1, 128)))
    return A, data


def _oracle(data, diags, X, n, m):
    """y = A @ X from the diagonal values, in float64."""
    X = np.asarray(X, np.float64)
    Y = np.zeros((n,) + X.shape[1:])
    for d, o in enumerate(diags):
        lo, hi = max(0, -o), min(n, m - o)
        w = data[d, lo:hi].astype(np.float64)
        Y[lo:hi] += w.reshape((-1,) + (1,) * (X.ndim - 1)) * X[lo + o : hi + o]
    return Y


def _sym(rng, n, offsets, dtype=np.float32):
    """(A, dense) for a SymmetricDIAMatrix with random upper diagonals."""
    stride = -(-n // 128) * 128
    data = np.zeros((len(offsets), stride), dtype)
    dense = np.zeros((n, n))
    for d, o in enumerate(offsets):
        data[d, : n - o] = rng.standard_normal(n - o)
        i = np.arange(n - o)
        dense[i, i + o] = data[d, : n - o]
        if o > 0:
            dense[i + o, i] = data[d, : n - o]
    A = SymmetricDIAMatrix(
        data=jnp.asarray(data.reshape(len(offsets), -1, 128)),
        offsets=tuple(offsets), n=n,
    )
    return A, dense


def _rel(a, b):
    return np.max(np.abs(np.asarray(a) - b)) / max(np.max(np.abs(b)), 1e-30)


def _run(dA, n):
    A = DIAMatrix.from_dense(dA.astype(np.float32))
    x = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    y = A.matvec(jnp.asarray(x))
    ref = dA @ x
    return np.max(np.abs(np.asarray(y) - ref)) / max(1.0, np.max(np.abs(ref)))


def test_tridiagonal():
    n = 300
    dA = (
        np.diag(np.full(n, 3.0))
        + np.diag(np.full(n - 1, -1.0), 1)
        + np.diag(np.full(n - 1, -1.0), -1)
    )
    assert _run(dA, n) < 1e-6


def test_wide_offsets():
    n = 700
    rng = np.random.default_rng(1)
    dA = np.diag(rng.standard_normal(n))
    for o in (1, -1, 130, -130, 257, -399):
        dA += np.diag(rng.standard_normal(n - abs(o)), o)
    assert _run(dA, n) < 1e-6


def test_unaligned_n():
    n = 333  # not a multiple of 128
    rng = np.random.default_rng(2)
    dA = np.diag(rng.standard_normal(n)) + np.diag(rng.standard_normal(n - 5), 5)
    assert _run(dA, n) < 1e-6


@pytest.mark.parametrize(
    "n,diags",
    [
        (200_000, [0, 1, -1, 300, -300, 2500, -2500]),
        (133_337, [0, 5, -7, 999]),  # unaligned n, odd offsets
        (70_000, [0]),  # single diagonal
    ],
)
def test_dia_matvec_grid(n, diags):
    rng = np.random.default_rng(7)
    A, data = _dia(rng, n, n, diags)
    x = rng.standard_normal(n).astype(np.float32)
    y = A.matvec(jnp.asarray(x))
    assert y.shape == (n,) and y.dtype == jnp.float32
    assert _rel(y, _oracle(data, diags, x, n, n)) < 1e-5


@pytest.mark.parametrize(
    "n,m,diags",
    [
        (90_000, 70_123, [0, 4, -300, 2000]),  # tall: x frame shorter
        (70_123, 90_000, [0, -4, 300, 2000]),  # wide: x beyond last row
    ],
)
def test_dia_rectangular_grid(n, m, diags):
    """Rectangular DIA (AMG transfer shapes): matvec and rmatvec."""
    rng = np.random.default_rng(9)
    A, data = _dia(rng, n, m, diags)
    x = rng.standard_normal(m).astype(np.float32)
    assert _rel(A.matvec(jnp.asarray(x)), _oracle(data, diags, x, n, m)) < 1e-5
    z = rng.standard_normal(n).astype(np.float32)
    dense_t = np.zeros(m)
    for d, o in enumerate(diags):
        lo, hi = max(0, -o), min(n, m - o)
        dense_t[lo + o : hi + o] += data[d, lo:hi] * z[lo:hi]
    yt = A.rmatvec(jnp.asarray(z))
    assert yt.shape == (m,)
    assert _rel(yt, dense_t) < 1e-5


@pytest.mark.parametrize(
    "n,diags,k",
    [
        (150_000, [0, 1, -1, 300, -300], 4),
        (93_333, [0, 5, -7, 999], 3),
        (60_000, [0, 1, -1, 300, -300], 40),  # wide RHS block
        (49_999, [0, 5, -7, 999], 20),
        (50_001, [0, -2, 131], 17),
    ],
)
def test_dia_spmm_grid(n, diags, k):
    """matmat and the RHS-major entry against the oracle."""
    rng = np.random.default_rng(11)
    A, data = _dia(rng, n, n, diags)
    X = rng.standard_normal((n, k)).astype(np.float32)
    ref = _oracle(data, diags, X, n, n)
    assert _rel(A.matmat(jnp.asarray(X)), ref) < 1e-5
    YT = A.matmat_rhs_major(jnp.asarray(X.T))
    assert YT.shape == (k, n)
    assert _rel(YT, ref.T) < 1e-5


@pytest.mark.parametrize("k", [1, 3, 4])
def test_dia_wide_band_scan_grid(k):
    """Above _SCAN_THRESHOLD diagonals every apply takes the scan form."""
    rng = np.random.default_rng(13)
    n = 20_000
    diags = sorted({0} | set(int(v) for v in rng.integers(-2000, 2000, 60)))
    assert len(diags) > DIAMatrix._SCAN_THRESHOLD
    A, data = _dia(rng, n, n, diags)
    X = rng.standard_normal((n, k)).astype(np.float32)
    ref = _oracle(data, diags, X, n, n)
    assert _rel(A.matvec(jnp.asarray(X[:, 0])), ref[:, 0]) < 1e-5
    assert _rel(A.matmat(jnp.asarray(X)), ref) < 1e-5
    refT = _oracle(
        np.stack([np.roll(data[d], o) for d, o in enumerate(diags)]),
        [-o for o in diags], X, n, n,
    )
    assert _rel(A.rmatmat(jnp.asarray(X)), refT) < 1e-5


@pytest.mark.parametrize(
    "n,offsets",
    [
        (4000, (0, 1, 128, 300)),
        (4096, (0, 5)),  # n a whole number of 128-row tiles
        (5000, (1, 130, 259)),  # no main diagonal
        (3000, (0,)),  # diagonal only
        (9000, (0, 2, 127, 129, 383)),
    ],
)
def test_sym_matvec_grid(n, offsets):
    rng = np.random.default_rng(17)
    A, dense = _sym(rng, n, offsets)
    x = rng.standard_normal(n).astype(np.float32)
    assert _rel(A.matvec(jnp.asarray(x)), dense @ x) < 1e-5
    assert _rel(A.rmatvec(jnp.asarray(x)), dense @ x) < 1e-5


@pytest.mark.parametrize(
    "n,offsets,k",
    [
        (3000, (0, 1, 128, 300), 3),
        (4096, (0, 5), 4),
        (5000, (1, 130, 259), 2),  # no main diagonal
    ],
)
def test_sym_spmm_grid(n, offsets, k):
    rng = np.random.default_rng(19)
    A, dense = _sym(rng, n, offsets)
    XT = rng.standard_normal((k, n)).astype(np.float32)
    ref = dense @ XT.T.astype(np.float64)
    assert _rel(A.matmat_rhs_major(jnp.asarray(XT)).T, ref) < 1e-5
    assert _rel(A.matmat(jnp.asarray(XT.T)), ref) < 1e-5


@pytest.mark.parametrize(
    "n,diags,k",
    [
        (150_000, [0, 1, -1, 300, -300], 4),
        (93_333, [0, 5, -7, 999], 3),
        (120_000, [0, -2, 131], 1),
    ],
)
def test_dia_interleaved_spmm_grid(n, diags, k):
    """matmat_interleaved stays layout-consistent with the oracle."""
    rng = np.random.default_rng(29)
    A, data = _dia(rng, n, n, diags)
    XT = rng.standard_normal((k, n)).astype(np.float32)
    YI = A.matmat_interleaved(interleave_panels(jnp.asarray(XT), n))
    assert YI.shape == (k * (-(-n // 128)), 128)
    Y = deinterleave_panels(YI, k, n)
    assert _rel(Y, _oracle(data, diags, XT.T, n, n).T) < 1e-5


@pytest.mark.parametrize(
    "n,offsets,k",
    [
        (3000, (0, 1, 128, 300), 3),
        (4096, (0, 5), 4),
        (5000, (1, 130, 259), 2),  # no main diagonal
    ],
)
def test_sym_interleaved_spmm_grid(n, offsets, k):
    rng = np.random.default_rng(31)
    A, dense = _sym(rng, n, offsets)
    XT = rng.standard_normal((k, n)).astype(np.float32)
    YI = A.matmat_interleaved(interleave_panels(jnp.asarray(XT), n))
    Y = deinterleave_panels(YI, k, n)
    assert _rel(Y, (dense @ XT.T.astype(np.float64)).T) < 1e-5


def test_interleave_roundtrip():
    """interleave_panels/deinterleave_panels are exact inverses, with
    zero padding past m."""
    rng = np.random.default_rng(23)
    for k, m in ((1, 640), (4, 1000), (3, 127)):
        XT = rng.standard_normal((k, m)).astype(np.float32)
        XI = interleave_panels(jnp.asarray(XT), m)
        Sx = -(-m // 128)
        assert XI.shape == (k * Sx, 128)
        # row s*k + j holds elements s*128.. of panel j
        xi = np.asarray(XI)
        for j in range(k):
            flat = xi[j::k].reshape(-1)
            assert np.array_equal(flat[:m], XT[j])
            assert not flat[m:].any()
        back = np.asarray(deinterleave_panels(XI, k, m))
        assert np.array_equal(back, XT)


def test_matmat_interleaved_cpu_fallback():
    """DIAMatrix.matmat_interleaved goes through matmat and stays
    layout-consistent with interleave_panels(matmat(X).T)."""
    n, k = 700, 3
    rng = np.random.default_rng(37)
    dA = np.diag(rng.standard_normal(n))
    v = rng.standard_normal(n - 1)
    dA += np.diag(v, 1) + np.diag(v, -1)
    A = DIAMatrix.from_dense(dA)
    XT = rng.standard_normal((k, n))
    XI = interleave_panels(jnp.asarray(XT), n)
    YI = A.matmat_interleaved(XI)
    Y = np.asarray(deinterleave_panels(YI, k, n))
    ref = (dA @ XT.T).T
    assert np.max(np.abs(Y - ref)) < 1e-10


def test_symmetric_wide_band_scan_path(rng):
    """SymmetricDIAMatrix at > _SCAN_THRESHOLD upper diagonals takes the
    O(1)-program-size scan path; dense oracle."""
    n = 700
    dense = np.zeros((n, n))
    offs = sorted({0} | set(int(v) for v in rng.integers(1, 90, 40)))
    assert len(offs) > 24
    for o in offs:
        v = rng.standard_normal(n - o)
        dense[np.arange(n - o), np.arange(n - o) + o] = v
        if o:
            dense[np.arange(n - o) + o, np.arange(n - o)] = v
    A = SymmetricDIAMatrix.from_dense(dense)
    x = rng.standard_normal(n)
    y = np.asarray(A.matvec(jnp.asarray(x)))
    assert np.max(np.abs(y - dense @ x)) < 1e-11 * max(
        1.0, np.abs(dense @ x).max()
    )


def test_symmetric_wide_band_matmat_scan(rng):
    """Wide sym band matmat takes the scan path; dense oracle."""
    n, k = 600, 3
    dense = np.zeros((n, n))
    offs = sorted({0} | set(int(v) for v in rng.integers(1, 80, 35)))
    assert len(offs) > 24
    for o in offs:
        v = rng.standard_normal(n - o)
        dense[np.arange(n - o), np.arange(n - o) + o] = v
        if o:
            dense[np.arange(n - o) + o, np.arange(n - o)] = v
    A = SymmetricDIAMatrix.from_dense(dense)
    X = rng.standard_normal((n, k))
    Y = np.asarray(A.matmat(jnp.asarray(X)))
    assert np.max(np.abs(Y - dense @ X)) < 1e-11 * max(
        1.0, np.abs(dense @ X).max()
    )


def test_grouped_interleave_roundtrip():
    """interleave_panels_grouped/deinterleave_panels_grouped are exact
    inverses, with zero padding past m and past k up to KO*kb panels."""
    rng = np.random.default_rng(37)
    for kb, k, m in ((16, 40, 640), (8, 20, 1000), (16, 17, 127)):
        XT = rng.standard_normal((k, m)).astype(np.float32)
        XG = interleave_panels_grouped(jnp.asarray(XT), kb, m)
        Sx = -(-m // 128)
        KO = -(-k // kb)
        assert XG.shape == (KO, kb * Sx, 128)
        xg = np.asarray(XG)
        for j in range(k):
            flat = xg[j // kb, j % kb :: kb].reshape(-1)
            assert np.array_equal(flat[:m], XT[j])
            assert not flat[m:].any()
        # padding panels are zero
        for j in range(k, KO * kb):
            assert not xg[j // kb, j % kb :: kb].any()
        back = np.asarray(deinterleave_panels_grouped(XG, kb, k, m))
        assert np.array_equal(back, XT)
