"""chip_smoke.py at tiny sizes, its GPU gate, the compile-cache rule, and
the precision pinned on the Krylov/eigensolver panel products."""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.extend.core
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_phase_s1_tiny():
    out = chip_smoke.phase_s1(nx=12, copy_bytes=1 << 20, reps=1)
    assert out["dia"]["err"] <= chip_smoke.DIA_SPMV_RTOL
    assert out["dia_sym"]["err"] <= chip_smoke.DIA_SPMV_RTOL
    assert out["copy_gbps"] > 0


def test_phase_s2_tiny():
    out = chip_smoke.phase_s2(nx=10, k=3)
    assert out["gmg_iterations"] < out["cg_iterations"] * 3
    assert out["block_cg_iterations"] > 0


def test_phase_u1_tiny():
    out = chip_smoke.phase_u1(H=128, W=16, coarse_size=256, reps=1,
                              copy_gbps=1.0)
    assert set(out) >= {"pruned", "pruned_sym", "banded_dia"}
    assert out["gmg_iterations"] <= out["cg_iterations"]


def test_phase_e1_tiny():
    out = chip_smoke.phase_e1(nx=8, steps=120)
    assert max(out["rel_err"]) <= chip_smoke.EIG_RTOL


def test_phase_dist_tiny():
    out = chip_smoke.phase_dist(4, nx=16, H=128, W=16)
    assert out["devices"] == 4


def test_lowest_distinct_eigenvalues_match_dense():
    nx = 5
    d = np.diag(np.full(nx, 2.0)) - np.eye(nx, k=1) - np.eye(nx, k=-1)
    eye = np.eye(nx)
    L = (np.kron(np.kron(d, eye), eye) + np.kron(np.kron(eye, d), eye)
         + np.kron(np.kron(eye, eye), d))
    lam = np.linalg.eigvalsh(L)
    distinct = lam[np.concatenate([[True], np.diff(lam) > 1e-9])]
    got = chip_smoke.lowest_distinct_eigenvalues(nx, 4)
    assert np.allclose(got, distinct[:4], rtol=1e-12)


def test_csr_from_dia_matches_dense():
    rng = np.random.default_rng(3)
    n, m, offs = 300, 260, (-5, 0, 3, 140)
    data = rng.standard_normal((len(offs), 384))
    dense = np.zeros((n, m))
    for d, o in enumerate(offs):
        for i in range(max(0, -o), min(n, m - o)):
            dense[i, i + o] = data[d, i]
    assert np.array_equal(
        chip_smoke.csr_from_dia(data, offs, n, m).toarray(), dense
    )


def test_main_refuses_cpu(capsys):
    assert chip_smoke.main([]) == 1
    out = capsys.readouterr()
    assert out.out == ""
    assert "no GPU found" in out.err


def test_script_alone_fails(tmp_path):
    """Copied away from the package, the script exits non-zero and prints
    no result line."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run(
        [sys.executable, str(tmp_path / "chip_smoke.py")],
        capture_output=True, text=True, timeout=120, cwd=tmp_path,
    )
    assert r.returncode != 0
    assert r.stdout == ""


def test_compile_cache_env_set(monkeypatch, tmp_path):
    from sigma_tpu.utils.util import configure_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    assert configure_compile_cache(str(tmp_path / "fixed")) == str(
        tmp_path / "env"
    )
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_env_unset(monkeypatch, tmp_path):
    from sigma_tpu.utils.util import configure_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        got = configure_compile_cache(str(tmp_path / "fixed"))
        assert got == str(tmp_path / "fixed")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _dot_precisions(jaxpr):
    """precision params of every dot_general with a non-scalar result,
    searched through every nested jaxpr (loop bodies, conds, pjit)."""
    found = []

    def walk(jp):
        for eqn in jp.eqns:
            if eqn.primitive.name == "dot_general" and eqn.outvars[0].aval.ndim:
                found.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in v if isinstance(v, (tuple, list)) else (v,):
                    if isinstance(sub, jax.extend.core.ClosedJaxpr):
                        walk(sub.jaxpr)
                    elif isinstance(sub, jax.extend.core.Jaxpr):
                        walk(sub)

    walk(jaxpr.jaxpr)
    return found


def _highest(prec):
    hi = jax.lax.Precision.HIGHEST
    return prec is not None and all(p == hi for p in prec)


def _stencil(n):
    from sigma_tpu import DIAMatrix

    d = 2.5 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    return DIAMatrix.from_dense(d.astype(np.float32))


def test_lanczos_panel_products_pinned_highest():
    from sigma_tpu.eigen import eigensolve

    A = _stencil(64)
    jp = jax.make_jaxpr(lambda A: eigensolve(A, 10, key=jax.random.PRNGKey(0)))(A)
    precs = _dot_precisions(jp)
    assert len(precs) >= 3  # reorthogonalization + Ritz vectors
    assert all(_highest(p) for p in precs), precs


@pytest.mark.parametrize("panels", ["cols", "interleaved"])
def test_block_cg_panel_products_pinned_highest(panels):
    from sigma_tpu.solvers import block_cg_solve

    A = _stencil(256)
    B = jnp.ones((256, 3), jnp.float32)
    jp = jax.make_jaxpr(
        lambda A, B: block_cg_solve(A, B, rtol=1e-6, maxiter=20,
                                    panels=panels)
    )(A, B)
    precs = _dot_precisions(jp)
    assert len(precs) >= 4  # Gram matrices + panel combinations
    assert all(_highest(p) for p in precs), precs


def test_gmres_arnoldi_pinned_highest():
    from sigma_tpu.solvers import gmres_solve

    A = _stencil(128)
    b = jnp.ones((128,), jnp.float32)
    jp = jax.make_jaxpr(lambda A, b: gmres_solve(A, b, restart=8, maxiter=16))(A, b)
    precs = _dot_precisions(jp)
    assert precs and all(_highest(p) for p in precs), precs


@pytest.mark.gpu
def test_smoke_phases_on_gpu(gpu):
    """The chip_smoke phases at reduced sizes on the card: every bound
    holds there too (JAX_PLATFORMS=cuda, -m gpu)."""
    chip_smoke.phase_s1(nx=64, copy_bytes=1 << 26)
    chip_smoke.phase_s2(nx=48)
    chip_smoke.phase_u1(H=2048, W=64, coarse_size=1024)
    chip_smoke.phase_e1(nx=32, steps=200)
    assert json.dumps({"device": gpu.device_kind})
