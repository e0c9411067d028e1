"""Profiling / observability helpers.

The reference has none of this (SURVEY §5: no timers anywhere, only solver
iteration counters).  Here: device-synchronized wall timing
(``jax.block_until_ready``), SpMV throughput in nnz/s, and a thin wrapper
over ``jax.profiler`` traces for XLA-level inspection.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = ["time_fn", "spmv_throughput", "trace", "SolverLog"]


def time_fn(f: Callable, *args, reps: int = 3) -> float:
    """Median wall seconds of ``f(*args)`` over ``reps`` calls, each ended
    by ``block_until_ready``, after one untimed call that compiles."""
    jax.block_until_ready(f(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def spmv_throughput(A, iters: int = 20, reps: int = 3) -> float:
    """Measured SpMV throughput of operator A in nonzeros/second: a jitted
    chain of ``iters`` matvecs, timed by :func:`time_fn`."""
    x = jnp.ones((A.shape[1],), dtype=getattr(A, "dtype", jnp.float32))

    @jax.jit
    def chain(A, x):
        def body(i, v):
            return A.matvec(v) * jnp.asarray(0.5, v.dtype)

        return lax.fori_loop(0, iters, body, x)

    return A.nnz * iters / time_fn(chain, A, x, reps=reps)


@contextlib.contextmanager
def trace(logdir: str):
    """``with trace("/tmp/trace"):`` — capture a jax.profiler trace for
    xprof/tensorboard inspection."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class SolverLog:
    """Pretty-printer for SolveInfo residual histories."""

    def __init__(self, info):
        self.info = info

    def residuals(self) -> np.ndarray:
        if self.info.history is None:  # solve ran without history=True
            return np.empty(0)
        h = np.asarray(self.info.history)
        return h[~np.isnan(h)]

    def report(self, name: str = "solve") -> str:
        r = self.residuals()
        lines = [
            f"{name}: {int(self.info.iterations)} iterations, "
            f"final residual {float(self.info.residual_norm):.3e}, "
            f"converged={bool(self.info.converged)}"
        ]
        if r.size:
            drop = r[0] / max(r[-1], 1e-300)
            lines.append(
                f"  residual drop {drop:.2e} over {r.size} recorded steps"
            )
        return "\n".join(lines)
