"""ctypes bindings for the compiled host core (``native/sigma_host.cpp``).

The shared library is built on first use with the system ``g++`` (no build
system, no pip); every entry point has a pure-numpy fallback, so the
package works identically without a compiler — just slower on huge
host-side builds.  Set ``SIGMA_TPU_NO_NATIVE=1`` to force the fallbacks.

Wired call sites: ``bfs_order``/``greedy_coloring`` (graph/permutations),
``triangular_levels`` (solvers/ildu).  ``csr_from_coo`` and
``edge_positions`` are bound and tested but intentionally NOT wired: the
numpy paths (SIMD introsort; vectorized searchsorted/broadcast lookups)
were faster on the hosts tried.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "available",
    "csr_from_coo",
    "bfs_order",
    "greedy_coloring",
    "triangular_levels",
    "edge_positions",
    "ilu0_factorize",
    "pack_levels",
    "greedy_aggregate",
    "vmb_aggregate",
    "spgemm",
    "csr_add",
    "csr_transpose",
    "iluk_symbolic",
    "rcm_order",
    "sloan_order",
    "adjacency_from_coo",
    "pack_pruned",
    "coarsen_pair",
]

_SRC = Path(__file__).resolve().parent.parent.parent / "native" / "sigma_host.cpp"
_LIB_PATH = _SRC.parent / "libsigma_host.so"
_lock = threading.Lock()
# serializes the spgemm fused+fetch two-call protocol (shared C++ buffers)
_SPGEMM_LOCK = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")


def _build() -> bool:
    if not _SRC.exists():
        return False
    if _LIB_PATH.exists() and _LIB_PATH.stat().st_mtime >= _SRC.stat().st_mtime:
        return True
    try:
        subprocess.run(
            [
                "g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                str(_SRC), "-o", str(_LIB_PATH),
            ],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("SIGMA_TPU_NO_NATIVE"):
            return None
        if not _build():
            return None
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
        except OSError:
            return None
        i64 = ctypes.c_longlong
        lib.csr_from_coo.restype = i64
        lib.csr_from_coo.argtypes = [i64, i64, i64, _i64p, _i64p, _i64p, _i64p, _i64p]
        lib.adjacency_from_coo.restype = None
        lib.adjacency_from_coo.argtypes = [i64, i64, _i64p, _i64p, _i64p, _i64p]
        lib.bfs_order.restype = None
        lib.bfs_order.argtypes = [i64, _i64p, _i64p, i64, _i64p]
        lib.greedy_coloring.restype = i64
        lib.greedy_coloring.argtypes = [i64, _i64p, _i64p, _i64p]
        lib.triangular_levels.restype = i64
        lib.triangular_levels.argtypes = [i64, _i64p, _i64p, i64, _i64p]
        lib.edge_positions.restype = None
        lib.edge_positions.argtypes = [i64, _i64p, _i64p, i64, _i64p, _i64p, _i64p]
        lib.ilu0_factorize.restype = i64
        lib.ilu0_factorize.argtypes = [i64, _i64p, _i64p, _f64p, _f64p]
        lib.pack_levels.restype = None
        lib.pack_levels.argtypes = [
            i64, _i64p, _i64p, _f64p, _i64p, i64, i64, i64, _i64p, _i64p, _f64p,
        ]
        lib.greedy_aggregate.restype = i64
        lib.greedy_aggregate.argtypes = [i64, _i64p, _i64p, _i64p]
        lib.vmb_aggregate.restype = i64
        lib.vmb_aggregate.argtypes = [i64, _i64p, _i64p, _i64p]
        f64 = ctypes.c_double
        lib.spgemm_symbolic.restype = i64
        lib.spgemm_symbolic.argtypes = [i64, i64, _i64p, _i64p, _i64p, _i64p, _i64p]
        lib.spgemm_numeric.restype = None
        lib.spgemm_numeric.argtypes = [
            i64, i64, _i64p, _i64p, _f64p, _i64p, _i64p, _f64p, _i64p, _i64p, _f64p,
        ]
        lib.spgemm_fused.restype = i64
        lib.spgemm_fused.argtypes = [
            i64, i64, _i64p, _i64p, _f64p, _i64p, _i64p, _f64p, _i64p,
        ]
        lib.spgemm_fetch.restype = None
        lib.spgemm_fetch.argtypes = [i64, _i64p, _f64p]
        lib.csr_add_symbolic.restype = i64
        lib.csr_add_symbolic.argtypes = [i64, _i64p, _i64p, _i64p, _i64p, _i64p]
        lib.csr_add_numeric.restype = None
        lib.csr_add_numeric.argtypes = [
            i64, f64, f64, _i64p, _i64p, _f64p, _i64p, _i64p, _f64p,
            _i64p, _i64p, _f64p,
        ]
        lib.csr_transpose.restype = None
        lib.csr_transpose.argtypes = [i64, i64, _i64p, _i64p, _f64p, _i64p, _i64p, _f64p]
        lib.iluk_symbolic.restype = i64
        lib.iluk_symbolic.argtypes = [i64, _i64p, _i64p, i64, i64, _i64p, _i64p]
        lib.rcm_order.restype = None
        lib.sloan_order.restype = None
        lib.sloan_order.argtypes = [i64, _i64p, _i64p, _i64p]
        lib.rcm_order.argtypes = [i64, _i64p, _i64p, _i64p]
        _f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
        _i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
        lib.pack_pruned_count.restype = i64
        lib.pack_pruned_count.argtypes = [
            i64, _i64p, _i64p, _f64p, i64, i64, i64, i64,
        ]
        lib.pack_pruned_fill.restype = None
        lib.pack_pruned_fill.argtypes = [
            i64, i64, i64, i64, _f32p, _i32p, _i32p, _i32p, _i32p,
        ]
        lib.pack_pruned_active.restype = i64
        lib.pack_pruned_active.argtypes = []
        lib.coarsen_pair_count.restype = i64
        lib.coarsen_pair_count.argtypes = [i64, _i64p, _i64p, _f64p, i64]
        lib.coarsen_pair_fetch.restype = None
        lib.coarsen_pair_fetch.argtypes = [i64, i64, _i64p, _i64p, _f64p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _c64(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.int64))


def csr_from_coo(
    n: int, m: int, rows, cols
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Sorted deduplicated (rows, cols, indptr) or None if native is off."""
    lib = _load()
    if lib is None:
        return None
    rows, cols = _c64(rows), _c64(cols)
    ne = rows.size
    out_r = np.empty(ne, dtype=np.int64)
    out_c = np.empty(ne, dtype=np.int64)
    indptr = np.empty(n + 1, dtype=np.int64)
    w = lib.csr_from_coo(n, m, ne, rows, cols, out_r, out_c, indptr)
    return out_r[:w], out_c[:w], indptr


def sloan_order(indptr, indices) -> Optional[np.ndarray]:
    """Sloan wavefront-minimizing permutation (scatter form), or None if
    native is off.  Wavefront ~ local bandwidth ~ the pruned layout's
    per-row-tile active-diagonal count (the occupancy lever)."""
    lib = _load()
    if lib is None:
        return None
    indptr, indices = _c64(indptr), _c64(indices)
    n = indptr.size - 1
    perm = np.empty(n, dtype=np.int64)
    lib.sloan_order(n, indptr, indices, perm)
    return perm


def adjacency_from_coo(n: int, rows, cols):
    """Row-grouped adjacency (cols, indptr) of DUPLICATE-FREE COO edges
    — counting sort by row only (no dedup, no within-row sort): the
    cheap neighbor-list build for RCM/BFS whose quality is order-
    independent.  Returns None if native is off."""
    lib = _load()
    if lib is None:
        return None
    rows, cols = _c64(rows), _c64(cols)
    ne = rows.size
    out_c = np.empty(ne, dtype=np.int64)
    indptr = np.empty(n + 1, dtype=np.int64)
    lib.adjacency_from_coo(n, ne, rows, cols, out_c, indptr)
    return out_c, indptr


def bfs_order(indptr, indices, start: int = 0) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    indptr, indices = _c64(indptr), _c64(indices)
    n = indptr.size - 1
    perm = np.empty(n, dtype=np.int64)
    lib.bfs_order(n, indptr, indices, int(start), perm)
    return perm


_PACK_LOCK = threading.Lock()  # pack_pruned / coarsen_pair static buffers


def pack_pruned(
    rows, cols, vals, *, tile_rows: int, group: int, reach: int,
    n_tiles: int, E: int,
):
    """Pruned block-DIA packing (ops/spmv_pruned.py setup) in C++: radix
    sort by (tile, offset) + one-pass fill of the packed f32 value
    blocks and prefetch arrays.  Returns
    ``(data, tile, first, rowoff, laneoff, L, n_active)`` or None if
    native is off.  f32 values only (the production dtype)."""
    lib = _load()
    if lib is None:
        return None
    rows, cols = _c64(rows), _c64(cols)
    vals = np.ascontiguousarray(np.asarray(vals, dtype=np.float64))
    ne = rows.size
    with _PACK_LOCK:
        L = int(lib.pack_pruned_count(
            ne, rows, cols, vals, tile_rows, group, reach, n_tiles
        ))
        n_active = int(lib.pack_pruned_active())
        data = np.zeros((L * group, tile_rows), dtype=np.float32)
        tile = np.empty(L, dtype=np.int32)
        first = np.empty(L, dtype=np.int32)
        rowoff = np.full(L * group, E, dtype=np.int32)
        laneoff = np.zeros(L * group, dtype=np.int32)
        lib.pack_pruned_fill(
            ne, tile_rows, group, E, data, tile, first, rowoff, laneoff
        )
    return data, tile, first, rowoff, laneoff, L, n_active


def coarsen_pair(rows, cols, vals, nc: int):
    """1-D pair-aggregation Galerkin coarsening C[r//2, c//2] += v/2 in
    C++ (radix sort + duplicate sum, exact cancellations dropped).
    Returns ``(rows, cols, vals)`` or None if native is off."""
    lib = _load()
    if lib is None:
        return None
    rows, cols = _c64(rows), _c64(cols)
    vals = np.ascontiguousarray(np.asarray(vals, dtype=np.float64))
    with _PACK_LOCK:
        n_out = int(lib.coarsen_pair_count(rows.size, rows, cols, vals, nc))
        out_r = np.empty(n_out, dtype=np.int64)
        out_c = np.empty(n_out, dtype=np.int64)
        out_v = np.empty(n_out, dtype=np.float64)
        lib.coarsen_pair_fetch(n_out, nc, out_r, out_c, out_v)
    return out_r, out_c, out_v


def rcm_order(indptr, indices) -> Optional[np.ndarray]:
    """Reverse Cuthill-McKee permutation (scatter form), or None if native
    is off."""
    lib = _load()
    if lib is None:
        return None
    indptr, indices = _c64(indptr), _c64(indices)
    n = indptr.size - 1
    perm = np.empty(n, dtype=np.int64)
    lib.rcm_order(n, indptr, indices, perm)
    return perm


def greedy_coloring(indptr, indices) -> Optional[Tuple[np.ndarray, int]]:
    lib = _load()
    if lib is None:
        return None
    indptr, indices = _c64(indptr), _c64(indices)
    n = indptr.size - 1
    colors = np.empty(n, dtype=np.int64)
    nc = lib.greedy_coloring(n, indptr, indices, colors)
    return colors, int(nc)


def triangular_levels(
    indptr, indices, reverse: bool = False
) -> Optional[Tuple[np.ndarray, int]]:
    lib = _load()
    if lib is None:
        return None
    indptr, indices = _c64(indptr), _c64(indices)
    n = indptr.size - 1
    lvl = np.empty(n, dtype=np.int64)
    nl = lib.triangular_levels(n, indptr, indices, int(bool(reverse)), lvl)
    return lvl, int(nl)


def edge_positions(qr, qc, indptr, indices) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    qr, qc = _c64(qr), _c64(qc)
    indptr, indices = _c64(indptr), _c64(indices)
    n = indptr.size - 1
    out = np.empty(qr.size, dtype=np.int64)
    lib.edge_positions(qr.size, qr, qc, n, indptr, indices, out)
    return out


def ilu0_factorize(
    indptr, indices, data
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """In-place-style ILU(0): returns (lu, diag) where lu is data factorized
    on the pattern (L strict left of diag, D on diag, U rows right of it —
    see sigma_host.cpp), or None if native is off.  Raises
    ZeroDivisionError on a zero/missing pivot (matching the numpy path)."""
    lib = _load()
    if lib is None:
        return None
    indptr, indices = _c64(indptr), _c64(indices)
    n = indptr.size - 1
    lu = np.ascontiguousarray(np.asarray(data, dtype=np.float64)).copy()
    diag = np.empty(n, dtype=np.float64)
    bad = lib.ilu0_factorize(n, indptr, indices, lu, diag)
    if bad:
        raise ZeroDivisionError(
            f"zero or missing pivot at row {int(bad) - 1} in ILDU(0) "
            "factorization"
        )
    return lu, diag


def pack_levels(
    indptr, indices, data, level, nlev: int, max_rows: int, width: int
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Level-major padded (rows, cols, vals) for batched triangular sweeps,
    or None if native is off.  Sentinel row id is n; pads are zero."""
    lib = _load()
    if lib is None:
        return None
    indptr, indices = _c64(indptr), _c64(indices)
    level = _c64(level)
    data = np.ascontiguousarray(np.asarray(data, dtype=np.float64))
    n = indptr.size - 1
    rows = np.full((nlev, max_rows), n, dtype=np.int64)
    cols = np.zeros((nlev, max_rows, width), dtype=np.int64)
    vals = np.zeros((nlev, max_rows, width), dtype=np.float64)
    lib.pack_levels(
        n, indptr, indices, data, level, nlev, max_rows, width,
        rows.reshape(-1), cols.reshape(-1), vals.reshape(-1),
    )
    return rows, cols, vals


def greedy_aggregate(indptr, indices) -> Optional[Tuple[np.ndarray, int]]:
    """AMG greedy aggregation ids, or None if native is off."""
    lib = _load()
    if lib is None:
        return None
    indptr, indices = _c64(indptr), _c64(indices)
    n = indptr.size - 1
    agg = np.empty(n, dtype=np.int64)
    na = lib.greedy_aggregate(n, indptr, indices, agg)
    return agg, int(na)


def _cf64(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float64))


def spgemm(
    aptr, acol, aval, bptr, bcol, bval, m: int
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """C = A @ B for row-sorted host CSR operands; returns (indptr, cols,
    vals) of C with sorted rows, or None if native is off.  O(nnz(C))
    memory (Gustavson sparse accumulator) — the one-shot product path that
    sidesteps the plan machinery's contribution-map blowup."""
    lib = _load()
    if lib is None:
        return None
    aptr, acol = _c64(aptr), _c64(acol)
    bptr, bcol = _c64(bptr), _c64(bcol)
    aval, bval = _cf64(aval), _cf64(bval)
    n = aptr.size - 1
    cptr = np.empty(n + 1, dtype=np.int64)
    # fused single-pass Gustavson into persistent C++ buffers (warm pages
    # across the AMG setup's repeated products), then one copy-out — half
    # the traversal of the symbolic+numeric pair.  The fused+fetch pair
    # communicates through process-global C++ buffers and ctypes releases
    # the GIL during each call, so the two-call protocol must be serialized
    # across Python threads (else one thread's fetch can read another
    # product's freshly resized buffers).
    with _SPGEMM_LOCK:
        nnz = lib.spgemm_fused(n, m, aptr, acol, aval, bptr, bcol, bval, cptr)
        ccol = np.empty(nnz, dtype=np.int64)
        cval = np.empty(nnz, dtype=np.float64)
        lib.spgemm_fetch(nnz, ccol, cval)
    return cptr, ccol, cval


def csr_add(
    aptr, acol, aval, bptr, bcol, bval, alpha: float = 1.0, beta: float = 1.0
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """C = alpha*A + beta*B on the union sparsity (row-sorted host CSR), or
    None if native is off."""
    lib = _load()
    if lib is None:
        return None
    aptr, acol = _c64(aptr), _c64(acol)
    bptr, bcol = _c64(bptr), _c64(bcol)
    aval, bval = _cf64(aval), _cf64(bval)
    n = aptr.size - 1
    cptr = np.empty(n + 1, dtype=np.int64)
    nnz = lib.csr_add_symbolic(n, aptr, acol, bptr, bcol, cptr)
    ccol = np.empty(nnz, dtype=np.int64)
    cval = np.empty(nnz, dtype=np.float64)
    lib.csr_add_numeric(
        n, float(alpha), float(beta), aptr, acol, aval, bptr, bcol, bval,
        cptr, ccol, cval,
    )
    return cptr, ccol, cval


def csr_transpose(
    aptr, acol, aval, m: int
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """T = A^T of an (n x m) row-sorted host CSR; rows of T come out
    sorted.  Returns (indptr, cols, vals) of T or None if native is off."""
    lib = _load()
    if lib is None:
        return None
    aptr, acol = _c64(aptr), _c64(acol)
    aval = _cf64(aval)
    n = aptr.size - 1
    ne = int(aptr[-1])
    tptr = np.empty(m + 1, dtype=np.int64)
    tcol = np.empty(ne, dtype=np.int64)
    tval = np.empty(ne, dtype=np.float64)
    lib.csr_transpose(n, m, aptr, acol, aval, tptr, tcol, tval)
    return tptr, tcol, tval


def iluk_symbolic(
    indptr, indices, k: int
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Level-of-fill ILU(k) symbolic pattern (L + diag + U, sorted CSR) of a
    row-sorted host CSR matrix; returns (indptr, cols) or None if native is
    off.  The numeric phase is ``ilu0_factorize`` on this pattern."""
    lib = _load()
    if lib is None:
        return None
    indptr, indices = _c64(indptr), _c64(indices)
    n = indptr.size - 1
    cap = max(int(indptr[-1]) * (int(k) + 2), 16)
    for _ in range(2):
        fptr = np.empty(n + 1, dtype=np.int64)
        fcol = np.empty(cap, dtype=np.int64)
        got = lib.iluk_symbolic(n, indptr, indices, int(k), cap, fptr, fcol)
        if got >= 0:
            return fptr, fcol[:got]
        cap = -got
    raise AssertionError("iluk_symbolic capacity retry failed")


def vmb_aggregate(indptr, indices) -> Optional[Tuple[np.ndarray, int]]:
    """VMB three-phase aggregation ids, or None if native is off."""
    lib = _load()
    if lib is None:
        return None
    indptr, indices = _c64(indptr), _c64(indices)
    n = indptr.size - 1
    agg = np.empty(n, dtype=np.int64)
    na = lib.vmb_aggregate(n, indptr, indices, agg)
    return agg, int(na)
