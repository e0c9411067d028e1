"""Structured pair-aggregation multigrid: a gather-free AMG for stencils.

The reference's solver/preconditioner unification exists "to enable
nested multilevel methods" (/root/reference/src/solver/README.md); this
module is a gather-free multilevel method for them.  The general
smoothed-aggregation AMG (solvers/amg.py) is format-agnostic but its
prolongator is a CSR matrix whose apply is an arbitrary gather, far
slower than the DIA SpMV it sits next to.

This builder exploits what the north-star problems actually are —
stencils on structured grids — to make EVERY hot object in the
hierarchy a dense-diagonal (DIA) operator and every transfer a
reshape:

- **Aggregation** is pairs of adjacent cells along one grid axis per
  level (the largest axis, round-robin for near-cubes) — Notay-style
  pairwise aggregation with the pairs chosen by grid geometry instead
  of by graph matching.
- **P is never materialized.**  With aggregate weights 1/sqrt(2),
  ``P^T r`` is a strided even/odd sum along the pairing axis and
  ``P e`` is a repeat — O(n) vector ops with zero index traffic.
- **The Galerkin product P^T A P has a closed form on DIA**: each fine
  axis-offset (da, db, dc) splits into at most two coarse offsets
  (parity of the pairing-axis component), so the coarse operator is
  assembled by strided adds on the diagonal value grids in O(nnz)
  numpy — no sparse matmul, no symbolic phase.  A 7-point stencil
  stays a 7-point stencil on every level; setup at 10M rows is
  numpy-bandwidth, not SpGEMM.
- Unsmoothed aggregation keeps the stencil exactly banded (a smoothed
  prolongator would widen it); quality is recovered the standard
  pairwise-AMG way — as a preconditioner inside CG.  Measured
  (3-D Dirichlet Poisson, V(1,1) weighted-Jacobi, f64 CPU): CG
  iterations 74 -> 17 at 16^3 and 143 -> 23 at 32^3 vs unpreconditioned.

Works for grids of any dimensionality (``dims`` is a tuple whose
product is n); odd axis extents pair the last cell as a singleton.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sigma_tpu.matrix.formats import DIAMatrix
from sigma_tpu.operators.linear_operator import LinearOperator

__all__ = [
    "StructuredAMGPreconditioner",
    "structured_pair_amg",
    "pruned_pair_amg",
    "structured_amg",
]

_W = 1.0 / math.sqrt(2.0)  # aggregate weight (columns of P unit-norm for pairs)


def _pair_sum(x3, ax: int):
    """Sum adjacent pairs (2i, 2i+1) along axis ``ax`` by a contiguous
    (c/2, 2) reshape and a sum over the new minor axis; an odd extent
    pairs its last cell with a zero."""
    c = x3.shape[ax]
    if c % 2:
        pad = [(0, 0)] * x3.ndim
        pad[ax] = (0, 1)
        x3 = jnp.pad(x3, pad)
    shape = x3.shape[:ax] + ((c + 1) // 2, 2) + x3.shape[ax + 1 :]
    return x3.reshape(shape).sum(ax + 1)


def _pair_repeat(e3, ax: int):
    """Transpose of :func:`_pair_sum` (before any odd-extent trim): each
    entry repeated twice along axis ``ax``."""
    return jnp.repeat(e3, 2, axis=ax)


def _axis_candidates(o, dims):
    """All per-axis displacement tuples that flatten to offset ``o`` with
    minimal-magnitude remainders.  Usually one; a remainder that lands
    exactly on extent/2 of an even axis is a tie (+e/2 vs -e/2), so both
    branches are emitted — the caller picks the one whose value grid is
    box-valid."""
    cands = [([], int(o))]
    for ax in range(len(dims) - 1, -1, -1):
        extent = dims[ax]
        nxt = []
        for disp, rem in cands:
            d = rem % extent
            opts = {d if d <= extent // 2 else d - extent}
            if extent % 2 == 0 and d == extent // 2:
                opts = {d, d - extent}
            for dd in opts:
                nxt.append(([dd] + disp, (rem - dd) // extent))
        cands = nxt
    out = [tuple(disp) for disp, rem in cands if rem == 0]
    if not out:
        raise ValueError(
            f"offset {o} is out of stencil reach for grid dims {dims}"
        )
    return out


def _grid_box_valid(V: np.ndarray, disp, dims) -> bool:
    """True when every stored value whose per-axis target leaves the grid
    box is zero under this displacement interpretation."""
    for ax, d in enumerate(disp):
        if d == 0:
            continue
        sl = [slice(None)] * len(dims)
        sl[ax] = slice(None, -d) if d < 0 else slice(dims[ax] - d, None)
        if np.any(V[tuple(sl)] != 0):
            return False
    return True


def _flat_offset(disp, dims) -> int:
    """Per-axis displacements -> flat DIA offset (row-major strides)."""
    o = 0
    stride = 1
    for ax in range(len(dims) - 1, -1, -1):
        o += disp[ax] * stride
        stride *= dims[ax]
    return o


def _decompose_grids(offsets, data2d, dims) -> Dict[tuple, np.ndarray]:
    """Flat DIA (offsets, per-diagonal rows) -> axis-displacement value
    grids.  Each offset takes the (usually unique) displacement
    interpretation under which its values are box-valid; a flat-diagonal
    matrix with no such interpretation is not a stencil on ``dims``
    (flat storage would wrap entries onto a neighboring grid line)."""
    grids: Dict[tuple, np.ndarray] = {}
    for d, o in enumerate(offsets):
        V = data2d[d].reshape(dims)
        for disp in _axis_candidates(o, dims):
            if _grid_box_valid(V, disp, dims):
                grids[disp] = V
                break
        else:
            raise ValueError(
                f"matrix is not a stencil on dims {dims}: offset {o} has "
                "nonzero out-of-box (wrapped) entries under every "
                "axis decomposition"
            )
    return grids


def _coarsen(grids: Dict[tuple, np.ndarray], dims, ax):
    """Closed-form Galerkin P^T A P for pair aggregation along axis
    ``ax`` with weights 1/sqrt(2): fine offset component d along the
    pairing axis splits by child parity p into coarse components
    (p + d) // 2, each contributing 0.5 * (strided slice of the value
    grid).  Returns (coarse grids, coarse dims)."""
    nd = len(dims)
    cdims = tuple(
        (e + 1) // 2 if i == ax else e for i, e in enumerate(dims)
    )
    out: Dict[tuple, np.ndarray] = {}
    for disp, V in grids.items():
        d = disp[ax]
        for p in (0, 1):
            dcc = (p + d) // 2  # python floor division: exact for d < 0
            cdisp = tuple(
                dcc if i == ax else disp[i] for i in range(nd)
            )
            sl = [slice(None)] * nd
            sl[ax] = slice(p, None, 2)
            src = V[tuple(sl)]
            tgt = out.get(cdisp)
            if tgt is None:
                tgt = out[cdisp] = np.zeros(cdims, V.dtype)
            wsl = [slice(None)] * nd
            wsl[ax] = slice(0, src.shape[ax])
            tgt[tuple(wsl)] += 0.5 * src
    # prune diagonals that vanished (boundary-only couplings)
    return {k: v for k, v in out.items() if np.any(v != 0)}, cdims


def _merge_flat(grids: Dict[tuple, np.ndarray], dims):
    """Axis-displacement grids -> sorted (flat_offsets, value_grids) with
    ALIASED displacements merged by summation: two displacements can
    flatten to one DIA offset (e.g. (1, -1) and (0, 1) on a narrow
    grid); at any row at most one of them is in-box (the others are
    zero), so summing reproduces the flat-diagonal semantics exactly —
    and a DIAGraph with duplicate offsets would break searchsorted-based
    consumers (entries/get_values/distribute)."""
    merged: Dict[int, np.ndarray] = {}
    for disp, V in grids.items():
        o = _flat_offset(disp, dims)
        if o in merged:
            merged[o] = merged[o] + V
        else:
            merged[o] = V
    offs = sorted(merged)
    return offs, [merged[o] for o in offs]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class _SLevel:
    A: DIAMatrix
    dinv: jax.Array
    dims: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    # axis pairings applied between this level and the next, in order
    # (several pairings per level = larger aggregates = shallower
    # hierarchy = fewer smoothing matvecs per cycle)
    axes: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    omega: float = dataclasses.field(metadata=dict(static=True))
    # largest eigenvalue of D^{-1}A (power-iteration estimate), only set
    # when the hierarchy was built with smoother="chebyshev"
    lmax: jax.Array = None


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True, repr=False)
class StructuredAMGPreconditioner(LinearOperator):
    """One V-cycle of structured pair-aggregation multigrid: every level
    operator is DIA (gather-free blocked-kernel SpMV), every transfer a
    strided slice/repeat.  Use as ``M=`` in any Krylov solver; the cycle
    is symmetric (equal pre/post smoothing, transposed transfers), so it
    is a valid SPD preconditioner for CG."""

    levels: Tuple[_SLevel, ...]
    # dense INVERSE of the coarsest operator, computed once in f64 at
    # setup: the coarse solve applies as one dense matvec instead of a
    # sequential triangular solve per cycle; inverse-apply accuracy is
    # preconditioner-grade by construction (f64 inversion, SPD coarse
    # operator)
    coarse_inv: jax.Array
    n_smooth: int = dataclasses.field(metadata=dict(static=True), default=1)
    # "jacobi" (n_smooth weighted sweeps) or "chebyshev" (degree-n_smooth
    # polynomial in D^{-1}A over [lmax/30, lmax] — stronger damping per
    # matvec, still zero collectives when distributed)
    smoother: str = dataclasses.field(metadata=dict(static=True), default="jacobi")

    @property
    def shape(self):
        if self.levels:
            n = self.levels[0].A.shape[0]
        else:
            n = self.coarse_inv.shape[0]
        return (n, n)

    def _smooth(self, lvl: _SLevel, x, r, from_zero=False):
        """n_smooth weighted-Jacobi sweeps (or one degree-n_smooth
        Chebyshev application); ``from_zero=True`` states x == 0 so the
        first sweep skips its A @ 0 matvec (bit-exact — one full SpMV
        saved per level per cycle)."""
        if self.smoother == "chebyshev":
            return self._smooth_chebyshev(lvl, x, r, from_zero)
        for k in range(self.n_smooth):
            if k == 0 and from_zero:
                x = lvl.omega * lvl.dinv * r
            else:
                x = x + lvl.omega * lvl.dinv * (r - lvl.A.matvec(x))
        return x

    def _smooth_chebyshev(self, lvl: _SLevel, x, r, from_zero):
        """Degree-``n_smooth`` Chebyshev smoothing on the Jacobi-
        preconditioned operator D^{-1}A over [lmax/30, lmax] (the
        standard multigrid smoothing interval; Saad, Iterative Methods,
        Alg. 12.1 with z = D^{-1} r as the preconditioned residual).
        Costs ``n_smooth`` SpMVs like the Jacobi sweeps (``from_zero``
        saves one), but damps the upper 29/30 of the spectrum nearly
        uniformly where a single weighted-Jacobi sweep leaves the
        mid-spectrum barely touched."""
        deg = self.n_smooth
        ub = lvl.lmax.astype(r.dtype)
        lb = ub * jnp.asarray(1.0 / 30.0, r.dtype)
        theta = 0.5 * (ub + lb)
        delta = 0.5 * (ub - lb)
        sigma1 = theta / delta
        rho = 1.0 / sigma1
        if from_zero:
            z = lvl.dinv * r
        else:
            z = lvl.dinv * (r - lvl.A.matvec(x))
        d = z / theta
        if from_zero:
            x = d
        else:
            x = x + d
        for _ in range(deg - 1):
            z = z - lvl.dinv * lvl.A.matvec(d)
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * z
            rho = rho_new
            x = x + d
        return x

    def matvec(self, r):
        return self._cycle(0, r)

    rmatvec = matvec  # symmetric cycle

    def matmat(self, X):
        """Blockwise V-cycles as an explicit per-column loop; m is small
        and static for preconditioner use (LOBPCG residual blocks, block
        CG)."""
        return jnp.stack(
            [self._cycle(0, X[:, j]) for j in range(X.shape[1])], axis=1
        )

    rmatmat = matmat

    def _restrict(self, lvl: _SLevel, r):
        """P^T r through this level's pairing axes, in order; returns
        ``(rc, stages)`` where ``stages`` are the static per-stage grid
        extents the matching prolongation needs for odd-extent trims."""
        w = jnp.asarray(_W, r.dtype)
        # restrict: P^T r = w * (even + odd) along each pairing axis
        # in order (stage extents tracked statically for the odd-pad)
        stages = [tuple(lvl.dims)]
        x3 = r.reshape(lvl.dims)
        for ax in lvl.axes:
            dims_s = stages[-1]
            c = dims_s[ax]
            x3 = w * _pair_sum(x3, ax)
            stages.append(
                tuple(
                    (c + 1) // 2 if k == ax else e
                    for k, e in enumerate(dims_s)
                )
            )
        return x3.reshape(-1), stages

    def _prolong(self, lvl: _SLevel, ec, stages):
        """P ec back through this level's pairing axes (reversed order);
        ``stages`` is the extent list :meth:`_restrict` returned."""
        nd = len(lvl.dims)
        w = jnp.asarray(_W, ec.dtype)
        # prolongate: P e = w * repeat along each pairing axis, reversed
        e3 = ec.reshape(stages[-1])
        for si in range(len(lvl.axes) - 1, -1, -1):
            ax = lvl.axes[si]
            c = stages[si][ax]
            e3 = w * _pair_repeat(e3, ax)
            if c % 2:
                trim = [slice(None)] * nd
                trim[ax] = slice(0, c)
                e3 = e3[tuple(trim)]
        return e3.reshape(-1)

    def _cycle(self, i: int, r):
        if i == len(self.levels):
            return (self.coarse_inv @ r.astype(self.coarse_inv.dtype)).astype(
                r.dtype
            )
        lvl = self.levels[i]
        x = self._smooth(lvl, jnp.zeros_like(r), r, from_zero=True)
        rc, stages = self._restrict(lvl, r - lvl.A.matvec(x))
        ec = self._cycle(i + 1, rc)
        x = x + self._prolong(lvl, ec, stages)
        return self._smooth(lvl, x, r)

    def fmg(self, b):
        """Full-multigrid initial guess: restrict ``b`` through every
        level, solve exactly on the coarsest grid, then work upward —
        prolongate and apply one V-cycle correction per level.  Costs
        under two V-cycles of work and returns an iterate ~1 digit in
        (measured rel residual 0.13 on 16^3 Poisson).

        VERDICT by iteration count (benchmarks/fmg_sequence.py —
        pseudo-timestepping on the 10.1M-row Poisson north star, GMG-CG
        rtol 1e-6, rtol relative to ||b||): the FMG guess LOSES — 19
        iterations/step vs 13 cold (the prolongated guess carries
        interpolation-error components the V-cycle-preconditioned CG
        then spends iterations removing) and plain WARM-STARTING from
        the previous step's solution wins outright (9.7 iterations).
        For solve sequences, warm-start:
        ``cg_solve(A, b_t, x0=x_prev, M=M)``; keep ``fmg`` for
        single-solve contexts with loose tolerances where ~1 digit is
        all that is needed.

        Classic nested iteration (Brandt's FMG); no reference analogue —
        the reference has no multigrid (its strongest preconditioner is
        ILDU, ldu_solvers.f90)."""
        rbs = [b]
        stages_all = []
        for lvl in self.levels:
            rc, stages = self._restrict(lvl, rbs[-1])
            rbs.append(rc)
            stages_all.append(stages)
        x = self._cycle(len(self.levels), rbs[-1])
        for i in range(len(self.levels) - 1, -1, -1):
            lvl = self.levels[i]
            x = self._prolong(lvl, x, stages_all[i])
            x = x + self._cycle(i, rbs[i] - lvl.A.matvec(x))
        return x


def structured_pair_amg(
    A: DIAMatrix,
    dims,
    *,
    coarse_size: int = 64,
    omega: float = 2.0 / 3.0,
    n_smooth: int = 1,
    smoother: str = "jacobi",
    max_levels: int = 64,
    pairs_per_level: int | None = None,
    pair_by: str = "extent",
    freeze_axes: Tuple[int, ...] = (),
    level_dtype=None,
    host_data=None,
) -> StructuredAMGPreconditioner:
    """Build the structured pair-aggregation hierarchy for a stencil
    operator ``A`` (a :class:`DIAMatrix`) on a grid of shape ``dims``
    (row-major, last axis fastest; ``prod(dims) == A.shape[0]``).

    Setup is closed-form numpy on the diagonal value grids — O(nnz) per
    level, no sparse matmul — so it scales to the 10M-row north star in
    seconds.  Raises ``ValueError`` if ``A`` is not actually a stencil
    relative to ``dims`` (flat diagonals that wrap across grid lines
    with nonzero values).

    ``pairs_per_level``: axis-pairings fused between consecutive levels
    (default 1 = Notay-style pairwise aggregates of 2; ``len(dims)``
    gives 2^d cube aggregates — a hierarchy with d-fold fewer levels and
    fewer smoothing matvecs per cycle, at somewhat more iterations).

    ``pair_by``: axis-choice rule for each pairing — ``"extent"``
    (default: largest grid extent) or ``"strength"`` (largest mean
    |unit-displacement coupling|, ties by extent): **semicoarsening**
    for anisotropic operators, which pairs along the strongly coupled
    direction first (pairing across a weak coupling barely changes the
    low-frequency error the level must kill, so extent-based pairing
    stalls on e.g. eps*u_xx + u_yy).

    ``smoother``: ``"jacobi"`` (default; ``n_smooth`` weighted sweeps) or
    ``"chebyshev"`` — a degree-``n_smooth`` Chebyshev polynomial in
    D^{-1}A, same SpMV count per application but near-uniform damping of
    the upper spectrum (per-level lmax estimated by power iteration at
    setup); still zero collectives when distributed.

    ``freeze_axes``: grid axes never paired — used by
    :func:`distribute_structured_amg` to keep the row-sharded axis
    intact, so every transfer in the distributed cycle stays
    shard-local (the frozen direction is resolved exactly by the
    coarsest dense solve).

    ``level_dtype``: storage dtype for the LEVEL matrices (including a
    re-frozen copy of the fine level); ``jnp.bfloat16`` halves the
    V-cycle's dominant HBM stream — a preconditioner tolerates
    low-precision operator values, and the smoothers' dinv and the
    coarsest LU stay in working precision.  Default: A's dtype.

    ``host_data``: optional numpy (D, stride) or (D, S, 128) copy of
    A's diagonal values; pass it when you built A from host arrays to
    spare the device->host readback (322 MB at the north star).
    """
    dims = tuple(int(d) for d in dims)
    n = int(np.prod(dims))
    if A.shape != (n, n):
        raise ValueError(f"dims {dims} do not tile A of shape {A.shape}")
    dtype = np.dtype(A.data.dtype)

    from sigma_tpu.matrix.symmetric import SymmetricDIAMatrix

    if isinstance(A, SymmetricDIAMatrix):
        # symmetric (upper-only) storage: expand to full diagonals for
        # the Galerkin coarsening (host-side mirror of each stored
        # diagonal), but keep A ITSELF as the level-0 operator — every
        # fine-level smoothing sweep then runs the symmetric apply
        offsets_u = A.offsets
        if host_data is not None:
            data_u = np.asarray(host_data).reshape(len(offsets_u), -1)[:, :n]
        else:
            data_u = np.asarray(A.data2d)[:, :n]
        rows = []
        offsets_full = []
        for d, o in enumerate(offsets_u):
            rows.append(data_u[d])
            offsets_full.append(o)
            if o > 0:
                # mirror: A[i, i-o] = A[i-o, i] = data_u[o][i-o]
                mirrored = np.zeros(n, data_u.dtype)
                mirrored[o:] = data_u[d, : n - o]
                rows.append(mirrored)
                offsets_full.append(-o)
        order = np.argsort(offsets_full)
        data2d = np.stack([rows[j] for j in order])
        flat_offsets = tuple(int(offsets_full[j]) for j in order)
    else:
        if host_data is not None:
            data2d = np.asarray(host_data).reshape(A.graph.n_diags, -1)[:, :n]
        else:
            data2d = np.asarray(A.data2d)[:, :n]
        flat_offsets = A.graph.offsets
    grids = _decompose_grids(flat_offsets, data2d, dims)

    if pairs_per_level is None:
        pairs_per_level = 1

    # phase 1: all-numpy hierarchy construction
    def _axis_strengths(g2, nd):
        """Mean |coupling| per axis over the unit displacements — the
        aggregation-strength measure for semicoarsening."""
        s = np.zeros(nd)
        for disp, V in g2.items():
            nz = [k for k, d in enumerate(disp) if d]
            if len(nz) == 1 and abs(disp[nz[0]]) == 1:
                s[nz[0]] += float(np.abs(V).mean())
        return s

    def _pick_axis(g2, d2):
        nd = len(d2)
        strengths = (
            _axis_strengths(g2, nd) if pair_by == "strength" else None
        )
        best = -1
        for k, e in enumerate(d2):
            if k in freeze_axes or e < 2:
                continue
            if best < 0:
                best = k
            elif strengths is not None and not np.isclose(
                strengths[k], strengths[best], rtol=0.05
            ):
                if strengths[k] > strengths[best]:
                    best = k
            elif e > d2[best]:
                best = k
        return best

    specs = []  # (grids, dims, axes) per level
    while n > coarse_size and len(specs) < max_levels - 1:
        axes = []
        g2, d2 = grids, dims
        for _ in range(pairs_per_level):
            if int(np.prod(d2)) <= coarse_size:
                break
            ax = _pick_axis(g2, d2)
            if ax < 0:
                break
            axes.append(ax)
            g2, d2 = _coarsen(g2, d2, ax)
        if not axes:
            break
        specs.append((grids, dims, tuple(axes)))
        grids, dims = g2, d2
        n = int(np.prod(dims))

    # dense coarsest operator (tiny ridge guards a singular Laplacian),
    # factored once on host.  Accumulate (+=): aliased displacements map
    # to one flat diagonal and must sum, like in the flat-DIA matvec.
    coarse = np.zeros((n, n), dtype)
    i = np.arange(n)
    coffs, cgrids = _merge_flat(grids, dims)
    for o, V in zip(coffs, cgrids):
        lo, hi = max(0, -o), min(n, n - o)
        coarse[i[lo:hi], i[lo:hi] + o] += V.reshape(-1)[lo:hi]
    coarse = coarse + 1e-12 * np.eye(n, dtype=dtype)
    cinv = np.linalg.inv(coarse.astype(np.float64))

    # phase 2: ONE host->device transfer per dtype for the whole
    # hierarchy instead of one per level.  Level matrices go in
    # ``level_dtype`` (bf16 halves the V-cycle's dominant data stream,
    # and a preconditioner tolerates low-precision values); dinv and the
    # coarse LU stay in working precision.
    lvl_np = np.dtype(level_dtype) if level_dtype is not None else dtype
    pieces = []  # (kind, level_index, shape, numpy array)
    level_offs = {}
    for li, (g, d, axes) in enumerate(specs):
        nl = int(np.prod(d))
        stride = -(-nl // 128) * 128
        offs, vgrids = _merge_flat(g, d)
        level_offs[li] = tuple(offs)
        if li > 0 or lvl_np != dtype:
            dat = np.zeros((len(offs), stride), lvl_np)
            for k, V in enumerate(vgrids):
                dat[k, :nl] = V.reshape(-1).astype(lvl_np)
            pieces.append(("data", li, dat.shape, dat))
        diag = g.get((0,) * len(d))
        dvec = diag.reshape(-1) if diag is not None else np.zeros(nl, dtype)
        dinv = np.where(dvec != 0, 1.0, 0.0) / np.where(dvec != 0, dvec, 1.0)
        pieces.append(("dinv", li, (nl,), dinv.astype(dtype)))
    pieces.append(("cinv", -1, cinv.shape, cinv.astype(dtype)))

    carved = {}
    for buf_dtype in {lvl_np, dtype}:
        mine = [p for p in pieces if p[3].dtype == buf_dtype]
        if not mine:
            continue
        big = np.concatenate([p[3].reshape(-1) for p in mine])
        dev = jnp.asarray(big)
        off = 0
        for kind, li, shape, arr in mine:
            size = arr.size
            carved[(kind, li)] = dev[off : off + size].reshape(shape)
            off += size

    from sigma_tpu.graph.graph import DIAGraph

    levels = []
    for li, (g, d, axes) in enumerate(specs):
        nl = int(np.prod(d))
        if li == 0 and ("data", 0) not in carved:
            Alvl = A
        else:
            offsets = level_offs[li]
            nnz = sum(
                max(0, min(nl, nl - o) - max(0, -o)) for o in offsets
            )
            graph = DIAGraph(offsets=offsets, shape=(nl, nl), nnz=int(nnz))
            dat = carved[("data", li)]
            Alvl = DIAMatrix(
                graph=graph, data=dat.reshape(len(offsets), -1, 128)
            )
        lmax = None
        if smoother == "chebyshev":
            # rigorous Gershgorin bound on lmax(D^{-1}A) from the host
            # value grids: Chebyshev amplifies any eigenvalue above its
            # interval, so an under-estimate (a 15-step power iteration
            # measured ~10% low here) DIVERGES the cycle — the bound
            # must be an upper bound, not an estimate
            lmax = jnp.asarray(
                _gershgorin_dinv_a(specs[li][0]),
                np.asarray(carved[("dinv", li)]).dtype,
            )
        elif smoother != "jacobi":
            raise ValueError(f"unknown smoother {smoother!r}")
        levels.append(
            _SLevel(
                A=Alvl,
                dinv=carved[("dinv", li)],
                dims=d,
                axes=axes,
                omega=float(omega),
                lmax=lmax,
            )
        )

    return StructuredAMGPreconditioner(
        levels=tuple(levels),
        coarse_inv=carved[("cinv", -1)],
        n_smooth=n_smooth,
        smoother=smoother,
    )


def _gershgorin_dinv_a(grids) -> float:
    """Gershgorin upper bound on lmax(D^{-1}A) from the displacement
    value grids: max over rows of (sum_disp |a|) / |diag| (host numpy,
    one pass; ~2.0 on a Jacobi-scaled Poisson stencil, within ~2% of
    the true 1.97)."""
    zero = next(d for d in grids if not any(d))
    diag = np.abs(np.asarray(grids[zero], dtype=np.float64))
    rows = sum(np.abs(np.asarray(V, dtype=np.float64)) for V in grids.values())
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(diag > 0, rows / np.where(diag > 0, diag, 1.0), 0.0)
    return float(ratio.max())


def _pair_coarsen_coo(rows, cols, vals, nc, dtype):
    """One Galerkin pair-coarsening step on COO triples,
    ``C[r//2, c//2] += 0.5 * A[r, c]`` (exact cancellations dropped):
    the C++ radix path when available, numpy otherwise.  Shared by the
    single-device and distributed pruned hierarchies — they are required
    to be numerically identical (parity asserted in tests/dryrun)."""
    from sigma_tpu import native as _native

    cp = _native.coarsen_pair(rows, cols, vals, nc)
    if cp is not None:
        return cp[0], cp[1], cp[2].astype(dtype)
    key = (rows // 2) * nc + cols // 2
    ukey, inv = np.unique(key, return_inverse=True)
    # accumulate in f64 and cancel-check BEFORE the cast, matching the
    # C++ path bit-for-bit (hosts with and without the native library
    # must build identical hierarchies — values AND sparsity pattern)
    acc = np.zeros(ukey.size, np.float64)
    np.add.at(acc, inv, 0.5 * vals.astype(np.float64))
    keep = acc != 0
    ukey, cv = ukey[keep], acc[keep].astype(dtype)
    return ukey // nc, ukey % nc, cv


def _coo_dinv_lmax(nl, r, c, v, dtype, want_lmax):
    """Smoother diagonal inverse + (optionally) the Gershgorin bound on
    lmax(D^{-1}A), from COO triples.  Assumes CANONICAL (duplicate-free)
    triples — `entries()` output; with duplicates the summed diagonal
    here would disagree with the operator's last-value-wins packing
    (validated under SIGMA_TPU_DEBUG=1)."""
    if os.environ.get("SIGMA_TPU_DEBUG"):
        key = np.asarray(r, np.int64) * (np.asarray(c).max() + 1) + c
        if np.unique(key).size != np.asarray(r).size:
            raise ValueError(
                "pair-AMG requires duplicate-free COO triples (the "
                "operator packs last-value-wins while the hierarchy "
                "would SUM duplicates); deduplicate first, e.g. via "
                "CSRMatrix.from_coo(...).entries()"
            )
    # bincount(weights=) instead of np.add.at: same sum, ~10x faster on
    # the 70M-entry fine level of the 10M setup (add.at is the slow
    # ufunc scatter API)
    dm = r == c
    r = np.asarray(r)
    if r.size and int(r.max()) >= nl:
        # bincount would silently GROW past nl (np.add.at used to raise
        # IndexError here) — keep the loud failure at the cause
        raise ValueError(
            f"row index {int(r.max())} out of range for level size {nl} "
            "(padded-index mismatch? pass pad_to / check the triples)"
        )
    diag = np.bincount(r[dm], weights=v[dm].astype(np.float64),
                       minlength=nl)
    dinv = np.where(diag != 0, 1.0, 0.0) / np.where(diag != 0, diag, 1.0)
    lmax = None
    if want_lmax:
        rs = np.bincount(r, weights=np.abs(v).astype(np.float64),
                         minlength=nl)
        ad = np.abs(diag)
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = np.where(ad > 0, rs / np.where(ad > 0, ad, 1.0), 0.0)
        lmax = float(ratio.max())
    return dinv.astype(dtype), lmax


def skew_dominance(rows, cols, vals) -> float:
    """``||A - A^T||_F / ||A + A^T||_F`` from COO triples (host, one key
    sort): 0 for symmetric operators, -> 1 as the skew part dominates.
    The routing statistic for :func:`auto_pruned_preconditioner`,
    calibrated by iteration counts on the 1M-row edge-skewed mesh
    family (benchmarks/unstructured_nonsym.py --beta): dominance 0.006
    -> pruned-GMG-BiCG-stab 27 vs plain 188 iterations; 0.019 -> 43 vs
    215; 0.116 -> 225 vs 156 (pruned GMG makes it worse) — hence the
    0.05 default threshold.  The statistic is family-specific, not
    universal: the STRUCTURED upwinded advection-diffusion operator
    measures 0.13 yet structured GMG still helps there (its coarsening
    follows the flow axis); this router serves the unstructured pruned
    pipeline only.  The threshold has not been re-derived from H100
    wall times."""
    rows = np.asarray(rows, dtype=np.int64).ravel()
    cols = np.asarray(cols, dtype=np.int64).ravel()
    vals = np.asarray(vals, dtype=np.float64).ravel()
    m = int(max(rows.max(initial=0), cols.max(initial=0))) + 1
    # one argsort of nnz keys + one searchsorted for the mirror lookup
    # (the 2*nnz np.unique form cost tens of seconds of page-fault wall
    # at the 10M routing scale).  Iterating stored entries covers every
    # pair of the pattern union: a one-sided entry contributes at its
    # own position with mirror 0.  Assumes duplicate-free triples (the
    # canonical `entries()` form — duplicates would double-count).
    ks = rows * m + cols
    order = np.argsort(ks)
    ks_s, vs_s = ks[order], vals[order]
    kt = cols * m + rows
    pos = np.searchsorted(ks_s, kt)
    pos_c = np.minimum(pos, ks_s.size - 1)
    match = ks_s[pos_c] == kt
    vt = np.where(match, vs_s[pos_c], 0.0)
    skew = float(np.linalg.norm(vals - vt))
    sym = float(np.linalg.norm(vals + vt))
    return skew / max(sym, 1e-300)


def auto_pruned_preconditioner(
    n, rows, cols, vals, *, skew_threshold: float = 0.05, **amg_kwargs
):
    """Route an unstructured operator to its best-known treatment:
    returns ``(M, info)`` where ``M`` is a :func:`pruned_pair_amg`
    hierarchy (symmetric-storage levels when the operator is
    numerically symmetric) or ``None`` for strongly nonnormal
    operators, where plain BiCG-stab wins (the pair-Galerkin coarse
    grids amplify skew modes — see :func:`skew_dominance`).
    ``info`` records the decision: ``{"skew_dominance": s, "route":
    "pruned_gmg" | "pruned_gmg_sym" | "plain"}``.

    This puts the round-4 prose routing rule in code; the reference's
    only nonsymmetric answer is unpreconditioned BiCG-stab
    (``/root/reference/src/solver/bicgstab_solvers.f90:36``).
    """
    # an EXPLICIT symmetric=True is the caller asserting symmetry the
    # 1e-12 gate cannot detect (fp-roundoff-asymmetric SPD assemblies
    # measure ~1e-8); honor it instead of silently downgrading to full
    # storage (review regression)
    sym_requested = bool(amg_kwargs.pop("symmetric", False))
    s = skew_dominance(rows, cols, vals)
    if s > skew_threshold:
        return None, {"skew_dominance": s, "route": "plain"}
    if sym_requested or s < 1e-12:
        M = pruned_pair_amg(n, rows, cols, vals, symmetric=True,
                            validate=False, **amg_kwargs)
        return M, {"skew_dominance": s, "route": "pruned_gmg_sym"}
    M = pruned_pair_amg(n, rows, cols, vals, **amg_kwargs)
    return M, {"skew_dominance": s, "route": "pruned_gmg"}


def pruned_pair_amg(
    n,
    rows,
    cols,
    vals,
    *,
    coarse_size: int = 4096,
    omega: float = 2.0 / 3.0,
    n_smooth: int = 1,
    smoother: str = "chebyshev",
    max_levels: int = 64,
    level_dtype=None,
    tile_rows: int = 16384,
    group: int | None = None,
    fine_A=None,
    pad_to: int | None = None,
    symmetric: bool = False,
    validate: bool = True,
) -> StructuredAMGPreconditioner:
    """1-D pair-aggregation AMG over COO input, every level stored in
    the PRUNED block-DIA layout (:class:`~sigma_tpu.matrix.pruned.
    PrunedDIAMatrix`) — the multilevel preconditioner for RCM-banded
    unstructured matrices at scales where the full DIA band does not
    fit memory (10M rows x 245 diagonals = 10.3 GB full vs ~1-2 GB
    pruned), which is where :func:`structured_pair_amg`'s dense
    diagonal-grid setup stops applying.

    Same mathematical hierarchy as ``structured_pair_amg(D, (n,))``:
    pair consecutive indices with weight 1/sqrt(2) columns of P, so the
    Galerkin coarse operator is the closed form
    ``C[r//2, c//2] += 0.5 * A[r, c]`` — here evaluated directly on the
    COO triples (one ``np.unique`` + scatter-add per level, O(nnz log
    nnz) host work, no diagonal value grids), so setup never touches
    the padded band.  The returned
    :class:`StructuredAMGPreconditioner` reuses the standard cycle:
    1-D reshape-pair transfers, Jacobi or Chebyshev smoothing
    (Gershgorin-bounded interval — a power-iteration under-estimate
    diverges), dense-inverse coarse solve.

    Pass ``fine_A`` (a PrunedDIAMatrix over the SAME COO triples) to
    reuse it as the level-0 operator instead of re-packing.  ``pad_to``
    coarsens in a padded index space (zero rows beyond ``n``) — pass the
    distributed layout's ``n_pad`` to make this hierarchy the exact
    single-device twin of :func:`sigma_tpu.parallel.pruned.
    distributed_pruned_pair_amg` for parity tests.

    ``symmetric=True`` stores every level in upper-triangle symmetric
    pruned storage (:class:`~sigma_tpu.matrix.pruned.
    SymmetricPrunedDIAMatrix` — half the level value streams; pair
    Galerkin coarsening preserves symmetry, so no per-level validation
    is needed).  The V-cycle is matvec-only, exactly the access
    pattern where the symmetric kernel wins 1.5x.

    No reference analogue (the reference has no multigrid); the
    capability it extends is the any-pattern solve of
    ``/root/reference/src/matrix/formats/cs_matrices.f90:600-622``
    composed with its solver stack.
    """
    from sigma_tpu.matrix.pruned import (
        PrunedDIAMatrix,
        SymmetricPrunedDIAMatrix,
    )

    # group=None passes through to from_coo, whose defaults depend on
    # (storage, dtype): sym 12, bf16 16, f32 8 — resolving here
    # dtype-blind broke the bf16 distributed-twin group parity

    if coarse_size > 8192:
        raise ValueError(
            "the coarsest level is dense-inverted; coarse_size above "
            "~8K is intractable (see structured_pair_amg CAUTION)"
        )
    n = int(n)
    if pad_to is not None:
        if pad_to < n:
            raise ValueError(f"pad_to {pad_to} < n {n}")
        n = int(pad_to)
    rows = np.asarray(rows, dtype=np.int64).ravel()
    cols = np.asarray(cols, dtype=np.int64).ravel()
    vals = np.asarray(vals).ravel()
    dtype = np.dtype(vals.dtype)
    if dtype == np.float64 and not jax.config.read("jax_enable_x64"):
        dtype = np.dtype(np.float32)
        vals = vals.astype(dtype)
    lvl_np = np.dtype(level_dtype) if level_dtype is not None else dtype

    if smoother not in ("jacobi", "chebyshev"):
        raise ValueError(f"unknown smoother {smoother!r}")

    specs = []  # (nl, rows, cols, vals)
    while n > coarse_size and len(specs) < max_levels - 1:
        specs.append((n, rows, cols, vals))
        nc = (n + 1) // 2
        rows, cols, vals = _pair_coarsen_coo(rows, cols, vals, nc, dtype)
        n = nc

    coarse = np.zeros((n, n), np.float64)
    coarse[rows, cols] = vals.astype(np.float64)  # post-unique: no dups
    coarse += 1e-12 * np.eye(n)
    cinv = jnp.asarray(np.linalg.inv(coarse).astype(dtype))

    levels = []
    for li, (nl, r, c, v) in enumerate(specs):
        if li == 0 and fine_A is not None:
            Alvl = fine_A
            if lvl_np != np.dtype(fine_A.data.dtype):
                Alvl = fine_A.astype(lvl_np)
        elif symmetric:
            # validate (default on) checks numeric symmetry ONCE at the
            # fine level — upper-only or skewed input would otherwise
            # build a silently wrong hierarchy (and an underestimated
            # Gershgorin lmax, the diverging-Chebyshev trap); pass
            # validate=False for known-symmetric large assemblies (the
            # check is an O(nnz log nnz) host sort).  Coarser levels
            # skip it: pair Galerkin preserves symmetry.
            # assume_unique on levels > 0: _pair_coarsen_coo output is
            # canonical (post radix/unique), so the per-level O(nnz log
            # nnz) dedup sort the round-4 setup wall paid is skipped
            Alvl = SymmetricPrunedDIAMatrix.from_coo(
                nl, nl, r, c, v, dtype=lvl_np,
                tile_rows=tile_rows, group=group,
                validate=validate and li == 0,
                assume_unique=li > 0,
            )
        else:
            Alvl = PrunedDIAMatrix.from_coo(
                nl, nl, r, c, v, dtype=lvl_np,
                tile_rows=tile_rows, group=group,
                assume_unique=li > 0,
            )
        dinv, lmax = _coo_dinv_lmax(
            nl, r, c, v, dtype, smoother == "chebyshev"
        )
        levels.append(
            _SLevel(
                A=Alvl,
                dinv=jnp.asarray(dinv),
                dims=(nl,),
                axes=(0,),
                omega=float(omega),
                lmax=None if lmax is None else jnp.asarray(lmax, dtype),
            )
        )

    return StructuredAMGPreconditioner(
        levels=tuple(levels),
        coarse_inv=cinv,
        n_smooth=n_smooth,
        smoother=smoother,
    )


class StructuredAMGFactory:
    """Factory-style builder matching the reference's solver idiom
    (``cg()``/``jacobi()``/``ldu()`` return objects with ``setup(A)``,
    cg_solvers.f90:36 etc.): ``structured_amg(dims).setup(A)`` yields the
    V-cycle preconditioner."""

    def __init__(self, dims, **kwargs):
        self.dims = tuple(int(d) for d in dims)
        self.kwargs = kwargs

    def setup(self, A) -> StructuredAMGPreconditioner:
        return structured_pair_amg(A, self.dims, **self.kwargs)


def structured_amg(dims, **kwargs) -> StructuredAMGFactory:
    """``M = structured_amg((nx, ny, nz), pairs_per_level=3).setup(A)`` —
    see :func:`structured_pair_amg` for the keyword options."""
    return StructuredAMGFactory(dims, **kwargs)
