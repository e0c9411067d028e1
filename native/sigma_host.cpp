// sigma_tpu native host core.
//
// The reference (danshapero/sigma) is a fully compiled library; here the
// device path is XLA-compiled, and this file is the compiled
// runtime for the *host* side: topology freezing (COO -> sorted/deduped
// CSR via counting sort, cf. the two-pass build of cs_graphs.f90:109-197),
// reordering (BFS / greedy coloring, cf. permutations.f90), and the
// dependency-level scheduling that parallelizes triangular solves
// (ldu_solvers.f90's sequential sweeps).  Exposed as a C ABI for ctypes.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC sigma_host.cpp -o libsigma_host.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <queue>
#include <utility>
#include <vector>

using i64 = long long;

extern "C" {

// COO -> row-major sorted, deduplicated edge list + CSR row pointer.
// rows/cols: ne input edges.  out_rows/out_cols must hold ne entries;
// indptr must hold n+1.  Returns deduplicated edge count (<= ne).
//
// Strategy: LSD radix sort (16-bit digits) on the composite key
// row*m + col, skipping digit positions above the key width — 3-4 linear
// passes instead of the O(ne log ne) comparison sort, which is what makes
// this worth doing natively for 10^7-10^8-edge topologies.
i64 csr_from_coo(i64 n, i64 m, i64 ne, const i64* rows, const i64* cols,
                 i64* out_rows, i64* out_cols, i64* indptr) {
    using u64 = unsigned long long;
    std::vector<u64> keys(static_cast<size_t>(ne));
    for (i64 e = 0; e < ne; ++e)
        keys[e] = static_cast<u64>(rows[e]) * static_cast<u64>(m) +
                  static_cast<u64>(cols[e]);

    u64 max_key = n > 0 ? static_cast<u64>(n) * static_cast<u64>(m) : 0;
    std::vector<u64> buf(static_cast<size_t>(ne));
    constexpr int RADIX_BITS = 16;
    constexpr size_t BUCKETS = 1u << RADIX_BITS;
    std::vector<i64> count(BUCKETS);
    u64* src = keys.data();
    u64* dst = buf.data();
    for (int shift = 0; shift < 64 && (max_key >> shift) != 0;
         shift += RADIX_BITS) {
        std::fill(count.begin(), count.end(), 0);
        for (i64 e = 0; e < ne; ++e)
            count[(src[e] >> shift) & (BUCKETS - 1)]++;
        i64 sum = 0;
        for (size_t b = 0; b < BUCKETS; ++b) {
            i64 c = count[b];
            count[b] = sum;
            sum += c;
        }
        for (i64 e = 0; e < ne; ++e)
            dst[count[(src[e] >> shift) & (BUCKETS - 1)]++] = src[e];
        std::swap(src, dst);
    }

    // dedup + decompose + row counts
    std::vector<i64> rcnt(static_cast<size_t>(n) + 1, 0);
    i64 w = 0;
    for (i64 e = 0; e < ne; ++e) {
        if (e > 0 && src[e] == src[e - 1]) continue;
        i64 r = static_cast<i64>(src[e] / static_cast<u64>(m));
        out_rows[w] = r;
        out_cols[w] = static_cast<i64>(src[e] % static_cast<u64>(m));
        rcnt[r + 1]++;
        ++w;
    }
    indptr[0] = 0;
    for (i64 i = 0; i < n; ++i) indptr[i + 1] = indptr[i] + rcnt[i + 1];
    return w;
}

// BFS visit-rank permutation (perm[v] = visit rank), restarting at the
// lowest unvisited vertex; matches permutations.f90:22 semantics.
void bfs_order(i64 n, const i64* indptr, const i64* indices, i64 start,
               i64* perm) {
    std::vector<char> seen(static_cast<size_t>(n), 0);
    std::vector<i64> queue;
    queue.reserve(static_cast<size_t>(n));
    i64 rank = 0;
    i64 scan = 0;
    i64 s = start;
    while (rank < n) {
        if (s < 0) {
            while (scan < n && seen[scan]) ++scan;
            if (scan >= n) break;
            s = scan;
        }
        queue.clear();
        queue.push_back(s);
        seen[s] = 1;
        for (size_t q = 0; q < queue.size(); ++q) {
            i64 v = queue[q];
            perm[v] = rank++;
            for (i64 k = indptr[v]; k < indptr[v + 1]; ++k) {
                i64 u = indices[k];
                if (!seen[u]) {
                    seen[u] = 1;
                    queue.push_back(u);
                }
            }
        }
        s = -1;
    }
}

// Reverse Cuthill-McKee ordering: BFS from a minimum-degree vertex per
// component, visiting neighbors in ascending-degree order, ranks reversed.
// perm[v] = new label of v (scatter form).  Sharper bandwidth reduction
// than the plain BFS above (the reference has only the BFS,
// permutations.f90:22).
void rcm_order(i64 n, const i64* indptr, const i64* indices, i64* perm) {
    std::vector<i64> deg(static_cast<size_t>(n));
    for (i64 v = 0; v < n; ++v) deg[v] = indptr[v + 1] - indptr[v];
    std::vector<char> seen(static_cast<size_t>(n), 0);
    std::vector<i64> queue;
    queue.reserve(static_cast<size_t>(n));
    std::vector<i64> nbrs;
    i64 rank = 0;
    // visit components in order of their minimum-degree vertex
    std::vector<i64> verts(static_cast<size_t>(n));
    for (i64 v = 0; v < n; ++v) verts[v] = v;
    std::sort(verts.begin(), verts.end(),
              [&](i64 a, i64 b) { return deg[a] < deg[b] || (deg[a] == deg[b] && a < b); });
    for (i64 s : verts) {
        if (seen[s]) continue;
        queue.clear();
        queue.push_back(s);
        seen[s] = 1;
        for (size_t q = 0; q < queue.size(); ++q) {
            i64 v = queue[q];
            perm[v] = rank++;
            nbrs.clear();
            for (i64 k = indptr[v]; k < indptr[v + 1]; ++k) {
                i64 u = indices[k];
                if (!seen[u]) {
                    seen[u] = 1;
                    nbrs.push_back(u);
                }
            }
            std::sort(nbrs.begin(), nbrs.end(),
                      [&](i64 a, i64 b) { return deg[a] < deg[b] || (deg[a] == deg[b] && a < b); });
            for (i64 u : nbrs) queue.push_back(u);
        }
    }
    for (i64 v = 0; v < n; ++v) perm[v] = n - 1 - perm[v];  // reverse
}

// Sloan profile/wavefront-minimizing ordering (Sloan '86): the
// classic two-phase scheme — (1) pseudo-peripheral start via repeated
// BFS, distances to the end vertex, (2) a max-priority frontier walk
// with priority = -W1*degree_current + W2*distance, promoting
// preactive/active neighbors.  Wavefront ~ LOCAL bandwidth, which is
// exactly the pruned layout's per-row-tile active-diagonal count
// (the pruned layout's occupancy lever).  Status: 0 inactive,
// 1 preactive, 2 active, 3 numbered.
void sloan_order(i64 n, const i64* indptr, const i64* indices, i64* perm) {
    auto bfs_dist = [&](i64 start, std::vector<i64>& dist) -> i64 {
        std::fill(dist.begin(), dist.end(), (i64)-1);
        std::vector<i64> q;
        q.reserve(static_cast<size_t>(n));
        q.push_back(start);
        dist[start] = 0;
        i64 last = start;
        for (size_t h = 0; h < q.size(); ++h) {
            i64 v = q[h];
            last = v;
            for (i64 k = indptr[v]; k < indptr[v + 1]; ++k) {
                i64 u = indices[k];
                if (dist[u] < 0) {
                    dist[u] = dist[v] + 1;
                    q.push_back(u);
                }
            }
        }
        return last;
    };
    std::vector<i64> dist(static_cast<size_t>(n));
    std::vector<char> status(static_cast<size_t>(n), 0);
    std::vector<i64> pri(static_cast<size_t>(n));
    const i64 W1 = 1, W2 = 2;
    i64 rank = 0;
    for (i64 s0 = 0; s0 < n; ++s0) {
        if (status[s0] == 3) continue;
        // pseudo-peripheral pair for this component
        i64 s = s0;
        i64 e = bfs_dist(s, dist);
        for (int it = 0; it < 2; ++it) {
            i64 e2 = bfs_dist(e, dist);
            s = e;
            e = e2;
        }
        bfs_dist(e, dist);  // distances to the END vertex
        for (i64 v = 0; v < n; ++v)
            if (dist[v] >= 0 && status[v] != 3)
                pri[v] = W2 * dist[v] - W1 * (indptr[v + 1] - indptr[v]);
        // lazy max-heap of (priority, vertex)
        std::priority_queue<std::pair<i64, i64>> heap;
        heap.push({pri[s], s});
        status[s] = 1;
        while (!heap.empty()) {
            i64 v = heap.top().second;
            i64 pv = heap.top().first;
            heap.pop();
            if (status[v] == 3 || pv != pri[v]) continue;  // stale
            perm[v] = rank++;
            status[v] = 3;
            for (i64 k = indptr[v]; k < indptr[v + 1]; ++k) {
                i64 u = indices[k];
                if (status[u] == 3) continue;
                if (status[u] == 0) {
                    // becomes preactive: enters the frontier
                    status[u] = 1;
                    heap.push({pri[u], u});
                }
                if (status[u] == 1) {
                    // activation bonus: u joins the wavefront when its
                    // first neighbor is numbered
                    status[u] = 2;
                    pri[u] += W1;
                    heap.push({pri[u], u});
                }
                // freeing v's edge to u shrinks u's current degree
                pri[u] += W1;
                heap.push({pri[u], u});
            }
        }
    }
}

// Greedy first-fit coloring in vertex order; returns number of colors.
i64 greedy_coloring(i64 n, const i64* indptr, const i64* indices,
                    i64* colors) {
    std::fill(colors, colors + n, (i64)-1);
    std::vector<i64> mark(static_cast<size_t>(n), -1);
    i64 ncolors = 0;
    for (i64 v = 0; v < n; ++v) {
        for (i64 k = indptr[v]; k < indptr[v + 1]; ++k) {
            i64 u = indices[k];
            if (colors[u] >= 0) mark[colors[u]] = v;
        }
        i64 c = 0;
        while (c < n && mark[c] == v) ++c;
        colors[v] = c;
        if (c + 1 > ncolors) ncolors = c + 1;
    }
    return ncolors;
}

// Dependency levels of a strict triangular sparsity: level[i] =
// 1 + max(level[j]) over stored dependencies j of row i.  reverse=0:
// lower-triangular (j < i, rows processed 0..n-1); reverse=1:
// upper-triangular (j > i, rows processed n-1..0).  Rows in the same
// level can be solved in parallel (the multicolor escape hatch for
// ldu_solvers.f90:208-253).  Returns number of levels.
i64 triangular_levels(i64 n, const i64* indptr, const i64* indices,
                      i64 reverse, i64* level_of) {
    i64 nlevels = n > 0 ? 1 : 0;
    i64 begin = reverse ? n - 1 : 0;
    i64 step = reverse ? -1 : 1;
    for (i64 t = 0, i = begin; t < n; ++t, i += step) {
        i64 lvl = 0;
        for (i64 k = indptr[i]; k < indptr[i + 1]; ++k) {
            i64 j = indices[k];
            bool dep = reverse ? (j > i) : (j < i);
            if (dep && level_of[j] + 1 > lvl) lvl = level_of[j] + 1;
        }
        level_of[i] = lvl;
        if (lvl + 1 > nlevels) nlevels = lvl + 1;
    }
    return nlevels;
}

// Zero-fill ILU(0)/ILDU(0) numeric factorization on a sorted CSR pattern
// (the compiled form of ldu_solvers.f90:275-417's setup).  data is
// factorized IN PLACE (SPARSKIT ikj order with a column-position marker):
// on return, entries left of the diagonal hold L (unit-diagonal implied),
// the diagonal entry holds D, entries right of it hold the rows of U with
// D folded in (divide row i's upper entries by D_i to get the unit-U
// factors).  diag_out[i] = D_i.  Returns 0 on success or (i+1) for a zero
// or structurally missing pivot in row i.
i64 ilu0_factorize(i64 n, const i64* indptr, const i64* indices,
                   double* data, double* diag_out) {
    std::vector<i64> ipos(static_cast<size_t>(n), -1);
    std::vector<i64> diag_pos(static_cast<size_t>(n), -1);
    for (i64 i = 0; i < n; ++i) {
        i64 s = indptr[i], e = indptr[i + 1];
        for (i64 p = s; p < e; ++p) ipos[indices[p]] = p;
        for (i64 p = s; p < e; ++p) {
            i64 k = indices[p];
            if (k >= i) break;
            double lik = data[p] / diag_out[k];
            data[p] = lik;
            for (i64 kp = diag_pos[k] + 1; kp < indptr[k + 1]; ++kp) {
                i64 pos = ipos[indices[kp]];
                if (pos >= 0) data[pos] -= lik * data[kp];
            }
        }
        i64 dp = diag_pos[i] = ipos[i];
        for (i64 p = s; p < e; ++p) ipos[indices[p]] = -1;
        if (dp < 0 || data[dp] == 0.0) return i + 1;
        diag_out[i] = data[dp];
    }
    return 0;
}

// Pack a strict-triangular CSR system into level-major padded arrays for
// the batched level-scheduled sweeps (the compiled form of the per-row
// fill in TriangularLevels.from_csr).  rows_out (nlev*max_rows) must be
// pre-filled with the sentinel n; cols_out/vals_out (nlev*max_rows*width)
// pre-zeroed.
void pack_levels(i64 n, const i64* indptr, const i64* indices,
                 const double* data, const i64* level, i64 nlev,
                 i64 max_rows, i64 width, i64* rows_out, i64* cols_out,
                 double* vals_out) {
    std::vector<i64> slot(static_cast<size_t>(nlev), 0);
    for (i64 i = 0; i < n; ++i) {
        i64 l = level[i];
        i64 s_ = slot[l]++;
        rows_out[l * max_rows + s_] = i;
        i64 base = (l * max_rows + s_) * width;
        for (i64 p = indptr[i]; p < indptr[i + 1]; ++p) {
            cols_out[base] = indices[p];
            vals_out[base] = data[p];
            ++base;
        }
    }
}

// Greedy aggregation for smoothed-aggregation AMG: each unaggregated
// vertex in order seeds an aggregate with its unaggregated neighbors.
// Returns the number of aggregates.
i64 greedy_aggregate(i64 n, const i64* indptr, const i64* indices,
                     i64* agg) {
    std::fill(agg, agg + n, (i64)-1);
    i64 next_agg = 0;
    for (i64 v = 0; v < n; ++v) {
        if (agg[v] >= 0) continue;
        agg[v] = next_agg;
        for (i64 k = indptr[v]; k < indptr[v + 1]; ++k) {
            i64 u = indices[k];
            if (agg[u] < 0) agg[u] = next_agg;
        }
        ++next_agg;
    }
    return next_agg;
}

// VMB (Vanek-Mandel-Brezina) aggregation: phase 1 seeds an aggregate at a
// vertex only when its whole neighborhood is unaggregated (yields compact
// ~3^d aggregates on stencils instead of the greedy pairs); phase 2
// attaches leftovers to an adjacent aggregate; phase 3 seeds the rest
// from whatever unaggregated neighbors remain.  Returns aggregate count.
i64 vmb_aggregate(i64 n, const i64* indptr, const i64* indices, i64* agg) {
    std::fill(agg, agg + n, (i64)-1);
    i64 next_agg = 0;
    for (i64 v = 0; v < n; ++v) {  // phase 1
        if (agg[v] >= 0) continue;
        bool clean = true;
        for (i64 k = indptr[v]; k < indptr[v + 1] && clean; ++k)
            if (indices[k] != v && agg[indices[k]] >= 0) clean = false;
        if (!clean) continue;
        agg[v] = next_agg;
        for (i64 k = indptr[v]; k < indptr[v + 1]; ++k) agg[indices[k]] = next_agg;
        ++next_agg;
    }
    for (i64 v = 0; v < n; ++v) {  // phase 2
        if (agg[v] >= 0) continue;
        for (i64 k = indptr[v]; k < indptr[v + 1]; ++k) {
            i64 a = agg[indices[k]];
            if (a >= 0) { agg[v] = a; break; }
        }
    }
    for (i64 v = 0; v < n; ++v) {  // phase 3
        if (agg[v] >= 0) continue;
        agg[v] = next_agg;
        for (i64 k = indptr[v]; k < indptr[v + 1]; ++k)
            if (agg[indices[k]] < 0) agg[indices[k]] = next_agg;
        ++next_agg;
    }
    return next_agg;
}

// ILU(k) symbolic factorization: the level-of-fill pattern expansion
// (Saad, Iterative Methods, §10.3.3; SPARSKIT's iluk symbolic phase).
// The reference library aborts for fill level > 0 (ldu_solvers.f90:414-417)
// — this goes beyond it.  The numeric phase needs no new code: running
// ilu0_factorize on the expanded pattern (fill slots value-0) IS ILU(k).
//
// Per row: seed with A's pattern at level 0, then for each kept column
// j < i in ascending order merge row j's upper factor pattern with
// lev = lev(i,j) + lev(j,l) + 1, keeping lev <= k.  Ascending traversal
// with O(1) insertion uses the classic linked-list-through-columns work
// array.  Output: CSR pattern of the factor (L + diag + U, sorted rows).
// Returns nnz(F) if it fits cap, else -(nnz needed) so the caller can
// retry with exact capacity.
i64 iluk_symbolic(i64 n, const i64* indptr, const i64* indices, i64 k,
                  i64 cap, i64* fptr, i64* fcol) {
    // factor's strict-upper patterns + levels, kept for later row merges
    std::vector<std::vector<i64>> ucols(static_cast<size_t>(n));
    std::vector<std::vector<i64>> ulev(static_cast<size_t>(n));
    const i64 INF = (i64)1 << 60;
    std::vector<i64> lev(static_cast<size_t>(n), INF);
    std::vector<i64> nxt(static_cast<size_t>(n) + 1, -1);  // linked list
    std::vector<i64> out;
    out.reserve(static_cast<size_t>(indptr[n]));
    std::vector<i64> optr(static_cast<size_t>(n) + 1, 0);

    for (i64 i = 0; i < n; ++i) {
        // seed the linked list with row i of A (already sorted)
        i64 head = n;  // sentinel
        nxt[n] = -1;
        i64 prev = n;
        for (i64 p = indptr[i]; p < indptr[i + 1]; ++p) {
            i64 c = indices[p];
            lev[c] = 0;
            nxt[prev] = c;
            nxt[c] = -1;
            prev = c;
        }
        // ascending merge over kept columns j < i
        for (i64 j = nxt[head]; j != -1 && j < i; j = nxt[j]) {
            i64 levij = lev[j];
            if (levij > k) continue;
            const auto& uc = ucols[j];
            const auto& ul = ulev[j];
            i64 ins = j;  // insertion cursor: uc is ascending and > j
            for (size_t t = 0; t < uc.size(); ++t) {
                i64 l = uc[t];
                i64 nl = levij + ul[t] + 1;
                if (lev[l] == INF) {
                    if (nl > k) continue;
                    lev[l] = nl;
                    // insert l into the list after `ins` (advance first)
                    while (nxt[ins] != -1 && nxt[ins] < l) ins = nxt[ins];
                    nxt[l] = nxt[ins];
                    nxt[ins] = l;
                } else if (nl < lev[l]) {
                    lev[l] = nl;
                }
            }
        }
        // emit kept entries (sorted by construction); record upper factor
        for (i64 c = nxt[head]; c != -1; c = nxt[c]) {
            if (lev[c] <= k) {
                out.push_back(c);
                if (c > i) {
                    ucols[i].push_back(c);
                    ulev[i].push_back(lev[c]);
                }
            }
        }
        optr[i + 1] = static_cast<i64>(out.size());
        // reset work arrays (touched columns only)
        for (i64 c = nxt[head]; c != -1;) {
            i64 c2 = nxt[c];
            lev[c] = INF;
            nxt[c] = -1;
            c = c2;
        }
    }
    i64 total = static_cast<i64>(out.size());
    if (total > cap) return -total;
    std::memcpy(fptr, optr.data(), sizeof(i64) * (n + 1));
    std::memcpy(fcol, out.data(), sizeof(i64) * total);
    return total;
}

// ---------------------------------------------------------------------------
// Memory-lean CSR algebra for one-shot host products (Gustavson SpGEMM).
//
// The python plan machinery (matrix/algebra.py) materializes a *contribution
// map* — one int64 per scalar product — which is the right shape for
// reusable jitted numeric phases but allocates ~10x the bytes of the result.
// On this VM's page-fault-bound host memory that made generic AMG setup
// minutes per level; these routines compute the same products in O(nnz(C))
// memory with preallocated (stays-warm) workspaces.  Two-pass C ABI:
// *_symbolic fills the row pointer and returns nnz(C) so the caller can
// allocate exactly, *_numeric fills sorted columns + values.
// ---------------------------------------------------------------------------

// C = A (n x k) @ B (k x m): count distinct columns per row of C.
i64 spgemm_symbolic(i64 n, i64 m, const i64* aptr, const i64* acol,
                    const i64* bptr, const i64* bcol, i64* cptr) {
    std::vector<i64> mark(static_cast<size_t>(m), -1);
    cptr[0] = 0;
    for (i64 i = 0; i < n; ++i) {
        i64 cnt = 0;
        for (i64 p = aptr[i]; p < aptr[i + 1]; ++p) {
            i64 k = acol[p];
            for (i64 q = bptr[k]; q < bptr[k + 1]; ++q) {
                i64 j = bcol[q];
                if (mark[j] != i) {
                    mark[j] = i;
                    ++cnt;
                }
            }
        }
        cptr[i + 1] = cptr[i] + cnt;
    }
    return cptr[n];
}

// Numeric phase: sparse-accumulator row merge, columns sorted within rows.
void spgemm_numeric(i64 n, i64 m, const i64* aptr, const i64* acol,
                    const double* aval, const i64* bptr, const i64* bcol,
                    const double* bval, const i64* cptr, i64* ccol,
                    double* cval) {
    std::vector<double> spa(static_cast<size_t>(m), 0.0);
    std::vector<i64> mark(static_cast<size_t>(m), -1);
    std::vector<i64> row_cols;
    for (i64 i = 0; i < n; ++i) {
        row_cols.clear();
        for (i64 p = aptr[i]; p < aptr[i + 1]; ++p) {
            i64 k = acol[p];
            double a = aval[p];
            for (i64 q = bptr[k]; q < bptr[k + 1]; ++q) {
                i64 j = bcol[q];
                if (mark[j] != i) {
                    mark[j] = i;
                    spa[j] = a * bval[q];
                    row_cols.push_back(j);
                } else {
                    spa[j] += a * bval[q];
                }
            }
        }
        std::sort(row_cols.begin(), row_cols.end());
        i64 w = cptr[i];
        for (i64 j : row_cols) {
            ccol[w] = j;
            cval[w] = spa[j];
            ++w;
        }
    }
}

// Fused single-pass SpGEMM: one Gustavson traversal computes structure AND
// values into persistent internal buffers (capacity survives across calls —
// the AMG setup's 12 products reuse warm pages on this fault-bound host),
// then spgemm_fetch copies them out into caller arrays.  Halves the
// traversal work of the symbolic+numeric pair above (kept for parity
// tests and as the no-fetch API).
static std::vector<i64> g_spgemm_ccol;
static std::vector<double> g_spgemm_cval;

i64 spgemm_fused(i64 n, i64 m, const i64* aptr, const i64* acol,
                 const double* aval, const i64* bptr, const i64* bcol,
                 const double* bval, i64* cptr) {
    std::vector<double> spa(static_cast<size_t>(m), 0.0);
    std::vector<i64> mark(static_cast<size_t>(m), -1);
    std::vector<i64> row_cols;
    g_spgemm_ccol.clear();
    g_spgemm_cval.clear();
    cptr[0] = 0;
    for (i64 i = 0; i < n; ++i) {
        row_cols.clear();
        for (i64 p = aptr[i]; p < aptr[i + 1]; ++p) {
            i64 k = acol[p];
            double a = aval[p];
            for (i64 q = bptr[k]; q < bptr[k + 1]; ++q) {
                i64 j = bcol[q];
                if (mark[j] != i) {
                    mark[j] = i;
                    spa[j] = a * bval[q];
                    row_cols.push_back(j);
                } else {
                    spa[j] += a * bval[q];
                }
            }
        }
        std::sort(row_cols.begin(), row_cols.end());
        for (i64 j : row_cols) {
            g_spgemm_ccol.push_back(j);
            g_spgemm_cval.push_back(spa[j]);
        }
        cptr[i + 1] = static_cast<i64>(g_spgemm_ccol.size());
    }
    return cptr[n];
}

void spgemm_fetch(i64 nnz, i64* ccol, double* cval) {
    std::copy_n(g_spgemm_ccol.data(), static_cast<size_t>(nnz), ccol);
    std::copy_n(g_spgemm_cval.data(), static_cast<size_t>(nnz), cval);
}

// C = alpha*A + beta*B on the union sparsity (both row-sorted CSR).
i64 csr_add_symbolic(i64 n, const i64* aptr, const i64* acol,
                     const i64* bptr, const i64* bcol, i64* cptr) {
    cptr[0] = 0;
    for (i64 i = 0; i < n; ++i) {
        i64 pa = aptr[i], ea = aptr[i + 1];
        i64 pb = bptr[i], eb = bptr[i + 1];
        i64 cnt = 0;
        while (pa < ea || pb < eb) {
            if (pb >= eb || (pa < ea && acol[pa] < bcol[pb])) ++pa;
            else if (pa >= ea || bcol[pb] < acol[pa]) ++pb;
            else { ++pa; ++pb; }
            ++cnt;
        }
        cptr[i + 1] = cptr[i] + cnt;
    }
    return cptr[n];
}

void csr_add_numeric(i64 n, double alpha, double beta, const i64* aptr,
                     const i64* acol, const double* aval, const i64* bptr,
                     const i64* bcol, const double* bval, const i64* cptr,
                     i64* ccol, double* cval) {
    for (i64 i = 0; i < n; ++i) {
        i64 pa = aptr[i], ea = aptr[i + 1];
        i64 pb = bptr[i], eb = bptr[i + 1];
        i64 w = cptr[i];
        while (pa < ea || pb < eb) {
            if (pb >= eb || (pa < ea && acol[pa] < bcol[pb])) {
                ccol[w] = acol[pa];
                cval[w] = alpha * aval[pa++];
            } else if (pa >= ea || bcol[pb] < acol[pa]) {
                ccol[w] = bcol[pb];
                cval[w] = beta * bval[pb++];
            } else {
                ccol[w] = acol[pa];
                cval[w] = alpha * aval[pa++] + beta * bval[pb++];
            }
            ++w;
        }
    }
}

// T = A^T for an (n x m) row-sorted CSR; counting sort by column — rows of
// T come out sorted because the scan is in row order.
void csr_transpose(i64 n, i64 m, const i64* aptr, const i64* acol,
                   const double* aval, i64* tptr, i64* tcol, double* tval) {
    std::fill(tptr, tptr + m + 1, (i64)0);
    i64 ne = aptr[n];
    for (i64 p = 0; p < ne; ++p) tptr[acol[p] + 1]++;
    for (i64 j = 0; j < m; ++j) tptr[j + 1] += tptr[j];
    std::vector<i64> next(tptr, tptr + m);
    for (i64 i = 0; i < n; ++i)
        for (i64 p = aptr[i]; p < aptr[i + 1]; ++p) {
            i64 w = next[acol[p]]++;
            tcol[w] = i;
            tval[w] = aval[p];
        }
}

// Batched binary-search of (row, col) queries in a sorted CSR structure.
// out[q] = flat position of (r, c) or -1.
void edge_positions(i64 nq, const i64* qr, const i64* qc, i64 n,
                    const i64* indptr, const i64* indices, i64* out) {
    for (i64 q = 0; q < nq; ++q) {
        i64 r = qr[q], c = qc[q];
        if (r < 0 || r >= n) {
            out[q] = -1;
            continue;
        }
        const i64* lo = indices + indptr[r];
        const i64* hi = indices + indptr[r + 1];
        const i64* it = std::lower_bound(lo, hi, c);
        out[q] = (it != hi && *it == c) ? (it - indices) : -1;
    }
}

// ---- pruned block-DIA packing (matrix/pruned.py setup hot path) -------
//
// Replaces the numpy np.unique + flat-scatter construction of
// sigma_tpu/ops/spmv_pruned.py::build_pruned_plan, which is
// page-fault/sort-bound at 10M rows (~60-150 s on this host class).
// Two-call protocol like spgemm_fused/fetch: pack_pruned_count radix-
// sorts the (tile, offset) keys (STABLE LSD — duplicate (r, c) entries
// keep input order, so the fill's sequential overwrite preserves
// last-value-wins set_values semantics) and stores the sorted triples
// in persistent buffers; pack_pruned_fill writes the packed value
// blocks and the prefetch arrays into caller-allocated outputs.
static std::vector<unsigned long long> g_pp_keys;
static std::vector<double> g_pp_vals;
static std::vector<i64> g_pp_rloc;
static std::vector<i64> g_pp_cnt;     // active (tile, offset) pairs per tile
static i64 g_pp_reach = 0, g_pp_G = 0;

i64 pack_pruned_count(i64 ne, const i64* rows, const i64* cols,
                      const double* vals, i64 tile_rows, i64 group,
                      i64 reach, i64 G) {
    using u64 = unsigned long long;
    u64 W = static_cast<u64>(4 * (reach + 1) + 1);
    g_pp_keys.resize(static_cast<size_t>(ne));
    g_pp_vals.resize(static_cast<size_t>(ne));
    g_pp_rloc.resize(static_cast<size_t>(ne));
    for (i64 e = 0; e < ne; ++e) {
        i64 t = rows[e] / tile_rows;
        i64 off = cols[e] - rows[e];
        g_pp_keys[e] = static_cast<u64>(t) * W +
                       static_cast<u64>(off + reach);
        g_pp_vals[e] = vals[e];
        g_pp_rloc[e] = rows[e] - t * tile_rows;
    }
    u64 max_key = static_cast<u64>(G) * W;
    std::vector<u64> kbuf(static_cast<size_t>(ne));
    std::vector<double> vbuf(static_cast<size_t>(ne));
    std::vector<i64> rbuf(static_cast<size_t>(ne));
    constexpr int RADIX_BITS = 16;
    constexpr size_t BUCKETS = 1u << RADIX_BITS;
    std::vector<i64> count(BUCKETS);
    u64 *ks = g_pp_keys.data(), *kd = kbuf.data();
    double *vs = g_pp_vals.data(), *vd = vbuf.data();
    i64 *rs = g_pp_rloc.data(), *rd = rbuf.data();
    for (int shift = 0; shift < 64 && (max_key >> shift) != 0;
         shift += RADIX_BITS) {
        std::fill(count.begin(), count.end(), 0);
        for (i64 e = 0; e < ne; ++e)
            count[(ks[e] >> shift) & (BUCKETS - 1)]++;
        i64 sum = 0;
        for (size_t b = 0; b < BUCKETS; ++b) {
            i64 c = count[b];
            count[b] = sum;
            sum += c;
        }
        for (i64 e = 0; e < ne; ++e) {
            i64 w = count[(ks[e] >> shift) & (BUCKETS - 1)]++;
            kd[w] = ks[e];
            vd[w] = vs[e];
            rd[w] = rs[e];
        }
        std::swap(ks, kd);
        std::swap(vs, vd);
        std::swap(rs, rd);
    }
    if (ks != g_pp_keys.data()) {
        std::copy_n(ks, static_cast<size_t>(ne), g_pp_keys.data());
        std::copy_n(vs, static_cast<size_t>(ne), g_pp_vals.data());
        std::copy_n(rs, static_cast<size_t>(ne), g_pp_rloc.data());
    }
    // per-tile active-pair counts -> total padded step count L
    g_pp_cnt.assign(static_cast<size_t>(G), 0);
    for (i64 e = 0; e < ne; ++e) {
        if (e > 0 && g_pp_keys[e] == g_pp_keys[e - 1]) continue;
        g_pp_cnt[static_cast<size_t>(g_pp_keys[e] / W)]++;
    }
    g_pp_reach = reach;
    g_pp_G = G;
    i64 L = 0;
    for (i64 t = 0; t < G; ++t) {
        i64 steps = (g_pp_cnt[t] + group - 1) / group;
        L += steps > 0 ? steps : 1;
    }
    return L;
}

// active (tile, offset) pair count of the last pack_pruned_count call
i64 pack_pruned_active() {
    i64 s = 0;
    for (i64 c : g_pp_cnt) s += c;
    return s;
}

// data: (L*group, tile_rows) f32, zero-initialized by the caller;
// tile/first: (L,); rowoff/laneoff: (L*group,) pre-filled by the caller
// with the padding-slot values (E, 0).
void pack_pruned_fill(i64 ne, i64 tile_rows, i64 group, i64 E,
                      float* data, int* tile, int* first, int* rowoff,
                      int* laneoff) {
    using u64 = unsigned long long;
    u64 W = static_cast<u64>(4 * (g_pp_reach + 1) + 1);
    i64 step = 0, e = 0;
    for (i64 t = 0; t < g_pp_G; ++t) {
        i64 cnt = g_pp_cnt[t];
        i64 steps_t = cnt > 0 ? (cnt + group - 1) / group : 1;
        i64 slot = step * group;
        for (i64 s = 0; s < steps_t; ++s) {
            tile[step + s] = static_cast<int>(t);
            first[step + s] = (s == 0) ? 1 : 0;
        }
        i64 pair = -1;
        u64 prev_key = ~0ull;
        while (e < ne && static_cast<i64>(g_pp_keys[e] / W) == t) {
            if (g_pp_keys[e] != prev_key) {
                prev_key = g_pp_keys[e];
                ++pair;
                i64 off = static_cast<i64>(g_pp_keys[e] % W) - g_pp_reach;
                i64 q = E * 128 + off;
                rowoff[slot + pair] = static_cast<int>(q / 128);
                laneoff[slot + pair] = static_cast<int>(q % 128);
            }
            data[(slot + pair) * tile_rows + g_pp_rloc[e]] =
                static_cast<float>(g_pp_vals[e]);
            ++e;
        }
        step += steps_t;
    }
}

// ---- 1-D pair-aggregation Galerkin coarsening (solvers/gmg.py) --------
// C[r/2, c/2] += 0.5 * A[r, c]: radix-sort the coarse keys, sum
// duplicates.  Two-call protocol; replaces a np.unique + np.add.at pass
// per level (sort-bound at 70M entries).
static std::vector<unsigned long long> g_cp_keys;
static std::vector<double> g_cp_vals;

i64 coarsen_pair_count(i64 ne, const i64* rows, const i64* cols,
                       const double* vals, i64 nc) {
    using u64 = unsigned long long;
    g_cp_keys.resize(static_cast<size_t>(ne));
    g_cp_vals.resize(static_cast<size_t>(ne));
    for (i64 e = 0; e < ne; ++e) {
        g_cp_keys[e] = static_cast<u64>(rows[e] / 2) * static_cast<u64>(nc) +
                       static_cast<u64>(cols[e] / 2);
        g_cp_vals[e] = 0.5 * vals[e];
    }
    u64 max_key = static_cast<u64>(nc) * static_cast<u64>(nc);
    std::vector<u64> kbuf(static_cast<size_t>(ne));
    std::vector<double> vbuf(static_cast<size_t>(ne));
    constexpr int RADIX_BITS = 16;
    constexpr size_t BUCKETS = 1u << RADIX_BITS;
    std::vector<i64> count(BUCKETS);
    u64 *ks = g_cp_keys.data(), *kd = kbuf.data();
    double *vs = g_cp_vals.data(), *vd = vbuf.data();
    for (int shift = 0; shift < 64 && (max_key >> shift) != 0;
         shift += RADIX_BITS) {
        std::fill(count.begin(), count.end(), 0);
        for (i64 e = 0; e < ne; ++e)
            count[(ks[e] >> shift) & (BUCKETS - 1)]++;
        i64 sum = 0;
        for (size_t b = 0; b < BUCKETS; ++b) {
            i64 c = count[b];
            count[b] = sum;
            sum += c;
        }
        for (i64 e = 0; e < ne; ++e) {
            i64 w = count[(ks[e] >> shift) & (BUCKETS - 1)]++;
            kd[w] = ks[e];
            vd[w] = vs[e];
        }
        std::swap(ks, kd);
        std::swap(vs, vd);
    }
    // in-place duplicate sum into the head of the (possibly swapped)
    // buffers; drop exact cancellations to keep packing tight
    i64 w = -1;
    for (i64 e = 0; e < ne; ++e) {
        if (w >= 0 && ks[e] == static_cast<u64>(g_cp_keys[w])) {
            g_cp_vals[w] += vs[e];
        } else {
            if (w >= 0 && g_cp_vals[w] == 0.0) --w;  // cancelled
            ++w;
            g_cp_keys[w] = ks[e];
            g_cp_vals[w] = vs[e];
        }
    }
    if (w >= 0 && g_cp_vals[w] == 0.0) --w;
    return w + 1;
}

void coarsen_pair_fetch(i64 n_out, i64 nc, i64* out_rows, i64* out_cols,
                        double* out_vals) {
    for (i64 e = 0; e < n_out; ++e) {
        out_rows[e] = static_cast<i64>(g_cp_keys[e] / static_cast<unsigned long long>(nc));
        out_cols[e] = static_cast<i64>(g_cp_keys[e] % static_cast<unsigned long long>(nc));
        out_vals[e] = g_cp_vals[e];
    }
}

// Adjacency-only counting sort: group DUPLICATE-FREE COO edges by row
// (within-row order unspecified, no dedup) — the O(nnz) two-pass build
// for consumers that only need neighbor lists (RCM/BFS orderings).
// ~4x less memory traffic than csr_from_coo's radix sort + dedup; the
// reference's counting-sort idiom (cs_graphs.f90:109-197) without the
// column sort its accessors need.
void adjacency_from_coo(i64 n, i64 ne, const i64* rows, const i64* cols,
                        i64* out_cols, i64* indptr) {
    for (i64 i = 0; i <= n; ++i) indptr[i] = 0;
    for (i64 e = 0; e < ne; ++e) indptr[rows[e] + 1]++;
    for (i64 i = 0; i < n; ++i) indptr[i + 1] += indptr[i];
    std::vector<i64> pos(indptr, indptr + n);
    for (i64 e = 0; e < ne; ++e) out_cols[pos[rows[e]]++] = cols[e];
}

}  // extern "C"
