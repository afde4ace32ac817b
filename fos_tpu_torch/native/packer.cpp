// Native host-side tile packers for the blocked-ELL / banded-block sparse
// operators (fos_tpu_torch/linalg/sparse_ell.py), and the tile statistics
// behind their format choice.
//
// The port's copy of fos_tpu/native/packer.cpp: the same four entry points
// with the same contract, plus fos_tile_stats.  Packing COO triplets into
// (bm, bn) tile tables is the one host-side O(nnz) pass of a form build;
// numpy (np.unique + np.add.at over 4-d indices) costs ~0.5 us per nonzero.
// This pass is a counting sort + per-row-block dedup + scatter, threaded
// over row blocks.
//
// Contract (mirrors _build_ell_arrays / _build_band_arrays exactly,
// including duplicate-COO summing):
//   ELL:  phase1 buckets entries by row block and assigns each entry the
//         slot of its tile (slots numbered in ascending block-column order,
//         matching np.unique's sorted output); fill scatters values into the
//         zero-initialised (nrb, kmax, bm, bn) table and writes the
//         (nrb, kmax) block-column table.
//   band: phase1 computes the per-row-block window start lo[] and the max
//         window width S; fill scatters into (nrb, S, bm, bn).
//   stats: the widest window and the most distinct tiles of one row block,
//         and of one column block: the integers band_span_ratio and
//         bell_storage_ratio are made of.
//
// All index inputs are int64, values float32, outputs caller-allocated
// (numpy owns every buffer; no allocation crosses the ABI).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

int nthreads_for(int64_t work_items) {
    unsigned hw = std::thread::hardware_concurrency();
    if (hw == 0) hw = 1;
    // threading pays only past ~1e5 entries (thread spawn ~10us each)
    if (work_items < 100000) return 1;
    return static_cast<int>(std::min<unsigned>(hw, 8));
}

// Split row blocks [0, nrb) into `nt` contiguous ranges balanced by entry
// count (offs is the bucket prefix sum).
std::vector<int64_t> balance(const int64_t* offs, int64_t nrb, int nt) {
    std::vector<int64_t> cut(nt + 1, nrb);
    cut[0] = 0;
    int64_t total = offs[nrb];
    for (int t = 1; t < nt; ++t) {
        int64_t target = total * t / nt;
        cut[t] = std::lower_bound(offs, offs + nrb + 1, target) - offs;
        if (cut[t] < cut[t - 1]) cut[t] = cut[t - 1];
    }
    return cut;
}

}  // namespace

extern "C" {

// Bucket entries by row block (counting sort) and assign per-entry tile
// slots.  Returns the max unique-tile count over row blocks (>= 0), or -1
// if any entry indexes outside the (nrb*bm, ncb*bn) grid.
int64_t fos_ell_phase1(const int64_t* rows, const int64_t* cols, int64_t nnz,
                       int64_t bm, int64_t bn, int64_t nrb, int64_t ncb,
                       int64_t* perm,     // [nnz]  entries grouped by block
                       int64_t* offs,     // [nrb+1] bucket prefix sum
                       int32_t* slot,     // [nnz]  per-entry tile slot
                       int64_t* counts) { // [nrb]  unique tiles per block
    std::memset(counts, 0, sizeof(int64_t) * nrb);
    std::memset(offs, 0, sizeof(int64_t) * (nrb + 1));
    for (int64_t e = 0; e < nnz; ++e) {
        // guard the RAW indices: C++ division truncates toward zero, so
        // rows[e] in (-bm, 0) would give ti == 0 and slip past a ti-check
        if (rows[e] < 0 || rows[e] >= nrb * bm ||
            cols[e] < 0 || cols[e] >= ncb * bn) return -1;
        ++offs[rows[e] / bm + 1];
    }
    for (int64_t b = 0; b < nrb; ++b) offs[b + 1] += offs[b];
    {
        std::vector<int64_t> cursor(offs, offs + nrb);
        for (int64_t e = 0; e < nnz; ++e)
            perm[cursor[rows[e] / bm]++] = e;
    }

    int nt = nthreads_for(nnz);
    std::vector<int64_t> cut = balance(offs, nrb, nt);
    std::vector<int64_t> maxc(nt, 0);
    auto work = [&](int t) {
        // per-thread scratch: tile-column marks + slot lookup
        std::vector<uint8_t> mark(ncb, 0);
        std::vector<int32_t> slot_of(ncb);
        std::vector<int64_t> touched;
        for (int64_t b = cut[t]; b < cut[t + 1]; ++b) {
            touched.clear();
            for (int64_t p = offs[b]; p < offs[b + 1]; ++p) {
                int64_t tj = cols[perm[p]] / bn;
                if (!mark[tj]) { mark[tj] = 1; touched.push_back(tj); }
            }
            std::sort(touched.begin(), touched.end());
            for (size_t k = 0; k < touched.size(); ++k)
                slot_of[touched[k]] = static_cast<int32_t>(k);
            for (int64_t p = offs[b]; p < offs[b + 1]; ++p) {
                int64_t e = perm[p];
                slot[e] = slot_of[cols[e] / bn];
            }
            for (int64_t tj : touched) mark[tj] = 0;
            counts[b] = static_cast<int64_t>(touched.size());
            if (counts[b] > maxc[t]) maxc[t] = counts[b];
        }
    };
    if (nt == 1) {
        work(0);
    } else {
        std::vector<std::thread> ts;
        for (int t = 0; t < nt; ++t) ts.emplace_back(work, t);
        for (auto& th : ts) th.join();
    }
    return *std::max_element(maxc.begin(), maxc.end());
}

// Scatter values into the zero-initialised ELL tables.  Threads own
// disjoint row-block ranges, so blocks/cols_tab writes never race.
// Duplicate (row, col) entries SUM (BCOO semantics).
void fos_ell_fill(const int64_t* rows, const int64_t* cols,
                  const float* vals, const int64_t* perm,
                  const int64_t* offs, const int32_t* slot,
                  int64_t nrb, int64_t bm, int64_t bn, int64_t kmax,
                  float* blocks,       // [nrb*kmax*bm*bn] zeroed
                  int32_t* cols_tab) { // [nrb*kmax]       zeroed
    int nt = nthreads_for(offs[nrb]);
    std::vector<int64_t> cut = balance(offs, nrb, nt);
    auto work = [&](int t) {
        for (int64_t b = cut[t]; b < cut[t + 1]; ++b) {
            for (int64_t p = offs[b]; p < offs[b + 1]; ++p) {
                int64_t e = perm[p];
                int64_t tj = cols[e] / bn;
                int64_t k = slot[e];
                cols_tab[b * kmax + k] = static_cast<int32_t>(tj);
                blocks[((b * kmax + k) * bm + (rows[e] - b * bm)) * bn +
                       (cols[e] - tj * bn)] += vals[e];
            }
        }
    };
    if (nt == 1) {
        work(0);
    } else {
        std::vector<std::thread> ts;
        for (int t = 0; t < nt; ++t) ts.emplace_back(work, t);
        for (auto& th : ts) th.join();
    }
}

// Per-row-block window starts for the banded layout.  Returns the max
// window width S (>= 1 even when empty, matching _build_band_arrays), or
// -1 on an out-of-grid entry.
int64_t fos_band_phase1(const int64_t* rows, const int64_t* cols,
                        int64_t nnz, int64_t bm, int64_t bn, int64_t nrb,
                        int64_t ncb,
                        int64_t* lo) {  // [nrb] window starts (0 if empty)
    std::vector<int64_t> hi(nrb, -1);
    for (int64_t b = 0; b < nrb; ++b) lo[b] = INT64_MAX;
    for (int64_t e = 0; e < nnz; ++e) {
        // raw-index guard: see fos_ell_phase1 (truncating division)
        if (rows[e] < 0 || rows[e] >= nrb * bm ||
            cols[e] < 0 || cols[e] >= ncb * bn) return -1;
        int64_t ti = rows[e] / bm, tj = cols[e] / bn;
        if (tj < lo[ti]) lo[ti] = tj;
        if (tj > hi[ti]) hi[ti] = tj;
    }
    int64_t S = 1;
    for (int64_t b = 0; b < nrb; ++b) {
        if (hi[b] >= 0) {
            if (hi[b] - lo[b] + 1 > S) S = hi[b] - lo[b] + 1;
        } else {
            lo[b] = 0;
        }
    }
    return S;
}

// Scatter into the zero-initialised (nrb, S, bm, bn) band table.  Serial:
// entries of one row block may arrive from anywhere in the input (the
// transpose build is unsorted), so parallelism would need the bucket pass;
// the band fill is one add per entry and runs at memory bandwidth anyway.
void fos_band_fill(const int64_t* rows, const int64_t* cols,
                   const float* vals, int64_t nnz, int64_t bm, int64_t bn,
                   int64_t S, const int64_t* lo,
                   float* blocks) {  // [nrb*S*bm*bn] zeroed
    for (int64_t e = 0; e < nnz; ++e) {
        int64_t ti = rows[e] / bm, tj = cols[e] / bn;
        blocks[((ti * S + (tj - lo[ti])) * bm + (rows[e] - ti * bm)) * bn +
               (cols[e] - tj * bn)] += vals[e];
    }
}

// The tile statistics of a COO matrix on an (nrb, ncb) grid of (bm, bn)
// tiles, for A's row blocks and for A''s (A's column blocks), from one pass
// over the entries that marks each occupied tile in a bitmap:
//   out[0] = the widest window of tile columns one row block spans
//            (hi - lo + 1, at least 1), out[1] = the most distinct tiles of
//            one row block; out[2], out[3] the same over column blocks.
// Returns 0, -1 on an out-of-grid entry, or -2 when the bitmap would take
// more than kMaxStatsBytes (the caller then counts another way).
constexpr int64_t kMaxStatsBytes = int64_t(1) << 28;

int64_t fos_tile_stats(const int64_t* rows, const int64_t* cols, int64_t nnz,
                       int64_t bm, int64_t bn, int64_t nrb, int64_t ncb,
                       int64_t* out) {  // [4]
    const int64_t stride = (ncb + 63) / 64;   // 64-bit words per row block
    if (nrb * stride * 8 > kMaxStatsBytes) return -2;
    std::vector<uint64_t> bits(nrb * stride, 0);
    std::vector<int64_t> lo(nrb, INT64_MAX), hi(nrb, -1);
    std::vector<int64_t> lo_t(ncb, INT64_MAX), hi_t(ncb, -1);
    for (int64_t e = 0; e < nnz; ++e) {
        // raw-index guard: see fos_ell_phase1 (truncating division)
        if (rows[e] < 0 || rows[e] >= nrb * bm ||
            cols[e] < 0 || cols[e] >= ncb * bn) return -1;
        int64_t ti = rows[e] / bm, tj = cols[e] / bn;
        bits[ti * stride + tj / 64] |= uint64_t(1) << (tj % 64);
        if (tj < lo[ti]) lo[ti] = tj;
        if (tj > hi[ti]) hi[ti] = tj;
        if (ti < lo_t[tj]) lo_t[tj] = ti;
        if (ti > hi_t[tj]) hi_t[tj] = ti;
    }
    std::vector<int64_t> per_col(ncb, 0);
    int64_t span = 1, most = 0, span_t = 1, most_t = 0;
    for (int64_t ti = 0; ti < nrb; ++ti) {
        int64_t k = 0;
        for (int64_t w = 0; w < stride; ++w) {
            for (uint64_t word = bits[ti * stride + w]; word; word &= word - 1) {
                ++per_col[w * 64 + __builtin_ctzll(word)];
                ++k;
            }
        }
        if (k > most) most = k;
        if (hi[ti] >= 0 && hi[ti] - lo[ti] + 1 > span) span = hi[ti] - lo[ti] + 1;
    }
    for (int64_t tj = 0; tj < ncb; ++tj) {
        if (per_col[tj] > most_t) most_t = per_col[tj];
        if (hi_t[tj] >= 0 && hi_t[tj] - lo_t[tj] + 1 > span_t)
            span_t = hi_t[tj] - lo_t[tj] + 1;
    }
    out[0] = span;
    out[1] = most;
    out[2] = span_t;
    out[3] = most_t;
    return 0;
}

}  // extern "C"
