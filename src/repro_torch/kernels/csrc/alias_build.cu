// alias_build_batched: positional split-and-pack alias construction over a
// (B, n) weight stack, each row spread over tiles of 2048 cells, one block
// a tile.
//
// Replaces the TPU kernel repro/kernels/alias_build.py `alias_build_batched`
// (row core `alias_split_pack_rows`). Per row:
//   wsum = sum(w) (float32; summed here in float64 and rounded once, so it
//   is within an ulp of the true sum and the float32 n*p of a row sum to n
//   within the tolerance of ROADMAP C6); npi = (w / wsum) * n (rounded
//   divide, rounded multiply: no FMA contraction); light = npi < 1;
//   D = cumsum(light ? 1 - npi : 0), S = cumsum(light ? 0 : npi - 1),
//   each pinned by a running max over its members only (-inf elsewhere),
//   so the tapes are bit-flat between member cells;
//   lights: q = npi, alias = first position with S > D - dv, else the last
//   heavy;
//   heavies: x = S; pj = first position with D >= x; a heavy whose supply
//   ends strictly inside the demand (pj < n, x < min(D[-1], S[-1]),
//   surplus > 0) owes debt = clamp(D[pj] - x, 0, 1) to the first position
//   with S > x (else the last heavy): q = 1 - debt, alias = that heavy or
//   itself;
//   rows without both lights and heavies: the identity table.
// The per-cell terms are float32 as in the JAX core; the tapes (and the
// debts taken from them) are float64: in float32 the tapes of a
// 65536-cell row reach ~4e4, where an ulp is ~4e-3, and ties between
// rounded tape values misroute whole light cells (ROADMAP C6).
//
// The TPU walks a whole row in VMEM. Here a row of more than one tile is
// cut into T = ceil(n / 2048) tiles, and each step is one launch of B * T
// blocks of 256 threads (a 65536-cell row fills 32 SMs, not one):
//   1. partials: each tile's float64 sum of w;
//   2. records: each block sums the row's partials in tile order into
//      wsum, scans its tile's demand and supply terms from 0 (8
//      consecutive cells a thread, warp shuffles, the 8 warps in order),
//      and records the local prefix at its last cell, the largest local
//      prefix of a member cell, whether it holds lights and heavies, and
//      its last heavy;
//   3. tapes: each block takes its carries as sums of the preceding tiles'
//      records in tile order (c_t = (..(r_0 + r_1) + ..) + r_{t-1}) and the
//      pin carried in as max over k < t of fl(c_k + member max_k) (fl(c + .)
//      is monotone, so that is the running max at the tile's start),
//      rescans its tile, and writes D = fl(c_t + local), pinned by a max
//      scan, into the (B, 2, n) float64 scratch;
//   4. search: every search result is monotone in its query, so the
//      tile's least and largest query bound the positions each of its
//      three searches can reach (lights: D - dv into S, strict; heavies: S
//      into D, non-strict, and S into S, strict). The block finds the six
//      bounds together, each round testing 256 evenly spaced positions of
//      every range at once (two rounds for 65536 cells, where one thread
//      would chain 17 dependent loads), stages the D window and the S
//      window (the union of the lights' and the heavies', searched in one
//      pass) in shared memory (8192 entries, 64 KB, together) and searches
//      there, 8 cells a thread interleaved and branch-free; a window that
//      does not fit is searched in place, in device memory. S is flat after
//      the row's last heavy, so an S window stops there; a query that finds
//      nothing in its window lands on the answer of the tile's largest
//      query. Either way a search returns the full-row search's position.
// There is no decoupled look-back and there are no float atomics: a block
// that combined whichever predecessors happened to be ready would sum in a
// varying order. Every sum here has a fixed order that depends on n alone,
// so a row's table is a function of the row and n: bit-equal from run to
// run, and whether the row is built alone or inside a stack. Weights are
// read and tapes written through shared memory, so device memory sees
// whole lines.
// A row of up to one tile is built by one block in one launch, its tapes in
// shared memory: the float64 sum, a scan 1024 cells a step, then binary
// searches over the whole tapes, one cell at a time where a thread has at
// most two cells, else interleaved as in step 4 (no window needed).
// The sums are taken in another order than torch.cumsum, so the bits agree
// with the plain version where every partial sum is exact (dyadic weights,
// where both equal the JAX core); every row is valid and conserves mass.
// Bound on the H100: bytes, 12 B a cell (weight in, q and alias out). The
// steps move more: w is read four times (16 B), the tapes are written and
// read back (16 B, plus the windows), q and alias written (8 B).
#include "common.cuh"

#define AB_THREADS 256
#define AB_ITEMS 8
#define AB_TILE (AB_THREADS * AB_ITEMS)  // 2048 cells a tile
#define AB_WARPS (AB_THREADS / 32)
#define AB_SCAN_SH (4 * AB_WARPS)  // doubles: the buffers of four block scans in turn
#define AB_ROW_ITEMS 4
#define AB_ROW_CHUNK (AB_THREADS * AB_ROW_ITEMS)  // cells a scan step of a one-tile row
#define AB_WIN 8192                       // tape entries staged for the searches
#define AB_REC 8                          // doubles of a tile's record
#define AB_RCHUNK 64                      // records staged in shared memory at once
#define FULL_MASK 0xffffffffu

// Fields of a tile's record in the scratch.
enum { R_WPART = 0, R_DSUM, R_SSUM, R_DMAX, R_SMAX, R_LIGHT, R_HEAVY, R_LAST };

struct SumOp {
    __device__ __forceinline__ double operator()(double a, double b) const { return a + b; }
};
struct MaxOp {
    __device__ __forceinline__ double operator()(double a, double b) const { return fmax(a, b); }
};

// Block-wide reduction in a fixed order (a butterfly over the warp, then
// the warps in order); every thread gets the result. sh holds AB_WARPS
// values and may be reused right after (SYNC: a barrier first, so sh may
// be one that the block still reads).
template <bool SYNC = true, class Op>
__device__ __forceinline__ double block_reduce(double v, double* sh, Op op) {
    for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(FULL_MASK, v, o));
    if (SYNC) __syncthreads();
    if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
    __syncthreads();
    double r = sh[0];
    for (int k = 1; k < AB_WARPS; ++k) r = op(r, sh[k]);
    return r;
}

// Inclusive block scan of N consecutive items a thread. v[] becomes carry
// (op) inclusive prefix; returns the block's total without the carry. sh
// holds AB_WARPS values and is written before any barrier, so it must not
// be one that a scan or reduction in progress still reads: consecutive
// scans take turns over four buffers (each scan's barrier orders the reads
// of the one before it), and block_reduce syncs first.
template <int N, class Op>
__device__ __forceinline__ double block_scan(double (&v)[N], double carry, double ident,
                                             double* sh, Op op) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 1; k < N; ++k) v[k] = op(v[k - 1], v[k]);
    double incl = v[N - 1];
    for (int o = 1; o < 32; o <<= 1) {
        double u = __shfl_up_sync(FULL_MASK, incl, o);
        if (lane >= o) incl = op(u, incl);
    }
    double excl = __shfl_up_sync(FULL_MASK, incl, 1);
    if (lane == 31) sh[warp] = incl;
    __syncthreads();
    double pre = ident, total = ident;
    for (int w = 0; w < AB_WARPS; ++w) {
        if (w == warp) pre = total;
        total = op(total, sh[w]);
    }
    if (lane > 0) pre = op(pre, excl);
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = op(carry, op(pre, v[k]));
    return total;
}

__device__ __forceinline__ float npi_of(float w, float wsum, int n) {
    return __fmul_rn(__fdiv_rn(w, wsum), (float)n);
}

// float64 sum of a tile's cnt weights (in device or shared memory): each
// thread its cells tid, tid + 256, ... in order, then block_reduce.
__device__ __forceinline__ double tile_wsum(const float* w, int cnt, double* sh) {
    double s = 0.0;
#pragma unroll
    for (int k = 0; k < AB_ITEMS; ++k) {
        const int j = k * AB_THREADS + threadIdx.x;
        const double x = w[min(j, cnt - 1)];
        s += j < cnt ? x : 0.0;
    }
    return block_reduce(s, sh, SumOp());
}

// What a block needs of its row's records, read in tile order through
// shared memory (sh, AB_RCHUNK records at a time): the float32 wsum (the
// partials summed in float64, rounded once); with FULL (the records are
// complete), the carries and pins into tile t, whether the row has lights
// and heavies, and its last heavy.
struct RowInfo {
    float wsum;
    double cD, cS, mD, mS;
    bool any_l, any_h;
    int last_heavy;
};

template <bool FULL>
__device__ __forceinline__ RowInfo row_info(const double* rec, int tiles, int t, double* sh) {
    const int words = FULL ? AB_REC : 1;
    double ws = 0.0;
    RowInfo r{0.0f, 0.0, 0.0, -INFINITY, -INFINITY, false, false, -1};
    for (int k0 = 0; k0 < tiles; k0 += AB_RCHUNK) {
        const int m = min(AB_RCHUNK, tiles - k0);
        __syncthreads();
        for (int i = threadIdx.x; i < m * words; i += AB_THREADS)
            sh[i] = rec[(k0 + i / words) * AB_REC + (FULL ? i % words : R_WPART)];
        __syncthreads();
        for (int k = 0; k < m; ++k) {
            const double* x = sh + k * words;
            ws += x[FULL ? R_WPART : 0];
            if (!FULL) continue;
            r.any_l |= x[R_LIGHT] != 0.0;
            r.any_h |= x[R_HEAVY] != 0.0;
            r.last_heavy = max(r.last_heavy, (int)x[R_LAST]);
            if (k0 + k < t) {
                r.mD = fmax(r.mD, r.cD + x[R_DMAX]);
                r.mS = fmax(r.mS, r.cS + x[R_SMAX]);
                r.cD = r.cD + x[R_DSUM];
                r.cS = r.cS + x[R_SSUM];
            }
        }
    }
    r.wsum = __double2float_rn(ws);
    return r;
}

// Copies a tile's cnt weights into shared memory in whole lines.
__device__ __forceinline__ void load_tile(const float* w, int cnt, float* sw) {
    float x[AB_ITEMS];
#pragma unroll
    for (int k = 0; k < AB_ITEMS; ++k) x[k] = w[min(k * AB_THREADS + (int)threadIdx.x, cnt - 1)];
#pragma unroll
    for (int k = 0; k < AB_ITEMS; ++k) {
        const int j = k * AB_THREADS + threadIdx.x;
        if (j < cnt) sw[j] = x[k];
    }
    __syncthreads();
}

// The demand and supply terms of a thread's AB_ITEMS consecutive cells of
// a tile, from the tile's weights in shared memory (cells at or past cnt:
// zero terms, members of neither tape), and their local inclusive scans
// from 0 (in the first two of sh's AB_SCAN_SH buffers).
struct TileScan {
    double d[AB_ITEMS], s[AB_ITEMS];
    bool light[AB_ITEMS], in[AB_ITEMS];
};

__device__ __forceinline__ void tile_scan(TileScan& ts, const float* sw, int cnt, float wsum,
                                          int n, double* sh) {
    const int base = threadIdx.x * AB_ITEMS;
#pragma unroll
    for (int k = 0; k < AB_ITEMS; ++k) {
        ts.in[k] = base + k < cnt;
        const float p = ts.in[k] ? npi_of(sw[base + k], wsum, n) : 1.0f;
        ts.light[k] = p < 1.0f;
        ts.d[k] = ts.in[k] && ts.light[k] ? (double)__fsub_rn(1.0f, p) : 0.0;
        ts.s[k] = ts.in[k] && !ts.light[k] ? (double)__fsub_rn(p, 1.0f) : 0.0;
    }
    block_scan(ts.d, 0.0, 0.0, sh, SumOp());
    block_scan(ts.s, 0.0, 0.0, sh + AB_WARPS, SumOp());
}

// The pinned tapes of a tile: member values fl(carry + local), -inf
// elsewhere, max-scanned from the pin carried in (in the last two of sh's
// buffers), written to sD, sS (shared memory) at the tile's cells.
__device__ __forceinline__ void tile_tapes(TileScan& ts, double cD, double cS, double mD,
                                           double mS, double* sD, double* sS, double* sh) {
    const double NINF = -INFINITY;
#pragma unroll
    for (int k = 0; k < AB_ITEMS; ++k) {
        ts.d[k] = ts.in[k] && ts.light[k] ? cD + ts.d[k] : NINF;
        ts.s[k] = ts.in[k] && !ts.light[k] ? cS + ts.s[k] : NINF;
    }
    block_scan(ts.d, mD, NINF, sh + 2 * AB_WARPS, MaxOp());
    block_scan(ts.s, mS, NINF, sh + 3 * AB_WARPS, MaxOp());
    const int base = threadIdx.x * AB_ITEMS;
#pragma unroll
    for (int k = 0; k < AB_ITEMS; ++k) {
        if (ts.in[k]) { sD[base + k] = ts.d[k]; sS[base + k] = ts.s[k]; }
    }
}

// A window of a tape: positions [lo, hi), position p at t[p - base].
struct Win {
    const double* t;
    int base, lo, hi;
};

// The searches of a thread's cells (those in act) in one window,
// interleaved and branch-free: the steps depend on the window's length
// alone, and every searching cell loads at every step (clamped into the
// window), so the loads of one step are all in flight together. res: the
// first position in [w.lo, w.hi) that passes, or w.hi.
template <bool STRICT>
__device__ __forceinline__ void win_search(const Win& w, const double (&v)[AB_ITEMS],
                                           const bool (&act)[AB_ITEMS], int (&res)[AB_ITEMS]) {
    int pos[AB_ITEMS];  // every position up to pos is left of the answer
#pragma unroll
    for (int k = 0; k < AB_ITEMS; ++k) pos[k] = w.lo - 1;
    const int len = w.hi - w.lo;
    for (int step = len > 0 ? 1 << (31 - __clz(len)) : 0; step > 0; step >>= 1) {
        double x[AB_ITEMS];
#pragma unroll
        for (int k = 0; k < AB_ITEMS; ++k)
            x[k] = act[k] ? w.t[min(pos[k] + step, w.hi - 1) - w.base] : 0.0;
#pragma unroll
        for (int k = 0; k < AB_ITEMS; ++k) {
            const bool left = pos[k] + step < w.hi && (STRICT ? x[k] <= v[k] : x[k] < v[k]);
            pos[k] = left ? pos[k] + step : pos[k];
        }
    }
#pragma unroll
    for (int k = 0; k < AB_ITEMS; ++k) res[k] = pos[k] + 1;
}

// Six searches over whole tapes by the whole block: query i asks for the
// first position p in [lo[i], hi[i]) with t_i[p] > v[i] (strict[i]) or
// >= v[i], hi[i] if none, and gets it in lo[i]. Each round every thread
// tests one of 256 evenly spaced positions of every live range, and the
// count left of the answer cuts the range by 256. Every thread gets the
// results.
#define AB_NQ 6
__device__ __forceinline__ void block_search(const double* const (&t)[AB_NQ],
                                             const double (&v)[AB_NQ],
                                             const bool (&strict)[AB_NQ], int (&lo)[AB_NQ],
                                             int (&hi)[AB_NQ]) {
    for (;;) {
        bool live = false;
#pragma unroll
        for (int i = 0; i < AB_NQ; ++i) live |= lo[i] < hi[i];
        if (!live) return;
        int step[AB_NQ];
        bool left[AB_NQ];
#pragma unroll
        for (int i = 0; i < AB_NQ; ++i) {
            step[i] = (hi[i] - lo[i] + AB_THREADS - 1) / AB_THREADS;
            const int p = lo[i] + threadIdx.x * step[i];
            const double x = t[i][max(min(p, hi[i] - 1), 0)];
            left[i] = p < hi[i] && (strict[i] ? x <= v[i] : x < v[i]);
        }
#pragma unroll
        for (int i = 0; i < AB_NQ; ++i) {
            const int c = __syncthreads_count(left[i]);
            if (lo[i] >= hi[i]) continue;
            if (c == 0) {
                hi[i] = lo[i];
            } else {
                const int next = lo[i] + c * step[i];  // the first sample right of the answer
                lo[i] = next - step[i] + 1;
                hi[i] = min(hi[i], next);
            }
        }
    }
}

// The per-cell state of the search step: each thread's cells
// tid, tid + 256, ... of the tile.
struct Cells {
    float p[AB_ITEMS];
    double qv[AB_ITEMS];    // lights: D - dv; heavies: S
    double debt[AB_ITEMS];
    bool light[AB_ITEMS], heavy[AB_ITEMS];
};

// The three searches of a tile's cells and their packed (q, alias), in two
// passes. D and S are the row's tapes. WINDOWED: they lie in device
// memory, and the searches run in windows staged in buf (or in place where
// a window does not fit); otherwise they lie in shared memory and are
// searched whole.
template <bool WINDOWED>
__device__ __forceinline__ void tile_search(const float* w, int i0, int cnt, float wsum,
                                            int n, const double* D, const double* S,
                                            int last_heavy, float* q, int* alias,
                                            double* buf, double* sh) {
    const double INF = INFINITY;
    const double total = fmin(D[n - 1], S[n - 1]);
    const int flat = last_heavy + 1;  // S is flat from here on
    Cells c;
    double vmin = INF, vmax = -INF, xmin = INF, xmax = -INF;
#pragma unroll
    for (int k = 0; k < AB_ITEMS; ++k) {
        const int j = k * AB_THREADS + threadIdx.x, jc = min(j, cnt - 1);
        c.p[k] = npi_of(w[jc], wsum, n);
        c.light[k] = j < cnt && c.p[k] < 1.0f;
        c.heavy[k] = j < cnt && !(c.p[k] < 1.0f);
        c.debt[k] = 0.0;
    }
#pragma unroll
    for (int k = 0; k < AB_ITEMS; ++k) {
        const int jc = min(k * AB_THREADS + (int)threadIdx.x, cnt - 1);
        const double x = (c.p[k] < 1.0f ? D : S)[i0 + jc];
        c.qv[k] = c.light[k] ? x - (double)__fsub_rn(1.0f, c.p[k]) : x;
        if (c.light[k]) { vmin = fmin(vmin, c.qv[k]); vmax = fmax(vmax, c.qv[k]); }
        if (c.heavy[k]) { xmin = fmin(xmin, c.qv[k]); xmax = fmax(xmax, c.qv[k]); }
    }
    // One strict search into S serves the lights (D - dv) and the heavies
    // (S, for the next heavy); one non-strict search into D the heavies'
    // debts. A search that finds nothing in its window lands on its end.
    Win ws{S, 0, 0, flat}, wd{D, 0, 0, n};
    int end_l = n, end_h = n;
    if (WINDOWED) {
        vmin = -block_reduce(-vmin, sh, MaxOp());
        vmax = block_reduce(vmax, sh, MaxOp());
        xmin = -block_reduce(-xmin, sh, MaxOp());
        xmax = block_reduce(xmax, sh, MaxOp());
        const bool has_l = vmin <= vmax, has_h = xmin <= xmax;
        const double* const tq[AB_NQ] = {S, S, D, D, S, S};
        const double vq[AB_NQ] = {vmin, vmax, xmin, xmax, xmin, xmax};
        const bool sq[AB_NQ] = {true, true, false, false, true, true};
        int lo[AB_NQ], hi[AB_NQ];
#pragma unroll
        for (int i = 0; i < AB_NQ; ++i) {
            lo[i] = 0;
            hi[i] = (i < 2 ? has_l : has_h) ? n : 0;
        }
        block_search(tq, vq, sq, lo, hi);
        // The S window is the union of the lights' and the heavies' (each
        // stopped where S turns flat); each keeps its own end.
        end_l = lo[1];
        end_h = lo[5];
        const int ls = has_l ? lo[0] : n, hs = has_h ? lo[4] : n;
        const int le = has_l ? max(lo[0], min(lo[1], flat)) : 0;
        const int he = has_h ? max(lo[4], min(lo[5], flat)) : 0;
        const int s_lo = min(ls, hs), s_hi = max(s_lo, max(le, he));
        ws = Win{S, 0, s_lo, s_hi};
        wd = Win{D, 0, lo[2], has_h ? lo[3] : lo[2]};
        const int s_len = s_hi - s_lo, d_len = wd.hi - wd.lo;
        const bool s_in = s_len <= AB_WIN, d_in = d_len <= AB_WIN - (s_in ? s_len : 0);
        double* dbuf = buf + (s_in ? s_len : 0);
        if (s_in) {
            for (int i = threadIdx.x; i < s_len; i += AB_THREADS) buf[i] = S[s_lo + i];
            ws = Win{buf, s_lo, s_lo, s_hi};
        }
        if (d_in) {
            for (int i = threadIdx.x; i < d_len; i += AB_THREADS) dbuf[i] = D[wd.lo + i];
            wd = Win{dbuf, wd.lo, wd.lo, wd.hi};
        }
        __syncthreads();
    }
    bool any[AB_ITEMS];
#pragma unroll
    for (int k = 0; k < AB_ITEMS; ++k) any[k] = c.light[k] || c.heavy[k];
    int r[AB_ITEMS];
    win_search<false>(wd, c.qv, c.heavy, r);  // heavies: the debt from D
#pragma unroll
    for (int k = 0; k < AB_ITEMS; ++k) {
        const double x = c.qv[k];
        const int pj = r[k];  // a miss in D's window lands on its end, wd.hi
        if (c.heavy[k] && pj < n && x < total && __fsub_rn(c.p[k], 1.0f) > 0.0f) {
            const double dj = pj < wd.hi ? wd.t[pj - wd.base] : D[pj];
            c.debt[k] = fmin(fmax(dj - x, 0.0), 1.0);
        }
    }
    win_search<true>(ws, c.qv, any, r);  // lights and heavies into S
#pragma unroll
    for (int k = 0; k < AB_ITEMS; ++k) {
        const int j = k * AB_THREADS + threadIdx.x;
        const int hit = r[k] < ws.hi ? r[k] : c.light[k] ? end_l : end_h;
        const int to = hit < n ? hit : last_heavy;
        if (c.light[k]) {
            q[j] = c.p[k];
            alias[j] = to;
        } else if (c.heavy[k]) {
            q[j] = __double2float_rn(1.0 - c.debt[k]);
            alias[j] = c.debt[k] > 0.0 ? to : i0 + j;
        }
    }
}

__device__ __forceinline__ void identity_tile(int i0, int cnt, float* q, int* alias) {
    for (int j = threadIdx.x; j < cnt; j += AB_THREADS) {
        q[j] = 1.0f;
        alias[j] = i0 + j;
    }
}

// First position in [0, n] with a[p] > v (STRICT) or a[p] >= v.
template <bool STRICT>
__device__ __forceinline__ int row_search(const double* a, double v, int n) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (STRICT ? a[mid] <= v : a[mid] < v) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// A row of up to one tile: one block, its tapes in 2n doubles of dynamic
// shared memory. The tapes are scanned AB_ROW_CHUNK cells at a time, the
// carries and pins in registers. Rows of up to two cells a thread then
// search one cell at a time, a binary search over the whole tape each;
// longer rows interleave the searches of a thread's cells (tile_search).
__global__ void __launch_bounds__(AB_THREADS)
alias_build_row(const float* __restrict__ w_all, float* __restrict__ q_all,
                int* __restrict__ alias_all, int n) {
    extern __shared__ double tapes[];
    __shared__ double sh[AB_SCAN_SH + AB_WARPS];  // the scans' buffers, then block_reduce's
    __shared__ int last[AB_WARPS];
    double* red = sh + AB_SCAN_SH;
    const int tid = threadIdx.x;
    const long long off = (long long)blockIdx.x * n;
    const float* w = w_all + off;
    float* q = q_all + off;
    int* alias = alias_all + off;
    double* D = tapes;
    double* S = tapes + n;
    const double NINF = -INFINITY;
    double ws = 0.0;
    for (int i = tid; i < n; i += AB_THREADS) ws += w[i];
    const float wsum = __double2float_rn(block_reduce<false>(ws, red, SumOp()));
    double cD = 0.0, cS = 0.0, mD = NINF, mS = NINF;
    int any_l = 0, any_h = 0, lh = -1;
    for (int t0 = 0; t0 < n; t0 += AB_ROW_CHUNK) {
        const int base = t0 + tid * AB_ROW_ITEMS;
        double d[AB_ROW_ITEMS], s[AB_ROW_ITEMS];
        bool light[AB_ROW_ITEMS], in[AB_ROW_ITEMS];
#pragma unroll
        for (int k = 0; k < AB_ROW_ITEMS; ++k) {
            in[k] = base + k < n;
            const float p = in[k] ? npi_of(w[base + k], wsum, n) : 1.0f;
            light[k] = p < 1.0f;
            d[k] = in[k] && light[k] ? (double)__fsub_rn(1.0f, p) : 0.0;
            s[k] = in[k] && !light[k] ? (double)__fsub_rn(p, 1.0f) : 0.0;
            if (in[k]) {
                any_l |= light[k];
                any_h |= !light[k];
                if (!light[k]) lh = base + k;
            }
        }
        const double tD = block_scan(d, cD, 0.0, sh, SumOp());
        const double tS = block_scan(s, cS, 0.0, sh + AB_WARPS, SumOp());
#pragma unroll
        for (int k = 0; k < AB_ROW_ITEMS; ++k) {
            d[k] = in[k] && light[k] ? d[k] : NINF;
            s[k] = in[k] && !light[k] ? s[k] : NINF;
        }
        const double xD = block_scan(d, mD, NINF, sh + 2 * AB_WARPS, MaxOp());
        const double xS = block_scan(s, mS, NINF, sh + 3 * AB_WARPS, MaxOp());
#pragma unroll
        for (int k = 0; k < AB_ROW_ITEMS; ++k) {
            if (in[k]) { D[base + k] = d[k]; S[base + k] = s[k]; }
        }
        cD = cD + tD;
        cS = cS + tS;
        mD = fmax(mD, xD);
        mS = fmax(mS, xS);
    }
    for (int o = 16; o > 0; o >>= 1) lh = max(lh, __shfl_xor_sync(FULL_MASK, lh, o));
    if ((tid & 31) == 0) last[tid >> 5] = lh;
    any_l = __syncthreads_or(any_l);  // the barriers publish last[] too
    any_h = __syncthreads_or(any_h);
    if (!(any_l && any_h)) {
        identity_tile(0, n, q, alias);
        return;
    }
    for (int k = 0; k < AB_WARPS; ++k) lh = max(lh, last[k]);
    if (n > 2 * AB_THREADS) {
        tile_search<false>(w, 0, n, wsum, n, D, S, lh, q, alias, nullptr, red);
        return;
    }
    const double total = fmin(D[n - 1], S[n - 1]);
    for (int i = tid; i < n; i += AB_THREADS) {
        const float p = npi_of(w[i], wsum, n);
        if (p < 1.0f) {
            const int to = row_search<true>(S, D[i] - (double)__fsub_rn(1.0f, p), n);
            q[i] = p;
            alias[i] = to < n ? to : lh;
        } else {
            const double x = S[i];
            const int pj = row_search<false>(D, x, n);
            const bool inside = pj < n && x < total && __fsub_rn(p, 1.0f) > 0.0f;
            const double debt = inside ? fmin(fmax(D[pj] - x, 0.0), 1.0) : 0.0;
            q[i] = __double2float_rn(1.0 - debt);
            if (debt > 0.0) {
                const int to = row_search<true>(S, x, n);
                alias[i] = to < n ? to : lh;
            } else {
                alias[i] = i;
            }
        }
    }
}

// Step 1: each tile's float64 partial sum of w.
__global__ void __launch_bounds__(AB_THREADS)
alias_build_partials(const float* __restrict__ w_all, double* __restrict__ rec_all,
                     int n, int tiles) {
    __shared__ double sh[AB_WARPS];
    const int row = blockIdx.x / tiles, t = blockIdx.x % tiles;
    const int i0 = t * AB_TILE, cnt = min(AB_TILE, n - i0);
    const double s = tile_wsum(w_all + (long long)row * n + i0, cnt, sh);
    if (threadIdx.x == 0) rec_all[(long long)blockIdx.x * AB_REC + R_WPART] = s;
}

// Step 2: each tile's record: local prefix at its last cell, member
// maxima of the local prefixes, light/heavy flags, last heavy.
__global__ void __launch_bounds__(AB_THREADS)
alias_build_records(const float* __restrict__ w_all, double* __restrict__ rec_all,
                    int n, int tiles) {
    __shared__ double srec[AB_RCHUNK * AB_REC];
    __shared__ float sw[AB_TILE];
    __shared__ double sh[AB_SCAN_SH];
    const int row = blockIdx.x / tiles, t = blockIdx.x % tiles;
    const int i0 = t * AB_TILE, cnt = min(AB_TILE, n - i0);
    double* rec = rec_all + (long long)row * tiles * AB_REC;
    const RowInfo ri = row_info<false>(rec, tiles, 0, srec);
    load_tile(w_all + (long long)row * n + i0, cnt, sw);
    TileScan ts;
    tile_scan(ts, sw, cnt, ri.wsum, n, sh);
    double mD = -INFINITY, mS = -INFINITY;
    int lh = -1, any_l = 0, any_h = 0;
    const int base = threadIdx.x * AB_ITEMS;
#pragma unroll
    for (int k = 0; k < AB_ITEMS; ++k) {
        if (!ts.in[k]) continue;
        if (ts.light[k]) { mD = fmax(mD, ts.d[k]); any_l = 1; }
        else { mS = fmax(mS, ts.s[k]); any_h = 1; lh = i0 + base + k; }
        if (base + k == cnt - 1) {
            rec[t * AB_REC + R_DSUM] = ts.d[k];
            rec[t * AB_REC + R_SSUM] = ts.s[k];
        }
    }
    mD = block_reduce(mD, sh, MaxOp());
    mS = block_reduce(mS, sh, MaxOp());
    const double lhd = block_reduce((double)lh, sh, MaxOp());
    any_l = __syncthreads_or(any_l);
    any_h = __syncthreads_or(any_h);
    if (threadIdx.x == 0) {
        rec[t * AB_REC + R_DMAX] = mD;
        rec[t * AB_REC + R_SMAX] = mS;
        rec[t * AB_REC + R_LIGHT] = any_l;
        rec[t * AB_REC + R_HEAVY] = any_h;
        rec[t * AB_REC + R_LAST] = lhd;
    }
}

// Step 3: carries from the preceding tiles' records in tile order, then
// the tile's pinned tapes into the scratch. At most 64 registers, so four
// blocks share an SM (a full class runs 40 blocks an SM).
__global__ void __launch_bounds__(AB_THREADS, 4)
alias_build_tapes(const float* __restrict__ w_all, const double* __restrict__ rec_all,
                  double* __restrict__ tapes, int n, int tiles) {
    __shared__ double srec[AB_RCHUNK * AB_REC];
    __shared__ double sD[AB_TILE], sS[AB_TILE];
    __shared__ float sw[AB_TILE];
    __shared__ double sh[AB_SCAN_SH];
    const int row = blockIdx.x / tiles, t = blockIdx.x % tiles;
    const int i0 = t * AB_TILE, cnt = min(AB_TILE, n - i0);
    const RowInfo ri = row_info<true>(rec_all + (long long)row * tiles * AB_REC, tiles, t, srec);
    load_tile(w_all + (long long)row * n + i0, cnt, sw);
    TileScan ts;
    tile_scan(ts, sw, cnt, ri.wsum, n, sh);
    tile_tapes(ts, ri.cD, ri.cS, ri.mD, ri.mS, sD, sS, sh);
    __syncthreads();
    double* D = tapes + (long long)row * 2 * n + i0;
    for (int j = threadIdx.x; j < cnt; j += AB_THREADS) {
        D[j] = sD[j];
        D[n + j] = sS[j];
    }
}

// Step 4: the searches of each tile, in windows of the row's tapes. At
// most 80 registers: three blocks an SM, as the 64 KB window allows.
__global__ void __launch_bounds__(AB_THREADS, 3)
alias_build_search(const float* __restrict__ w_all, const double* __restrict__ rec_all,
                   const double* __restrict__ tapes, float* __restrict__ q_all,
                   int* __restrict__ alias_all, int n, int tiles) {
    extern __shared__ double buf[];  // AB_WIN entries
    __shared__ double srec[AB_RCHUNK * AB_REC];
    __shared__ double sh[AB_WARPS];
    const int row = blockIdx.x / tiles, t = blockIdx.x % tiles;
    const int i0 = t * AB_TILE, cnt = min(AB_TILE, n - i0);
    const RowInfo ri = row_info<true>(rec_all + (long long)row * tiles * AB_REC, tiles, 0, srec);
    const long long off = (long long)row * n + i0;
    if (!(ri.any_l && ri.any_h)) {
        identity_tile(i0, cnt, q_all + off, alias_all + off);
        return;
    }
    const double* D = tapes + (long long)row * 2 * n;
    tile_search<true>(w_all + off, i0, cnt, ri.wsum, n, D, D + n, ri.last_heavy, q_all + off,
                      alias_all + off, buf, sh);
}

static int ab_tiles(int n) { return (n + AB_TILE - 1) / AB_TILE; }

// Tiles (blocks) a row of n cells is cut into.
RT_API int rt_alias_tiles(int n) { return ab_tiles(n); }

// float64 words of scratch a row of n cells needs: none for one tile; else
// its tapes, (2, n), and its records, (tiles, AB_REC).
RT_API long long rt_alias_scratch_words(int n) {
    const int tiles = ab_tiles(n);
    return tiles > 1 ? 2LL * n + (long long)AB_REC * tiles : 0;
}

// scratch: B * rt_alias_scratch_words(n) doubles (the tapes of every row,
// then the records of every row), or null for rows of one tile.
RT_API int rt_alias_build(const void* w, void* q, void* alias, void* scratch, int B, int n,
                          void* stream) {
    const int tiles = ab_tiles(n);
    if (B <= 0 || n <= 0 || (tiles > 1 && scratch == nullptr))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const float* wp = (const float*)w;
    float* qp = (float*)q;
    int* ap = (int*)alias;
    if (tiles == 1) {
        alias_build_row<<<B, AB_THREADS, 2 * (size_t)n * sizeof(double), st>>>(wp, qp, ap, n);
        return (int)cudaGetLastError();
    }
    double* tapes = (double*)scratch;
    double* rec = tapes + 2LL * B * n;
    const int grid = B * tiles;
    const int smem = AB_WIN * sizeof(double);
    int err = (int)cudaFuncSetAttribute(alias_build_search,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
    alias_build_partials<<<grid, AB_THREADS, 0, st>>>(wp, rec, n, tiles);
    if ((err = (int)cudaGetLastError())) return err;
    alias_build_records<<<grid, AB_THREADS, 0, st>>>(wp, rec, n, tiles);
    if ((err = (int)cudaGetLastError())) return err;
    alias_build_tapes<<<grid, AB_THREADS, 0, st>>>(wp, rec, tapes, n, tiles);
    if ((err = (int)cudaGetLastError())) return err;
    alias_build_search<<<grid, AB_THREADS, smem, st>>>(wp, rec, tapes, qp, ap, n, tiles);
    return (int)cudaGetLastError();
}
