// alias_build_batched: positional split-and-pack alias construction, one
// block per row of a (B, n) weight stack.
//
// Replaces the TPU kernel repro/kernels/alias_build.py `alias_build_batched`
// (row core `alias_split_pack_rows`). Per row:
//   wsum = sum(w); npi = (w / wsum) * n (rounded divide, rounded multiply:
//   no FMA contraction); light = npi < 1;
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
// The TPU walks whole rows in VMEM. Here one block owns a row: a reduction
// pass for the sum, a tile loop (1024 cells, 4 a thread) that scans both
// tapes with the sum carried across tiles in registers (as cdf_scan.cu
// does) and pins them with a max scan, then one thread per cell runs the
// three binary searches. The per-cell terms are float32 as in the JAX
// core, but the tapes (and the debts taken from them) are float64: in
// float32 the tapes of a 65536-cell row reach ~4e4, where an ulp is ~4e-3,
// and ties between rounded tape values misroute whole light cells (mass off
// by up to 1 per cell, the JAX core included). D and S live in shared
// memory for rows of up to RT_ALIAS_SMEM_N = 2048 cells (32 KB); longer
// rows (up to 65536 in the pool, 1 MB) use a global scratch that the
// wrapper allocates and that stays in the 50 MB L2 while the block works.
// The sums are taken in another order than torch.cumsum, so the bits agree
// with the plain version where every partial sum is exact (dyadic weights,
// where both equal the JAX core); every row is valid and conserves mass.
// Bound on the H100: bytes, 12 B a cell (weight in, q and alias out); the
// searches read the row's tapes from shared memory or L2.
#include "common.cuh"

#define AB_THREADS 256
#define AB_ITEMS 4
#define AB_TILE (AB_THREADS * AB_ITEMS)
#define AB_WARPS (AB_THREADS / 32)
#define RT_ALIAS_SMEM_N 2048

struct SumOp {
    __device__ __forceinline__ double operator()(double a, double b) const { return a + b; }
};
struct MaxOp {
    __device__ __forceinline__ double operator()(double a, double b) const { return fmax(a, b); }
};

// Inclusive block scan of AB_ITEMS consecutive items a thread. Returns the
// block total; v[] becomes carry (op) inclusive prefix. sh holds AB_WARPS
// values; the caller syncs before sh is reused.
template <class Op>
__device__ __forceinline__ double block_scan(double (&v)[AB_ITEMS], double carry,
                                             double ident, double* sh, Op op) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 1; k < AB_ITEMS; ++k) v[k] = op(v[k - 1], v[k]);
    double incl = v[AB_ITEMS - 1];
    for (int o = 1; o < 32; o <<= 1) {
        double u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl = op(u, incl);
    }
    double excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 31) sh[warp] = incl;
    __syncthreads();
    double pre = ident, total = ident;
    for (int w = 0; w < AB_WARPS; ++w) {
        if (w == warp) pre = total;
        total = op(total, sh[w]);
    }
    if (lane > 0) pre = op(pre, excl);
#pragma unroll
    for (int k = 0; k < AB_ITEMS; ++k) v[k] = op(carry, op(pre, v[k]));
    return total;
}

__device__ __forceinline__ float npi_of(float w, float wsum, int n) {
    return __fmul_rn(__fdiv_rn(w, wsum), (float)n);
}

// First position in [0, n] with a[p] > v (strict) or a[p] >= v.
template <bool STRICT>
__device__ __forceinline__ int search(const double* a, double v, int n) {
    int lo = 0, hi = n;
    while (lo < hi) {
        int mid = (lo + hi) >> 1;
        bool right = STRICT ? a[mid] <= v : a[mid] < v;
        if (right) lo = mid + 1; else hi = mid;
    }
    return lo;
}

__global__ void alias_build_kernel(const float* __restrict__ w_all,
                                   float* __restrict__ q_all,
                                   int* __restrict__ alias_all,
                                   double* __restrict__ scratch, int n) {
    extern __shared__ double tapes_smem[];
    __shared__ double sh[4][AB_WARPS];
    __shared__ float red[AB_WARPS];
    __shared__ int red_i[AB_WARPS];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long off = (long long)blockIdx.x * n;
    const float* w = w_all + off;
    double* D = scratch ? scratch + 2 * off : tapes_smem;
    double* S = D + n;
    const double NINF = -INFINITY;

    // Pass 1: the row sum.
    float s = 0.0f;
    for (int i = tid; i < n; i += AB_THREADS) s += w[i];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) red[warp] = s;
    __syncthreads();
    float wsum = red[0];
    for (int k = 1; k < AB_WARPS; ++k) wsum += red[k];

    // Pass 2: demand and supply tapes, positional, pinned.
    double cD = 0.0, cS = 0.0, mD = NINF, mS = NINF;
    int any_light = 0, any_heavy = 0, last_heavy = -1;
    for (int t0 = 0; t0 < n; t0 += AB_TILE) {
        const int base = t0 + tid * AB_ITEMS;
        float dv[AB_ITEMS], sv[AB_ITEMS];
        double d[AB_ITEMS], sp[AB_ITEMS];
        bool lt[AB_ITEMS], in[AB_ITEMS];
#pragma unroll
        for (int k = 0; k < AB_ITEMS; ++k) {
            in[k] = base + k < n;
            float p = in[k] ? npi_of(w[base + k], wsum, n) : 1.0f;
            lt[k] = p < 1.0f;
            dv[k] = in[k] && lt[k] ? __fsub_rn(1.0f, p) : 0.0f;
            sv[k] = in[k] && !lt[k] ? __fsub_rn(p, 1.0f) : 0.0f;
            d[k] = dv[k];
            sp[k] = sv[k];
            if (in[k]) {
                any_light |= lt[k];
                any_heavy |= !lt[k];
                if (!lt[k]) last_heavy = base + k;
            }
        }
        double tD = block_scan(d, cD, 0.0, sh[0], SumOp());
        double tS = block_scan(sp, cS, 0.0, sh[1], SumOp());
#pragma unroll
        for (int k = 0; k < AB_ITEMS; ++k) {
            d[k] = in[k] && lt[k] ? d[k] : NINF;
            sp[k] = in[k] && !lt[k] ? sp[k] : NINF;
        }
        double xD = block_scan(d, mD, NINF, sh[2], MaxOp());
        double xS = block_scan(sp, mS, NINF, sh[3], MaxOp());
#pragma unroll
        for (int k = 0; k < AB_ITEMS; ++k) {
            if (in[k]) { D[base + k] = d[k]; S[base + k] = sp[k]; }
        }
        cD = cD + tD;
        cS = cS + tS;
        mD = fmax(mD, xD);
        mS = fmax(mS, xS);
        __syncthreads();  // sh is reused by the next tile
    }
    any_light = __syncthreads_or(any_light);
    any_heavy = __syncthreads_or(any_heavy);
    for (int o = 16; o > 0; o >>= 1)
        last_heavy = max(last_heavy, __shfl_xor_sync(0xffffffffu, last_heavy, o));
    if (lane == 0) red_i[warp] = last_heavy;
    __syncthreads();
    last_heavy = 0;
    for (int k = 0; k < AB_WARPS; ++k) last_heavy = max(last_heavy, red_i[k]);
    const bool has_both = any_light && any_heavy;
    const double total = fmin(D[n - 1], S[n - 1]);

    // Pass 3: one cell a thread, the three searches.
    float* q = q_all + off;
    int* alias = alias_all + off;
    for (int i = tid; i < n; i += AB_THREADS) {
        if (!has_both) { q[i] = 1.0f; alias[i] = i; continue; }
        float p = npi_of(w[i], wsum, n);
        if (p < 1.0f) {
            double v = D[i] - (double)__fsub_rn(1.0f, p);
            int pl = search<true>(S, v, n);
            q[i] = p;
            alias[i] = pl < n ? pl : last_heavy;
        } else {
            float sv = __fsub_rn(p, 1.0f);
            double x = S[i];
            int pj = search<false>(D, x, n);
            bool inside = pj < n && x < total && sv > 0.0f;
            double debt = inside ? D[min(pj, n - 1)] - x : 0.0;
            debt = fmin(fmax(debt, 0.0), 1.0);
            int pn = search<true>(S, x, n);
            q[i] = __double2float_rn(1.0 - debt);
            alias[i] = debt > 0.0 ? (pn < n ? pn : last_heavy) : i;
        }
    }
}

RT_API int rt_alias_build(const void* w, void* q, void* alias, void* scratch,
                          int B, int n, void* stream) {
    size_t smem = scratch ? 0 : 2 * (size_t)n * sizeof(double);
    alias_build_kernel<<<B, AB_THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)w, (float*)q, (int*)alias, (double*)scratch, n);
    return (int)cudaGetLastError();
}

RT_API int rt_alias_smem_max_n() { return RT_ALIAS_SMEM_N; }
