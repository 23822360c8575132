// forest_sample: Algorithm 2 (guide table + radix-tree descent) over one
// forest, one lane a thread, reading the packed layout of forest_pack.
//
// Replaces the TPU kernel repro/kernels/forest_sample.py `forest_sample`
// (`_forest_kernel`). Per lane:
//   g = clip(floor(xi*m), 0, m-1); j = table[g];
//   in a flagged (degenerate) cell, pre-resolve by the 32-trip bisection of
//   core.sample._bisect over cdf[cell_first[g] .. cell_first[g+1]];
//   then j = xi < cdf[j] ? left[j] : right[j] until j < 0 (at most
//   MAX_DEPTH = 256 trips); output ~j.
// Unlike the TPU kernel's fixed 40 trips, each lane stops at its own leaf,
// so the result equals core.sample.sample_forest elementwise.
//
// Bound on the H100: the rate at which L2 serves scattered 32-byte sectors.
// At n = m = 2^20 the forest fits the 50 MB L2 and lanes share almost no
// sector, so a lane costs one sector a table read: reading the six arrays
// (guide entry; the flag where the cell holds a tree; cdf[j], then the
// chosen child, a level) took ~2.43 sectors a lane, and the old kernel and
// this one both move their sector counts at ~4.8 TB/s (PERF.md). The byte
// floor, 8 B a lane of xi in and index out, is ~5x below.
// Design: forest_pack, run once per forest, writes what a lane reads into
// fewer sectors: guide[g] is table[g] with bit 30 set in a flagged cell, so
// the flag costs no read; nodes[j] = (cdf[j], left[j], right[j], 0) is one
// 16-byte record, so a level costs one sector and one load, not two
// dependent ones: ~1.6 sectors a lane. Table reads carry an L2 evict-last
// policy, the lane's xi and index stream past with evict-first loads and
// stores. Tried and dropped (PERF.md): two and four lanes a thread with
// their loads issued together (slower at every size measured), the cell
// root's record beside its guide entry (a 16 MB guide table; slower).
#include "common.cuh"

#define RT_MAX_DEPTH 256
#define RT_B1_THREADS 256
// Bit 30 of a guide entry j >= 0: the cell is flagged (bisect). Node ids
// are below n < 2^30; leaf entries ~i < 0 are never flagged.
#define RT_FLAG (1 << 30)

// L2 evict-last policy for the forest's tables, so the lane stream does
// not push them out of L2.
__device__ __forceinline__ unsigned long long rt_keep_policy() {
    unsigned long long p;
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
    return p;
}

__device__ __forceinline__ int rt_ld_keep(const int* p, unsigned long long pol) {
    int v;
    asm("ld.global.nc.L2::cache_hint.s32 %0, [%1], %2;" : "=r"(v) : "l"(p), "l"(pol));
    return v;
}

__device__ __forceinline__ int4 rt_ld_keep4(const int4* p, unsigned long long pol) {
    int4 v;
    asm("ld.global.nc.L2::cache_hint.v4.s32 {%0, %1, %2, %3}, [%4], %5;"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
        : "l"(p), "l"(pol));
    return v;
}

__global__ void __launch_bounds__(RT_B1_THREADS) forest_sample_kernel(
    const int* __restrict__ guide, const int4* __restrict__ nodes,
    const float* __restrict__ cdf, const int* __restrict__ cell_first,
    const float* __restrict__ xi, int* __restrict__ out, int m, int B, int use_fallback) {
    const int t = blockIdx.x * RT_B1_THREADS + threadIdx.x;
    if (t >= B) return;
    const unsigned long long pol = rt_keep_policy();
    const float x = __ldcs(xi + t);
    const int g = rt_guide_cell(x, m);
    int j = rt_ld_keep(guide + g, pol);
    if (j >= 0 && (j & RT_FLAG)) {
        j &= ~RT_FLAG;
        if (use_fallback) {
            int lo = __ldg(cell_first + g);
            int hi = __ldg(cell_first + g + 1);
            for (int s = 0; s < 32; ++s) {
                const int mid = (lo + hi + 1) >> 1;
                if (x >= __ldg(cdf + mid)) lo = mid; else hi = mid - 1;
            }
            j = ~lo;
        }
    }
    for (int it = 0; it < RT_MAX_DEPTH && j >= 0; ++it) {
        const int4 nd = rt_ld_keep4(nodes + j, pol);
        j = x < __int_as_float(nd.x) ? nd.y : nd.z;
    }
    __stcs(out + t, ~j);
}

// The same descent over the six arrays, for forests of 2^30 or more
// intervals, whose node ids the packed guide entry cannot hold beside its
// flag bit (the wrapper chooses this body from n alone). Reads as the body
// before the packed layout did: the guide entry, the flag byte, then cdf[j]
// and the chosen child a level. The bisection's midpoint is taken in 32
// unsigned bits: lo + hi + 1 reaches 2^31 near the end of such a forest.
__global__ void __launch_bounds__(RT_B1_THREADS) forest_sample_wide_kernel(
    const float* __restrict__ cdf, const int* __restrict__ table,
    const int* __restrict__ left, const int* __restrict__ right,
    const int* __restrict__ cell_first, const bool* __restrict__ fallback,
    const float* __restrict__ xi, int* __restrict__ out, int m, int B, int use_fallback) {
    const int t = blockIdx.x * RT_B1_THREADS + threadIdx.x;
    if (t >= B) return;
    const float x = __ldcs(xi + t);
    const int g = rt_guide_cell(x, m);
    int j = __ldg(table + g);
    if (use_fallback && j >= 0 && __ldg((const unsigned char*)fallback + g)) {
        int lo = __ldg(cell_first + g);
        int hi = __ldg(cell_first + g + 1);
        for (int s = 0; s < 32; ++s) {
            const int mid = (int)(((unsigned)lo + (unsigned)hi + 1u) >> 1);
            if (x >= __ldg(cdf + mid)) lo = mid; else hi = mid - 1;
        }
        j = ~lo;
    }
    for (int it = 0; it < RT_MAX_DEPTH && j >= 0; ++it)
        j = x < __ldg(cdf + j) ? __ldg(left + j) : __ldg(right + j);
    __stcs(out + t, ~j);
}

// The layout forest_sample reads, from the six arrays: guide[g] = table[g]
// with bit 30 set where the cell holds a tree and is flagged; nodes[j] =
// (bits of cdf[j], left[j], right[j], 0).
__global__ void forest_pack_kernel(const float* __restrict__ cdf, const int* __restrict__ table,
                                   const int* __restrict__ left, const int* __restrict__ right,
                                   const bool* __restrict__ fallback, int* __restrict__ guide,
                                   int4* __restrict__ nodes, int n, int m) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t < n) nodes[t] = make_int4(__float_as_int(cdf[t]), left[t], right[t], 0);
    if (t < m) {
        const int j = table[t];
        guide[t] = j >= 0 && fallback[t] ? (j | RT_FLAG) : j;
    }
}

RT_API int rt_forest_sample(const void* guide, const void* nodes, const void* cdf,
                            const void* cell_first, const void* xi, void* out, int m, int B,
                            int use_fallback, void* stream) {
    const int blocks = (B + RT_B1_THREADS - 1) / RT_B1_THREADS;
    forest_sample_kernel<<<blocks, RT_B1_THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)guide, (const int4*)nodes, (const float*)cdf, (const int*)cell_first,
        (const float*)xi, (int*)out, m, B, use_fallback);
    return (int)cudaGetLastError();
}

RT_API int rt_forest_sample_wide(const void* cdf, const void* table, const void* left,
                                 const void* right, const void* cell_first,
                                 const void* fallback, const void* xi, void* out, int m,
                                 int B, int use_fallback, void* stream) {
    const int blocks = (B + RT_B1_THREADS - 1) / RT_B1_THREADS;
    forest_sample_wide_kernel<<<blocks, RT_B1_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)cdf, (const int*)table, (const int*)left, (const int*)right,
        (const int*)cell_first, (const bool*)fallback, (const float*)xi, (int*)out, m, B,
        use_fallback);
    return (int)cudaGetLastError();
}

RT_API int rt_forest_pack(const void* cdf, const void* table, const void* left,
                          const void* right, const void* fallback, void* guide, void* nodes,
                          int n, int m, void* stream) {
    const int threads = 256;
    const int blocks = ((n > m ? n : m) + threads - 1) / threads;
    forest_pack_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)cdf, (const int*)table, (const int*)left, (const int*)right,
        (const bool*)fallback, (int*)guide, (int4*)nodes, n, m);
    return (int)cudaGetLastError();
}
