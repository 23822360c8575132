// forest_sample: Algorithm 2 (guide table + radix-tree descent) over one
// forest, one thread per uniform.
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
// Bound on the H100: the latency of dependent gathers, about 2 + depth loads
// a lane (table, then cdf and a child per level). At n = 2^20 the tables
// (cdf, left, right, table: ~16 MB plus side tables) fit the 50 MB L2, so
// the descent runs from L2; the byte floor is 8 B a lane (xi in, index
// out). Design: one lane per thread and many resident warps hide the
// dependent-load latency; read-only loads go through the non-coherent
// cache; lanes leave the loop independently (no warp-wide trip count).
#include "common.cuh"

#define RT_MAX_DEPTH 256

__global__ void forest_sample_kernel(
    const float* __restrict__ cdf, const int* __restrict__ table,
    const int* __restrict__ left, const int* __restrict__ right,
    const int* __restrict__ cell_first, const bool* __restrict__ fallback,
    const float* __restrict__ xi, int* __restrict__ out, int m, int B,
    int use_fallback) {
    int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= B) return;
    float x = xi[t];
    int g = rt_guide_cell(x, m);
    int j = __ldg(table + g);
    if (use_fallback && j >= 0 && __ldg((const unsigned char*)fallback + g)) {
        int lo = __ldg(cell_first + g);
        int hi = __ldg(cell_first + g + 1);
        for (int s = 0; s < 32; ++s) {
            int mid = (lo + hi + 1) >> 1;
            if (x >= __ldg(cdf + mid)) lo = mid; else hi = mid - 1;
        }
        j = ~lo;
    }
    for (int it = 0; it < RT_MAX_DEPTH && j >= 0; ++it)
        j = x < __ldg(cdf + j) ? __ldg(left + j) : __ldg(right + j);
    out[t] = ~j;
}

RT_API int rt_forest_sample(const void* cdf, const void* table,
                            const void* left, const void* right,
                            const void* cell_first, const void* fallback,
                            const void* xi, void* out, int m, int B,
                            int use_fallback, void* stream) {
    int threads = 256;
    int blocks = (B + threads - 1) / threads;
    forest_sample_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)cdf, (const int*)table, (const int*)left,
        (const int*)right, (const int*)cell_first, (const bool*)fallback,
        (const float*)xi, (int*)out, m, B, use_fallback);
    return (int)cudaGetLastError();
}
