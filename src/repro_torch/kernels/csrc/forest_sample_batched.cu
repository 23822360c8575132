// forest_sample_batched: Algorithm 2 over B stacked forests, one thread per
// (dist_id, uniform) lane; the stream-aware drain is the same body with
// STREAM = true.
//
// Replaces the TPU kernels repro/kernels/forest_sample.py
// `forest_sample_batched` and `forest_sample_batched_streams` (one body,
// `_forest_batched_kernel`, with `stream=False` / `stream=True`). Per lane:
//   did < 0 (sentinel / padding): write 0, read no row;
//   STREAM: rev = brev(ctr) >> 8, bits = (rev + off) & 0xFFFFFF,
//           xi = bits * 2^-24 (exact), also written out;
//   g = clip(floor(xi*m), 0, m-1); j = table[did][g];
//   in a flagged cell, the 32-trip bisection of core.sample._bisect over
//   the lane's own cdf row between cell_first[did][g] and [g+1];
//   then j = xi < cdf[did][j] ? left[did][j] : right[did][j] until j < 0
//   (at most MAX_DEPTH = 256 trips); output ~j (row-local index).
// Row offsets are int64: did * (n+1) passes 2^31 in large size classes.
// Unlike the TPU kernel's fixed 40 trips, each lane stops at its own leaf,
// so the result equals core.sample.sample_forest of the lane's row.
// Bound on the H100: the latency of dependent gathers (2 + depth loads a
// lane, scattered over the stacked tables); the byte floor is 12 B a lane
// (20 B streamed) plus the table entries read. Design: as forest_sample.cu,
// one lane per thread, many resident warps hide the load latency, lanes
// leave the loop independently; the caller's optional stable sort by row
// (coalesce) puts lanes of one tree next to each other so their gathers
// share cache lines.
#include "common.cuh"

#define RT_MAX_DEPTH 256

template <bool STREAM>
__global__ void forest_sample_batched_kernel(
    const float* __restrict__ cdf, const int* __restrict__ table,
    const int* __restrict__ left, const int* __restrict__ right,
    const int* __restrict__ cell_first, const bool* __restrict__ fallback,
    const int* __restrict__ dist_id, const float* __restrict__ xi_in,
    const uint32_t* __restrict__ ctr, const uint32_t* __restrict__ off,
    int* __restrict__ out, float* __restrict__ xi_out, int B, int n, int m,
    int Q) {
    int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= Q) return;
    float x;
    if (STREAM) {
        uint32_t rev = __brev(ctr[t]) >> 8;
        uint32_t bits = (rev + off[t]) & 0xFFFFFFu;
        x = (float)bits * 5.9604644775390625e-08f;  // 2^-24, exact
        xi_out[t] = x;
    } else {
        x = xi_in[t];
    }
    int did = dist_id[t];
    if (did < 0) { out[t] = 0; return; }
    did = min(did, B - 1);
    const long long crow = (long long)did * (n + 1);
    const long long nrow = (long long)did * n;
    const long long mrow = (long long)did * m;
    int g = rt_guide_cell(x, m);
    int j = __ldg(table + mrow + g);
    if (j >= 0 && __ldg((const unsigned char*)fallback + mrow + g)) {
        const long long frow = (long long)did * (m + 1);
        int lo = __ldg(cell_first + frow + g);
        int hi = __ldg(cell_first + frow + g + 1);
        for (int s = 0; s < 32; ++s) {
            int mid = (lo + hi + 1) >> 1;
            if (x >= __ldg(cdf + crow + mid)) lo = mid; else hi = mid - 1;
        }
        j = ~lo;
    }
    for (int it = 0; it < RT_MAX_DEPTH && j >= 0; ++it)
        j = x < __ldg(cdf + crow + j) ? __ldg(left + nrow + j)
                                      : __ldg(right + nrow + j);
    out[t] = ~j;
}

RT_API int rt_forest_sample_batched(
    const void* cdf, const void* table, const void* left, const void* right,
    const void* cell_first, const void* fallback, const void* dist_id,
    const void* xi, const void* ctr, const void* off, void* out,
    void* xi_out, int B, int n, int m, int Q, int stream_mode,
    void* stream) {
    int threads = 256;
    int blocks = (Q + threads - 1) / threads;
    cudaStream_t st = (cudaStream_t)stream;
    if (stream_mode)
        forest_sample_batched_kernel<true><<<blocks, threads, 0, st>>>(
            (const float*)cdf, (const int*)table, (const int*)left,
            (const int*)right, (const int*)cell_first, (const bool*)fallback,
            (const int*)dist_id, nullptr, (const uint32_t*)ctr,
            (const uint32_t*)off, (int*)out, (float*)xi_out, B, n, m, Q);
    else
        forest_sample_batched_kernel<false><<<blocks, threads, 0, st>>>(
            (const float*)cdf, (const int*)table, (const int*)left,
            (const int*)right, (const int*)cell_first, (const bool*)fallback,
            (const int*)dist_id, (const float*)xi, nullptr, nullptr,
            (int*)out, nullptr, B, n, m, Q);
    return (int)cudaGetLastError();
}
