// alias_sample_batched: the O(1) alias drain over B stacked packed tables,
// one thread per (dist_id, uniform) lane.
//
// Replaces the TPU kernel repro/kernels/alias_sample.py
// `alias_sample_batched` (`_alias_sample_kernel`). Per lane:
//   did < 0 (sentinel / padding): write 0, read no row;
//   scaled = xi * n (rounded multiply, no contraction);
//   cell = clamp(trunc(scaled), 0, n-1);
//   frac = clamp(scaled - cell, 0, ALIAS_FRAC_MAX = 1 - 2^-24);
//   out = frac < q[did][cell] ? cell : alias[did][cell]  (int64 offsets).
// The same IEEE float32 steps as core.alias.np_sample_alias_f32, so the
// result is held to it elementwise.
// Bound on the H100: bytes, 12 B a lane (dist id and uniform in, index
// out) plus 8 B for each table cell some lane touches; two independent
// gathers a lane, no loop. Design: one lane per thread; the caller's
// optional stable sort by row (coalesce) groups a row's gathers.
#include "common.cuh"

#define RT_ALIAS_FRAC_MAX 0.99999994039535522461f  // largest float below 1

__global__ void alias_sample_batched_kernel(
    const float* __restrict__ q, const int* __restrict__ alias,
    const int* __restrict__ dist_id, const float* __restrict__ xi,
    int* __restrict__ out, int B, int n, int Q) {
    int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= Q) return;
    int did = dist_id[t];
    if (did < 0) { out[t] = 0; return; }
    did = min(did, B - 1);
    float scaled = __fmul_rn(xi[t], (float)n);
    int cell = min(max((int)scaled, 0), n - 1);
    float frac = __fsub_rn(scaled, (float)cell);
    frac = fminf(fmaxf(frac, 0.0f), RT_ALIAS_FRAC_MAX);
    const long long flat = (long long)did * n + cell;
    out[t] = frac < __ldg(q + flat) ? cell : __ldg(alias + flat);
}

RT_API int rt_alias_sample_batched(const void* q, const void* alias,
                                   const void* dist_id, const void* xi,
                                   void* out, int B, int n, int Q,
                                   void* stream) {
    int threads = 256;
    int blocks = (Q + threads - 1) / threads;
    alias_sample_batched_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)q, (const int*)alias, (const int*)dist_id,
        (const float*)xi, (int*)out, B, n, Q);
    return (int)cudaGetLastError();
}
