// forest_delta: separator distances of radix-forest construction.
//
// Replaces the TPU kernel repro/kernels/forest_delta.py `forest_delta`
// (`_delta_kernel`). For k in [0, n-1):
//   d[k] = bits(a[k]) ^ bits(a[k+1]), or 0xFFFFFFFF where the two lower
//   bounds fall into different guide cells clip(floor(x*m), 0, m-1).
// Bound on the H100: bytes. Each separator reads 4 B (a[k+1] is shared with
// the neighbour and served from L1/L2) and writes 4 B, so about 8-12 B per
// separator against 3.35 TB/s; no arithmetic worth counting. Design: one
// thread per separator, consecutive threads on consecutive addresses so
// every warp load and store is one coalesced 128-byte line. The product
// x*m is pinned to a rounded multiply (no contraction) so the cells agree
// bit for bit with the plain version.
#include "common.cuh"

__global__ void forest_delta_kernel(const float* __restrict__ data,
                                    uint32_t* __restrict__ out, int s, int m) {
    int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= s) return;
    float a = data[k];
    float b = data[k + 1];
    uint32_t raw = __float_as_uint(a) ^ __float_as_uint(b);
    out[k] = rt_guide_cell(a, m) != rt_guide_cell(b, m) ? 0xFFFFFFFFu : raw;
}

RT_API int rt_forest_delta(const void* data, void* out, int n, int m,
                           void* stream) {
    int s = n - 1;
    int threads = 256;
    int blocks = (s + threads - 1) / threads;
    forest_delta_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)data, (uint32_t*)out, s, m);
    return (int)cudaGetLastError();
}
