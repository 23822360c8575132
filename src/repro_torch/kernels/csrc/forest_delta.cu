// forest_delta: separator distances of radix-forest construction.
//
// Replaces the TPU kernel repro/kernels/forest_delta.py `forest_delta`
// (`_delta_kernel`). For k in [0, n-1):
//   d[k] = bits(a[k]) ^ bits(a[k+1]), or 0xFFFFFFFF where the two lower
//   bounds fall into different guide cells clip(floor(x*m), 0, m-1).
// The second entry point replaces repro/kernels/forest_delta.py
// `forest_delta_update` (`_changed_kernel`): for a weight update it writes
// the distances of the NEW lower bounds and, in the same pass, the mask of
// leaves whose float32 bit pattern moved, changed[i] = bits(old[i]) !=
// bits(new[i]). Fused, it reads each array once (8 B in a leaf; 1 B of mask
// and one distance out) where the TPU version ran two kernels.
// Both entry points write each distance as the int64 zero-extension of its
// uint32 value, the form the forest build's nearest-greater search compares,
// so no widening pass follows the kernel.
// Bound on the H100: bytes. The function reads 4 B a separator (a[k+1] is
// shared with the neighbour and served from L1/L2) and needs only 4 B of
// uint32 distance out; the int64 form writes 8 B. No arithmetic worth
// counting. Design: one thread per separator, consecutive threads on
// consecutive addresses so every warp load and store is coalesced. The product
// x*m is pinned to a rounded multiply (no contraction) so the cells agree
// bit for bit with the plain version.
#include "common.cuh"

__global__ void forest_delta_kernel(const float* __restrict__ data,
                                    long long* __restrict__ out, int s, int m) {
    int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= s) return;
    float a = data[k];
    float b = data[k + 1];
    uint32_t raw = __float_as_uint(a) ^ __float_as_uint(b);
    out[k] = (long long)(rt_guide_cell(a, m) != rt_guide_cell(b, m) ? 0xFFFFFFFFu : raw);
}

RT_API int rt_forest_delta(const void* data, void* out, int n, int m,
                           void* stream) {
    int s = n - 1;
    int threads = 256;
    int blocks = (s + threads - 1) / threads;
    forest_delta_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)data, (long long*)out, s, m);
    return (int)cudaGetLastError();
}

__global__ void forest_delta_update_kernel(const float* __restrict__ old_data,
                                           const float* __restrict__ new_data,
                                           long long* __restrict__ out,
                                           unsigned char* __restrict__ changed,
                                           int n, int m) {
    int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= n) return;
    float b = new_data[k];
    changed[k] = __float_as_uint(old_data[k]) != __float_as_uint(b);
    if (k + 1 < n) {
        float c = new_data[k + 1];
        uint32_t raw = __float_as_uint(b) ^ __float_as_uint(c);
        out[k] = (long long)(rt_guide_cell(b, m) != rt_guide_cell(c, m) ? 0xFFFFFFFFu : raw);
    }
}

RT_API int rt_forest_delta_update(const void* old_data, const void* new_data,
                                  void* out, void* changed, int n, int m,
                                  void* stream) {
    int threads = 256;
    int blocks = (n + threads - 1) / threads;
    forest_delta_update_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)old_data, (const float*)new_data, (long long*)out,
        (unsigned char*)changed, n, m);
    return (int)cudaGetLastError();
}
