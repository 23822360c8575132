// cdf_scan: row-wise inclusive prefix sums for CDF construction.
//
// Replaces the TPU kernel repro/kernels/cdf_scan.py `cdf_scan`
// (`_stats_kernel`, `_scan_kernel`). Three modes over a (B, V) row block:
//   mode 0, softmax: out = cumsum(exp(x - max) / sum(exp(x - max)));
//   mode 1, weights: out = cumsum(x / sum(x));
//   mode 2, raw:     out = cumsum(x)  (the row scan of chunked_cumsum).
// The TPU walks a row's tiles on a sequential grid axis and carries the
// running sum in VMEM scratch. Blocks on Hopper share no order, so here one
// block owns one row and a loop inside the block walks its tiles: each tile
// of 1024 elements is scanned block-wide (4 consecutive elements a thread,
// then warp shuffles and one shared-memory step over the 8 warps), and the
// running sum is carried in a register. The normalized modes first run a
// stats pass over the row with the same online max/rescaled-sum update as
// `_stats_kernel`. Softmax uses IEEE expf and division (no fast math).
// Bound on the H100: bytes, 4 B read (2 B for bf16) and 4 B written per
// element (twice the reads in the normalized modes). One block per row, so
// a launch with fewer rows than SMs (the main path's 64 rows) leaves most
// of the 132 SMs idle; splitting rows across blocks is later work.
// The sum is reassociated (tile tree + carry chain), so results are held
// to a tolerance, not to bits.
#include "common.cuh"
#include <cuda_bf16.h>

#define SCAN_THREADS 256
#define SCAN_ITEMS 4
#define SCAN_WARPS (SCAN_THREADS / 32)
#define NEG_INF (-1e30f)

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
}

__device__ __forceinline__ float warp_incl_scan(float v, int lane) {
    for (int o = 1; o < 32; o <<= 1) {
        float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
    }
    return v;
}

// Online softmax statistics: (mx, s) with s = sum exp(x - mx).
__device__ __forceinline__ void stats_merge(float& mx, float& s, float mx2,
                                            float s2) {
    float mn = fmaxf(mx, mx2);
    s = s * expf(mx - mn) + s2 * expf(mx2 - mn);
    mx = mn;
}

template <typename T>
__global__ void cdf_scan_kernel(const T* __restrict__ x, float* __restrict__ out,
                                int V, int mode) {
    __shared__ float red_m[SCAN_WARPS];
    __shared__ float red_s[SCAN_WARPS];
    __shared__ float wsum[SCAN_WARPS];
    __shared__ float wpre[SCAN_WARPS];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const T* row = x + (size_t)blockIdx.x * V;
    float* orow = out + (size_t)blockIdx.x * V;

    // Pass 1: row statistics (softmax max + sum of exp, or the plain sum).
    float rmax = 0.0f, rsum = 1.0f;
    if (mode != 2) {
        float mx = mode == 0 ? NEG_INF : 0.0f, s = 0.0f;
        for (int i = tid; i < V; i += SCAN_THREADS) {
            float v = load_f32(row + i);
            if (mode == 0) {
                if (v > mx) { s = s * expf(mx - v) + 1.0f; mx = v; }
                else s += expf(v - mx);
            } else {
                s += v;
            }
        }
        for (int o = 16; o > 0; o >>= 1) {
            float mx2 = __shfl_xor_sync(0xffffffffu, mx, o);
            float s2 = __shfl_xor_sync(0xffffffffu, s, o);
            if (mode == 0) stats_merge(mx, s, mx2, s2); else s += s2;
        }
        if (lane == 0) { red_m[warp] = mx; red_s[warp] = s; }
        __syncthreads();
        mx = red_m[0]; s = red_s[0];
        for (int w = 1; w < SCAN_WARPS; ++w) {
            if (mode == 0) stats_merge(mx, s, red_m[w], red_s[w]);
            else s += red_s[w];
        }
        rmax = mx; rsum = s;
    }

    // Pass 2: normalized elements, tile scan, running carry.
    float carry = 0.0f;
    for (int t0 = 0; t0 < V; t0 += SCAN_THREADS * SCAN_ITEMS) {
        const int base = t0 + tid * SCAN_ITEMS;
        float v[SCAN_ITEMS];
#pragma unroll
        for (int k = 0; k < SCAN_ITEMS; ++k) {
            float e = 0.0f;
            if (base + k < V) {
                float xv = load_f32(row + base + k);
                e = mode == 0 ? expf(xv - rmax) / rsum
                    : mode == 1 ? xv / rsum : xv;
            }
            v[k] = k ? v[k - 1] + e : e;
        }
        float incl = warp_incl_scan(v[SCAN_ITEMS - 1], lane);
        float lane_excl = __shfl_up_sync(0xffffffffu, incl, 1);
        if (lane == 0) lane_excl = 0.0f;
        if (lane == 31) wsum[warp] = incl;
        __syncthreads();
        if (warp == 0) {
            float w = warp_incl_scan(lane < SCAN_WARPS ? wsum[lane] : 0.0f, lane);
            if (lane < SCAN_WARPS) wpre[lane] = w;
        }
        __syncthreads();
        const float excl = (warp ? wpre[warp - 1] : 0.0f) + lane_excl;
#pragma unroll
        for (int k = 0; k < SCAN_ITEMS; ++k)
            if (base + k < V) orow[base + k] = carry + (excl + v[k]);
        carry += wpre[SCAN_WARPS - 1];
    }
}

RT_API int rt_cdf_scan(const void* x, void* out, int B, int V, int mode,
                       int is_bf16, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (is_bf16)
        cdf_scan_kernel<__nv_bfloat16><<<B, SCAN_THREADS, 0, st>>>(
            (const __nv_bfloat16*)x, (float*)out, V, mode);
    else
        cdf_scan_kernel<float><<<B, SCAN_THREADS, 0, st>>>(
            (const float*)x, (float*)out, V, mode);
    return (int)cudaGetLastError();
}
