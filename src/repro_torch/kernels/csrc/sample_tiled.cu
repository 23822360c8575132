// sample_rows: per-row two-level inverse-CDF search for decode sampling.
//
// Replaces the TPU kernel repro/kernels/sample_tiled.py `sample_rows`
// (`_sample_kernel`, tile 512). Per (row, draw) with uniform u over a row
// of V inclusive CDF entries, padded to nt = ceil(V / 512) tiles with 2.0:
//   t   = #{tile cutpoints row[j*512 + 511] <= u}, t = min(t, nt - 1);
//   off = #{row[t*512 + i] <= u, i < 512},       off = min(off, 511);
//   out = min(t*512 + off, V - 1).
// Float comparisons are exact, so the result equals the plain version
// (kernels/ref.py `ref_sample_rows`) elementwise on any row.
// The TPU kernel vector-compares the cutpoints and one dynamic tile slice
// (no gathers). Here one block of 256 threads owns one (row, draw): level 1
// strides over the cutpoints (one float from each 2 KB tile, so each is
// its own 32 B sector), level 2 reads the chosen tile coalesced (2 floats a
// thread); each level's count is a warp-shuffle sum plus one shared-memory
// step over the 8 warps.
// Bound on the H100: bytes, nt 32 B sectors of cutpoints plus one 2 KB tile
// per draw, plus the uniform in and the index out. At the decode shapes
// (B <= 16 rows of 151936, one draw each) that is ~0.2 MB, so a launch is
// latency-bound: two dependent rounds of loads and block reductions.
#include "common.cuh"

#define RT_SAMPLE_TILE 512
#define RT_SAMPLE_THREADS 256
#define RT_SAMPLE_WARPS (RT_SAMPLE_THREADS / 32)

// Block-wide sum of one int a thread; every thread gets the total.
__device__ __forceinline__ int rt_block_count(int v, int* warp_sums) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    __syncthreads();  // earlier readers of warp_sums are done
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
    __syncthreads();
    int s = 0;
#pragma unroll
    for (int w = 0; w < RT_SAMPLE_WARPS; ++w) s += warp_sums[w];
    return s;
}

// Entry i of the padded row: the CDF inside the row, 2.0 past its end.
__device__ __forceinline__ float rt_padded(const float* row, int i, int V) {
    return i < V ? __ldg(row + i) : 2.0f;
}

__global__ void __launch_bounds__(RT_SAMPLE_THREADS)
sample_rows_kernel(const float* __restrict__ cdf, const float* __restrict__ xi,
                   int* __restrict__ out, int V, int k) {
    __shared__ int warp_sums[RT_SAMPLE_WARPS];
    const int lane = blockIdx.x;                 // row * k + draw
    const float* row = cdf + (long long)(lane / k) * V;
    const float u = xi[lane];
    const int nt = (V + RT_SAMPLE_TILE - 1) / RT_SAMPLE_TILE;

    int c = 0;
    for (int j = threadIdx.x; j < nt; j += RT_SAMPLE_THREADS)
        c += rt_padded(row, j * RT_SAMPLE_TILE + RT_SAMPLE_TILE - 1, V) <= u;
    const int t = min(rt_block_count(c, warp_sums), nt - 1);

    c = 0;
    for (int i = threadIdx.x; i < RT_SAMPLE_TILE; i += RT_SAMPLE_THREADS)
        c += rt_padded(row, t * RT_SAMPLE_TILE + i, V) <= u;
    const int off = min(rt_block_count(c, warp_sums), RT_SAMPLE_TILE - 1);
    if (threadIdx.x == 0) out[lane] = min(t * RT_SAMPLE_TILE + off, V - 1);
}

RT_API int rt_sample_rows(const void* cdf, const void* xi, void* out, int B,
                          int V, int k, void* stream) {
    sample_rows_kernel<<<B * k, RT_SAMPLE_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)cdf, (const float*)xi, (int*)out, V, k);
    return (int)cudaGetLastError();
}
