// sample_rows: per-row two-level inverse-CDF search for decode sampling.
//
// Replaces the TPU kernel repro/kernels/sample_tiled.py `sample_rows`
// (`_sample_kernel`, tile 512). Per (row, draw) with uniform u over a row
// of V inclusive CDF entries, padded to nt = ceil(V / 512) tiles with 2.0:
//   t   = #{tile cutpoints row[j*512 + 511] <= u}, t = min(t, nt - 1);
//   off = #{row[t*512 + i] <= u, i < 512},       off = min(off, 511);
//   out = min(t*512 + off, V - 1).
// Float comparisons are exact and both levels are counts, so the result
// equals the plain version (kernels/ref.py `ref_sample_rows`) elementwise on
// any row, monotone or not.
//
// Bound on the H100: bytes, nt 32 B sectors of cutpoints plus one 2 KB tile
// per draw, plus the uniform in and the index out: ~0.2 MB at the decode
// shape (16 rows of 151936, one draw each), 0.000055 ms at 3.35 TB/s. Bytes
// do not bind a launch this small: the chain of dependent latencies does
// (launch, the uniform, the cutpoints, the tile, the store). The TPU kernel
// vector-compares the cutpoints and one dynamic tile slice. Here one warp
// owns one (row, draw), several warps to a block when there are many draws,
// with no shared memory and no block barrier:
//   level 1: each lane issues all of its ceil(nt / 32) cutpoint loads at
//            once (up to RT_CUT_LOADS, unrolled and predicated, so they are
//            in flight together; 10 at V = 151936), counts, and one
//            warp-wide reduction (REDUX) gives t;
//   level 2: the chosen tile as four 16-byte loads a lane where the row base
//            is 16-byte aligned and V % 4 == 0 (Qwen's 151936), else sixteen
//            scalar loads a lane; entries past V read as 2.0; one reduction
//            gives off.
// So a draw waits on two rounds of loads and two warp reductions, where the
// block of 256 threads it replaces waited on the same loads plus four block
// barriers, with one or two scalar loads a thread at level 1. Rows past
// RT_CUT_LOADS * 32 tiles (V > 262144) take level 1 in rounds.
#include "common.cuh"

#define RT_SAMPLE_TILE 512
#define RT_CUT_LOADS 16          // cutpoint loads a lane issues at once
#define RT_SAMPLE_WARPS_MANY 4   // warps a block from RT_SAMPLE_MANY draws on
#define RT_SAMPLE_MANY (4 * 132)  // four warps an SM of the H100 SXM

// Entry i of the padded row: the CDF inside the row, 2.0 past its end.
__device__ __forceinline__ float rt_padded(const float* row, int i, int V) {
    return i < V ? __ldg(row + i) : 2.0f;
}

__global__ void sample_rows_kernel(const float* __restrict__ cdf,
                                   const float* __restrict__ xi, int* __restrict__ out,
                                   int V, int k, int draws, int vec) {
    const int lane = threadIdx.x & 31;
    const int draw = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);  // row * k + j
    if (draw >= draws) return;  // a whole warp: no warp-wide step below is split
    const float* row = cdf + (long long)(draw / k) * V;
    const float u = __ldg(xi + draw);
    const int nt = (V + RT_SAMPLE_TILE - 1) / RT_SAMPLE_TILE;

    unsigned c = 0;
    for (int j0 = 0; j0 < nt; j0 += 32 * RT_CUT_LOADS) {
        float cut[RT_CUT_LOADS];
#pragma unroll
        for (int i = 0; i < RT_CUT_LOADS; ++i) {
            const int j = j0 + lane + 32 * i;
            cut[i] = j < nt ? rt_padded(row, j * RT_SAMPLE_TILE + RT_SAMPLE_TILE - 1, V) : 2.0f;
        }
#pragma unroll
        for (int i = 0; i < RT_CUT_LOADS; ++i) c += cut[i] <= u;
    }
    const int t = min((int)__reduce_add_sync(0xffffffffu, c), nt - 1);

    const int base = t * RT_SAMPLE_TILE;
    c = 0;
    if (vec) {  // 16-byte aligned row and V % 4 == 0: a chunk lies wholly inside or past V
#pragma unroll
        for (int i = 0; i < RT_SAMPLE_TILE / 128; ++i) {
            const int e = base + 4 * (lane + 32 * i);
            const float4 x = e < V ? __ldg(reinterpret_cast<const float4*>(row + e))
                                   : make_float4(2.0f, 2.0f, 2.0f, 2.0f);
            c += (x.x <= u) + (x.y <= u) + (x.z <= u) + (x.w <= u);
        }
    } else {
        float x[RT_SAMPLE_TILE / 32];
#pragma unroll
        for (int i = 0; i < RT_SAMPLE_TILE / 32; ++i)
            x[i] = rt_padded(row, base + lane + 32 * i, V);
#pragma unroll
        for (int i = 0; i < RT_SAMPLE_TILE / 32; ++i) c += x[i] <= u;
    }
    const int off = min((int)__reduce_add_sync(0xffffffffu, c), RT_SAMPLE_TILE - 1);
    if (lane == 0) out[draw] = min(base + off, V - 1);
}

RT_API int rt_sample_rows(const void* cdf, const void* xi, void* out, int B, int V, int k,
                          void* stream) {
    const int draws = B * k;  // the wrapper keeps it below 2^31
    const int warps = draws >= RT_SAMPLE_MANY ? RT_SAMPLE_WARPS_MANY : 1;
    const int vec = reinterpret_cast<uintptr_t>(cdf) % 16 == 0 && V % 4 == 0;
    sample_rows_kernel<<<(draws + warps - 1) / warps, 32 * warps, 0, (cudaStream_t)stream>>>(
        (const float*)cdf, (const float*)xi, (int*)out, V, k, draws, vec);
    return (int)cudaGetLastError();
}

// An empty kernel of this library, one warp: the floor a launch of it sits
// on (chip_smoke.py and tools/ab_sample_rows.py time it beside B9).
__global__ void empty_kernel() {}

RT_API int rt_empty(void* stream) {
    empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}
