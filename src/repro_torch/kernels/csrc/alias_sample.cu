// alias_sample_batched: the O(1) alias drain over the stacked packed tables
// of up to RT_GROUP_CAP size classes in one launch (a drain's alias lanes,
// or one stack for the single-stack entry point).
//
// Replaces the TPU kernel repro/kernels/alias_sample.py
// `alias_sample_batched` (`_alias_sample_kernel`), and the per-group
// launches, coalescing sort and clip of repro/pool/arena.py's drain around
// it. Per lane of this launch (lanes.cuh):
//   row < 0 (sentinel / padding): write 0, read no row;
//   row = min(row, B-1); scaled = xi * n (rounded multiply, no contraction);
//   cell = clamp(trunc(scaled), 0, n-1);
//   frac = clamp(scaled - cell, 0, ALIAS_FRAC_MAX = 1 - 2^-24);
//   out = min(frac < q[row][cell] ? cell : alias[row][cell], hi)
//   (int64 offsets), written to the lane's own place.
// The same IEEE float32 steps as core.alias.np_sample_alias_f32, so the
// result is held to it elementwise.
// Bound on the H100: bytes, 20 B a lane (group, row, clip bound and
// uniform in, index out) plus 8 B for each table cell some lane touches,
// behind one dependent step (lane inputs, then q and alias together).
// Design: a block owns a tile of RT_TILE lanes, a thread two, read with
// 8-byte streaming loads and written with 8-byte stores, their four table
// loads in flight at once; with SORT (coalesce) the tile is first sorted
// in shared memory by (group, row, cell) and the results return to tile
// order through shared memory (it lost at the drain's shape, PERF.md).
#include <cstring>

#include "lanes.cuh"

#define RT_ALIAS_FRAC_MAX 0.99999994039535522461f  // largest float below 1

// The thread's lanes' draws, the table loads of both in flight at once;
// res gets each lane's clipped result.
__device__ __forceinline__ void rt_alias_resolve(const RtLanes& L, const RtGroupsShared& sg,
                                                 int res[RT_TILE_LANES]) {
    float qv[RT_TILE_LANES], frac[RT_TILE_LANES];
    int av[RT_TILE_LANES], cell[RT_TILE_LANES];
    bool act[RT_TILE_LANES];
#pragma unroll
    for (int k = 0; k < RT_TILE_LANES; ++k) {
        act[k] = L.lg[k] >= 0 && L.row[k] >= 0;
        if (act[k]) {
            const int g = L.lg[k], n = sg.n[g];
            const long long r = min(L.row[k], sg.B[g] - 1);
            const float scaled = __fmul_rn(L.x[k], (float)n);
            cell[k] = min(max((int)scaled, 0), n - 1);
            frac[k] = fminf(fmaxf(__fsub_rn(scaled, (float)cell[k]), 0.0f), RT_ALIAS_FRAC_MAX);
            const long long flat = r * n + cell[k];
            qv[k] = __ldg(reinterpret_cast<const float*>(sg.ptr[0][g]) + flat);
            av[k] = __ldg(reinterpret_cast<const int*>(sg.ptr[1][g]) + flat);
        }
    }
#pragma unroll
    for (int k = 0; k < RT_TILE_LANES; ++k)
        res[k] = min(act[k] ? (frac[k] < qv[k] ? cell[k] : av[k]) : 0, L.hi[k]);
}

template <bool SORT>
__global__ void __launch_bounds__(RT_TILE_THREADS) alias_sample_batched_kernel(
    const __grid_constant__ RtGroups groups, int G, int g0, const int* __restrict__ gid,
    const int* __restrict__ row, const int* __restrict__ hi, const int* __restrict__ xi,
    int* __restrict__ out, int Q, int vec, int flat_bits, int end_bit) {
    const long long tile0 = (long long)blockIdx.x * RT_TILE;
    const long long q0 = tile0 + RT_TILE_LANES * threadIdx.x;
    RtLanes L;
    rt_read_lanes(gid, row, hi, g0, G, q0, Q, vec, L);  // in flight across the staging
    int xb[RT_TILE_LANES];
    rt_load_lanes(xi, q0, Q, vec, 0, xb);
    __shared__ RtGroupsShared sg;
    rt_stage_groups(groups, G, sg);
    bool own[RT_TILE_LANES];
#pragma unroll
    for (int k = 0; k < RT_TILE_LANES; ++k) {
        L.x[k] = __int_as_float(xb[k]);
        own[k] = L.lg[k] >= 0;
    }
    int res[RT_TILE_LANES];
    if constexpr (SORT) {
        __shared__ RtTileShared st;
        unsigned long long key[RT_TILE_LANES];
#pragma unroll
        for (int k = 0; k < RT_TILE_LANES; ++k) {
            key[k] = rt_last_key(end_bit);
            if (L.lg[k] >= 0 && L.row[k] >= 0) {
                const int g = L.lg[k], n = sg.n[g];
                const long long r = min(L.row[k], sg.B[g] - 1);
                const int cell = min(max((int)__fmul_rn(L.x[k], (float)n), 0), n - 1);
                key[k] = rt_tile_key(g, r * n + cell, flat_bits);
            }
        }
        rt_sort_tile(L, key, end_bit, tile0, st);
        rt_alias_resolve(L, sg, res);
        rt_unsort_tile(L, res, tile0, st);
    } else {
        rt_alias_resolve(L, sg, res);
    }
    rt_store_lanes(out, q0, vec, own, res);
}

template <bool SORT>
static void rt_launch_alias(const RtGroups& table, int blocks, cudaStream_t st, int G, int g0,
                            const int* gid, const int* row, const int* hi, const int* xi,
                            int* out, int Q, int vec, int flat_bits, int end_bit) {
    alias_sample_batched_kernel<SORT><<<blocks, RT_TILE_THREADS, 0, st>>>(
        table, G, g0, gid, row, hi, xi, out, Q, vec, flat_bits, end_bit);
}

// groups: G packed RtGroup records (host memory; ptr[0] q, ptr[1] alias),
// copied into the launch's by-value table.
RT_API int rt_alias_sample_grouped(const void* groups, int G, int g0, const void* gid,
                                   const void* row, const void* hi, const void* xi,
                                   void* out, int Q, int flat_bits, int end_bit, int sort,
                                   void* stream) {
    if (G < 1 || G > RT_GROUP_CAP || Q < 0 || end_bit < 1 || end_bit > 64 ||
        flat_bits < 0 || flat_bits >= end_bit)
        return (int)cudaErrorInvalidValue;
    if (Q == 0) return 0;
    RtGroups table;
    memset(&table, 0, sizeof table);
    memcpy(table.g, groups, (size_t)G * sizeof(RtGroup));
    const int vec = rt_aligned8({gid, row, hi, xi, out});
    const int blocks = (int)(((long long)Q + RT_TILE - 1) / RT_TILE);
    auto* launch = sort ? rt_launch_alias<true> : rt_launch_alias<false>;
    launch(table, blocks, (cudaStream_t)stream, G, g0, (const int*)gid, (const int*)row,
           (const int*)hi, (const int*)xi, (int*)out, Q, vec, flat_bits, end_bit);
    return (int)cudaGetLastError();
}
