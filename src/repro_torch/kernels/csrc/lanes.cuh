// Shared machinery of the grouped drain kernels (forest_sample_batched.cu,
// alias_sample.cu): the per-group descriptor table passed by value, the
// lane tile each block owns, and the in-tile sort that coalesces it.
//
// A launch serves up to RT_GROUP_CAP (method, size class) groups. Lane q
// belongs to group gid[q] - g0 of this launch's table when that is in
// [0, G); other lanes belong to another launch and are neither read past
// their inputs nor written. gid == nullptr puts every lane in group 0 (the
// single-stack entry points); hi == nullptr skips the clip. A block owns
// RT_TILE = RT_TILE_LANES * RT_TILE_THREADS consecutive lanes; thread t
// reads lanes 2t and 2t+1 of the tile with 8-byte streaming loads
// (evict-first, so the lane arrays do not push the stacks out of L2)
// where every lane array is 8-byte aligned, and with scalar loads
// otherwise.
#pragma once
#include <cub/block/block_radix_sort.cuh>
#include <initializer_list>

#include "common.cuh"

#define RT_GROUP_CAP 32
#define RT_TILE_THREADS 256
// Lanes a thread carries, read and written as one int2: at the drain's
// shape two matched one and beat four (PERF.md).
#define RT_TILE_LANES 2
#define RT_TILE (RT_TILE_THREADS * RT_TILE_LANES)

// One group: the stack's base pointers (forest: cdf, table, left, right,
// cell_first, fallback; alias: q, alias), its rows B, leaves n and guide
// cells m (alias: m = n). 64 bytes; kernels/groups.py packs the same layout.
struct RtGroup {
    unsigned long long ptr[6];
    int B, n, m, pad;
};
struct RtGroups {
    RtGroup g[RT_GROUP_CAP];
};
static_assert(sizeof(RtGroup) == 64, "RtGroup layout is packed by groups.py");

// The table staged in shared memory, one array a field, so lanes of
// different groups read different banks.
struct RtGroupsShared {
    unsigned long long ptr[6][RT_GROUP_CAP];
    int B[RT_GROUP_CAP], n[RT_GROUP_CAP], m[RT_GROUP_CAP];
};

__device__ __forceinline__ void rt_stage_groups(const RtGroups& groups, int G,
                                                RtGroupsShared& s) {
    for (int i = threadIdx.x; i < G; i += blockDim.x) {
        const RtGroup& d = groups.g[i];
#pragma unroll
        for (int k = 0; k < 6; ++k) s.ptr[k][i] = d.ptr[k];
        s.B[i] = d.B;
        s.n[i] = d.n;
        s.m[i] = d.m;
    }
    __syncthreads();
}

// A thread's consecutive 32-bit lane values from lane q0 on; `fill` where
// the array is absent or the lane lies past Q.
static_assert(RT_TILE_LANES == 2, "lanes travel as one int2");
__device__ __forceinline__ void rt_load_lanes(const int* __restrict__ p, long long q0, int Q,
                                              bool vec, int fill, int v[RT_TILE_LANES]) {
    if (p == nullptr) {
#pragma unroll
        for (int k = 0; k < RT_TILE_LANES; ++k) v[k] = fill;
    } else if (vec && q0 + RT_TILE_LANES <= Q) {
        const int2 t = __ldcs(reinterpret_cast<const int2*>(p + q0));
        v[0] = t.x;
        v[1] = t.y;
    } else {
#pragma unroll
        for (int k = 0; k < RT_TILE_LANES; ++k) v[k] = q0 + k < Q ? __ldcs(p + q0 + k) : fill;
    }
}

// The lanes a thread carries: its local group (-1: not this launch's
// lane), row (< 0: sentinel), clip bound and uniform, and the lane index.
struct RtLanes {
    int lg[RT_TILE_LANES], row[RT_TILE_LANES], hi[RT_TILE_LANES];
    float x[RT_TILE_LANES];
    long long q[RT_TILE_LANES];
};

// Reads the thread's lanes (tile order): group, row and clip bound.
__device__ __forceinline__ void rt_read_lanes(const int* __restrict__ gid,
                                              const int* __restrict__ row,
                                              const int* __restrict__ hi, int g0, int G,
                                              long long q0, int Q, bool vec, RtLanes& L) {
    int gv[RT_TILE_LANES];
    rt_load_lanes(gid, q0, Q, vec, g0, gv);
    rt_load_lanes(row, q0, Q, vec, -1, L.row);
    rt_load_lanes(hi, q0, Q, vec, 0x7FFFFFFF, L.hi);
#pragma unroll
    for (int k = 0; k < RT_TILE_LANES; ++k) {
        int lg = gv[k] - g0;
        L.q[k] = q0 + k;
        L.lg[k] = (q0 + k < Q && (unsigned)lg < (unsigned)G) ? lg : -1;
    }
}

// The key of a lane that reads no row: after every descending lane.
__device__ __forceinline__ unsigned long long rt_last_key(int end_bit) {
    return end_bit >= 64 ? ~0ull : (1ull << end_bit) - 1ull;
}

// The in-tile coalescing sort: by a key of (local group, flat cell offset
// row * width + cell), lanes not descending (other launches' lanes,
// sentinels, lanes past Q) last. CUB's block radix sort over the key's
// end_bit low bits, striped out so a warp's neighbouring lanes hold
// neighbouring keys. The lanes' inputs travel through shared memory by
// tile index.
using RtTileSort =
    cub::BlockRadixSort<unsigned long long, RT_TILE_THREADS, RT_TILE_LANES, int>;

struct RtTileShared {
    typename RtTileSort::TempStorage sort;
    int lg[RT_TILE], row[RT_TILE], hi[RT_TILE];
    float x[RT_TILE];
};

__device__ __forceinline__ void rt_sort_tile(RtLanes& L,
                                             unsigned long long (&key)[RT_TILE_LANES],
                                             int end_bit, long long tile0, RtTileShared& s) {
    int idx[RT_TILE_LANES];
#pragma unroll
    for (int k = 0; k < RT_TILE_LANES; ++k) {
        int i = RT_TILE_LANES * threadIdx.x + k;
        s.lg[i] = L.lg[k];
        s.row[i] = L.row[k];
        s.hi[i] = L.hi[k];
        s.x[i] = L.x[k];
        idx[k] = i;
    }
    RtTileSort(s.sort).SortBlockedToStriped(key, idx, 0, end_bit);
    __syncthreads();  // other threads wrote the lane arrays read below
#pragma unroll
    for (int k = 0; k < RT_TILE_LANES; ++k) {
        int i = idx[k];
        L.lg[k] = s.lg[i];
        L.row[k] = s.row[i];
        L.hi[k] = s.hi[i];
        L.x[k] = s.x[i];
        L.q[k] = tile0 + i;
    }
}

// Back to tile order after a sorted descent: each lane's result goes to
// its tile index (read only by the thread holding it since the sort), then
// thread t takes lanes 2t and 2t+1.
__device__ __forceinline__ void rt_unsort_tile(const RtLanes& L, int v[RT_TILE_LANES],
                                               long long tile0, RtTileShared& s) {
#pragma unroll
    for (int k = 0; k < RT_TILE_LANES; ++k) s.row[L.q[k] - tile0] = v[k];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < RT_TILE_LANES; ++k) v[k] = s.row[RT_TILE_LANES * threadIdx.x + k];
}

// A thread's results (tile order, lanes from q0 on) to their places: one
// 8-byte store where both are this launch's and the array is aligned,
// else one store a lane of this launch. Plain stores, so the sectors two
// launches share are merged in L2.
__device__ __forceinline__ void rt_store_lanes(int* __restrict__ p, long long q0, bool vec,
                                               const bool own[RT_TILE_LANES],
                                               const int v[RT_TILE_LANES]) {
    bool all = vec;
#pragma unroll
    for (int k = 0; k < RT_TILE_LANES; ++k) all = all && own[k];
    if (all) {
        *reinterpret_cast<int2*>(p + q0) = make_int2(v[0], v[1]);
    } else {
#pragma unroll
        for (int k = 0; k < RT_TILE_LANES; ++k)
            if (own[k]) p[q0 + k] = v[k];
    }
}

__device__ __forceinline__ unsigned long long rt_tile_key(int lg, long long flat,
                                                          int flat_bits) {
    return ((unsigned long long)lg << flat_bits) | (unsigned long long)flat;
}

// Host side: every lane array 8-byte aligned, so the tile reads and
// writes them as int2 (absent arrays do not count).
static inline int rt_aligned8(std::initializer_list<const void*> ps) {
    for (const void* p : ps)
        if (p != nullptr && ((uintptr_t)p & 7u) != 0) return 0;
    return 1;
}
