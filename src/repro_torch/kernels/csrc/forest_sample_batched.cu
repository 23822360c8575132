// forest_sample_batched: Algorithm 2 over the stacked forests of up to
// RT_GROUP_CAP size classes in one launch (a drain's forest lanes, or one
// stack for the single-stack entry points); the stream-aware drain is the
// same body with STREAM = true.
//
// Replaces the TPU kernels repro/kernels/forest_sample.py
// `forest_sample_batched` and `forest_sample_batched_streams` (one body,
// `_forest_batched_kernel`, with `stream=False` / `stream=True`), and the
// per-group launches, coalescing sort and clip of repro/pool/arena.py's
// drain around them. Per lane of this launch (lanes.cuh):
//   row < 0 (sentinel / padding): write 0, read no row;
//   STREAM: rev = brev(ctr) >> 8, bits = (rev + off) & 0xFFFFFF,
//           xi = bits * 2^-24 (exact), also written out where asked;
//   row = min(row, B-1); g = clip(floor(xi*m), 0, m-1); j = table[row][g];
//   in a flagged cell, the 32-trip bisection of core.sample._bisect over
//   the lane's own cdf row between cell_first[row][g] and [g+1];
//   then j = xi < cdf[row][j] ? left[row][j] : right[row][j] until j < 0
//   (at most MAX_DEPTH = 256 trips); output min(~j, hi) (row-local index
//   clipped to the tenant's n - 1), written to the lane's own place.
// Row offsets are int64: row * (n+1) passes 2^31 in large size classes.
// Unlike the TPU kernel's fixed 40 trips, each lane stops at its own leaf,
// so the result equals core.sample.sample_forest of the lane's row.
// Bound on the H100: the latency of dependent gathers (lane inputs, the
// guide entry, the fallback flag where the cell holds a tree, then per
// level cdf[j] and the chosen child); the byte floor is the lane's inputs
// and output plus the table entries read, and at scale the 32-byte sectors
// those scattered entries occupy.
// Design: a block owns a tile of RT_TILE lanes, a thread two of them, read
// with 8-byte streaming loads and written with 8-byte stores; the two
// descend together, each step issuing both lanes' loads at once, so a
// thread keeps two loads in flight where one lane kept one. At the drain's
// shape (PERF.md) two lanes matched one and beat four, the flag read after
// the guide entry beat reading both at once, and cdf[j] then the chosen
// child beat cdf[j], left[j] and right[j] at once (a third more sectors).
// With SORT (coalesce) the tile is first sorted in shared memory by (group,
// row, guide cell), so a warp's neighbouring lanes walk neighbouring cells,
// and the results return to tile order through shared memory; it lost at
// the drain's shape, which runs without it.
#include <cstring>

#include "lanes.cuh"

#define RT_MAX_DEPTH 256

// The thread's lanes' descents; res gets each lane's clipped result.
__device__ __forceinline__ void rt_forest_descend(const RtLanes& L, const RtGroupsShared& sg,
                                                  int res[RT_TILE_LANES]) {
    const float* cdf[RT_TILE_LANES];
    const int* lft[RT_TILE_LANES];
    const int* rgt[RT_TILE_LANES];
    int j[RT_TILE_LANES], lo[RT_TILE_LANES], hi[RT_TILE_LANES];
    unsigned char fb[RT_TILE_LANES];
    bool act[RT_TILE_LANES], flag[RT_TILE_LANES];
#pragma unroll
    for (int k = 0; k < RT_TILE_LANES; ++k) {
        act[k] = L.lg[k] >= 0 && L.row[k] >= 0;
        j[k] = -1;
        lo[k] = hi[k] = 0;
        fb[k] = 0;
        if (act[k]) {
            const int g = L.lg[k], n = sg.n[g], m = sg.m[g];
            const long long r = min(L.row[k], sg.B[g] - 1);
            cdf[k] = reinterpret_cast<const float*>(sg.ptr[0][g]) + r * (n + 1);
            lft[k] = reinterpret_cast<const int*>(sg.ptr[2][g]) + r * n;
            rgt[k] = reinterpret_cast<const int*>(sg.ptr[3][g]) + r * n;
            const long long cell = r * m + rt_guide_cell(L.x[k], m);
            j[k] = __ldg(reinterpret_cast<const int*>(sg.ptr[1][g]) + cell);
        }
    }
#pragma unroll
    for (int k = 0; k < RT_TILE_LANES; ++k) {
        if (act[k] && j[k] >= 0) {
            const int g = L.lg[k], m = sg.m[g];
            const long long r = min(L.row[k], sg.B[g] - 1);
            fb[k] = __ldg(reinterpret_cast<const unsigned char*>(sg.ptr[5][g]) + r * m +
                          rt_guide_cell(L.x[k], m));
        }
    }
    bool any_flag = false;
#pragma unroll
    for (int k = 0; k < RT_TILE_LANES; ++k) {
        flag[k] = act[k] && j[k] >= 0 && fb[k];
        if (flag[k]) {
            const int g = L.lg[k], m = sg.m[g];
            const long long r = min(L.row[k], sg.B[g] - 1);
            const int* cf = reinterpret_cast<const int*>(sg.ptr[4][g]) + r * (m + 1) +
                            rt_guide_cell(L.x[k], m);
            lo[k] = __ldg(cf);
            hi[k] = __ldg(cf + 1);
            any_flag = true;
        }
    }
    if (any_flag) {
        for (int s = 0; s < 32; ++s) {
            float c[RT_TILE_LANES];
            int mid[RT_TILE_LANES];
#pragma unroll
            for (int k = 0; k < RT_TILE_LANES; ++k) {
                mid[k] = (lo[k] + hi[k] + 1) >> 1;
                if (flag[k]) c[k] = __ldg(cdf[k] + mid[k]);
            }
#pragma unroll
            for (int k = 0; k < RT_TILE_LANES; ++k) {
                if (flag[k]) {
                    if (L.x[k] >= c[k]) lo[k] = mid[k]; else hi[k] = mid[k] - 1;
                }
            }
        }
#pragma unroll
        for (int k = 0; k < RT_TILE_LANES; ++k)
            if (flag[k]) j[k] = ~lo[k];
    }
    for (int it = 0; it < RT_MAX_DEPTH; ++it) {
        float c[RT_TILE_LANES];
#pragma unroll
        for (int k = 0; k < RT_TILE_LANES; ++k)
            if (j[k] >= 0) c[k] = __ldg(cdf[k] + j[k]);
        bool live = false;
#pragma unroll
        for (int k = 0; k < RT_TILE_LANES; ++k) {
            if (j[k] >= 0) {
                j[k] = __ldg((L.x[k] < c[k] ? lft[k] : rgt[k]) + j[k]);
                live |= j[k] >= 0;
            }
        }
        if (!live) break;
    }
#pragma unroll
    for (int k = 0; k < RT_TILE_LANES; ++k) res[k] = min(act[k] ? ~j[k] : 0, L.hi[k]);
}

template <bool STREAM, bool SORT>
__global__ void __launch_bounds__(RT_TILE_THREADS) forest_sample_batched_kernel(
    const __grid_constant__ RtGroups groups, int G, int g0, const int* __restrict__ gid,
    const int* __restrict__ row, const int* __restrict__ hi, const int* __restrict__ xi_in,
    const int* __restrict__ ctr, const int* __restrict__ off, int* __restrict__ out,
    float* __restrict__ xi_out, int Q, int vec, int flat_bits, int end_bit) {
    const long long tile0 = (long long)blockIdx.x * RT_TILE;
    const long long q0 = tile0 + RT_TILE_LANES * threadIdx.x;
    RtLanes L;
    rt_read_lanes(gid, row, hi, g0, G, q0, Q, vec, L);  // in flight across the staging
    bool own[RT_TILE_LANES];
#pragma unroll
    for (int k = 0; k < RT_TILE_LANES; ++k) own[k] = L.lg[k] >= 0;
    if (STREAM) {
        int c[RT_TILE_LANES], o[RT_TILE_LANES], xb[RT_TILE_LANES];
        rt_load_lanes(ctr, q0, Q, vec, 0, c);
        rt_load_lanes(off, q0, Q, vec, 0, o);
#pragma unroll
        for (int k = 0; k < RT_TILE_LANES; ++k) {
            uint32_t rev = __brev((uint32_t)c[k]) >> 8;
            uint32_t bits = (rev + (uint32_t)o[k]) & 0xFFFFFFu;
            L.x[k] = (float)bits * 5.9604644775390625e-08f;  // 2^-24, exact
            xb[k] = __float_as_int(L.x[k]);
        }
        if (xi_out != nullptr) rt_store_lanes(reinterpret_cast<int*>(xi_out), q0, vec, own, xb);
    } else {
        int xb[RT_TILE_LANES];
        rt_load_lanes(xi_in, q0, Q, vec, 0, xb);
#pragma unroll
        for (int k = 0; k < RT_TILE_LANES; ++k) L.x[k] = __int_as_float(xb[k]);
    }
    __shared__ RtGroupsShared sg;
    rt_stage_groups(groups, G, sg);
    int res[RT_TILE_LANES];
    if constexpr (SORT) {
        __shared__ RtTileShared st;
        unsigned long long key[RT_TILE_LANES];
#pragma unroll
        for (int k = 0; k < RT_TILE_LANES; ++k) {
            key[k] = rt_last_key(end_bit);
            if (L.lg[k] >= 0 && L.row[k] >= 0) {
                const int g = L.lg[k], m = sg.m[g];
                const long long r = min(L.row[k], sg.B[g] - 1);
                key[k] = rt_tile_key(g, r * m + rt_guide_cell(L.x[k], m), flat_bits);
            }
        }
        rt_sort_tile(L, key, end_bit, tile0, st);
        rt_forest_descend(L, sg, res);
        rt_unsort_tile(L, res, tile0, st);
    } else {
        rt_forest_descend(L, sg, res);
    }
    rt_store_lanes(out, q0, vec, own, res);
}

template <bool STREAM, bool SORT>
static void rt_launch_forest(const RtGroups& table, int blocks, cudaStream_t st, int G,
                             int g0, const int* gid, const int* row, const int* hi,
                             const int* xi, const int* ctr, const int* off, int* out,
                             float* xi_out, int Q, int vec, int flat_bits, int end_bit) {
    forest_sample_batched_kernel<STREAM, SORT><<<blocks, RT_TILE_THREADS, 0, st>>>(
        table, G, g0, gid, row, hi, xi, ctr, off, out, xi_out, Q, vec, flat_bits, end_bit);
}

// groups: G packed RtGroup records (host memory), copied into the launch's
// by-value table. Lanes of group gid - g0 in [0, G) are this launch's.
RT_API int rt_forest_sample_grouped(
    const void* groups, int G, int g0, const void* gid, const void* row, const void* hi,
    const void* xi, const void* ctr, const void* off, void* out, void* xi_out, int Q,
    int flat_bits, int end_bit, int stream_mode, int sort, void* stream) {
    if (G < 1 || G > RT_GROUP_CAP || Q < 0 || end_bit < 1 || end_bit > 64 ||
        flat_bits < 0 || flat_bits >= end_bit)
        return (int)cudaErrorInvalidValue;
    if (Q == 0) return 0;
    RtGroups table;
    memset(&table, 0, sizeof table);
    memcpy(table.g, groups, (size_t)G * sizeof(RtGroup));
    const int vec = rt_aligned8({gid, row, hi, xi, ctr, off, out, xi_out});
    const int blocks = (int)(((long long)Q + RT_TILE - 1) / RT_TILE);
    cudaStream_t st = (cudaStream_t)stream;
    auto* launch = stream_mode
                       ? (sort ? rt_launch_forest<true, true> : rt_launch_forest<true, false>)
                       : (sort ? rt_launch_forest<false, true> : rt_launch_forest<false, false>);
    launch(table, blocks, st, G, g0, (const int*)gid, (const int*)row, (const int*)hi,
           (const int*)xi, (const int*)ctr, (const int*)off, (int*)out, (float*)xi_out, Q,
           vec, flat_bits, end_bit);
    return (int)cudaGetLastError();
}
