// cdf_scan: row-wise inclusive prefix sums for CDF construction.
//
// Replaces the TPU kernel repro/kernels/cdf_scan.py `cdf_scan`
// (`_stats_kernel`, `_scan_kernel`). Three modes over a (B, V) row block:
//   mode 0, softmax: out = cumsum(exp(x - max)) / sum(exp(x - max));
//   mode 1, weights: out = cumsum(x) / sum(x);
//   mode 2, raw:     out = cumsum(x)  (the row scan of chunked_cumsum).
// The TPU walks a row's tiles on a sequential grid axis and carries the
// running sum in VMEM scratch. Blocks on Hopper share no order, so a row is
// split over the blocks of one thread-block cluster instead, which read each
// other's shared memory. Bound on the H100: bytes, 4 B (2 B for bf16) read
// and 4 B written per element; the row is read once and written once.
//
// The launch plan (regime, cluster size, slice, threads, rounds) is chosen
// in Python by `kernels/cdf_scan.py:scan_plan` from V alone and checked
// here, so a row's bits depend only on its contents and V: the same row
// alone, in any stack, and from run to run. A warp covers its elements in
// rounds of 128 (4 consecutive elements a lane, so every load and store is
// one coalesced 16-byte access a lane, 8 bytes for bf16 input). Every sum
// runs in a fixed order (no atomics, no look-back):
//   * a lane scans a round's four elements in order;
//   * a shuffle-up scan joins the lanes of a round, a running carry the
//     rounds of a warp, and the warps' totals in warp order give each warp's
//     prefix;
//   * a cluster joins its blocks in rank order, each block reading every
//     rank's published values through distributed shared memory.
// The terms are scanned before they are normalized: the row sum is the
// scan's own total, and each output is one IEEE division of its prefix by
// it, so a normalized row ends at exactly 1.
// Regimes:
//   0 (warp):    V <= 1024: one warp a row, 4 rows a block, the row's 1-8
//                rounds in registers; softmax takes the warp max and
//                exp(x - max) there (the pool's chunk and carry rows);
//   1 (cluster): V up to 8 x 32768: one cluster of 1-8 blocks a row, each
//                block a contiguous slice of at most 32768 elements in shared
//                memory (at most 128 KB, two blocks an SM). Softmax first
//                loads the slice and takes the block max m_b; every mode then
//                scans exp(x - m_b), x or raw x, reading the row here in the
//                other modes. A block publishes (m_b, its prefix at its last
//                element T_b); after the one cluster barrier each block reads
//                them all: M = max m_q, shares T_q * exp(m_q - M) (softmax) or
//                T_q, the row sum s = the shares in rank order and the base =
//                the lower ranks' shares in rank order; it writes
//                (base + exp(m_b - M) * prefix) / s, (base + prefix) / s or
//                base + prefix. A slice's last output is exactly the next
//                slice's base. One more barrier before exit keeps shared
//                memory alive for the other ranks' reads;
//   2 (block):   longer rows: one block a row walks its tiles of 1024 with a
//                running carry, after a stats pass over the row (the row is
//                read twice in the normalized modes).
// IEEE expf and division (no fast math); products and sums that must not
// fuse into one rounding use __fmul_rn / __fadd_rn.
#include "common.cuh"
#include <cooperative_groups.h>
#include <cuda_bf16.h>

namespace cg = cooperative_groups;

#define MODE_SOFTMAX 0
#define MODE_WEIGHTS 1
#define MODE_RAW 2
#define NEG_INF (-1e30f)
#define FULL 0xffffffffu

#define ROUND 128                    // elements a warp covers in one round
#define WARP_ROWS_MAX 8              // regime 0: most rows (warps) a block
#define CLUSTER_MAX 8                // regime 1: portable cluster size
#define CLUSTER_WARPS 32             // regime 1: most warps a block
#define CLUSTER_ROUNDS 8             // regime 1: most rounds a warp
#define BLOCK_THREADS 256            // regime 2
#define BLOCK_ITEMS 4
#define BLOCK_WARPS (BLOCK_THREADS / 32)

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
}

// Elements p[0..3], n of them valid (the rest 0): one 16-byte (8 for bf16)
// load where `vec` says the run is aligned; the values are the same either way.
__device__ __forceinline__ void load4(const float* p, int n, bool vec, float (&a)[4]) {
    if (vec && n >= 4) {
        const float4 u = __ldg(reinterpret_cast<const float4*>(p));
        a[0] = u.x; a[1] = u.y; a[2] = u.z; a[3] = u.w;
        return;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = i < n ? p[i] : 0.0f;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, int n, bool vec, float (&a)[4]) {
    if (vec && n >= 4) {
        const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
        a[0] = __uint_as_float(u.x << 16); a[1] = __uint_as_float(u.x & 0xffff0000u);
        a[2] = __uint_as_float(u.y << 16); a[3] = __uint_as_float(u.y & 0xffff0000u);
        return;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = i < n ? load_f32(p + i) : 0.0f;
}

__device__ __forceinline__ void store4(float* p, int n, bool vec, const float (&a)[4]) {
    if (vec && n >= 4) {
        *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
        return;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
        if (i < n) p[i] = a[i];
}

template <typename T>
__device__ __forceinline__ bool aligned_run(const T* p) {
    return (reinterpret_cast<uintptr_t>(p) & (4 * sizeof(T) - 1)) == 0;
}

__device__ __forceinline__ float warp_incl_scan(float v, int lane) {
    for (int o = 1; o < 32; o <<= 1) {
        float u = __shfl_up_sync(FULL, v, o);
        if (lane >= o) v += u;
    }
    return v;
}

// Butterfly max: every lane ends with the warp's max.
__device__ __forceinline__ float warp_max(float v) {
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
    return v;
}

// Every lane gets the values of lanes 0..n-1 (1 <= n <= N) summed in lane order.
template <int N>
__device__ __forceinline__ float lanes_sum(float v, int n) {
    float t = __shfl_sync(FULL, v, 0);
#pragma unroll
    for (int i = 1; i < N; ++i) {
        const float u = __shfl_sync(FULL, v, i);
        if (i < n) t += u;
    }
    return t;
}
// Every lane gets 0 plus the values of lanes 0..k-1 (0 <= k < N), in order.
template <int N>
__device__ __forceinline__ float lanes_prefix(float v, int k) {
    float t = 0.0f;
#pragma unroll
    for (int i = 0; i < N - 1; ++i) {
        const float u = __shfl_sync(FULL, v, i);
        if (i < k) t += u;
    }
    return t;
}

// One round of a warp's scan: a <- (carry + the lane's exclusive prefix) +
// the lane's running prefix of a; carry += the round's total.
__device__ __forceinline__ void round_scan(float (&a)[4], float& carry, int lane) {
    a[1] += a[0];
    a[2] += a[1];
    a[3] += a[2];
    const float incl = warp_incl_scan(a[3], lane);
    float excl = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) excl = 0.0f;
    const float base = carry + excl;
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = base + a[i];
    carry += __shfl_sync(FULL, incl, 31);
}

// round_scan over R rounds held in registers, with the same additions; the
// rounds' shuffles are issued together, level by level.
template <int R>
__device__ __forceinline__ void rounds_scan(float (&a)[R][4], int lane) {
    float incl[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
        a[j][1] += a[j][0];
        a[j][2] += a[j][1];
        a[j][3] += a[j][2];
        incl[j] = a[j][3];
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        float u[R];
#pragma unroll
        for (int j = 0; j < R; ++j) u[j] = __shfl_up_sync(FULL, incl[j], o);
#pragma unroll
        for (int j = 0; j < R; ++j)
            if (lane >= o) incl[j] += u[j];
    }
    float carry = 0.0f;
#pragma unroll
    for (int j = 0; j < R; ++j) {
        float excl = __shfl_up_sync(FULL, incl[j], 1);
        if (lane == 0) excl = 0.0f;
        const float base = carry + excl;
#pragma unroll
        for (int i = 0; i < 4; ++i) a[j][i] = base + a[j][i];
        carry += __shfl_sync(FULL, incl[j], 31);
    }
}

// ---------------------------------------------------------------- regime 0

template <typename T, int R>
__global__ void __launch_bounds__(WARP_ROWS_MAX * 32)
cdf_scan_warp(const T* __restrict__ x, float* __restrict__ out, int B, int V, int mode) {
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (row >= B) return;
    const T* src = x + (size_t)row * V;
    float* dst = out + (size_t)row * V;
    const bool vin = aligned_run(src), vout = aligned_run(dst);
    float a[R][4];
#pragma unroll
    for (int j = 0; j < R; ++j) load4(src + j * ROUND + 4 * lane, V - j * ROUND - 4 * lane, vin, a[j]);
    if (mode == MODE_SOFTMAX) {
        float m = NEG_INF;
#pragma unroll
        for (int j = 0; j < R; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i)
                if (j * ROUND + 4 * lane + i < V) m = fmaxf(m, a[j][i]);
        m = warp_max(m);
#pragma unroll
        for (int j = 0; j < R; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i)
                a[j][i] = j * ROUND + 4 * lane + i < V ? expf(a[j][i] - m) : 0.0f;
    }
    rounds_scan<R>(a, lane);
    if (mode != MODE_RAW) {
        // The row sum is the prefix at the last element (round R - 1 holds
        // it; a lane's later items add zeros), so the row ends at exactly 1.
        const float total = __shfl_sync(FULL, a[R - 1][3], ((V - 1) % ROUND) / 4);
#pragma unroll
        for (int j = 0; j < R; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) a[j][i] = a[j][i] / total;
    }
#pragma unroll
    for (int j = 0; j < R; ++j) store4(dst + j * ROUND + 4 * lane, V - j * ROUND - 4 * lane, vout, a[j]);
}

// ---------------------------------------------------------------- regime 1

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_barrier() {
    cluster_arrive();
    cluster_wait();
}

// Dynamic shared memory: the slice (warps x rounds x 128 floats; warp w owns
// the w-th contiguous span), then two arrays of one float a warp (warp maxima;
// warp totals, then the warps' exclusive prefixes), then the two values a
// block publishes to its cluster: its max (softmax) and its total, the local
// prefix at the slice's last element.
template <typename T>
__global__ void __launch_bounds__(CLUSTER_WARPS * 32, 2)
cdf_scan_cluster(const T* __restrict__ x, float* __restrict__ out, int V, int mode,
                 int slice, int rounds) {
    extern __shared__ float4 smem4[];
    cg::cluster_group cluster = cg::this_cluster();
    const int ranks = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    const int row = blockIdx.x / ranks;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int warps = blockDim.x >> 5;
    const int span = rounds * ROUND;  // elements a warp owns
    float* data = reinterpret_cast<float*>(smem4);
    float* part_max = data + warps * span;
    float* part_scan = part_max + warps;
    float* pub = part_scan + warps;

    const int s0 = rank * slice;
    const int n = max(0, min(slice, V - s0));
    const T* src = x + (size_t)row * V + s0;
    float* dst = out + (size_t)row * V + s0;
    const bool vin = aligned_run(src), vout = aligned_run(dst);
    const int first = warp * span + 4 * lane;  // this lane's element in round 0

    // Softmax: load the slice once into shared memory and take the block max.
    float bmax = 0.0f;
    if (mode == MODE_SOFTMAX) {
        float m = NEG_INF;
#pragma unroll 4
        for (int j = 0; j < rounds; ++j) {
            const int e = first + j * ROUND;
            float a[4];
            load4(src + e, n - e, vin, a);
#pragma unroll
            for (int i = 0; i < 4; ++i)
                if (e + i < n) m = fmaxf(m, a[i]);
            smem4[e >> 2] = make_float4(a[0], a[1], a[2], a[3]);
        }
        m = warp_max(m);
        if (lane == 0) part_max[warp] = m;
        __syncthreads();
        bmax = warp_max(lane < warps ? part_max[lane] : NEG_INF);
    }

    // The warp's scan over its rounds of exp(x - max), x (read once from the
    // row here) or raw x; carry ends as the warp's total.
    float carry = 0.0f;
#pragma unroll 4
    for (int j = 0; j < rounds; ++j) {
        const int e = first + j * ROUND;
        float a[4];
        if (mode == MODE_SOFTMAX) {
            const float4 f = smem4[e >> 2];
            a[0] = f.x; a[1] = f.y; a[2] = f.z; a[3] = f.w;
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = e + i < n ? expf(a[i] - bmax) : 0.0f;
        } else {
            load4(src + e, n - e, vin, a);
        }
        round_scan(a, carry, lane);
        smem4[e >> 2] = make_float4(a[0], a[1], a[2], a[3]);
    }

    // The warps' exclusive prefixes (warp 0, in order) and the block's total.
    if (lane == 0) part_scan[warp] = carry;
    __syncthreads();
    if (warp == 0) {
        const float wtot = lane < warps ? part_scan[lane] : 0.0f;
        float run = 0.0f, mine = 0.0f;
#pragma unroll
        for (int w = 0; w < CLUSTER_WARPS; ++w) {
            const float u = __shfl_sync(FULL, wtot, w);
            if (lane == w) mine = run;
            if (w < warps) run += u;
        }
        __syncwarp();
        if (lane < warps) part_scan[lane] = mine;
        if (n > 0 && lane == (n - 1) / span) {
            pub[0] = bmax;
            pub[1] = mine + data[n - 1];
        }
    }
    __syncthreads();
    const float wpre = part_scan[warp];

    // The one exchange: each warp reads every rank's (max, total) into its
    // lanes. A rank's share is total * exp(max - M) (softmax, M the row max)
    // or its total; the row sum s adds the shares in rank order, this
    // block's base the lower ranks' shares in the same order, so a slice's
    // last output is exactly the next slice's base, and the last is s / s.
    cluster_barrier();
    const float tq = lane < ranks ? *cluster.map_shared_rank(pub + 1, lane) : 0.0f;
    float scale = 1.0f, share = tq;
    if (mode == MODE_SOFTMAX) {
        const float mq = lane < ranks ? *cluster.map_shared_rank(pub, lane) : NEG_INF;
        const float mx = warp_max(mq);
        share = __fmul_rn(tq, expf(mq - mx));
        scale = expf(bmax - mx);
    }
    const float total = lanes_sum<CLUSTER_MAX>(share, ranks);
    const float base = lanes_prefix<CLUSTER_MAX>(share, rank);
    cluster_arrive();  // done reading the other ranks' shared memory
#pragma unroll 4
    for (int j = 0; j < rounds; ++j) {
        const int e = first + j * ROUND;
        const float4 f = smem4[e >> 2];
        float a[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float t = wpre + a[i];
            a[i] = mode == MODE_RAW ? base + t
                 : __fadd_rn(base, mode == MODE_SOFTMAX ? __fmul_rn(scale, t) : t) / total;
        }
        store4(dst + e, n - e, vout, a);
    }
    cluster_wait();    // no block leaves while a reader may still need it
}

// ---------------------------------------------------------------- regime 2

// Online softmax statistics: (mx, s) with s = sum exp(x - mx).
__device__ __forceinline__ void stats_merge(float& mx, float& s, float mx2,
                                            float s2) {
    float mn = fmaxf(mx, mx2);
    s = s * expf(mx - mn) + s2 * expf(mx2 - mn);
    mx = mn;
}

template <typename T>
__global__ void __launch_bounds__(BLOCK_THREADS)
cdf_scan_block(const T* __restrict__ x, float* __restrict__ out, int V, int mode) {
    __shared__ float red_m[BLOCK_WARPS];
    __shared__ float red_s[BLOCK_WARPS];
    __shared__ float wsum[BLOCK_WARPS];
    __shared__ float wpre[BLOCK_WARPS];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const T* row = x + (size_t)blockIdx.x * V;
    float* orow = out + (size_t)blockIdx.x * V;

    // Pass 1: row statistics (softmax max + sum of exp, or the plain sum).
    float rmax = 0.0f, rsum = 1.0f;
    if (mode != MODE_RAW) {
        float mx = mode == MODE_SOFTMAX ? NEG_INF : 0.0f, s = 0.0f;
        for (int i = tid; i < V; i += BLOCK_THREADS) {
            float v = load_f32(row + i);
            if (mode == MODE_SOFTMAX) {
                if (v > mx) { s = s * expf(mx - v) + 1.0f; mx = v; }
                else s += expf(v - mx);
            } else {
                s += v;
            }
        }
        for (int o = 16; o > 0; o >>= 1) {
            float mx2 = __shfl_xor_sync(0xffffffffu, mx, o);
            float s2 = __shfl_xor_sync(0xffffffffu, s, o);
            if (mode == MODE_SOFTMAX) stats_merge(mx, s, mx2, s2); else s += s2;
        }
        if (lane == 0) { red_m[warp] = mx; red_s[warp] = s; }
        __syncthreads();
        mx = red_m[0]; s = red_s[0];
        for (int w = 1; w < BLOCK_WARPS; ++w) {
            if (mode == MODE_SOFTMAX) stats_merge(mx, s, red_m[w], red_s[w]);
            else s += red_s[w];
        }
        rmax = mx; rsum = s;
    }

    // Pass 2: normalized elements, tile scan, running carry.
    float carry = 0.0f;
    for (int t0 = 0; t0 < V; t0 += BLOCK_THREADS * BLOCK_ITEMS) {
        const int base = t0 + tid * BLOCK_ITEMS;
        float v[BLOCK_ITEMS];
#pragma unroll
        for (int k = 0; k < BLOCK_ITEMS; ++k) {
            float e = 0.0f;
            if (base + k < V) {
                float xv = load_f32(row + base + k);
                e = mode == MODE_SOFTMAX ? expf(xv - rmax) / rsum
                    : mode == MODE_WEIGHTS ? xv / rsum : xv;
            }
            v[k] = k ? v[k - 1] + e : e;
        }
        float incl = warp_incl_scan(v[BLOCK_ITEMS - 1], lane);
        float lane_excl = __shfl_up_sync(0xffffffffu, incl, 1);
        if (lane == 0) lane_excl = 0.0f;
        if (lane == 31) wsum[warp] = incl;
        __syncthreads();
        if (warp == 0) {
            float w = warp_incl_scan(lane < BLOCK_WARPS ? wsum[lane] : 0.0f, lane);
            if (lane < BLOCK_WARPS) wpre[lane] = w;
        }
        __syncthreads();
        const float excl = (warp ? wpre[warp - 1] : 0.0f) + lane_excl;
#pragma unroll
        for (int k = 0; k < BLOCK_ITEMS; ++k)
            if (base + k < V) orow[base + k] = carry + (excl + v[k]);
        carry += wpre[BLOCK_WARPS - 1];
    }
}

// ---------------------------------------------------------------- launch

template <typename T, int R>
static cudaError_t launch_warp(const T* x, float* out, int B, int V, int mode,
                               int threads, cudaStream_t st) {
    const int rows = threads / 32;
    cdf_scan_warp<T, R><<<(B + rows - 1) / rows, threads, 0, st>>>(x, out, B, V, mode);
    return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_cluster(const T* x, float* out, int B, int V, int mode,
                                  int ranks, int slice, int threads, int rounds, int smem,
                                  cudaStream_t st) {
    // Above 48 KB a block's dynamic shared memory needs this attribute, set
    // once a device for each instance.
    static unsigned opted_in = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 32 && !(opted_in >> dev & 1u)) {
        err = cudaFuncSetAttribute(cdf_scan_cluster<T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   4 * (CLUSTER_WARPS * (CLUSTER_ROUNDS * ROUND + 2) + 2));
        if (err != cudaSuccess) return err;
        opted_in |= 1u << dev;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)B * (unsigned)ranks, 1, 1);
    cfg.blockDim = dim3((unsigned)threads, 1, 1);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)ranks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, cdf_scan_cluster<T>, x, out, V, mode, slice, rounds);
    return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
static cudaError_t run(const T* x, float* out, int B, int V, int mode, int regime,
                       int ranks, int slice, int threads, int rounds, int smem,
                       cudaStream_t st) {
    if (regime == 0) {
        if (ranks != 1 || threads % 32 || threads < 32 || threads > WARP_ROWS_MAX * 32 ||
            slice != rounds * ROUND || slice < V || slice - ROUND >= V || smem != 0)
            return cudaErrorInvalidValue;
        switch (rounds) {
            case 1: return launch_warp<T, 1>(x, out, B, V, mode, threads, st);
            case 2: return launch_warp<T, 2>(x, out, B, V, mode, threads, st);
            case 3: return launch_warp<T, 3>(x, out, B, V, mode, threads, st);
            case 4: return launch_warp<T, 4>(x, out, B, V, mode, threads, st);
            case 5: return launch_warp<T, 5>(x, out, B, V, mode, threads, st);
            case 6: return launch_warp<T, 6>(x, out, B, V, mode, threads, st);
            case 7: return launch_warp<T, 7>(x, out, B, V, mode, threads, st);
            case 8: return launch_warp<T, 8>(x, out, B, V, mode, threads, st);
            default: return cudaErrorInvalidValue;
        }
    }
    if (regime == 1) {
        const int warps = threads / 32;
        if (ranks < 1 || ranks > CLUSTER_MAX || threads % 32 || warps < 1 ||
            warps > CLUSTER_WARPS || rounds < 1 || rounds > CLUSTER_ROUNDS || slice % 8 ||
            warps * rounds * ROUND < slice || (long long)ranks * slice < V ||
            (long long)(ranks - 1) * slice >= V ||
            smem != 4 * (warps * (rounds * ROUND + 2) + 2))
            return cudaErrorInvalidValue;
        return launch_cluster<T>(x, out, B, V, mode, ranks, slice, threads, rounds, smem, st);
    }
    if (regime == 2) {
        if (ranks != 1 || threads != BLOCK_THREADS || rounds != 1 || slice != V || smem != 0)
            return cudaErrorInvalidValue;
        cdf_scan_block<T><<<B, BLOCK_THREADS, 0, st>>>(x, out, V, mode);
        return cudaGetLastError();
    }
    return cudaErrorInvalidValue;
}

RT_API int rt_cdf_scan(const void* x, void* out, int B, int V, int mode, int is_bf16,
                       int regime, int ranks, int slice, int threads, int rounds,
                       int smem, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (is_bf16)
        return (int)run<__nv_bfloat16>((const __nv_bfloat16*)x, (float*)out, B, V, mode,
                                       regime, ranks, slice, threads, rounds, smem, st);
    return (int)run<float>((const float*)x, (float*)out, B, V, mode, regime, ranks,
                           slice, threads, rounds, smem, st);
}
