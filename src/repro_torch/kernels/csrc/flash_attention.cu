// flash_attention: online-softmax attention over key tiles, forward only.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py `flash_attention`
// (`_flash_kernel`, grid (B, H, Sq/Tq, Sk/Tk) with the key axis sequential
// and m/l/acc carried in VMEM scratch). On Hopper one block owns one query
// tile of one (head, batch row) and loops over the key tiles itself, so
// nothing carries between blocks. Per key tile, as on the TPU:
//   s = (q . k) * scale  (float32; keys >= Sk, and keys > query when causal,
//                         masked),
//   m_new = max(m, rowmax s),  p = exp(s - m_new),  alpha = exp(m - m_new),
//   l = l * alpha + rowsum p,  acc = acc * alpha + p . v,  m = m_new;
// and out = acc / max(l, 1e-30) in q's dtype. Query head h reads key head
// h / G (GQA), and the (B, S, heads, hd) layout is read through its strides,
// with no transpose copy. Two bodies, chosen by dtype in rt_flash_attention
// (a dispatch by type: neither retreats to the other):
//
// bfloat16: `flash_attention_bf16_wgmma`, on the tensor cores. A block of
// 288 threads owns a 128-row query tile: two consumer warpgroups of 64 rows
// each (wgmma's M) and one producer warp. The producer loads Q once and the
// K and V tiles of 128 keys into a two-stage ring with TMA (4-D tensor maps
// over (B, S, heads, hd) built from the strides, 128-byte swizzle; 64-byte
// at hd 32, whose rows are 64 B), signalling full/empty mbarriers. Each
// consumer warpgroup computes S = Q K^T with wgmma m64n128k16 (A and B from
// shared memory, K-major), applies the scale times log2(e) to S in float32
// after the product (the reference scales q before it: the two differ by
// rounding only, and not at all at hd 64, where the scale is 1/8), masks
// (diagonal and ragged tiles only; zero-filled keys past Sk are masked, not
// trusted), takes row max and sum over the quad of lanes that shares a row,
// p = 2^(s - m) in one MUFU.EX2 (exact zeros for masked lanes), rounds the
// unnormalized P to bf16 (as the JAX einsum path rounds its softmax
// weights) and converts the accumulator layout of S into wgmma's register-A
// fragments without shuffles, then O += P V with A from registers and B = V
// from shared memory, MN-major (the transpose bit). The two warpgroups take
// turns issuing S (named barriers), so the softmax of one overlaps the
// products of the other. Tiles wholly above the diagonal are not visited;
// the grid puts the last query tiles (the longest under causal masking)
// first. The tensor maps are encoded on the host per call through
// cuTensorMapEncodeTiled, fetched with cudaGetDriverEntryPoint(ByVersion),
// so the library links without -lcuda; an encode failure returns 10000 +
// the CUresult. TMA needs 16-byte-aligned base addresses and strides: the
// wrapper copies an input that breaks that.
//
// float32: `flash_attention_f32`, the CUDA-core body: one 256-thread block
// per (64-row query tile, head, batch row) over 64-key tiles, FMA from
// float32 shared memory, `expf`. On the tensor cores float32 would run as
// TF32 (10-bit mantissa) and miss the JAX suite's float32 tolerance of
// 2e-5, so it stays here; the eval path runs bf16.
//
// Bound on the H100 at the eval shape (B 2, S 2048, 16 heads, hd 64, bf16,
// causal): 2*2*B*H*hd FLOPs per visible (query, key) pair, 17.2 GFLOP,
// against 989 TFLOP/s of dense bf16 tensor-core work is 0.0174 ms, above the
// 0.010 ms of q/k/v/o bytes at 3.35 TB/s: operations bind. The earlier
// float32 CUDA-core body for bf16 measured 0.99 ms there (57x the bound);
// this one ~0.059 ms, level with scaled_dot_product_attention (NVIDIA H100
// 80GB HBM3, 700 W; PERF.md). At hd 64 the 16 exp2 a clock of an SM take as
// long as the two products of a tile, so the softmax, not the tensor cores,
// is the next limit; issuing the next tile's S before the last tile's P V
// (one warpgroup overlapping itself) measured slower here and spilled at hd
// 128.
#include "common.cuh"
#include <cuda.h>
#include <cuda_bf16.h>

struct FaStrides {
    long long b, s, h;  // elements; the head dim is dense
};

// ---------------------------------------------------------------------------
// float32: the CUDA-core body.
// ---------------------------------------------------------------------------

#define FA_BQ 64
#define FA_BK 64
#define FA_THREADS 256
#define FA_NEG_INF (-1e30f)

template <int HD>
__host__ __device__ constexpr int fa_smem_floats() {
    return FA_BQ * (HD + 1) + FA_BK * (HD + 1) + FA_BK * HD + FA_BQ * (FA_BK + 1);
}

// Layout: Q (scaled), K, V and P tiles in shared memory as float32 (Q and K
// rows padded by one word, so the 16 threads of a row group read 16 banks);
// thread (ty, tx) of a 16 x 16 grid owns rows ty + 16i (i < 4) of the tile,
// score columns tx + 16j (j < 4) and output columns tx + 16c (c < hd/16);
// row max and sum are shuffles over the 16 lanes of a row group. Shared
// memory: 66 KB at hd 64, 113 KB at hd 128. Masked lanes give exact zeros:
// expf(-1e30 - m) is 0 (no fast-math __expf).
template <int HD>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o, int Sq, int Sk,
                    int G, FaStrides sq, FaStrides sk, FaStrides sv, FaStrides so,
                    int causal, float scale) {
    constexpr int QP = HD + 1;       // padded row of Qs and Ks
    constexpr int PP = FA_BK + 1;    // padded row of Ps
    constexpr int DC = HD / 16;      // output columns a thread owns
    extern __shared__ float smem[];
    float* Qs = smem;                // [FA_BQ][QP]
    float* Ks = Qs + FA_BQ * QP;     // [FA_BK][QP]
    float* Vs = Ks + FA_BK * QP;     // [FA_BK][HD]
    float* Ps = Vs + FA_BK * HD;     // [FA_BQ][PP]

    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int q0 = blockIdx.x * FA_BQ, h = blockIdx.y, b = blockIdx.z;
    const int hk = h / G;
    const float* qb = q + b * sq.b + h * sq.h;
    const float* kb = k + b * sk.b + hk * sk.h;
    const float* vb = v + b * sv.b + hk * sv.h;

    for (int e = tid; e < FA_BQ * HD; e += FA_THREADS) {
        const int r = e / HD, d = e % HD, s = q0 + r;
        Qs[r * QP + d] = s < Sq ? __ldg(qb + s * sq.s + d) * scale : 0.f;
    }

    float m[4], l[4], acc[4][DC];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = FA_NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
    }

    // Keys past the tile's last query are masked for every row when causal.
    const int kend = causal ? min(Sk, q0 + FA_BQ) : Sk;
    for (int k0 = 0; k0 < kend; k0 += FA_BK) {
        __syncthreads();  // the last tile's readers of Ks/Vs/Ps are done
        for (int e = tid; e < FA_BK * HD; e += FA_THREADS) {
            const int r = e / HD, d = e % HD, s = k0 + r;
            const bool in = s < Sk;
            Ks[r * QP + d] = in ? __ldg(kb + s * sk.s + d) : 0.f;
            Vs[r * HD + d] = in ? __ldg(vb + s * sv.s + d) : 0.f;
        }
        __syncthreads();

        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) {
            float qv[4], kv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * QP + d];
#pragma unroll
            for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * QP + d];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int qpos = q0 + ty + 16 * i;
            float mx = FA_NEG_INF;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int kpos = k0 + tx + 16 * j;
                const bool valid = kpos < Sk && (!causal || kpos <= qpos);
                sc[i][j] = valid ? sc[i][j] : FA_NEG_INF;
                mx = fmaxf(mx, sc[i][j]);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[i], mx);
            float rs = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = expf(sc[i][j] - m_new);
                Ps[(ty + 16 * i) * PP + tx + 16 * j] = p;
                rs += p;
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                rs += __shfl_xor_sync(0xffffffffu, rs, off);
            const float alpha = expf(m[i] - m_new);
            l[i] = l[i] * alpha + rs;
            m[i] = m_new;
#pragma unroll
            for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
        }
        __syncthreads();

#pragma unroll 4
        for (int c = 0; c < FA_BK; ++c) {
            float pv[4], vv[DC];
#pragma unroll
            for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PP + c];
#pragma unroll
            for (int cc = 0; cc < DC; ++cc) vv[cc] = Vs[c * HD + tx + 16 * cc];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int cc = 0; cc < DC; ++cc) acc[i][cc] = fmaf(pv[i], vv[cc], acc[i][cc]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int s = q0 + ty + 16 * i;
        if (s >= Sq) continue;
        const float denom = fmaxf(l[i], 1e-30f);
        float* ob = o + b * so.b + s * so.s + h * so.h;
#pragma unroll
        for (int c = 0; c < DC; ++c) ob[tx + 16 * c] = acc[i][c] / denom;
    }
}

template <int HD>
static int fa_f32_launch(const void* q, const void* k, const void* v, void* o, int B,
                         int Sq, int Sk, int H, int KV, FaStrides sq, FaStrides sk,
                         FaStrides sv, FaStrides so, int causal, float scale,
                         cudaStream_t stream) {
    const int smem = (int)(sizeof(float) * fa_smem_floats<HD>());
    cudaError_t e = cudaFuncSetAttribute(flash_attention_f32<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((Sq + FA_BQ - 1) / FA_BQ, H, B);
    flash_attention_f32<HD><<<grid, FA_THREADS, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, Sq, Sk, H / KV, sq, sk,
        sv, so, causal, scale);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core body (wgmma, TMA, mbarriers), raw PTX.
// ---------------------------------------------------------------------------

#define FA_TQ 128                  // query rows of a block: two warpgroups of 64
#define FA_TK 128                  // keys of a tile
#define FA_CONSUMERS 256           // two consumer warpgroups
#define FA_WG_THREADS (FA_CONSUMERS + 32)  // plus one producer warp
#define FA_TMA_ERROR 10000         // + CUresult of a failed tensor-map encode

// Shared-memory tiles of a [rows][HD] bf16 matrix: column blocks of SWB bytes
// a row (the swizzle width), each block [rows][SWB] as TMA writes it.
template <int HD>
struct FaTile {
    static constexpr int SWB = HD * 2 < 128 ? HD * 2 : 128;
    static constexpr int NB = SWB / 2;                 // columns of a block
    static constexpr int CB = HD / NB;                 // blocks
    static constexpr int Q_BYTES = FA_TQ * HD * 2;
    static constexpr int KV_BYTES = FA_TK * HD * 2;    // one K (or V) stage
    static constexpr int SMEM = 1024 + Q_BYTES + 4 * KV_BYTES + 64;
};

__device__ __forceinline__ uint32_t fa_smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void fa_mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void fa_mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void fa_mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed. A
// wait that never ends (a lost TMA transaction) traps instead of hanging.
__device__ __forceinline__ void fa_mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    for (uint32_t spins = 0;; ++spins) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
        if (done) return;
        if (spins == (1u << 26)) __trap();
    }
}

// TMA: box (c0 column, c1 row, c2 head, c3 batch) of a 4-D tensor map into
// shared memory; completion counted in bytes on the barrier.
__device__ __forceinline__ void fa_tma_load(uint32_t dst, const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
           "r"(c3), "r"(bar)
        : "memory");
}

// wgmma shared-memory descriptor of a swizzled tile at `addr`: 8-row groups
// SBO = 8 * SWB bytes apart; the leading offset is unused (each instruction
// reads within one swizzle atom along its K-major K or MN-major N); swizzle
// mode 1 = 128 B, 2 = 64 B.
template <int SWB>
__device__ __forceinline__ uint64_t fa_desc(uint32_t addr) {
    constexpr uint64_t mode = SWB == 128 ? 1 : 2;
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
           ((uint64_t)((8 * SWB) >> 4) << 32) | (mode << 62);
}

__device__ __forceinline__ void fa_wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void fa_wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void fa_wgmma_wait0() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma (its asm operands look complete at issue).
template <int N>
__device__ __forceinline__ void fa_fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// Named barriers over the two consumer warpgroups (id 0 is __syncthreads).
__device__ __forceinline__ void fa_bar_sync(int id) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "n"(FA_CONSUMERS) : "memory");
}
__device__ __forceinline__ void fa_bar_arrive(int id) {
    asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "n"(FA_CONSUMERS) : "memory");
}

// 2^x in one MUFU.EX2 (relative error ~2^-22; -inf gives +0; results below
// 2^-126 flush to zero, far under any weight that moves a bf16 output).
__device__ __forceinline__ float fa_exp2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t fa_pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 128, float32) += A (64 x 16 bf16, shared, K-major) * B (128 x 16
// bf16, shared, K-major); scale_d = 0 overwrites D.
__device__ __forceinline__ void fa_wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                                int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, float32) += A (64 x 16 bf16, registers) * B (16 x 64 bf16,
// shared, MN-major: the transpose bit is set).
__device__ __forceinline__ void fa_wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 32, float32) += A (64 x 16 bf16, registers) * B (16 x 32 bf16,
// shared, MN-major: the transpose bit is set).
__device__ __forceinline__ void fa_wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                               uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int NB>
__device__ __forceinline__ void fa_wgmma_pv(float (&d)[NB / 2], const uint32_t (&a)[4],
                                            uint64_t db) {
    if constexpr (NB == 64) fa_wgmma_rs_n64(d, a, db);
    else fa_wgmma_rs_n32(d, a, db);
}

// Accumulator layout of wgmma m64nNk16 (float32) in warp w of a warpgroup,
// lane l: register i holds row 16w + l/4 (+8 when i & 2) and column
// 8 * (i / 4) + 2 * (l % 4) + (i & 1). Registers 8kk..8kk+7 of S are the
// 16 keys of step kk, exactly the register-A fragment of that step.
template <int HD>
__global__ void __launch_bounds__(FA_WG_THREADS, 1)
flash_attention_bf16_wgmma(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           __nv_bfloat16* __restrict__ o, FaStrides so, int Sq, int Sk,
                           int G, int nq, int causal, float scale) {
    using T = FaTile<HD>;
    constexpr int SWB = T::SWB, NB = T::NB, CB = T::CB;
    extern __shared__ __align__(1024) unsigned char fa_wg_smem[];
    const uint32_t base = (fa_smem_addr(fa_wg_smem) + 1023u) & ~1023u;
    const uint32_t sQ = base;                          // [CB][FA_TQ][SWB]
    const uint32_t sK = sQ + T::Q_BYTES;               // 2 stages of [CB][FA_TK][SWB]
    const uint32_t sV = sK + 2 * T::KV_BYTES;          // 2 stages of [CB][FA_TK][SWB]
    const uint32_t qbar = sV + 2 * T::KV_BYTES;        // then full[2], empty[2]
    const uint32_t full0 = qbar + 8, empty0 = qbar + 24;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int h = blockIdx.x, b = blockIdx.y;
    const int q0 = (nq - 1 - (int)blockIdx.z) * FA_TQ;   // longest causal tiles first
    const int kend = causal ? min(Sk, q0 + FA_TQ) : Sk;
    const int nt = (kend + FA_TK - 1) / FA_TK;

    if (tid == 0) {
        fa_mbar_init(qbar, 1);
        for (int s = 0; s < 2; ++s) {
            fa_mbar_init(full0 + 8 * s, 1);
            fa_mbar_init(empty0 + 8 * s, FA_CONSUMERS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp == FA_CONSUMERS / 32) {  // the producer warp: one lane issues TMA
        if (lane == 0) {
            const int hk = h / G;
            fa_mbar_expect_tx(qbar, T::Q_BYTES);
#pragma unroll
            for (int cb = 0; cb < CB; ++cb)
                fa_tma_load(sQ + cb * FA_TQ * SWB, &tm_q, cb * NB, q0, h, b, qbar);
            for (int t = 0; t < nt; ++t) {
                const int s = t & 1;
                if (t >= 2) fa_mbar_wait(empty0 + 8 * s, ((t >> 1) & 1) ^ 1);
                const uint32_t full = full0 + 8 * s;
                fa_mbar_expect_tx(full, 2 * T::KV_BYTES);
#pragma unroll
                for (int cb = 0; cb < CB; ++cb) {
                    const uint32_t off = s * T::KV_BYTES + cb * FA_TK * SWB;
                    fa_tma_load(sK + off, &tm_k, cb * NB, t * FA_TK, hk, b, full);
                    fa_tma_load(sV + off, &tm_v, cb * NB, t * FA_TK, hk, b, full);
                }
            }
        }
        return;
    }

    // Consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63.
    const int wg = warp >> 2, wq = warp & 3;
    const int rw = q0 + 64 * wg + 16 * wq;             // first row of this warp
    const int r0 = rw + (lane >> 2), r1 = r0 + 8;
    const int cq = 2 * (lane & 3);
    const float c = scale * 1.4426950408889634f;       // scale * log2(e)

    float acc[CB][NB / 2];
#pragma unroll
    for (int nb = 0; nb < CB; ++nb)
#pragma unroll
        for (int i = 0; i < NB / 2; ++i) acc[nb][i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // m in log2 units

    // The two warpgroups take turns issuing S = Q K^T (named barriers 1 and
    // 2), so one's softmax overlaps the other's products; warpgroup 0 first.
    if (wg == 1) fa_bar_arrive(1);
    fa_mbar_wait(qbar, 0);
    for (int t = 0; t < nt; ++t) {
        const int s = t & 1, k0 = t * FA_TK;
        fa_mbar_wait(full0 + 8 * s, (t >> 1) & 1);
        const uint32_t kt = sK + s * T::KV_BYTES, vt = sV + s * T::KV_BYTES;

        float sc[FA_TK / 2];
#pragma unroll
        for (int i = 0; i < FA_TK / 2; ++i) sc[i] = 0.f;
        fa_fence_regs(sc);
        fa_bar_sync(1 + wg);
        fa_wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {  // 16 columns of hd a step
            const int cb = kk * 32 / SWB, off = kk * 32 % SWB;
            fa_wgmma_ss_n128(sc, fa_desc<SWB>(sQ + cb * FA_TQ * SWB + wg * 64 * SWB + off),
                             fa_desc<SWB>(kt + cb * FA_TK * SWB + off), 1);
        }
        fa_wgmma_commit();
        if (wg == 0 || t + 1 < nt) fa_bar_arrive(2 - wg);  // the other's turn
        fa_wgmma_wait0();
        fa_fence_regs(sc);

        // Interior tiles need no mask: every key is < Sk and <= every row.
        if (k0 + FA_TK > Sk || (causal && k0 + FA_TK - 1 > rw)) {
#pragma unroll
            for (int i = 0; i < FA_TK / 2; ++i) {
                const int kpos = k0 + 8 * (i >> 2) + cq + (i & 1);
                const int qpos = (i & 2) ? r1 : r0;
                if (kpos >= Sk || (causal && kpos > qpos)) sc[i] = -INFINITY;
            }
        }
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int i = 0; i < FA_TK / 2; ++i) {
            if (i & 2) mx1 = fmaxf(mx1, sc[i]);
            else mx0 = fmaxf(mx0, sc[i]);
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {  // the quad that shares a row
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float n0 = fmaxf(m0, mx0 * c), n1 = fmaxf(m1, mx1 * c);
        const float u0 = n0 == -INFINITY ? 0.f : n0, u1 = n1 == -INFINITY ? 0.f : n1;
        const float a0 = fa_exp2(m0 - u0), a1 = fa_exp2(m1 - u1);
        m0 = n0;
        m1 = n1;
        float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
        for (int i = 0; i < FA_TK / 2; ++i) {
            if (i & 2) {
                sc[i] = fa_exp2(fmaf(sc[i], c, -u1));
                rs1 += sc[i];
            } else {
                sc[i] = fa_exp2(fmaf(sc[i], c, -u0));
                rs0 += sc[i];
            }
        }
        l0 = l0 * a0 + rs0;  // this lane's columns; the quad is summed at the end
        l1 = l1 * a1 + rs1;
#pragma unroll
        for (int nb = 0; nb < CB; ++nb)
#pragma unroll
            for (int i = 0; i < NB / 2; ++i) acc[nb][i] *= (i & 2) ? a1 : a0;
        uint32_t pa[FA_TK / 16][4];
#pragma unroll
        for (int kk = 0; kk < FA_TK / 16; ++kk)
#pragma unroll
            for (int r = 0; r < 4; ++r)
                pa[kk][r] = fa_pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

#pragma unroll
        for (int nb = 0; nb < CB; ++nb) fa_fence_regs(acc[nb]);
        fa_wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < FA_TK / 16; ++kk)  // 16 keys a step
#pragma unroll
            for (int nb = 0; nb < CB; ++nb)
                fa_wgmma_pv<NB>(acc[nb], pa[kk],
                                fa_desc<SWB>(vt + nb * FA_TK * SWB + kk * 16 * SWB));
        fa_wgmma_commit();
        fa_wgmma_wait0();
#pragma unroll
        for (int nb = 0; nb < CB; ++nb) fa_fence_regs(acc[nb]);
        fa_mbar_arrive(empty0 + 8 * s);  // this thread is done with the stage
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    __nv_bfloat16* ob = o + b * so.b + h * so.h;
#pragma unroll
    for (int nb = 0; nb < CB; ++nb)
#pragma unroll
        for (int i = 0; i < NB / 2; i += 2) {
            const int row = (i & 2) ? r1 : r0;
            const float d = (i & 2) ? d1 : d0;
            if (row < Sq)
                *reinterpret_cast<__nv_bfloat162*>(ob + row * so.s + nb * NB + 8 * (i >> 2) +
                                                   cq) =
                    __floats2bfloat162_rn(acc[nb][i] / d, acc[nb][i + 1] / d);
        }
}

typedef CUresult (*FaEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// The driver's tensor-map encoder, through the runtime (no -lcuda).
static FaEncodeTiled fa_encode_tiled() {
    static FaEncodeTiled fn = nullptr;
    if (!fn) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t e = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                      cudaEnableDefault, &found);
#endif
        if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<FaEncodeTiled>(p);
    }
    return fn;
}

// 4-D map (hd, S, heads, B) of a bf16 (B, S, heads, hd) tensor read through its
// strides; a box is `rows` rows of one column block. A dimension of size 1 is
// never stepped, so its stride is replaced by the dense one.
static int fa_make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads, int hd,
                       FaStrides st, int rows, int swb) {
    const FaEncodeTiled encode = fa_encode_tiled();
    if (!encode) return (int)cudaErrorSymbolNotFound;
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return (int)cudaErrorInvalidValue;
    const long long given[3] = {st.s, st.h, st.b};
    const long long dense[3] = {(long long)heads * hd, hd, (long long)S * heads * hd};
    const int size[3] = {S, heads, B};
    cuuint64_t strides[3];
    for (int i = 0; i < 3; ++i) {
        const long long e = size[i] == 1 ? dense[i] : given[i];
        if (e <= 0 || e % 8) return (int)cudaErrorInvalidValue;  // 16-byte multiples
        strides[i] = (cuuint64_t)e * 2;
    }
    const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)S, (cuuint64_t)heads,
                                (cuuint64_t)B};
    const cuuint32_t box[4] = {(cuuint32_t)(swb / 2), (cuuint32_t)rows, 1, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    const CUresult r = encode(
        map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
        unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
        swb == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : FA_TMA_ERROR + (int)r;
}

template <int HD>
static int fa_bf16_launch(const void* q, const void* k, const void* v, void* o, int B,
                          int Sq, int Sk, int H, int KV, FaStrides sq, FaStrides sk,
                          FaStrides sv, FaStrides so, int causal, float scale,
                          cudaStream_t stream) {
    using T = FaTile<HD>;
    CUtensorMap mq, mk, mv;
    int err = fa_make_map(&mq, q, B, Sq, H, HD, sq, FA_TQ, T::SWB);
    if (!err) err = fa_make_map(&mk, k, B, Sk, KV, HD, sk, FA_TK, T::SWB);
    if (!err) err = fa_make_map(&mv, v, B, Sk, KV, HD, sv, FA_TK, T::SWB);
    if (err) return err;
    cudaError_t e = cudaFuncSetAttribute(flash_attention_bf16_wgmma<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return (int)e;
    const int nq = (Sq + FA_TQ - 1) / FA_TQ;
    dim3 grid(H, B, nq);
    flash_attention_bf16_wgmma<HD><<<grid, FA_WG_THREADS, T::SMEM, stream>>>(
        mq, mk, mv, (__nv_bfloat16*)o, so, Sq, Sk, H / KV, nq, causal, scale);
    return (int)cudaGetLastError();
}

RT_API int rt_flash_attention(const void* q, const void* k, const void* v, void* o,
                              int B, int Sq, int Sk, int H, int KV, int hd,
                              long long sqb, long long sqs, long long sqh,
                              long long skb, long long sks, long long skh,
                              long long svb, long long svs, long long svh,
                              long long sob, long long sos, long long soh,
                              int causal, int bf16, float scale, void* stream) {
    const FaStrides sq{sqb, sqs, sqh}, sk{skb, sks, skh}, sv{svb, svs, svh},
        so{sob, sos, soh};
    cudaStream_t st = (cudaStream_t)stream;
#define FA_CASE(launch, HD)                                                          \
    return launch<HD>(q, k, v, o, B, Sq, Sk, H, KV, sq, sk, sv, so, causal, scale, st)
    if (bf16) {
        if (hd == 32) FA_CASE(fa_bf16_launch, 32);
        if (hd == 64) FA_CASE(fa_bf16_launch, 64);
        if (hd == 128) FA_CASE(fa_bf16_launch, 128);
    } else {
        if (hd == 32) FA_CASE(fa_f32_launch, 32);
        if (hd == 64) FA_CASE(fa_f32_launch, 64);
        if (hd == 128) FA_CASE(fa_f32_launch, 128);
    }
#undef FA_CASE
    return (int)cudaErrorInvalidValue;
}
