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
// with no transpose copy. Head dims 32, 64 and 128 have tiles of their own;
// hd 112 (Kimi K2) runs the hd-128 tile, whose columns past 112 read as
// zeros (TMA's out-of-bounds fill, or masked loads) and are not stored.
// Two bodies, chosen by dtype in rt_flash_attention (a dispatch by type:
// neither retreats to the other):
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
// float32: `flash_attention_f32_tf32x3`, on the tensor cores as three TF32
// products. TF32 alone (a 10-bit mantissa) misses the JAX suite's float32
// tolerance of 2e-5, so each operand x is split into hi = TF32(x) (rounded
// as cvt.rna.tf32.f32 rounds: nearest, ties away) and lo = TF32(x - hi),
// and each product is summed in float32 as lo.hi' + hi.lo' + hi.hi' (lo.lo'
// dropped): ~22 bits of every term. A CTA of two warpgroups (256 threads)
// owns a 128-row query tile, 64 rows a warpgroup, and walks key tiles of 64
// (32 at hd 128). Q is split once into hi/lo tiles in shared memory; each K
// tile, and each V tile transposed, is loaded, split and stored once for
// both warpgroups (65, 129 and 193 KB in all at hd 32, 64, 128; one CTA an
// SM), the next tile's loads issued before this tile's products. S = Q K^T
// and O += P V run as wgmma m64nNk8 on TF32, three a k-step, P's hi/lo
// taken from S's registers. wgmma takes 32-bit operands K-major only (no transpose bit),
// so V is stored transposed, with the keys of each group of 8 in the order
// that makes S's accumulator registers P's A fragment. An mma.sync m16n8k8
// form of this body measured 0.445 ms at the eval shape in float32, ~115
// TFLOP/s of TF32 (NVIDIA H100 80GB HBM3, 700 W; tools/ab_flash_f32.py):
// the HMMA issue rate, not the data, bound it; one warpgroup a 64-row CTA
// measured 8% slower at the eval shape and 32% at hd 128, 9% faster at
// (1, 1000, 4/2 heads). Where the query tiles of all heads and rows would
// leave SMs idle (32 CTAs at (1, 1000, 4 heads)), 2 or 4 CTAs of a cluster
// share one query tile's key tiles and rank 0 joins
// their (m, l, acc) in rank order through distributed shared memory: no
// atomics, and the split depends on the shape alone, so a shape's results
// are bitwise repeatable. Scores stay in log2 units (q scaled first, as the
// reference scales it, then s * log2(e) and one MUFU.EX2: exact zeros for
// masked lanes).
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
//
// float32, the same count of FLOPs: the work over the 67 TFLOP/s of the CUDA
// cores, or the three TF32 products this body issues (3x the FLOPs) over
// 495 TFLOP/s of dense TF32; the second is the tighter bound of this design
// (0.104 ms at the eval shape in float32, 0.0062 ms at (1, 1000, 4/2 heads,
// hd 64, non-causal), against 0.257 and 0.0153 ms for the first). Per key
// tile a CTA splits K and V itself and runs its products, softmax and loads
// in turn, so integer address and split work and the wait between the
// phases, not the tensor cores, set its time (PERF.md).
#include "common.cuh"
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>

namespace cg = cooperative_groups;

struct FaStrides {
    long long b, s, h;  // elements; the head dim is dense
};

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
template <int HD, int HDV>
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
            const int col = nb * NB + 8 * (i >> 2) + cq;
            const float d = (i & 2) ? d1 : d0;
            if (row < Sq && (HDV == HD || col < HDV))  // the tile's columns past hd are padding
                *reinterpret_cast<__nv_bfloat162*>(ob + row * so.s + col) =
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

// HDV: the head dim of the tensors; HD >= HDV: the tile's. Where HDV < HD
// the maps span HDV columns and TMA fills the box's columns past them with
// zeros, which add nothing to q . k and make zero output columns, not stored.
template <int HD, int HDV>
static int fa_bf16_launch(const void* q, const void* k, const void* v, void* o, int B,
                          int Sq, int Sk, int H, int KV, FaStrides sq, FaStrides sk,
                          FaStrides sv, FaStrides so, int causal, float scale,
                          cudaStream_t stream) {
    using T = FaTile<HD>;
    CUtensorMap mq, mk, mv;
    int err = fa_make_map(&mq, q, B, Sq, H, HDV, sq, FA_TQ, T::SWB);
    if (!err) err = fa_make_map(&mk, k, B, Sk, KV, HDV, sk, FA_TK, T::SWB);
    if (!err) err = fa_make_map(&mv, v, B, Sk, KV, HDV, sv, FA_TK, T::SWB);
    if (err) return err;
    cudaError_t e = cudaFuncSetAttribute(flash_attention_bf16_wgmma<HD, HDV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return (int)e;
    const int nq = (Sq + FA_TQ - 1) / FA_TQ;
    dim3 grid(H, B, nq);
    flash_attention_bf16_wgmma<HD, HDV><<<grid, FA_WG_THREADS, T::SMEM, stream>>>(
        mq, mk, mv, (__nv_bfloat16*)o, so, Sq, Sk, H / KV, nq, causal, scale);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: the tensor-core body, three TF32 products for each product
// (wgmma on TF32; hi/lo tiles written to shared memory by the CTA itself).
// ---------------------------------------------------------------------------

#define FA_F32_ROWS 128          // query rows of a CTA: two warpgroups of 64 (wgmma's M)
#define FA_F32_THREADS 256
#define FA_F32_SPLIT_MAX 4       // CTAs of a cluster sharing one query tile's keys
#define FA_F32_SMS 132           // the H100 SXM's SMs: the split is set by the shape alone

// Shared-memory tiles of the float32 body, each in TF32 hi and lo halves,
// all K-major with the 128-byte swizzle: a [rows][cols] tile is stored as
// column blocks of 32 floats (128 bytes a row), each block [rows][128 B],
// with the 16-byte chunk c of row r at chunk c ^ (r % 8).
template <int HD>
struct FaF32 {
    static constexpr int BK = HD == 128 ? 32 : 64;  // keys a tile
    static constexpr int Q_BYTES = FA_F32_ROWS * HD * 4;  // Q: [128][HD]
    static constexpr int K_BYTES = BK * HD * 4;           // K: [BK][HD]
    static constexpr int V_BYTES = HD * BK * 4;           // V^T: [HD][BK]
    static constexpr int SMEM = 1024 + 2 * (Q_BYTES + K_BYTES + V_BYTES);
    // The ranks of a cluster exchange (acc, m, l) of every thread over Q, K and V.
    static_assert((HD / 2 + 4) * FA_F32_THREADS * 4 <= 2 * (Q_BYTES + K_BYTES + V_BYTES),
                  "exchange");
};

// Byte offset of the 16-byte chunk holding (r, c), c % 4 == 0, in a swizzled
// K-major tile of ROWS rows.
template <int ROWS>
__device__ __forceinline__ uint32_t fa_sw(int r, int c) {
    return (uint32_t)((c >> 5) * ROWS * 128 + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4));
}

// TF32(x) as cvt.rna.tf32.f32 rounds a finite float (to nearest, ties away
// from zero): half of the 13 dropped bits added to the magnitude, then
// cleared. Two integer instructions, 9% faster at the eval shape than the cvt.
__device__ __forceinline__ uint32_t fa_tf32(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo to ~22 bits: hi = TF32(x), lo = TF32(x - hi); x - hi is exact.
__device__ __forceinline__ void fa_split(float x, uint32_t& hi, uint32_t& lo) {
    hi = fa_tf32(x);
    lo = fa_tf32(x - __uint_as_float(hi));
}

// Four floats times `mul`, split, into the hi and lo tiles at byte `at`.
__device__ __forceinline__ void fa_put4(unsigned char* hi, unsigned char* lo, uint32_t at,
                                        float4 x, float mul) {
    uint4 h, l;
    fa_split(x.x * mul, h.x, l.x);
    fa_split(x.y * mul, h.y, l.y);
    fa_split(x.z * mul, h.z, l.z);
    fa_split(x.w * mul, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + at) = h;
    *reinterpret_cast<uint4*>(lo + at) = l;
}

// Rows r0 .. r0 + ROWS - 1 of a (S, hd) slice at `src` (row r at src + r *
// rs) into registers, 16 bytes a chunk; rows at or past `rows`, and columns
// at or past HDV (a tile wider than the tensor's head dim), read as 0.
// `vec`: 16-byte loads (aligned base and strides), else four scalar loads.
template <int HD, int HDV, int ROWS>
__device__ __forceinline__ void fa_f32_load(float4 (&x)[ROWS * HD / 4 / FA_F32_THREADS],
                                            const float* __restrict__ src, long long rs,
                                            int r0, int rows, int vec) {
    constexpr int C = HD / 4;
#pragma unroll
    for (int i = 0; i < ROWS * C / FA_F32_THREADS; ++i) {
        const int c = (int)threadIdx.x + i * FA_F32_THREADS, r = r0 + c / C;
        const float* p = src + (long long)r * rs + (c % C) * 4;
        if (r >= rows || (HDV < HD && (c % C) * 4 >= HDV)) x[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        else if (vec) x[i] = __ldg(reinterpret_cast<const float4*>(p));
        else x[i] = make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
    }
}

// The chunks of fa_f32_load (ROWS x HD, row-major) times `mul` into the
// swizzled hi/lo tiles.
template <int HD, int ROWS>
__device__ __forceinline__ void fa_f32_store(const float4 (&x)[ROWS * HD / 4 / FA_F32_THREADS],
                                             float mul, unsigned char* hi, unsigned char* lo) {
    constexpr int C = HD / 4;
#pragma unroll
    for (int i = 0; i < ROWS * C / FA_F32_THREADS; ++i) {
        const int c = (int)threadIdx.x + i * FA_F32_THREADS;
        fa_put4(hi, lo, fa_sw<ROWS>(c / C, (c % C) * 4), x[i], mul);
    }
}

// V^T of a key tile: thread chunk c covers column n = c % HD and, of the
// key group of 8 that chunk c / HD / 2 names, keys half, half + 2, + 4, + 6
// (half = c / HD % 2), read down the column (a warp reads 32 columns of one
// key row: coalesced) and stored as positions 4 half .. 4 half + 3 of that
// group in row n of V^T. Position p of a group holds key 2p (p < 4) or
// 2(p - 4) + 1: the k order that makes S's accumulator registers P's A
// fragment (below).
template <int HD, int HDV, int BK>
__device__ __forceinline__ void fa_f32_load_vt(float4 (&x)[BK * HD / 4 / FA_F32_THREADS],
                                               const float* __restrict__ vb, long long rs,
                                               int k0, int Sk) {
#pragma unroll
    for (int i = 0; i < BK * HD / 4 / FA_F32_THREADS; ++i) {
        const int c = (int)threadIdx.x + i * FA_F32_THREADS, n = c % HD, pc = c / HD;
        const int j = k0 + 8 * (pc >> 1) + (pc & 1);
        const bool col = HDV == HD || n < HDV;
        float e[4];
#pragma unroll
        for (int m = 0; m < 4; ++m)
            e[m] = col && j + 2 * m < Sk ? __ldg(vb + (long long)(j + 2 * m) * rs + n) : 0.f;
        x[i] = make_float4(e[0], e[1], e[2], e[3]);
    }
}

template <int HD, int BK>
__device__ __forceinline__ void fa_f32_store_vt(const float4 (&x)[BK * HD / 4 / FA_F32_THREADS],
                                                unsigned char* hi, unsigned char* lo) {
#pragma unroll
    for (int i = 0; i < BK * HD / 4 / FA_F32_THREADS; ++i) {
        const int c = (int)threadIdx.x + i * FA_F32_THREADS;
        fa_put4(hi, lo, fa_sw<HD>(c % HD, 4 * (c / HD)), x[i], 1.f);
    }
}

// Orders this thread's generic-proxy writes to shared memory before the
// async proxy's (wgmma's) reads of it.
__device__ __forceinline__ void fa_fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps register A operands of asynchronous wgmma live and unchanged until
// the wait that ends the products reading them.
template <int N>
__device__ __forceinline__ void fa_fence_uregs(uint32_t (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// D (64 x 32, float32) += A (64 x 8 tf32, shared, K-major) * B (32 x 8 tf32,
// shared, K-major); scale_d = 0 overwrites D.
__device__ __forceinline__ void fa_wgmma_tf32_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                                    int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 32, float32) += A (64 x 8 tf32, registers) * B (32 x 8 tf32, shared,
// K-major).
__device__ __forceinline__ void fa_wgmma_tf32_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                                    uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, float32) += A (64 x 8 tf32, shared, K-major) * B (64 x 8 tf32,
// shared, K-major); scale_d = 0 overwrites D.
__device__ __forceinline__ void fa_wgmma_tf32_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                                    int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, float32) += A (64 x 8 tf32, registers) * B (64 x 8 tf32, shared,
// K-major).
__device__ __forceinline__ void fa_wgmma_tf32_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                                    uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, float32) += A (64 x 8 tf32, shared, K-major) * B (128 x 8 tf32,
// shared, K-major); scale_d = 0 overwrites D.
__device__ __forceinline__ void fa_wgmma_tf32_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                                    int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
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

// D (64 x 128, float32) += A (64 x 8 tf32, registers) * B (128 x 8 tf32, shared,
// K-major).
__device__ __forceinline__ void fa_wgmma_tf32_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void fa_wgmma_tf32_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                                 int scale_d) {
    if constexpr (N == 32) fa_wgmma_tf32_ss_n32(d, da, db, scale_d);
    else if constexpr (N == 64) fa_wgmma_tf32_ss_n64(d, da, db, scale_d);
    else fa_wgmma_tf32_ss_n128(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void fa_wgmma_tf32_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                                 uint64_t db) {
    if constexpr (N == 32) fa_wgmma_tf32_rs_n32(d, a, db);
    else if constexpr (N == 64) fa_wgmma_tf32_rs_n64(d, a, db);
    else fa_wgmma_tf32_rs_n128(d, a, db);
}

// A CTA (two warpgroups, 256 threads) owns a 128-row query tile of one
// (head, batch row): warpgroup i rows 64i .. 64i + 63, its warp w rows 16w
// .. 16w + 15 of those. The `split` CTAs of a cluster share the tile:
// rank r walks key tiles r, r + split, ...
// (balanced under causal masking), and rank 0 joins the others' (m, l, acc)
// in rank order through distributed shared memory. Q is split once into
// hi/lo tiles; per key tile the CTA loads K and V, splits them and stores K
// and V^T hi/lo tiles; then S = Q K^T as three TF32 wgmma products over
// hd/8 k-steps (A and B from shared memory), the mask, the online softmax in
// log2 units on the accumulator layout, and O += P V as three TF32 wgmma
// products with A = P's hi/lo split straight from S's registers: wgmma's
// accumulator registers 4j .. 4j + 3 of a thread are (g, 8j + 2t), (g, 8j +
// 2t + 1), (g + 8, 8j + 2t), (g + 8, 8j + 2t + 1), and its TF32 A fragment
// of k-step j is (g, k t), (g + 8, k t), (g, k t + 4), (g + 8, k t + 4), so
// with k t <-> key 2t and k t + 4 <-> key 2t + 1 (V^T stored in that order)
// P's fragment is registers 4j, 4j + 2, 4j + 1, 4j + 3.
template <int HD, int HDV>
__global__ void __launch_bounds__(FA_F32_THREADS, 1)
flash_attention_f32_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o, int Sq, int Sk,
                           int G, int nq, FaStrides sq, FaStrides sk, FaStrides sv,
                           FaStrides so, int causal, float scale, int vec) {
    using T = FaF32<HD>;
    constexpr int BK = T::BK;
    constexpr int NT = BK / 8;   // 8-key groups of S's columns, k-steps of P V
    constexpr int NO = HD / 8;   // k-steps of S, 8-column groups of O
    constexpr float LOG2E = 1.4426950408889634f;
    extern __shared__ __align__(1024) unsigned char fa_f32_smem[];
    unsigned char* base = fa_f32_smem + ((1024u - (fa_smem_addr(fa_f32_smem) & 1023u)) & 1023u);
    unsigned char* Qh = base;
    unsigned char* Ql = Qh + T::Q_BYTES;
    unsigned char* Kh = Ql + T::Q_BYTES;
    unsigned char* Kl = Kh + T::K_BYTES;
    unsigned char* Vh = Kl + T::K_BYTES;
    unsigned char* Vl = Vh + T::V_BYTES;
    const uint32_t sQh = fa_smem_addr(Qh), sQl = fa_smem_addr(Ql), sKh = fa_smem_addr(Kh),
                   sKl = fa_smem_addr(Kl), sVh = fa_smem_addr(Vh), sVl = fa_smem_addr(Vl);

    cg::cluster_group cluster = cg::this_cluster();
    const int split = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const int h = blockIdx.y, b = blockIdx.z;
    const int q0 = (nq - 1 - (int)blockIdx.x / split) * FA_F32_ROWS;  // longest causal first
    const int hk = h / G;
    const float* kb = k + b * sk.b + hk * sk.h;
    const float* vb = v + b * sv.b + hk * sv.h;
    const int kend = causal ? min(Sk, q0 + FA_F32_ROWS) : Sk;
    const int nt = (kend + BK - 1) / BK;
    const int wg = warp >> 2;             // warpgroup: rows q0 + 64 wg .. + 63
    const int rw = q0 + 64 * wg + 16 * (warp & 3);  // first row of this warp
    const int r0 = rw + g, r1 = r0 + 8;

    {   // Q times the scale (as the reference scales q), split once
        float4 x[FA_F32_ROWS * HD / 4 / FA_F32_THREADS];
        fa_f32_load<HD, HDV, FA_F32_ROWS>(x, q + b * sq.b + h * sq.h, sq.s, q0, Sq, vec);
        fa_f32_store<HD, FA_F32_ROWS>(x, scale, Qh, Ql);
    }

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // m in log2 units

    // The next key tile's loads are issued before this tile's products and
    // land in registers while they run.
    float4 xk[BK * HD / 4 / FA_F32_THREADS], xv[BK * HD / 4 / FA_F32_THREADS];
    if (rank < nt) {
        fa_f32_load<HD, HDV, BK>(xk, kb, sk.s, rank * BK, Sk, vec);
        fa_f32_load_vt<HD, HDV, BK>(xv, vb, sv.s, rank * BK, Sk);
    }
    for (int it = rank; it < nt; it += split) {
        const int k0 = it * BK;
        __syncthreads();  // the last tile's wgmma reads are done in every warp
        fa_f32_store<HD, BK>(xk, 1.f, Kh, Kl);
        fa_f32_store_vt<HD, BK>(xv, Vh, Vl);
        fa_fence_proxy_async();
        __syncthreads();
        if (it + split < nt) {
            fa_f32_load<HD, HDV, BK>(xk, kb, sk.s, k0 + split * BK, Sk, vec);
            fa_f32_load_vt<HD, HDV, BK>(xv, vb, sv.s, k0 + split * BK, Sk);
        }
        if (causal && k0 > q0 + 64 * wg + 63) continue;  // after every row of this warpgroup

        float sc[BK / 2];
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
        fa_fence_regs(sc);
        fa_wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NO; ++kk) {  // 8 columns of hd a step
            const int off = (kk >> 2) * BK * 128 + (kk & 3) * 32;
            const int offq = (kk >> 2) * FA_F32_ROWS * 128 + wg * 64 * 128 + (kk & 3) * 32;
            const uint64_t qh = fa_desc<128>(sQh + offq), ql = fa_desc<128>(sQl + offq);
            const uint64_t kh = fa_desc<128>(sKh + off), kl = fa_desc<128>(sKl + off);
            fa_wgmma_tf32_ss<BK>(sc, ql, kh, kk > 0);
            fa_wgmma_tf32_ss<BK>(sc, qh, kl, 1);
            fa_wgmma_tf32_ss<BK>(sc, qh, kh, 1);
        }
        fa_wgmma_commit();
        fa_wgmma_wait0();
        fa_fence_regs(sc);

        // Interior tiles need no mask: every key is < Sk and <= every row.
        if (k0 + BK > Sk || (causal && k0 + BK - 1 > rw)) {
#pragma unroll
            for (int i = 0; i < BK / 2; ++i) {
                const int kpos = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
                const int qpos = (i & 2) ? r1 : r0;
                if (kpos >= Sk || (causal && kpos > qpos)) sc[i] = -INFINITY;
            }
        }
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
            if (i & 2) mx1 = fmaxf(mx1, sc[i]);
            else mx0 = fmaxf(mx0, sc[i]);
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {  // the quad that shares a row
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float n0 = fmaxf(m0, mx0 * LOG2E), n1 = fmaxf(m1, mx1 * LOG2E);
        const float u0 = n0 == -INFINITY ? 0.f : n0, u1 = n1 == -INFINITY ? 0.f : n1;
        const float a0 = fa_exp2(m0 - u0), a1 = fa_exp2(m1 - u1);
        m0 = n0;
        m1 = n1;
        float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {  // masked: exactly 0
            if (i & 2) {
                sc[i] = fa_exp2(fmaf(sc[i], LOG2E, -u1));
                rs1 += sc[i];
            } else {
                sc[i] = fa_exp2(fmaf(sc[i], LOG2E, -u0));
                rs0 += sc[i];
            }
        }
        l0 = l0 * a0 + rs0;  // this lane's columns; the quad is summed at the end
        l1 = l1 * a1 + rs1;
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) acc[i] *= (i & 2) ? a1 : a0;
        uint32_t ph[NT][4], pl[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            fa_split(sc[4 * j + 0], ph[j][0], pl[j][0]);
            fa_split(sc[4 * j + 2], ph[j][1], pl[j][1]);
            fa_split(sc[4 * j + 1], ph[j][2], pl[j][2]);
            fa_split(sc[4 * j + 3], ph[j][3], pl[j][3]);
        }

        fa_fence_regs(acc);
        fa_wgmma_fence();
#pragma unroll
        for (int j = 0; j < NT; ++j) {  // 8 keys a step
            const int off = (j >> 2) * HD * 128 + (j & 3) * 32;
            const uint64_t vh = fa_desc<128>(sVh + off), vl = fa_desc<128>(sVl + off);
            fa_wgmma_tf32_rs<HD>(acc, pl[j], vh);
            fa_wgmma_tf32_rs<HD>(acc, ph[j], vl);
            fa_wgmma_tf32_rs<HD>(acc, ph[j], vh);
        }
        fa_wgmma_commit();
        fa_wgmma_wait0();
        fa_fence_regs(acc);
#pragma unroll
        for (int j = 0; j < NT; ++j) {  // live until the products that read them are done
            fa_fence_uregs(ph[j]);
            fa_fence_uregs(pl[j]);
        }
    }

    if (split > 1) {  // rank 0 joins the ranks' (m, l, acc) in rank order
        float* xs = reinterpret_cast<float*>(Qh);  // [HD / 2 + 4][FA_F32_THREADS]
        __syncthreads();  // this CTA's readers of Q, K and V are done
        if (rank > 0) {
#pragma unroll
            for (int i = 0; i < HD / 2; ++i) xs[i * FA_F32_THREADS + tid] = acc[i];
            xs[(HD / 2 + 0) * FA_F32_THREADS + tid] = m0;
            xs[(HD / 2 + 1) * FA_F32_THREADS + tid] = m1;
            xs[(HD / 2 + 2) * FA_F32_THREADS + tid] = l0;
            xs[(HD / 2 + 3) * FA_F32_THREADS + tid] = l1;
        }
        cluster.sync();
        if (rank == 0) {
            float M0 = m0, M1 = m1;
            for (int r = 1; r < split; ++r) {
                const float* rx = cluster.map_shared_rank(xs, r);
                M0 = fmaxf(M0, rx[(HD / 2 + 0) * FA_F32_THREADS + tid]);
                M1 = fmaxf(M1, rx[(HD / 2 + 1) * FA_F32_THREADS + tid]);
            }
            const float U0 = M0 == -INFINITY ? 0.f : M0, U1 = M1 == -INFINITY ? 0.f : M1;
            float f0 = fa_exp2(m0 - U0), f1 = fa_exp2(m1 - U1);
            l0 *= f0;
            l1 *= f1;
#pragma unroll
            for (int i = 0; i < HD / 2; ++i) acc[i] *= (i & 2) ? f1 : f0;
            for (int r = 1; r < split; ++r) {
                const float* rx = cluster.map_shared_rank(xs, r);
                f0 = fa_exp2(rx[(HD / 2 + 0) * FA_F32_THREADS + tid] - U0);
                f1 = fa_exp2(rx[(HD / 2 + 1) * FA_F32_THREADS + tid] - U1);
                l0 = fmaf(rx[(HD / 2 + 2) * FA_F32_THREADS + tid], f0, l0);
                l1 = fmaf(rx[(HD / 2 + 3) * FA_F32_THREADS + tid], f1, l1);
#pragma unroll
                for (int i = 0; i < HD / 2; ++i)
                    acc[i] = fmaf(rx[i * FA_F32_THREADS + tid], (i & 2) ? f1 : f0, acc[i]);
            }
        }
        cluster.sync();  // no CTA leaves while rank 0 may still read it
        if (rank > 0) return;
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    float* ob = o + b * so.b + h * so.h + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
        if (HDV < HD && 8 * n + 2 * t4 >= HDV) continue;  // padding columns of the tile
        if (r0 < Sq)
            *reinterpret_cast<float2*>(ob + r0 * so.s + 8 * n) =
                make_float2(acc[4 * n] / d0, acc[4 * n + 1] / d0);
        if (r1 < Sq)
            *reinterpret_cast<float2*>(ob + r1 * so.s + 8 * n) =
                make_float2(acc[4 * n + 2] / d1, acc[4 * n + 3] / d1);
    }
}

// Clusters of `split` CTAs over a query tile's key tiles where the grid of
// query tiles alone would leave SMs idle: the largest split of 1, 2 or 4
// that keeps the CTAs within one wave (FA_F32_SMS x the CTAs an SM holds,
// which the occupancy query gives from the kernel's registers and shared
// memory) and gives every rank a key tile. It depends on the shape and the
// compiled kernel alone, so a shape's bits do too.
static int fa_f32_split(long long ctas, int nt, int per_sm) {
    int split = 1;
    while (split < FA_F32_SPLIT_MAX && 2 * split <= nt &&
           ctas * 2 * split <= (long long)FA_F32_SMS * per_sm)
        split *= 2;
    return split;
}

static bool fa_vec_ready(const void* p, FaStrides s) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 4 == 0 && s.s % 4 == 0 &&
           s.h % 4 == 0;
}

template <int HD, int HDV>
static int fa_f32_launch(const void* q, const void* k, const void* v, void* o, int B,
                         int Sq, int Sk, int H, int KV, FaStrides sq, FaStrides sk,
                         FaStrides sv, FaStrides so, int causal, float scale,
                         cudaStream_t stream) {
    using T = FaF32<HD>;
    cudaError_t e = cudaFuncSetAttribute(flash_attention_f32_tf32x3<HD, HDV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return (int)e;
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flash_attention_f32_tf32x3<HD, HDV>,
                                                      FA_F32_THREADS, T::SMEM);
    if (e != cudaSuccess) return (int)e;
    const int nq = (Sq + FA_F32_ROWS - 1) / FA_F32_ROWS;
    const int nt = ((causal ? min(Sk, nq * FA_F32_ROWS) : Sk) + T::BK - 1) / T::BK;
    const int split = fa_f32_split((long long)nq * H * B, nt, max(per_sm, 1));
    const int vec = fa_vec_ready(q, sq) && fa_vec_ready(k, sk) && fa_vec_ready(v, sv);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(nq * split), (unsigned)H, (unsigned)B);
    cfg.blockDim = dim3(FA_F32_THREADS, 1, 1);
    cfg.dynamicSmemBytes = (size_t)T::SMEM;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, flash_attention_f32_tf32x3<HD, HDV>, (const float*)q,
                           (const float*)k, (const float*)v, (float*)o, Sq, Sk, H / KV, nq, sq,
                           sk, sv, so, causal, scale, vec);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
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
#define FA_CASE(launch, HD, HDV)                                                     \
    return launch<HD, HDV>(q, k, v, o, B, Sq, Sk, H, KV, sq, sk, sv, so, causal, scale, st)
    // hd 112 (Kimi K2) runs the hd-128 tile over zero-filled columns
    if (bf16) {
        if (hd == 32) FA_CASE(fa_bf16_launch, 32, 32);
        if (hd == 64) FA_CASE(fa_bf16_launch, 64, 64);
        if (hd == 112) FA_CASE(fa_bf16_launch, 128, 112);
        if (hd == 128) FA_CASE(fa_bf16_launch, 128, 128);
    } else {
        if (hd == 32) FA_CASE(fa_f32_launch, 32, 32);
        if (hd == 64) FA_CASE(fa_f32_launch, 64, 64);
        if (hd == 112) FA_CASE(fa_f32_launch, 128, 112);
        if (hd == 128) FA_CASE(fa_f32_launch, 128, 128);
    }
#undef FA_CASE
    return (int)cudaErrorInvalidValue;
}
