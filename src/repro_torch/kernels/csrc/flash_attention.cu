// flash_attention: online-softmax attention over key tiles, forward only.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py `flash_attention`
// (`_flash_kernel`, grid (B, H, Sq/Tq, Sk/Tk) with the key axis sequential
// and m/l/acc carried in VMEM scratch). Here one block of 256 threads owns
// one (query tile of 64 rows, query head, batch row) and a loop inside the
// block walks the key tiles of 64, so nothing carries between blocks. Per
// key tile, as on the TPU:
//   s = (q * scale) . k  (float32; keys >= Sk, and keys > query when causal,
//                         set to -1e30),
//   m_new = max(m, rowmax s),  p = exp(s - m_new),  alpha = exp(m - m_new),
//   l = l * alpha + rowsum p,  acc = acc * alpha + p . v,  m = m_new;
// and out = acc / max(l, 1e-30) in q's dtype. Key tiles wholly above the
// diagonal are skipped: their p are exact zeros (expf of -1e30 - m is 0;
// no fast-math __expf), so the result does not change. bf16 inputs are
// converted to float32 on the load; the whole body runs in float32 on the
// CUDA cores (FMA), as the TPU kernel's body does. Query head h reads key
// head h / G in place (GQA), and the (B, S, heads, hd) layout is read
// through its strides, with no transpose copy.
//
// Layout: Q (scaled), K, V and P tiles in shared memory as float32 (Q and K
// rows padded by one word, so the 16 threads of a row group read 16 banks);
// thread (ty, tx) of a 16 x 16 grid owns rows ty + 16i (i < 4) of the tile,
// score columns tx + 16j (j < 4) and output columns tx + 16c (c < hd/16);
// row max and sum are shuffles over the 16 lanes of a row group. Shared
// memory: 66 KB at hd 64, 113 KB at hd 128 (above 48 KB, so the entry point
// raises the kernel's dynamic shared-memory limit).
//
// Bound on the H100 at the eval shape (B 2, S 2048, 16 heads, hd 64, bf16,
// causal): 2*2*B*H*hd FLOPs per visible (query, key) pair, 17.2 GFLOP,
// against 989 TFLOP/s of dense bf16 tensor-core work is 0.0174 ms, above the
// 0.010 ms of q/k/v/o bytes at 3.35 TB/s: operations bind. This first kernel
// does its products in float32 FMA on the CUDA cores (67 TFLOP/s peak, so
// >= 0.26 ms here) and feeds them from shared memory (two loads per four
// FMAs in the score loop); it measured 0.99 ms there, 57x its bound and 17x
// SDPA (NVIDIA H100 80GB HBM3, 700 W; PERF.md). Moving the products to the
// tensor cores (mma/wgmma on bf16 tiles, TMA loads) is the next step.
#include "common.cuh"
#include <cuda_bf16.h>

#define FA_BQ 64
#define FA_BK 64
#define FA_THREADS 256
#define FA_NEG_INF (-1e30f)

struct FaStrides {
    long long b, s, h;  // elements; the head dim is dense
};

__device__ __forceinline__ float fa_load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float fa_load(const __nv_bfloat16* p) {
    return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void fa_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void fa_store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
}

template <int HD>
__host__ __device__ constexpr int fa_smem_floats() {
    return FA_BQ * (HD + 1) + FA_BK * (HD + 1) + FA_BK * HD + FA_BQ * (FA_BK + 1);
}

template <typename T, int HD>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
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
    const T* qb = q + b * sq.b + h * sq.h;
    const T* kb = k + b * sk.b + hk * sk.h;
    const T* vb = v + b * sv.b + hk * sv.h;

    for (int e = tid; e < FA_BQ * HD; e += FA_THREADS) {
        const int r = e / HD, d = e % HD, s = q0 + r;
        Qs[r * QP + d] = s < Sq ? fa_load(qb + s * sq.s + d) * scale : 0.f;
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
            Ks[r * QP + d] = in ? fa_load(kb + s * sk.s + d) : 0.f;
            Vs[r * HD + d] = in ? fa_load(vb + s * sv.s + d) : 0.f;
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
        T* ob = o + b * so.b + s * so.s + h * so.h;
#pragma unroll
        for (int c = 0; c < DC; ++c) fa_store(ob + tx + 16 * c, acc[i][c] / denom);
    }
}

template <typename T, int HD>
static int fa_launch(const void* q, const void* k, const void* v, void* o, int B,
                     int Sq, int Sk, int H, int KV, FaStrides sq, FaStrides sk,
                     FaStrides sv, FaStrides so, int causal, float scale,
                     cudaStream_t stream) {
    const int smem = (int)(sizeof(float) * fa_smem_floats<HD>());
    cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((Sq + FA_BQ - 1) / FA_BQ, H, B);
    flash_attention_kernel<T, HD><<<grid, FA_THREADS, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, Sq, Sk, H / KV, sq, sk, sv, so,
        causal, scale);
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
#define FA_CASE(T, HD)                                                              \
    return fa_launch<T, HD>(q, k, v, o, B, Sq, Sk, H, KV, sq, sk, sv, so, causal,   \
                            scale, st)
    if (bf16) {
        if (hd == 32) FA_CASE(__nv_bfloat16, 32);
        if (hd == 64) FA_CASE(__nv_bfloat16, 64);
        if (hd == 128) FA_CASE(__nv_bfloat16, 128);
    } else {
        if (hd == 32) FA_CASE(float, 32);
        if (hd == 64) FA_CASE(float, 64);
        if (hd == 128) FA_CASE(float, 128);
    }
#undef FA_CASE
    return (int)cudaErrorInvalidValue;
}
