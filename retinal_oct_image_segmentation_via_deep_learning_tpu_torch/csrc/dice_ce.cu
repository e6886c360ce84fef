// K8 and K9: the fused Dice + cross-entropy loss of the packed train step,
// on channels-last (NHWC) logits with C <= 32 classes.
//
// Replaces ops/pallas_loss.py:_run_fwd (K8, the statistics) and
// ops/pallas_loss.py:_bwd (K9, dlogits). The TPU kernels read class-major
// (N, C, H, W) logits to fill 128-lane tiles; here a thread owns a pixel and
// its C logits are contiguous, so the head's NHWC output is read as it is.
//
// K8, per pixel p with label l (t_c = [l == c], w = cw[l], zero where l is
// outside [0, C)): the softmax p_c, and the sums over all pixels
//   out[c] = sum p_c t_c,  out[C + c] = sum p_c,  out[2C + c] = sum t_c,
//   out[3C] = sum ll * w (ll = x_l - max - log sum exp),  out[3C + 1] = sum w.
// One cooperative launch (dice_ce_stats_kernel) on a persistent grid of no
// more blocks than the card holds at once:
// - pass 1: a block walks tiles of STATS_TP pixels (g, g + grid, ...),
//   each tile's logits and labels brought by K9's 16-byte copies into a
//   ring of STATS_STAGES slots; a thread computes its two pixels of a tile
//   from shared memory (the label's logit and weight read once, bf16 pairs
//   as one word) and keeps the 3C + 2 running sums in registers across all
//   its tiles, then the warp trees and the warps in order give the block's
//   partial, written to its own row of a (grid, 3C + 2) fp32 array;
// - a grid-wide barrier (cooperative_groups; the grid fits on the card);
// - pass 2: one block an output, its threads adding partials t, t + 256,
//   ... in fp64, then the warps' shuffle-down trees and the 8 warps in
//   order (one round of loads, where a warp an output needs three).
// No float atomics: the order of every sum depends on the plan alone
// (ops/dice_ce.py:stats_plan), so the loss is reproducible run to run.
//
// K9, per pixel, from the per-class coefficients A, B, wce (3C fp32,
// read once per block into shared memory):
//   dlogit_c = wce_l (p_c - t_c) + A_c t_c p_c + B_c p_c
//              - p_c (A_l p_l + sum_c' B_c' p_c'),
// written in the logits' dtype. The softmax is recomputed, not stored.
//
// Bound on the card: bytes. K8 reads the logits and labels once; K9 reads
// them once more and writes dlogits. A thread keeps its pixel's C values
// and (K8) its 3C + 2 running sums in registers (statically indexed: the
// class loops are unrolled to MAXC, 8, 16 or 32, and exactly 10 in an
// instance of each kernel of its own); expf and logf are the accurate
// versions, not the fast intrinsics.
//
// Both move their bytes in 16-byte units: a thread's own C values are 2C
// or 4C bytes apart from its neighbours', so C loads or stores of 2 or 4
// bytes a thread would touch many sectors a warp instruction and fill none.
// A persistent grid (no more blocks than the card holds at once) walks
// tiles of BWD_TP pixels (a multiple of 8: a tile's logits and labels are
// whole 16-byte units for either dtype and any C). The tile's logits and
// labels come by 16-byte cp.async into a ring of BWD_STAGES slots (the
// next tiles in flight while one is computed; the last unit of a ragged
// tile reads only its valid bytes); a thread computes its pixel from
// shared memory with the same arithmetic, writes its dlogits into a shared
// output tile, and the block stores that tile with 16-byte stores (element
// stores for the ragged tail's last unit).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_int8.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_C = 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// One pixel's softmax: e[c] = exp(x_c - m) for c < C; returns sum e, and the
// max m and the label's logit x_l (0 if l is outside [0, C)).
template <int MAXC, typename T>
__device__ __forceinline__ float softmax_pixel(const T* __restrict__ xp, int C,
                                               int l, float (&e)[MAXC],
                                               float& m, float& x_l) {
    m = __int_as_float(0xff800000);  // -inf
    x_l = 0.0f;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
        if (c < C) {
            e[c] = to_f32(xp[c]);
            m = fmaxf(m, e[c]);
            if (c == l) x_l = e[c];
        }
    }
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
        if (c < C) {
            e[c] = expf(e[c] - m);
            s += e[c];
        }
    }
    return s;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

constexpr int BWD_TP = THREADS;  // pixels a K9 tile: one a thread
constexpr int BWD_STAGES = 2;    // slots of K9's ring
constexpr int BWD_EXACT_C = 10;  // the classes of K9's exact instance

// n <= 16 bytes from global to shared memory, the rest of the 16 zero.
__device__ __forceinline__ void cp_async_n(uint32_t dst, const void* src,
                                           int n) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(n) : "memory");
}

// The bytes [0, n) of a tile from src into shared memory at dst, 16 at a
// time (both 16-byte aligned).
__device__ __forceinline__ void copy_tile(uint32_t dst, const void* src,
                                          long long n) {
    const char* s = static_cast<const char*>(src);
    for (long long u = threadIdx.x; 16 * u < n; u += THREADS)
        cp_async_n(dst + 16 * static_cast<uint32_t>(u), s + 16 * u,
                   static_cast<int>(min(16LL, n - 16 * u)));
}

// Shared memory of a K9 block: BWD_STAGES slots of logits and of labels,
// and the output tile.
template <typename T, typename L>
constexpr int bwd_smem(int C) {
    return (BWD_STAGES + 1) * BWD_TP * C * static_cast<int>(sizeof(T))
           + BWD_STAGES * BWD_TP * static_cast<int>(sizeof(L));
}

template <int MAXC, typename T, typename L>
__global__ void __launch_bounds__(THREADS) dice_ce_bwd_kernel(
    const T* __restrict__ x, const L* __restrict__ lab,
    const float* __restrict__ coef, T* __restrict__ dx, long long P, int C,
    long long tiles) {
    extern __shared__ __align__(16) unsigned char smem[];
    // [A | B | wce], each at a fixed offset (aligned: vector reads)
    __shared__ __align__(16) float cs[3][MAX_C];
    for (int i = threadIdx.x; i < 3 * C; i += THREADS)
        cs[i / C][i % C] = coef[i];
    const int XB = BWD_TP * C * static_cast<int>(sizeof(T));
    const int LB = BWD_TP * static_cast<int>(sizeof(L));
    T* const os = reinterpret_cast<T*>(smem + BWD_STAGES * (XB + LB));
    const uint32_t ring = smem_addr(smem);
    const long long stride = gridDim.x;

    // tile `tile`'s logits and labels into slot `slot`
    auto load = [&](long long tile, int slot) {
        const long long p0 = tile * BWD_TP;
        const long long np = min((long long)BWD_TP, P - p0);
        copy_tile(ring + slot * XB, x + p0 * C, np * C * (long long)sizeof(T));
        copy_tile(ring + BWD_STAGES * XB + slot * LB, lab + p0,
                  np * (long long)sizeof(L));
    };
#pragma unroll
    for (int s = 0; s < BWD_STAGES - 1; ++s) {
        if (blockIdx.x + s * stride < tiles) load(blockIdx.x + s * stride, s);
        cp_async_commit();
    }
    int slot = 0;
    for (long long tile = blockIdx.x; tile < tiles; tile += stride) {
        cp_async_wait<BWD_STAGES - 2>();
        __syncthreads();  // this tile landed; the slot before it, os are free
        {
            const long long next = tile + (BWD_STAGES - 1) * stride;
            if (next < tiles)
                load(next, slot == 0 ? BWD_STAGES - 1 : slot - 1);
            cp_async_commit();
        }

        const long long p0 = tile * BWD_TP;
        const int np = static_cast<int>(min((long long)BWD_TP, P - p0));
        const int i = threadIdx.x;
        // the exact instance's class count is a constant (C == MAXC there)
        const int Cn = MAXC == BWD_EXACT_C ? MAXC : C;
        if (i < np) {
            const T* const xt = reinterpret_cast<const T*>(smem + slot * XB);
            const L* const lt = reinterpret_cast<const L*>(
                smem + BWD_STAGES * XB + slot * LB);
            const int l = static_cast<int>(lt[i]);
            float e[MAXC], m, x_l;
            const float s = softmax_pixel<MAXC>(xt + i * Cn, Cn, l, e, m, x_l);
            const float inv = 1.0f / s;
            float qA = 0.0f, qB = 0.0f, wce = 0.0f;
#pragma unroll
            for (int c = 0; c < MAXC; ++c) {
                if (c < Cn) {
                    const float pc = e[c] * inv;
                    const float t = c == l ? 1.0f : 0.0f;
                    qA += cs[0][c] * t * pc;
                    qB += cs[1][c] * pc;
                    wce += cs[2][c] * t;
                }
            }
            T* out = os + i * Cn;
#pragma unroll
            for (int c = 0; c < MAXC; ++c) {
                if (c < Cn) {
                    const float pc = e[c] * inv;
                    const float t = c == l ? 1.0f : 0.0f;
                    const float d = wce * (pc - t) + cs[0][c] * t * pc
                                    + cs[1][c] * pc - pc * (qA + qB);
                    store(out + c, d);
                }
            }
        }
        __syncthreads();  // the output tile is whole
        const long long n = (long long)np * C;  // values of the tile
        const long long units = n * (long long)sizeof(T) / 16;
        char* const og = reinterpret_cast<char*>(dx + p0 * C);
        for (long long u = threadIdx.x; u < units; u += THREADS)
            *reinterpret_cast<uint4*>(og + 16 * u) =
                *reinterpret_cast<const uint4*>(
                    reinterpret_cast<const char*>(os) + 16 * u);
        for (long long v = units * 16 / (long long)sizeof(T) + threadIdx.x;
             v < n; v += THREADS)
            dx[p0 * C + v] = os[v];
        slot = slot == BWD_STAGES - 1 ? 0 : slot + 1;
    }
}

constexpr int STATS_TP = 2 * THREADS;  // pixels a K8 tile: two a thread
constexpr int STATS_STAGES = 2;     // slots of K8's ring
constexpr int STATS_EXACT_C = 10;   // the classes of K8's exact instance

// Shared memory of a K8 block: STATS_STAGES slots of logits and of labels.
template <typename T, typename L>
constexpr int stats_smem(int C) {
    return STATS_STAGES * STATS_TP
           * (C * static_cast<int>(sizeof(T)) + static_cast<int>(sizeof(L)));
}

// K8's pixel from shared memory: e[c] = x_c (c < C), bf16 pairs read as
// one 4-byte word where C is even (the pixel then starts on 4 bytes);
// returns the max, taken in class order as softmax_pixel takes it.
template <int MAXC, typename T>
__device__ __forceinline__ float load_pixel(const T* __restrict__ xp, int C,
                                            float (&e)[MAXC]) {
    if constexpr (sizeof(T) == 2 && MAXC % 2 == 0) {
        if (C % 2 == 0) {
            const uint32_t* const xw = reinterpret_cast<const uint32_t*>(xp);
#pragma unroll
            for (int c = 0; c < MAXC; c += 2) {
                if (c < C) {
                    const uint32_t u = xw[c / 2];
                    e[c] = __uint_as_float(u << 16);  // bf16 -> fp32: exact
                    e[c + 1] = __uint_as_float(u & 0xffff0000u);
                }
            }
        } else {
#pragma unroll
            for (int c = 0; c < MAXC; ++c)
                if (c < C) e[c] = to_f32(xp[c]);
        }
    } else {
#pragma unroll
        for (int c = 0; c < MAXC; ++c)
            if (c < C) e[c] = to_f32(xp[c]);
    }
    float m = __int_as_float(0xff800000);  // -inf
#pragma unroll
    for (int c = 0; c < MAXC; ++c)
        if (c < C) m = fmaxf(m, e[c]);
    return m;
}

// grid (G) <= the co-resident blocks, block (THREADS); partial: fp32
// scratch (G, K), K = 3C + 2; out: fp32 (K,).
template <int MAXC, typename T, typename L>
__global__ void __launch_bounds__(THREADS) dice_ce_stats_kernel(
    const T* __restrict__ x, const L* __restrict__ lab,
    const float* __restrict__ cw, float* __restrict__ partial,
    float* __restrict__ out, long long P, int C, long long tiles) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float cws[MAX_C];
    __shared__ float sh[WARPS][3 * MAX_C + 2];
    __shared__ double shd[WARPS];
    // the exact instance's class count is a constant (C == MAXC there)
    const int Cn = MAXC == STATS_EXACT_C ? MAXC : C;
    for (int i = threadIdx.x; i < Cn; i += THREADS) cws[i] = cw[i];
    const int XB = STATS_TP * Cn * static_cast<int>(sizeof(T));
    const int LB = STATS_TP * static_cast<int>(sizeof(L));
    const uint32_t ring = smem_addr(smem);
    const long long stride = gridDim.x;

    float inter[MAXC], sp[MAXC], cnt[MAXC];
#pragma unroll
    for (int c = 0; c < MAXC; ++c) inter[c] = sp[c] = cnt[c] = 0.0f;
    float sll = 0.0f, sw = 0.0f;

    // tile `tile`'s logits and labels into slot `slot`
    auto load = [&](long long tile, int slot) {
        const long long q0 = tile * STATS_TP;
        const long long nq = min((long long)STATS_TP, P - q0);
        copy_tile(ring + slot * XB, x + q0 * Cn,
                  nq * Cn * (long long)sizeof(T));
        copy_tile(ring + STATS_STAGES * XB + slot * LB, lab + q0,
                  nq * (long long)sizeof(L));
    };
#pragma unroll
    for (int s = 0; s < STATS_STAGES - 1; ++s) {
        if (blockIdx.x + s * stride < tiles) load(blockIdx.x + s * stride, s);
        cp_async_commit();
    }
    int slot = 0;
    for (long long tile = blockIdx.x; tile < tiles; tile += stride) {
        cp_async_wait<STATS_STAGES - 2>();
        __syncthreads();  // this tile landed; the slot before it is free
        {
            const long long next = tile + (STATS_STAGES - 1) * stride;
            if (next < tiles)
                load(next, slot == 0 ? STATS_STAGES - 1 : slot - 1);
            cp_async_commit();
        }

        // thread t adds pixels t, t + THREADS, ... of the tile, in order
#pragma unroll
        for (int k = 0; k < STATS_TP / THREADS; ++k) {
            const int i = threadIdx.x + k * THREADS;
            if (i < P - tile * STATS_TP) {  // the pixel exists
                const T* const xt = reinterpret_cast<const T*>(smem + slot * XB);
                const L* const lt = reinterpret_cast<const L*>(
                    smem + STATS_STAGES * XB + slot * LB);
                const int l = static_cast<int>(lt[i]);
                float e[MAXC];
                const float m = load_pixel<MAXC>(xt + i * Cn, Cn, e);
                // the label's logit and weight read once (0 outside [0, C))
                const bool in =
                    static_cast<unsigned>(l) < static_cast<unsigned>(Cn);
                const float x_l = in ? to_f32(xt[i * Cn + l]) : 0.0f;
                const float w = in ? cws[l] : 0.0f;
                float s = 0.0f;
#pragma unroll
                for (int c = 0; c < MAXC; ++c) {
                    if (c < Cn) {
                        e[c] = expf(e[c] - m);
                        s += e[c];
                    }
                }
                const float inv = 1.0f / s;
                const float logs = logf(s);
#pragma unroll
                for (int c = 0; c < MAXC; ++c) {
                    if (c < Cn) {
                        const float pc = e[c] * inv;
                        sp[c] += pc;
                        if (c == l) {
                            inter[c] += pc;
                            cnt[c] += 1.0f;
                        }
                    }
                }
                sll += (x_l - m - logs) * w;
                sw += w;
            }
        }
        slot = slot == STATS_STAGES - 1 ? 0 : slot + 1;
    }

    // the block's partial: the warp trees, then the warps in order
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int K = 3 * Cn + 2;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
        if (c < Cn) {
            const float a = warp_sum(inter[c]);
            const float b = warp_sum(sp[c]);
            const float d = warp_sum(cnt[c]);
            if (lane == 0) {
                sh[warp][c] = a;
                sh[warp][Cn + c] = b;
                sh[warp][2 * Cn + c] = d;
            }
        }
    }
    {
        const float a = warp_sum(sll), b = warp_sum(sw);
        if (lane == 0) {
            sh[warp][3 * Cn] = a;
            sh[warp][3 * Cn + 1] = b;
        }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < K; k += THREADS) {
        float v = 0.0f;
#pragma unroll
        for (int j = 0; j < WARPS; ++j) v += sh[j][k];
        partial[(size_t)blockIdx.x * K + k] = v;
    }

    // pass 2, after every partial: output k by block k (k, k + grid, ...);
    // thread t adds partials t, t + THREADS, ... in fp64, then the warp
    // trees and the warps in order
    cg::this_grid().sync();
    const int G = gridDim.x;
    for (int k = blockIdx.x; k < K; k += G) {
        double v = 0.0;
#pragma unroll 4
        for (int q = threadIdx.x; q < G; q += THREADS)
            v += static_cast<double>(__ldcg(partial + (size_t)q * K + k));
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            v += __shfl_down_sync(0xffffffffu, v, o);
        if (lane == 0) shd[warp] = v;
        __syncthreads();
        if (threadIdx.x == 0) {
            double t = 0.0;
#pragma unroll
            for (int j = 0; j < WARPS; ++j) t += shd[j];
            out[k] = static_cast<float>(t);
        }
        __syncthreads();
    }
}

template <typename T, typename L>
using BwdKernel = void (*)(const T*, const L*, const float*, T*, long long,
                           int, long long);

// K9's instance for C classes (MAXC of the dispatch below): the class
// loops issue all MAXC iterations, predicated off past C, so the model's
// default class count (10) has an instance of its own.
template <int MAXC, typename T, typename L>
BwdKernel<T, L> bwd_kernel(int C) {
    if (MAXC == 16 && C == BWD_EXACT_C)
        return dice_ce_bwd_kernel<BWD_EXACT_C, T, L>;
    return dice_ce_bwd_kernel<MAXC, T, L>;
}

template <int MAXC, typename T, typename L>
int bwd(const void* x, const void* lab, const void* coef, void* dx,
        long long P, int C, int grid, cudaStream_t s) {
    const BwdKernel<T, L> k = bwd_kernel<MAXC, T, L>(C);
    const int smem = bwd_smem<T, L>(C);
    const cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    k<<<grid, THREADS, smem, s>>>(
        static_cast<const T*>(x), static_cast<const L*>(lab),
        static_cast<const float*>(coef), static_cast<T*>(dx), P, C,
        (P + BWD_TP - 1) / BWD_TP);
    return static_cast<int>(cudaGetLastError());
}

template <int MAXC, typename T, typename L>
int bwd_resident(int C, int* blocks) {
    const BwdKernel<T, L> k = bwd_kernel<MAXC, T, L>(C);
    const int smem = bwd_smem<T, L>(C);
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, THREADS,
                                                            smem);
    *blocks = per_sm * sms;
    return static_cast<int>(err);
}

// K8's instance for C classes (MAXC of the dispatch below), as for K9.
template <int MAXC, typename T, typename L>
const void* stats_kernel(int C) {
    if (MAXC == 16 && C == STATS_EXACT_C)
        return reinterpret_cast<const void*>(
            dice_ce_stats_kernel<STATS_EXACT_C, T, L>);
    return reinterpret_cast<const void*>(dice_ce_stats_kernel<MAXC, T, L>);
}

template <int MAXC, typename T, typename L>
int stats(const void* x, const void* lab, const void* cw, void* partial,
          void* out, long long P, int C, int grid, cudaStream_t s) {
    const void* k = stats_kernel<MAXC, T, L>(C);
    const int smem = stats_smem<T, L>(C);
    cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    long long tiles = (P + STATS_TP - 1) / STATS_TP;
    void* args[] = {&x, &lab, &cw, &partial, &out, &P, &C, &tiles};
    err = cudaLaunchCooperativeKernel(k, dim3(grid), dim3(THREADS), args, smem,
                                      s);
    if (err != cudaSuccess) cudaGetLastError();  // clear it; reported below
    return static_cast<int>(err);
}

template <int MAXC, typename T, typename L>
int stats_resident(int C, int* blocks) {
    const void* k = stats_kernel<MAXC, T, L>(C);
    const int smem = stats_smem<T, L>(C);
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, THREADS,
                                                            smem);
    *blocks = per_sm * sms;
    return static_cast<int>(err);
}

// Calls F<MAXC, T, L>(args...) for the logits' dtype (bf16 or fp32), the
// labels' width (int64 or int32) and the smallest MAXC >= C.
#define OCTSEG_DISPATCH(F, ...)                                              \
    do {                                                                     \
        if (bf16) {                                                          \
            if (lab64) {                                                     \
                if (C <= 8) return F<8, __nv_bfloat16, int64_t>(__VA_ARGS__);   \
                if (C <= 16) return F<16, __nv_bfloat16, int64_t>(__VA_ARGS__); \
                return F<32, __nv_bfloat16, int64_t>(__VA_ARGS__);              \
            }                                                                \
            if (C <= 8) return F<8, __nv_bfloat16, int32_t>(__VA_ARGS__);       \
            if (C <= 16) return F<16, __nv_bfloat16, int32_t>(__VA_ARGS__);     \
            return F<32, __nv_bfloat16, int32_t>(__VA_ARGS__);                  \
        }                                                                    \
        if (lab64) {                                                         \
            if (C <= 8) return F<8, float, int64_t>(__VA_ARGS__);            \
            if (C <= 16) return F<16, float, int64_t>(__VA_ARGS__);          \
            return F<32, float, int64_t>(__VA_ARGS__);                       \
        }                                                                    \
        if (C <= 8) return F<8, float, int32_t>(__VA_ARGS__);                \
        if (C <= 16) return F<16, float, int32_t>(__VA_ARGS__);              \
        return F<32, float, int32_t>(__VA_ARGS__);                           \
    } while (0)

}  // namespace

// x: contiguous (P, C) logits, fp32 (bf16 = 0) or bf16 (bf16 = 1); lab:
// (P,) int32 (lab64 = 0) or int64 (lab64 = 1); both 16-byte aligned; cw:
// fp32 (C,); partial: fp32 scratch (grid, 3C + 2); out: fp32 (3C + 2,).
// 1 <= C <= 32; grid <= the co-resident blocks
// (octseg_dice_ce_stats_resident). One cooperative launch.
extern "C" int octseg_dice_ce_stats(const void* x, const void* lab,
                                    const void* cw, void* partial, void* out,
                                    long long P, int C, int bf16, int lab64,
                                    int grid, void* stream) {
    if (C < 1 || C > MAX_C || grid < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    OCTSEG_DISPATCH(stats, x, lab, cw, partial, out, P, C, grid, s);
}

// *blocks = the blocks of K8's instance for (C, bf16, lab64) that the card
// holds at once (the occupancy API's blocks an SM times the SMs).
extern "C" int octseg_dice_ce_stats_resident(int C, int bf16, int lab64,
                                             void* blocks) {
    if (C < 1 || C > MAX_C) return static_cast<int>(cudaErrorInvalidValue);
    OCTSEG_DISPATCH(stats_resident, C, static_cast<int*>(blocks));
}

// x, lab as above, both 16-byte aligned; coef: fp32 (3C,) = [A, B, wce];
// dx: (P, C) in x's dtype, 16-byte aligned; grid <= the co-resident blocks
// (octseg_dice_ce_bwd_resident).
extern "C" int octseg_dice_ce_bwd(const void* x, const void* lab,
                                  const void* coef, void* dx, long long P,
                                  int C, int bf16, int lab64, int grid,
                                  void* stream) {
    if (C < 1 || C > MAX_C || grid < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    OCTSEG_DISPATCH(bwd, x, lab, coef, dx, P, C, grid, s);
}

// *blocks = the blocks of K9's instance for (C, bf16, lab64) that the card
// holds at once (the occupancy API's blocks an SM times the SMs).
extern "C" int octseg_dice_ce_bwd_resident(int C, int bf16, int lab64,
                                           void* blocks) {
    if (C < 1 || C > MAX_C) return static_cast<int>(cudaErrorInvalidValue);
    OCTSEG_DISPATCH(bwd_resident, C, static_cast<int*>(blocks));
}
