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
// Pass 1 gives each block a contiguous range of pixels and writes its
// (3C + 2) fp32 partial sums (warp shuffles, then the warps in order);
// pass 2 adds the partials of each sum in a fixed order in fp64. No float
// atomics, so the loss is reproducible run to run.
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
// class loops are unrolled to MAXC, 8, 16 or 32); expf and logf are the
// accurate versions, not the fast intrinsics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// Pass 1: block b sums pixels [b * rows, min(P, (b + 1) * rows)) and writes
// partial[b][0 .. 3C + 2).
template <int MAXC, typename T, typename L>
__global__ void __launch_bounds__(THREADS) dice_ce_stats_partial(
    const T* __restrict__ x, const L* __restrict__ lab,
    const float* __restrict__ cw, float* __restrict__ partial, long long P,
    int C, long long rows) {
    __shared__ float cws[MAX_C];
    __shared__ float sh[WARPS][3 * MAX_C + 2];
    for (int i = threadIdx.x; i < C; i += THREADS) cws[i] = cw[i];
    __syncthreads();

    float inter[MAXC], sp[MAXC], cnt[MAXC];
#pragma unroll
    for (int c = 0; c < MAXC; ++c) inter[c] = sp[c] = cnt[c] = 0.0f;
    float sll = 0.0f, sw = 0.0f;

    const long long p0 = (long long)blockIdx.x * rows;
    const long long p1 = min(P, p0 + rows);
    for (long long p = p0 + threadIdx.x; p < p1; p += THREADS) {
        const int l = static_cast<int>(lab[p]);
        float e[MAXC], m, x_l;
        const float s = softmax_pixel<MAXC>(x + p * C, C, l, e, m, x_l);
        const float inv = 1.0f / s;
        const float logs = logf(s);
        float w = 0.0f;
#pragma unroll
        for (int c = 0; c < MAXC; ++c) {
            if (c < C) {
                const float pc = e[c] * inv;
                sp[c] += pc;
                if (c == l) {
                    inter[c] += pc;
                    cnt[c] += 1.0f;
                    w = cws[c];
                }
            }
        }
        sll += (x_l - m - logs) * w;
        sw += w;
    }

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
        if (c < C) {
            const float a = warp_sum(inter[c]);
            const float b = warp_sum(sp[c]);
            const float d = warp_sum(cnt[c]);
            if (lane == 0) {
                sh[warp][c] = a;
                sh[warp][C + c] = b;
                sh[warp][2 * C + c] = d;
            }
        }
    }
    const float a = warp_sum(sll), b = warp_sum(sw);
    if (lane == 0) {
        sh[warp][3 * C] = a;
        sh[warp][3 * C + 1] = b;
    }
    __syncthreads();
    const int K = 3 * C + 2;
    for (int k = threadIdx.x; k < K; k += THREADS) {
        float v = 0.0f;
#pragma unroll
        for (int j = 0; j < WARPS; ++j) v += sh[j][k];
        partial[(size_t)blockIdx.x * K + k] = v;
    }
}

// Pass 2: block k writes out[k] = sum over g of partial[g][k]: each thread
// sums a fixed strided subset in fp64, then a fixed tree over the threads.
__global__ void __launch_bounds__(THREADS) dice_ce_stats_final(
    const float* __restrict__ partial, float* __restrict__ out, int G,
    int K) {
    __shared__ double sh[THREADS];
    const int k = blockIdx.x;
    double v = 0.0;
    for (int g = threadIdx.x; g < G; g += THREADS)
        v += (double)partial[(size_t)g * K + k];
    sh[threadIdx.x] = v;
    __syncthreads();
    for (int w = THREADS / 2; w > 0; w >>= 1) {
        if (threadIdx.x < w) sh[threadIdx.x] += sh[threadIdx.x + w];
        __syncthreads();
    }
    if (threadIdx.x == 0) out[k] = (float)sh[0];
}

template <int MAXC, typename T, typename L>
__global__ void __launch_bounds__(THREADS) dice_ce_bwd_kernel(
    const T* __restrict__ x, const L* __restrict__ lab,
    const float* __restrict__ coef, T* __restrict__ dx, long long P, int C) {
    __shared__ float cs[3 * MAX_C];
    for (int i = threadIdx.x; i < 3 * C; i += THREADS) cs[i] = coef[i];
    __syncthreads();

    const long long stride = (long long)gridDim.x * THREADS;
    for (long long p = (long long)blockIdx.x * THREADS + threadIdx.x; p < P;
         p += stride) {
        const int l = static_cast<int>(lab[p]);
        float e[MAXC], m, x_l;
        const float s = softmax_pixel<MAXC>(x + p * C, C, l, e, m, x_l);
        const float inv = 1.0f / s;
        float qA = 0.0f, qB = 0.0f, wce = 0.0f;
#pragma unroll
        for (int c = 0; c < MAXC; ++c) {
            if (c < C) {
                const float pc = e[c] * inv;
                const float t = c == l ? 1.0f : 0.0f;
                qA += cs[c] * t * pc;
                qB += cs[C + c] * pc;
                wce += cs[2 * C + c] * t;
            }
        }
        T* out = dx + p * C;
#pragma unroll
        for (int c = 0; c < MAXC; ++c) {
            if (c < C) {
                const float pc = e[c] * inv;
                const float t = c == l ? 1.0f : 0.0f;
                const float d = wce * (pc - t) + cs[c] * t * pc
                                + cs[C + c] * pc - pc * (qA + qB);
                store(out + c, d);
            }
        }
    }
}

int blocks_for(long long P) {
    long long blocks = (P + THREADS - 1) / THREADS;
    if (blocks > 132LL * 16) blocks = 132LL * 16;
    return blocks < 1 ? 1 : static_cast<int>(blocks);
}

template <int MAXC, typename T, typename L>
int stats(const void* x, const void* lab, const void* cw, void* partial,
          void* out, long long P, int C, int G, long long rows,
          cudaStream_t s) {
    dice_ce_stats_partial<MAXC, T, L><<<G, THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<const L*>(lab),
        static_cast<const float*>(cw), static_cast<float*>(partial), P, C,
        rows);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    dice_ce_stats_final<<<3 * C + 2, THREADS, 0, s>>>(
        static_cast<const float*>(partial), static_cast<float*>(out), G,
        3 * C + 2);
    return static_cast<int>(cudaGetLastError());
}

template <int MAXC, typename T, typename L>
int bwd(const void* x, const void* lab, const void* coef, void* dx,
        long long P, int C, cudaStream_t s) {
    dice_ce_bwd_kernel<MAXC, T, L><<<blocks_for(P), THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<const L*>(lab),
        static_cast<const float*>(coef), static_cast<T*>(dx), P, C);
    return static_cast<int>(cudaGetLastError());
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
// (P,) int32 (lab64 = 0) or int64 (lab64 = 1); cw: fp32 (C,); partial: fp32
// scratch (G, 3C + 2) with G = ceil(P / rows); out: fp32 (3C + 2,).
// 1 <= C <= 32. Two launches; returns cudaGetLastError() after each.
extern "C" int octseg_dice_ce_stats(const void* x, const void* lab,
                                    const void* cw, void* partial, void* out,
                                    long long P, int C, int G,
                                    long long rows, int bf16, int lab64,
                                    void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
    OCTSEG_DISPATCH(stats, x, lab, cw, partial, out, P, C, G, rows, s);
}

// x, lab as above; coef: fp32 (3C,) = [A, B, wce]; dx: (P, C) in x's dtype.
extern "C" int octseg_dice_ce_bwd(const void* x, const void* lab,
                                  const void* coef, void* dx, long long P,
                                  int C, int bf16, int lab64, void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
    OCTSEG_DISPATCH(bwd, x, lab, coef, dx, P, C, s);
}
