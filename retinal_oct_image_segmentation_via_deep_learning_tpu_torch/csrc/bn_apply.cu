// K13 and K14: the training BatchNorm's per-element passes, with the ReLU
// that follows each BatchNorm of the packed U-Net step.
//
//   K13 bn_apply:  y  = round(x * scale[c] + shift[c]), then ReLU (optional)
//   K14 bn_dx:     dx = round((dy_m * g[c] - x * c1[c]) - c0[c]),
//                  dy_m = dy, or 0 where the forward's ReLU was closed
//
// They replace no TPU kernel: the JAX package leaves these passes to XLA,
// which fuses them. In eager PyTorch they were separate ops, each a pass
// over device memory and most in fp32 (ops/fused_bn.py: bn_apply_reference,
// bn_dx_reference hold them as the plain versions). Every product and sum
// here is rounded by its own _rn intrinsic (never an FMA) and the result
// rounded as .to() rounds it (bn_round.cuh), so y and dx equal the plain
// ops' bit for bit. K14 finds the ReLU's mask again from x, scale and shift
// as K13 found y, so it reads nothing that the pass does not read anyway.
//
// Bound on the card: the bytes. K13 reads x and writes y, K14 reads dy and
// x and writes dx: 4 and 6 bytes an element in bf16, at a handful of fp32
// operations an element. So the layout is for streaming: a lane owns VEC
// consecutive channels (VEC = 8 where C % 8 == 0 and every pointer is
// 16-byte aligned: one 16-byte load or store a row in bf16, two in fp32;
// else 1) and keeps their per-channel terms in registers for the whole
// launch. A block's THREADS threads are rows_step rows x lanes lanes
// (a warp covers whole rows, or consecutive rows, of contiguous memory);
// the grid, no larger than the card holds at once, strides over the rows,
// each lane with UNROLL rows' loads in flight before it stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn_round.cuh"

namespace {

constexpr int THREADS = 256;  // a block (ops/fused_bn.py: THREADS)
constexpr int UNROLL = 4;     // rows in flight a lane (ops/fused_bn.py)

// VEC consecutive channels of one row: loaded, read as fp32, and stored
// from fp32 values that are exact in T (already rounded by bn_round).
template <typename T, int VEC>
struct Chunk;

template <>
struct Chunk<__nv_bfloat16, 8> {
    uint4 u;
    __device__ __forceinline__ void load(const __nv_bfloat16* p) {
        u = __ldg(reinterpret_cast<const uint4*>(p));
    }
    __device__ __forceinline__ float at(int j) const {
        const unsigned w = j < 2 ? u.x : j < 4 ? u.y : j < 6 ? u.z : u.w;
        return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
    }
    static __device__ __forceinline__ unsigned pack(float lo, float hi) {
        return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xffff0000u);
    }
    static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                                 const float (&v)[8]) {
        *reinterpret_cast<uint4*>(p) = make_uint4(
            pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]),
            pack(v[6], v[7]));
    }
};

template <>
struct Chunk<float, 8> {
    float4 lo, hi;
    __device__ __forceinline__ void load(const float* p) {
        lo = __ldg(reinterpret_cast<const float4*>(p));
        hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
    }
    __device__ __forceinline__ float at(int j) const {
        const float4& q = j < 4 ? lo : hi;
        const int k = j & 3;
        return k == 0 ? q.x : k == 1 ? q.y : k == 2 ? q.z : q.w;
    }
    static __device__ __forceinline__ void store(float* p,
                                                 const float (&v)[8]) {
        reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
        reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
};

template <>
struct Chunk<__nv_bfloat16, 1> {
    unsigned short u;
    __device__ __forceinline__ void load(const __nv_bfloat16* p) {
        u = __ldg(reinterpret_cast<const unsigned short*>(p));
    }
    __device__ __forceinline__ float at(int) const {
        return __uint_as_float(static_cast<unsigned>(u) << 16);
    }
    static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                                 const float (&v)[1]) {
        *reinterpret_cast<unsigned short*>(p) =
            static_cast<unsigned short>(__float_as_uint(v[0]) >> 16);
    }
};

template <>
struct Chunk<float, 1> {
    float v;
    __device__ __forceinline__ void load(const float* p) { v = __ldg(p); }
    __device__ __forceinline__ float at(int) const { return v; }
    static __device__ __forceinline__ void store(float* p,
                                                 const float (&w)[1]) {
        *p = w[0];
    }
};

template <int VEC>
__device__ __forceinline__ void load_terms(float (&t)[VEC],
                                           const float* __restrict__ p) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) t[j] = __ldg(p + j);
}

// K13 on one chunk.
template <typename T, int VEC, bool RELU>
__device__ __forceinline__ void apply_chunk(T* p, const Chunk<T, VEC>& in,
                                            const float (&s)[VEC],
                                            const float (&h)[VEC]) {
    float v[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
        v[j] = bn_value<T>(in.at(j), s[j], h[j]);
        if (RELU && v[j] <= 0.0f) v[j] = 0.0f;
    }
    Chunk<T, VEC>::store(p, v);
}

// grid (G), block (THREADS): thread t = ry * lanes + lane takes channel
// groups lane, lane + lanes, ... and, of each, the rows blockIdx.x *
// rows_step + ry + k * G * rows_step.
template <typename T, int VEC, bool RELU>
__global__ void __launch_bounds__(THREADS) bn_apply_kernel(
    const T* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ shift, T* __restrict__ y, long long M, int C,
    int lanes, int rows_step) {
    const int lane = threadIdx.x % lanes, ry = threadIdx.x / lanes;
    if (ry >= rows_step) return;
    const long long step = (long long)gridDim.x * rows_step;
    for (int c = lane * VEC; c < C; c += lanes * VEC) {
        float s[VEC], h[VEC];
        load_terms(s, scale + c);
        load_terms(h, shift + c);
        long long r = (long long)blockIdx.x * rows_step + ry;
        for (; r + (UNROLL - 1) * step < M; r += UNROLL * step) {
            Chunk<T, VEC> in[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) in[u].load(x + (r + u * step) * C + c);
#pragma unroll
            for (int u = 0; u < UNROLL; ++u)
                apply_chunk<T, VEC, RELU>(y + (r + u * step) * C + c, in[u], s, h);
        }
        for (; r < M; r += step) {
            Chunk<T, VEC> in;
            in.load(x + r * C + c);
            apply_chunk<T, VEC, RELU>(y + r * C + c, in, s, h);
        }
    }
}

// K14 on one chunk of dy and x.
template <typename T, int VEC, bool RELU>
__device__ __forceinline__ void dx_chunk(T* p, const Chunk<T, VEC>& d,
                                         const Chunk<T, VEC>& xv,
                                         const float (&g)[VEC],
                                         const float (&c1)[VEC],
                                         const float (&c0)[VEC],
                                         const float (&s)[VEC],
                                         const float (&h)[VEC]) {
    float v[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
        const float xj = xv.at(j);
        float dj = d.at(j);
        if (RELU && relu_closed<T>(xj, s[j], h[j])) dj = 0.0f;
        v[j] = bn_round<T>(__fsub_rn(__fsub_rn(__fmul_rn(dj, g[j]),
                                               __fmul_rn(xj, c1[j])),
                                     c0[j]));
    }
    Chunk<T, VEC>::store(p, v);
}

// As bn_apply_kernel, over dy and x.
template <typename T, int VEC, bool RELU>
__global__ void __launch_bounds__(THREADS) bn_dx_kernel(
    const T* __restrict__ dy, const T* __restrict__ x,
    const float* __restrict__ g, const float* __restrict__ c1,
    const float* __restrict__ c0, const float* __restrict__ scale,
    const float* __restrict__ shift, T* __restrict__ dx, long long M, int C,
    int lanes, int rows_step) {
    const int lane = threadIdx.x % lanes, ry = threadIdx.x / lanes;
    if (ry >= rows_step) return;
    const long long step = (long long)gridDim.x * rows_step;
    for (int c = lane * VEC; c < C; c += lanes * VEC) {
        float tg[VEC], t1[VEC], t0[VEC], s[VEC], h[VEC];
        load_terms(tg, g + c);
        load_terms(t1, c1 + c);
        load_terms(t0, c0 + c);
        if constexpr (RELU) {
            load_terms(s, scale + c);
            load_terms(h, shift + c);
        }
        long long r = (long long)blockIdx.x * rows_step + ry;
        for (; r + (UNROLL - 1) * step < M; r += UNROLL * step) {
            Chunk<T, VEC> d[UNROLL], xv[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                d[u].load(dy + (r + u * step) * C + c);
                xv[u].load(x + (r + u * step) * C + c);
            }
#pragma unroll
            for (int u = 0; u < UNROLL; ++u)
                dx_chunk<T, VEC, RELU>(dx + (r + u * step) * C + c, d[u],
                                       xv[u], tg, t1, t0, s, h);
        }
        for (; r < M; r += step) {
            Chunk<T, VEC> d, xv;
            d.load(dy + r * C + c);
            xv.load(x + r * C + c);
            dx_chunk<T, VEC, RELU>(dx + r * C + c, d, xv, tg, t1, t0, s, h);
        }
    }
}

template <typename T, int VEC>
const void* kernel_of(bool dx, bool relu) {
    if (dx)
        return relu ? reinterpret_cast<const void*>(bn_dx_kernel<T, VEC, true>)
                    : reinterpret_cast<const void*>(bn_dx_kernel<T, VEC, false>);
    return relu ? reinterpret_cast<const void*>(bn_apply_kernel<T, VEC, true>)
                : reinterpret_cast<const void*>(bn_apply_kernel<T, VEC, false>);
}

const void* kernel_for(int dx, int bf16, int vec, int relu) {
    if (bf16)
        return vec == 8 ? kernel_of<__nv_bfloat16, 8>(dx != 0, relu != 0)
                        : kernel_of<__nv_bfloat16, 1>(dx != 0, relu != 0);
    return vec == 8 ? kernel_of<float, 8>(dx != 0, relu != 0)
                    : kernel_of<float, 1>(dx != 0, relu != 0);
}

int launch(const void* fn, void** args, int grid, void* stream) {
    const cudaError_t err = cudaLaunchKernel(
        fn, dim3(grid), dim3(THREADS), args, 0,
        static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) cudaGetLastError();  // clear it; reported below
    return static_cast<int>(err);
}

}  // namespace

// K13. x, y: contiguous (M, C), both float32 (bf16 = 0) or both bfloat16
// (bf16 = 1), 16-byte aligned where vec = 8 (C % 8 == 0); scale, shift:
// fp32 (C). The plan (vec, lanes, rows_step, grid) is ops/fused_bn.py:
// apply_plan's; relu != 0 applies the ReLU.
extern "C" int octseg_bn_apply(const void* x, const void* scale,
                               const void* shift, void* y, long long M, int C,
                               int vec, int lanes, int rows_step, int grid,
                               int relu, int bf16, void* stream) {
    if (vec != 1 && vec != 8) return static_cast<int>(cudaErrorInvalidValue);
    void* args[] = {&x, &scale, &shift, &y, &M, &C, &lanes, &rows_step};
    return launch(kernel_for(0, bf16, vec, relu), args, grid, stream);
}

// K14. dy, x, dx as x and y of K13; g, c1, c0: fp32 (C); scale, shift: the
// forward's, read only where relu != 0 (dy zeroed where the forward's ReLU
// was closed).
extern "C" int octseg_bn_dx(const void* dy, const void* x, const void* g,
                            const void* c1, const void* c0, const void* scale,
                            const void* shift, void* dx, long long M, int C,
                            int vec, int lanes, int rows_step, int grid,
                            int relu, int bf16, void* stream) {
    if (vec != 1 && vec != 8) return static_cast<int>(cudaErrorInvalidValue);
    void* args[] = {&dy, &x, &g, &c1, &c0, &scale, &shift, &dx, &M, &C,
                    &lanes, &rows_step};
    return launch(kernel_for(1, bf16, vec, relu), args, grid, stream);
}

// *blocks = the blocks of the (dx, bf16, vec, relu) instance the current
// device holds at once: the occupancy API's blocks an SM times the SMs.
extern "C" int octseg_bn_apply_resident(int dx, int bf16, int vec, int relu,
                                        void* blocks) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel_for(dx, bf16, vec, relu), THREADS, 0);
    *static_cast<int*>(blocks) = per_sm * sms;
    return static_cast<int>(err);
}
