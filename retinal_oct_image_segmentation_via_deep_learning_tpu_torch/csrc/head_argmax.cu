// K3: 1x1 int8 classifier head fused with the per-pixel argmax, NHWC int8
// in, int8 labels out.
//
// Replaces ops/pallas_conv_psrp.py:head_argmax_psrp.
//
// Function, per pixel p: acc[k] = sum_c x[p,c] * w[k,c] in int32, logit
// z[k] = fmaf(float(acc[k]), scale[k], bias[k]) (no round, no clip), label =
// argmax_k z[k] with ties to the lowest class (a strict '>' scan from
// class 0). The logits never leave registers.
//
// Bound on the card: reading the input (cin bytes per pixel) from device
// memory; the nc*cin/4 dp4a per pixel are few. One thread per pixel keeps
// its cin/4 input words in registers and reads the weights, scales and
// biases from shared memory (uniform across the warp: broadcast).
//
// Weights are pre-arranged (ops/head_argmax.py:pack_head_weights) as int32
// words (nc, cin/4): word [k, j] holds w[k, 4j..4j+3].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_CW = 16;   // cin <= 64
constexpr int MAX_NC = 32;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) head_argmax_kernel(
    const int8_t* __restrict__ x, const int32_t* __restrict__ w,
    const float* __restrict__ scale, const float* __restrict__ bias,
    int8_t* __restrict__ y, long long P, int cw, int nc) {
    __shared__ int32_t ws[MAX_NC * MAX_CW];
    __shared__ float ss[MAX_NC], bs[MAX_NC];
    for (int i = threadIdx.x; i < nc * cw; i += THREADS) ws[i] = w[i];
    for (int i = threadIdx.x; i < nc; i += THREADS) {
        ss[i] = scale[i];
        bs[i] = bias[i];
    }
    __syncthreads();

    const long long stride = (long long)gridDim.x * THREADS;
    for (long long p = (long long)blockIdx.x * THREADS + threadIdx.x; p < P;
         p += stride) {
        const int32_t* xp = reinterpret_cast<const int32_t*>(x + p * cw * 4);
        int32_t xv[MAX_CW];
#pragma unroll
        for (int j = 0; j < MAX_CW; ++j) xv[j] = j < cw ? xp[j] : 0;
        float best = 0.0f;
        int arg = 0;
        for (int k = 0; k < nc; ++k) {
            int acc = 0;
#pragma unroll
            for (int j = 0; j < MAX_CW; ++j)
                if (j < cw) acc = __dp4a(xv[j], ws[k * cw + j], acc);
            const float z = __fmaf_rn(__int2float_rn(acc), ss[k], bs[k]);
            if (k == 0 || z > best) {
                best = z;
                arg = k;
            }
        }
        y[p] = static_cast<int8_t>(arg);
    }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). cin = 4*cw
// with cw <= 16; nc <= 32.
extern "C" int octseg_head_argmax(const void* x, const void* w,
                                  const void* scale, const void* bias,
                                  void* y, long long P, int cw, int nc,
                                  void* stream) {
    long long blocks = (P + THREADS - 1) / THREADS;
    if (blocks > 65535LL * 16) blocks = 65535LL * 16;
    if (blocks < 1) blocks = 1;
    head_argmax_kernel<<<(unsigned)blocks, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(x), static_cast<const int32_t*>(w),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<int8_t*>(y), P, cw, nc);
    return static_cast<int>(cudaGetLastError());
}
