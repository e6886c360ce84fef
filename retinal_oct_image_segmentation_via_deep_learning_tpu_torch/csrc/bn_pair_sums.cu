// K6: per-channel pair of sums for the training BatchNorm, in fp32.
//
// Replaces ops/fused_bn.py:_pallas_pair_sums (the _sum_kernel(two_inputs)
// family): over the rows of a channels-last (M, C) tensor,
//   forward mode:  out = [sum_m a[m,c], sum_m a[m,c]^2]
//   backward mode: out = [sum_m a[m,c], sum_m a[m,c] * b[m,c]]   (a = dy, b = x)
// The TPU kernel wrote one (2, C) partial per grid step and let XLA sum
// them. Here pass 1 gives each block a contiguous range of rows and writes
// its fp32 partial; pass 2 sums the partials per channel in a fixed order.
// No float atomics, so the sums, and a training step, are reproducible.
//
// Bound on the card: the bytes read (each input element once; a few flops
// per element). Each thread keeps a Kahan-compensated fp32 sum, and the
// two reduction levels are compensated too, so the result stays within
// about one fp32 ulp of the exact sum for well-conditioned data, with the
// fp32 accumulation the TPU kernel used.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CX = 32;  // channels per block (threadIdx.x)
constexpr int RY = 8;   // row lanes per block (threadIdx.y)

__device__ __forceinline__ void kahan_add(float& s, float& comp, float v) {
    const float y = v - comp;
    const float t = s + y;
    comp = (t - s) - y;
    s = t;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// grid (G, ceil(C / CX)), block (CX, RY). Block g sums rows
// [g * rows_per_block, min(M, (g + 1) * rows_per_block)).
template <typename T, bool TWO>
__global__ void __launch_bounds__(CX * RY) pair_sums_partial(
    const T* __restrict__ a, const T* __restrict__ b,
    float* __restrict__ partial, long long M, int C,
    long long rows_per_block) {
    __shared__ float sh[2][RY][CX + 1];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int c = blockIdx.y * CX + tx;
    const long long r0 = (long long)blockIdx.x * rows_per_block;
    const long long r1 = min(M, r0 + rows_per_block);
    float s0 = 0.0f, e0 = 0.0f, s1 = 0.0f, e1 = 0.0f;
    if (c < C) {
        for (long long r = r0 + ty; r < r1; r += RY) {
            const float av = to_f32(a[r * C + c]);
            const float bv = TWO ? to_f32(b[r * C + c]) : av;
            kahan_add(s0, e0, av);
            kahan_add(s1, e1, av * bv);
        }
    }
    sh[0][ty][tx] = s0;
    sh[1][ty][tx] = s1;
    __syncthreads();
    if (ty < 2 && c < C) {
        float s = 0.0f, e = 0.0f;
#pragma unroll
        for (int j = 0; j < RY; ++j) kahan_add(s, e, sh[ty][j][tx]);
        partial[((size_t)blockIdx.x * 2 + ty) * C + c] = s;
    }
}

// out[k][c] = sum over g = 0..G-1 of partial[g][k][c], in that order.
__global__ void pair_sums_final(const float* __restrict__ partial,
                                float* __restrict__ out, int G, int C) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= 2 * C) return;
    const int k = i / C, c = i - k * C;
    float s = 0.0f, e = 0.0f;
    for (int g = 0; g < G; ++g) kahan_add(s, e, partial[((size_t)g * 2 + k) * C + c]);
    out[i] = s;
}

template <typename T>
int launch(const void* a, const void* b, void* partial, void* out,
           long long M, int C, int G, long long rows_per_block,
           cudaStream_t s) {
    dim3 grid(G, (C + CX - 1) / CX);
    dim3 block(CX, RY);
    auto ap = static_cast<const T*>(a);
    auto bp = static_cast<const T*>(b);
    auto pp = static_cast<float*>(partial);
    if (b != nullptr)
        pair_sums_partial<T, true><<<grid, block, 0, s>>>(ap, bp, pp, M, C, rows_per_block);
    else
        pair_sums_partial<T, false><<<grid, block, 0, s>>>(ap, ap, pp, M, C, rows_per_block);
    int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    pair_sums_final<<<(2 * C + 255) / 256, 256, 0, s>>>(pp, static_cast<float*>(out), G, C);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (and b, if not null): contiguous (M, C), both float32 (bf16 = 0) or both
// bfloat16 (bf16 = 1). partial: fp32 scratch (G, 2, C) with
// G = ceil(M / rows_per_block). out: fp32 (2, C). Two launches.
extern "C" int octseg_bn_pair_sums(const void* a, const void* b,
                                   void* partial, void* out, long long M,
                                   int C, int G, long long rows_per_block,
                                   int bf16, void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
    if (bf16)
        return launch<__nv_bfloat16>(a, b, partial, out, M, C, G, rows_per_block, s);
    return launch<float>(a, b, partial, out, M, C, G, rows_per_block, s);
}
