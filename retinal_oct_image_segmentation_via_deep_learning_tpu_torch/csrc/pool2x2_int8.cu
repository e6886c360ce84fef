// K11: 2x2 stride-2 max-pool of an NHWC int8 tensor.
//
// Replaces ops/pallas_conv_int8.py:pool2x2_int8 (the deep pools of the
// row-packed serving graph, inference/packed.py).
//
// Function: out[n, i, j, c] = max over dy, dx in {0, 1} of
// in[n, 2i+dy, 2j+dx, c]; H and W even (the wrapper checks).
//
// Bound on the card: device-memory bytes (each input byte read once, a
// quarter as many written); there is no arithmetic to speak of. Each thread
// owns one output pixel and VEC consecutive channels: it loads the four
// input pixels' VEC bytes as vectors (16 bytes where C is a multiple of 16;
// 8, 4 or single bytes for the other channel counts, the scalar tail), takes
// the byte-wise signed max with __vmaxs4 and stores VEC bytes. Neighbouring
// threads take neighbouring channel vectors, then neighbouring pixels, so a
// warp's loads and stores cover contiguous runs of memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <int VEC>
struct Vec;
template <>
struct Vec<16> { using T = uint4; };
template <>
struct Vec<8> { using T = uint2; };
template <>
struct Vec<4> { using T = uint32_t; };

__device__ __forceinline__ uint4 vmax(uint4 a, uint4 b) {
    return make_uint4(__vmaxs4(a.x, b.x), __vmaxs4(a.y, b.y),
                      __vmaxs4(a.z, b.z), __vmaxs4(a.w, b.w));
}
__device__ __forceinline__ uint2 vmax(uint2 a, uint2 b) {
    return make_uint2(__vmaxs4(a.x, b.x), __vmaxs4(a.y, b.y));
}
__device__ __forceinline__ uint32_t vmax(uint32_t a, uint32_t b) {
    return __vmaxs4(a, b);
}

template <int VEC>
__global__ void __launch_bounds__(THREADS) pool2x2_vec_kernel(
    const int8_t* __restrict__ x, int8_t* __restrict__ y, long long total,
    int H, int W, int C) {
    using T = typename Vec<VEC>::T;
    const int cv = C / VEC;
    const int Ho = H / 2, Wo = W / 2;
    const size_t row = (size_t)W * C;
    for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
         i < total; i += (long long)gridDim.x * THREADS) {
        const int v = (int)(i % cv);
        const long long p = i / cv;  // output pixel
        const int j = (int)(p % Wo);
        const long long r = p / Wo;  // n * Ho + i
        const long long n = r / Ho;
        const int oi = (int)(r - n * Ho);
        const int8_t* base = x + ((size_t)n * H + 2 * oi) * row
                             + (size_t)(2 * j) * C + (size_t)v * VEC;
        const T a = *reinterpret_cast<const T*>(base);
        const T b = *reinterpret_cast<const T*>(base + C);
        const T c = *reinterpret_cast<const T*>(base + row);
        const T d = *reinterpret_cast<const T*>(base + row + C);
        *reinterpret_cast<T*>(y + (size_t)p * C + (size_t)v * VEC) =
            vmax(vmax(a, b), vmax(c, d));
    }
}

__global__ void __launch_bounds__(THREADS) pool2x2_byte_kernel(
    const int8_t* __restrict__ x, int8_t* __restrict__ y, long long total,
    int H, int W, int C) {
    const int Ho = H / 2, Wo = W / 2;
    const size_t row = (size_t)W * C;
    for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
         i < total; i += (long long)gridDim.x * THREADS) {
        const int ch = (int)(i % C);
        const long long p = i / C;
        const int j = (int)(p % Wo);
        const long long r = p / Wo;
        const long long n = r / Ho;
        const int oi = (int)(r - n * Ho);
        const int8_t* base = x + ((size_t)n * H + 2 * oi) * row
                             + (size_t)(2 * j) * C + ch;
        int8_t m = base[0];
        m = base[C] > m ? base[C] : m;
        m = base[row] > m ? base[row] : m;
        m = base[row + C] > m ? base[row + C] : m;
        y[i] = m;
    }
}

int blocks_for(long long total) {
    long long b = (total + THREADS - 1) / THREADS;
    return (int)(b < 132LL * 64 ? b : 132LL * 64);  // grid-stride beyond
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). x (N, H, W, C)
// and y (N, H/2, W/2, C) contiguous int8, H and W even; vec is 16, 8, 4 or 1
// and divides C, and both pointers are aligned to it.
extern "C" int octseg_pool2x2_int8(const void* x, void* y, int N, int H,
                                   int W, int C, int vec, void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
    auto xi = static_cast<const int8_t*>(x);
    auto yo = static_cast<int8_t*>(y);
    const long long pix = (long long)N * (H / 2) * (W / 2);
    const long long total = pix * (C / vec);
    if (total == 0) return 0;
    const int grid = blocks_for(total);
    switch (vec) {
        case 16: pool2x2_vec_kernel<16><<<grid, THREADS, 0, s>>>(xi, yo, total, H, W, C); break;
        case 8: pool2x2_vec_kernel<8><<<grid, THREADS, 0, s>>>(xi, yo, total, H, W, C); break;
        case 4: pool2x2_vec_kernel<4><<<grid, THREADS, 0, s>>>(xi, yo, total, H, W, C); break;
        default: pool2x2_byte_kernel<<<grid, THREADS, 0, s>>>(xi, yo, total, H, W, C); break;
    }
    return static_cast<int>(cudaGetLastError());
}
