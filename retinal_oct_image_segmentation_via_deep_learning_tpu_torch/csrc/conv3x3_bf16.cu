// K4 and K5: the bf16 3x3 stride-1 "same" training convolution on NHWC
// tensors, with fp32 accumulation on the tensor cores (WMMA 16x16x16 bf16).
//
// K4 replaces ops/pallas_conv_bf16.py:_conv_fwd_pallas, which serves both
// the forward and the input gradient of conv3x3_psrp_bf16:
//   y[n,h,w,co] = bf16_rn( sum_{ky,kx,ci} x[n,h+ky-1,w+kx-1,ci] * w[ky,kx,ci,co] )
// (zero outside the image). The dgrad is the same kernel on dy with the
// weights rotated 180 degrees and transposed (ops/conv_bf16.py:flip_w).
//
// K5 replaces ops/pallas_conv_bf16.py:_conv_wgrad_pallas and the band fold
// after it: it writes the (3, 3, cin, cout) fp32 weight gradient directly,
//   dw[ky,kx,ci,co] = sum_{n,h,w} x[n,h+ky-1,w+kx-1,ci] * dy[n,h,w,co].
// The TPU kernel carried one accumulator across its sequential grid; here
// blocks run in parallel, so each block writes fp32 partials for its share
// of the pixels and a second kernel sums them in a fixed order (no float
// atomics: a training step is reproducible).
//
// Bound on the card: at the 512^2 stages (cin, cout <= 64) the bytes moved;
// at the deep stages the bf16 tensor-core rate. This first design is
// simple: a block stages an 8x16-pixel output tile's input rows plus halo
// (16 input channels at a time) and the matching weight slice in shared
// memory, and each warp runs one 16-pixel row of the tile through WMMA for
// the nine taps. TMA loads, wgmma and a deeper pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TH = 8;             // output tile rows: one warp per row (K4)
constexpr int TW = 16;            // output tile columns: one WMMA M tile
constexpr int HH = TH + 2;        // halo tile rows
constexpr int HWD = TW + 2;       // halo tile columns
constexpr int KC = 16;            // input channels per chunk: the WMMA K
constexpr int CO_T = 32;          // output channels per block: 2 WMMA N tiles
constexpr int FWD_THREADS = 32 * TH;   // 256
constexpr int WG_THREADS = 32 * 9;     // K5: one warp per tap

__device__ __forceinline__ bf16 bf16_zero() { return __ushort_as_bfloat16(0); }

// Stage the HH x HWD x KC input tile of channels [c0, c0 + KC) around the
// output tile at (y0, x0) into xs (pixel-major, KC channels per pixel).
// Zero outside the image and past cin. VEC: 16-byte loads (cin % 8 == 0
// and a 16-byte aligned base).
template <bool VEC>
__device__ __forceinline__ void load_halo(bf16* xs, const bf16* __restrict__ x,
                                          int n, int H, int W, int cin,
                                          int c0, int y0, int x0, int tid,
                                          int nthreads) {
    if (VEC) {
        for (int i = tid; i < HH * HWD * (KC / 8); i += nthreads) {
            const int p = i / (KC / 8), v = i - p * (KC / 8);
            const int iy = y0 - 1 + p / HWD, ix = x0 - 1 + p % HWD;
            const int c = c0 + v * 8;
            uint4 val = make_uint4(0u, 0u, 0u, 0u);
            if (iy >= 0 && iy < H && ix >= 0 && ix < W && c < cin)
                val = *reinterpret_cast<const uint4*>(
                    x + (((size_t)n * H + iy) * W + ix) * cin + c);
            *reinterpret_cast<uint4*>(xs + p * KC + v * 8) = val;
        }
    } else {
        for (int i = tid; i < HH * HWD * KC; i += nthreads) {
            const int p = i / KC, j = i - p * KC;
            const int iy = y0 - 1 + p / HWD, ix = x0 - 1 + p % HWD;
            const int c = c0 + j;
            bf16 val = bf16_zero();
            if (iy >= 0 && iy < H && ix >= 0 && ix < W && c < cin)
                val = x[(((size_t)n * H + iy) * W + ix) * cin + c];
            xs[i] = val;
        }
    }
}

// K4: grid (tiles_y * tiles_x, ceil(cout / CO_T), N), FWD_THREADS threads.
template <bool VEC>
__global__ void __launch_bounds__(FWD_THREADS) conv3x3_bf16_fwd_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w,
    bf16* __restrict__ y, int H, int W, int cin, int cout, int tiles_x) {
    __shared__ __align__(128) bf16 xs[HH * HWD * KC];
    __shared__ __align__(128) bf16 ws[9 * KC * CO_T];
    __shared__ __align__(128) float os[TH * TW * CO_T];

    const int n = blockIdx.z;
    const int co0 = blockIdx.y * CO_T;
    const int y0 = (blockIdx.x / tiles_x) * TH;
    const int x0 = (blockIdx.x % tiles_x) * TW;
    const int tid = threadIdx.x;
    const int warp = tid >> 5;

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.0f);
    wmma::fill_fragment(acc[1], 0.0f);

    for (int c0 = 0; c0 < cin; c0 += KC) {
        load_halo<VEC>(xs, x, n, H, W, cin, c0, y0, x0, tid, FWD_THREADS);
        for (int i = tid; i < 9 * KC * CO_T; i += FWD_THREADS) {
            const int t = i / (KC * CO_T);
            const int r = i - t * (KC * CO_T);
            const int ci = c0 + r / CO_T, co = co0 + r % CO_T;
            ws[i] = (ci < cin && co < cout)
                        ? w[((size_t)t * cin + ci) * cout + co] : bf16_zero();
        }
        __syncthreads();
#pragma unroll
        for (int t = 0; t < 9; ++t) {
            const int ky = t / 3, kx = t % 3;
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
            wmma::load_matrix_sync(a, xs + ((warp + ky) * HWD + kx) * KC, KC);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
                wmma::load_matrix_sync(b, ws + t * KC * CO_T + j * 16, CO_T);
                wmma::mma_sync(acc[j], a, b, acc[j]);
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(os + warp * TW * CO_T + j * 16, acc[j], CO_T,
                                wmma::mem_row_major);
    __syncthreads();
    for (int i = tid; i < TH * TW * CO_T; i += FWD_THREADS) {
        const int p = i / CO_T, co = co0 + i % CO_T;
        const int oy = y0 + p / TW, ox = x0 + p % TW;
        if (oy < H && ox < W && co < cout)
            y[(((size_t)n * H + oy) * W + ox) * cout + co] = __float2bfloat16_rn(os[i]);
    }
}

// K5, pass 1: grid (G, cinp / KC, coutp / CO_T), WG_THREADS threads. Block
// (g, ., .) takes the spatial tiles g, g + G, g + 2G, ... and writes its
// fp32 partial to partial[g][tap][ci][co] ((G, 9, cinp, coutp), padded).
template <bool VX, bool VD>
__global__ void __launch_bounds__(WG_THREADS) conv3x3_bf16_wgrad_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ dy,
    float* __restrict__ partial, int N, int H, int W, int cin, int cout,
    int cinp, int coutp, int tiles_x, int tiles_per_image, int G) {
    __shared__ __align__(128) bf16 xs[HH * HWD * KC];
    __shared__ __align__(128) bf16 ds[TH * TW * CO_T];

    const int g = blockIdx.x;
    const int c0 = blockIdx.y * KC;
    const int co0 = blockIdx.z * CO_T;
    const int tid = threadIdx.x;
    const int tap = tid >> 5;
    const int ky = tap / 3, kx = tap % 3;

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.0f);
    wmma::fill_fragment(acc[1], 0.0f);

    const int total = N * tiles_per_image;
    for (int s = g; s < total; s += G) {
        const int n = s / tiles_per_image;
        const int r = s - n * tiles_per_image;
        const int y0 = (r / tiles_x) * TH, x0 = (r % tiles_x) * TW;
        load_halo<VX>(xs, x, n, H, W, cin, c0, y0, x0, tid, WG_THREADS);
        if (VD) {
            for (int i = tid; i < TH * TW * (CO_T / 8); i += WG_THREADS) {
                const int p = i / (CO_T / 8), v = i - p * (CO_T / 8);
                const int oy = y0 + p / TW, ox = x0 + p % TW;
                const int co = co0 + v * 8;
                uint4 val = make_uint4(0u, 0u, 0u, 0u);
                if (oy < H && ox < W && co < cout)
                    val = *reinterpret_cast<const uint4*>(
                        dy + (((size_t)n * H + oy) * W + ox) * cout + co);
                *reinterpret_cast<uint4*>(ds + p * CO_T + v * 8) = val;
            }
        } else {
            for (int i = tid; i < TH * TW * CO_T; i += WG_THREADS) {
                const int p = i / CO_T, co = co0 + i % CO_T;
                const int oy = y0 + p / TW, ox = x0 + p % TW;
                ds[i] = (oy < H && ox < W && co < cout)
                            ? dy[(((size_t)n * H + oy) * W + ox) * cout + co]
                            : bf16_zero();
            }
        }
        __syncthreads();
#pragma unroll 2
        for (int row = 0; row < TH; ++row) {
            // A = x^T (16 channels x 16 pixels), column-major in xs
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
            wmma::load_matrix_sync(a, xs + ((row + ky) * HWD + kx) * KC, KC);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
                wmma::load_matrix_sync(b, ds + row * TW * CO_T + j * 16, CO_T);
                wmma::mma_sync(acc[j], a, b, acc[j]);
            }
        }
        __syncthreads();
    }

    float* out = partial + (((size_t)g * 9 + tap) * cinp + c0) * coutp + co0;
#pragma unroll
    for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(out + j * 16, acc[j], coutp, wmma::mem_row_major);
}

// K5, pass 2: dw[t][ci][co] = sum over g = 0..G-1, in that order.
__global__ void conv3x3_bf16_wgrad_reduce(const float* __restrict__ partial,
                                          float* __restrict__ dw, int G,
                                          int cin, int cout, int cinp,
                                          int coutp) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= 9 * cin * cout) return;
    const int t = i / (cin * cout);
    const int r = i - t * cin * cout;
    const int ci = r / cout, co = r - ci * cout;
    const size_t stride = (size_t)9 * cinp * coutp;
    const float* p = partial + ((size_t)t * cinp + ci) * coutp + co;
    float s = 0.0f;
    for (int g = 0; g < G; ++g) s += p[g * stride];
    dw[i] = s;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// K4. x: (N, H, W, cin) bf16, w: (3, 3, cin, cout) bf16, y: (N, H, W, cout)
// bf16, all contiguous. Returns cudaGetLastError() after the launch.
extern "C" int octseg_conv3x3_bf16(const void* x, const void* w, void* y,
                                   int N, int H, int W, int cin, int cout,
                                   void* stream) {
    const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
    dim3 grid(tiles_x * tiles_y, (cout + CO_T - 1) / CO_T, N);
    auto s = static_cast<cudaStream_t>(stream);
    auto xp = static_cast<const bf16*>(x);
    auto wp = static_cast<const bf16*>(w);
    auto yp = static_cast<bf16*>(y);
    if (cin % 8 == 0 && aligned16(x))
        conv3x3_bf16_fwd_kernel<true><<<grid, FWD_THREADS, 0, s>>>(xp, wp, yp, H, W, cin, cout, tiles_x);
    else
        conv3x3_bf16_fwd_kernel<false><<<grid, FWD_THREADS, 0, s>>>(xp, wp, yp, H, W, cin, cout, tiles_x);
    return static_cast<int>(cudaGetLastError());
}

// K5. x: (N, H, W, cin) bf16, dy: (N, H, W, cout) bf16, partial: fp32
// scratch of (G, 9, cinp, coutp) with cinp = cin rounded up to 16 and coutp
// = cout rounded up to 32, dw: (3, 3, cin, cout) fp32. Two launches.
extern "C" int octseg_conv3x3_bf16_wgrad(const void* x, const void* dy,
                                         void* partial, void* dw, int N,
                                         int H, int W, int cin, int cout,
                                         int cinp, int coutp, int G,
                                         void* stream) {
    const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
    dim3 grid(G, cinp / KC, coutp / CO_T);
    auto s = static_cast<cudaStream_t>(stream);
    auto xp = static_cast<const bf16*>(x);
    auto dp = static_cast<const bf16*>(dy);
    auto pp = static_cast<float*>(partial);
    const bool vx = cin % 8 == 0 && aligned16(x);
    const bool vd = cout % 8 == 0 && aligned16(dy);
    const int tpi = tiles_x * tiles_y;
    if (vx && vd)
        conv3x3_bf16_wgrad_kernel<true, true><<<grid, WG_THREADS, 0, s>>>(xp, dp, pp, N, H, W, cin, cout, cinp, coutp, tiles_x, tpi, G);
    else if (vx)
        conv3x3_bf16_wgrad_kernel<true, false><<<grid, WG_THREADS, 0, s>>>(xp, dp, pp, N, H, W, cin, cout, cinp, coutp, tiles_x, tpi, G);
    else if (vd)
        conv3x3_bf16_wgrad_kernel<false, true><<<grid, WG_THREADS, 0, s>>>(xp, dp, pp, N, H, W, cin, cout, cinp, coutp, tiles_x, tpi, G);
    else
        conv3x3_bf16_wgrad_kernel<false, false><<<grid, WG_THREADS, 0, s>>>(xp, dp, pp, N, H, W, cin, cout, cinp, coutp, tiles_x, tpi, G);
    int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    const int total = 9 * cin * cout;
    conv3x3_bf16_wgrad_reduce<<<(total + 255) / 256, 256, 0, s>>>(
        pp, static_cast<float*>(dw), G, cin, cout, cinp, coutp);
    return static_cast<int>(cudaGetLastError());
}
