// K10: the U-Net's fused stem: the 1-channel int8 image through the stem
// 3x3 conv (1 -> c1) and its requant, then blk0_conv1 (3x3, c1 -> cout) and
// its requant, writing the full-resolution output (the enc0 skip) and its
// 2x2/2 max-pool. The stem activation never reaches device memory.
//
// Replaces ops/pallas_conv_psrp.py:stem_conv_psrp (the opt-in fused stem of
// the PSRP serving graph, OCTSEG_PSRP_STEM_FUSE).
//
// Function, bit for bit that of two K1 calls (csrc/conv3x3_int8.cu):
//   mid[n,y,x,c] = requant(sum_{ky,kx} img[n,y+ky-1,x+kx-1] * w0[ky,kx,c],
//                          scale0[c], bias0[c])     (image zero-padded)
//   out[n,y,x,o] = requant(sum_{ky,kx,c} mid[n,y+ky-1,x+kx-1,c] * w1[..],
//                          scale1[o], bias1[o])     (mid zero-padded)
// with requant(acc, s, b) = clip(rint(relu(fmaf(float(acc), s, b))), +-127).
// The zero padding of `mid` matters: a halo position outside the image holds
// 0 (conv1's padding of the int8 stem activation), not the stem evaluated on
// a zero-padded image, which would be relu(rint(bias0)).
//
// Design: a block owns a 16x16 output tile and 32 output channels. It loads
// the 20x20 image window (the tile plus the two halos) into shared memory,
// computes the stem for the 18x18 window that conv1 reads, requantized to
// int8 and packed four channels to an int32 word, into shared memory (324
// pixels x c1 channels, ~10 KB at c1 = 32), and then runs conv1 from there
// exactly as K1 does (each thread a 2x2 output quad x 8 channels, __dp4a,
// the pool from the four results it holds).
//
// Bound on the card: at c1 = cout = 32 the bytes (the image in, the skip
// and the pooled tensor out) and the operations are about equal; the stem's
// share of the operations is 1/(cout+1). What K10 saves against K1 + K1 is
// the stem tensor's write and read (64 bytes per pixel at c1 = 32). The
// conv1 part runs on the dp4a pipe like K1, far below the tensor cores'
// int8 rate; wgmma tiles are the next step, as for K1.
//
// Weights: w0 and w1 are K1's packed layout (ops/conv_int8.py:
// pack_conv3x3_weights): int32 words (9, cinp/4, coutp), word [t, j, co]
// holding w[t//3, t%3, 4j..4j+3, co]. For the stem, cinp = 4 and only byte
// 0 of each word is the weight (cin = 1).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int HALO = TILE + 2;     // conv1's input window
constexpr int WIN = TILE + 4;      // the image window the stem reads
constexpr int COUT_T = 32;
constexpr int CPT = 8;
constexpr int THREADS = 256;
constexpr int MAX_C1 = 32;

__device__ __forceinline__ int8_t requant(int acc, float s, float b) {
    float v = __fmaf_rn(__int2float_rn(acc), s, b);
    v = fmaxf(v, 0.0f);
    v = rintf(v);
    v = fminf(v, 127.0f);
    return static_cast<int8_t>(__float2int_rn(v));
}

// KW: int32 words of the stem activation per pixel (1 for c1 <= 4, else 8).
template <int KW>
__global__ void __launch_bounds__(THREADS) stem_conv_int8_kernel(
    const int8_t* __restrict__ img, const int32_t* __restrict__ w0,
    const float* __restrict__ scale0, const float* __restrict__ bias0,
    const int32_t* __restrict__ w1, const float* __restrict__ scale1,
    const float* __restrict__ bias1, int8_t* __restrict__ y,
    int8_t* __restrict__ yp, int H, int W, int c1, int c1p, int cout,
    int coutp, int tiles_x) {
    __shared__ int32_t win[WIN * WIN];
    __shared__ int32_t w0s[9][MAX_C1];
    __shared__ float s0s[MAX_C1], b0s[MAX_C1];
    __shared__ int32_t xs[HALO * HALO][KW + 1];
    __shared__ __align__(16) int32_t ws[9][KW][COUT_T];

    const int n = blockIdx.z;
    const int co0 = blockIdx.y * COUT_T;
    const int ty0 = (blockIdx.x / tiles_x) * TILE;
    const int tx0 = (blockIdx.x % tiles_x) * TILE;
    const int tid = threadIdx.x;

    // the image window rows ty0-2 .. ty0+17, zero outside the image
    for (int i = tid; i < WIN * WIN; i += THREADS) {
        const int iy = ty0 - 2 + i / WIN, ix = tx0 - 2 + i % WIN;
        win[i] = (iy >= 0 && iy < H && ix >= 0 && ix < W)
                     ? (int32_t)img[((size_t)n * H + iy) * W + ix] : 0;
    }
    for (int i = tid; i < 9 * c1; i += THREADS) {
        const int t = i / c1, c = i - t * c1;
        // byte 0 of word [t, 0, c] is w0[t//3, t%3, 0, c]
        w0s[t][c] = (int32_t)reinterpret_cast<const int8_t*>(
            w0 + (size_t)t * c1p + c)[0];
    }
    for (int i = tid; i < c1; i += THREADS) {
        s0s[i] = scale0[i];
        b0s[i] = bias0[i];
    }
    for (int i = tid; i < 9 * KW * COUT_T; i += THREADS) {
        const int t = i / (KW * COUT_T);
        const int r = i - t * KW * COUT_T;
        const int j = r / COUT_T, c = r - j * COUT_T;
        ws[t][j][c] = w1[((size_t)t * KW + j) * coutp + co0 + c];
    }
    __syncthreads();

    // stage 1: the stem at the 18x18 window, int8, four channels a word;
    // 0 outside the image (conv1's padding) and beyond c1
    for (int i = tid; i < HALO * HALO * KW; i += THREADS) {
        const int p = i / KW, j = i - p * KW;
        const int py = p / HALO, px = p % HALO;
        const int iy = ty0 - 1 + py, ix = tx0 - 1 + px;
        uint32_t u = 0;
        if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
            int v[9];
#pragma unroll
            for (int t = 0; t < 9; ++t)
                v[t] = win[(py + t / 3) * WIN + px + t % 3];
#pragma unroll
            for (int b = 0; b < 4; ++b) {
                const int c = 4 * j + b;
                if (c < c1) {
                    int acc = 0;
#pragma unroll
                    for (int t = 0; t < 9; ++t) acc += v[t] * w0s[t][c];
                    u |= (uint32_t)(uint8_t)requant(acc, s0s[c], b0s[c])
                         << (8 * b);
                }
            }
        }
        xs[p][j] = (int32_t)u;
    }
    __syncthreads();

    // stage 2: conv1 from shared memory, as K1
    const int q = tid & 63;
    const int g = tid >> 6;
    const int qy = q >> 3, qx = q & 7;
    int acc[4][CPT];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[p][c] = 0;
#pragma unroll
    for (int j = 0; j < KW; ++j) {
        int32_t xv[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b)
                xv[a][b] = xs[(2 * qy + a) * HALO + 2 * qx + b][j];
#pragma unroll
        for (int t = 0; t < 9; ++t) {
            const int ky = t / 3, kx = t % 3;
            const int4 wa = *reinterpret_cast<const int4*>(&ws[t][j][g * CPT]);
            const int4 wb = *reinterpret_cast<const int4*>(&ws[t][j][g * CPT + 4]);
            const int wv[CPT] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int dy = 0; dy < 2; ++dy)
#pragma unroll
                for (int dx = 0; dx < 2; ++dx) {
                    const int32_t xw = xv[dy + ky][dx + kx];
#pragma unroll
                    for (int c = 0; c < CPT; ++c)
                        acc[dy * 2 + dx][c] = __dp4a(xw, wv[c], acc[dy * 2 + dx][c]);
                }
        }
    }

    const int oy = ty0 + 2 * qy, ox = tx0 + 2 * qx;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
        const int co = co0 + g * CPT + c;
        if (co >= cout) break;
        const float s = scale1[co], b = bias1[co];
        int8_t m = -128;
#pragma unroll
        for (int dy = 0; dy < 2; ++dy)
#pragma unroll
            for (int dx = 0; dx < 2; ++dx) {
                const int yy = oy + dy, xx = ox + dx;
                if (yy < H && xx < W) {
                    const int8_t v = requant(acc[dy * 2 + dx][c], s, b);
                    y[(((size_t)n * H + yy) * W + xx) * cout + co] = v;
                    m = v > m ? v : m;
                }
            }
        if (oy < H && ox < W)
            yp[(((size_t)n * (H / 2) + oy / 2) * (W / 2) + ox / 2) * cout + co] = m;
    }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). img (N, H, W)
// int8; w0 (9, 1, c1p, 4) and w1 (9, cinp/4, coutp, 4) K1-packed int8 with
// cinp = 4 (c1 <= 4) or 32 (c1 <= 32); y (N, H, W, cout), yp (N, H/2, W/2,
// cout); H and W even.
extern "C" int octseg_stem_conv_int8(
    const void* img, const void* w0, const void* scale0, const void* bias0,
    const void* w1, const void* scale1, const void* bias1, void* y, void* yp,
    int N, int H, int W, int c1, int c1p, int cinp, int cout, int coutp,
    void* stream) {
    const int tiles_x = (W + TILE - 1) / TILE;
    const int tiles_y = (H + TILE - 1) / TILE;
    dim3 grid(tiles_x * tiles_y, coutp / COUT_T, N);
    auto s = static_cast<cudaStream_t>(stream);
    auto a = static_cast<const int8_t*>(img);
    auto ww0 = static_cast<const int32_t*>(w0);
    auto ww1 = static_cast<const int32_t*>(w1);
    auto s0 = static_cast<const float*>(scale0);
    auto b0 = static_cast<const float*>(bias0);
    auto s1 = static_cast<const float*>(scale1);
    auto b1 = static_cast<const float*>(bias1);
    auto o = static_cast<int8_t*>(y);
    auto op = static_cast<int8_t*>(yp);
    if (cinp == 4)
        stem_conv_int8_kernel<1><<<grid, THREADS, 0, s>>>(
            a, ww0, s0, b0, ww1, s1, b1, o, op, H, W, c1, c1p, cout, coutp, tiles_x);
    else
        stem_conv_int8_kernel<8><<<grid, THREADS, 0, s>>>(
            a, ww0, s0, b0, ww1, s1, b1, o, op, H, W, c1, c1p, cout, coutp, tiles_x);
    return static_cast<int>(cudaGetLastError());
}
