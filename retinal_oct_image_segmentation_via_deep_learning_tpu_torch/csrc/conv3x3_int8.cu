// K1: int8 3x3 stride-1 "same" convolution with a fused requant epilogue
// and an optional fused 2x2/2 max-pool or fused 1x1 head + argmax, for
// NHWC int8 activations.
//
// Replaces three TPU kernels that compute this one function in different
// lane packings:
//   ops/pallas_conv_psrp.py:conv3x3_psrp  (512^2 / 256^2 stages, +pool,
//                                          +head)
//   ops/pallas_conv_psrp.py:stem_psrp     (the Cin=1 stem)
//   ops/pallas_conv_int8.py:conv3x3_int8  (deep stages, by=1)
// with the knobs of the w4a4 serving mode (out_clip, pad_val(s), the
// split-scale pool) and conv3x3_psrp's fused head.
//
// Function: acc[n,y,x,co] = sum_{ky,kx,c} in[n,y+ky-1,x+kx-1,c] * w[ky,kx,c,co]
// in int32, where `in` is the channel concat of one or two inputs (the
// concat is never materialised: the tile loader reads both pointers) and
// out-of-image pixels of input k hold pad_k (0, or -7 for an input stored
// at zero point 7). Epilogue, in this order:
//   v = fmaf(float(acc), scale[co], bias[co]); relu; rint (half-even);
//   clip to [-out_clip, out_clip]; int8.
// With a pool output, the pooled value of each 2x2 window is taken from
// the float32 max m of its four v (after relu, before rounding):
// clip(rint(fmaf(m, pool_rescale, pool_shift)), +-pool_clip).
// With pool_rescale = 1, pool_shift = 0 and pool_clip = out_clip that is
// the max of the four int8 results (round and clip are monotone); the w4a4
// mode sets (14/127, -7, 7), so the pooled tensor gets a 4-bit scale of
// its own while the unpooled output keeps 8 bits.
// With the head (HEAD), the block keeps its requantized tile in shared
// memory instead of writing it to device memory, and then computes for
// each pixel z[k] = fmaf(float(sum_c t[c] * wh[k,c]), hscale[k],
// hbias[k]) and the argmax with ties to the lowest class (K3's arithmetic,
// csrc/head_argmax.cu). Only the labels leave the chip.
// int32 sums are exact in any order, so every body gives the same bits.
//
// The TPU kernels' dot_int4 knob runs the MXU at its int4 rate. Hopper's
// tensor cores take s8 and no s4 operands through mma.sync and wgmma; the
// w4a4 operands are +-7 values stored in int8, so the 4-bit modes run the
// same int8 products.
//
// What bounds K1 on an H100 (int8 at 1979 TOPS dense, HBM at 3.35 TB/s):
// the three 512^2 stages and three of the four 256^2 ones (32-64 channels
// in) do 256-576 operations a byte moved, under the ~590 at which the
// tensor cores and not HBM are the limit: they are bound by bytes. The
// others (blk7_conv0's 128 channels in, and every stage from 128^2 down)
// are bound by operations.
//
// The stem (Cin = 1) is bound by bytes everywhere: 18 multiply-adds a
// pixel and output channel against one byte written for each, so at 512^2
// x 32 channels its 268 MB of int8 output (batch 32) set the bound.
//
// K1 has three bodies; ops/conv_int8.py:conv3x3_plan chooses one per call
// by shape.
// - conv3x3_int8_stem (one input of one channel, cout 16, 32 or 64, W a
//   multiple of 16, an aligned input; no pool, no head): the stem of the
//   served graphs. The 9 taps are folded into K of one mma.sync m16n8k32
//   s8: K byte 4*ky + kx holds tap (ky, kx), so lane l (t = l % 4) holds in
//   its A register a0 the 4 input bytes of halo row ky = t, columns x-1 ..
//   x+2, of its pixel x (the fourth byte meets a zero weight; lanes t = 3
//   meet only zero weights), one funnel shift of two 32-bit words of the
//   byte halo in shared memory; a2, a3 and b1 (K bytes 16-31) are 0. One
//   product a n8 tile covers 16 pixels. The weights stay in registers (b0
//   of each n8 tile), and the output channels are permuted in the weight
//   pack so that the C fragment gives each lane cout/4 consecutive
//   channels of one pixel: column 2q+e of n8 tile j is channel (cout/4)q +
//   2j + e. The requant (K1's: the FMA, then rounded_bits) runs in
//   registers, and each lane stores its cout/4 bytes of a pixel in one
//   4-, 8- or 16-byte store: a warp's store is 8 pixels x cout bytes,
//   contiguous. A persistent grid walks tiles of 8 whole image rows (one a
//   warp); the next tile's 10 halo rows arrive by cp.async into the other
//   half of a double buffer while this tile multiplies and stores.
//   Halo rows and columns outside the image hold the pad value.
// - conv3x3_int8_mma (every input's channels a multiple of 32, cout a
//   multiple of 32, 16-byte aligned inputs; with the head cout = 32):
//   K7's implicit GEMM (csrc/conv7x3_int8.cu:conv7x3_mma) with KH = 3 on
//   mma.sync m16n8k32 s8 * s8 -> s32. M = the pixels of a 32 x 16 output
//   tile (8 warps x 4 m16 tiles; 16 x 16 for blocks of 4 warps), N = 32 or
//   64 output channels a block, K = 9 taps x the chunks of 32 channels of
//   one input (x0's chunks first). Chunk j's (rows + 2) x 18 halo (32
//   bytes a pixel) and its 9 x N weight rows arrive by cp.async 16-byte
//   copies into a ring of 2-3 slots in shared memory; a halo unit outside
//   the image is filled with 16 bytes of its input's pad value by a
//   shared-memory store (a chunk lies inside one input, so one value fills
//   the unit). Each 32-byte row's two 16-byte units are XOR-swizzled by
//   bit 2 of the pixel (swz), so the 8 rows of every ldmatrix phase fall
//   in 8 bank groups. A warp reads each of its 6 halo rows once a kx for
//   all three ky (K4's mma_chunk, csrc/conv3x3_bf16.cu). The 512^2 and
//   256^2 stages have 1-2 chunks, too few for a ring in one block to hide
//   the first copy or the epilogue: at N = 32 the 64 int32 accumulators a
//   thread let two blocks of 8 warps (four of 4 warps at one chunk) share
//   an SM, and one multiplies while another copies or stores; the deep
//   stages take N = 64 where cout allows. Epilogue, from the accumulator
//   fragments: FMA, relu and the clip, rounded by an add (rounded_bits,
//   not rintf), the int8 result into a rows x 16 x N tile in shared
//   memory (rows padded by 16 bytes: conflict-free 2-byte writes), which
//   leaves as 16-byte stores, neighbouring threads on neighbouring
//   addresses. The pool is taken from the float values in registers: the
//   C fragment holds pixel (tile row warp*4 + m, column lane/4 + 8h), so
//   a window's rows are m and m+1 of one thread (m even) and its columns
//   lanes l and l^4; a register max and one shuffle give its max, and the
//   pooled int8 tile leaves as 16-byte stores too. The head reads the
//   int8 tile and the head's weights (in the freed ring) from shared
//   memory, one thread per pixel.
// - conv3x3_int8_kernel (odd channel counts, stems of other widths,
//   misaligned inputs): the first design, on __dp4a. A block stages an
//   18 x 18-pixel input tile and the matching weight slice per 32-channel
//   chunk; each thread reuses every input word of its 4x4 window across 8
//   output channels and 9 taps (288 dp4a per 16 input and 18 vector
//   weight loads), and owns a 2x2 output quad (its pool).
//
// Weights: the mma.sync body reads ops/conv_int8.py:pack_conv3x3_mma_weights,
// int8 (nk, 9, cout, 32), byte [j, t, co, b] = w[t/3, t%3, 32j+b, co]. The
// stem body reads pack_stem_mma_weights, int8 (cout, 16): row n = 8j + c
// (GEMM column c of n8 tile j) holds channel (cout/4)(c/2) + 2j + c%2,
// byte 4*ky + kx its tap (ky, kx), bytes 4*ky + 3 and 12-15 zero. The
// dp4a body reads pack_conv3x3_weights, int32 words (9, cinp/4, coutp):
// word [t, j, co] holds w[t//3, t%3, 4j..4j+3, co], cinp = cin padded to
// the chunk width, coutp = cout padded to 32; padding is zero. Head
// weights (ops/head_argmax.py:pack_head_weights) are int32 words (nc,
// cout/4).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_int8.cuh"

namespace {

constexpr int TILE = 16;           // output tile edge, pixels
constexpr int HALO = TILE + 2;     // input tile edge
constexpr int COUT_T = 32;         // output channels per block
constexpr int CPT = 8;             // output channels per thread
constexpr int THREADS = 256;       // 64 quads x 4 channel groups
constexpr int HEAD_STRIDE = COUT_T / 4 + 1;  // words per pixel of the head tile
constexpr int MAX_NC = 32;         // head classes

__device__ __forceinline__ int8_t round_clip(float v, float clip) {
    v = rintf(v);
    v = fminf(fmaxf(v, -clip), clip);
    return static_cast<int8_t>(__float2int_rn(v));
}

__device__ __forceinline__ uint32_t splat(int pad) {
    return (uint32_t)(uint8_t)(int8_t)pad * 0x01010101u;
}

// KW: int32 words (4 channels each) per channel chunk. WORDS: both inputs
// have a channel count divisible by 4, so a word never straddles inputs and
// is one aligned 32-bit load; otherwise bytes are gathered one by one.
// HEAD: end in the 1x1 head + argmax (one block of output channels).
template <int KW, bool WORDS, bool HEAD>
__global__ void __launch_bounds__(THREADS) conv3x3_int8_kernel(
    const int8_t* __restrict__ x0, int cin0,
    const int8_t* __restrict__ x1, int cin1,
    const int32_t* __restrict__ w, const float* __restrict__ scale,
    const float* __restrict__ bias, int8_t* __restrict__ y,
    int8_t* __restrict__ yp, int H, int W, int cinp, int cout, int coutp,
    int relu, int pad0, int pad1, float out_clip, float pool_rescale,
    float pool_shift, float pool_clip, const int32_t* __restrict__ hw,
    const float* __restrict__ hscale, const float* __restrict__ hbias,
    int nc, int8_t* __restrict__ labels, int tiles_x) {
    __shared__ int32_t xs[HALO * HALO][KW + 1];
    __shared__ __align__(16) int32_t ws[9][KW][COUT_T];
    static_assert(!HEAD || HALO * HALO * (KW + 1) >= TILE * TILE * HEAD_STRIDE,
                  "the head tile reuses the input tile's shared memory");
    static_assert(!HEAD || 9 * KW * COUT_T >= MAX_NC * (COUT_T / 4 + 2),
                  "the head weights reuse the weight tile's shared memory");

    const int n = blockIdx.z;
    const int co0 = blockIdx.y * COUT_T;
    const int ty0 = (blockIdx.x / tiles_x) * TILE;
    const int tx0 = (blockIdx.x % tiles_x) * TILE;
    const int tid = threadIdx.x;
    const int q = tid & 63;   // output quad within the tile
    const int g = tid >> 6;   // channel group; uniform across a warp
    const int qy = q >> 3, qx = q & 7;
    const int cin = cin0 + cin1;
    const int cinw = cinp / 4;
    const uint32_t fill0 = splat(pad0), fill1 = splat(pad1);

    int acc[4][CPT];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[p][c] = 0;

    for (int ch = 0; ch < cinw / KW; ++ch) {
        for (int i = tid; i < HALO * HALO * KW; i += THREADS) {
            const int p = i / KW, j = i - p * KW;
            const int iy = ty0 - 1 + p / HALO, ix = tx0 - 1 + p % HALO;
            const int c = (ch * KW + j) * 4;
            const bool inside = iy >= 0 && iy < H && ix >= 0 && ix < W;
            const size_t pix = ((size_t)n * H + iy) * W + ix;
            int32_t v = 0;  // channel padding c >= cin stays 0
            if (WORDS) {
                if (c < cin0)
                    v = inside ? *reinterpret_cast<const int32_t*>(x0 + pix * cin0 + c)
                               : (int32_t)fill0;
                else if (c < cin)
                    v = inside ? *reinterpret_cast<const int32_t*>(x1 + pix * cin1 + (c - cin0))
                               : (int32_t)fill1;
            } else {
                uint32_t u = 0;
#pragma unroll
                for (int b = 0; b < 4; ++b) {
                    const int cc = c + b;
                    int8_t s = 0;
                    if (cc < cin0) s = inside ? x0[pix * cin0 + cc] : (int8_t)pad0;
                    else if (cc < cin) s = inside ? x1[pix * cin1 + (cc - cin0)] : (int8_t)pad1;
                    u |= (uint32_t)(uint8_t)s << (8 * b);
                }
                v = (int32_t)u;
            }
            xs[p][j] = v;
        }
        for (int i = tid; i < 9 * KW * COUT_T; i += THREADS) {
            const int t = i / (KW * COUT_T);
            const int r = i - t * KW * COUT_T;
            const int j = r / COUT_T, c = r - j * COUT_T;
            ws[t][j][c] = w[((size_t)t * cinw + ch * KW + j) * coutp + co0 + c];
        }
        __syncthreads();

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
        __syncthreads();
    }

    // HEAD: the requantized tile, int32 words [pixel][HEAD_STRIDE], in xs
    int8_t* tile = reinterpret_cast<int8_t*>(&xs[0][0]);
    const int oy = ty0 + 2 * qy, ox = tx0 + 2 * qx;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
        const int co = co0 + g * CPT + c;
        if (co >= cout) break;
        const float s = scale[co], b = bias[co];
        float m = -INFINITY;
#pragma unroll
        for (int dy = 0; dy < 2; ++dy)
#pragma unroll
            for (int dx = 0; dx < 2; ++dx) {
                const int yy = oy + dy, xx = ox + dx;
                if (yy < H && xx < W) {
                    float v = __fmaf_rn(__int2float_rn(acc[dy * 2 + dx][c]), s, b);
                    if (relu) v = fmaxf(v, 0.0f);
                    const int8_t r = round_clip(v, out_clip);
                    if constexpr (HEAD) {
                        const int p = (2 * qy + dy) * TILE + 2 * qx + dx;
                        tile[p * HEAD_STRIDE * 4 + co] = r;
                    } else {
                        y[(((size_t)n * H + yy) * W + xx) * cout + co] = r;
                    }
                    m = fmaxf(m, v);
                }
            }
        if (!HEAD && yp != nullptr && oy < H && ox < W)
            yp[(((size_t)n * (H / 2) + oy / 2) * (W / 2) + ox / 2) * cout + co] =
                round_clip(__fmaf_rn(m, pool_rescale, pool_shift), pool_clip);
    }

    if constexpr (HEAD) {
        const int cw = cout / 4;
        int32_t* hws = &ws[0][0][0];
        float* hss = reinterpret_cast<float*>(hws + MAX_NC * (COUT_T / 4));
        float* hbs = hss + MAX_NC;
        for (int i = tid; i < nc * cw; i += THREADS) hws[i] = hw[i];
        for (int i = tid; i < nc; i += THREADS) {
            hss[i] = hscale[i];
            hbs[i] = hbias[i];
        }
        __syncthreads();
        const int py = tid / TILE, px = tid % TILE;
        const int yy = ty0 + py, xx = tx0 + px;
        if (yy < H && xx < W) {
            const int32_t* t = reinterpret_cast<const int32_t*>(tile) + tid * HEAD_STRIDE;
            int32_t tv[COUT_T / 4];
#pragma unroll
            for (int j = 0; j < COUT_T / 4; ++j) tv[j] = j < cw ? t[j] : 0;
            float best = 0.0f;
            int arg = 0;
            for (int k = 0; k < nc; ++k) {
                int a = 0;
#pragma unroll
                for (int j = 0; j < COUT_T / 4; ++j)
                    if (j < cw) a = __dp4a(tv[j], hws[k * cw + j], a);
                const float z = __fmaf_rn(__int2float_rn(a), hss[k], hbs[k]);
                if (k == 0 || z > best) {
                    best = z;
                    arg = k;
                }
            }
            labels[((size_t)n * H + yy) * W + xx] = static_cast<int8_t>(arg);
        }
    }
}

template <int KW, bool WORDS, bool HEAD>
void launch(const int8_t* x0, int cin0, const int8_t* x1, int cin1,
            const int32_t* w, const float* scale, const float* bias,
            int8_t* y, int8_t* yp, int N, int H, int W, int cinp, int cout,
            int coutp, int relu, int pad0, int pad1, float out_clip,
            float pool_rescale, float pool_shift, float pool_clip,
            const int32_t* hw, const float* hscale, const float* hbias,
            int nc, int8_t* labels, cudaStream_t stream) {
    const int tiles_x = (W + TILE - 1) / TILE;
    const int tiles_y = (H + TILE - 1) / TILE;
    dim3 grid(tiles_x * tiles_y, coutp / COUT_T, N);
    conv3x3_int8_kernel<KW, WORDS, HEAD><<<grid, THREADS, 0, stream>>>(
        x0, cin0, x1, cin1, w, scale, bias, y, yp, H, W, cinp, cout, coutp,
        relu, pad0, pad1, out_clip, pool_rescale, pool_shift, pool_clip, hw,
        hscale, hbias, nc, labels, tiles_x);
}

// ------------------------------------------------------------ mma.sync body
// A block is WARPS warps (8 or 4) on a tile of WARPS * MW rows by COLS
// columns; the halo of one chunk is (rows + 2) x HALO_W pixels.
constexpr int MW = 4;                    // tile rows (m16 tiles) a warp
constexpr int COLS = 16;                 // output tile columns: one m16 tile
constexpr int HALO_W = COLS + 2;         // halo columns
constexpr int KCH = 32;                  // bytes of K a chunk: the MMA's k
constexpr int PITCH = HALO_W * KCH;      // bytes a halo row of one chunk

__host__ __device__ constexpr int halo_bytes(int warps) { return (warps * MW + 2) * PITCH; }

// The products of one K chunk (the 3 x 3 taps) for a warp's M tile rows.
// For each kx: the B fragments of the taps (0..2, kx) (ldmatrix from each
// tap's N x 32 bytes at b_base), then each of the M + 2 halo rows r that
// the tile rows read at that kx (ldmatrix at a_rows + r * RP + a_col[kx]),
// multiplied into every tile row m = r - ky it serves: a halo row is read
// once for up to three taps.
template <int M, int NT, int RP>
__device__ __forceinline__ void mma_chunk(int (&acc)[M][NT][4],
                                          uint32_t a_rows,
                                          const uint32_t (&a_col)[3],
                                          uint32_t b_base,
                                          const uint32_t (&b_off)[NT / 2]) {
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
        uint32_t b[3][NT][2];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
            const uint32_t bt = b_base + (ky * 3 + kx) * NT * 8 * KCH;
#pragma unroll
            for (int j = 0; j < NT / 2; ++j) {
                uint32_t r[4];
                ldmatrix_x4(r, bt + b_off[j]);
                b[ky][2 * j][0] = r[0];
                b[ky][2 * j][1] = r[1];
                b[ky][2 * j + 1][0] = r[2];
                b[ky][2 * j + 1][1] = r[3];
            }
        }
#pragma unroll
        for (int r = 0; r < M + 2; ++r) {
            uint32_t a[4];
            ldmatrix_x4(a, a_rows + r * RP + a_col[kx]);
#pragma unroll
            for (int ky = 0; ky < 3; ++ky) {
                const int m = r - ky;
                if (m < 0 || m >= M) continue;
#pragma unroll
                for (int t = 0; t < NT; ++t)
                    mma_s8(acc[m][t], a, b[ky][t][0], b[ky][t][1]);
            }
        }
    }
}

// This lane's ldmatrix offsets: A rows are 16 pixels of a tile row (matrix
// l/8: pixels 0-7 | 8-15, bytes 0-15 | 16-31), shifted by kx; B rows are
// output channels (matrices: channels 16j + 0-7, units 0 | 1, then 16j +
// 8-15).
template <int NT>
__device__ __forceinline__ void lane_offsets(int lane, uint32_t (&a_col)[3],
                                             uint32_t (&b_off)[NT / 2]) {
#pragma unroll
    for (int kx = 0; kx < 3; ++kx)
        a_col[kx] = swz(kx + (lane & 7) + 8 * ((lane >> 3) & 1), lane >> 4);
#pragma unroll
    for (int j = 0; j < NT / 2; ++j)
        b_off[j] = swz(16 * j + (lane & 7) + 8 * (lane >> 4), (lane >> 3) & 1);
}

// The requant and its knobs, the pool's and the head's tensors.
struct Epilogue {
    const float* scale;
    const float* bias;
    int relu;
    float out_clip, pool_rescale, pool_shift, pool_clip;
    int8_t* y;
    int8_t* yp;
    const int32_t* hw;
    const float* hscale;
    const float* hbias;
    int nc;
    int8_t* labels;
};

// Requant the accumulators into the int8 tile os (rows x COLS pixels, rows
// of N + 16 bytes); with a pool, the pooled values of the tile's windows
// from the float values into the pooled tile ps ((rows/2) x (COLS/2)
// pixels, the same rows) after it; then y and yp leave from the tiles in
// 16-byte stores. HEAD: the head's weights, scales and biases go after
// the tile, and each pixel's labels leave instead.
template <int NT, int WARPS, bool HEAD>
__device__ __forceinline__ void epilogue(const int (&acc)[MW][NT][4],
                                         uint8_t* smem, const Epilogue& ep,
                                         int n, int H, int W, int y0, int x0,
                                         int co0, int cout) {
    constexpr int CO_T = NT * 8, OP = CO_T + 16, UPP = CO_T / 16;
    constexpr int ROWS = WARPS * MW, THREADS_B = 32 * WARPS;
    constexpr int OUT = ROWS * COLS * OP;
    uint8_t* os = smem;
    uint8_t* ps = smem + OUT;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const bool pool = ep.yp != nullptr;
    int32_t* hws = reinterpret_cast<int32_t*>(smem + OUT);
    float* hss = reinterpret_cast<float*>(hws + MAX_NC * (CO_T / 4));
    float* hbs = hss + MAX_NC;
    if constexpr (HEAD) {
        for (int i = tid; i < ep.nc * (CO_T / 4); i += THREADS_B) hws[i] = ep.hw[i];
        for (int i = tid; i < ep.nc; i += THREADS_B) {
            hss[i] = ep.hscale[i];
            hbs[i] = ep.hbias[i];
        }
    }
    const float lo = ep.relu ? 0.0f : -ep.out_clip;  // relu, then the clip
#pragma unroll
    for (int t = 0; t < NT; ++t) {
        const int c = 8 * t + 2 * (lane & 3), co = co0 + c;
        const float s0 = ep.scale[co], b0 = ep.bias[co];
        const float s1 = ep.scale[co + 1], b1 = ep.bias[co + 1];
        float v[MW][2][2];  // [tile row m][pixel half h][channel c + e]
#pragma unroll
        for (int m = 0; m < MW; ++m)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const float v0 = __fmaf_rn(__int2float_rn(acc[m][t][2 * h]), s0, b0);
                const float v1 = __fmaf_rn(__int2float_rn(acc[m][t][2 * h + 1]), s1, b1);
                v[m][h][0] = ep.relu ? fmaxf(v0, 0.0f) : v0;
                v[m][h][1] = ep.relu ? fmaxf(v1, 0.0f) : v1;
                const int px = (warp * MW + m) * COLS + (lane >> 2) + 8 * h;
                *reinterpret_cast<uint16_t*>(os + px * OP + c) =
                    static_cast<uint16_t>(__byte_perm(
                        rounded_bits(v0, lo, ep.out_clip),
                        rounded_bits(v1, lo, ep.out_clip), 0x0040));
            }
        if (!HEAD && pool) {
            // window (tile rows m, m+1; columns of lanes l, l^4)
#pragma unroll
            for (int m = 0; m < MW; m += 2)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    float mx[2];
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        mx[e] = fmaxf(v[m][h][e], v[m + 1][h][e]);
                        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 4));
                    }
                    if ((lane & 4) == 0) {
                        const int pp = ((warp * MW + m) / 2) * (COLS / 2) +
                                       (lane >> 3) + 4 * h;
                        *reinterpret_cast<uint16_t*>(ps + pp * OP + c) =
                            static_cast<uint16_t>(__byte_perm(
                                rounded_bits(__fmaf_rn(mx[0], ep.pool_rescale, ep.pool_shift),
                                             -ep.pool_clip, ep.pool_clip),
                                rounded_bits(__fmaf_rn(mx[1], ep.pool_rescale, ep.pool_shift),
                                             -ep.pool_clip, ep.pool_clip),
                                0x0040));
                    }
                }
        }
    }
    __syncthreads();
    if constexpr (HEAD) {
        constexpr int CW = CO_T / 4;  // int32 words of a pixel's channels
        for (int p = tid; p < ROWS * COLS; p += THREADS_B) {
            const int oy = y0 + p / COLS, ox = x0 + p % COLS;
            if (oy >= H || ox >= W) continue;
            int32_t tv[CW];
#pragma unroll
            for (int q = 0; q < CW / 4; ++q) {
                const int4 u = *reinterpret_cast<const int4*>(os + p * OP + 16 * q);
                tv[4 * q] = u.x;
                tv[4 * q + 1] = u.y;
                tv[4 * q + 2] = u.z;
                tv[4 * q + 3] = u.w;
            }
            float best = 0.0f;
            int arg = 0;
            for (int k = 0; k < ep.nc; ++k) {
                int a = 0;
#pragma unroll
                for (int j = 0; j < CW; ++j) a = __dp4a(tv[j], hws[k * CW + j], a);
                const float z = __fmaf_rn(__int2float_rn(a), hss[k], hbs[k]);
                if (k == 0 || z > best) {
                    best = z;
                    arg = k;
                }
            }
            ep.labels[((size_t)n * H + oy) * W + ox] = static_cast<int8_t>(arg);
        }
        return;
    }
    for (int e = tid; e < ROWS * COLS * UPP; e += THREADS_B) {
        const int px = e / UPP, u = e - px * UPP;
        const int oy = y0 + px / COLS, ox = x0 + px % COLS;
        if (oy < H && ox < W)
            *reinterpret_cast<uint4*>(
                ep.y + (((size_t)n * H + oy) * W + ox) * cout + co0 + 16 * u) =
                *reinterpret_cast<const uint4*>(os + px * OP + 16 * u);
    }
    if (!pool) return;
    const int H2 = H / 2, W2 = W / 2;
    for (int e = tid; e < (ROWS / 2) * (COLS / 2) * UPP; e += THREADS_B) {
        const int pp = e / UPP, u = e - pp * UPP;
        const int oy = y0 / 2 + pp / (COLS / 2), ox = x0 / 2 + pp % (COLS / 2);
        if (oy < H2 && ox < W2)
            *reinterpret_cast<uint4*>(
                ep.yp + (((size_t)n * H2 + oy) * W2 + ox) * cout + co0 + 16 * u) =
                *reinterpret_cast<const uint4*>(ps + pp * OP + 16 * u);
    }
}

// The mma.sync body: grid (tiles * n_co, N), the channel tile fastest (so
// the blocks that read one tile's input run side by side and the second
// read comes from L2), 32 * WARPS threads, dynamic shared memory of
// `stages` ring slots (halo chunk, then weights); the epilogue's tiles
// reuse the ring. w: (nk, 9, cout, 32) int8. Resident blocks an SM: four
// of 4 warps, two of 8 warps at N = 32 (64 int32 accumulators a thread),
// one at N = 64.
template <int NT, int WARPS, bool HEAD>
__global__ void __launch_bounds__(32 * WARPS, NT == 8 ? 1 : (WARPS == 4 ? 4 : 2)) conv3x3_int8_mma(
    const int8_t* __restrict__ x0, int cin0, const int8_t* __restrict__ x1,
    int cin1, const int8_t* __restrict__ w, Epilogue ep, int pad0, int pad1,
    int H, int W, int cout, int nk, int stages, int tiles_x, int n_co) {
    constexpr int CO_T = NT * 8, ROWS = WARPS * MW, HR = ROWS + 2;
    constexpr int THREADS_B = 32 * WARPS, M_HALO = halo_bytes(WARPS);
    constexpr int STAGE = M_HALO + 9 * CO_T * KCH;
    extern __shared__ __align__(128) uint8_t k1_smem[];
    const uint32_t base = smem_addr(k1_smem);

    const int n = blockIdx.y, tile = blockIdx.x / n_co;
    const int co0 = (blockIdx.x - tile * n_co) * CO_T;
    const int ty0 = (tile / tiles_x) * ROWS;  // the tile's origin
    const int tx0 = (tile % tiles_x) * COLS;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    uint32_t a_col[3], b_off[NT / 2];
    lane_offsets<NT>(lane, a_col, b_off);

    int acc[MW][NT][4];
#pragma unroll
    for (int m = 0; m < MW; ++m)
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][t][e] = 0;

    // copy group j: chunk j's halo (pixel rows y0-1.., columns x0-1..; 32
    // channels of one input, its pad value outside the image) and weights
    // into ring slot j % stages
    auto issue = [&](int j) {
        if (j < nk) {
            const uint32_t off = (j % stages) * STAGE;
            const bool first = j * KCH < cin0;
            const int8_t* src = first ? x0 + j * KCH : x1 + (j * KCH - cin0);
            const int stride = first ? cin0 : cin1;
            const uint32_t f = splat(first ? pad0 : pad1);
            for (int e = tid; e < HR * HALO_W * 2; e += THREADS_B) {
                const int u = e & 1, p = e >> 1;
                const int hr = p / HALO_W, hc = p - hr * HALO_W;
                const int iy = ty0 - 1 + hr, ix = tx0 - 1 + hc;
                const uint32_t dst = off + hr * PITCH + swz(hc, u);
                if (iy >= 0 && iy < H && ix >= 0 && ix < W)
                    cp_async16(base + dst,
                               src + (((size_t)n * H + iy) * W + ix) * stride + 16 * u,
                               true);
                else
                    *reinterpret_cast<uint4*>(k1_smem + dst) = make_uint4(f, f, f, f);
            }
            const int8_t* wj = w + (size_t)j * 9 * cout * KCH;
            for (int e = tid; e < 9 * CO_T * 2; e += THREADS_B) {
                const int u = e & 1, r = e >> 1;
                const int tap = r / CO_T, co = r - tap * CO_T;
                cp_async16(base + off + M_HALO + tap * CO_T * KCH + swz(co, u),
                           wj + ((size_t)tap * cout + co0 + co) * KCH + 16 * u,
                           true);
            }
        }
        cp_async_commit();
    };

    for (int s = 0; s < stages - 1; ++s) issue(s);
    for (int j = 0; j < nk; ++j) {
        if (stages == 3) cp_async_wait<1>();  // this thread's group j landed
        else cp_async_wait<0>();
        __syncthreads();        // everyone's has; chunk j-1's products done
        issue(j + stages - 1);  // into the slot chunk j-1 freed
        const uint32_t slot = base + (j % stages) * STAGE;
        mma_chunk<MW, NT, PITCH>(acc, slot + warp * MW * PITCH, a_col,
                                 slot + M_HALO, b_off);
    }
    cp_async_wait<0>();
    __syncthreads();  // the epilogue's tiles reuse the ring
    epilogue<NT, WARPS, HEAD>(acc, k1_smem, ep, n, H, W, ty0, tx0, co0, cout);
}

// Dynamic shared memory of one mma.sync block (ops/conv_int8.py:mma_smem):
// the ring, or the epilogue's int8 tile and after it the pooled tile or
// the head's parameters, whichever is larger.
int mma_smem_bytes(int co_t, int stages, int warps) {
    const int ring = stages * (halo_bytes(warps) + 9 * co_t * KCH);
    const int rows = warps * MW, op = co_t + 16, pooled = rows * COLS / 4 * op;
    const int head = MAX_NC * (co_t + 8);
    const int epi = rows * COLS * op + (pooled > head ? pooled : head);
    return ring > epi ? ring : epi;
}

template <int NT, int WARPS, bool HEAD>
int launch_mma(const int8_t* x0, int cin0, const int8_t* x1, int cin1,
               const int8_t* w, const Epilogue& ep, int pad0, int pad1, int N,
               int H, int W, int cout, int nk, int stages, int smem,
               cudaStream_t s) {
    constexpr int ROWS = WARPS * MW;
    const int tiles_x = (W + COLS - 1) / COLS, tiles_y = (H + ROWS - 1) / ROWS;
    const int n_co = cout / (NT * 8);
    cudaError_t err = cudaFuncSetAttribute(
        conv3x3_int8_mma<NT, WARPS, HEAD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    conv3x3_int8_mma<NT, WARPS, HEAD><<<dim3(tiles_x * tiles_y * n_co, N), 32 * WARPS, smem, s>>>(
        x0, cin0, x1, cin1, w, ep, pad0, pad1, H, W, cout, nk, stages, tiles_x, n_co);
    return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// a clip bound the epilogue's rounding takes: an integer in [0, 127]
bool integral_clip(float c) { return c >= 0.0f && c <= 127.0f && c == floorf(c); }

// --------------------------------------------------------------- stem body
// A block is STEM_WARPS warps on a tile of STEM_WARPS whole image rows, one
// a warp. A halo row is the image row with STEM_PAD bytes of pad value on
// either side (column c at byte STEM_PAD + c); a buffer holds the tile's
// STEM_WARPS + 2 halo rows, and there are two buffers.
constexpr int STEM_WARPS = 8;
constexpr int STEM_PAD = 16;
constexpr int STEM_K = 16;  // bytes of a weight row: tap (ky, kx) at 4ky + kx

int stem_smem_bytes(int W) { return 2 * (STEM_WARPS + 2) * (W + 2 * STEM_PAD); }

// NT n8 tiles: cout = 8 * NT output channels, cout / 4 of them a lane.
template <int NT>
__global__ void __launch_bounds__(32 * STEM_WARPS, NT == 8 ? 2 : 4) conv3x3_int8_stem(
    const int8_t* __restrict__ x, const uint32_t* __restrict__ w,
    const float* __restrict__ scale, const float* __restrict__ bias,
    int8_t* __restrict__ y, int H, int W, int relu, int pad, float out_clip,
    int tiles_y, int n_tiles) {
    constexpr int COUT = 8 * NT, CPL = COUT / 4, THREADS_B = 32 * STEM_WARPS;
    extern __shared__ __align__(16) uint8_t stem_smem[];
    const uint32_t base = smem_addr(stem_smem);
    const int pitch = W + 2 * STEM_PAD, units = pitch / 16;
    const int buf = (STEM_WARPS + 2) * pitch;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;

    // b0 of n8 tile j: taps (t, 0..2) of GEMM column g (zero for t = 3)
    uint32_t b[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) b[j] = w[(8 * j + g) * (STEM_K / 4) + t];
    // this lane's channels CPL * t .. CPL * t + CPL - 1
    float sc[CPL], bi[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
        sc[i] = scale[CPL * t + i];
        bi[i] = bias[CPL * t + i];
    }
    const float lo = relu ? 0.0f : -out_clip;  // relu, then the clip
    const uint32_t f = splat(pad);

    // tile u's halo (image rows y0 - 1 .. y0 + STEM_WARPS) into buffer s
    auto issue = [&](int u, int s) {
        if (u < n_tiles) {
            const int n = u / tiles_y, y0 = (u - n * tiles_y) * STEM_WARPS;
            for (int e = tid; e < (STEM_WARPS + 2) * units; e += THREADS_B) {
                const int hr = e / units, c = e - hr * units;
                const int iy = y0 - 1 + hr;
                const uint32_t dst = s * buf + hr * pitch + 16 * c;
                if (iy >= 0 && iy < H && c >= 1 && c < units - 1)
                    cp_async16(base + dst, x + ((size_t)n * H + iy) * W + 16 * (c - 1),
                               true);
                else
                    *reinterpret_cast<uint4*>(stem_smem + dst) = make_uint4(f, f, f, f);
            }
        }
        cp_async_commit();
    };

    // this lane's A words: halo row warp + ky (ky = t; lanes t = 3 read
    // row 2, their K bytes meet zero weights), from the word that holds
    // column x - 1 of its pixel x = x0 + g, shifted by that column's byte
    const int word = (STEM_PAD - 1 + g) >> 2;
    const uint32_t shift = 8 * ((STEM_PAD - 1 + g) & 3);
    const int row_off = (warp + min(t, 2)) * pitch;

    issue(blockIdx.x, 0);
    int s = 0;
    for (int u = blockIdx.x; u < n_tiles; u += gridDim.x, s ^= 1) {
        cp_async_wait<0>();
        __syncthreads();  // tile u's halo landed; the other buffer is free
        issue(u + gridDim.x, s ^ 1);
        const int n = u / tiles_y, oy = (u - n * tiles_y) * STEM_WARPS + warp;
        if (oy >= H) continue;
        const uint32_t* a_row =
            reinterpret_cast<const uint32_t*>(stem_smem + s * buf + row_off) + word;
        int8_t* out = y + (((size_t)n * H + oy) * W + g) * COUT + CPL * t;
        // two 16-pixel tiles an iteration: 5% faster than one (k1_stem_probe.py)
#pragma unroll 2
        for (int x0 = 0; x0 < W; x0 += 16) {
            const uint32_t* p = a_row + x0 / 4;
            const uint32_t a[4] = {__funnelshift_r(p[0], p[1], shift),
                                   __funnelshift_r(p[2], p[3], shift), 0u, 0u};
            int acc[NT][4];
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
                mma_s8(acc[j], a, b[j], 0u);
            }
            // pixel x0 + g (h = 0) and x0 + g + 8 (h = 1): byte 2j + e is
            // column 2t + e of n8 tile j, channel CPL * t + 2j + e
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                uint32_t r[CPL];
#pragma unroll
                for (int j = 0; j < NT; ++j)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int i = 2 * j + e;
                        r[i] = rounded_bits(
                            __fmaf_rn(__int2float_rn(acc[j][2 * h + e]), sc[i], bi[i]),
                            lo, out_clip);
                    }
                int8_t* o = out + (size_t)(x0 + 8 * h) * COUT;
                if constexpr (CPL == 4) {
                    *reinterpret_cast<uint32_t*>(o) = pack4(r);
                } else if constexpr (CPL == 8) {
                    *reinterpret_cast<uint2*>(o) = make_uint2(pack4(r), pack4(r + 4));
                } else {
                    *reinterpret_cast<uint4*>(o) = make_uint4(
                        pack4(r), pack4(r + 4), pack4(r + 8), pack4(r + 12));
                }
            }
        }
    }
    cp_async_wait<0>();
}

template <int NT>
int launch_stem(const int8_t* x, const uint32_t* w, const float* scale,
                const float* bias, int8_t* y, int N, int H, int W, int relu,
                int pad, float out_clip, int grid, int smem, cudaStream_t s) {
    const int tiles_y = (H + STEM_WARPS - 1) / STEM_WARPS;
    cudaError_t err = cudaFuncSetAttribute(
        conv3x3_int8_stem<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    conv3x3_int8_stem<NT><<<grid, 32 * STEM_WARPS, smem, s>>>(
        x, w, scale, bias, y, H, W, relu, pad, out_clip, tiles_y, N * tiles_y);
    return static_cast<int>(cudaGetLastError());
}


}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a head it cannot take. x1 may be null with
// cin1 = 0; yp may be null (no pool). cinp must be 4 (cin <= 4) or a
// multiple of 32; coutp a multiple of 32. With labels (the head): y and yp
// null, cinp a multiple of 32, cout <= 32 and a multiple of 4, nc <= 32.
extern "C" int octseg_conv3x3_int8(
    const void* x0, int cin0, const void* x1, int cin1, const void* w,
    const void* scale, const void* bias, void* y, void* yp, int N, int H,
    int W, int cinp, int cout, int coutp, int relu, int pad0, int pad1,
    float out_clip, float pool_rescale, float pool_shift, float pool_clip,
    const void* head_w, const void* head_scale, const void* head_bias,
    int nc, void* labels, void* stream) {
    const bool words = (cin0 % 4 == 0) && (cin1 % 4 == 0);
    auto s = static_cast<cudaStream_t>(stream);
    auto a0 = static_cast<const int8_t*>(x0);
    auto a1 = static_cast<const int8_t*>(x1);
    auto wq = static_cast<const int32_t*>(w);
    auto sc = static_cast<const float*>(scale);
    auto bi = static_cast<const float*>(bias);
    auto o = static_cast<int8_t*>(y);
    auto op = static_cast<int8_t*>(yp);
    auto hw = static_cast<const int32_t*>(head_w);
    auto hs = static_cast<const float*>(head_scale);
    auto hb = static_cast<const float*>(head_bias);
    auto lab = static_cast<int8_t*>(labels);
#define OCTSEG_K1_ARGS a0, cin0, a1, cin1, wq, sc, bi, o, op, N, H, W, cinp, \
    cout, coutp, relu, pad0, pad1, out_clip, pool_rescale, pool_shift,      \
    pool_clip, hw, hs, hb, nc, lab, s
    if (lab != nullptr) {
        if (cinp == 4 || cout > COUT_T || cout % 4 != 0 || nc < 1 || nc > MAX_NC)
            return static_cast<int>(cudaErrorInvalidValue);
        if (words) launch<8, true, true>(OCTSEG_K1_ARGS);
        else launch<8, false, true>(OCTSEG_K1_ARGS);
    } else if (cinp == 4) {
        if (words) launch<1, true, false>(OCTSEG_K1_ARGS);
        else launch<1, false, false>(OCTSEG_K1_ARGS);
    } else {
        if (words) launch<8, true, false>(OCTSEG_K1_ARGS);
        else launch<8, false, false>(OCTSEG_K1_ARGS);
    }
#undef OCTSEG_K1_ARGS
    return static_cast<int>(cudaGetLastError());
}

// K1's mma.sync body. x0 (N, H, W, cin0) and x1 (N, H, W, cin1) int8, cin0
// and cin1 multiples of 32 (x1 null with cin1 = 0); w: (nk, 9, cout, 32)
// int8 (ops/conv_int8.py:pack_conv3x3_mma_weights), nk = (cin0 + cin1) /
// 32; cout a multiple of co_t; x0, x1 and w 16-byte aligned; out_clip and
// pool_clip integers in [0, 127]. y (N, H, W,
// cout) and yp (N, H/2, W/2, cout; null: no pool; H, W even) int8,
// 16-byte aligned. With labels (the head): y and yp null, cout = co_t =
// 32, 1 <= nc <= 32. The plan (ops/conv_int8.py:conv3x3_plan) gives co_t
// (32 or 64 output channels a block), warps (8: 32 x 16 tiles; 4: 16 x 16
// tiles, at co_t 32 only), stages (2 or 3 ring slots) and smem (dynamic
// shared memory bytes). Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments the plan would not give.
extern "C" int octseg_conv3x3_int8_mma(
    const void* x0, int cin0, const void* x1, int cin1, const void* w,
    const void* scale, const void* bias, void* y, void* yp, int N, int H,
    int W, int cout, int relu, int pad0, int pad1, float out_clip,
    float pool_rescale, float pool_shift, float pool_clip,
    const void* head_w, const void* head_scale, const void* head_bias,
    int nc, void* labels, int co_t, int warps, int nk, int stages, int smem,
    void* stream) {
    const bool head = labels != nullptr;
    const int rows = warps * MW;
    const long long blocks = (long long)((H + rows - 1) / rows) *
                             ((W + COLS - 1) / COLS) *
                             (co_t > 0 ? cout / co_t : 0);
    const bool bad =
        N < 1 || N > 65535 || H < 1 || W < 1 || cin0 < KCH || cin0 % KCH != 0 ||
        cin1 < 0 || cin1 % KCH != 0 || (cin1 > 0 && x1 == nullptr) ||
        nk != (cin0 + cin1) / KCH || (co_t != 32 && co_t != 64) ||
        (warps != 8 && !(warps == 4 && co_t == 32)) ||
        cout < co_t || cout % co_t != 0 || (stages != 2 && stages != 3) ||
        pad0 < -128 || pad0 > 127 || pad1 < -128 || pad1 > 127 ||
        !integral_clip(out_clip) || !integral_clip(pool_clip) ||
        blocks > 0x7fffffffLL || !aligned16(x0) ||
        (cin1 > 0 && !aligned16(x1)) || !aligned16(w) ||
        smem != mma_smem_bytes(co_t, stages, warps) ||
        (head ? (y != nullptr || yp != nullptr || co_t != 32 || cout != 32 ||
                 nc < 1 || nc > MAX_NC || head_w == nullptr ||
                 head_scale == nullptr || head_bias == nullptr)
              : (y == nullptr || !aligned16(y) ||
                 (yp != nullptr && (!aligned16(yp) || H % 2 != 0 || W % 2 != 0))));
    if (bad) return static_cast<int>(cudaErrorInvalidValue);
    const Epilogue ep{static_cast<const float*>(scale), static_cast<const float*>(bias),
                      relu, out_clip, pool_rescale, pool_shift, pool_clip,
                      static_cast<int8_t*>(y), static_cast<int8_t*>(yp),
                      static_cast<const int32_t*>(head_w),
                      static_cast<const float*>(head_scale),
                      static_cast<const float*>(head_bias), nc,
                      static_cast<int8_t*>(labels)};
    auto s = static_cast<cudaStream_t>(stream);
    auto a0 = static_cast<const int8_t*>(x0);
    auto a1 = static_cast<const int8_t*>(x1);
    auto wp = static_cast<const int8_t*>(w);
#define K1_LAUNCH(NT, WARPS, HEAD)                                          \
    return launch_mma<NT, WARPS, HEAD>(a0, cin0, a1, cin1, wp, ep, pad0, pad1, \
                                       N, H, W, cout, nk, stages, smem, s)
    if (head) {
        if (warps == 4) K1_LAUNCH(4, 4, true);
        K1_LAUNCH(4, 8, true);
    }
    if (co_t == 64) K1_LAUNCH(8, 8, false);
    if (warps == 4) K1_LAUNCH(4, 4, false);
    K1_LAUNCH(4, 8, false);
#undef K1_LAUNCH
}

// K1's stem body. x (N, H, W, 1) int8, 16-byte aligned, W a multiple of
// 16; w: (cout, 16) int8 (ops/conv_int8.py:pack_stem_mma_weights), 16-byte
// aligned; cout 16, 32 or 64; out_clip an integer in [0, 127]; pad the
// border value; y (N, H, W, cout) int8, 16-byte aligned. The plan
// (ops/conv_int8.py:conv3x3_plan) gives grid (persistent blocks; any
// positive count covers the tiles) and smem (dynamic shared memory
// bytes). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the plan would not give.
extern "C" int octseg_conv3x3_int8_stem(
    const void* x, const void* w, const void* scale, const void* bias,
    void* y, int N, int H, int W, int cout, int relu, int pad,
    float out_clip, int grid, int smem, void* stream) {
    const long long tiles = (long long)N * ((H + STEM_WARPS - 1) / STEM_WARPS);
    const bool bad =
        N < 1 || H < 1 || W < 16 || W % 16 != 0 ||
        (cout != 16 && cout != 32 && cout != 64) || pad < -128 || pad > 127 ||
        !integral_clip(out_clip) || tiles > 0x7fffffffLL || grid < 1 ||
        smem != stem_smem_bytes(W) || x == nullptr || !aligned16(x) ||
        w == nullptr || !aligned16(w) || y == nullptr || !aligned16(y) ||
        scale == nullptr || bias == nullptr;
    if (bad) return static_cast<int>(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    auto xi = static_cast<const int8_t*>(x);
    auto wi = static_cast<const uint32_t*>(w);
    auto sc = static_cast<const float*>(scale);
    auto bi = static_cast<const float*>(bias);
    auto yo = static_cast<int8_t*>(y);
#define K1_STEM(NT) \
    return launch_stem<NT>(xi, wi, sc, bi, yo, N, H, W, relu, pad, out_clip, grid, smem, s)
    if (cout == 16) K1_STEM(2);
    if (cout == 32) K1_STEM(4);
    K1_STEM(8);
#undef K1_STEM
}
