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
// with requant(acc, s, b) = clip(rint(relu(fmaf(float(acc), s, b))), +-127),
// and the pool the max of each 2x2 window of out.
// The zero padding of `mid` matters: a halo position outside the image holds
// 0 (conv1's padding of the int8 stem activation), not the stem evaluated on
// a zero-padded image, which would be relu(rint(bias0)).
//
// Bound on the card: at c1 = cout = 32 the bytes (the image in, the skip
// and the pooled tensor out: 41 a pixel) and the int8 operations (19,008 a
// pixel) are about equal, ~0.10 and ~0.08 ms at batch 32, 512^2. What K10
// saves against K1 + K1 is the stem tensor's write and read (64 bytes a
// pixel at c1 = 32).
//
// Two bodies; ops/stem_conv_int8.py:stem_conv_plan chooses one per call.
// - stem_conv_int8_mma (c1 = cout = 32, W a multiple of 16, an aligned
//   image; the served f=32 stem): K1's stem product (conv3x3_int8_stem)
//   writing straight into K1's int8 mma.sync implicit GEMM
//   (conv3x3_int8_mma) in shared memory. A block of 8 warps walks whole
//   image rows: a persistent grid over bands of `band` output rows of one
//   image, each in steps of 4 rows. A step's stem products (the 9 taps
//   folded into K of one m16n8k32 s8 a 16-pixel n8 tile, K1's requant)
//   write the stem rows into a ring of 6 rows of (W + 2) pixels x 32
//   bytes in K1's A layout (each pixel's two 16-byte units XOR-swizzled
//   by bit 2 of the pixel): the weight pack's channel order gives each
//   lane 8 consecutive channels of a pixel, half a unit, one 8-byte shared
//   store, and a half-warp's 16 stores fill 128 contiguous bytes (no bank
//   conflict). Stem rows outside the image are written as zeros (conv1's
//   padding); the ring's columns 0 and W + 1 are zeroed once. Each step
//   computes 4 new stem rows (6 at a band's start) and conv1 then reads
//   6: the stem is computed (band + 2) / band times over, where K1 + K1
//   computes it once (1.03 at batch 32, 512^2). conv1 is K1's mma_chunk
//   (ldmatrix, 9 taps x 4 n8 tiles) on a warp's 4 x 16 tile, the warps
//   side by side along the row; conv1's weights (resident, 9 KB) are
//   stored with the output channels permuted like the stem's, so the C
//   fragment gives a lane 8 consecutive channels of a pixel: K1's requant
//   (FMA, relu, rounded_bits) in registers, then 8-byte stores, a warp's
//   store 8 pixels x 32 channels, 256 contiguous bytes, with no shared
//   tile. The pool is the byte max of the rounded values (relu makes them
//   0..127, and rounding and the clip are monotone, so this is the rounded
//   max of the float values, as K1's pool): rows m, m+1 of a thread, then
//   lanes l and l^4 by one shuffle. The next step's image rows arrive by
//   cp.async while conv1 runs; two blocks share an SM, so one's stem runs
//   beside the other's conv1. Time at batch 32 (k10_probe.py): conv1's
//   products about a third, the stem's requant and conv1's requant about
//   a sixth each; the stores and the copies hide.
// - stem_conv_int8_kernel (every other c1 <= 32): the first design, on
//   __dp4a. A block owns a 16x16 output tile and 32 output channels; it
//   loads the 20x20 image window, computes the stem for the 18x18 window
//   conv1 reads into shared memory (int8, four channels a word), then runs
//   conv1 as K1's dp4a body does (each thread a 2x2 output quad x 8
//   channels; the pool from the four results it holds).
//
// Weights: the mma.sync body reads ops/conv_int8.py:pack_stem_mma_weights
// (int8 (32, 16): row n holds channel 8(n%8 / 2) + 2(n/8) + n%2, byte
// 4*ky + kx its tap) and pack_conv3x3_mma_weights (int8 (1, 9, 32, 32),
// byte [0, t, co, b] = w1[t/3, t%3, b, co]). The dp4a body reads K1's
// packed layout (pack_conv3x3_weights): int32 words (9, cinp/4, coutp),
// word [t, j, co] holding w[t//3, t%3, 4j..4j+3, co]. For the stem, cinp =
// 4 and only byte 0 of each word is the weight (cin = 1).

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_int8.cuh"

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

// ------------------------------------------------------------ mma.sync body
constexpr int M_ROWS = 4;               // output rows a step: a warp's m16 tiles
constexpr int M_COLS = 16;              // output columns of a warp's tile
constexpr int M_WARPS = 8;
constexpr int M_THREADS = 32 * M_WARPS;
constexpr int CH = 32;                  // c1 = cout: one K chunk, four n8 tiles
constexpr int RING = M_ROWS + 2;        // stem rows a step's conv1 reads
constexpr int IMG_ROWS = RING + 2;      // image rows a band's first step reads
constexpr int IMG_PAD = 16;             // zero bytes either side of an image row

__host__ __device__ constexpr int ring_pitch(int W) { return (W + 2) * CH; }
__host__ __device__ constexpr int image_pitch(int W) { return W + 2 * IMG_PAD; }

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// Dynamic shared memory of one block (ops/stem_conv_int8.py:stem_mma_smem):
// the ring, conv1's weights, the image rows, the four epilogue vectors and
// the stem's weights.
int mma_smem_bytes(int W) {
    return RING * ring_pitch(W) + 9 * CH * CH + IMG_ROWS * image_pitch(W) +
           4 * CH * 4 + CH * 16;
}

// conv1's products for a warp's 4 x 16 tile: K1's mma_chunk
// (csrc/conv3x3_int8.cu) with the 6 halo rows at the ring addresses in
// `row` (not one stride apart). For each kx: the B fragments of the taps
// (0..2, kx), then each halo row once, into every tile row it serves.
__device__ __forceinline__ void ring_products(int (&acc)[M_ROWS][4][4],
                                              const uint32_t (&row)[RING],
                                              const uint32_t (&a_col)[3],
                                              uint32_t b_base,
                                              const uint32_t (&b_off)[2]) {
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
        uint32_t b[3][4][2];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
            const uint32_t bt = b_base + (ky * 3 + kx) * CH * CH;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                uint32_t r[4];
                ldmatrix_x4(r, bt + b_off[j]);
                b[ky][2 * j][0] = r[0];
                b[ky][2 * j][1] = r[1];
                b[ky][2 * j + 1][0] = r[2];
                b[ky][2 * j + 1][1] = r[3];
            }
        }
#pragma unroll
        for (int r = 0; r < RING; ++r) {
            uint32_t a[4];
            ldmatrix_x4(a, row[r] + a_col[kx]);
#pragma unroll
            for (int ky = 0; ky < 3; ++ky) {
                const int m = r - ky;
                if (m < 0 || m >= M_ROWS) continue;
#pragma unroll
                for (int t = 0; t < 4; ++t)
                    mma_s8(acc[m][t], a, b[ky][t][0], b[ky][t][1]);
            }
        }
    }
}

// The byte max of a and b, whose bytes are 0..127: (a | 0x80) - b per byte
// has its top bit set where a >= b (no borrow crosses a byte), and prmt's
// sign mode spreads that bit over the byte.
__device__ __forceinline__ uint32_t max_bytes(uint32_t a, uint32_t b) {
    const uint32_t d = (a | 0x80808080u) - b;
    uint32_t ge;
    asm("prmt.b32 %0, %1, 0, 0xBA98;" : "=r"(ge) : "r"(d));
    return (a & ge) | (b & ~ge);
}

// A persistent grid over units u = n * bands + band index (band output
// rows of image n); unit u's steps k cover output rows y0 = Y + 4k ..
// y0 + 3 (Y = its first row). Step k's stem rows: Y - 1 .. Y + 4 (k = 0),
// else y0 + 1 .. y0 + 4; stem row r lives in ring slot (r - Y + 1) % RING,
// so conv1 finds rows y0 - 1 .. y0 + 4 at slots (4k + i) % RING. w0:
// (32, 16) int8; w1: (1, 9, 32, 32) int8.
__global__ void __launch_bounds__(M_THREADS, 2) stem_conv_int8_mma(
    const int8_t* __restrict__ img, const int8_t* __restrict__ w0,
    const float* __restrict__ scale0, const float* __restrict__ bias0,
    const int8_t* __restrict__ w1, const float* __restrict__ scale1,
    const float* __restrict__ bias1, int8_t* __restrict__ y,
    int8_t* __restrict__ yp, int H, int W, int band, int bands, int units) {
    extern __shared__ __align__(128) uint8_t k10_smem[];
    const uint32_t base = smem_addr(k10_smem);
    const int rp = ring_pitch(W), ip = image_pitch(W), gw = W / M_COLS;
    const int w1_off = RING * rp, img_off = w1_off + 9 * CH * CH;
    float* prm = reinterpret_cast<float*>(k10_smem + img_off + IMG_ROWS * ip);
    const uint32_t* w0s = reinterpret_cast<const uint32_t*>(prm + 4 * CH);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

    // once a block: conv1's weights, GEMM column n of each tap holding
    // channel 8 (n%8 / 2) + 2 (n/8) + n%2 (the stem's order), swizzled as
    // K1 stores them; the ring's zero columns; the image rows' zero pads;
    // the epilogues' scales and biases and the stem's weights
    for (int e = tid; e < 9 * CH * 2; e += M_THREADS) {
        const int u = e & 1, r = e >> 1, tap = r / CH, n = r - tap * CH;
        const int co = 8 * ((n & 7) >> 1) + 2 * (n >> 3) + (n & 1);
        cp_async16(base + w1_off + tap * CH * CH + swz(n, u),
                   w1 + (tap * CH + co) * CH + 16 * u, true);
    }
    for (int e = tid; e < RING * 4; e += M_THREADS) {
        const int s = e >> 2, right = (e >> 1) & 1, u = e & 1;
        *reinterpret_cast<uint4*>(k10_smem + s * rp + swz(right ? W + 1 : 0, u)) = zero;
    }
    for (int e = tid; e < IMG_ROWS * 2; e += M_THREADS)
        *reinterpret_cast<uint4*>(k10_smem + img_off + (e >> 1) * ip +
                                  ((e & 1) ? IMG_PAD + W : 0)) = zero;
    for (int i = tid; i < CH; i += M_THREADS) {
        prm[i] = scale0[i];
        prm[CH + i] = bias0[i];
        prm[2 * CH + i] = scale1[i];
        prm[3 * CH + i] = bias1[i];
        reinterpret_cast<uint4*>(prm + 4 * CH)[i] =
            reinterpret_cast<const uint4*>(w0)[i];
    }
    // the stem's A words: image row ky = t (lanes t = 3 read row 2 and
    // meet zero weights), from the word that holds column x - 1 of pixel x
    // = 16c + g, shifted by that column's byte; pixel x + 8 two words on
    const int word = (IMG_PAD - 1 + g) >> 2;
    const uint32_t shift = 8 * ((IMG_PAD - 1 + g) & 3);
    // conv1's ldmatrix offsets (K1's lane_offsets): A rows are 16 pixels of
    // a halo row shifted by kx (matrix l/8: pixels 0-7 | 8-15, units 0 |
    // 1); B rows are GEMM columns 16j + 0-7 (units 0 | 1), then 16j + 8-15
    uint32_t a_col[3], b_off[2];
#pragma unroll
    for (int kx = 0; kx < 3; ++kx)
        a_col[kx] = swz(kx + (lane & 7) + 8 * ((lane >> 3) & 1), lane >> 4);
#pragma unroll
    for (int j = 0; j < 2; ++j)
        b_off[j] = swz(16 * j + (lane & 7) + 8 * (lane >> 4), (lane >> 3) & 1);

    auto steps = [&](int u) {
        const int y0 = (u % bands) * band;
        return (min(band, H - y0) + M_ROWS - 1) / M_ROWS;
    };
    // step k of unit u's image rows (its first stem row - 1 on, two more
    // than its stem rows), zero outside the image, into the image rows
    auto issue = [&](int u, int k) {
        if (u < units) {
            const int n = u / bands, y0 = (u - n * bands) * band + M_ROWS * k;
            const int first = k ? y0 : y0 - 2, rows = (k ? M_ROWS : RING) + 2;
            for (int e = tid; e < rows * gw; e += M_THREADS) {
                const int i = e / gw, c = e - i * gw, iy = first + i;
                const uint32_t dst = img_off + i * ip + IMG_PAD + 16 * c;
                if (iy >= 0 && iy < H)
                    cp_async16(base + dst, img + ((size_t)n * H + iy) * W + 16 * c, true);
                else
                    *reinterpret_cast<uint4*>(k10_smem + dst) = zero;
            }
        }
        cp_async_commit();
    };

    int u = blockIdx.x, k = 0;
    issue(u, 0);
    while (u < units) {
        const int n = u / bands, Y = (u - n * bands) * band, y0 = Y + M_ROWS * k;
        int nu = u, nk = k + 1;
        if (nk == steps(u)) {
            nu += gridDim.x;
            nk = 0;
        }
        cp_async_wait<0>();
        __syncthreads();  // the image rows landed; the last conv1 left the ring

        // the stem: rows r0 .. r0 + rows - 1 into the ring, 16 pixels a
        // product; its weights and epilogue from shared memory each step
        {
            const int r0 = k ? y0 + 1 : y0 - 1, rows = k ? M_ROWS : RING;
            // B fragments: taps (t, 0..2) of GEMM column g of n8 tile j
            // (zero for t = 3)
            uint32_t b0[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) b0[j] = w0s[(8 * j + g) * 4 + t];
            const float4* p4 = reinterpret_cast<const float4*>(prm) + 2 * t;
            const float4 sa = p4[0], sb = p4[1], ba = p4[8], bb = p4[9];
            const float sc[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
            const float bi[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
            for (int i = 0; i < rows; ++i) {
                const int r = r0 + i;
                uint8_t* row = k10_smem + ((r - Y + 1) % RING) * rp + 8 * (t & 1);
                const uint32_t* src = reinterpret_cast<const uint32_t*>(
                    k10_smem + img_off + (i + min(t, 2)) * ip) + word;
                const bool inside = r >= 0 && r < H;  // else conv1's zero padding
                for (int c = warp; c < gw; c += M_WARPS) {
                    uint2 out[2] = {make_uint2(0u, 0u), make_uint2(0u, 0u)};
                    if (inside) {
                        const uint32_t* p = src + 4 * c;
                        const uint32_t a[4] = {__funnelshift_r(p[0], p[1], shift),
                                               __funnelshift_r(p[2], p[3], shift), 0u, 0u};
                        int acc[4][4];
#pragma unroll
                        for (int j = 0; j < 4; ++j) {
                            acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
                            mma_s8(acc[j], a, b0[j], 0u);
                        }
                        // pixel 16c + g + 8h: byte 2j + e is column 2t + e
                        // of n8 tile j, channel 8t + 2j + e
#pragma unroll
                        for (int h = 0; h < 2; ++h) {
                            uint32_t v[8];
#pragma unroll
                            for (int j = 0; j < 4; ++j)
#pragma unroll
                                for (int e = 0; e < 2; ++e) {
                                    const int i8 = 2 * j + e;
                                    v[i8] = rounded_bits(
                                        __fmaf_rn(__int2float_rn(acc[j][2 * h + e]), sc[i8], bi[i8]),
                                        0.0f, 127.0f);
                                }
                            out[h] = make_uint2(pack4(v), pack4(v + 4));
                        }
                    }
#pragma unroll
                    for (int h = 0; h < 2; ++h)
                        *reinterpret_cast<uint2*>(row + swz(16 * c + g + 8 * h + 1, t >> 1)) = out[h];
                }
            }
        }
        __syncthreads();  // the ring holds rows y0 - 1 .. y0 + 4; the image rows are free
        issue(nu, nk);

        // conv1 on the warps' 4 x 16 tiles, then the requant, stores and pool
        uint32_t ring_row[RING];
#pragma unroll
        for (int i = 0; i < RING; ++i) ring_row[i] = base + ((y0 - Y + i) % RING) * rp;
        const float4* p4 = reinterpret_cast<const float4*>(prm + 2 * CH) + 2 * t;
        // this lane's bytes of pixel (y0, g) and of pooled pixel (y0 / 2,
        // 4 (g & 1) + g / 2) (column tile 0); rows of W and W / 2 pixels
        const int rs = W * CH, hh = g & 1;
        int8_t* yo = y + (((size_t)n * H + y0) * W + g) * CH + 8 * t;
        int8_t* po = yp + (((size_t)n * (H / 2) + y0 / 2) * (W / 2) + 4 * hh + (g >> 1)) * CH + 8 * t;
        for (int c = warp; c < gw; c += M_WARPS) {
            int acc[M_ROWS][4][4];
#pragma unroll
            for (int m = 0; m < M_ROWS; ++m)
#pragma unroll
                for (int j = 0; j < 4; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[m][j][e] = 0;
            uint32_t rc[RING];
#pragma unroll
            for (int i = 0; i < RING; ++i) rc[i] = ring_row[i] + c * M_COLS * CH;
            ring_products(acc, rc, a_col, base + w1_off, b_off);
            // pixel (y0 + m, 16c + g + 8h): byte 2j + e is channel 8t + 2j + e
            const float4 sa = p4[0], sb = p4[1], ba = p4[8], bb = p4[9];
            const float sc[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
            const float bi[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
            uint2 o[M_ROWS][2];
#pragma unroll
            for (int m = 0; m < M_ROWS; ++m)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    uint32_t v[8];
#pragma unroll
                    for (int j = 0; j < 4; ++j)
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const int i8 = 2 * j + e;
                            v[i8] = rounded_bits(
                                __fmaf_rn(__int2float_rn(acc[m][j][2 * h + e]), sc[i8], bi[i8]),
                                0.0f, 127.0f);
                        }
                    o[m][h] = make_uint2(pack4(v), pack4(v + 4));
                }
            int8_t* yc = yo + c * M_COLS * CH;
#pragma unroll
            for (int m = 0; m < M_ROWS; ++m) {
                if (y0 + m >= H) break;
                *reinterpret_cast<uint2*>(yc + m * rs) = o[m][0];
                *reinterpret_cast<uint2*>(yc + m * rs + 8 * CH) = o[m][1];
            }
            // window (rows m, m+1; columns of lanes l, l^4); lanes with g
            // even store the windows of h = 0, odd ones those of h = 1
#pragma unroll
            for (int m = 0; m < M_ROWS; m += 2) {
                if (y0 + m >= H) break;  // H even: rows y0 + m + 1 < H too
                uint32_t mx[2][2];
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    mx[h][0] = max_bytes(o[m][h].x, o[m + 1][h].x);
                    mx[h][1] = max_bytes(o[m][h].y, o[m + 1][h].y);
                    mx[h][0] = max_bytes(mx[h][0], __shfl_xor_sync(0xffffffffu, mx[h][0], 4));
                    mx[h][1] = max_bytes(mx[h][1], __shfl_xor_sync(0xffffffffu, mx[h][1], 4));
                }
                *reinterpret_cast<uint2*>(po + c * (M_COLS / 2) * CH + (m / 2) * (rs / 2)) =
                    hh ? make_uint2(mx[1][0], mx[1][1]) : make_uint2(mx[0][0], mx[0][1]);
            }
        }
        u = nu;
        k = nk;
    }
    cp_async_wait<0>();
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

// K10's mma.sync body. img (N, H, W, 1) int8, 16-byte aligned, H even, W a
// multiple of 16; w0: (32, 16) int8 (ops/conv_int8.py:pack_stem_mma_weights),
// 16-byte aligned; w1: (1, 9, 32, 32) int8 (pack_conv3x3_mma_weights),
// 16-byte aligned; c1 = cout = 32; y (N, H, W, 32) and yp (N, H/2, W/2, 32)
// int8, 16-byte aligned. The plan (ops/stem_conv_int8.py:stem_conv_plan)
// gives band (output rows a unit, a multiple of 4), grid (persistent
// blocks; any positive count covers the units) and smem (dynamic shared
// memory bytes). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the plan would not give.
extern "C" int octseg_stem_conv_int8_mma(
    const void* img, const void* w0, const void* scale0, const void* bias0,
    const void* w1, const void* scale1, const void* bias1, void* y, void* yp,
    int N, int H, int W, int band, int grid, int smem, void* stream) {
    const long long bands = band > 0 ? (H + band - 1) / band : 0;
    const bool bad =
        N < 1 || H < 2 || H % 2 != 0 || W < M_COLS || W % M_COLS != 0 ||
        band < M_ROWS || band % M_ROWS != 0 || bands * N > 0x7fffffffLL ||
        grid < 1 || smem != mma_smem_bytes(W) || img == nullptr ||
        !aligned16(img) || w0 == nullptr || !aligned16(w0) ||
        w1 == nullptr || !aligned16(w1) || y == nullptr || !aligned16(y) ||
        yp == nullptr || !aligned16(yp) || scale0 == nullptr || bias0 == nullptr ||
        scale1 == nullptr || bias1 == nullptr;
    if (bad) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(
        stem_conv_int8_mma, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    stem_conv_int8_mma<<<grid, M_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(img), static_cast<const int8_t*>(w0),
        static_cast<const float*>(scale0), static_cast<const float*>(bias0),
        static_cast<const int8_t*>(w1), static_cast<const float*>(scale1),
        static_cast<const float*>(bias1), static_cast<int8_t*>(y),
        static_cast<int8_t*>(yp), H, W, band, static_cast<int>(bands),
        static_cast<int>(bands * N));
    return static_cast<int>(cudaGetLastError());
}
