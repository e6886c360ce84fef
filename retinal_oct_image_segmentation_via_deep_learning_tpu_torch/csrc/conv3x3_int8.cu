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
// With a pool output, each thread owns a 2x2 output quad and keeps the
// float32 max m of its four v (after relu, before rounding); the pooled
// value is clip(rint(fmaf(m, pool_rescale, pool_shift)), +-pool_clip).
// With pool_rescale = 1, pool_shift = 0 and pool_clip = out_clip that is
// the max of the four int8 results (round and clip are monotone); the w4a4
// mode sets (14/127, -7, 7), so the pooled tensor gets a 4-bit scale of
// its own while the unpooled output keeps 8 bits.
// With the head (HEAD), the block writes its requantized 16x16 x cout
// tile to shared memory instead of device memory, and one thread per pixel
// then computes z[k] = fmaf(float(sum_c t[c] * wh[k,c]), hscale[k],
// hbias[k]) and the argmax with ties to the lowest class (K3's arithmetic,
// csrc/head_argmax.cu). Only the labels leave the chip. A tile's channel
// groups are four different warps, hence the trip through shared memory.
//
// The TPU kernels' dot_int4 knob runs the MXU at its int4 rate. Hopper's
// wgmma takes s8/u8 operands and no s4, and the card's data sheet lists no
// int4 rate; the w4a4 operands are +-7 values stored in int8, whose int32
// dot __dp4a computes exactly, so the 4-bit modes run this same dp4a loop.
//
// Bound on the card: the __dp4a issue rate (four int8 MACs per instruction
// on the CUDA cores, well below the tensor cores' int8 rate). The design
// keeps the dp4a pipe fed from shared memory: a block stages a 18x18-pixel
// input tile and the matching weight slice per 32-channel chunk, each
// thread reuses every input word of its 4x4 window across 8 output
// channels and 9 taps (288 dp4a per 16 input and 18 vector weight loads).
// wgmma / IMMA tensor-core tiles are the next step.
//
// Weights are pre-arranged (ops/conv_int8.py:pack_conv3x3_weights) as int32
// words (9, cinp/4, coutp): word [t, j, co] holds w[t//3, t%3, 4j..4j+3, co],
// cinp = cin padded to the chunk width, coutp = cout padded to 32; padding
// is zero. Head weights (ops/head_argmax.py:pack_head_weights) are int32
// words (nc, cout/4).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
