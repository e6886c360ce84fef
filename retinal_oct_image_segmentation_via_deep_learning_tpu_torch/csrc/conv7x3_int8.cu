// K7: int8 KHx3 stride-1 "same" convolution (KH odd: 3, 5 or 7; ReLayNet
// uses 7) with a fused requant + PReLU epilogue and an optional fused 2x2/2
// index max-pool, for NHWC int8 activations.
//
// Replaces two TPU kernels that compute this one function in TPU lane
// packings:
//   ops/pallas_conv_psrp7.py:conv7x3_psrp  (ReLayNet's blocks b1..b6, the
//                                            decoders' skip concat folded in)
//   ops/pallas_conv_psrp7.py:stem7_psrp    (the Cin=1 stem b0)
//
// Function: acc[n,y,x,co] = sum_{ky,kx,c} in[n,y+ky-KH/2,x+kx-1,c] *
// w[ky,kx,c,co] in int32, where `in` is the channel concat of one or two
// inputs (never materialised: the tile loader reads both pointers) and
// out-of-image pixels are zero. Epilogue, in this order:
//   v = fmaf(float(acc), scale[co], bias[co]);
//   v = v >= 0 ? v : alpha * v   (PReLU, one shared fp32 slope);
//   rint (half-even); clip to [-127, 127]; int8.
// With a pool output each thread owns a 2x2 output quad, so it holds the
// four requantized values of a window: the pooled value is their maximum
// and the index (int8, 0..3, flat dy*2+dx) the first maximum in the order
// (0,0), (0,1), (1,0), (1,1), decided with strict > as the TPU kernel does.
//
// Bound on the card: the __dp4a issue rate (four int8 MACs per instruction
// on the CUDA cores, well below the tensor cores' int8 rate). A block
// stages a (16 + KH - 1) x 18 input halo and the KH*3-tap weight slice of
// 32 output channels per 32-channel chunk in shared memory; each thread
// keeps the (KH + 1) x 4 input words of its quad's window in registers and
// reuses each across 8 output channels and up to 3*KH taps (672 dp4a per
// 32 input and 42 vector weight loads at KH = 7). wgmma / IMMA tensor-core
// tiles are the next step.
//
// Weights are pre-arranged (ops/conv7x3_int8.py:pack_conv7x3_weights) as
// int32 words (KH*3, cinp/4, coutp): word [t, j, co] holds
// w[t/3, t%3, 4j..4j+3, co], cinp = cin padded to the chunk width (4 for
// cin <= 4, else a multiple of 32), coutp = cout padded to 32; zero padding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;           // output tile edge, pixels
constexpr int HALO_W = TILE + 2;   // input tile width
constexpr int COUT_T = 32;         // output channels per block
constexpr int CPT = 8;             // output channels per thread
constexpr int THREADS = 256;       // 64 quads x 4 channel groups

__device__ __forceinline__ int8_t requant_prelu(int acc, float s, float b,
                                                float alpha) {
    float v = __fmaf_rn(__int2float_rn(acc), s, b);
    v = v >= 0.0f ? v : __fmul_rn(alpha, v);
    v = rintf(v);
    v = fminf(fmaxf(v, -127.0f), 127.0f);
    return static_cast<int8_t>(__float2int_rn(v));
}

// KW: int32 words (4 channels each) per channel chunk. WORDS: both inputs
// have a channel count divisible by 4, so a word never straddles inputs and
// is one aligned 32-bit load; otherwise bytes are gathered one by one.
template <int KH, int KW, bool WORDS>
__global__ void __launch_bounds__(THREADS) conv_kh3_int8_kernel(
    const int8_t* __restrict__ x0, int cin0,
    const int8_t* __restrict__ x1, int cin1,
    const int32_t* __restrict__ w, const float* __restrict__ scale,
    const float* __restrict__ bias, float alpha, int8_t* __restrict__ y,
    int8_t* __restrict__ yp, int8_t* __restrict__ yi, int H, int W,
    int cinp, int cout, int coutp, int tiles_x) {
    constexpr int HALO_H = TILE + KH - 1;
    constexpr int TAPS = KH * 3;
    __shared__ int32_t xs[HALO_H * HALO_W][KW + 1];
    __shared__ __align__(16) int32_t ws[TAPS][KW][COUT_T];

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

    int acc[4][CPT];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[p][c] = 0;

    for (int ch = 0; ch < cinw / KW; ++ch) {
        for (int i = tid; i < HALO_H * HALO_W * KW; i += THREADS) {
            const int p = i / KW, j = i - p * KW;
            const int iy = ty0 - KH / 2 + p / HALO_W;
            const int ix = tx0 - 1 + p % HALO_W;
            const int c = (ch * KW + j) * 4;
            int32_t v = 0;
            if (iy >= 0 && iy < H && ix >= 0 && ix < W && c < cin) {
                const size_t pix = ((size_t)n * H + iy) * W + ix;
                if (WORDS) {
                    v = c < cin0
                        ? *reinterpret_cast<const int32_t*>(x0 + pix * cin0 + c)
                        : *reinterpret_cast<const int32_t*>(x1 + pix * cin1 + (c - cin0));
                } else {
                    uint32_t u = 0;
#pragma unroll
                    for (int b = 0; b < 4; ++b) {
                        const int cc = c + b;
                        int8_t s = 0;
                        if (cc < cin0) s = x0[pix * cin0 + cc];
                        else if (cc < cin) s = x1[pix * cin1 + (cc - cin0)];
                        u |= (uint32_t)(uint8_t)s << (8 * b);
                    }
                    v = (int32_t)u;
                }
            }
            xs[p][j] = v;
        }
        for (int i = tid; i < TAPS * KW * COUT_T; i += THREADS) {
            const int t = i / (KW * COUT_T);
            const int r = i - t * KW * COUT_T;
            const int j = r / COUT_T, c = r - j * COUT_T;
            ws[t][j][c] = w[((size_t)t * cinw + ch * KW + j) * coutp + co0 + c];
        }
        __syncthreads();

#pragma unroll 1
        for (int j = 0; j < KW; ++j) {
            int32_t xv[KH + 1][4];
#pragma unroll
            for (int a = 0; a < KH + 1; ++a)
#pragma unroll
                for (int b = 0; b < 4; ++b)
                    xv[a][b] = xs[(2 * qy + a) * HALO_W + 2 * qx + b][j];
#pragma unroll
            for (int t = 0; t < TAPS; ++t) {
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

    const int oy = ty0 + 2 * qy, ox = tx0 + 2 * qx;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
        const int co = co0 + g * CPT + c;
        if (co >= cout) break;
        const float s = scale[co], b = bias[co];
        int8_t v[4];
#pragma unroll
        for (int dy = 0; dy < 2; ++dy)
#pragma unroll
            for (int dx = 0; dx < 2; ++dx) {
                const int yy = oy + dy, xx = ox + dx;
                v[dy * 2 + dx] = requant_prelu(acc[dy * 2 + dx][c], s, b, alpha);
                if (yy < H && xx < W)
                    y[(((size_t)n * H + yy) * W + xx) * cout + co] = v[dy * 2 + dx];
            }
        // with a pool output H and W are even, so a quad that starts inside
        // the image lies inside it
        if (yp != nullptr && oy < H && ox < W) {
            int8_t best = v[0], idx = 0;
#pragma unroll
            for (int k = 1; k < 4; ++k)
                if (v[k] > best) {
                    best = v[k];
                    idx = static_cast<int8_t>(k);
                }
            const size_t o = (((size_t)n * (H / 2) + oy / 2) * (W / 2) + ox / 2) * cout + co;
            yp[o] = best;
            yi[o] = idx;
        }
    }
}

template <int KH, int KW, bool WORDS>
void launch(const int8_t* x0, int cin0, const int8_t* x1, int cin1,
            const int32_t* w, const float* scale, const float* bias,
            float alpha, int8_t* y, int8_t* yp, int8_t* yi, int N, int H,
            int W, int cinp, int cout, int coutp, cudaStream_t stream) {
    const int tiles_x = (W + TILE - 1) / TILE;
    const int tiles_y = (H + TILE - 1) / TILE;
    dim3 grid(tiles_x * tiles_y, coutp / COUT_T, N);
    conv_kh3_int8_kernel<KH, KW, WORDS><<<grid, THREADS, 0, stream>>>(
        x0, cin0, x1, cin1, w, scale, bias, alpha, y, yp, yi, H, W, cinp,
        cout, coutp, tiles_x);
}

template <int KH>
void launch_kh(bool words, const int8_t* x0, int cin0, const int8_t* x1,
               int cin1, const int32_t* w, const float* scale,
               const float* bias, float alpha, int8_t* y, int8_t* yp,
               int8_t* yi, int N, int H, int W, int cinp, int cout, int coutp,
               cudaStream_t s) {
    if (cinp == 4) {
        if (words) launch<KH, 1, true>(x0, cin0, x1, cin1, w, scale, bias, alpha, y, yp, yi, N, H, W, cinp, cout, coutp, s);
        else launch<KH, 1, false>(x0, cin0, x1, cin1, w, scale, bias, alpha, y, yp, yi, N, H, W, cinp, cout, coutp, s);
    } else {
        if (words) launch<KH, 8, true>(x0, cin0, x1, cin1, w, scale, bias, alpha, y, yp, yi, N, H, W, cinp, cout, coutp, s);
        else launch<KH, 8, false>(x0, cin0, x1, cin1, w, scale, bias, alpha, y, yp, yi, N, H, W, cinp, cout, coutp, s);
    }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a kh other than 3, 5, 7. x1 may be null with
// cin1 = 0; yp and yi are both null (no pool) or both set (pool; H, W
// even). cinp must be 4 (cin <= 4) or a multiple of 32; coutp a multiple
// of 32.
extern "C" int octseg_conv7x3_int8(
    const void* x0, int cin0, const void* x1, int cin1, const void* w,
    const void* scale, const void* bias, float alpha, void* y, void* yp,
    void* yi, int N, int H, int W, int cinp, int cout, int coutp, int kh,
    void* stream) {
    const bool words = (cin0 % 4 == 0) && (cin1 % 4 == 0);
    auto s = static_cast<cudaStream_t>(stream);
    auto a0 = static_cast<const int8_t*>(x0);
    auto a1 = static_cast<const int8_t*>(x1);
    auto wq = static_cast<const int32_t*>(w);
    auto sc = static_cast<const float*>(scale);
    auto bi = static_cast<const float*>(bias);
    auto o = static_cast<int8_t*>(y);
    auto op = static_cast<int8_t*>(yp);
    auto oi = static_cast<int8_t*>(yi);
    switch (kh) {
        case 7: launch_kh<7>(words, a0, cin0, a1, cin1, wq, sc, bi, alpha, o, op, oi, N, H, W, cinp, cout, coutp, s); break;
        case 5: launch_kh<5>(words, a0, cin0, a1, cin1, wq, sc, bi, alpha, o, op, oi, N, H, W, cinp, cout, coutp, s); break;
        case 3: launch_kh<3>(words, a0, cin0, a1, cin1, wq, sc, bi, alpha, o, op, oi, N, H, W, cinp, cout, coutp, s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
