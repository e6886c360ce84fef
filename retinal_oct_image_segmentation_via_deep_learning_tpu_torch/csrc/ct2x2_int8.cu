// K2: int8 2x2 stride-2 transposed convolution with a fused requant
// epilogue (no relu), NHWC int8 in and out.
//
// Replaces three TPU kernels that compute this one function in different
// lane packings:
//   ops/pallas_conv_int8.py:ct2x2_int8   (ct0, ct1: deep, NHWC)
//   ops/pallas_conv_psrp.py:ct_up_psrp   (ct2: NHWC -> 256^2 stage)
//   ops/pallas_conv_psrp.py:ct_psrp      (ct3: 256^2 -> 512^2 stage)
//
// Function: the kernel never overlaps, so every output pixel is one dot:
//   out[n, 2i+dy, 2j+dx, co] = requant(sum_c x[n,i,j,c] * w[dy,dx,c,co])
// with requant v = fmaf(float(acc), scale[co], bias[i]), rint (half-even),
// clip to [-out_clip, out_clip], int8. That is a GEMM of (N*H*W, cin)
// pixels by (cin, 4*cout) columns, column = (dy*2 + dx)*cout + co, whose
// epilogue scatters each column to its output phase. The bias is per output
// channel (i = co) or, in the w4a4 mode, per column (i = column: the fold of
// the input's zero point 7 differs per tap), and out_clip is 127, or 7 for a
// 4-bit consumer. The TPU kernel's dot_int4 (the MXU's int4 rate) has no
// counterpart: the card has no int4 tensor-core path, and __dp4a computes
// the dot of the +-7 operands exactly.
//
// Bound on the card: __dp4a issue rate (the GEMM is K = cin = 64..512 deep).
// A block stages a 128-pixel x 32-channel A tile and a 32-channel x 64-column
// weight tile in shared memory; each thread owns 4 pixels x 8 columns, so
// every A word feeds 8 dp4a and every (broadcast) weight word 4.
//
// Weights are pre-arranged (ops/conv_int8.py:pack_ct2x2_weights) as int32
// words (cinp/4, colp): word [j, col] holds w[dy, dx, 4j..4j+3, co]; cinp =
// cin padded to 32 and colp = 4*cout padded to 64, zero padding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 128;        // pixels per block
constexpr int TN = 64;         // columns per block
constexpr int KW = 8;          // int32 words (32 channels) per chunk
constexpr int RPT = 4;         // pixels per thread (rows r, r+32, r+64, r+96)
constexpr int CPT = 8;         // columns per thread
constexpr int THREADS = 256;   // 32 row lanes x 8 column groups

__global__ void __launch_bounds__(THREADS) ct2x2_int8_kernel(
    const int8_t* __restrict__ x, const int32_t* __restrict__ w,
    const float* __restrict__ scale, const float* __restrict__ bias,
    int bias_per_col, float out_clip, int8_t* __restrict__ y, long long M,
    int H, int W, int cin, int cinp, int cout, int colp) {
    __shared__ int32_t as[TM][KW + 1];
    __shared__ __align__(16) int32_t bs[KW][TN];

    const long long m0 = (long long)blockIdx.x * TM;
    const int n0 = blockIdx.y * TN;
    const int tid = threadIdx.x;
    const int r = tid & 31;    // row lane
    const int cg = tid >> 5;   // column group; uniform across a warp
    const int cinw = cin / 4;

    int acc[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = 0;

    for (int ch = 0; ch < cinp / (4 * KW); ++ch) {
        for (int i = tid; i < TM * KW; i += THREADS) {
            const int row = i / KW, j = i - row * KW;
            const long long m = m0 + row;
            const int cw = ch * KW + j;
            int32_t v = 0;
            if (m < M && cw < cinw)
                v = reinterpret_cast<const int32_t*>(x + m * cin)[cw];
            as[row][j] = v;
        }
        for (int i = tid; i < KW * TN; i += THREADS) {
            const int j = i / TN, c = i - j * TN;
            bs[j][c] = w[(size_t)(ch * KW + j) * colp + n0 + c];
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < KW; ++j) {
            const int4 wa = *reinterpret_cast<const int4*>(&bs[j][cg * CPT]);
            const int4 wb = *reinterpret_cast<const int4*>(&bs[j][cg * CPT + 4]);
            const int wv[CPT] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
                const int32_t a = as[r + 32 * i][j];
#pragma unroll
                for (int c = 0; c < CPT; ++c) acc[i][c] = __dp4a(a, wv[c], acc[i][c]);
            }
        }
        __syncthreads();
    }

    const int ncol = 4 * cout;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const long long m = m0 + r + 32 * i;
        if (m >= M) continue;
        const int jx = (int)(m % W);
        const long long t = m / W;
        const int iy = (int)(t % H);
        const long long n = t / H;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
            const int col = n0 + cg * CPT + c;
            if (col >= ncol) break;
            const int ph = col / cout, co = col - ph * cout;
            const int dy = ph >> 1, dx = ph & 1;
            const float b = bias[bias_per_col ? col : co];
            float v = __fmaf_rn(__int2float_rn(acc[i][c]), scale[co], b);
            v = fminf(fmaxf(rintf(v), -out_clip), out_clip);
            y[((n * 2 * H + 2 * iy + dy) * 2 * W + 2 * jx + dx) * cout + co] =
                static_cast<int8_t>(__float2int_rn(v));
        }
    }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). cin must be a
// multiple of 4; cinp a multiple of 32; colp a multiple of 64. bias holds
// cout values, or 4*cout with bias_per_col.
extern "C" int octseg_ct2x2_int8(const void* x, const void* w,
                                 const void* scale, const void* bias,
                                 int bias_per_col, float out_clip, void* y,
                                 int N, int H, int W, int cin, int cinp,
                                 int cout, int colp, void* stream) {
    const long long M = (long long)N * H * W;
    dim3 grid((unsigned)((M + TM - 1) / TM), colp / TN);
    ct2x2_int8_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(x), static_cast<const int32_t*>(w),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        bias_per_col, out_clip, static_cast<int8_t*>(y), M, H, W, cin, cinp,
        cout, colp);
    return static_cast<int>(cudaGetLastError());
}
