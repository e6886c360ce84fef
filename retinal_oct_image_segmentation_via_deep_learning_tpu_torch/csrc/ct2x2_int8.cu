// K2: int8 2x2 stride-2 transposed convolution with a fused requant
// epilogue (no relu), NHWC int8 in and out, on the int8 tensor cores.
//
// Replaces three TPU kernels that compute this one function in different
// lane packings:
//   ops/pallas_conv_int8.py:ct2x2_int8   (ct0, ct1: deep, NHWC; with the
//                                         w4a4 mode's per-(dy, dx) bias
//                                         and out_clip)
//   ops/pallas_conv_psrp.py:ct_up_psrp   (ct2: NHWC -> 256^2 stage)
//   ops/pallas_conv_psrp.py:ct_psrp      (ct3: 256^2 -> 512^2 stage)
//
// Function: the kernel never overlaps, so every output pixel is one dot:
//   out[n, 2i+dy, 2j+dx, co] = requant(sum_c x[n,i,j,c] * w[c,co,dy,dx])
// with requant v = fmaf(float(acc), scale[co], bias), rint (half-even),
// clip to [-out_clip, out_clip], int8; bias is bias[co] or, in the w4a4
// mode, bias[(2dy+dx)*cout + co] (the fold of the input's zero point 7
// differs per tap), and out_clip is 127, or 7 for a 4-bit consumer. That
// is a GEMM of (N*H*W, cin) pixels by (cin, 4*cout) columns, column =
// (2dy + dx)*cout + co, whose epilogue sends each column to its output
// phase. |acc| <= 512 * 128^2 < 2^24, so float(acc) is exact. The TPU
// kernel's dot_int4 (the MXU's int4 rate) has no counterpart: Hopper's
// tensor cores take no s4 operand, and +-7 values stored in int8 give the
// same exact products.
//
// What bounds each call on an H100 (int8 at 1979 TOPS dense, HBM at 3.35
// TB/s): ct0 (32^2 x 512 -> 64^2 x 256) does 675 operations a byte moved,
// above the ~590 at which the tensor cores and not HBM are the limit: it
// is bound by operations. ct1..ct3 (cin 256, 128, 64) do 342, 171 and 85:
// they are bound by bytes, most of them the output (4*cout bytes a pixel
// against cin read).
//
// Design. A GEMM on mma.sync m16n8k32 s8*s8 -> s32. A block of 8 warps
// owns an output-channel tile co0 .. co0+CO_T and all four taps of it (N =
// 4*CO_T block columns, tap-major), so every n8 tile of a warp's
// accumulators belongs to one tap and the block owns whole output pixels.
// M = a tile of TM consecutive input pixels (NHWC: a pixel's cin bytes are
// one contiguous row, so the A tile is TM rows of 32-byte K chunks, K1's
// halo rows without a halo). The warps form WM x WN with WM*WN = 8; a warp
// multiplies 2 m16 tiles by 8 n8 tiles (32 pixels x 64 columns, 64 int32
// accumulators), so TM = 32*WM and CO_T = 16*WN: (TM, CO_T) = (256, 16),
// (128, 32), (64, 64) or (32, 128). Two blocks share an SM
// (__launch_bounds__(256, 2): 114-120 registers, no spills; warps of 32
// columns, three blocks an SM, were no faster).
// - The block's weights (cin x 4*CO_T bytes, K-contiguous per column) and
//   the scale and bias of its 4*CO_T columns are copied into shared memory
//   once and stay.
// - The block walks the tiles u = blockIdx.x, blockIdx.x + gridDim.x, ...
//   (the grid is persistent: two blocks an SM over the channel tiles,
//   ops/conv_int8.py:ct2x2_plan). The tiles' K chunks (TM x 32 bytes) pass
//   through a ring of STAGES slots that runs on across tiles, so while a
//   tile's epilogue runs the next tile's chunks are in flight: ct3 and ct2
//   have only 2 and 4 chunks a tile, too short a loop for a ring inside one
//   tile to hide anything, and one block a tile was slower at every call
//   (k2_probe.py). Pixels beyond M, and channels beyond cin (cin % 32 =
//   16), are zero-filled by the copy's source size; cin % 16 != 0 or a
//   misaligned input takes a byte-gathering loader into the same layout
//   (right, not fast).
// - A and B fragments come from ldmatrix.x4; each 32-byte row's two
//   16-byte units are XOR-swizzled by bit 2 of the row (swz), so the 8
//   rows of every ldmatrix phase fall in 8 bank groups.
// - Epilogue, from the C fragments (rows lane/4 and lane/4 + 8, columns
//   2*(lane%4) and +1 of each n8 tile): fmaf, then the clip and the rounding
//   by an add (rounded_bits); the int8 pairs go into a shared-memory tile
//   laid out as the output, [dy][pixel][dx][co], 2*CO_T + 16 bytes a
//   (dy, pixel) row (the 16-byte pad puts the 8 rows of a 2-byte store in
//   8 bank pairs). The tile leaves as 16-byte stores, neighbouring threads
//   on neighbouring addresses: where CO_T = cout (ct2, ct3) a tile inside
//   one input row is, for each dy, one contiguous run of 2*TM*cout bytes
//   of output row 2i+dy; elsewhere runs of CO_T bytes at a pixel stride of
//   cout. cout % 16 != 0 stores bytes. Every output byte is written once.
//
// Weights (ops/conv_int8.py:pack_ct2x2_weights): int8 (nk, 4*cout, 32),
// byte [j, col, b] = w[32j + b, co, dy, dx] for col = (2dy + dx)*cout + co,
// cin zero-padded to nk*32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_int8.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int MT = 2;         // m16 tiles a warp (32 pixels)
constexpr int NT = 8;         // n8 tiles a warp (64 columns)
constexpr int KCH = 32;       // bytes of K a chunk: the MMA's k
constexpr int STAGES = 4;     // ring slots of A chunks
constexpr int SMEM_MAX = 232448;

struct Epilogue {
    const float* scale;
    const float* bias;
    int bias_per_col;
    float out_clip;
    int8_t* y;
};

// Dynamic shared memory of one block (ops/conv_int8.py:ct2x2_smem): the
// weights, the ring, the output tile, the scale and bias of the block's
// columns.
__host__ __device__ constexpr int smem_bytes(int tm, int co_t, int nk) {
    return nk * 4 * co_t * KCH + STAGES * tm * KCH + 2 * tm * (2 * co_t + 16) +
           4 * co_t * 8;
}

// The products of one K chunk: the warp's 2 m16 A tiles (ldmatrix from the
// ring slot, a_off for the first; the second 16 rows on) against its NT n8
// B tiles, two at a time (ldmatrix from the chunk's weights, b_off for the
// first pair; each next pair 16 rows on).
__device__ __forceinline__ void mma_chunk(int (&acc)[MT][NT][4], uint32_t a_slot,
                                          uint32_t b_chunk, uint32_t a_off,
                                          uint32_t b_off) {
    uint32_t a[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) ldmatrix_x4(a[m], a_slot + a_off + m * 16 * KCH);
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
        uint32_t b[4];
        ldmatrix_x4(b, b_chunk + b_off + j * 16 * KCH);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
            mma_s8(acc[m][2 * j], a[m], b[0], b[1]);
            mma_s8(acc[m][2 * j + 1], a[m], b[2], b[3]);
        }
    }
}

// Requant the accumulators of tile `tile` into the output tile os, then
// store it. Block column n = tap * CO_T + c (tap = 2dy + dx) of the warp's
// n8 tile t is wn * 64 + 8t + 2(lane % 4) (+1); its pixel is wm * 32 + 16m
// + lane / 4 (+8). scb holds (scale, bias) of each block column.
template <int WM, int WN>
__device__ __forceinline__ void epilogue(const int (&acc)[MT][NT][4], uint8_t* os,
                                         const float2* scb, const Epilogue& ep,
                                         int tile, int M, int W, int cout, int co0) {
    constexpr int TM = 32 * WM, CO_T = 16 * WN, OROW = 2 * CO_T + 16;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp / WN, wn = warp % WN;
    const float clip = ep.out_clip;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
        const int n = wn * 64 + 8 * t + 2 * (lane & 3);
        const int tap = n / CO_T, c = n % CO_T;
        const float4 sb = *reinterpret_cast<const float4*>(scb + n);
        uint8_t* row = os + (tap >> 1) * TM * OROW + (tap & 1) * CO_T + c;
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int p = wm * 32 + 16 * m + (lane >> 2) + 8 * h;
                const float v0 = __fmaf_rn(__int2float_rn(acc[m][t][2 * h]), sb.x, sb.y);
                const float v1 = __fmaf_rn(__int2float_rn(acc[m][t][2 * h + 1]), sb.z, sb.w);
                *reinterpret_cast<uint16_t*>(row + p * OROW) =
                    static_cast<uint16_t>(__byte_perm(rounded_bits(v0, -clip, clip),
                                                      rounded_bits(v1, -clip, clip), 0x0040));
            }
    }
    __syncthreads();
    // pixel m0 + p is (row r0, column j0) + p: output rows 2r + dy (r = n*H + i)
    const int m0 = tile * TM, r0 = m0 / W, j0 = m0 - r0 * W;
    if (cout % 16 == 0) {
        constexpr int UPT = CO_T / 16, UPR = 2 * UPT;  // 16-byte units a tap, a row
        for (int e = tid; e < 2 * TM * UPR; e += THREADS) {
            const int dy = e / (TM * UPR), rem = e - dy * TM * UPR;
            const int p = rem / UPR, q = rem - p * UPR;
            const int dx = q / UPT, c = 16 * (q - dx * UPT);
            if (m0 + p < M && co0 + c < cout) {
                int r = r0, j = j0 + p;
                if (j >= W) {
                    const int k = j / W;
                    r += k;
                    j -= k * W;
                }
                *reinterpret_cast<uint4*>(
                    ep.y + ((size_t)(2 * r + dy) * (2 * W) + 2 * j + dx) * cout + co0 + c) =
                    *reinterpret_cast<const uint4*>(os + (dy * TM + p) * OROW + 16 * q);
            }
        }
        return;
    }
    for (int e = tid; e < 2 * TM * 2 * CO_T; e += THREADS) {  // byte stores
        const int dy = e / (TM * 2 * CO_T), rem = e - dy * TM * 2 * CO_T;
        const int p = rem / (2 * CO_T), q = rem - p * (2 * CO_T);
        const int dx = q / CO_T, c = q - dx * CO_T;
        if (m0 + p < M && co0 + c < cout) {
            int r = r0, j = j0 + p;
            if (j >= W) {
                const int k = j / W;
                r += k;
                j -= k * W;
            }
            ep.y[((size_t)(2 * r + dy) * (2 * W) + 2 * j + dx) * cout + co0 + c] =
                static_cast<int8_t>(os[(dy * TM + p) * OROW + q]);
        }
    }
}

// grid (persistent blocks along M, channel tiles), THREADS threads,
// dynamic shared memory smem_bytes(TM, CO_T, nk): the weights (nk x 4 CO_T
// rows of 32 bytes), the ring (STAGES x TM rows of 32 bytes), the output
// tile, the columns' scale and bias. The block's tiles are blockIdx.x +
// k * gridDim.x, k < tiles; the ring's copies run STAGES - 1 chunks ahead
// of the products, across tiles.
template <int WM, int WN>
__global__ void __launch_bounds__(THREADS, 2) ct2x2_int8_mma(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w, Epilogue ep,
    int M, int W, int cin, int cout, int nk, bool async_ld) {
    constexpr int TM = 32 * WM, CO_T = 16 * WN, NB = 4 * CO_T, SLOT = TM * KCH;
    extern __shared__ __align__(128) uint8_t k2_smem[];
    const uint32_t base = smem_addr(k2_smem);
    const uint32_t ring = base + nk * NB * KCH;
    uint8_t* os = k2_smem + nk * NB * KCH + STAGES * SLOT;
    float2* scb = reinterpret_cast<float2*>(os + 2 * TM * (2 * CO_T + 16));

    const int co0 = blockIdx.y * CO_T;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp / WN, wn = warp % WN;
    const int units = (M + TM - 1) / TM;
    const int tiles = (int)blockIdx.x < units ? (units - 1 - blockIdx.x) / gridDim.x + 1 : 0;
    const uint32_t a_off = swz(wm * 32 + (lane & 7) + 8 * ((lane >> 3) & 1), lane >> 4);
    const uint32_t b_off = swz(wn * 64 + (lane & 7) + 8 * (lane >> 4), (lane >> 3) & 1);

    // the block's weights: chunk j, block column n = tap * CO_T + c from
    // packed column tap * cout + co0 + c (zeros beyond cout); they land
    // with the first chunk's group
    for (int e = tid; e < nk * NB * 2; e += THREADS) {
        const int u = e & 1, r = e >> 1, j = r / NB, n = r - j * NB;
        const int tap = n / CO_T, co = co0 + n % CO_T;
        const bool ok = co < cout;
        cp_async16(base + j * NB * KCH + swz(n, u),
                   ok ? w + ((size_t)j * 4 * cout + tap * cout + co) * KCH + 16 * u : w, ok);
    }
    for (int n = tid; n < NB; n += THREADS) {  // read after the first barrier
        const int tap = n / CO_T, co = co0 + n % CO_T;
        scb[n] = co < cout ? make_float2(ep.scale[co],
                                         ep.bias[(ep.bias_per_col ? tap * cout : 0) + co])
                           : make_float2(0.0f, 0.0f);
    }
    // copy group: the next chunk ij of the block's tile it (pixels x 32
    // channels) into ring slot islot
    int it = 0, ij = 0, islot = 0;
    auto issue = [&]() {
        if (it < tiles) {
            const int m0 = (blockIdx.x + it * gridDim.x) * TM, c0 = ij * KCH;
            const uint32_t slot = ring + islot * SLOT;
            for (int e = tid; e < TM * 2; e += THREADS) {
                const int u = e & 1, p = e >> 1;
                const int m = m0 + p, c = c0 + 16 * u;
                const uint32_t dst = slot + swz(p, u);
                if (async_ld) {
                    const bool ok = m < M && c < cin;
                    cp_async16(dst, ok ? x + (size_t)m * cin + c : x, ok);
                } else {
                    uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
                    for (int b = 0; b < 16; ++b)  // constant indices: registers
                        if (m < M && c + b < cin)
                            v[b >> 2] |= (uint32_t)(uint8_t)x[(size_t)m * cin + c + b]
                                         << (8 * (b & 3));
                    *reinterpret_cast<uint4*>(k2_smem + (dst - base)) =
                        make_uint4(v[0], v[1], v[2], v[3]);
                }
            }
            if (++ij == nk) {
                ij = 0;
                ++it;
            }
            islot = islot == STAGES - 1 ? 0 : islot + 1;
        }
        cp_async_commit();
    };

    for (int s = 0; s < STAGES - 1; ++s) issue();
    int slot = 0;
    for (int t = 0; t < tiles; ++t) {
        int acc[MT][NT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[m][n][e] = 0;
        for (int j = 0; j < nk; ++j) {
            cp_async_wait<STAGES - 2>();  // this thread's group for chunk j has landed
            __syncthreads();              // everyone's has; the last chunk's products are done
            issue();                      // into the slot the last chunk freed
            mma_chunk(acc, ring + slot * SLOT, base + j * NB * KCH, a_off, b_off);
            slot = slot == STAGES - 1 ? 0 : slot + 1;
        }
        epilogue<WM, WN>(acc, os, scb, ep, blockIdx.x + t * gridDim.x, M, W, cout, co0);
    }
    cp_async_wait<0>();
}

template <int WM, int WN>
int launch(const int8_t* x, const int8_t* w, const Epilogue& ep, int M, int W,
           int cin, int cout, int nk, int grid, bool async_ld, int smem,
           cudaStream_t s) {
    constexpr int CO_T = 16 * WN;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            ct2x2_int8_mma<WM, WN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    ct2x2_int8_mma<WM, WN><<<dim3(grid, (cout + CO_T - 1) / CO_T), THREADS, smem, s>>>(
        x, w, ep, M, W, cin, cout, nk, async_ld);
    return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// a clip bound the epilogue's rounding takes: an integer in [0, 127]
bool integral_clip(float c) { return c >= 0.0f && c <= 127.0f && c == floorf(c); }

}  // namespace

// K2. x (N, H, W, cin) int8; w (nk, 4*cout, 32) int8, nk = ceil(cin / 32)
// (ops/conv_int8.py:pack_ct2x2_weights), 16-byte aligned; scale (cout)
// and bias (cout, or 4*cout with bias_per_col) float32; out_clip an
// integer in [0, 127]; y (N, 2H, 2W, cout) int8, 16-byte aligned where
// cout % 16 == 0. The plan (ops/conv_int8.py:ct2x2_plan) gives tm and co_t
// ((256, 16), (128, 32), (64, 64) or (32, 128)), stages (STAGES), grid
// (blocks along M, 1..tiles), loader (0: cp.async, which needs cin % 16
// == 0 and an aligned x; 1: byte gathers) and smem (dynamic shared memory
// bytes). Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for arguments the plan would not give.
extern "C" int octseg_ct2x2_int8(const void* x, const void* w, const void* scale,
                                 const void* bias, int bias_per_col,
                                 float out_clip, void* y, int N, int H, int W,
                                 int cin, int cout, int tm, int co_t, int nk,
                                 int stages, int grid, int loader, int smem,
                                 void* stream) {
    const long long M = (long long)N * H * W;
    const long long units = tm > 0 ? (M + tm - 1) / tm : 0;
    const long long n_co = co_t > 0 ? (cout + co_t - 1) / co_t : 0;
    const bool bad =
        N < 1 || H < 1 || W < 1 || M > 0x7fffffffLL - 512 || cin < 1 || cout < 1 ||
        nk != (cin + KCH - 1) / KCH || tm * co_t != 32 * 128 ||
        (tm != 32 && tm != 64 && tm != 128 && tm != 256) || stages != STAGES ||
        grid < 1 || grid > units || n_co > 65535 ||
        (units + grid - 1) / grid * nk > 0x7fffffffLL || (loader != 0 && loader != 1) ||
        (loader == 0 && (cin % 16 != 0 || !aligned16(x))) || x == nullptr ||
        w == nullptr || !aligned16(w) || scale == nullptr || bias == nullptr ||
        (bias_per_col != 0 && bias_per_col != 1) || !integral_clip(out_clip) ||
        y == nullptr || (cout % 16 == 0 && !aligned16(y)) ||
        smem != smem_bytes(tm, co_t, nk) || smem > SMEM_MAX;
    if (bad) return static_cast<int>(cudaErrorInvalidValue);
    const Epilogue ep{static_cast<const float*>(scale), static_cast<const float*>(bias),
                      bias_per_col, out_clip, static_cast<int8_t*>(y)};
    auto a = static_cast<const int8_t*>(x);
    auto b = static_cast<const int8_t*>(w);
    auto s = static_cast<cudaStream_t>(stream);
    const bool async_ld = loader == 0;
#define K2_LAUNCH(WM, WN) \
    return launch<WM, WN>(a, b, ep, (int)M, W, cin, cout, nk, grid, async_ld, smem, s)
    if (tm == 256) K2_LAUNCH(8, 1);
    if (tm == 128) K2_LAUNCH(4, 2);
    if (tm == 64) K2_LAUNCH(2, 4);
    K2_LAUNCH(1, 8);
#undef K2_LAUNCH
}
