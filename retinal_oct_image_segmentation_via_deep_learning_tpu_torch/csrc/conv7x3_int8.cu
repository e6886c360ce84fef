// K7: int8 KHx3 stride-1 "same" convolution (KH odd: 3, 5 or 7; ReLayNet
// uses 7) with a fused requant + PReLU epilogue and an optional fused 2x2/2
// index max-pool, for NHWC int8 activations, on the int8 tensor cores.
//
// Replaces two TPU kernels that compute this one function in TPU lane
// packings:
//   ops/pallas_conv_psrp7.py:conv7x3_psrp  (ReLayNet's blocks b1..b6, the
//                                            decoders' skip concat folded in)
//   ops/pallas_conv_psrp7.py:stem7_psrp    (the Cin=1 stem b0)
//
// Function: acc[n,y,x,co] = sum_{ky,kx,c} in[n,y+ky-KH/2,x+kx-1,c] *
// w[ky,kx,c,co] in int32, where `in` is the channel concat of one or two
// inputs (never materialised: the loader reads both pointers) and
// out-of-image pixels are zero. Epilogue, in this order:
//   v = fmaf(float(acc), scale[co], bias[co]);
//   v = v >= 0 ? v : alpha * v   (PReLU, one shared fp32 slope);
//   rint (half-even); clip to [-127, 127]; int8.
// The pool's value is the maximum of a 2x2 window of that int8 output and
// its index (int8, 0..3, flat dy*2+dx) the first maximum in the order (0,0),
// (0,1), (1,0), (1,1), decided with strict > as the TPU kernel does. int32
// sums are exact in any order, so the tensor-core sums equal any other.
//
// What bounds each stage on an H100 (int8 at 1979 TOPS dense, HBM at 3.35
// TB/s): b1..b6 (64 or 128 input channels, 64 outputs, 21 taps) do 1.1-1.8
// thousand operations a byte moved, above the ~590 at which the tensor
// cores and not HBM are the limit: they are bound by operations. The stem
// (one input channel) does about 28 operations a byte: it is bound by the
// bytes it writes (y, the pooled values and the indices: 1.5 bytes per
// output channel and pixel against 1/64 byte read).
//
// Design. An implicit GEMM on mma.sync m16n8k32 s8*s8 -> s32: M = the
// pixels of a 32 x 16 output tile (8 warps, each 4 tile rows = 4 m16
// tiles), N = 32 or 64 output channels a block (all of ReLayNet's 64, so a
// pixel's outputs sit together), K = taps x input channels in 32-byte
// chunks (32 channels of one input at f=64, x0's chunks before x1's).
// - b1..b6: chunk j of the (32+KH-1) x 18 halo (32 bytes a pixel) and of the
//   weights (KH*3 taps x N x 32 bytes, K-contiguous per output channel)
//   arrive by cp.async 16-byte copies into a ring of 2 or 3 stages in
//   shared memory, zero-filled outside the image by their source size, so
//   the next chunks' copies are in flight during a chunk's products. A
//   fragments come from ldmatrix.x4 on the halo: a tap (ky, kx) only moves
//   the row addresses by ky rows and kx pixels. B fragments come from
//   ldmatrix.x4 on the weights, loaded once a tap and used by the warp's 4
//   m16 tiles. Each 32-byte row's two 16-byte units are XOR-swizzled by bit
//   2 of the pixel (swz below), so the 8 rows of every ldmatrix phase (8
//   consecutive pixels of one halo row, or 8 consecutive output channels)
//   fall in 8 different bank groups at any tap shift. Per chunk a warp
//   issues 84 A and 84 B ldmatrix for 672 MMAs.
// - The stem (cin <= 4): the taps are folded into K (im2col). The block
//   stages the image rows of its halo (cp.async 16-byte units where the
//   rows are whole units), spreads them to one 32-bit word (4 channels) a
//   pixel, and builds each output pixel's KH*3 words, zero-padded to whole
//   32-byte chunks, in shared memory; the weights arrive by 4-byte
//   cp.async. The same MMA body and epilogue follow.
// - Epilogue (both): requant and PReLU on the accumulator fragments, the
//   int8 results into a 32 x 16 x N tile in shared memory (rows padded by
//   16 bytes: conflict-free 2-byte writes), then y, the pooled values and
//   the indices leave as 16-byte stores, neighbouring threads on
//   neighbouring addresses (byte stores only where cout % 16 != 0). The
//   pool is taken from the tile with per-byte SIMD compares; tiles start on
//   even rows and columns.
// - Channel counts that are not a multiple of 32, or misaligned inputs:
//   the loader gathers bytes into the same layout (right, not fast).
// The launch (tile, stages, shared memory, loader) is the plan of
// ops/conv7x3_int8.py:conv7x3_plan; the entry point checks it.
//
// Weights (ops/conv7x3_int8.py:pack_conv7x3_weights): cin > 4: int8
// (nk, KH*3, coutp, 32), byte [j, t, co, b] = w[t/3, t%3, 32j+b, co];
// cin <= 4: int32 words (KH*3, 1, coutp), word [t, co] = w[t/3, t%3,
// 0..3, co]; coutp = cout padded to 32, zero padding.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_int8.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;  // 256
constexpr int MW = 4;                // tile rows (m16 tiles) a warp, b1..b6
constexpr int ROWS = WARPS * MW;     // output tile rows, b1..b6
constexpr int SMW = 2;               // the same for the stem
constexpr int SROWS = WARPS * SMW;
constexpr int COLS = 16;             // output tile columns: one m16 tile
constexpr int HALO_W = COLS + 2;     // halo columns
constexpr int KCH = 32;              // bytes of K a chunk: the MMA's k
constexpr int PITCH = HALO_W * KCH;  // bytes a halo row of one chunk
constexpr int RAW = 48;              // stem: pixels of an image row staged

__device__ __forceinline__ int8_t requant_prelu(int acc, float s, float b,
                                                float alpha) {
    float v = __fmaf_rn(__int2float_rn(acc), s, b);
    v = v >= 0.0f ? v : __fmul_rn(alpha, v);
    v = rintf(v);
    v = fminf(fmaxf(v, -127.0f), 127.0f);
    return static_cast<int8_t>(__float2int_rn(v));
}

// 4 bytes, likewise
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

// The products of one K chunk: for each of the KY x KX taps, the warp's NT
// n8 B tiles (ldmatrix from the tap's N x 32 bytes at b_base) against its
// M m16 A tiles, tile row m of tap (ky, kx) at a_rows + (m + ky) * RP +
// a_col[kx].
template <int M, int KY, int KX, int NT, int RP>
__device__ __forceinline__ void mma_chunk(int (&acc)[M][NT][4],
                                          uint32_t a_rows,
                                          const uint32_t (&a_col)[3],
                                          uint32_t b_base,
                                          const uint32_t (&b_off)[NT / 2]) {
#pragma unroll
    for (int ky = 0; ky < KY; ++ky)
#pragma unroll
        for (int kx = 0; kx < KX; ++kx) {
            const uint32_t bt = b_base + (ky * KX + kx) * NT * 8 * KCH;
            uint32_t b[NT][2];
#pragma unroll
            for (int j = 0; j < NT / 2; ++j) {
                uint32_t r[4];
                ldmatrix_x4(r, bt + b_off[j]);
                b[2 * j][0] = r[0];
                b[2 * j][1] = r[1];
                b[2 * j + 1][0] = r[2];
                b[2 * j + 1][1] = r[3];
            }
#pragma unroll
            for (int m = 0; m < M; ++m) {
                uint32_t a[4];
                ldmatrix_x4(a, a_rows + (m + ky) * RP + a_col[kx]);
#pragma unroll
                for (int t = 0; t < NT; ++t)
                    mma_s8(acc[m][t], a, b[t][0], b[t][1]);
            }
        }
}

// Requant the accumulators (M tile rows a warp) into the int8 tile os
// (8 M x COLS pixels, rows of N + 16 bytes), then write y, and with a pool
// yp and yi, from it.
template <int M, int NT>
__device__ __forceinline__ void epilogue(
    const int (&acc)[M][NT][4], uint8_t* os, const float* __restrict__ scale,
    const float* __restrict__ bias, float alpha, int8_t* __restrict__ y,
    int8_t* __restrict__ yp, int8_t* __restrict__ yi, int n, int H, int W,
    int y0, int x0, int co0, int cout) {
    constexpr int CO_T = NT * 8, OP = CO_T + 16, R = WARPS * M;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
        const int c = 8 * t + 2 * (lane & 3), co = co0 + c;
        const float s0 = co < cout ? scale[co] : 0.0f;
        const float b0 = co < cout ? bias[co] : 0.0f;
        const float s1 = co + 1 < cout ? scale[co + 1] : 0.0f;
        const float b1 = co + 1 < cout ? bias[co + 1] : 0.0f;
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int px = (warp * M + m) * COLS + (lane >> 2) + 8 * h;
                const uint32_t v0 = static_cast<uint8_t>(
                    requant_prelu(acc[m][t][2 * h], s0, b0, alpha));
                const uint32_t v1 = static_cast<uint8_t>(
                    requant_prelu(acc[m][t][2 * h + 1], s1, b1, alpha));
                *reinterpret_cast<uint16_t*>(os + px * OP + c) =
                    static_cast<uint16_t>(v0 | (v1 << 8));
            }
    }
    __syncthreads();
    const int H2 = H / 2, W2 = W / 2;
    if (cout % 16 == 0) {
        constexpr int UPP = CO_T / 16;  // 16-byte units a pixel
        for (int e = tid; e < R * COLS * UPP; e += THREADS) {
            const int px = e / UPP, u = e - px * UPP;
            const int oy = y0 + px / COLS, ox = x0 + px % COLS;
            const int co = co0 + 16 * u;
            if (oy < H && ox < W && co < cout)
                *reinterpret_cast<uint4*>(
                    y + (((size_t)n * H + oy) * W + ox) * cout + co) =
                    *reinterpret_cast<const uint4*>(os + px * OP + 16 * u);
        }
        if (yp == nullptr) return;
        for (int e = tid; e < (R / 2) * (COLS / 2) * UPP; e += THREADS) {
            const int pp = e / UPP, u = e - pp * UPP;
            const int pr = pp / (COLS / 2), pc = pp % (COLS / 2);
            const int oy = y0 / 2 + pr, ox = x0 / 2 + pc, co = co0 + 16 * u;
            if (oy >= H2 || ox >= W2 || co >= cout) continue;
            const uint8_t* src = os + (2 * pr * COLS + 2 * pc) * OP + 16 * u;
            const uint4 v[4] = {
                *reinterpret_cast<const uint4*>(src),
                *reinterpret_cast<const uint4*>(src + OP),
                *reinterpret_cast<const uint4*>(src + COLS * OP),
                *reinterpret_cast<const uint4*>(src + COLS * OP + OP)};
            uint32_t best[4] = {v[0].x, v[0].y, v[0].z, v[0].w};
            uint32_t idx[4] = {0u, 0u, 0u, 0u};
#pragma unroll
            for (int k = 1; k < 4; ++k) {
                const uint32_t vk[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const uint32_t gt = __vcmpgts4(vk[i], best[i]);  // 0xff where >
                    best[i] = (vk[i] & gt) | (best[i] & ~gt);
                    idx[i] = ((0x01010101u * k) & gt) | (idx[i] & ~gt);
                }
            }
            const size_t o = (((size_t)n * H2 + oy) * W2 + ox) * cout + co;
            *reinterpret_cast<uint4*>(yp + o) =
                make_uint4(best[0], best[1], best[2], best[3]);
            *reinterpret_cast<uint4*>(yi + o) =
                make_uint4(idx[0], idx[1], idx[2], idx[3]);
        }
        return;
    }
    // cout % 16 != 0: byte stores
    for (int e = tid; e < R * COLS * CO_T; e += THREADS) {
        const int px = e / CO_T, c = e - px * CO_T;
        const int oy = y0 + px / COLS, ox = x0 + px % COLS;
        if (oy < H && ox < W && co0 + c < cout)
            y[(((size_t)n * H + oy) * W + ox) * cout + co0 + c] =
                static_cast<int8_t>(os[px * OP + c]);
    }
    if (yp == nullptr) return;
    for (int e = tid; e < (R / 2) * (COLS / 2) * CO_T; e += THREADS) {
        const int pp = e / CO_T, c = e - pp * CO_T;
        const int pr = pp / (COLS / 2), pc = pp % (COLS / 2);
        const int oy = y0 / 2 + pr, ox = x0 / 2 + pc;
        if (oy >= H2 || ox >= W2 || co0 + c >= cout) continue;
        const uint8_t* src = os + (2 * pr * COLS + 2 * pc) * OP + c;
        const int8_t v[4] = {static_cast<int8_t>(src[0]),
                             static_cast<int8_t>(src[OP]),
                             static_cast<int8_t>(src[COLS * OP]),
                             static_cast<int8_t>(src[COLS * OP + OP])};
        int8_t best = v[0], idx = 0;
#pragma unroll
        for (int k = 1; k < 4; ++k)
            if (v[k] > best) {
                best = v[k];
                idx = static_cast<int8_t>(k);
            }
        const size_t o = (((size_t)n * H2 + oy) * W2 + ox) * cout + co0 + c;
        yp[o] = best;
        yi[o] = idx;
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

// b1..b6 (cin > 4): grid (tiles, coutp / (8 NT), N), THREADS threads,
// dynamic shared memory of `stages` ring slots (halo chunk, then weights).
template <int KH, int NT>
__global__ void __launch_bounds__(THREADS, 1) conv7x3_mma(
    const int8_t* __restrict__ x0, int cin0, const int8_t* __restrict__ x1,
    int cin1, const int8_t* __restrict__ w, const float* __restrict__ scale,
    const float* __restrict__ bias, float alpha, int8_t* __restrict__ y,
    int8_t* __restrict__ yp, int8_t* __restrict__ yi, int H, int W, int cout,
    int coutp, int nk, int stages, bool async_ld, int tiles_x) {
    constexpr int CO_T = NT * 8, TAPS = KH * 3, HR = ROWS + KH - 1;
    constexpr int HALO = HR * PITCH, STAGE = HALO + TAPS * CO_T * KCH;
    extern __shared__ __align__(128) uint8_t smem[];
    const uint32_t base = smem_addr(smem);

    const int n = blockIdx.z, co0 = blockIdx.y * CO_T;
    const int ty0 = (blockIdx.x / tiles_x) * ROWS;  // the tile's origin
    const int tx0 = (blockIdx.x % tiles_x) * COLS;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int cin = cin0 + cin1;
    uint32_t a_col[3], b_off[NT / 2];
    lane_offsets<NT>(lane, a_col, b_off);

    int acc[MW][NT][4];
#pragma unroll
    for (int m = 0; m < MW; ++m)
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][t][e] = 0;

    // copy group j: chunk j's halo (pixel rows y0-KH/2.., columns x0-1..)
    // and weights into ring slot j % stages
    auto issue = [&](int j) {
        if (j < nk) {
            const uint32_t off = (j % stages) * STAGE;
            for (int e = tid; e < HR * HALO_W * 2; e += THREADS) {
                const int u = e & 1, p = e >> 1;
                const int hr = p / HALO_W, hc = p - hr * HALO_W;
                const int iy = ty0 - KH / 2 + hr, ix = tx0 - 1 + hc;
                const bool in = iy >= 0 && iy < H && ix >= 0 && ix < W;
                const size_t pix = in ? ((size_t)n * H + iy) * W + ix : 0;
                const uint32_t dst = off + hr * PITCH + swz(hc, u);
                const int c = j * KCH + 16 * u;
                if (async_ld) {
                    const int8_t* src = c < cin0 ? x0 + pix * cin0 + c
                                                 : x1 + pix * cin1 + (c - cin0);
                    cp_async16(base + dst, in ? src : x0, in);
                } else {
                    uint32_t v[4] = {0u, 0u, 0u, 0u};
                    if (in)
                        for (int b = 0; b < 16; ++b) {
                            const int cc = c + b;
                            const int8_t s = cc < cin0 ? x0[pix * cin0 + cc]
                                             : cc < cin ? x1[pix * cin1 + (cc - cin0)]
                                                        : 0;
                            v[b >> 2] |= (uint32_t)(uint8_t)s << (8 * (b & 3));
                        }
                    *reinterpret_cast<uint4*>(smem + dst) =
                        make_uint4(v[0], v[1], v[2], v[3]);
                }
            }
            const int8_t* wj = w + (size_t)j * TAPS * coutp * KCH;
            for (int e = tid; e < TAPS * CO_T * 2; e += THREADS) {
                const int u = e & 1, r = e >> 1;
                const int tap = r / CO_T, co = r - tap * CO_T;
                cp_async16(base + off + HALO + tap * CO_T * KCH + swz(co, u),
                           wj + ((size_t)tap * coutp + co0 + co) * KCH + 16 * u,
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
        mma_chunk<MW, KH, 3, NT, PITCH>(acc, slot + warp * MW * PITCH, a_col,
                                    slot + HALO, b_off);
    }
    cp_async_wait<0>();
    __syncthreads();  // the epilogue's tile reuses the ring
    epilogue<MW, NT>(acc, smem, scale, bias, alpha, y, yp, yi, n, H, W, ty0, tx0,
                 co0, cout);
}

template <int KH>
__host__ __device__ constexpr int stem_chunks() { return (KH * 3 * 4 + KCH - 1) / KCH; }

// The stem (cin <= 4): a persistent block (2 an SM) walks the tiles u =
// blockIdx.x, blockIdx.x + gridDim.x, ... (u -> image u / tiles, tile
// u % tiles, a tile SROWS x COLS pixels) for output channels blockIdx.y *
// 8 NT... . Shared memory: the epilogue's int8 tile, the weights (NK x N x
// 32 bytes, loaded once), the halo as one 32-bit word (4 channels) a pixel,
// and for the async loader the staged image rows, which take the next
// tile's rows while this tile is multiplied and stored. The taps are
// folded into K: A register (pixel, tap t) is the halo word under tap t,
// read straight from the word halo (K bytes 4t..4t+3), so no im2col copy
// is built.
template <int KH, int NT>
__global__ void __launch_bounds__(THREADS, 2) stem7x3_mma(
    const int8_t* __restrict__ x0, int cin0, const int8_t* __restrict__ x1,
    int cin1, const int32_t* __restrict__ w, const float* __restrict__ scale,
    const float* __restrict__ bias, float alpha, int8_t* __restrict__ y,
    int8_t* __restrict__ yp, int8_t* __restrict__ yi, int N, int H, int W,
    int cout, int coutp, bool async_ld, int tiles_x, int tiles) {
    constexpr int CO_T = NT * 8, TAPS = KH * 3, HR = SROWS + KH - 1;
    constexpr int NK = stem_chunks<KH>();
    constexpr int W_OFF = SROWS * COLS * (CO_T + 16);
    constexpr int HW_OFF = W_OFF + NK * CO_T * KCH;
    constexpr int RAW_OFF = HW_OFF + HR * HALO_W * 4;
    extern __shared__ __align__(128) uint8_t smem[];
    const uint32_t base = smem_addr(smem);

    const int co0 = blockIdx.y * CO_T;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int cin = cin0 + cin1, units = 3 * cin0;
    const long row_bytes = (long)W * cin0;
    uint32_t a_col[3], b_off[NT / 2];
    lane_offsets<NT>(lane, a_col, b_off);
    // this lane's A words: pixel lane / 4 (+ 8), taps 8 kc + lane % 4 (+ 4)
    // at halo word offset tap_off[kc][h] from the pixel's, or zero padding
    int tap_off[NK][2];
#pragma unroll
    for (int kc = 0; kc < NK; ++kc)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int t = 8 * kc + 4 * h + (lane & 3);
            tap_off[kc][h] = t < TAPS ? (t / 3) * HALO_W + t % 3 : -1;
        }
    uint32_t* hw = reinterpret_cast<uint32_t*>(smem + HW_OFF);

    // weight word (t, co) -> chunk t / 8, row co, bytes 4 (t % 8)..+3
    // (unit (t % 8) / 4)
    for (int e = tid; e < NK * 8 * CO_T; e += THREADS) {
        const int t = e / CO_T, co = e - t * CO_T;
        const bool ok = t < TAPS;
        cp_async4(base + W_OFF + (t / 8) * CO_T * KCH + swz(co, (t % 8) >> 2) +
                      4 * (t & 3),
                  ok ? w + (size_t)t * coutp + co0 + co : w, ok);
    }
    // tile u's image rows from pixel tx0-16: 3 cin0 units of 16 bytes a row,
    // each wholly inside the row or wholly outside (zero-filled)
    auto issue_rows = [&](int u) {
        if (async_ld && u < N * tiles) {
            const int n = u / tiles, tile = u - n * tiles;
            const int ty0 = (tile / tiles_x) * SROWS, tx0 = (tile % tiles_x) * COLS;
            for (int e = tid; e < HR * units; e += THREADS) {
                const int hr = e / units, q = e - hr * units;
                const int iy = ty0 - KH / 2 + hr;
                const long off = (long)(tx0 - 16) * cin0 + 16 * q;
                const bool ok = iy >= 0 && iy < H && off >= 0 && off + 16 <= row_bytes;
                cp_async16(base + RAW_OFF + hr * RAW * 4 + 16 * q,
                           ok ? x0 + ((size_t)n * H + iy) * row_bytes + off : x0, ok);
            }
        }
        cp_async_commit();
    };
    issue_rows(blockIdx.x);

    for (int u = blockIdx.x; u < N * tiles; u += gridDim.x) {
        const int n = u / tiles, tile = u - n * tiles;
        const int ty0 = (tile / tiles_x) * SROWS, tx0 = (tile % tiles_x) * COLS;
        cp_async_wait<0>();
        __syncthreads();  // tile u's rows (and the weights) landed; tile
                          // u - gridDim.x's products are done with the halo
        for (int p = tid; p < HR * HALO_W; p += THREADS) {
            const int hr = p / HALO_W, hc = p - hr * HALO_W;
            uint32_t v = 0;
            if (async_ld) {
                const uint8_t* r = smem + RAW_OFF + hr * RAW * 4 + (hc + 15) * cin0;
                for (int c = 0; c < cin0; ++c) v |= (uint32_t)r[c] << (8 * c);
            } else {
                const int iy = ty0 - KH / 2 + hr, ix = tx0 - 1 + hc;
                if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
                    const size_t pix = ((size_t)n * H + iy) * W + ix;
                    for (int c = 0; c < cin; ++c) {
                        const int8_t s = c < cin0 ? x0[pix * cin0 + c]
                                                  : x1[pix * cin1 + (c - cin0)];
                        v |= (uint32_t)(uint8_t)s << (8 * c);
                    }
                }
            }
            hw[p] = v;
        }
        __syncthreads();
        issue_rows(u + gridDim.x);  // the staged rows are free again

        int acc[SMW][NT][4];
#pragma unroll
        for (int m = 0; m < SMW; ++m)
#pragma unroll
            for (int t = 0; t < NT; ++t)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[m][t][e] = 0;
#pragma unroll
        for (int kc = 0; kc < NK; ++kc) {
            const uint32_t bt = base + W_OFF + kc * CO_T * KCH;
            uint32_t b[NT][2];
#pragma unroll
            for (int j = 0; j < NT / 2; ++j) {
                uint32_t r[4];
                ldmatrix_x4(r, bt + b_off[j]);
                b[2 * j][0] = r[0];
                b[2 * j][1] = r[1];
                b[2 * j + 1][0] = r[2];
                b[2 * j + 1][1] = r[3];
            }
#pragma unroll
            for (int m = 0; m < SMW; ++m) {
                const uint32_t* px = hw + (warp * SMW + m) * HALO_W + (lane >> 2);
                uint32_t a[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int off = tap_off[kc][i >> 1];
                    a[i] = off >= 0 ? px[off + 8 * (i & 1)] : 0u;
                }
#pragma unroll
                for (int t = 0; t < NT; ++t)
                    mma_s8(acc[m][t], a, b[t][0], b[t][1]);
            }
        }
        epilogue<SMW, NT>(acc, smem, scale, bias, alpha, y, yp, yi, n, H, W,
                          ty0, tx0, co0, cout);
    }
}

// Dynamic shared memory of one block (ops/conv7x3_int8.py:_smem).
int smem_bytes(int kh, int co_t, int nk, int stages, bool im2col) {
    const int rows = im2col ? SROWS : ROWS;
    const int hr = rows + kh - 1, out = rows * COLS * (co_t + 16);
    if (im2col)  // the tile, then the weights, the word halo and the rows
        return out + nk * co_t * KCH + hr * HALO_W * 4 + hr * RAW * 4;
    const int ring = stages * (hr * PITCH + kh * 3 * co_t * KCH);
    return ring > out ? ring : out;  // the tile reuses the ring
}

template <int KH, int NT>
int launch(const int8_t* x0, int cin0, const int8_t* x1, int cin1,
           const void* w, const float* scale, const float* bias, float alpha,
           int8_t* y, int8_t* yp, int8_t* yi, int N, int H, int W, int cout,
           int coutp, int nk, int stages, int blocks, int loader, int smem,
           cudaStream_t s) {
    const int rows = loader >= 2 ? SROWS : ROWS;
    const int tiles_x = (W + COLS - 1) / COLS, tiles_y = (H + rows - 1) / rows;
    const bool async_ld = loader == 0 || loader == 2;
    cudaError_t err;
    if (loader >= 2) {
        err = cudaFuncSetAttribute(stem7x3_mma<KH, NT>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        stem7x3_mma<KH, NT><<<dim3(blocks, coutp / (NT * 8)), THREADS, smem, s>>>(
            x0, cin0, x1, cin1, static_cast<const int32_t*>(w), scale, bias,
            alpha, y, yp, yi, N, H, W, cout, coutp, async_ld, tiles_x,
            tiles_x * tiles_y);
    } else {
        err = cudaFuncSetAttribute(conv7x3_mma<KH, NT>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        conv7x3_mma<KH, NT><<<dim3(blocks, coutp / (NT * 8), N), THREADS, smem, s>>>(
            x0, cin0, x1, cin1, static_cast<const int8_t*>(w), scale, bias,
            alpha, y, yp, yi, H, W, cout, coutp, nk, stages, async_ld, tiles_x);
    }
    return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// The plan (ops/conv7x3_int8.py:conv7x3_plan) gives co_t (32 or 64 output
// channels a block), nk (K chunks), stages (2 or 3; 1 for the im2col
// loaders), blocks (the grid's x: one a tile, or the stem's persistent
// blocks), loader (0 async, 1 gather, 2 im2col_async, 3 im2col_gather) and
// smem (dynamic shared memory bytes). x1 may be null with cin1 = 0; yp and
// yi are both null (no pool) or both set (pool; H, W even). Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for arguments the plan would not give.
extern "C" int octseg_conv7x3_int8(
    const void* x0, int cin0, const void* x1, int cin1, const void* w,
    const void* scale, const void* bias, float alpha, void* y, void* yp,
    void* yi, int N, int H, int W, int cout, int coutp, int kh, int co_t,
    int nk, int stages, int blocks, int loader, int smem, void* stream) {
    const bool im2col = loader == 2 || loader == 3;
    const int cin = cin0 + cin1;
    const int rows = im2col ? SROWS : ROWS;
    const int tiles = ((H + rows - 1) / rows) * ((W + COLS - 1) / COLS);
    const int nk_want = im2col ? (kh * 3 * 4 + KCH - 1) / KCH
                               : (cin + KCH - 1) / KCH;
    const bool bad =
        (kh != 3 && kh != 5 && kh != 7) || (co_t != 32 && co_t != 64) ||
        coutp % co_t != 0 || coutp < cout || cout < 1 || loader < 0 ||
        loader > 3 || (yp == nullptr) != (yi == nullptr) ||
        (yp != nullptr && (H % 2 != 0 || W % 2 != 0)) || nk != nk_want ||
        (im2col ? (cin > 4 || stages != 1) : (cin <= 4 || (stages != 2 && stages != 3))) ||
        (cin1 > 0 && x1 == nullptr) || N < 1 || H < 1 || W < 1 ||
        (im2col ? (blocks < 1 || blocks > N * tiles) : blocks != tiles) ||
        (loader == 0 && (cin0 % 32 != 0 || cin1 % 32 != 0 || !aligned16(x0) ||
                         (cin1 > 0 && !aligned16(x1)))) ||
        (loader == 2 && (cin1 != 0 || (W * cin0) % 16 != 0 || !aligned16(x0))) ||
        smem != smem_bytes(kh, co_t, nk, stages, im2col);
    if (bad) return static_cast<int>(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    auto a0 = static_cast<const int8_t*>(x0);
    auto a1 = static_cast<const int8_t*>(x1);
    auto sc = static_cast<const float*>(scale);
    auto bi = static_cast<const float*>(bias);
    auto o = static_cast<int8_t*>(y);
    auto op = static_cast<int8_t*>(yp);
    auto oi = static_cast<int8_t*>(yi);
#define K7_LAUNCH(KH, NT)                                                    \
    return launch<KH, NT>(a0, cin0, a1, cin1, w, sc, bi, alpha, o, op, oi, N, \
                          H, W, cout, coutp, nk, stages, blocks, loader,    \
                          smem, s)
    if (co_t == 64) {
        if (kh == 7) K7_LAUNCH(7, 8);
        if (kh == 5) K7_LAUNCH(5, 8);
        K7_LAUNCH(3, 8);
    }
    if (kh == 7) K7_LAUNCH(7, 4);
    if (kh == 5) K7_LAUNCH(5, 4);
    K7_LAUNCH(3, 4);
#undef K7_LAUNCH
}
