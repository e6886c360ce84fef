// K4 and K5: the bf16 3x3 stride-1 "same" training convolution on NHWC
// tensors, with fp32 accumulation on the tensor cores.
//
// K4 replaces ops/pallas_conv_bf16.py:_conv_fwd_pallas, which serves both
// the forward and the input gradient of conv3x3_psrp_bf16:
//   y[n,h,w,co] = bf16_rn( sum_{ky,kx,ci} x[n,h+ky-1,w+kx-1,ci] * w[ky,kx,ci,co] )
// (zero outside the image). The dgrad is the same kernel on dy with the
// weights rotated 180 degrees and transposed (ops/conv_bf16.py:flip_w).
//
// What bounds K4 on the card: at the default train step's six 512^2 calls
// (cin 32 or 64, cout 32 or 64, batch 8) the bytes: 144-192 operations a
// byte moved, under the ~295 bf16 operations a byte at which the tensor
// cores become the limit (0.0801-0.1202 ms a call at 3.35 TB/s).
//
// K4 has two bodies; ops/conv_bf16.py:fwd_plan chooses one per call.
// - conv3x3_bf16_mma (cin % 16 == 0, cout % 8 == 0, 16-byte aligned
//   pointers): K7's implicit GEMM (csrc/conv7x3_int8.cu:conv7x3_mma) with
//   KH = 3 on mma.sync m16n8k16 bf16 -> fp32. A K chunk of 16 input
//   channels is 32 bytes a pixel, K7's chunk, and the bf16 m16n8k16
//   fragments sit in the registers byte for byte as K7's s8 m16n8k32 ones
//   (A: a0 row g, bytes 4t..4t+3, a1 row g+8, a2/a3 16 bytes on; B: b0
//   column g, bytes 4t..4t+3, b1 16 bytes on; C: c0/c1 row g, columns 2t,
//   2t+1, c2/c3 row g+8), so K7's loader, ring, swizzle and ldmatrix
//   addresses carry over unchanged. M = a 32 x 16 output tile (8 warps x 4
//   m16 tiles), N = 32 (or 64) output channels a block, K = 9 taps x the
//   chunks. A warp reads each of its 6 halo rows once a kx for all three
//   ky (18 A ldmatrix a chunk, not 36). Chunk j's (32+2) x 18 halo and its
//   9 x N weight rows arrive by cp.async 16-byte copies, zero-filled
//   outside the image by source size, into a ring of 2-3 slots.
//   A tile has only 2-4 chunks, too few for the ring to hide the first
//   chunk's copy; the overlap comes from a second resident block: at
//   N = 32 the 64 fp32 accumulators a thread let two blocks share an SM,
//   so one multiplies while the other copies or stores. Three slots put a
//   tile's first two chunks in flight from its start. (A persistent grid
//   whose two-slot ring ran across tiles, with the epilogue's tile apart,
//   was slower on the card: PERF.md section 6.) The epilogue
//   rounds each sum once to bf16 into a 32 x 16 x N tile in shared memory
//   that reuses the ring (rows padded by 16 bytes: conflict-free 4-byte
//   writes) and stores it as 16-byte chunks, neighbouring threads on
//   neighbouring addresses.
// - conv3x3_bf16_fwd_kernel (every other call: odd channel counts,
//   misaligned inputs): an 8x16-pixel output tile's input rows plus halo
//   (16 input channels at a time) and the matching weight slice staged in
//   shared memory, each warp one 16-pixel row of the tile through WMMA
//   16x16x16 for the nine taps.
// With no atomics, a repeated call gives the same bits.
//
// K5 replaces ops/pallas_conv_bf16.py:_conv_wgrad_pallas and the band fold
// after it: it writes the (3, 3, cin, cout) fp32 weight gradient directly,
//   dw[ky,kx,ci,co] = sum_{n,h,w} x[n,h+ky-1,w+kx-1,ci] * dy[n,h,w,co],
// a split-K GEMM with M = 9 taps x cin, N = cout and K = the N*H*W pixels.
//
// What bounds K5 on the card: at the 512^2 stages (cin 32 or 64, cout 32)
// the bytes. There a call does 40-80 GFLOP on 0.2-0.3 GB of x and dy, below
// the ~295 bf16 operations a byte at which the tensor cores become the
// limit. At the deep stages (up to 512 -> 512 at 32^2) the operations.
//
// Decomposition. A block owns a band of R output rows x TWK columns of one
// image and a channel tile (CI_T <= 64 input, WG_CO_T = 32 output channels),
// and keeps the (9, CI_T, 32) sums of all nine taps in registers: warp t
// holds tap t's CI_T x 32 block (at most 64 fp32 a thread). At the 512^2
// stages the channel tile is all of cin and cout, so each byte of dy leaves
// HBM once and each byte of x (R+2)/R * (TWK+2)/TWK times. The grid is
// (G, cin tiles, cout tiles), G a small multiple of the SM count
// (ops/conv_bf16.py:wgrad_plan chooses G, R, TWK and CI_T); block g walks the
// bands g, g+G, g+2G, ... in that order and writes one fp32 partial, and a
// second kernel adds the G partials in a fixed order (no float atomics: a
// training step is reproducible bit for bit): 8 slices of a block's warps
// and a pairwise sum where G is large (the 512^2 stages), one thread an
// output where G is small (the deep stages, many outputs, few partials).
//
// Staging. A ring in shared memory of WG_XS x row segments (TWK+2 pixels x
// CI_T channels) and WG_DS dy row segments (TWK pixels x 32 channels):
// while output row r is multiplied out of x rows r-1..r+1 and dy row r, the
// x rows up to r+1+WG_DEPTH and dy rows up to r+WG_DEPTH are in flight. The
// copies are cp.async, 16 bytes a thread, with commit/wait groups, and not
// Hopper's 1-D bulk copy: a channel tile of a deep stage is not one
// contiguous run of bytes; cp.async fills rows, columns and channels outside
// the image with zeros by its source size (no byte read); and each 16-byte
// chunk goes to an XOR-swizzled place in its slot, so that every ldmatrix
// below reads 8 different bank groups at any pixel offset (a bulk copy
// lands the segment unswizzled: 8-way bank conflicts at cin 64).
//
// Products. mma.sync m16n8k16 bf16 -> fp32 through inline PTX, with A = x^T
// (ci x pixels) and B = dy (pixels x co), both read from the pixel-major
// slots by ldmatrix.trans. A tap's kx shift is a one-pixel offset of the
// ldmatrix row addresses and its ky another ring slot: no copy per tap.
//
// What holds K5 on the card (k5_probe.py times builds with parts taken
// out): the copies hide under the products, so the issue of mma.sync and
// ldmatrix by one warp a tap sets the time, not HBM. Each lane's ldmatrix
// addresses are fixed per slot and each thread's copy offsets per band,
// which keeps address arithmetic out of the loops.
//
// Why no wgmma yet: the three 512^2 calls of the default train step are
// bound by bytes (0.2805 ms at batch 8 on an H100), and half that bound
// needs ~280 TFLOP/s, which mma.sync reaches. wgmma takes 64-row tiles
// from swizzled shared memory per warpgroup; it is the next step for the
// deep stages, which are bound by operations.

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

// ---------------------------------------------------------------- K5
constexpr int WG_WARPS = 9;                  // one warp per tap
constexpr int WG_THREADS = 32 * WG_WARPS;    // 288
constexpr int WG_DEPTH = 2;                  // rows in flight ahead of the one computed
constexpr int WG_XS = WG_DEPTH + 3;          // x slots: rows r-1..r+1 and WG_DEPTH ahead
constexpr int WG_DS = WG_DEPTH + 1;          // dy slots: row r and WG_DEPTH ahead
constexpr int WG_CO_T = 32;                  // output channels per block: 4 n8 tiles
constexpr int WG_DCH = WG_CO_T / 8;          // 16-byte chunks per dy pixel
constexpr int WG_TWK_MAX = 128;              // widest column tile
constexpr int WG_SLICES = 8;                 // pass 2: partial sums per output

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; ok == false reads nothing and
// writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x8 bf16 matrices, transposed; lane l gives the row address of
// matrix l / 8, row l % 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
        : "memory");
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte chunk u of a slot holding CH chunks a pixel: the
// chunk index is XORed, inside its 128-byte line, with the line's low bits,
// so the 8 row addresses of an ldmatrix (8 consecutive pixels, one chunk)
// fall in 8 different bank groups whatever the first pixel.
template <int CH>
__device__ __forceinline__ uint32_t swz(int u) {
    return static_cast<uint32_t>(u ^ ((u >> 3) & (CH - 1))) * 16u;
}

// 16-byte chunks in an x slot: TWK+2 pixels of CH chunks, whole lines.
__host__ __device__ constexpr int wg_x_units(int twk, int ch) {
    return ((twk + 2) * ch + 7) & ~7;
}

// K5, pass 1: grid (G, ceil(cin / CI_T), ceil(cout / 32)), WG_THREADS
// threads, dynamic shared memory for the ring. Block (g, i, j) adds the
// products of bands u = g, g+G, ... < units (u -> image, band, column tile
// with the column tile fastest) for input channels [i*CI_T, (i+1)*CI_T) and
// output channels [32j, 32j+32), and writes them to partial[g][tap][ci][co]
// ((G, 9, cinP, coutP), channels padded to whole tiles).
template <int MT>
__global__ void __launch_bounds__(WG_THREADS, 2) conv3x3_bf16_wgrad_ring(
    const bf16* __restrict__ x, const bf16* __restrict__ dy,
    float* __restrict__ partial, int H, int W, int cin, int cout, int R,
    int twk, int nbands, int nct, int units, int cinP, int coutP) {
    constexpr int CI_T = 16 * MT;
    constexpr int CH = CI_T / 8;        // 16-byte chunks per x pixel
    constexpr int NT = WG_CO_T / 8;     // n8 tiles
    constexpr int KU = MT >= 4 ? 2 : 4;  // 16-pixel steps unrolled (4 spills at MT 4)
    extern __shared__ __align__(128) uint4 wg_smem[];
    const int xu = wg_x_units(twk, CH), du = twk * WG_DCH;
    const uint32_t xs = smem_addr(wg_smem);
    const uint32_t ds = xs + WG_XS * xu * 16;

    const int g = blockIdx.x;
    const int ci0 = blockIdx.y * CI_T, co0 = blockIdx.z * WG_CO_T;
    const int tid = threadIdx.x, lane = tid & 31, tap = tid >> 5;
    const int ky = tap / 3, kx = tap - 3 * ky;
    // This lane's ldmatrix rows, as byte offsets into a slot at the first
    // 16-pixel step: A (x^T) matrices are (ci 0-7 | 8-15) x (pixels 0-7 |
    // 8-15) shifted by kx, B (dy) matrices (pixels 0-7 | 8-15) x (n8 tile).
    // Step k adds k * 16 pixels to both, which the swizzle leaves a plain
    // offset (16 pixels are whole 128-byte lines).
    uint32_t a_off[MT], b_off[NT / 2];
#pragma unroll
    for (int m = 0; m < MT; ++m)
        a_off[m] = swz<CH>((kx + (lane & 7) + 8 * (lane >> 4)) * CH + 2 * m +
                           ((lane >> 3) & 1));
#pragma unroll
    for (int j = 0; j < NT / 2; ++j)
        b_off[j] = swz<WG_DCH>(((lane & 7) + 8 * ((lane >> 3) & 1)) * WG_DCH +
                               2 * j + (lane >> 4));

    float acc[MT][NT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][t][e] = 0.0f;

    // the 16-byte chunks this thread copies into every x and dy slot: chunk
    // e = tid + j * WG_THREADS, its element offset in the image row, or -1
    // outside the image columns or channels (zero-filled)
    constexpr int XPER = ((WG_TWK_MAX + 2) * CH + WG_THREADS - 1) / WG_THREADS;
    constexpr int DPER = (WG_TWK_MAX * WG_DCH + WG_THREADS - 1) / WG_THREADS;
    const int x_chunks = (twk + 2) * CH, d_chunks = twk * WG_DCH;
    int xg[XPER], dg[DPER];

    for (int u = g; u < units; u += gridDim.x) {
        const int ct = u % nct, nb = u / nct;
        const int n = nb / nbands, y0 = (nb - n * nbands) * R;
        const int x0 = ct * twk;
        const int rows = min(R, H - y0);
        const int nk = min(twk, W - x0 + 15) >> 4;  // 16-pixel steps in the image
#pragma unroll
        for (int j = 0; j < XPER; ++j) {
            const int e = tid + j * WG_THREADS, p = e / CH;
            const int ix = x0 - 1 + p, ci = ci0 + 8 * (e - p * CH);
            xg[j] = ix >= 0 && ix < W && ci < cin ? ix * cin + ci : -1;
        }
#pragma unroll
        for (int j = 0; j < DPER; ++j) {
            const int e = tid + j * WG_THREADS, q = e / WG_DCH;
            const int ox = x0 + q, co = co0 + 8 * (e - q * WG_DCH);
            dg[j] = ox < W && co < cout ? ox * cout + co : -1;
        }

        // x row y0 - 1 + i into slot i % WG_XS (TWK+2 pixels from column x0-1)
        auto load_x = [&](int i) {
            const int iy = y0 - 1 + i;
            const bool row_in = iy >= 0 && iy < H;
            const bf16* src = x + ((size_t)n * H + (row_in ? iy : 0)) * W * cin;
            const uint32_t slot = xs + (i % WG_XS) * xu * 16;
#pragma unroll
            for (int j = 0; j < XPER; ++j) {
                const int e = tid + j * WG_THREADS;
                if (e < x_chunks) {
                    const bool ok = row_in && xg[j] >= 0;
                    cp_async16(slot + swz<CH>(e), ok ? src + xg[j] : x, ok);
                }
            }
        };
        // dy row y0 + s into slot s % WG_DS (TWK pixels from column x0)
        auto load_dy = [&](int s) {
            const bf16* src = dy + ((size_t)n * H + y0 + s) * W * cout;
            const uint32_t slot = ds + (s % WG_DS) * du * 16;
#pragma unroll
            for (int j = 0; j < DPER; ++j) {
                const int e = tid + j * WG_THREADS;
                if (e < d_chunks)
                    cp_async16(slot + swz<WG_DCH>(e),
                               dg[j] >= 0 ? src + dg[j] : dy, dg[j] >= 0);
            }
        };
        // copy group s: what output row s needs beyond row s-1's rows
        auto issue = [&](int s) {
            if (s < rows) {
                if (s == 0) {
                    load_x(0);
                    load_x(1);
                }
                load_x(s + 2);
                load_dy(s);
            }
            cp_async_commit();
        };

#pragma unroll
        for (int s = 0; s < WG_DEPTH; ++s) issue(s);
        for (int s = 0; s < rows; ++s) {
            cp_async_wait<WG_DEPTH - 1>();  // this thread's group s has landed
            __syncthreads();                // everyone's has; row s-1 is done
            issue(s + WG_DEPTH);            // into the slots row s-1 freed
            const uint32_t xrow = xs + ((s + ky) % WG_XS) * xu * 16;
            const uint32_t drow = ds + (s % WG_DS) * du * 16;
#pragma unroll (KU)
            for (int k = 0; k < nk; ++k) {
                const uint32_t xk = xrow + k * 256 * CH;
                const uint32_t dk = drow + k * 256 * WG_DCH;
                uint32_t b[NT][2];
#pragma unroll
                for (int j = 0; j < NT / 2; ++j) {
                    uint32_t r[4];
                    ldmatrix_x4_trans(r, dk + b_off[j]);
                    b[2 * j][0] = r[0];
                    b[2 * j][1] = r[1];
                    b[2 * j + 1][0] = r[2];
                    b[2 * j + 1][1] = r[3];
                }
#pragma unroll
                for (int m = 0; m < MT; ++m) {
                    uint32_t a[4];
                    ldmatrix_x4_trans(a, xk + a_off[m]);
#pragma unroll
                    for (int t = 0; t < NT; ++t)
                        mma_bf16(acc[m][t], a, b[t][0], b[t][1]);
                }
            }
        }
        __syncthreads();  // the next band's first copies reuse every slot
    }

    float* out = partial + ((size_t)g * 9 + tap) * cinP * coutP;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int t = 0; t < NT; ++t) {
            const int ci = ci0 + 16 * m + (lane >> 2);
            const int co = co0 + 8 * t + 2 * (lane & 3);
            *reinterpret_cast<float2*>(out + (size_t)ci * coutP + co) =
                make_float2(acc[m][t][0], acc[m][t][1]);
            *reinterpret_cast<float2*>(out + (size_t)(ci + 8) * coutP + co) =
                make_float2(acc[m][t][2], acc[m][t][3]);
        }
}

// K5, pass 2: dw[t][ci][co] = the sum over g of partial[g][t][ci][co], in a
// fixed order for a given G. With S = WG_SLICES (G >= 64) a block takes 32
// outputs: slice s of its 8 warps adds g = s, s+8, s+16, ... in turn, and
// the 8 slice sums are added pairwise. With S = 1 (the deep stages' few
// partials) a thread adds the G partials of its output in turn.
template <int S>
__global__ void __launch_bounds__(32 * WG_SLICES) conv3x3_bf16_wgrad_reduce(
    const float* __restrict__ partial, float* __restrict__ dw, int G, int cin,
    int cout, int cinP, int coutP) {
    __shared__ float sums[32 * WG_SLICES];
    static_assert(S == 1 || S == WG_SLICES, "one slice or WG_SLICES");
    constexpr int per = 32 * WG_SLICES / S;  // outputs a block
    const int j = threadIdx.x % per, s = threadIdx.x / per;
    const int i = blockIdx.x * per + j;
    const int total = 9 * cin * cout;
    float acc = 0.0f;
    if (i < total) {
        const int t = i / (cin * cout);
        const int r = i - t * cin * cout;
        const int ci = r / cout, co = r - ci * cout;
        const size_t stride = (size_t)9 * cinP * coutP;
        const float* p = partial + ((size_t)t * cinP + ci) * coutP + co;
#pragma unroll 4
        for (int gg = s; gg < G; gg += S) acc += p[gg * stride];
    }
    if constexpr (S == 1) {
        if (i < total) dw[i] = acc;
        return;
    }
    sums[threadIdx.x] = acc;
    __syncthreads();
    if (s == 0 && i < total) {
        const float* v = sums + j;
        dw[i] = ((v[0] + v[32]) + (v[64] + v[96])) +
                ((v[128] + v[160]) + (v[192] + v[224]));
    }
}

template <int MT>
int launch_wgrad_ring(dim3 grid, cudaStream_t s, const bf16* x,
                      const bf16* dy, float* partial, int H, int W, int cin,
                      int cout, int R, int twk, int nbands, int nct, int units,
                      int cinP, int coutP) {
    const size_t smem =
        (size_t)16 * (WG_XS * wg_x_units(twk, 2 * MT) + WG_DS * twk * WG_DCH);
    cudaError_t err = cudaFuncSetAttribute(
        conv3x3_bf16_wgrad_ring<MT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    conv3x3_bf16_wgrad_ring<MT><<<grid, WG_THREADS, smem, s>>>(
        x, dy, partial, H, W, cin, cout, R, twk, nbands, nct, units, cinP,
        coutP);
    return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- K4, mma.sync
constexpr int MW = 4;                  // tile rows (m16 tiles) a warp
constexpr int M_WARPS = 8;
constexpr int M_THREADS = 32 * M_WARPS;  // 256
constexpr int ROWS = M_WARPS * MW;     // output tile rows
constexpr int COLS = 16;               // output tile columns: one m16 tile
constexpr int HALO_W = COLS + 2;       // halo columns
constexpr int HR = ROWS + 2;           // halo rows
constexpr int KCH = 32;                // bytes of K a chunk: 16 bf16 channels
constexpr int PITCH = HALO_W * KCH;    // bytes a halo row of one chunk
constexpr int HALO = HR * PITCH;       // bytes of one chunk's halo

// Four 8x8 b16 matrices (8 rows of 16 bytes each); lane l gives the row
// address of matrix l / 8, row l % 8, and receives 4 bytes of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
        : "memory");
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate; not
// volatile (as K7's mma_s8), so the compiler may schedule the products
// among the ldmatrix reads.
__device__ __forceinline__ void mma_bf16_sched(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte unit u (0 or 1) of 32-byte row p within a run of
// rows: the unit index 2p + u with its low bit XORed with bit 2 of p, so
// that 8 consecutive rows at one u fill 8 different bank groups.
__device__ __forceinline__ uint32_t swz(int p, int u) {
    return static_cast<uint32_t>((2 * p + u) ^ ((p >> 2) & 1)) * 16u;
}

// The products of one K chunk (the 3 x 3 taps) for a warp's M tile rows.
// For each kx: the B fragments of the taps (0..2, kx) (ldmatrix from each
// tap's N x 32 bytes at b_base), then each of the M + 2 halo rows r that
// the tile rows read at that kx (ldmatrix at a_rows + r * RP + a_col[kx]),
// multiplied into every tile row m = r - ky it serves: a halo row is read
// once for up to three taps.
template <int M, int NT, int RP>
__device__ __forceinline__ void mma_chunk(float (&acc)[M][NT][4],
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
                    mma_bf16_sched(acc[m][t], a, b[ky][t][0], b[ky][t][1]);
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

// Round the accumulators once to bf16 into the tile os (ROWS x COLS
// pixels, rows of 2N + 16 bytes), then write y from it in 16-byte chunks
// (8 channels; cout % 8 == 0).
template <int NT>
__device__ __forceinline__ void epilogue(const float (&acc)[MW][NT][4],
                                         uint8_t* os, bf16* __restrict__ y,
                                         int n, int H, int W, int y0, int x0,
                                         int co0, int cout) {
    constexpr int N_T = NT * 8, OP = 2 * N_T + 16, UPP = N_T / 8;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
        const int c = 8 * t + 2 * (lane & 3);
#pragma unroll
        for (int m = 0; m < MW; ++m)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int px = (warp * MW + m) * COLS + (lane >> 2) + 8 * h;
                *reinterpret_cast<__nv_bfloat162*>(os + px * OP + 2 * c) =
                    __halves2bfloat162(__float2bfloat16_rn(acc[m][t][2 * h]),
                                       __float2bfloat16_rn(acc[m][t][2 * h + 1]));
            }
    }
    __syncthreads();
    for (int e = tid; e < ROWS * COLS * UPP; e += M_THREADS) {
        const int px = e / UPP, u = e - px * UPP;
        const int oy = y0 + px / COLS, ox = x0 + px % COLS, co = co0 + 8 * u;
        if (oy < H && ox < W && co < cout)
            *reinterpret_cast<uint4*>(y + (((size_t)n * H + oy) * W + ox) * cout + co) =
                *reinterpret_cast<const uint4*>(os + px * OP + 16 * u);
    }
}

// K4, mma.sync body: grid (tiles * n_co, N), the channel tile fastest (so
// the blocks of one tile's channel tiles run side by side and the second
// read of its input comes from L2), M_THREADS threads, dynamic shared
// memory of `stages` ring slots (halo chunk, then weights); the
// epilogue's tile reuses the ring. w: (nk, 9, coutp, 16) bf16.
template <int NT>
__global__ void __launch_bounds__(M_THREADS, NT == 4 ? 2 : 1) conv3x3_bf16_mma(
    const bf16* __restrict__ x, const bf16* __restrict__ w,
    bf16* __restrict__ y, int H, int W, int cin, int cout, int coutp, int nk,
    int stages, int tiles_x, int n_co) {
    constexpr int N_T = NT * 8, STAGE = HALO + 9 * N_T * KCH;
    extern __shared__ __align__(128) uint8_t k4_smem[];
    const uint32_t base = smem_addr(k4_smem);

    const int n = blockIdx.y, tile = blockIdx.x / n_co;
    const int co0 = (blockIdx.x - tile * n_co) * N_T;
    const int ty0 = (tile / tiles_x) * ROWS;  // the tile's origin
    const int tx0 = (tile % tiles_x) * COLS;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    uint32_t a_col[3], b_off[NT / 2];
    lane_offsets<NT>(lane, a_col, b_off);

    float acc[MW][NT][4];
#pragma unroll
    for (int m = 0; m < MW; ++m)
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][t][e] = 0.0f;

    // copy group j: chunk j's halo (pixel rows y0-1.., columns x0-1..) and
    // weights into ring slot j % stages
    auto issue = [&](int j) {
        if (j < nk) {
            const uint32_t off = (j % stages) * STAGE;
            for (int e = tid; e < HR * HALO_W * 2; e += M_THREADS) {
                const int u = e & 1, p = e >> 1;
                const int hr = p / HALO_W, hc = p - hr * HALO_W;
                const int iy = ty0 - 1 + hr, ix = tx0 - 1 + hc;
                const bool in = iy >= 0 && iy < H && ix >= 0 && ix < W;
                const size_t pix = in ? ((size_t)n * H + iy) * W + ix : 0;
                cp_async16(base + off + hr * PITCH + swz(hc, u),
                           in ? x + pix * cin + 16 * j + 8 * u : x, in);
            }
            const bf16* wj = w + (size_t)j * 9 * coutp * 16;
            for (int e = tid; e < 9 * N_T * 2; e += M_THREADS) {
                const int u = e & 1, r = e >> 1;
                const int tap = r / N_T, co = r - tap * N_T;
                cp_async16(base + off + HALO + tap * N_T * KCH + swz(co, u),
                           wj + ((size_t)tap * coutp + co0 + co) * 16 + 8 * u,
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
                                 slot + HALO, b_off);
    }
    cp_async_wait<0>();
    __syncthreads();  // the epilogue's tile reuses the ring
    epilogue<NT>(acc, k4_smem, y, n, H, W, ty0, tx0, co0, cout);
}

// Dynamic shared memory of one mma.sync block (ops/conv_bf16.py:mma_smem).
int mma_smem_bytes(int co_t, int stages) {
    const int ring = stages * (HALO + 9 * co_t * KCH);
    const int out = ROWS * COLS * (2 * co_t + 16);
    return ring > out ? ring : out;  // the tile reuses the ring
}

template <int NT>
int launch_mma(const bf16* x, const bf16* w, bf16* y, int N, int H, int W,
               int cin, int cout, int coutp, int nk, int stages, int smem,
               cudaStream_t s) {
    const int tiles_x = (W + COLS - 1) / COLS, tiles_y = (H + ROWS - 1) / ROWS;
    const int n_co = coutp / (NT * 8);
    cudaError_t err = cudaFuncSetAttribute(
        conv3x3_bf16_mma<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    conv3x3_bf16_mma<NT><<<dim3(tiles_x * tiles_y * n_co, N), M_THREADS, smem, s>>>(
        x, w, y, H, W, cin, cout, coutp, nk, stages, tiles_x, n_co);
    return static_cast<int>(cudaGetLastError());
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

// K4's mma.sync body. x: (N, H, W, cin) bf16, cin % 16 == 0; w: (nk, 9,
// coutp, 16) bf16 (ops/conv_bf16.py:pack_conv3x3_bf16_weights); y: (N, H,
// W, cout) bf16, cout % 8 == 0; all contiguous and 16-byte aligned. The
// plan (ops/conv_bf16.py:fwd_plan) gives co_t (32 or 64 output channels a
// block), nk = cin / 16, stages (2 or 3 ring slots) and smem (dynamic
// shared memory bytes). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the plan would not give.
extern "C" int octseg_conv3x3_bf16_mma(const void* x, const void* w, void* y,
                                       int N, int H, int W, int cin, int cout,
                                       int coutp, int co_t, int nk, int stages,
                                       int smem, void* stream) {
    const long long blocks = (long long)((H + ROWS - 1) / ROWS) *
                             ((W + COLS - 1) / COLS) *
                             (co_t > 0 ? coutp / co_t : 0);
    const bool bad =
        N < 1 || N > 65535 || H < 1 || W < 1 || cin < 16 || cin % 16 != 0 ||
        nk != cin / 16 || cout < 1 || cout % 8 != 0 ||
        (co_t != 32 && co_t != 64) || coutp % co_t != 0 || coutp < cout ||
        coutp - cout >= co_t || (stages != 2 && stages != 3) ||
        blocks > 0x7fffffffLL || !aligned16(x) || !aligned16(w) ||
        !aligned16(y) || smem != mma_smem_bytes(co_t, stages);
    if (bad) return static_cast<int>(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    auto xp = static_cast<const bf16*>(x);
    auto wp = static_cast<const bf16*>(w);
    auto yp = static_cast<bf16*>(y);
    if (co_t == 64)
        return launch_mma<8>(xp, wp, yp, N, H, W, cin, cout, coutp, nk, stages, smem, s);
    return launch_mma<4>(xp, wp, yp, N, H, W, cin, cout, coutp, nk, stages, smem, s);
}

// K5. x: (N, H, W, cin) bf16, dy: (N, H, W, cout) bf16, both 16-byte
// aligned with cin, cout % 8 == 0 (the wrapper pads the channels); the plan
// (ops/conv_bf16.py:wgrad_plan): G blocks per channel tile, bands of R rows,
// column tiles of twk pixels (a multiple of 16, <= 128), ci_t input
// channels a block (16, 32 or 64). partial: fp32 scratch of (G, 9, cinP,
// coutP), cinP = cin rounded up to ci_t, coutP = cout rounded up to 32; dw:
// (3, 3, cin, cout) fp32. Two launches; returns the first CUDA error.
extern "C" int octseg_conv3x3_bf16_wgrad(const void* x, const void* dy,
                                         void* partial, void* dw, int N,
                                         int H, int W, int cin, int cout,
                                         int G, int R, int twk, int ci_t,
                                         void* stream) {
    if (cin % 8 != 0 || cout % 8 != 0 || !aligned16(x) || !aligned16(dy) ||
        twk < 16 || twk > WG_TWK_MAX || twk % 16 != 0 || R < 1 || G < 1 ||
        (ci_t != 16 && ci_t != 32 && ci_t != 64))
        return static_cast<int>(cudaErrorInvalidValue);
    const int nbands = (H + R - 1) / R, nct = (W + twk - 1) / twk;
    const int units = N * nbands * nct;
    const int n_ci = (cin + ci_t - 1) / ci_t;
    const int n_co = (cout + WG_CO_T - 1) / WG_CO_T;
    const int cinP = n_ci * ci_t, coutP = n_co * WG_CO_T;
    const dim3 grid(G, n_ci, n_co);
    auto s = static_cast<cudaStream_t>(stream);
    auto xp = static_cast<const bf16*>(x);
    auto dp = static_cast<const bf16*>(dy);
    auto pp = static_cast<float*>(partial);
    int err;
    if (ci_t == 16)
        err = launch_wgrad_ring<1>(grid, s, xp, dp, pp, H, W, cin, cout, R, twk, nbands, nct, units, cinP, coutP);
    else if (ci_t == 32)
        err = launch_wgrad_ring<2>(grid, s, xp, dp, pp, H, W, cin, cout, R, twk, nbands, nct, units, cinP, coutP);
    else
        err = launch_wgrad_ring<4>(grid, s, xp, dp, pp, H, W, cin, cout, R, twk, nbands, nct, units, cinP, coutP);
    if (err != 0) return err;
    const int total = 9 * cin * cout;
    auto dwp = static_cast<float*>(dw);
    if (G >= 64)
        conv3x3_bf16_wgrad_reduce<WG_SLICES><<<(total + 31) / 32, 32 * WG_SLICES, 0, s>>>(
            pp, dwp, G, cin, cout, cinP, coutP);
    else
        conv3x3_bf16_wgrad_reduce<1><<<(total + 32 * WG_SLICES - 1) / (32 * WG_SLICES), 32 * WG_SLICES, 0, s>>>(
            pp, dwp, G, cin, cout, cinP, coutP);
    return static_cast<int>(cudaGetLastError());
}
