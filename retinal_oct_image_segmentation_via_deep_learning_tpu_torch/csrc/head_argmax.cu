// K3: 1x1 int8 classifier head fused with the per-pixel argmax, NHWC int8
// in, int8 labels out.
//
// Replaces ops/pallas_conv_psrp.py:head_argmax_psrp and
// ops/pallas_conv_packed.py:head_argmax_packed.
//
// Function, per pixel p: acc[k] = sum_c x[p,c] * w[k,c] in int32, logit
// z[k] = fmaf(float(acc[k]), scale[k], bias[k]) (no round, no clip), label =
// argmax_k z[k] with ties to the lowest class. The logits never leave
// registers.
//
// Bound on the card: reading the input (cin bytes a pixel) from device
// memory. A thread that owns a pixel and reads it with cin/4 word loads
// (lanes cin bytes apart) and the weights from shared memory is held by
// the load/shared-memory pipe instead, so the products go to the tensor
// cores and the bytes come in 16-byte copies:
// - a persistent grid (no more blocks than the card holds at once) walks
//   tiles of TP contiguous pixels; each tile (TP*cin bytes) is copied by
//   cp.async into a ring of STAGES slots, the next tiles in flight while
//   one is computed. In a slot, k-step s (channels 32s..32s+31) of pixel p
//   is a 32-byte row at s*TP*32 + swz(p, .), so that ldmatrix reads 8 rows
//   in 8 bank groups. Copies are 16 bytes where cin % 16 == 0, else 4; a
//   pixel past P is zero-filled (source size 0). Channels past cin in a row
//   are never written: their weights are zero, so they add nothing;
// - int8 mma.sync m16n8k32: A is 16 pixels x 32 channels (ldmatrix_x4), B
//   32 channels x 8 classes, KS = ceil(cin/32) k-steps, NT = ceil(nc/8) n8
//   tiles. B's fragments come straight from pack_head_weights' (nc, cin)
//   array (column n of B is row n there: lane (g, q) reads the words at
//   class 8t + g, channels 32s + 4q and 32s + 16 + 4q) and stay in
//   registers for the whole kernel, zero past nc and cin;
// - the epilogue in registers: lane (g, q) holds classes 8t + 2q + j of
//   pixels g and g + 8. The pixel's largest logit is the max over the
//   lane's columns, then over the quad (two xor shuffles, 1 and 2); its
//   label is the lowest class whose logit equals that max: the lane's
//   lowest such column, then the quad's least (two more shuffles), which
//   is argmax with ties to the lowest class. Padded classes are left out
//   by their index (k < nc). The sums reach float through the
//   accumulators' start value (MAGIC), not a conversion instruction;
// - each warp owns 32 pixels of a tile (two m16 groups); its labels go to
//   a 32-byte staging row in shared memory and leave as two 16-byte stores
//   (byte stores at a ragged end).

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_int8.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TP = 256;      // pixels a tile: 32 a warp, two m16 groups
constexpr int STAGES = 3;    // slots of the ring
static_assert(TP == THREADS, "a thread copies cin / 16 chunks of a tile");
constexpr int MAX_KS = 2;    // cin <= 64
constexpr int MAX_NT = 4;    // nc <= 32
constexpr int MAX_CLASSES = 8 * MAX_NT;
// Each accumulator starts at the bits of 1.5 * 2^23 (MAGIC): the products
// add the int32 sum s (|s| <= 64 * 128 * 128 = 2^20 < 2^22) to the float's
// mantissa, so the float, less 1.5 * 2^23, is float(s) exactly, without a
// conversion instruction (I2F runs at a quarter of the FMA rate)
constexpr int MAGIC = 0x4B400000;
constexpr float MAGIC_F = 12582912.0f;

// 4 bytes from global to shared memory (cin % 16 != 0); ok == false reads
// nothing and writes 4 zero bytes.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

// The 16-byte chunks a thread copies of every tile where cin % 16 == 0:
// chunk c = threadIdx.x + i * THREADS (i < cin / 16, as TP == THREADS) is
// bytes [16c, 16c + 16) of the tile, unit v = c % (cin / 16) of pixel p =
// c / (cin / 16), and lands in k-step row v / 2 at unit v % 2. Set once.
template <int KS>
struct Chunks {
    uint32_t dst[2 * KS];  // offset in the slot
    int pix[2 * KS];       // pixel in the tile
};

// Tile `tile`'s pixels into the slot: 16-byte chunks where cin % 16 == 0,
// else words (word v of pixel p: k-step row v / 8, unit (v / 4) % 2).
template <int KS>
__device__ __forceinline__ void load_tile(const int8_t* __restrict__ x,
                                          uint32_t slot, long long tile,
                                          long long P, int cin,
                                          const Chunks<KS>& ch) {
    const long long p0 = tile * TP;
    if (cin % 16 == 0) {
        const int8_t* tb = x + p0 * cin + 16 * threadIdx.x;
        const long long left = P - p0;
#pragma unroll
        for (int i = 0; i < 2 * KS; ++i)
            if (16 * i < cin) {
                const bool ok = ch.pix[i] < left;
                cp_async16(slot + ch.dst[i], ok ? tb + 16 * THREADS * i : x,
                           ok);
            }
    } else {
        const int cpp = cin / 4;
        for (int c = threadIdx.x; c < TP * cpp; c += THREADS) {
            const int p = c / cpp, v = c - p * cpp;
            const bool ok = p0 + p < P;
            cp_async4(slot + (v >> 3) * TP * 32 + swz(p, (v >> 2) & 1)
                          + 4 * (v & 3),
                      ok ? x + (p0 + p) * cin + 4 * v : x, ok);
        }
    }
}

template <int KS, int NT>
__global__ void __launch_bounds__(THREADS) head_argmax_mma(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, const float* __restrict__ bias,
    int8_t* __restrict__ y, long long P, int cin, int nc, long long tiles) {
    extern __shared__ __align__(16) unsigned char smem[];
    constexpr int SLOT = TP * KS * 32;
    const uint32_t ring = smem_addr(smem);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, q = lane & 3;
    const float neg_inf = __int_as_float(0xff800000);
    unsigned char* stage = smem + STAGES * SLOT + 32 * warp;

    // B fragments, and the scales and biases of the lane's columns
    uint32_t b[KS][NT][2];
    float sc[NT][2], bi[NT][2];
    bool ok[NT][2];  // the lane's column j of tile t is a class (k < nc)
#pragma unroll
    for (int t = 0; t < NT; ++t) {
        const int n = 8 * t + g;
#pragma unroll
        for (int s = 0; s < KS; ++s)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int k = 32 * s + 16 * h + 4 * q;
                b[s][t][h] = n < nc && k < cin
                    ? *reinterpret_cast<const uint32_t*>(w + n * cin + k) : 0u;
            }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const int k = 8 * t + 2 * q + j;
            ok[t][j] = k < nc;
            sc[t][j] = ok[t][j] ? scale[k] : 0.0f;
            bi[t][j] = ok[t][j] ? bias[k] : 0.0f;
        }
    }
    Chunks<KS> ch;
    if (cin % 16 == 0) {
        const int cpp = cin / 16;
#pragma unroll
        for (int i = 0; i < 2 * KS; ++i) {
            const int c = threadIdx.x + i * THREADS, p = c / cpp;
            const int v = c - p * cpp;
            ch.dst[i] = (v >> 1) * TP * 32 + swz(p, v & 1);
            ch.pix[i] = p;
        }
    }
    // the lane's ldmatrix row: matrix lane / 8 is rows 0-7 / 8-15 of the
    // group at unit 0, then the same at unit 1
    const uint32_t a_off =
        swz(32 * warp + (lane & 7) + 8 * ((lane >> 3) & 1), lane >> 4);

    const long long stride = gridDim.x;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        const long long tile = blockIdx.x + s * stride;
        if (tile < tiles) load_tile<KS>(x, ring + s * SLOT, tile, P, cin, ch);
        cp_async_commit();
    }
    int slot = 0;
    for (long long tile = blockIdx.x; tile < tiles; tile += stride) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();  // this tile landed; the slot below is free
        {
            const long long next = tile + (STAGES - 1) * stride;
            const int free_slot = slot == 0 ? STAGES - 1 : slot - 1;
            if (next < tiles)
                load_tile<KS>(x, ring + free_slot * SLOT, next, P, cin, ch);
            cp_async_commit();
        }
        const uint32_t base = ring + slot * SLOT + a_off;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
            int acc[NT][4];
#pragma unroll
            for (int t = 0; t < NT; ++t)
                acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = MAGIC;
#pragma unroll
            for (int s = 0; s < KS; ++s) {
                uint32_t a[4];
                ldmatrix_x4(a, base + s * TP * 32 + m * 16 * 32);
#pragma unroll
                for (int t = 0; t < NT; ++t)
                    mma_s8(acc[t], a, b[s][t][0], b[s][t][1]);
            }
            // the pixel's largest logit: over the lane's columns (a padded
            // class is left out by its index), then over the quad
            float v[NT][4];
            float zm[2] = {neg_inf, neg_inf};
#pragma unroll
            for (int t = 0; t < NT; ++t)
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    v[t][r] = __fmaf_rn(
                        __fsub_rn(__int_as_float(acc[t][r]), MAGIC_F),
                        sc[t][r & 1], bi[t][r & 1]);
                    if (ok[t][r & 1]) zm[r >> 1] = fmaxf(zm[r >> 1], v[t][r]);
                }
#pragma unroll
            for (int o = 1; o <= 2; o <<= 1)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    zm[h] = fmaxf(zm[h],
                                  __shfl_xor_sync(0xffffffffu, zm[h], o));
            // the label: the lowest class whose logit equals it (the lane's
            // columns in descending k, then the quad's least)
            int arg[2] = {MAX_CLASSES, MAX_CLASSES};
#pragma unroll
            for (int t = NT - 1; t >= 0; --t)
#pragma unroll
                for (int r = 3; r >= 0; --r)
                    if (ok[t][r & 1] && v[t][r] == zm[r >> 1])
                        arg[r >> 1] = 8 * t + 2 * q + (r & 1);
#pragma unroll
            for (int o = 1; o <= 2; o <<= 1)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    arg[h] = min(arg[h],
                                 __shfl_xor_sync(0xffffffffu, arg[h], o));
            // no class reaches the max only where no logit is a number:
            // class 0 then, as a strict scan from class 0 would give
            if (q == 0) {
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    stage[16 * m + g + 8 * h] = static_cast<unsigned char>(
                        arg[h] < MAX_CLASSES ? arg[h] : 0);
            }
        }
        __syncwarp();
        if (lane < 2) {
            const long long p = tile * TP + 32 * warp + 16 * lane;
            if (p + 16 <= P) {
                *reinterpret_cast<uint4*>(y + p) =
                    *reinterpret_cast<const uint4*>(stage + 16 * lane);
            } else {
                for (int j = 0; p + j < P; ++j)
                    y[p + j] = static_cast<int8_t>(stage[16 * lane + j]);
            }
        }
        slot = slot == STAGES - 1 ? 0 : slot + 1;
    }
}

using Kernel = void (*)(const int8_t*, const int8_t*, const float*,
                        const float*, int8_t*, long long, int, int,
                        long long);

template <int KS>
Kernel kernel_nt(int nt) {
    switch (nt) {
        case 1: return head_argmax_mma<KS, 1>;
        case 2: return head_argmax_mma<KS, 2>;
        case 3: return head_argmax_mma<KS, 3>;
        default: return head_argmax_mma<KS, 4>;
    }
}

// The instance for cin (<= 64) and nc (<= 32), and its shared memory.
Kernel kernel_for(int cin, int nc, int* smem) {
    const int ks = (cin + 31) / 32, nt = (nc + 7) / 8;
    *smem = STAGES * TP * ks * 32 + 32 * WARPS;  // the ring, the staging rows
    return ks == 1 ? kernel_nt<1>(nt) : kernel_nt<2>(nt);
}

bool refused(int cin, int nc) {
    return cin < 4 || cin % 4 != 0 || cin > 32 * MAX_KS || nc < 1 ||
           nc > MAX_CLASSES;
}

}  // namespace

// x: (P, cin) int8, 16-byte aligned; w: (nc, cin) int8 (pack_head_weights),
// 4-byte aligned; scale, bias: (nc,) fp32; y: (P,) int8, 16-byte aligned.
// cin a multiple of 4, <= 64; 1 <= nc <= 32; grid <= the co-resident
// blocks (octseg_head_argmax_resident). Returns cudaGetLastError() after
// the launch (0 = launched); cudaErrorInvalidValue for what it cannot take.
extern "C" int octseg_head_argmax(const void* x, const void* w,
                                  const void* scale, const void* bias,
                                  void* y, long long P, int cin, int nc,
                                  int grid, void* stream) {
    if (refused(cin, nc) || grid < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    int smem = 0;
    const Kernel k = kernel_for(cin, nc, &smem);
    const cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long tiles = (P + TP - 1) / TP;
    k<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<int8_t*>(y), P, cin, nc, tiles);
    return static_cast<int>(cudaGetLastError());
}

// *blocks = the blocks of the instance for (cin, nc) that the card holds
// at once (the occupancy API's blocks an SM times the SMs).
extern "C" int octseg_head_argmax_resident(int cin, int nc, void* blocks) {
    if (refused(cin, nc)) return static_cast<int>(cudaErrorInvalidValue);
    int smem = 0, dev = 0, sms = 0, per_sm = 0;
    const Kernel k = kernel_for(cin, nc, &smem);
    cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, THREADS,
                                                            smem);
    *static_cast<int*>(blocks) = per_sm * sms;
    return static_cast<int>(err);
}
