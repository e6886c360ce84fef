// K6: per-channel pair of sums for the training BatchNorm, in fp32.
//
// Replaces ops/fused_bn.py:_pallas_pair_sums (the _sum_kernel(two_inputs)
// family): over the rows of a channels-last (M, C) tensor,
//   forward mode:  out = [sum_m a[m,c], sum_m a[m,c]^2]
//   backward mode: out = [sum_m a[m,c], sum_m a[m,c] * b[m,c]]   (a = dy, b = x)
// The TPU kernel wrote one (2, C) partial per grid step and let XLA sum
// them. Here one cooperative launch does both levels:
//
// - pass 1: a lane owns VEC consecutive channels (VEC = 8 where C % 8 == 0:
//   one 16-byte load a row for bf16, two for fp32; else VEC = 1) and walks
//   its rows, 4 or 8 rows' loads in flight before the adds (UNROLL), into
//   one Kahan pair (s, e) a channel and product. The block joins the pairs
//   of the lanes that share a channel by a fixed tree in shared memory,
//   adding pairs by a two-sum (each level's additions dealt over all its
//   threads), and writes its (s, e) partial to its own slot;
// - a grid-wide barrier (the grid fits on the card at once: the plan
//   takes no more blocks than the occupancy API allows);
// - pass 2: each of the 2C outputs is taken by one warp, whose lanes join
//   the partials in fixed strides and then by a fixed shuffle tree.
//
// No float atomics, and each partial has its own slot, so the order of
// every addition is a function of the plan (ops/fused_bn.py:pair_sums_plan)
// alone, whichever block finishes first: the sums, and a training step,
// are reproducible bit for bit. The compensation is kept through both
// trees, so the result is within about one fp32 ulp of the exact sum for
// well-conditioned data. Products are rounded by __fmul_rn, never fused
// into the add (a numpy emulation of this order matches the kernel bit for
// bit: tests/test_torch_k6_order.py).
//
// Bound on the card: the bytes read (each input element once; about ten
// fp32 operations an element, a fraction of the issue rate).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;  // a block (ops/fused_bn.py: THREADS)

// (s, e) holds the value s + e; add v (Kahan).
__device__ __forceinline__ void kahan_add(float& s, float& e, float v) {
    const float y = v + e;
    const float t = s + y;
    e = y - (t - s);
    s = t;
}

// (s, e) += (s2, e2): the exact error of s + s2 (Knuth's two-sum) joins the
// two compensations, then the pair is renormalised.
__device__ __forceinline__ void pair_add(float& s, float& e, float s2,
                                         float e2) {
    const float t = s + s2;
    const float z = t - s;
    const float err = (s - (t - z)) + (s2 - z);
    const float f = (e + e2) + err;
    s = t + f;
    e = f - (s - t);
}

// VEC consecutive channels of one row as loaded.
template <typename T, int VEC>
struct Chunk;

template <>
struct Chunk<__nv_bfloat16, 8> {
    uint4 u;
    __device__ __forceinline__ void load(const __nv_bfloat16* p) {
        u = __ldg(reinterpret_cast<const uint4*>(p));
    }
    __device__ __forceinline__ float at(int j) const {
        const unsigned w = j < 2 ? u.x : j < 4 ? u.y : j < 6 ? u.z : u.w;
        return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
    }
};

template <>
struct Chunk<float, 8> {
    float4 lo, hi;
    __device__ __forceinline__ void load(const float* p) {
        lo = __ldg(reinterpret_cast<const float4*>(p));
        hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
    }
    __device__ __forceinline__ float at(int j) const {
        const float4& q = j < 4 ? lo : hi;
        const int k = j & 3;
        return k == 0 ? q.x : k == 1 ? q.y : k == 2 ? q.z : q.w;
    }
};

template <>
struct Chunk<__nv_bfloat16, 1> {
    unsigned short u;
    __device__ __forceinline__ void load(const __nv_bfloat16* p) {
        u = __ldg(reinterpret_cast<const unsigned short*>(p));
    }
    __device__ __forceinline__ float at(int) const {
        return __uint_as_float(static_cast<unsigned>(u) << 16);
    }
};

template <>
struct Chunk<float, 1> {
    float v;
    __device__ __forceinline__ void load(const float* p) { v = __ldg(p); }
    __device__ __forceinline__ float at(int) const { return v; }
};

// acc[j] = (s0, e0, s1, e1) of channel j of the lane's group.
template <typename T, int VEC>
__device__ __forceinline__ void add_row(float (&acc)[VEC][4],
                                        const Chunk<T, VEC>& x,
                                        const Chunk<T, VEC>& y) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
        const float av = x.at(j);
        kahan_add(acc[j][0], acc[j][1], av);
        kahan_add(acc[j][2], acc[j][3], __fmul_rn(av, y.at(j)));
    }
}

// Rows a lane has in flight: at VEC = 8, 128 bytes of loads a thread but
// in fp32 backward (256); more would not fit two blocks an SM.
template <typename T, bool TWO>
constexpr int UNROLL = (TWO || sizeof(T) == 4) ? 4 : 8;
constexpr int PASS2_LOADS = 8;  // partials a lane has in flight in pass 2

// Rows r, r + rows_step, ... (fewer than UNROLL + 1 steps: below r1) of a
// lane added in that order, all their loads issued first.
template <typename T, bool TWO, int VEC>
__device__ __forceinline__ void add_rows(float (&acc)[VEC][4], const T* pa,
                                         const T* pb, long long r,
                                         long long r1, int rows_step, int C,
                                         bool full) {
    constexpr int U = UNROLL<T, TWO>;
    Chunk<T, VEC> xa[U], xb[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
        if (full || r + (long long)u * rows_step < r1) {
            const long long row = (r + (long long)u * rows_step) * C;
            xa[u].load(pa + row);
            if constexpr (TWO) xb[u].load(pb + row);
        }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
        if (full || r + (long long)u * rows_step < r1) {
            if constexpr (TWO) add_row(acc, xa[u], xb[u]);
            else add_row(acc, xa[u], xa[u]);
        }
    }
}

// grid (G), block (THREADS): thread t = ry * lanes + lane holds row ry of
// the block step and channel group c0 + lane. part: fp32 [2][2C][G], the s
// plane then the e plane, output i = k * C + c of block g at [i * G + g].
template <typename T, bool TWO, int VEC>
__global__ void __launch_bounds__(THREADS, 2) pair_sums_kernel(
    const T* __restrict__ a, const T* __restrict__ b,
    float* __restrict__ part, float* __restrict__ out, long long M, int C,
    int lanes, int rows_step, long long rows_block) {
    constexpr int U = UNROLL<T, TWO>;
    __shared__ float sh[4 * VEC][THREADS];
    const int t = threadIdx.x, g = blockIdx.x, G = gridDim.x;
    const int lane = t % lanes, ry = t / lanes;
    const int groups = C / VEC;
    const long long r0 = (long long)g * rows_block;
    const long long r1 = min(M, r0 + rows_block);
    const size_t plane = (size_t)2 * C * G;

    // ------------------------------------------------------------ pass 1
    for (int c0 = 0; c0 < groups; c0 += lanes) {
        const int cgp = c0 + lane;
        float acc[VEC][4];
#pragma unroll
        for (int j = 0; j < VEC; ++j)
            acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
        if (ry < rows_step && cgp < groups) {
            const T* pa = a + (size_t)cgp * VEC;
            const T* pb = b + (size_t)cgp * VEC;
            long long r = r0 + ry;
            for (; r + (long long)(U - 1) * rows_step < r1; r += U * rows_step)
                add_rows<T, TWO, VEC>(acc, pa, pb, r, r1, rows_step, C, true);
            if (r < r1)
                add_rows<T, TWO, VEC>(acc, pa, pb, r, r1, rows_step, C, false);
        }
        // the block's tree over the rows_step lanes of each channel group:
        // item i += item i + h (h = ceil(n / 2)) for i < n - h, until one is
        // left; item i of channel group lane at sh[.][i * lanes + lane], a
        // level's 2 * VEC pair additions an item dealt over all the block's
        // threads
#pragma unroll
        for (int k = 0; k < 4 * VEC; ++k) sh[k][t] = acc[k / 4][k % 4];
        for (int n = rows_step; n > 1;) {
            const int h = (n + 1) / 2;
            const int span = (n - h) * lanes;
            __syncthreads();
            for (int job = t; job < span * 2 * VEC; job += THREADS) {
                const int q = job / span, u = job - q * span;
                float s = sh[2 * q][u], e = sh[2 * q + 1][u];
                pair_add(s, e, sh[2 * q][u + h * lanes],
                         sh[2 * q + 1][u + h * lanes]);
                sh[2 * q][u] = s;
                sh[2 * q + 1][u] = e;
            }
            n = h;
        }
        __syncthreads();
        // the partial: sh[4j + 2p + w][lane] (w: s or e) of output
        // p * C + (c0 + lane) * VEC + j
        for (int job = t; job < 4 * VEC * lanes; job += THREADS) {
            const int k = job / lanes, l = job - k * lanes;
            if (c0 + l < groups) {
                const size_t i = (size_t)(k / 2 % 2) * C
                                 + (size_t)(c0 + l) * VEC + k / 4;
                part[(k % 2) * plane + i * G + g] = sh[k][l];
            }
        }
        __syncthreads();
    }

    // ------------------------------------------------------------ pass 2
    cg::this_grid().sync();
    const int warp = t >> 5, wl = t & 31;
    for (int i = g + G * warp; i < 2 * C; i += G * (THREADS / 32)) {
        const float* ps = part + (size_t)i * G;
        const float* pe = ps + plane;
        float s = 0.0f, e = 0.0f;
        for (int q0 = wl; q0 < G; q0 += 32 * PASS2_LOADS) {
            float vs[PASS2_LOADS], ve[PASS2_LOADS];
#pragma unroll
            for (int u = 0; u < PASS2_LOADS; ++u) {
                const int q = q0 + 32 * u;
                vs[u] = q < G ? __ldcg(ps + q) : 0.0f;
                ve[u] = q < G ? __ldcg(pe + q) : 0.0f;
            }
#pragma unroll
            for (int u = 0; u < PASS2_LOADS; ++u)
                if (q0 + 32 * u < G) pair_add(s, e, vs[u], ve[u]);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const float s2 = __shfl_down_sync(0xffffffffu, s, off);
            const float e2 = __shfl_down_sync(0xffffffffu, e, off);
            pair_add(s, e, s2, e2);
        }
        if (wl == 0) out[i] = s;
    }
}

template <typename T>
const void* kernel_of(bool two, int vec) {
    if (vec == 8)
        return two ? reinterpret_cast<const void*>(pair_sums_kernel<T, true, 8>)
                   : reinterpret_cast<const void*>(pair_sums_kernel<T, false, 8>);
    return two ? reinterpret_cast<const void*>(pair_sums_kernel<T, true, 1>)
               : reinterpret_cast<const void*>(pair_sums_kernel<T, false, 1>);
}

const void* kernel_for(int bf16, int two, int vec) {
    return bf16 ? kernel_of<__nv_bfloat16>(two != 0, vec)
                : kernel_of<float>(two != 0, vec);
}

}  // namespace

// a (and b, if not null): contiguous (M, C), both float32 (bf16 = 0) or both
// bfloat16 (bf16 = 1), 16-byte aligned where vec = 8 (C % 8 == 0). part:
// fp32 scratch [2][2C][grid]. out: fp32 (2, C). The plan (vec, lanes,
// rows_step, grid, rows_block) is ops/fused_bn.py:pair_sums_plan's; grid
// must not exceed octseg_bn_pair_sums_resident's count. One cooperative
// launch.
extern "C" int octseg_bn_pair_sums(const void* a, const void* b, void* part,
                                   void* out, long long M, int C, int vec,
                                   int lanes, int rows_step, int grid,
                                   long long rows_block, int bf16,
                                   void* stream) {
    if (vec != 1 && vec != 8) return static_cast<int>(cudaErrorInvalidValue);
    const void* fn = kernel_for(bf16, b != nullptr, vec);
    const void* bb = b != nullptr ? b : a;
    void* args[] = {&a, &bb, &part, &out, &M, &C, &lanes, &rows_step,
                    &rows_block};
    const cudaError_t err = cudaLaunchCooperativeKernel(
        fn, dim3(grid), dim3(THREADS), args, 0,
        static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) cudaGetLastError();  // clear it; reported below
    return static_cast<int>(err);
}

// *blocks = the blocks of the (bf16, two, vec) instance the current device
// holds at once: the occupancy API's blocks an SM times the SMs.
extern "C" int octseg_bn_pair_sums_resident(int bf16, int two, int vec,
                                            void* blocks) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel_for(bf16, two, vec), THREADS, 0);
    *static_cast<int*>(blocks) = per_sm * sms;
    return static_cast<int>(err);
}
