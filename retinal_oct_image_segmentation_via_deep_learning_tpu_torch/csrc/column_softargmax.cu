// K12: the SDNet LayerEngine's column softmax, soft-argmax position and
// positional std, in one kernel.
//
// Replaces ops/pallas_kernels.py:fused_column_softargmax. For every column
// (b, l, :, w) of x (B, L, H, W) float32, with rows h = 0..H-1:
//   sm[h] = exp(x[h] - max) / sum_k exp(x[k] - max)
//   pos   = sum_h sm[h] * h
//   std   = sqrt(sum_h sm[h] * (h - pos)^2)
// The TPU kernel held a whole (H, 128-lane) tile in VMEM; W sat in lanes and
// was padded to 128. Here W is the contiguous axis: a block takes a strip of
// 32 neighbouring columns of one (b, l) plane (threadIdx.x), so every row a
// warp reads or writes is one 128-byte segment, and its 16 warps
// (threadIdx.y) split the rows of the strip. No padding.
//
// Bound on the card: bytes (x read once, sm written once, pos and std).
// The main body, column_softargmax_regs<R, FULL> (H <= 16 R, R = 8, 16 or
// 32: every H up to 512), reads x once: a thread holds its R rows h = ty,
// ty + 16, ... in registers (all R loads issued before the first use), so
//   1. the max: fmaxf over the thread's rows, then the 16 warps' partials;
//   2. e = exp(x - max) once an element, in place, and their sum;
//   3. p = e / sum written once as sm, and sum p * h;
//   4. the centred sum p * (h - pos)^2 from the same registers. The centred
//      form is kept: at H = 512, h^2 reaches 2.6e5, and E[h^2] - pos^2
//      cancels in float32.
// The value summed is the value written. Each step's 16 partials go to
// shared memory and are combined in one fixed order (the maxima by every
// warp, the sums by warp 0, whose result a barrier hands to the block): no
// float atomics, and the order depends on the shape alone. expf and the
// division are the accurate ones, not the fast intrinsics, and every sum
// is Kahan-compensated (a thread's rows, then the 16 partials): a plain
// float32 sum over H = 512 rows is off by up to ~2e-6 of itself, which is
// 2e-6 of a peaked column's softmax.
//
// H > 512 (no SDNet shape of the repo; `cli` can be asked for one), or a
// plane of 2^31 elements or more, takes column_softargmax_three_pass, which
// holds no rows: an online max and sum, then sm and sum sm * h, then the
// centred sum, each pass reading x again and recomputing sm with the same
// arithmetic. ops/column_softargmax.py:column_softargmax_plan names the
// body a shape takes.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int COLS = 32;  // columns per block (threadIdx.x)
constexpr int RW = 16;    // row lanes per block (threadIdx.y), one warp each
constexpr int MAX_REGS_H = 512;  // the largest H of the register body

__device__ __forceinline__ void kahan_add(float& s, float& comp, float v) {
    const float y = v - comp;
    const float t = s + y;
    comp = (t - s) - y;
    s = t;
}

// The 16 partials of column tx, Kahan-summed in order j = 0..15.
__device__ __forceinline__ float combine(const float (&part)[RW][COLS],
                                         int tx) {
    float t = 0.0f, te = 0.0f;
#pragma unroll
    for (int j = 0; j < RW; ++j) kahan_add(t, te, part[j][tx]);
    return t - te;
}

// grid (ceil(W / COLS), B * L), block (COLS, RW); H <= RW * R and
// H * W < 2^31 (offsets in a plane are 32-bit). FULL: every row of every
// thread exists (H == RW * R) and every column of every strip (W % COLS
// == 0), so nothing is predicated; it holds 2 blocks an SM (64 registers).
// The general instance tests each row and column and may take up to 128
// registers (1 block an SM): no spills either way.
template <int R, bool FULL>
__global__ void __launch_bounds__(COLS * RW, FULL ? 2 : 1)
    column_softargmax_regs(const float* __restrict__ x,
                           float* __restrict__ sm, float* __restrict__ pos,
                           float* __restrict__ std_out, int H, int W) {
    __shared__ float partm[RW][COLS];
    __shared__ float part[RW][COLS];
    __shared__ float col[COLS];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int w = blockIdx.x * COLS + tx;
    const bool live = FULL || w < W;
    const size_t plane = (size_t)blockIdx.y * H * W;
    const float* xp = x + plane;
    float* sp = sm + plane;
    const int o0 = ty * W + w, step = RW * W;  // row ty + RW r: o0 + r step
    const float h0 = static_cast<float>(ty);
    // row h = ty + RW * r of the thread exists for r < rows
    const int rows = live ? (H - ty + RW - 1) / RW : 0;
    auto row = [&](int r) { return FULL || r < rows; };

    // 1. all R loads, then the max (every warp combines the 16 maxima)
    float v[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
        v[r] = row(r) ? xp[o0 + r * step] : __int_as_float(0xff800000);
    float m = v[0];
#pragma unroll
    for (int r = 1; r < R; ++r) m = fmaxf(m, v[r]);
    partm[ty][tx] = m;
    __syncthreads();
    float mx = partm[0][tx];
#pragma unroll
    for (int j = 1; j < RW; ++j) mx = fmaxf(mx, partm[j][tx]);

    // 2. e = exp(x - max) in place (0 for rows past H), and its sum
    float s = 0.0f, se = 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        v[r] = row(r) ? expf(v[r] - mx) : 0.0f;
        kahan_add(s, se, v[r]);
    }
    part[ty][tx] = s - se;
    __syncthreads();
    if (ty == 0) col[tx] = combine(part, tx);  // the barrier publishes it
    __syncthreads();
    const float sum = col[tx];

    // 3. p = e / sum, written once, and sum p * h (every row a thread
    //    holds is added, 0 past H, in both sums below)
    float a = 0.0f, ae = 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        v[r] = v[r] / sum;
        if (row(r)) sp[o0 + r * step] = v[r];
        kahan_add(a, ae, v[r] * (h0 + static_cast<float>(RW * r)));
    }
    part[ty][tx] = a - ae;
    __syncthreads();
    if (ty == 0) col[tx] = combine(part, tx);  // the barrier publishes it
    __syncthreads();
    const float p_mean = col[tx];

    // 4. the centred second moment (p is 0 for rows past H)
    a = 0.0f;
    ae = 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const float d = (h0 + static_cast<float>(RW * r)) - p_mean;
        kahan_add(a, ae, v[r] * d * d);
    }
    part[ty][tx] = a - ae;
    __syncthreads();
    if (ty == 0 && live) {
        const size_t o = (size_t)blockIdx.y * W + w;
        pos[o] = p_mean;
        std_out[o] = sqrtf(combine(part, tx));
    }
}

// grid (ceil(W / COLS), B * L), block (COLS, RW); any H.
__global__ void __launch_bounds__(COLS * RW) column_softargmax_three_pass(
    const float* __restrict__ x, float* __restrict__ sm,
    float* __restrict__ pos, float* __restrict__ std_out, int H, int W) {
    __shared__ float part_a[RW][COLS];
    __shared__ float part_b[RW][COLS];
    __shared__ float col[2][COLS];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int w = blockIdx.x * COLS + tx;
    const bool live = w < W;
    const size_t plane = (size_t)blockIdx.y * H * W;
    const float* xp = x + plane + w;
    float* sp = sm + plane + w;

    // 1. online max and sum of exp (rescaled, with its compensation, when
    //    the max moves)
    float m = -INFINITY, s = 0.0f, e = 0.0f;
    if (live) {
        for (int h = ty; h < H; h += RW) {
            const float v = xp[(size_t)h * W];
            if (v > m) {
                const float r = expf(m - v);
                s *= r;
                e *= r;
                m = v;
                kahan_add(s, e, 1.0f);
            } else if (v != -INFINITY) {
                kahan_add(s, e, expf(v - m));
            }
        }
    }
    part_a[ty][tx] = m;
    part_b[ty][tx] = s - e;
    __syncthreads();
    if (ty == 0) {
        float mx = part_a[0][tx];
        for (int j = 1; j < RW; ++j) mx = fmaxf(mx, part_a[j][tx]);
        float sum = 0.0f, se = 0.0f;
        for (int j = 0; j < RW; ++j)
            if (part_a[j][tx] != -INFINITY)
                kahan_add(sum, se, part_b[j][tx] * expf(part_a[j][tx] - mx));
        col[0][tx] = mx;
        col[1][tx] = sum - se;
    }
    __syncthreads();
    const float mx = col[0][tx], sum = col[1][tx];

    // 2. sm, and sum sm * h
    float acc = 0.0f, ae = 0.0f;
    if (live) {
        for (int h = ty; h < H; h += RW) {
            const float p = expf(xp[(size_t)h * W] - mx) / sum;
            sp[(size_t)h * W] = p;
            kahan_add(acc, ae, p * (float)h);
        }
    }
    part_a[ty][tx] = acc - ae;
    __syncthreads();
    if (ty == 0) col[0][tx] = combine(part_a, tx);
    __syncthreads();
    const float p_mean = col[0][tx];

    // 3. the centred second moment
    acc = 0.0f;
    ae = 0.0f;
    if (live) {
        for (int h = ty; h < H; h += RW) {
            const float p = expf(xp[(size_t)h * W] - mx) / sum;
            const float d = (float)h - p_mean;
            kahan_add(acc, ae, p * d * d);
        }
    }
    part_b[ty][tx] = acc - ae;
    __syncthreads();
    if (ty == 0 && live) {
        const size_t o = (size_t)blockIdx.y * W + w;
        pos[o] = p_mean;
        std_out[o] = sqrtf(combine(part_b, tx));
    }
}

using Body = void (*)(const float*, float*, float*, float*, int, int);

template <int R>
Body regs_for(int H, int W) {
    if (H == RW * R && W % COLS == 0)
        return column_softargmax_regs<R, true>;
    return column_softargmax_regs<R, false>;
}

// The body for (H, W) (ops/column_softargmax.py:column_softargmax_plan).
Body body_for(int H, int W) {
    if ((long long)H * W >= (1LL << 31)) return column_softargmax_three_pass;
    if (H <= RW * 8) return regs_for<8>(H, W);
    if (H <= RW * 16) return regs_for<16>(H, W);
    if (H <= MAX_REGS_H) return regs_for<32>(H, W);
    return column_softargmax_three_pass;
}

}  // namespace

// x: contiguous float32 (planes, H, W) with planes = B * L <= 65535.
// sm: float32 (planes, H, W); pos, std: float32 (planes, W). One launch.
extern "C" int octseg_column_softargmax(const void* x, void* sm, void* pos,
                                        void* std_out, int planes, int H,
                                        int W, void* stream) {
    dim3 grid((W + COLS - 1) / COLS, planes);
    dim3 block(COLS, RW);
    body_for(H, W)<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<float*>(sm),
        static_cast<float*>(pos), static_cast<float*>(std_out), H, W);
    return static_cast<int>(cudaGetLastError());
}
