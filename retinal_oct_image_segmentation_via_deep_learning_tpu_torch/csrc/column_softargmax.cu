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
// Three passes over the strip, each ending in a fixed-order combine of the
// 16 warps' partials in shared memory:
//   1. an online max and sum of exp over the warp's rows;
//   2. sm written, and sum sm * h;
//   3. the centred sum sm * (h - pos)^2. The centred form is kept: at
//      H = 512, h^2 reaches 2.6e5, and E[h^2] - pos^2 cancels in float32.
// Passes 2 and 3 read x again (from L2 at the slice's sizes) and recompute
// sm with the same arithmetic, so the value summed is the value written.
// expf and the division are the accurate ones, not the fast intrinsics, and
// every sum is Kahan-compensated (a thread's rows, then the 16 partials):
// a plain float32 sum over H = 512 rows is off by up to ~2e-6 of itself,
// which is 2e-6 of a peaked column's softmax.
//
// Bound on the card: bytes (x read once, sm written once, pos and std). A
// simple kernel: its passes read x three times; keeping a strip's rows in
// registers or shared memory is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int COLS = 32;  // columns per block (threadIdx.x)
constexpr int RW = 16;    // row lanes per block (threadIdx.y), one warp each

__device__ __forceinline__ void kahan_add(float& s, float& comp, float v) {
    const float y = v - comp;
    const float t = s + y;
    comp = (t - s) - y;
    s = t;
}

// grid (ceil(W / COLS), B * L), block (COLS, RW).
__global__ void __launch_bounds__(COLS * RW) column_softargmax_kernel(
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
    if (ty == 0) {
        float t = 0.0f, te = 0.0f;
        for (int j = 0; j < RW; ++j) kahan_add(t, te, part_a[j][tx]);
        col[0][tx] = t - te;
    }
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
        float t = 0.0f, te = 0.0f;
        for (int j = 0; j < RW; ++j) kahan_add(t, te, part_b[j][tx]);
        const size_t o = (size_t)blockIdx.y * W + w;
        pos[o] = p_mean;
        std_out[o] = sqrtf(t - te);
    }
}

}  // namespace

// x: contiguous float32 (planes, H, W) with planes = B * L <= 65535.
// sm: float32 (planes, H, W); pos, std: float32 (planes, W). One launch.
extern "C" int octseg_column_softargmax(const void* x, void* sm, void* pos,
                                        void* std_out, int planes, int H,
                                        int W, void* stream) {
    dim3 grid((W + COLS - 1) / COLS, planes);
    dim3 block(COLS, RW);
    column_softargmax_kernel<<<grid, block, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<float*>(sm),
        static_cast<float*>(pos), static_cast<float*>(std_out), H, W);
    return static_cast<int>(cudaGetLastError());
}
