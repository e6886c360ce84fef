// The int8 tensor-core helpers that K1 (conv3x3_int8.cu), K2 (ct2x2_int8.cu),
// K3 (head_argmax.cu), K7 (conv7x3_int8.cu) and K10 (stem_conv_int8.cu)
// share, K9 (dice_ce.cu) its copy helpers: cp.async copies
// into shared memory, the ldmatrix reads, mma.sync m16n8k32 s8 * s8 -> s32,
// the 32-byte-row swizzle, the requant's rounding by an add and the
// packing of four rounded bytes into a word. Every function is inline
// (each source is compiled on its own, without relocatable device code).

#pragma once

#include <stdint.h>

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

// Four 8x8 b16 matrices (8 rows of 16 bytes each); lane l gives the row
// address of matrix l / 8, row l % 8, and receives 4 bytes of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
        : "memory");
}

// d += a (16x32, row) * b (32x8, col), s8 in, s32 accumulate; not
// volatile, so the compiler may schedule the products among the ldmatrix
// reads.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
    asm(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte unit u (0 or 1) of 32-byte row p within a run of
// rows: the unit index 2p + u with its low bit XORed with bit 2 of p, so
// that 8 consecutive rows at one u fill 8 different bank groups.
__device__ __forceinline__ uint32_t swz(int p, int u) {
    return static_cast<uint32_t>((2 * p + u) ^ ((p >> 2) & 1)) * 16u;
}

// The bits of 1.5 * 2^23 + clip(rint(v), lo..hi) for integral bounds in
// [-127, 127]; the low byte is the int8 result. Clipping before rounding
// gives the same value (rint is monotone, the bounds are integers), and
// adding 1.5 * 2^23 rounds |t| <= 127 to an integer, ties to even (the
// sum's ulp is 1 and 1.5 * 2^23 is even): no conversion instruction,
// where rintf and __float2int_rn are two at a quarter of the FMA rate.
__device__ __forceinline__ uint32_t rounded_bits(float v, float lo, float hi) {
    return __float_as_uint(__fadd_rn(fminf(fmaxf(v, lo), hi), 12582912.0f));
}

// The low bytes of r[0..3] as one word, r[0] lowest.
__device__ __forceinline__ uint32_t pack4(const uint32_t* r) {
    return __byte_perm(__byte_perm(r[0], r[1], 0x0040),
                       __byte_perm(r[2], r[3], 0x0040), 0x5410);
}
