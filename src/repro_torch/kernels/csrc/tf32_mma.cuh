// Shared device helpers of the tensor-core kernels (flash_attention.cu,
// ssd_scan.cu): 3xTF32 products on mma.sync m16n8k8, cp.async copies, and
// the tile copies of an fp32 or a bf16 operand into fp32 shared memory.
//
// 3xTF32: each fp32 operand x is split into hi = tf32(x) and lo =
// tf32(x - hi), and a product is lo*hi + hi*lo + hi*hi with fp32
// accumulators, which keeps about fp32's accuracy (plain TF32 keeps about
// three decimal digits).
//
// Fragment layout of mma.sync.m16n8k8 TF32 for lane = 4 g + t:
//   A (16 x 8, row):  a0 = (g, t), a1 = (g + 8, t), a2 = (g, t + 4), a3 = (g + 8, t + 4)
//   B (8 x 8, col):   b0 = (k t, n g), b1 = (k t + 4, n g)
//   C (16 x 8):       c0 = (g, 2t), c1 = (g, 2t + 1), c2 = (g + 8, 2t), c3 = (g + 8, 2t + 1)
// A C fragment holds columns 2t and 2t + 1 of a row where an A fragment
// wants t and t + 4: a product that takes an accumulator as its A operand
// runs its 8 k in the order (0, 2, 4, 6, 1, 3, 5, 7) and reads the B rows
// in that order (a0 = c0, a1 = c2, a2 = c1, a3 = c3).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"

namespace tf32 {

// tf32(x): x rounded to 10 mantissa bits, to nearest with ties away from
// zero -- the bits cvt.rna.tf32.f32 gives, from two integer operations
// instead of the conversion unit
__device__ __forceinline__ uint32_t to_tf32(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo with hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = to_tf32(x);
    lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b in 3xTF32, the small terms first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           const uint32_t (&bhi)[2],
                                           const uint32_t (&blo)[2]) {
    mma_tf32(c, alo, bhi);
    mma_tf32(c, ahi, blo);
    mma_tf32(c, ahi, bhi);
}

// acc[n] += a * b[n] in 3xTF32 for the first `live` of NT accumulators,
// each of the three products issued across the accumulators in turn, so
// that no mma waits on the one just before it (a chain of three on one
// accumulator stalls the warp on each result)
template <int NT>
__device__ __forceinline__ void mma_3xtf32_row(float (&acc)[NT][4], const uint32_t (&ahi)[4],
                                               const uint32_t (&alo)[4],
                                               const uint32_t (&bhi)[NT][2],
                                               const uint32_t (&blo)[NT][2], int live = NT) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
        if (n < live) mma_tf32(acc[n], alo, bhi[n]);
#pragma unroll
    for (int n = 0; n < NT; ++n)
        if (n < live) mma_tf32(acc[n], ahi, blo[n]);
#pragma unroll
    for (int n = 0; n < NT; ++n)
        if (n < live) mma_tf32(acc[n], ahi, bhi[n]);
}

// 16 (or 4) bytes from global to shared memory, asynchronously; zeros
// where `in` is false (src is then not read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(in ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(in ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four (copy4: 16-byte aligned dst, 4-element aligned src) or one element
// of an operand into fp32 shared memory, zeros where `in` is false (src is
// then not read): fp32 by cp.async, bf16 by a plain load widened exactly
// (synchronous: the commit and wait that follow cover the fp32 copies, the
// barrier after them both)
__device__ __forceinline__ void copy4(float* dst, const float* src, bool in) {
    cp_async16(dst, src, in);
}
__device__ __forceinline__ void copy4(float* dst, const uint16_t* src, bool in) {
    *reinterpret_cast<float4*>(dst) =
        in ? bf16x4_to_float4(*reinterpret_cast<const uint2*>(src))
           : make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void copy1(float* dst, const float* src, bool in) {
    cp_async4(dst, src, in);
}
__device__ __forceinline__ void copy1(float* dst, const uint16_t* src, bool in) {
    *dst = in ? bf16x1_to_float(*src) : 0.f;
}

}  // namespace tf32
