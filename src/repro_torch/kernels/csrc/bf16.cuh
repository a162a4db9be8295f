// Shared device helpers of the bf16 kernel instances (flat_aggregate.cu,
// pairwise_l2.cu, flash_attention.cu, ssd_scan.cu): bf16 is carried as its
// 16 bits (uint16_t) and widened to fp32 exactly, by a shift into the high
// half of the fp32 word; a result is rounded to bf16 once, to nearest even
// (cvt.rn.bf16.f32, what torch's own fp32 -> bf16 conversion on the card
// gives).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float bf16x1_to_float(uint16_t x) {
    return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

// the low and high bf16 of a 32-bit word (the lower address first)
__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t w) {
    return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

__device__ __forceinline__ float4 bf16x4_to_float4(uint2 w) {
    const float2 a = bf16x2_to_float2(w.x), b = bf16x2_to_float2(w.y);
    return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ uint16_t float_to_bf16(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// two results into one 32-bit word, a at the lower address
__device__ __forceinline__ uint32_t float2_to_bf16x2(float a, float b) {
    return static_cast<uint32_t>(float_to_bf16(a)) |
           (static_cast<uint32_t>(float_to_bf16(b)) << 16);
}

// Two results to adjacent outputs (dst even-aligned): fp32 as they are,
// bf16 rounded once
__device__ __forceinline__ void store2(float* dst, float a, float b) {
    *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(uint16_t* dst, float a, float b) {
    *reinterpret_cast<uint32_t*>(dst) = float2_to_bf16x2(a, b);
}
__device__ __forceinline__ void store1(float* dst, float a) { *dst = a; }
__device__ __forceinline__ void store1(uint16_t* dst, float a) { *dst = float_to_bf16(a); }
