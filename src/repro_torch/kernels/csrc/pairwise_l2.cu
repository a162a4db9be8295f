// Pairwise squared L2 distances: out[i, j] = sum_f (x[i, f] - c[j, f])^2.
// x: [n, f], c: [m, f] fp32 -> out: [n, m] fp32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/pairwise_l2.py
// (pairwise_l2 / _pairwise_l2_kernel). Bound on the card: bytes -- at the
// shapes the FL loop gives it (m = 10 K-means centroids over f = 2240, or
// m = 1 global row over f = P) it does 3 flops per 8 bytes read. Design: the
// direct sum of (x - c)^2, not the TPU body's |x|^2 + |c|^2 - 2 x.c
// expansion, which cancels badly when a client row is close to the global
// row. One block per (i, j) pair strides over f with float4 loads (four
// loads of each operand in flight per thread), then a fixed-shape
// warp-shuffle and shared-memory tree reduction: no atomics, so the result
// is the same bit for bit on every run. A sum of squares needs no clamp at
// zero, and a NaN input stays NaN.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float sq_diff4(float acc, float4 a, float4 b) {
    float d = a.x - b.x;
    acc = fmaf(d, d, acc);
    d = a.y - b.y;
    acc = fmaf(d, d, acc);
    d = a.z - b.z;
    acc = fmaf(d, d, acc);
    d = a.w - b.w;
    return fmaf(d, d, acc);
}

__global__ void __launch_bounds__(kThreads)
pairwise_l2_kernel(const float* __restrict__ x, const float* __restrict__ c,
                   float* __restrict__ out, int m, int f, bool vec) {
    const int i = blockIdx.x / m;
    const int j = blockIdx.x % m;
    const float* xr = x + (size_t)i * f;
    const float* cr = c + (size_t)j * f;
    const int t = threadIdx.x;
    float acc = 0.f;
    if (vec) {
        const float4* x4 = reinterpret_cast<const float4*>(xr);
        const float4* c4 = reinterpret_cast<const float4*>(cr);
        const int f4 = f / 4;
        int k = t;
        for (; k + 3 * kThreads < f4; k += 4 * kThreads) {
            const float4 a0 = __ldg(x4 + k), a1 = __ldg(x4 + k + kThreads);
            const float4 a2 = __ldg(x4 + k + 2 * kThreads);
            const float4 a3 = __ldg(x4 + k + 3 * kThreads);
            const float4 b0 = __ldg(c4 + k), b1 = __ldg(c4 + k + kThreads);
            const float4 b2 = __ldg(c4 + k + 2 * kThreads);
            const float4 b3 = __ldg(c4 + k + 3 * kThreads);
            acc = sq_diff4(acc, a0, b0);
            acc = sq_diff4(acc, a1, b1);
            acc = sq_diff4(acc, a2, b2);
            acc = sq_diff4(acc, a3, b3);
        }
        for (; k < f4; k += kThreads) acc = sq_diff4(acc, __ldg(x4 + k), __ldg(c4 + k));
    } else {
        for (int k = t; k < f; k += kThreads) {
            const float d = __ldg(xr + k) - __ldg(cr + k);
            acc = fmaf(d, d, acc);
        }
    }
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    __shared__ float warp_sums[kWarps];
    const int lane = t & 31;
    const int warp = t >> 5;
    if (lane == 0) warp_sums[warp] = acc;
    __syncthreads();
    if (warp == 0) {
        acc = lane < kWarps ? warp_sums[lane] : 0.f;
        for (int off = 16; off > 0; off >>= 1)
            acc += __shfl_down_sync(0xffffffffu, acc, off);
        if (lane == 0) out[(size_t)i * m + j] = acc;
    }
}

}  // namespace

// x: [n, f], c: [m, f] row-major fp32; out: [n, m] fp32.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int pairwise_l2_f32(const float* x, const float* c, float* out, int n,
                               int m, int f, void* stream) {
    if (n <= 0 || m <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool vec = f % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(c) % 16 == 0;
    pairwise_l2_kernel<<<n * m, kThreads, 0, s>>>(x, c, out, m, f, vec);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pairwise_l2_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
