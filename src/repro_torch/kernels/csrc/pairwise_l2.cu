// Pairwise squared L2 distances: out[i, j] = sum_f (x[i, f] - c[j, f])^2.
// x: [n, f], c: [m, f] fp32 -> out: [n, m] fp32; with a leading batch axis
// (a cohort's seeds), x: [batch, n, f], c: [batch, m, f] -> [batch, n, m],
// each entry's distances in the same launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/pairwise_l2.py
// (pairwise_l2 / _pairwise_l2_kernel). Bound on the card: bytes -- at the
// shapes the FL loop gives it (m = 10 K-means centroids over f = 2240, or
// m = 1 global row over f = P) it does 3 flops per 8 bytes read. Design: the
// direct sum of (x - c)^2, not the TPU body's |x|^2 + |c|^2 - 2 x.c
// expansion, which cancels badly when a client row is close to the global
// row. One block per ((i, j) pair, slab of f) strides over its slab with
// float4 loads (four loads of each operand in flight per thread), then a
// fixed-shape warp-shuffle and shared-memory tree reduction. Few pairs (the
// divergence: m = 1, n = 10 or 40) leave most SMs idle with one block a
// pair, so the wrapper cuts f into slabs (a count that depends on n, m and
// f alone, kernels/pairwise_l2.py: plan_slabs) and a second kernel adds
// each pair's slab partials in a fixed order, one warp a pair. With one
// slab the first kernel writes out directly. No atomics, so the result is
// the same bit for bit on every run. A sum of squares needs no clamp at
// zero, and a NaN input stays NaN. The batch folds into the pairs: pair
// (b, i, j) reads row i of entry b of x and row j of entry b of c, each
// entry at its own stride (the divergence reads the first n rows of each
// entry of a [batch, n + pad, f] plane) with the slab plan of a call on
// that entry alone, so each entry's sums run in that call's order.
//
// bf16 x (pairwise_l2_bf16: a bf16 client plane; c stays fp32, the wrapper
// widens its few rows): the same kernel with four bf16 (8 bytes) or one a
// load, widened exactly to fp32 before the subtraction; a thread takes the
// same columns in the same order, so the result is the fp32 instance's on
// the widened x, bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSumWarps = 8;          // pairs a block of the second pass

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

// Four (vec) or one x element, widened to fp32.
__device__ __forceinline__ float4 load4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const uint16_t* p) {
    return bf16x4_to_float4(__ldg(reinterpret_cast<const uint2*>(p)));
}
__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const uint16_t* p) {
    return bf16x1_to_float(__ldg(p));
}

template <typename X>
__global__ void __launch_bounds__(kThreads)
pairwise_l2_kernel(const X* __restrict__ x, const float* __restrict__ c,
                   float* __restrict__ out, int n, int m, int f, long long x_stride,
                   long long c_stride, int slabs, int width, bool vec) {
    const int pair = blockIdx.x / slabs, slab = blockIdx.x % slabs;
    const int b = pair / (n * m), ij = pair % (n * m);
    const int i = ij / m;
    const int j = ij % m;
    const int f0 = slab * width, fl = min(width, f - f0);   // the slab
    const X* xr = x + b * x_stride + (size_t)i * f + f0;
    const float* cr = c + b * c_stride + (size_t)j * f + f0;
    const int t = threadIdx.x;
    float acc = 0.f;
    if (vec) {
        const float4* c4 = reinterpret_cast<const float4*>(cr);
        const int f4 = fl / 4;
        int k = t;
        for (; k + 3 * kThreads < f4; k += 4 * kThreads) {
            const float4 a0 = load4(xr + 4 * k), a1 = load4(xr + 4 * (k + kThreads));
            const float4 a2 = load4(xr + 4 * (k + 2 * kThreads));
            const float4 a3 = load4(xr + 4 * (k + 3 * kThreads));
            const float4 b0 = __ldg(c4 + k), b1 = __ldg(c4 + k + kThreads);
            const float4 b2 = __ldg(c4 + k + 2 * kThreads);
            const float4 b3 = __ldg(c4 + k + 3 * kThreads);
            acc = sq_diff4(acc, a0, b0);
            acc = sq_diff4(acc, a1, b1);
            acc = sq_diff4(acc, a2, b2);
            acc = sq_diff4(acc, a3, b3);
        }
        for (; k < f4; k += kThreads) acc = sq_diff4(acc, load4(xr + 4 * k), __ldg(c4 + k));
    } else {
        for (int k = t; k < fl; k += kThreads) {
            const float d = load1(xr + k) - __ldg(cr + k);
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
        if (lane == 0) out[(size_t)pair * slabs + slab] = acc;
    }
}

// out[pair] = the sum of part[pair, 0 .. slabs), one warp a pair: lane l
// adds slabs l, l + 32, ... in order, then a fixed shuffle tree.
__global__ void __launch_bounds__(kSumWarps * 32)
slab_sum_kernel(const float* __restrict__ part, float* __restrict__ out, int pairs,
                int slabs) {
    const int pair = blockIdx.x * kSumWarps + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (pair >= pairs) return;
    float acc = 0.f;
    for (int s = lane; s < slabs; s += 32) acc += part[(size_t)pair * slabs + s];
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) out[pair] = acc;
}

// The first pass (and the second with slabs > 1); `vec` where the rows of
// x and c start on whole vectors (16 bytes of c, 4 x elements).
template <typename X>
int launch(const X* x, const float* c, float* out, float* part, int batch, int n, int m,
           int f, long long x_stride, long long c_stride, int slabs, int width,
           void* stream) {
    if (batch <= 0 || n <= 0 || m <= 0) return 0;
    if (slabs < 1 || width < 1 || width % 4 || (long long)slabs * width < f ||
        (long long)(slabs - 1) * width >= (f > 0 ? f : 1) || (slabs > 1 && part == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool vec = f % 4 == 0 && x_stride % 4 == 0 && c_stride % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % (4 * sizeof(X)) == 0 &&
                     reinterpret_cast<uintptr_t>(c) % 16 == 0;
    const int pairs = batch * n * m;
    pairwise_l2_kernel<X><<<pairs * slabs, kThreads, 0, s>>>(
        x, c, slabs > 1 ? part : out, n, m, f, x_stride, c_stride, slabs, width, vec);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || slabs == 1) return static_cast<int>(err);
    slab_sum_kernel<<<(pairs + kSumWarps - 1) / kSumWarps, kSumWarps * 32, 0, s>>>(
        part, out, pairs, slabs);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [batch, n, f] fp32 (pairwise_l2_f32) or bf16 (pairwise_l2_bf16), c:
// [batch, m, f] fp32, whose rows are row-major, entry b of x at x + b
// x_stride and of c at c + b c_stride (elements); out: [batch, n, m] fp32
// (batch = 1: the plain [n, f] x [m, f] -> [n, m]). f is cut into `slabs`
// slabs of `width` columns (a multiple of 4; the last may be shorter); with
// slabs > 1, part is scratch of batch n m slabs floats. Launches on `stream`
// (one kernel, or two with slabs > 1) and returns cudaGetLastError() (0 on
// success); cudaErrorInvalidValue for slabs that do not cover f.
extern "C" int pairwise_l2_f32(const float* x, const float* c, float* out, float* part,
                               int batch, int n, int m, int f, long long x_stride,
                               long long c_stride, int slabs, int width, void* stream) {
    return launch(x, c, out, part, batch, n, m, f, x_stride, c_stride, slabs, width,
                  stream);
}

extern "C" int pairwise_l2_bf16(const uint16_t* x, const float* c, float* out,
                                float* part, int batch, int n, int m, int f,
                                long long x_stride, long long c_stride, int slabs,
                                int width, void* stream) {
    return launch(x, c, out, part, batch, n, m, f, x_stride, c_stride, slabs, width,
                  stream);
}

extern "C" const char* pairwise_l2_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
