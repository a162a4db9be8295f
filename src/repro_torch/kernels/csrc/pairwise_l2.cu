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
// row. F is cut into slabs, and three kernels compute the (pair, slab)
// partials:
//
// - pairwise_l2_kernel: one block per (pair, slab), striding over it with
//   float4 loads (four loads of each operand in flight a thread), then a
//   fixed-shape warp-shuffle and shared-memory tree reduction.
// - pairwise_l2_walk_kernel, where the (lane, centroid, slab) blocks alone
//   fill the card (the divergence of a large leaf: m = 1, thousands of
//   slabs; the wrapper's plan_rows): a block owns one slab of c_j and walks
//   up to 64 rows of x, its threads holding their first 8 float4 of the
//   slab in registers, so each slab of c leaves HBM once, not once a row
//   (16 x 0.262 GB at the LM round's lm_head).
// - pairwise_l2_centroid_walk_kernel, for 2 to 16 centroids over an F wide
//   enough for thousands of slabs (the K-means of an LM's whole embedding
//   table: [16, 233,373,696] x [4, .]; the wrapper's plan_centroids): a
//   block owns one slab of every centroid and walks a group of rows of x
//   against all of them at once, up to 64 (row, centroid) sums a thread
//   in registers, so each slab of x and of c leaves HBM once (11.2 GB, not
//   the 89.6 GB of a block per (pair, slab)).
//
// Few pairs (the divergence: m = 1, n = 10 or 40) leave most SMs idle
// without slabs, so the wrapper cuts f into slabs (a count that depends on
// the shapes alone, kernels/pairwise_l2.py: plan_slabs, plan_divergence,
// plan_centroids) and a second kernel adds each pair's slab partials in a
// fixed order, one warp a pair. With one slab the first kernel writes out
// directly. Every kernel gives a (pair, slab) partial the same columns in
// the same order (thread t: t, t + kThreads, ...) through the same tree,
// and no atomics are used, so the result is the same bit for bit on every
// run. A sum of squares needs no clamp at zero, and a NaN input stays NaN
// in its own pairs. The batch folds into the pairs: pair (b, i, j) reads
// row i of entry b of x and row j of entry b of c, each entry at its own
// stride (the divergence reads the first n rows of each entry of a
// [batch, n + pad, f] plane) with the slab plan of a call on that entry
// alone, so each entry's sums run in that call's order.
//
// bf16 x (pairwise_l2_bf16, pairwise_l2_centroids_bf16: a bf16 client
// plane; c stays fp32, the wrapper widens its few rows): the same kernels
// with four bf16 (8 bytes) or one a load, widened exactly to fp32 before
// the subtraction; a thread takes the same columns in the same order, so
// the result is the fp32 instance's on the widened x, bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSumWarps = 8;          // pairs a block of the second pass
constexpr int kCached = 8;            // float4 of c a thread keeps in registers
constexpr int kMaxRows = 64;          // rows of x a block walks at most
                                      // (the wrapper's MAX_ROWS)
constexpr int kMaxSums = 64;          // (row, centroid) sums a thread of the
                                      // centroid walk holds (MAX_SUMS)
constexpr int kGroupRows = 16;        // rows of x a centroid walk's block
                                      // takes at most (GROUP_ROWS)
constexpr int kMaxCentroids = 16;     // centroids it takes (MAX_CENTROIDS)

// Rows of x a centroid walk's block takes for C centroid slots.
__host__ __device__ constexpr int group_rows(int C) {
    return kMaxSums / C < kGroupRows ? kMaxSums / C : kGroupRows;
}

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

// One block per (pair, slab): four float4 of x and of c in flight a
// thread, then the warp-shuffle and shared-memory tree.
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

// One block per (lane b, group of rows, centroid j, slab), the slabs
// innermost: the block's threads load their float4 columns of c's slab
// once (the first kCached into registers) and walk the group's rows of x,
// each row's partial taking thread t's columns t, t + kThreads, ... in
// that order and then the same tree as pairwise_l2_kernel: its bits.
template <typename X>
__global__ void __launch_bounds__(kThreads)
pairwise_l2_walk_kernel(const X* __restrict__ x, const float* __restrict__ c,
                        float* __restrict__ out, int n, int m, int f, long long x_stride,
                        long long c_stride, int slabs, int width, int rows, int groups,
                        bool vec) {
    int blk = blockIdx.x;
    const int slab = blk % slabs;
    blk /= slabs;
    const int j = blk % m;
    blk /= m;
    const int group = blk % groups, b = blk / groups;
    const int i0 = group * rows, count = min(rows, n - i0);
    const int f0 = slab * width, fl = min(width, f - f0);   // the slab
    const X* xb = x + b * x_stride + f0;
    const float* cr = c + b * c_stride + (size_t)j * f + f0;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    __shared__ float warp_sums[kMaxRows][kWarps];
    if (vec) {
        const float4* c4 = reinterpret_cast<const float4*>(cr);
        const int f4 = fl / 4;
        float4 cc[kCached];
#pragma unroll
        for (int q = 0; q < kCached; ++q) {
            const int k = t + q * kThreads;
            cc[q] = k < f4 ? __ldg(c4 + k) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        for (int r = 0; r < count; ++r) {
            const X* xr = xb + (size_t)(i0 + r) * f;
            float4 a[kCached];
#pragma unroll
            for (int q = 0; q < kCached; ++q) {
                const int k = t + q * kThreads;
                if (k < f4) a[q] = load4(xr + 4 * k);
            }
            float acc = 0.f;
#pragma unroll
            for (int q = 0; q < kCached; ++q)
                if (t + q * kThreads < f4) acc = sq_diff4(acc, a[q], cc[q]);
            for (int k = t + kCached * kThreads; k < f4; k += kThreads)
                acc = sq_diff4(acc, load4(xr + 4 * k), __ldg(c4 + k));
            for (int off = 16; off > 0; off >>= 1)
                acc += __shfl_down_sync(0xffffffffu, acc, off);
            if (lane == 0) warp_sums[r][warp] = acc;
        }
    } else {
        for (int r = 0; r < count; ++r) {
            const X* xr = xb + (size_t)(i0 + r) * f;
            float acc = 0.f;
            for (int k = t; k < fl; k += kThreads) {
                const float d = load1(xr + k) - __ldg(cr + k);
                acc = fmaf(d, d, acc);
            }
            for (int off = 16; off > 0; off >>= 1)
                acc += __shfl_down_sync(0xffffffffu, acc, off);
            if (lane == 0) warp_sums[r][warp] = acc;
        }
    }
    __syncthreads();
    for (int r = warp; r < count; r += kWarps) {
        float acc = lane < kWarps ? warp_sums[r][lane] : 0.f;
        for (int off = 16; off > 0; off >>= 1)
            acc += __shfl_down_sync(0xffffffffu, acc, off);
        if (lane == 0)
            out[((size_t)(b * n + i0 + r) * m + j) * slabs + slab] = acc;
    }
}

// One block per (lane b, group of rows, slab), the slabs innermost, for
// 2 <= m <= C centroids: for each of its float4 columns a thread loads the
// m centroids' float4 once and the group's rows' float4 once (bf16 widened
// at the load) and adds into a (row, centroid) sum held in registers;
// each (pair, slab) sum then takes the same tree as pairwise_l2_kernel.
// R x C <= kMaxSums (R = group_rows(C): the rows of the wrapper's plan,
// which fits() holds it to).
template <typename X, int C>
__global__ void __launch_bounds__(kThreads, 2)
pairwise_l2_centroid_walk_kernel(const X* __restrict__ x, const float* __restrict__ c,
                                 float* __restrict__ out, int n, int m, int f,
                                 long long x_stride, long long c_stride, int slabs,
                                 int width, int groups, bool vec) {
    constexpr int R = group_rows(C);
    int blk = blockIdx.x;
    const int slab = blk % slabs;
    blk /= slabs;
    const int group = blk % groups, b = blk / groups;
    const int i0 = group * R, count = min(R, n - i0);
    const int f0 = slab * width, fl = min(width, f - f0);   // the slab
    const X* xb = x + b * x_stride + (size_t)i0 * f + f0;
    const float* cb = c + b * c_stride + f0;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    float acc[R][C];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < C; ++j) acc[r][j] = 0.f;
    // No load takes a branch: past the group's rows and past m the pointer
    // stays on the last row or centroid (L1 and L2 hits), and those sums
    // are never stored, so a column's R + C loads are all in flight before
    // its first use. Stepping one pointer a row, not indexing each row,
    // keeps the block at two an SM (128 registers; 172 with the row
    // offsets held, and a third of the bandwidth).
    if (vec) {
        const int f4 = fl / 4;
        for (int k = t; k < f4; k += kThreads) {
            float4 cc[C], a[R];
            const float* cr = cb + 4 * k;
#pragma unroll
            for (int j = 0; j < C; ++j) {
                cc[j] = load4(cr);
                if (j + 1 < m) cr += f;
            }
            const X* xr = xb + 4 * k;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                a[r] = load4(xr);
                if (r + 1 < count) xr += f;
            }
#pragma unroll
            for (int r = 0; r < R; ++r)
#pragma unroll
                for (int j = 0; j < C; ++j) acc[r][j] = sq_diff4(acc[r][j], a[r], cc[j]);
        }
    } else {
        for (int k = t; k < fl; k += kThreads) {
            float cs[C], xs[R];
            const float* cr = cb + k;
#pragma unroll
            for (int j = 0; j < C; ++j) {
                cs[j] = __ldg(cr);
                if (j + 1 < m) cr += f;
            }
            const X* xr = xb + k;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                xs[r] = load1(xr);
                if (r + 1 < count) xr += f;
            }
#pragma unroll
            for (int r = 0; r < R; ++r)
#pragma unroll
                for (int j = 0; j < C; ++j) {
                    const float d = xs[r] - cs[j];
                    acc[r][j] = fmaf(d, d, acc[r][j]);
                }
        }
    }
    __shared__ float warp_sums[R * C][kWarps];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < C; ++j)
            if (r < count && j < m) {
                float s = acc[r][j];
                for (int off = 16; off > 0; off >>= 1)
                    s += __shfl_down_sync(0xffffffffu, s, off);
                if (lane == 0) warp_sums[r * C + j][warp] = s;
            }
    __syncthreads();
    for (int q = warp; q < count * m; q += kWarps) {
        const int r = q / m, j = q % m;
        float s = lane < kWarps ? warp_sums[r * C + j][lane] : 0.f;
        for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
        if (lane == 0) out[((size_t)(b * n + i0 + r) * m + j) * slabs + slab] = s;
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

// Do the rows of x and c start on whole vectors (16 bytes of c, 4 x
// elements)?
template <typename X>
bool vectors(const X* x, const float* c, int f, long long x_stride, long long c_stride) {
    return f % 4 == 0 && x_stride % 4 == 0 && c_stride % 4 == 0 &&
           reinterpret_cast<uintptr_t>(x) % (4 * sizeof(X)) == 0 &&
           reinterpret_cast<uintptr_t>(c) % 16 == 0;
}

// Do `slabs` slabs of `width` columns cover f, each column once?
bool covers(int f, int slabs, int width) {
    return slabs >= 1 && width >= 1 && width % 4 == 0 && (long long)slabs * width >= f &&
           (long long)(slabs - 1) * width < (f > 0 ? f : 1);
}

// The second pass (slabs > 1) after the first, and the launch's error.
int sum_slabs(const float* part, float* out, int pairs, int slabs, cudaStream_t s) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || slabs == 1) return static_cast<int>(err);
    slab_sum_kernel<<<(pairs + kSumWarps - 1) / kSumWarps, kSumWarps * 32, 0, s>>>(
        part, out, pairs, slabs);
    return static_cast<int>(cudaGetLastError());
}

template <typename X, int C>
void launch_centroid_walk(const X* x, const float* c, float* dst, int batch, int n, int m,
                          int f, long long x_stride, long long c_stride, int slabs,
                          int width, int groups, bool vec, cudaStream_t s) {
    pairwise_l2_centroid_walk_kernel<X, C><<<batch * groups * slabs, kThreads, 0, s>>>(
        x, c, dst, n, m, f, x_stride, c_stride, slabs, width, groups, vec);
}

// Does `rows` suit `kernel` (0 pairwise_l2_kernel, 1 pairwise_l2_walk_kernel,
// 2 pairwise_l2_centroid_walk_kernel) at n rows and m centroids? The
// centroid walk compiles m rounded up to 4, 8 or 16 slots and its group of
// rows for them: rows must be that group, or n where n is fewer.
bool fits(int kernel, int rows, int n, int m) {
    if (kernel == 0) return rows == 1;
    if (kernel == 1) return rows > 1 && rows <= kMaxRows;
    if (kernel != 2 || m < 2 || m > kMaxCentroids) return false;
    const int group = group_rows(m <= 4 ? 4 : m <= 8 ? 8 : 16);
    return rows == (n < group ? n : group);
}

// The kernel of the wrapper's plan, then the second pass (slabs > 1).
template <typename X>
int launch(const X* x, const float* c, float* out, float* part, int batch, int n, int m,
           int f, long long x_stride, long long c_stride, int slabs, int width, int rows,
           int kernel, void* stream) {
    if (batch <= 0 || n <= 0 || m <= 0) return 0;
    if (!fits(kernel, rows, n, m) || !covers(f, slabs, width) ||
        (slabs > 1 && part == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool vec = vectors(x, c, f, x_stride, c_stride);
    const int pairs = batch * n * m, groups = (n + rows - 1) / rows;
    float* dst = slabs > 1 ? part : out;
    if (kernel == 2 && m <= 4)
        launch_centroid_walk<X, 4>(x, c, dst, batch, n, m, f, x_stride, c_stride, slabs,
                                   width, groups, vec, s);
    else if (kernel == 2 && m <= 8)
        launch_centroid_walk<X, 8>(x, c, dst, batch, n, m, f, x_stride, c_stride, slabs,
                                   width, groups, vec, s);
    else if (kernel == 2)
        launch_centroid_walk<X, 16>(x, c, dst, batch, n, m, f, x_stride, c_stride, slabs,
                                    width, groups, vec, s);
    else if (kernel == 1)
        pairwise_l2_walk_kernel<X><<<batch * groups * m * slabs, kThreads, 0, s>>>(
            x, c, dst, n, m, f, x_stride, c_stride, slabs, width, rows, groups, vec);
    else
        pairwise_l2_kernel<X><<<pairs * slabs, kThreads, 0, s>>>(
            x, c, dst, n, m, f, x_stride, c_stride, slabs, width, vec);
    return sum_slabs(part, out, pairs, slabs, s);
}

}  // namespace

// x: [batch, n, f] fp32 (pairwise_l2_f32) or bf16 (pairwise_l2_bf16), c:
// [batch, m, f] fp32, whose rows are row-major, entry b of x at x + b
// x_stride and of c at c + b c_stride (elements); out: [batch, n, m] fp32
// (batch = 1: the plain [n, f] x [m, f] -> [n, m]). f is cut into `slabs`
// slabs of `width` columns (a multiple of 4; the last may be shorter); with
// slabs > 1, part is scratch of batch n m slabs floats. `kernel` names the
// first pass (0 pairwise_l2_kernel, 1 pairwise_l2_walk_kernel, 2
// pairwise_l2_centroid_walk_kernel, for 2 <= m <= 16) and a block of it
// takes `rows` rows of x (1; 2 to 64; the centroid walk's group). Launches
// on `stream` (one kernel, or two with slabs > 1) and returns
// cudaGetLastError() (0 on success); cudaErrorInvalidValue for slabs that
// do not cover f or rows that do not suit the kernel.
extern "C" int pairwise_l2_f32(const float* x, const float* c, float* out, float* part,
                               int batch, int n, int m, int f, long long x_stride,
                               long long c_stride, int slabs, int width, int rows,
                               int kernel, void* stream) {
    return launch(x, c, out, part, batch, n, m, f, x_stride, c_stride, slabs, width, rows,
                  kernel, stream);
}

extern "C" int pairwise_l2_bf16(const uint16_t* x, const float* c, float* out,
                                float* part, int batch, int n, int m, int f,
                                long long x_stride, long long c_stride, int slabs,
                                int width, int rows, int kernel, void* stream) {
    return launch(x, c, out, part, batch, n, m, f, x_stride, c_stride, slabs, width, rows,
                  kernel, stream);
}

extern "C" const char* pairwise_l2_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
