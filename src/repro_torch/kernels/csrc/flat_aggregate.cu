// Weighted row sum over the flat client plane: out[p] = sum_n w[n] * flat[n, p].
// FedAvg's eq.-(4) fold as one GEMV, fp32 or bf16 rows in, fp32 out; with a
// leading batch axis (a cohort's seeds), one such sum per batch entry in the
// same launch: out[b, p] = sum_n w[b, n] * flat[b, n, p].
//
// Replaces the Pallas TPU kernel src/repro/kernels/flat_aggregate.py
// (flat_aggregate / _flat_aggregate_kernel). Bound on the card: bytes -- the
// live rows are read once (live * P * 4 bytes, 2 in bf16) for 2 flops per element, so
// the kernel is as fast as the loads it keeps in flight (Little's law: about
// 2 MB across the card at 3.35 TB/s).
//
// Design: the block's 256 threads form 4 row groups of 64 lanes, and the
// block owns 64 * V column vectors (float4 where P % 4 == 0 and the
// pointers are 16-byte aligned, float otherwise), neighbouring lanes on
// neighbouring addresses. At block start the live rows (w > 0; a NaN weight
// is not live) of each 256-row chunk are compacted into shared memory in
// ascending order (a warp ballot and a prefix over the warps' counts); group
// g then takes compact rows g, g + 4, ..., U at a time, issuing U x V
// streaming loads a lane before its FMAs: eight loads in flight a lane
// whatever N is (U = 2, V = 4 for at most 8 rows; U = 8, V = 1 above).
// After the last chunk the group partials are added in shared memory in
// group order. Which rows a group takes depends only on w, every sum runs in
// a fixed order and there are no atomics, so the result is the same bit for
// bit on every run. Skipping rows with w <= 0 is the same function as zeroing
// them first (a NaN row at weight 0 included). The batch is the grid's y
// axis: a block reads its batch entry's rows and weights only, so each
// entry's sum is the one a call on that entry alone gives, bit for bit.
//
// bf16 rows (flat_aggregate_bf16): the same kernel with 8 bf16 (16 bytes)
// or one bf16 a load, each widened exactly to fp32 before its FMA. The
// vector width changes which columns a lane holds, never which rows a
// group takes or the order of any column's sum, so the result is the fp32
// instance's on the widened rows, bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 4;                 // row groups
constexpr int kLanes = kThreads / kGroups; // lanes a group
constexpr int kChunk = kThreads;           // rows compacted at a time
constexpr unsigned kFull = 0xffffffffu;

struct bf16x8 {                       // 8 bf16 in one 16-byte load
    uint4 v;
};
struct float8 {
    float4 lo, hi;
};

// Load type T -> its fp32 accumulator Acc, the floats a T holds, the
// exact widening and a zero load.
template <typename T> struct Vec;
template <> struct Vec<float> {
    using Acc = float;
    static constexpr int kWidth = 1;
    static __device__ __forceinline__ Acc widen(float x) { return x; }
    static __device__ __forceinline__ float zero() { return 0.f; }
};
template <> struct Vec<float4> {
    using Acc = float4;
    static constexpr int kWidth = 4;
    static __device__ __forceinline__ Acc widen(float4 x) { return x; }
    static __device__ __forceinline__ float4 zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
};
template <> struct Vec<uint16_t> {      // one bf16
    using Acc = float;
    static constexpr int kWidth = 1;
    static __device__ __forceinline__ Acc widen(uint16_t x) { return bf16x1_to_float(x); }
    static __device__ __forceinline__ uint16_t zero() { return 0; }
};
template <> struct Vec<bf16x8> {
    using Acc = float8;
    static constexpr int kWidth = 8;
    static __device__ __forceinline__ Acc widen(bf16x8 x) {
        return {bf16x4_to_float4(make_uint2(x.v.x, x.v.y)),
                bf16x4_to_float4(make_uint2(x.v.z, x.v.w))};
    }
    static __device__ __forceinline__ bf16x8 zero() { return {make_uint4(0, 0, 0, 0)}; }
};

__device__ __forceinline__ float ld_stream(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float4 ld_stream(const float4* p) { return __ldcs(p); }
__device__ __forceinline__ uint16_t ld_stream(const uint16_t* p) { return __ldcs(p); }
__device__ __forceinline__ bf16x8 ld_stream(const bf16x8* p) {
    return {__ldcs(reinterpret_cast<const uint4*>(p))};
}

__device__ __forceinline__ float fma_w(float w, float x, float a) {
    return fmaf(w, x, a);
}
__device__ __forceinline__ float4 fma_w(float w, float4 x, float4 a) {
    return make_float4(fmaf(w, x.x, a.x), fmaf(w, x.y, a.y), fmaf(w, x.z, a.z),
                       fmaf(w, x.w, a.w));
}
__device__ __forceinline__ float8 fma_w(float w, float8 x, float8 a) {
    return {fma_w(w, x.lo, a.lo), fma_w(w, x.hi, a.hi)};
}
template <typename A> __device__ __forceinline__ A zero_acc();
template <> __device__ __forceinline__ float zero_acc<float>() { return 0.f; }
template <> __device__ __forceinline__ float4 zero_acc<float4>() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
}
template <> __device__ __forceinline__ float8 zero_acc<float8>() {
    return {zero_acc<float4>(), zero_acc<float4>()};
}

// flat: [batch, n_rows, p] of T; w: [batch, n_rows]; out: [batch, p * kWidth]
// fp32 (p counts T's, not floats); blockIdx.y is the batch entry. Group g
// takes compact rows g, g + kGroups, ..., U at a time, and loads U rows x V
// vectors a lane before its FMAs. The block covers kLanes * V vectors.
template <typename T, int U, int V>
__global__ void __launch_bounds__(kThreads) flat_aggregate_kernel(
        const T* __restrict__ flat, const float* __restrict__ w,
        float* __restrict__ out, int n_rows, int p) {
    using Acc = typename Vec<T>::Acc;
    constexpr int kCols = kLanes * V;                         // T's a block
    constexpr int kFloats = kCols * Vec<T>::kWidth;
    flat += (size_t)blockIdx.y * n_rows * p;                  // the entry's rows
    w += (size_t)blockIdx.y * n_rows;
    out += (size_t)blockIdx.y * p * Vec<T>::kWidth;
    __shared__ int row_s[kChunk];
    __shared__ float w_s[kChunk];
    __shared__ int count_s[kThreads / 32];
    __shared__ __align__(16) float part_s[kGroups * kFloats];

    const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
    const int group = tid / kLanes, lane = tid % kLanes;
    const int col0 = blockIdx.x * kCols + lane;

    Acc acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = zero_acc<Acc>();

    for (int c0 = 0; c0 < n_rows; c0 += kChunk) {
        // compact the live rows of [c0, c0 + kChunk) in ascending order
        const int n = c0 + tid;
        const float wn = n < n_rows ? __ldg(w + n) : 0.f;
        const bool live = wn > 0.f;
        const unsigned ballot = __ballot_sync(kFull, live);
        if (wl == 0) count_s[warp] = __popc(ballot);
        __syncthreads();
        int base = 0, total = 0;
#pragma unroll
        for (int j = 0; j < kThreads / 32; ++j) {
            const int cj = count_s[j];
            base += j < warp ? cj : 0;
            total += cj;
        }
        if (live) {
            const int at = base + __popc(ballot & ((1u << wl) - 1u));
            row_s[at] = n;
            w_s[at] = wn;
        }
        __syncthreads();

        for (int i0 = 0; i0 < total; i0 += kGroups * U) {
            T x[U][V];
            float wu[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int i = i0 + u * kGroups + group;
                const bool in = i < total;
                wu[u] = in ? w_s[i] : 0.f;
                const T* row = flat + (size_t)(in ? row_s[i] : 0) * p;
#pragma unroll
                for (int v = 0; v < V; ++v) {
                    const int col = col0 + kLanes * v;
                    x[u][v] = in && col < p ? ld_stream(row + col) : Vec<T>::zero();
                }
            }
#pragma unroll
            for (int u = 0; u < U; ++u)
#pragma unroll
                for (int v = 0; v < V; ++v)
                    acc[v] = fma_w(wu[u], Vec<T>::widen(x[u][v]), acc[v]);
        }
        __syncthreads();              // the list is read before it is rewritten
    }

    // the groups' partials, added in group order
    Acc* part = reinterpret_cast<Acc*>(part_s) + group * kCols;
#pragma unroll
    for (int v = 0; v < V; ++v) part[lane + kLanes * v] = acc[v];
    __syncthreads();
    const long long n_floats = (long long)p * Vec<T>::kWidth;
    for (int e = tid; e < kFloats; e += kThreads) {
        const long long col = (long long)blockIdx.x * kFloats + e;
        if (col >= n_floats) break;
        float s = part_s[e];
#pragma unroll
        for (int j = 1; j < kGroups; ++j) s += part_s[j * kFloats + e];
        out[col] = s;
    }
}

template <typename T, int U, int V>
void launch_tiles(const void* flat, const float* w, float* out, int batch,
                  int n_rows, int p, cudaStream_t s) {
    constexpr int per = Vec<T>::kWidth, cols = kLanes * V;
    const int pt = p / per;
    const dim3 grid((pt + cols - 1) / cols, batch);
    flat_aggregate_kernel<T, U, V><<<grid, kThreads, 0, s>>>(
        reinterpret_cast<const T*>(flat), w, out, n_rows, pt);
}

// Eight vectors in flight a lane: at most eight rows give each group two
// rows of four vectors, more rows eight rows of one.
template <typename T>
void launch(const void* flat, const float* w, float* out, int batch, int n_rows,
            int p, cudaStream_t s) {
    if (n_rows <= 2 * kGroups)
        launch_tiles<T, 2, 4>(flat, w, out, batch, n_rows, p, s);
    else
        launch_tiles<T, 8, 1>(flat, w, out, batch, n_rows, p, s);
}

}  // namespace

// flat: [batch, n_rows, p] row-major fp32 (flat_aggregate_f32) or bf16
// (flat_aggregate_bf16); w: [batch, n_rows] fp32; out: [batch, p] fp32
// (batch = 1: the plain [n_rows, p] x [n_rows] -> [p] fold). Launches on
// `stream` and returns cudaGetLastError() (0 on success);
// cudaErrorInvalidValue for a batch larger than a grid's y axis.
extern "C" int flat_aggregate_f32(const float* flat, const float* w, float* out,
                                  int batch, int n_rows, int p, void* stream) {
    if (p <= 0 || batch <= 0) return 0;
    if (batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    // entry b starts b n_rows p floats in: as aligned as entry 0 when p % 4 == 0
    if (p % 4 == 0 && reinterpret_cast<uintptr_t>(flat) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(out) % 16 == 0)
        launch<float4>(flat, w, out, batch, n_rows, p, s);
    else
        launch<float>(flat, w, out, batch, n_rows, p, s);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int flat_aggregate_bf16(const uint16_t* flat, const float* w, float* out,
                                   int batch, int n_rows, int p, void* stream) {
    if (p <= 0 || batch <= 0) return 0;
    if (batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    // 8 bf16 (16 bytes) a load where p % 8 == 0 and the rows are aligned
    if (p % 8 == 0 && reinterpret_cast<uintptr_t>(flat) % 16 == 0)
        launch<bf16x8>(flat, w, out, batch, n_rows, p, s);
    else
        launch<uint16_t>(flat, w, out, batch, n_rows, p, s);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flat_aggregate_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
