// Weighted row sum over the flat client plane: out[p] = sum_n w[n] * flat[n, p].
// FedAvg's eq.-(4) fold as one GEMV, fp32 in and out.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flat_aggregate.py
// (flat_aggregate / _flat_aggregate_kernel). Bound on the card: bytes -- the
// plane is read once (N*P*4 bytes) for 2 flops per element. Design: one
// thread owns four consecutive columns (16-byte float4 loads, neighbouring
// threads on neighbouring addresses) and walks all N rows in a fixed order
// with fp32 fma accumulation. No split over N and no atomics, so the result
// is the same bit for bit on every run. Rows with w <= 0 are skipped, which
// is the same function as zeroing them first (a NaN row at weight 0 included).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void flat_aggregate_vec4(const float4* __restrict__ flat,
                                    const float* __restrict__ w,
                                    float4* __restrict__ out, int n_rows,
                                    int p4) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= p4) return;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int n = 0; n < n_rows; ++n) {
        const float wn = __ldg(w + n);
        if (wn > 0.f) {
            const float4 v = __ldg(flat + (size_t)n * p4 + j);
            acc.x = fmaf(wn, v.x, acc.x);
            acc.y = fmaf(wn, v.y, acc.y);
            acc.z = fmaf(wn, v.z, acc.z);
            acc.w = fmaf(wn, v.w, acc.w);
        }
    }
    out[j] = acc;
}

__global__ void flat_aggregate_scalar(const float* __restrict__ flat,
                                      const float* __restrict__ w,
                                      float* __restrict__ out, int n_rows,
                                      int p) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= p) return;
    float acc = 0.f;
    for (int n = 0; n < n_rows; ++n) {
        const float wn = __ldg(w + n);
        if (wn > 0.f) acc = fmaf(wn, __ldg(flat + (size_t)n * p + j), acc);
    }
    out[j] = acc;
}

}  // namespace

// flat: [n_rows, p] row-major fp32; w: [n_rows] fp32; out: [p] fp32.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int flat_aggregate_f32(const float* flat, const float* w, float* out,
                                  int n_rows, int p, void* stream) {
    if (p <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool vec = p % 4 == 0 && reinterpret_cast<uintptr_t>(flat) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
    if (vec) {
        const int p4 = p / 4;
        flat_aggregate_vec4<<<(p4 + kThreads - 1) / kThreads, kThreads, 0, s>>>(
            reinterpret_cast<const float4*>(flat), w, reinterpret_cast<float4*>(out),
            n_rows, p4);
    } else {
        flat_aggregate_scalar<<<(p + kThreads - 1) / kThreads, kThreads, 0, s>>>(
            flat, w, out, n_rows, p);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flat_aggregate_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
