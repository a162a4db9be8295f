// What the flash-attention kernels share (flash_attention.cu: fp32 in
// 3xTF32; flash_attention_bf16.cu: bf16 on the bf16 tensor cores): the
// kernel arguments, the key-tile range of a run of queries, the entry
// points' checks and launch, and the split-KV combine. Each .cu keeps its
// tile layout and its kernel body. Each chunk of key tiles leaves its
// unnormalised (m, l, acc) in fp32 scratch, m in the scaled score's units
// (the exponent base e); combine_kernel adds the chunks of a row in a fixed
// order, so a call gives the same bits on every run.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bf16.cuh"

namespace flash {

constexpr int kMaxChunks = 132;       // the wrapper's SPLIT_BLOCKS
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// T is the element: float, or uint16_t (the 16 bits of a bf16).
template <typename T>
struct Args {
    const T* q;
    const T* k;
    const T* v;
    T* out;
    float* part_acc;                  // [chunks, B, Sq, H, D] when chunks > 1
    float* part_ml;                   // [chunks, B, Sq, H, 2]
    int B, Sq, Sk, H, K, G;
    long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
    int causal, has_window, window;
    float scale;
    int row_tiles, chunks, tiles_per_chunk, first_tile;
    int q_vec, kv_vec;                // 16-byte copies allowed
};

// The tiles of BN keys holding an unmasked key of some query in [qlo, qhi];
// an empty range is lo = 0, hi = -1. The wrapper's key_tile_range mirrors
// it.
template <int BN, typename T>
__device__ __forceinline__ void key_tiles(const Args<T>& A, long long qlo, long long qhi,
                                          int& lo, int& hi) {
    long long klo = 0, khi = A.Sk - 1;
    if (A.causal) khi = min(khi, qhi);
    if (A.has_window) klo = max(klo, qlo - A.window + 1);
    if (khi < klo) {
        lo = 0;
        hi = -1;
        return;
    }
    lo = (int)(klo / BN);
    hi = (int)(khi / BN);
}

// One block per output row: the chunks' weights f_c = exp(m_c - max m) and
// l = sum f_c l_c (one warp), then sum f_c acc_c over (chunk slice, 4
// columns) threads, the slices added in slice order. Where D / 4 does not
// divide the block (D = 96: 24 columns, 10 slices), the threads past the
// last whole slice sit out.
constexpr int kCombineThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kCombineThreads) combine_kernel(
        const float* __restrict__ part_acc, const float* __restrict__ part_ml,
        T* __restrict__ out, long long n_rows, int D, int chunks) {
    __shared__ float f_s[kMaxChunks];
    __shared__ __align__(16) float red_s[4 * kCombineThreads];
    __shared__ float denom_s;
    const long long row = blockIdx.x;
    const int tid = threadIdx.x;
    if (tid < 32) {
        float m = kNegInf;
        for (int c = tid; c < chunks; c += 32)
            m = fmaxf(m, part_ml[(c * n_rows + row) * 2]);
        for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
        float l = 0.f;
        for (int c = tid; c < chunks; c += 32) {
            const float2 ml =
                *reinterpret_cast<const float2*>(part_ml + (c * n_rows + row) * 2);
            const float f = exp2f((ml.x - m) * kLog2e);
            f_s[c] = f;
            l = fmaf(ml.y, f, l);
        }
        for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(kFull, l, off);
        if (tid == 0) denom_s = fmaxf(l, 1e-30f);
    }
    __syncthreads();
    const int cols = D / 4, slices = kCombineThreads / cols;
    const int col = tid % cols, slice = tid / cols;
    if (slice < slices) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int c = slice; c < chunks; c += slices) {
            const float4 x = *reinterpret_cast<const float4*>(
                part_acc + (c * n_rows + row) * D + 4 * col);
            const float f = f_s[c];
            acc = make_float4(fmaf(f, x.x, acc.x), fmaf(f, x.y, acc.y),
                              fmaf(f, x.z, acc.z), fmaf(f, x.w, acc.w));
        }
        *reinterpret_cast<float4*>(red_s + slice * D + 4 * col) = acc;
    }
    __syncthreads();
    if (tid < D) {
        float sum = red_s[tid];
        for (int sl = 1; sl < slices; ++sl) sum += red_s[sl * D + tid];
        store1(out + row * D + tid, sum / denom_s);
    }
}

// `kernel` (the instance for D) over the plan's blocks of `threads`
// threads and `smem_bytes` of dynamic shared memory, then the combine where
// the plan has chunks; rows of `bm` packed rows a block. Returns
// cudaGetLastError() (0 on success), cudaErrorInvalidValue for row tiles
// that do not fit the shape.
template <int D, typename T>
int launch(void (*kernel)(Args<T>), int bm, int threads, int smem_bytes,
           const Args<T>& a, cudaStream_t s) {
    if (a.row_tiles != (a.Sq * a.G + bm - 1) / bm)
        return static_cast<int>(cudaErrorInvalidValue);
    // once for each (D, T): each is one kernel
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const int blocks = a.row_tiles * a.B * a.K * a.chunks;
    kernel<<<blocks, threads, smem_bytes, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || a.chunks == 1) return static_cast<int>(err);
    const long long n_rows = (long long)a.B * a.Sq * a.H;
    combine_kernel<T><<<(unsigned)n_rows, kCombineThreads, 0, s>>>(
        a.part_acc, a.part_ml, a.out, n_rows, D, a.chunks);
    return static_cast<int>(cudaGetLastError());
}

// rows of 16 bytes' elements start on whole 16-byte vectors
template <typename T>
bool aligned16(const T* p, long long sb, long long ss, long long sh) {
    constexpr long long vec = 16 / sizeof(T);
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % vec == 0 && ss % vec == 0 &&
           sh % vec == 0;
}

// An entry point's body: the checks every instance shares, the Args, and
// `by_d(std::integral_constant<int, D>, args, stream)` for the D given
// (cudaErrorInvalidValue for one it was not built for).
template <typename T, typename ByD>
int run(const T* q, const T* k, const T* v, T* out, float* part_acc, float* part_ml,
        int B, int Sq, int Sk, int H, int K, int D, long long q_sb, long long q_ss,
        long long q_sh, long long k_sb, long long k_ss, long long k_sh, long long v_sb,
        long long v_ss, long long v_sh, int causal, int has_window, int window,
        float scale, int row_tiles, int chunks, int tiles_per_chunk, int first_tile,
        void* stream, ByD by_d) {
    if (B <= 0 || Sq <= 0 || H <= 0) return 0;
    const int invalid = static_cast<int>(cudaErrorInvalidValue);
    if (K <= 0 || H % K || row_tiles < 1 || chunks < 1 || chunks > kMaxChunks ||
        tiles_per_chunk < 1 || first_tile < 0 ||
        (chunks > 1 && (part_acc == nullptr || part_ml == nullptr)))
        return invalid;
    const Args<T> a{q, k, v, out, part_acc, part_ml, B, Sq, Sk, H, K, H / K,
                    q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                    causal, has_window, window, scale,
                    row_tiles, chunks, tiles_per_chunk, first_tile,
                    aligned16(q, q_sb, q_ss, q_sh),
                    aligned16(k, k_sb, k_ss, k_sh) && aligned16(v, v_sb, v_ss, v_sh)};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 16: return by_d(std::integral_constant<int, 16>{}, a, s);
        case 32: return by_d(std::integral_constant<int, 32>{}, a, s);
        case 64: return by_d(std::integral_constant<int, 64>{}, a, s);
        case 96: return by_d(std::integral_constant<int, 96>{}, a, s);
        case 128: return by_d(std::integral_constant<int, 128>{}, a, s);
        default: return invalid;
    }
}

}  // namespace flash
