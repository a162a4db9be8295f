// Mamba-2 SSD scan, fp32: for each (b, h), with dA the log-decay a, the
// recurrence h_t = exp(a_t) h_{t-1} + x_t (outer) b_t, y_t = h_t c_t,
// computed in chunks of Q steps. Returns y and the final state.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py
// (ssd_scan / _ssd_kernel) and computes what it computes, per chunk with
// acum = the inclusive cumsum of a over the chunk:
//   y_i = sum_{j <= i} (c_i . b_j) exp(acum_i - acum_j) x_j       (intra)
//       + exp(acum_i) (h c_i)                                      (carried)
//   h'  = exp(acum_last) h + sum_q exp(acum_last - acum_q) x_q (outer) b_q
// A ragged last chunk stops at S, which is what the TPU's padding with
// a = 0, x = 0 amounts to. Group g = h / (H / G) of b and c is read in
// place of a repeat, and x, a, b, c are read in their [B, S, heads, .]
// layout through the strides given.
//
// Bound on the card: operations, 2 Q^2 (N + P) + 4 Q P N flops per (b h,
// chunk). Design: one block of 256 threads per (b h, slice of PS columns of
// P); the columns p of y and h are independent, so the wrapper picks PS to
// put enough blocks on the SMs when B H is small. The chunk loop is
// sequential inside the block, with the slice's [PS, N] state in shared
// memory. The [Q, Q] intra-chunk block (256 KB at Q = 256) is never held
// whole: it is built 32 x 32 at a time, C row tile against B column tile,
// and folded into the 32-row output tile at once. All sums are fp32 FMA in
// a fixed order, no atomics: the same bits on every run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int TI = 32;                // rows of a C, B or x tile
constexpr int GP = TI + 1;            // row stride of the 32 x 32 block
constexpr int SE = 8;                 // state entries a thread sums at once

struct Args {
    const float* x;
    const float* a;
    const float* b;
    const float* c;
    float* y;
    float* h_out;
    int S, H, G, P, N, Q;
    long long x_sb, x_ss, x_sh, a_sb, a_ss, a_sh;
    long long b_sb, b_ss, b_sg, c_sb, c_ss, c_sg;
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

inline int smem_floats(int Q, int N, int PS) {
    const int NP = N + 1;
    return round4(Q) + 2 * TI * NP + TI * PS + TI * GP + PS * NP + kWarps;
}

template <int PS>
__global__ void __launch_bounds__(kThreads) ssd_kernel(Args A) {
    constexpr int E = TI * PS / kThreads;    // y outputs per thread
    extern __shared__ float smem[];
    const int N = A.N, NP = N + 1;
    float* acum = smem;                      // [Q]
    float* Cs = acum + round4(A.Q);          // [TI][NP]
    float* Bs = Cs + TI * NP;                // [TI][NP]
    float* Xs = Bs + TI * NP;                // [TI][PS]
    float* Gs = Xs + TI * PS;                // [TI][GP]
    float* hs = Gs + TI * GP;                // [PS][NP] carried state
    float* wsum = hs + PS * NP;              // [kWarps]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int n_ps = A.P / PS;
    const int ps = blockIdx.x % n_ps, bh = blockIdx.x / n_ps;
    const int h = bh % A.H, bb = bh / A.H;
    const int g = h / (A.H / A.G);
    const int p0 = ps * PS;
    const float* xb = A.x + bb * A.x_sb + h * A.x_sh + p0;
    const float* ab = A.a + bb * A.a_sb + h * A.a_sh;
    const float* bp = A.b + bb * A.b_sb + g * A.b_sg;
    const float* cp = A.c + bb * A.c_sb + g * A.c_sg;
    const long long y_ss = (long long)A.H * A.P;
    float* yb = A.y + ((long long)bb * A.S * A.H + h) * A.P + p0;

    for (int e = tid; e < PS * N; e += kThreads) hs[(e / N) * NP + e % N] = 0.f;

    for (int t0 = 0; t0 < A.S; t0 += A.Q) {
        const int Ql = min(A.Q, A.S - t0);
        // acum = inclusive cumsum of a over the chunk (a block scan)
        float carry = 0.f;
        for (int s0 = 0; s0 < Ql; s0 += kThreads) {
            const int i = s0 + tid;
            float v = i < Ql ? ab[(t0 + i) * A.a_ss] : 0.f;
            for (int off = 1; off < 32; off <<= 1) {
                const float up = __shfl_up_sync(0xffffffffu, v, off);
                if (lane >= off) v += up;
            }
            __syncthreads();          // wsum's last readers are done
            if (lane == 31) wsum[warp] = v;
            __syncthreads();
            float pre = carry, tot = carry;
            for (int w = 0; w < kWarps; ++w) {
                if (w < warp) pre += wsum[w];
                tot += wsum[w];
            }
            if (i < Ql) acum[i] = v + pre;
            carry = tot;
        }
        __syncthreads();

        // y, one 32-row tile at a time. Each thread owns E (row, column)
        // outputs; the loops run the E sums side by side.
        for (int it = 0; it < Ql; it += TI) {
            __syncthreads();          // Cs and hs readers of the last tile
            for (int e = tid; e < TI * N; e += kThreads) {
                const int r = e / N, n = e % N, t = it + r;
                Cs[r * NP + n] = t < Ql ? cp[(t0 + t) * A.c_ss + n] : 0.f;
            }
            __syncthreads();
            float yv[E];
#pragma unroll
            for (int k = 0; k < E; ++k) yv[k] = 0.f;
            for (int n = 0; n < N; ++n) {   // the carried state through C
#pragma unroll
                for (int k = 0; k < E; ++k) {
                    const int e = tid + kThreads * k;
                    yv[k] = fmaf(Cs[(e / PS) * NP + n], hs[(e % PS) * NP + n], yv[k]);
                }
            }
#pragma unroll
            for (int k = 0; k < E; ++k) {
                const int r = (tid + kThreads * k) / PS;
                yv[k] = it + r < Ql ? yv[k] * expf(acum[it + r]) : 0.f;
            }
            for (int jt = 0; jt <= it; jt += TI) {
                __syncthreads();      // Bs, Xs, Gs readers of the last tile
                for (int e = tid; e < TI * N; e += kThreads) {
                    const int r = e / N, n = e % N, t = jt + r;
                    Bs[r * NP + n] = t < Ql ? bp[(t0 + t) * A.b_ss + n] : 0.f;
                }
                for (int e = tid; e < TI * PS; e += kThreads) {
                    const int r = e / PS, p = e % PS, t = jt + r;
                    Xs[e] = t < Ql ? xb[(t0 + t) * A.x_ss + p] : 0.f;
                }
                __syncthreads();
                // the 32 x 32 block: warp w owns rows w, w + 8, w + 16,
                // w + 24 and lane j column j
                constexpr int GR = TI * TI / kThreads;
                float g[GR];
#pragma unroll
                for (int k = 0; k < GR; ++k) g[k] = 0.f;
                for (int n = 0; n < N; ++n) {
                    const float bv = Bs[lane * NP + n];
#pragma unroll
                    for (int k = 0; k < GR; ++k)
                        g[k] = fmaf(Cs[(warp + kWarps * k) * NP + n], bv, g[k]);
                }
#pragma unroll
                for (int k = 0; k < GR; ++k) {
                    const int r = warp + kWarps * k;
                    const int i_c = it + r, j_c = jt + lane;
                    Gs[r * GP + lane] = (j_c <= i_c && i_c < Ql)
                                            ? g[k] * expf(acum[i_c] - acum[j_c]) : 0.f;
                }
                __syncthreads();
#pragma unroll 4
                for (int j = 0; j < TI; ++j) {
#pragma unroll
                    for (int k = 0; k < E; ++k) {
                        const int e = tid + kThreads * k;
                        yv[k] = fmaf(Gs[(e / PS) * GP + j], Xs[j * PS + e % PS], yv[k]);
                    }
                }
            }
#pragma unroll
            for (int k = 0; k < E; ++k) {
                const int e = tid + kThreads * k, r = e / PS, p = e % PS;
                if (it + r < Ql) yb[(t0 + it + r) * y_ss + p] = yv[k];
            }
        }

        // state: h' = exp(acum_last) h + sum_q exp(acum_last - acum_q) x_q b_q
        __syncthreads();              // every reader of the old state is done
        const float a_last = acum[Ql - 1];
        const float decay = expf(a_last);
        for (int e = tid; e < PS * N; e += kThreads) hs[(e / N) * NP + e % N] *= decay;
        for (int jt = 0; jt < Ql; jt += TI) {
            __syncthreads();
            for (int e = tid; e < TI * N; e += kThreads) {
                const int r = e / N, n = e % N, t = jt + r;
                Bs[r * NP + n] = t < Ql ? bp[(t0 + t) * A.b_ss + n] : 0.f;
            }
            for (int e = tid; e < TI * PS; e += kThreads) {
                const int r = e / PS, p = e % PS, t = jt + r;
                Xs[e] = t < Ql ? xb[(t0 + t) * A.x_ss + p] * expf(a_last - acum[t])
                               : 0.f;
            }
            __syncthreads();
            // a thread's state entries e = tid + 256 k, up to SE of them at
            // a time, summed side by side (the same owner as the scaling)
            for (int e0 = tid; e0 < PS * N; e0 += kThreads * SE) {
                float acc[SE];
                int p[SE], n[SE];
#pragma unroll
                for (int k = 0; k < SE; ++k) {
                    const int e = min(e0 + kThreads * k, PS * N - 1);
                    p[k] = e / N;
                    n[k] = e % N;
                    acc[k] = hs[p[k] * NP + n[k]];
                }
#pragma unroll 4
                for (int r = 0; r < TI; ++r) {
#pragma unroll
                    for (int k = 0; k < SE; ++k)
                        acc[k] = fmaf(Xs[r * PS + p[k]], Bs[r * NP + n[k]], acc[k]);
                }
#pragma unroll
                for (int k = 0; k < SE; ++k)
                    if (e0 + kThreads * k < PS * N) hs[p[k] * NP + n[k]] = acc[k];
            }
        }
        __syncthreads();              // acum and hs settle before the next chunk
    }

    float* ho = A.h_out + ((long long)bh * A.P + p0) * N;
    for (int e = tid; e < PS * N; e += kThreads) ho[e] = hs[(e / N) * NP + e % N];
}

template <int PS>
int launch(const Args& a, int blocks, cudaStream_t s) {
    const int bytes = smem_floats(a.Q, a.N, PS) * (int)sizeof(float);
    const cudaError_t attr = cudaFuncSetAttribute(
        ssd_kernel<PS>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    ssd_kernel<PS><<<blocks, kThreads, bytes, s>>>(a);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [B, S, H, P], a: [B, S, H], b and c: [B, S, G, N] fp32 with unit
// stride over the last axis (a: over none) and the given element strides;
// y: [B, S, H, P] and h_out: [B, H, P, N] contiguous. Q is the chunk
// (min(chunk, S)), PS in {8, 16, 32, 64} divides P, H is a multiple of G.
// Launches on `stream` and returns cudaGetLastError() (0 on success);
// cudaErrorInvalidValue for a PS it was not built for.
extern "C" int ssd_scan_f32(const float* x, const float* a, const float* b,
                            const float* c, float* y, float* h_out, int B, int S,
                            int H, int G, int P, int N, int Q, int PS,
                            long long x_sb, long long x_ss, long long x_sh,
                            long long a_sb, long long a_ss, long long a_sh,
                            long long b_sb, long long b_ss, long long b_sg,
                            long long c_sb, long long c_ss, long long c_sg,
                            void* stream) {
    if (B <= 0 || H <= 0 || S <= 0) return 0;
    Args args{x, a, b, c, y, h_out, S, H, G, P, N, Q, x_sb, x_ss, x_sh,
              a_sb, a_ss, a_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg};
    const int blocks = B * H * (P / PS);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (PS) {
        case 8: return launch<8>(args, blocks, s);
        case 16: return launch<16>(args, blocks, s);
        case 32: return launch<32>(args, blocks, s);
        case 64: return launch<64>(args, blocks, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

extern "C" const char* ssd_scan_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
