// Causal / sliding-window GQA attention, forward, fp32, with an online
// softmax over key tiles: out[b, i, h, :] = softmax_j(q_i . k_j / sqrt(D)) v_j
// over the unmasked keys j of query i.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _flash_kernel) and keeps its semantics: the 1/sqrt(D)
// scale goes on q; queries are right-aligned to keys (qpos = i + Sk - Sq);
// the mask is kpos <= qpos (causal) and qpos - kpos < window (window);
// masked scores are -1e30 and their p is forced to 0 where s <= -5e29; the
// denominator is clamped at 1e-30, so a row with no unmasked key (Sq > Sk)
// gives 0. GQA reads KV head h / (H / K) in place of a repeat, and q, k, v
// are read in their [B, S, heads, D] layout through the strides given.
//
// Bound on the card: operations at long S (4 D flops per unmasked (q, k)
// pair), latency at the FL path's S = 32. Design: one block of 256 threads
// per (b, h, 64-query tile); the TPU's sequential key-tile grid axis becomes
// a loop inside the block over 64-key tiles staged in shared memory (with a
// padded row stride, so the column reads hit distinct banks). Each thread
// keeps a 4 x 4 tile of scores and a 4 x D/16 tile of the output
// accumulator in registers; a warp per row does the max / exp / sum. Key
// tiles that the mask empties entirely are skipped (they would leave m, l
// and the accumulator unchanged). fp32 FMA throughout, no atomics, so the
// result is the same bit for bit on every run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int SP = BK + 1;            // score row stride in shared memory
constexpr float kNegInf = -1e30f;

struct Args {
    const float* q;
    const float* k;
    const float* v;
    float* out;
    int Sq, Sk, H, K;
    long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
    int causal, has_window, window;
    float scale;
};

template <int D>
constexpr int smem_floats() {
    return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * SP + 3 * BQ;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_kernel(Args A) {
    constexpr int DP = D + 1;
    constexpr int DC = D / 16;        // output columns per thread
    extern __shared__ float smem[];
    float* Qs = smem;                 // [BQ][DP]  q * scale
    float* Ks = Qs + BQ * DP;         // [BK][DP]
    float* Vs = Ks + BK * DP;         // [BK][D]
    float* Ss = Vs + BK * D;          // [BQ][SP]  scores, then p
    float* m_s = Ss + BQ * SP;        // [BQ] running max
    float* l_s = m_s + BQ;            // [BQ] running sum
    float* c_s = l_s + BQ;            // [BQ] this tile's correction

    const int tid = threadIdx.x;
    const int tx = tid & 15, ty = tid >> 4;
    const int warp = tid >> 5, lane = tid & 31;
    const int n_qt = (A.Sq + BQ - 1) / BQ;
    const int qt = blockIdx.x % n_qt;
    const int bh = blockIdx.x / n_qt;
    const int h = bh % A.H, b = bh / A.H;
    const int kh = h / (A.H / A.K);
    const int q0 = qt * BQ;
    const int shift = A.Sk - A.Sq;

    const float* qb = A.q + b * A.q_sb + h * A.q_sh;
    const float* kb = A.k + b * A.k_sb + kh * A.k_sh;
    const float* vb = A.v + b * A.v_sb + kh * A.v_sh;

    for (int e = tid; e < BQ * D; e += kThreads) {
        const int r = e / D, d = e % D, qi = q0 + r;
        Qs[r * DP + d] = qi < A.Sq ? qb[qi * A.q_ss + d] * A.scale : 0.f;
    }
    for (int r = tid; r < BQ; r += kThreads) {
        m_s[r] = kNegInf;
        l_s[r] = 0.f;
    }

    // the key tiles that hold at least one unmasked key of this query tile
    const long long qpos_lo = (long long)q0 + shift;
    const long long qpos_hi = (long long)min(q0 + BQ, A.Sq) - 1 + shift;
    long long k_lo = 0, k_hi = A.Sk - 1;
    if (A.causal) k_hi = min(k_hi, qpos_hi);
    if (A.has_window) k_lo = max(k_lo, qpos_lo - A.window + 1);
    const int kt_lo = (int)(k_lo / BK);
    const int kt_hi = k_hi < k_lo ? kt_lo - 1 : (int)(k_hi / BK);

    float acc[4][DC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;

    for (int kt = kt_lo; kt <= kt_hi; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();              // the last tile's readers are done
        for (int e = tid; e < BK * D; e += kThreads) {
            const int r = e / D, d = e % D, kj = k0 + r;
            const bool in = kj < A.Sk;
            Ks[r * DP + d] = in ? kb[kj * A.k_ss + d] : 0.f;
            Vs[r * D + d] = in ? vb[kj * A.v_ss + d] : 0.f;
        }
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
            float qv[4], kv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
            for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = ty + 16 * i;
            const long long qpos = (long long)q0 + r + shift;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int c = tx + 16 * j;
                const long long kpos = k0 + c;
                bool ok = kpos < A.Sk;
                if (A.causal) ok = ok && kpos <= qpos;
                if (A.has_window) ok = ok && (qpos - kpos) < A.window;
                Ss[r * SP + c] = ok ? s[i][j] : kNegInf;
            }
        }
        __syncthreads();

        // online softmax: warp w owns rows [8w, 8w + 8), a lane two columns
        for (int rr = 0; rr < BQ / 8; ++rr) {
            const int r = warp * (BQ / 8) + rr;
            const float s0 = Ss[r * SP + lane], s1 = Ss[r * SP + lane + 32];
            float mx = fmaxf(s0, s1);
            for (int off = 16; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_prev = m_s[r];
            const float m_new = fmaxf(m_prev, mx);
            const float p0 = s0 > 0.5f * kNegInf ? expf(s0 - m_new) : 0.f;
            const float p1 = s1 > 0.5f * kNegInf ? expf(s1 - m_new) : 0.f;
            float sum = p0 + p1;
            for (int off = 16; off > 0; off >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            Ss[r * SP + lane] = p0;
            Ss[r * SP + lane + 32] = p1;
            if (lane == 0) {
                const float corr = expf(m_prev - m_new);
                c_s[r] = corr;
                l_s[r] = l_s[r] * corr + sum;
                m_s[r] = m_new;
            }
        }
        __syncthreads();

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float corr = c_s[ty + 16 * i];
#pragma unroll
            for (int j = 0; j < DC; ++j) acc[i][j] *= corr;
        }
#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
            float pv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) pv[i] = Ss[(ty + 16 * i) * SP + kk];
#pragma unroll
            for (int j = 0; j < DC; ++j) {
                const float vv = Vs[kk * D + tx + 16 * j];
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
            }
        }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i, qi = q0 + r;
        if (qi >= A.Sq) continue;
        const float denom = fmaxf(l_s[r], 1e-30f);
        float* o = A.out + (((long long)b * A.Sq + qi) * A.H + h) * D;
#pragma unroll
        for (int j = 0; j < DC; ++j) o[tx + 16 * j] = acc[i][j] / denom;
    }
}

template <int D>
int launch(const Args& a, int blocks, cudaStream_t s) {
    constexpr int bytes = smem_floats<D>() * (int)sizeof(float);
    static const cudaError_t attr = cudaFuncSetAttribute(
        flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    flash_kernel<D><<<blocks, kThreads, bytes, s>>>(a);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: [B, Sq, H, D], k and v: [B, Sk, K, D] fp32 with unit stride over D and
// the given element strides over batch, sequence and head; out: [B, Sq, H, D]
// contiguous. D is 16, 32, 64 or 128; H is a multiple of K. window <= 0 with
// has_window masks every key. Launches on `stream` and returns
// cudaGetLastError() (0 on success); 1 (cudaErrorInvalidValue) for a D it
// was not built for.
extern "C" int flash_attention_f32(
        const float* q, const float* k, const float* v, float* out, int B,
        int Sq, int Sk, int H, int K, int D, long long q_sb, long long q_ss,
        long long q_sh, long long k_sb, long long k_ss, long long k_sh,
        long long v_sb, long long v_ss, long long v_sh, int causal,
        int has_window, int window, float scale, void* stream) {
    if (B <= 0 || Sq <= 0 || H <= 0) return 0;
    Args a{q, k, v, out, Sq, Sk, H, K, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
           v_sb, v_ss, v_sh, causal, has_window, window, scale};
    const int blocks = B * H * ((Sq + BQ - 1) / BQ);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 16: return launch<16>(a, blocks, s);
        case 32: return launch<32>(a, blocks, s);
        case 64: return launch<64>(a, blocks, s);
        case 128: return launch<128>(a, blocks, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

extern "C" const char* flash_attention_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
