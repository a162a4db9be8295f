// Causal / sliding-window GQA attention, forward, fp32 in and out, with an
// online softmax over key tiles: out[b, i, h, :] = softmax_j(q_i . k_j /
// sqrt(D)) v_j over the unmasked keys j of query i.
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
// pair, on the tensor cores in 3xTF32, so 495/3 TFLOP/s), bytes and latency
// at the FL path's S = 32. Design:
// - Both products run on the tensor cores (mma.sync m16n8k8 TF32, fp32
//   accumulators) in 3xTF32: each fp32 operand x is split into
//   hi = tf32(x) and lo = tf32(x - hi), and a product is lo*hi + hi*lo +
//   hi*hi, which keeps about fp32's accuracy (plain TF32 would not). q is
//   scaled and split once per block into (hi, lo) pairs in shared memory.
// - A block of 4 warps owns 64 packed rows of one (b, KV head): row r is the
//   pair (query r / G, q-head kh * G + r % G) with G = H / K, so one K/V tile
//   in shared memory serves every head that reads it and a few queries fill
//   a whole tile. Each row keeps its own query position for the masks.
// - A warp owns 16 rows. Its score tile stays in the mma accumulators: it is
//   masked, max-reduced (quad shuffles), exponentiated and summed in place;
//   m, l and the output accumulator live in registers. The score fragment
//   feeds P.V without a re-layout: the C fragment holds keys 2t and 2t + 1
//   where the A fragment wants t and t + 4, so P.V runs its 8 keys in the
//   order (0, 2, 4, 6, 1, 3, 5, 7) and reads V's rows in that same order.
// - 32-key K/V tiles are double-buffered with cp.async (16-byte copies where
//   the pointers and strides allow, zero-filled past Sk), rows padded to
//   D + 4 floats so that every fragment read hits distinct banks. Key tiles
//   that the masks empty for the whole block are not visited, and a warp
//   skips those empty for its own rows (either leaves m, l and the
//   accumulator as they were).
// - Split-KV: when (b, KV head, row tile) blocks are few and key tiles many
//   (one query against a long cache), the wrapper cuts the key tiles into
//   chunks of at least two tiles (a count that depends on the shape alone);
//   each block writes its unnormalised (m, l, acc) to scratch and a second
//   kernel adds the chunks in a fixed order. A chunk with no unmasked key
//   carries m = -1e30, l = 0.
// No atomics, so the result is the same bit for bit on every run.
// - D is 16, 32, 64, 96 (phi-3-vision) or 128: D / 8 output n-tiles, rows
//   of D + 4 floats (the same bank pattern at every D).
// bf16 q, k, v take flash_attention_bf16.cu (bf16 tensor cores, 64-key
// tiles); the arguments, key_tiles(), the entry point's checks, the launch
// and the split-KV combine are shared (flash_common.cuh). The wrapper's plan
// (kernels/flash_attention.py: plan_attention, block_key_tiles) mirrors BM,
// BN, kMaxChunks and key_tiles().
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "tf32_mma.cuh"

namespace {

using namespace flash;
using namespace tf32;

constexpr int kThreads = 128;         // 4 warps, 16 packed rows each
constexpr int BM = 64;                // packed rows a block
constexpr int BN = 32;                // keys a tile

// Shared memory, in floats: Q as (hi, lo) pairs [BM][DP], then two K/V
// stages, each K [BN][DP] then V [BN][DP]. Rows are padded to DP = D + 4 so
// that every fragment read (4-byte raw, 8-byte pairs) hits distinct banks.
// The raw q tile is first copied into stage 1 (the same size: BM = 2 BN).
template <int D>
struct Tile {
    static constexpr int DP = D + 4;
    static constexpr int stage = 2 * BN * DP;
    static constexpr int smem_floats = 2 * BM * DP + 2 * stage;
};

using Args = flash::Args<float>;

// The block's packed rows of q (unscaled) into Qraw [BM][DP], zero past the
// last row.
template <int D>
__device__ __forceinline__ void load_q(const Args& A, float* Qraw, int b, int kh,
                                       int r0, int rows) {
    constexpr int DP = Tile<D>::DP;
    const int step = A.q_vec ? 4 : 1, per_row = D / step;
    for (int e = threadIdx.x; e < BM * per_row; e += kThreads) {
        const int r = e / per_row, c = (e % per_row) * step, pr = r0 + r;
        const bool in = pr < rows;
        const float* src = A.q;
        if (in)
            src += b * A.q_sb + (pr / A.G) * A.q_ss + (kh * A.G + pr % A.G) * A.q_sh + c;
        if (A.q_vec)
            copy4(Qraw + r * DP + c, src, in);
        else
            copy1(Qraw + r * DP + c, src, in);
    }
}

// K and V rows [k0, k0 + BN) into a stage, zero past Sk.
template <int D>
__device__ __forceinline__ void load_kv(const Args& A, float* stage,
                                        const float* kb, const float* vb, int k0) {
    constexpr int DP = Tile<D>::DP;
    float* Ks = stage;
    float* Vs = stage + BN * DP;
    const int step = A.kv_vec ? 4 : 1, per_row = D / step;
    for (int e = threadIdx.x; e < BN * per_row; e += kThreads) {
        const int r = e / per_row, c = (e % per_row) * step, kj = k0 + r;
        const bool in = kj < A.Sk;
        const float* ks = in ? kb + kj * A.k_ss + c : kb;
        const float* vs = in ? vb + kj * A.v_ss + c : vb;
        if (A.kv_vec) {
            copy4(Ks + r * DP + c, ks, in);
            copy4(Vs + r * DP + c, vs, in);
        } else {
            copy1(Ks + r * DP + c, ks, in);
            copy1(Vs + r * DP + c, vs, in);
        }
    }
}

template <int D>
__global__ void __launch_bounds__(kThreads, D == 128 ? 1 : 3) flash_kernel(const Args A) {
    constexpr int DP = Tile<D>::DP;
    constexpr int NS = BN / 8;        // score n-tiles (8 keys each)
    constexpr int NO = D / 8;         // output n-tiles (8 columns each)
    extern __shared__ __align__(16) float smem[];
    uint2* Qs = reinterpret_cast<uint2*>(smem);      // [BM][DP] (hi, lo) of q * scale
    float* stages = smem + 2 * BM * DP;              // 2 x (K [BN][DP], V [BN][DP])

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;

    // block -> (row tile, b, KV head, chunk); row tiles with the most keys
    // (the last under the causal mask) go first
    int x = blockIdx.x;
    const int chunk = x % A.chunks;
    x /= A.chunks;
    const int bk = x % (A.B * A.K);
    const int rt = A.row_tiles - 1 - x / (A.B * A.K);
    const int kh = bk % A.K, b = bk / A.K;
    const int rows = A.Sq * A.G;
    const int r0 = rt * BM;
    const int shift = A.Sk - A.Sq;

    // the block's key tiles: its rows' unmasked range, cut to its chunk
    int kt_lo, kt_hi;
    {
        const int last = min(r0 + BM, rows) - 1;
        key_tiles<BN>(A, (long long)(r0 / A.G) + shift,
                      (long long)(last / A.G) + shift, kt_lo, kt_hi);
        const int c_lo = A.first_tile + chunk * A.tiles_per_chunk;
        kt_lo = max(kt_lo, c_lo);
        kt_hi = min(kt_hi, c_lo + A.tiles_per_chunk - 1);
    }
    // the warp's rows and key tiles
    const int wr0 = r0 + warp * 16;
    const long long wq_lo = (long long)(wr0 / A.G) + shift;
    const long long wq_hi = (long long)((min(wr0 + 16, rows) - 1) / A.G) + shift;
    int wkt_lo = 0, wkt_hi = -1;
    if (wr0 < rows) key_tiles<BN>(A, wq_lo, wq_hi, wkt_lo, wkt_hi);
    const int prA = wr0 + g, prB = prA + 8;           // this thread's two rows
    const long long qposA = (long long)(prA / A.G) + shift;
    const long long qposB = (long long)(prB / A.G) + shift;

    const float* kb = A.k + b * A.k_sb + kh * A.k_sh;
    const float* vb = A.v + b * A.v_sb + kh * A.v_sh;

    float o[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    float mA = kNegInf, mB = kNegInf, lA = 0.f, lB = 0.f;

    if (kt_lo <= kt_hi) {
        // q into stage 1 and the first K/V tile into stage 0, then q split
        // once into (hi, lo) pairs for every key tile to come
        float* Qraw = stages + Tile<D>::stage;
        load_q<D>(A, Qraw, b, kh, r0, rows);
        load_kv<D>(A, stages, kb, vb, kt_lo * BN);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        for (int e = tid; e < BM * D; e += kThreads) {
            const int at = (e / D) * DP + e % D;
            uint32_t hi, lo;
            split(Qraw[at] * A.scale, hi, lo);
            Qs[at] = make_uint2(hi, lo);
        }
        __syncthreads();
    }
    for (int kt = kt_lo; kt <= kt_hi; ++kt) {
        const int buf = (kt - kt_lo) & 1;
        if (kt < kt_hi) {
            load_kv<D>(A, stages + (buf ^ 1) * Tile<D>::stage, kb, vb, (kt + 1) * BN);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();              // tile kt visible to all warps

        if (kt >= wkt_lo && kt <= wkt_hi) {
            const float* Ks = stages + buf * Tile<D>::stage;
            const float* Vs = Ks + BN * DP;
            const uint2* Qw = Qs + warp * 16 * DP;
            const int k0 = kt * BN;

            // S = Q K^T: rows g, g + 8; keys n * 8 + 2t, n * 8 + 2t + 1
            float s[NS][4];
#pragma unroll
            for (int n = 0; n < NS; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < D / 8; ++kk) {
                const uint2 q0 = Qw[g * DP + kk * 8 + t];
                const uint2 q1 = Qw[(g + 8) * DP + kk * 8 + t];
                const uint2 q2 = Qw[g * DP + kk * 8 + t + 4];
                const uint2 q3 = Qw[(g + 8) * DP + kk * 8 + t + 4];
                const uint32_t ahi[4] = {q0.x, q1.x, q2.x, q3.x};
                const uint32_t alo[4] = {q0.y, q1.y, q2.y, q3.y};
#pragma unroll
                for (int n = 0; n < NS; ++n) {
                    uint32_t bhi[2], blo[2];
                    split(Ks[(n * 8 + g) * DP + kk * 8 + t], bhi[0], blo[0]);
                    split(Ks[(n * 8 + g) * DP + kk * 8 + t + 4], bhi[1], blo[1]);
                    mma_3xtf32(s[n], ahi, alo, bhi, blo);
                }
            }

            // masks, only where the tile is not wholly inside every row's range
            const bool inside = k0 + BN <= A.Sk &&
                                (!A.causal || k0 + BN - 1 <= wq_lo) &&
                                (!A.has_window || wq_hi - k0 < A.window);
            if (!inside) {
#pragma unroll
                for (int n = 0; n < NS; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const long long kpos = k0 + n * 8 + 2 * t + (e & 1);
                        const long long qpos = e < 2 ? qposA : qposB;
                        bool ok = kpos < A.Sk;
                        if (A.causal) ok = ok && kpos <= qpos;
                        if (A.has_window) ok = ok && qpos - kpos < A.window;
                        if (!ok) s[n][e] = kNegInf;
                    }
            }

            // online softmax; a row's four threads form a quad
            float mxA = kNegInf, mxB = kNegInf;
#pragma unroll
            for (int n = 0; n < NS; ++n) {
                mxA = fmaxf(mxA, fmaxf(s[n][0], s[n][1]));
                mxB = fmaxf(mxB, fmaxf(s[n][2], s[n][3]));
            }
#pragma unroll
            for (int off = 1; off <= 2; off <<= 1) {
                mxA = fmaxf(mxA, __shfl_xor_sync(kFull, mxA, off));
                mxB = fmaxf(mxB, __shfl_xor_sync(kFull, mxB, off));
            }
            const float mnA = fmaxf(mA, mxA), mnB = fmaxf(mB, mxB);
            const float cA = exp2f((mA - mnA) * kLog2e);
            const float cB = exp2f((mB - mnB) * kLog2e);
            mA = mnA;
            mB = mnB;
            float sumA = 0.f, sumB = 0.f;
#pragma unroll
            for (int n = 0; n < NS; ++n) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float mn = e < 2 ? mnA : mnB;
                    s[n][e] = s[n][e] > 0.5f * kNegInf ? exp2f((s[n][e] - mn) * kLog2e)
                                                       : 0.f;
                }
                sumA += s[n][0] + s[n][1];
                sumB += s[n][2] + s[n][3];
            }
            lA = lA * cA + sumA;      // this thread's share; the quad adds up last
            lB = lB * cB + sumB;
#pragma unroll
            for (int n = 0; n < NO; ++n) {
                o[n][0] *= cA;
                o[n][1] *= cA;
                o[n][2] *= cB;
                o[n][3] *= cB;
            }

            // O += P V, 8 keys a step in the order (2t | 2t + 1): A fragment
            // (row, t) = key 2t, (row, t + 4) = key 2t + 1
#pragma unroll
            for (int kk = 0; kk < NS; ++kk) {
                uint32_t ahi[4], alo[4];
                split(s[kk][0], ahi[0], alo[0]);
                split(s[kk][2], ahi[1], alo[1]);
                split(s[kk][1], ahi[2], alo[2]);
                split(s[kk][3], ahi[3], alo[3]);
                const float* v0 = Vs + (kk * 8 + 2 * t) * DP + g;
#pragma unroll
                for (int n = 0; n < NO; ++n) {
                    uint32_t bhi[2], blo[2];
                    split(v0[n * 8], bhi[0], blo[0]);
                    split(v0[DP + n * 8], bhi[1], blo[1]);
                    mma_3xtf32(o[n], ahi, alo, bhi, blo);
                }
            }
        }
        __syncthreads();              // every warp is done with stage buf
    }

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
        lA += __shfl_xor_sync(kFull, lA, off);
        lB += __shfl_xor_sync(kFull, lB, off);
    }

#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int pr = half ? prB : prA;
        if (pr >= rows) continue;
        const int i = pr / A.G, h = kh * A.G + pr % A.G;
        const long long row = ((long long)b * A.Sq + i) * A.H + h;
        const float m = half ? mB : mA, l = half ? lB : lA;
        if (A.chunks == 1) {
            const float denom = fmaxf(l, 1e-30f);
            float* dst = A.out + row * D + 2 * t;
#pragma unroll
            for (int n = 0; n < NO; ++n)
                store2(dst + n * 8, o[n][2 * half] / denom, o[n][2 * half + 1] / denom);
        } else {
            const long long prow = (long long)chunk * A.B * A.Sq * A.H + row;
            float* dst = A.part_acc + prow * D + 2 * t;
#pragma unroll
            for (int n = 0; n < NO; ++n)
                *reinterpret_cast<float2*>(dst + n * 8) =
                    make_float2(o[n][2 * half], o[n][2 * half + 1]);
            if (t == 0)
                *reinterpret_cast<float2*>(A.part_ml + prow * 2) = make_float2(m, l);
        }
    }
}

}  // namespace

// q: [B, Sq, H, D], k and v: [B, Sk, K, D] fp32 with unit stride over D
// and the given element strides over batch, sequence and head; out: [B, Sq,
// H, D] fp32 contiguous. D is 16, 32, 64, 96 or 128; H is a multiple of K.
// window <= 0 with has_window masks every key. The plan (row tiles of 64
// packed rows; key tiles of 32 keys; chunks of tiles_per_chunk key tiles
// from first_tile) comes from the wrapper; with chunks > 1, part_acc and
// part_ml are fp32 scratch of chunks * B * Sq * H * D and chunks * B * Sq *
// H * 2 floats. Launches on `stream` and returns cudaGetLastError() (0 on
// success); 1 (cudaErrorInvalidValue) for a D it was not built for or a
// plan that does not fit the shape.
extern "C" int flash_attention_f32(
        const float* q, const float* k, const float* v, float* out,
        float* part_acc, float* part_ml, int B, int Sq, int Sk, int H, int K,
        int D, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
        long long k_ss, long long k_sh, long long v_sb, long long v_ss,
        long long v_sh, int causal, int has_window, int window, float scale,
        int row_tiles, int chunks, int tiles_per_chunk, int first_tile,
        void* stream) {
    return flash::run(q, k, v, out, part_acc, part_ml, B, Sq, Sk, H, K, D, q_sb, q_ss,
                      q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, causal, has_window,
                      window, scale, row_tiles, chunks, tiles_per_chunk, first_tile,
                      stream, [](auto d, const auto& a, cudaStream_t s) {
                          constexpr int D = decltype(d)::value;
                          return flash::launch<D>(flash_kernel<D>, BM, kThreads,
                                                  Tile<D>::smem_floats * (int)sizeof(float),
                                                  a, s);
                      });
}

extern "C" const char* flash_attention_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
