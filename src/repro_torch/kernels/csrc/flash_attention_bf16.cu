// Causal / sliding-window GQA attention, forward, bf16 in and out, on the
// bf16 tensor cores: out[b, i, h, :] = softmax_j(q_i . k_j / sqrt(D)) v_j
// over the unmasked keys j of query i.
//
// Replaces, for a bf16 model, the Pallas TPU kernel
// src/repro/kernels/flash_attention.py (flash_attention / _flash_kernel),
// whose semantics it keeps as the fp32 instance (flash_attention.cu) does:
// the 1/sqrt(D) scale; queries right-aligned to keys (qpos = i + Sk - Sq);
// the mask kpos <= qpos (causal) and qpos - kpos < window (window); masked
// scores at -1e30 with their p forced to 0 where s <= -5e29; the
// denominator clamped at 1e-30, so a row with no unmasked key (Sq > Sk)
// gives 0. GQA reads KV head h / (H / K), and q, k, v are read in their
// [B, S, heads, D] layout through the strides given.
//
// Bound on the card: operations at long S (4 D flops per unmasked (q, k)
// pair at bf16's 989 TFLOP/s), bytes and latency at the FL path's S = 32.
// mma.sync reaches only part of that rate, and at D = 64 a tile's
// softmax (a max, an exp2 and a sum a score) issues about as many
// instructions as its products, so the design keeps the instructions a
// tile few. Design:
// - q, k, v stay bf16 in shared memory (rows padded to D + 8 elements, so
//   the eight 16-byte rows an ldmatrix phase reads hit distinct banks at
//   every D), loaded with 16-byte cp.async copies (zero-filled past the
//   last row or key; one element at a time, synchronously, where the
//   pointers or strides are not 16-byte aligned). K/V tiles of 64 keys run
//   through a ring of kStages stages: tile i + kStages - 1 is in flight
//   while tile i is computed, one barrier a tile.
// - Both products run on mma.sync m16n8k16 bf16 with fp32 accumulators:
//   S = Q K^T from ldmatrix fragments of Q (loaded into registers once) and
//   K; O += P V with P from the score registers (two 8-key C fragments are
//   one 16-key A fragment, rounded to bf16 pairs) and V through
//   ldmatrix.trans.
// - A block of 4 warps owns BM packed rows of one (b, KV head): row r is the
//   pair (query r / G, q-head kh * G + r % G) with G = H / K, so one K/V tile
//   serves every head that reads it. A warp owns MT m-tiles of 16 rows (two
//   at D <= 64: each K and V fragment read from shared memory feeds two
//   products, which halves those reads per flop; one at D = 96 and 128, whose
//   accumulators would not fit twice in registers), so BM is 128 or 64.
//   The warp's scores, m, l and output accumulators stay in registers. The
//   online softmax is fp32 on the unscaled scores, with scale * log2(e)
//   folded into one fma and one MUFU ex2 a score (m is kept unscaled and
//   written scaled for the combine).
// - Key tiles that the masks empty for the whole block are not visited, and
//   a warp skips those empty for its own rows.
// - Split-KV as in the fp32 instance: the wrapper's plan cuts the key tiles
//   into chunks (of 64-key tiles here); each block writes its unnormalised
//   (m, l, acc) to fp32 scratch and combine_kernel (flash_common.cuh) adds
//   the chunks in a fixed order.
// No atomics, so the result is the same bit for bit on every run. P is
// rounded to bf16 for P V and the output once to bf16, so the result is
// not the fp32 instance's on the widened inputs rounded: it is held to the
// plain version (and to that instance) within the reference's bf16
// tolerance, 2e-2.
// The arguments, key_tiles(), the entry point's checks and the launch are
// shared with the fp32 instance (flash_common.cuh). The wrapper's plan
// (kernels/flash_attention.py: plan_attention, block_key_tiles at
// block_shape(bfloat16, D)) mirrors BM, BN and key_tiles().
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16.cuh"
#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kThreads = 128;         // 4 warps
constexpr int BN = 64;                // keys a tile
constexpr int kStages = 2;            // K/V tiles in the ring

// MT m-tiles of 16 packed rows a warp, BM = 64 MT rows a block (the design
// note above). Shared memory, in bf16 elements: Q [BM][DP], then kStages
// stages of K [BN][DP] and V [BN][DP].
template <int D>
struct Tile {
    static constexpr int MT = D <= 64 ? 2 : 1;
    static constexpr int BM = 4 * 16 * MT;
    static constexpr int DP = D + 8;
    static constexpr int q_elems = BM * DP;
    static constexpr int stage = 2 * BN * DP;
    static constexpr int smem_bytes = (q_elems + kStages * stage) * 2;
};

using Args = flash::Args<uint16_t>;

// 16 bytes (8 bf16) from global to shared memory, asynchronously; zeros
// where `in` is false (src is then not read)
__device__ __forceinline__ void cp_async16(uint16_t* dst, const uint16_t* src, bool in) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(in ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; register j holds matrix j's (g, 2t .. 2t + 1)
// (.trans: its (2t .. 2t + 1, g)) for lane = 4 g + t
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const uint16_t* p) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const uint16_t* p) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s) : "memory");
}

// c += a * b on mma.sync m16n8k16, bf16 operands, fp32 accumulators. For
// lane = 4 g + t: A (16 x 16, row) a0 = (g, 2t..), a1 = (g + 8, 2t..),
// a2 = (g, 2t + 8..), a3 = (g + 8, 2t + 8..); B (16 x 8, col) b0 = (k 2t..,
// n g), b1 = (k 2t + 8.., n g); C c0, c1 = (g, 2t, 2t + 1), c2, c3 =
// (g + 8, 2t, 2t + 1)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one MUFU operation, subnormal results flushed to zero (exp2f's
// subnormal handling costs instructions on every score; a p below 2^-126
// of the row's largest adds nothing at bf16's precision)
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// (lo, hi) rounded to bf16 (to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    uint32_t r;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
    return r;
}

// The block's packed rows of q into Qs [BM][DP], zero past the last row.
template <int D>
__device__ __forceinline__ void load_q(const Args& A, uint16_t* Qs, int b, int kh, int r0,
                                       int rows) {
    constexpr int DP = Tile<D>::DP, BM = Tile<D>::BM;
    const uint16_t* qb = A.q + b * A.q_sb;
    if (A.q_vec) {
        constexpr int per_row = D / 8;
        for (int e = threadIdx.x; e < BM * per_row; e += kThreads) {
            const int r = e / per_row, c = (e % per_row) * 8, pr = r0 + r;
            const bool in = pr < rows;
            const uint16_t* src =
                in ? qb + (pr / A.G) * A.q_ss + (kh * A.G + pr % A.G) * A.q_sh + c : A.q;
            cp_async16(Qs + r * DP + c, src, in);
        }
    } else {
        for (int e = threadIdx.x; e < BM * D; e += kThreads) {
            const int r = e / D, c = e % D, pr = r0 + r;
            Qs[r * DP + c] =
                pr < rows ? qb[(pr / A.G) * A.q_ss + (kh * A.G + pr % A.G) * A.q_sh + c]
                          : uint16_t(0);
        }
    }
}

// K and V rows [k0, k0 + BN) into a stage, zero past Sk.
template <int D>
__device__ __forceinline__ void load_kv(const Args& A, uint16_t* stage, const uint16_t* kb,
                                        const uint16_t* vb, int k0) {
    constexpr int DP = Tile<D>::DP;
    uint16_t* Ks = stage;
    uint16_t* Vs = stage + BN * DP;
    if (A.kv_vec) {
        constexpr int per_row = D / 8;
#pragma unroll
        for (int e = threadIdx.x; e < BN * per_row; e += kThreads) {
            const int r = e / per_row, c = (e % per_row) * 8, kj = k0 + r;
            const bool in = kj < A.Sk;
            cp_async16(Ks + r * DP + c, in ? kb + kj * A.k_ss + c : kb, in);
            cp_async16(Vs + r * DP + c, in ? vb + kj * A.v_ss + c : vb, in);
        }
    } else {
        for (int e = threadIdx.x; e < BN * D; e += kThreads) {
            const int r = e / D, c = e % D, kj = k0 + r;
            const bool in = kj < A.Sk;
            Ks[r * DP + c] = in ? kb[kj * A.k_ss + c] : uint16_t(0);
            Vs[r * DP + c] = in ? vb[kj * A.v_ss + c] : uint16_t(0);
        }
    }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) flash_bf16_kernel(const Args A) {
    constexpr int MT = Tile<D>::MT, BM = Tile<D>::BM, DP = Tile<D>::DP;
    constexpr int NS = BN / 8;        // score n-tiles (8 keys each)
    constexpr int NO = D / 8;         // output n-tiles (8 columns each)
    constexpr int KD = D / 16;        // k-steps of Q K^T
    extern __shared__ __align__(16) uint16_t smem[];
    uint16_t* Qs = smem;
    uint16_t* stages = smem + Tile<D>::q_elems;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    // ldmatrix addresses: Q's A fragment (rows l % 16, columns 8 (l / 16)),
    // K's B fragments of two n-tiles (keys l % 8 + 8 (l / 16), columns
    // 8 (l / 8 % 2)), V's through .trans (keys l % 8 + 8 (l / 8 % 2),
    // columns 8 (l / 16))
    const int q_row = lane & 15, q_col = 8 * (lane >> 4);
    const int k_row = (lane & 7) + 8 * (lane >> 4), k_col = 8 * ((lane >> 3) & 1);
    const int v_row = (lane & 7) + 8 * ((lane >> 3) & 1), v_col = 8 * (lane >> 4);

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
    // the warp's 16 MT rows and key tiles; this thread's rows g and g + 8 of
    // each m-tile
    const int wr0 = r0 + warp * 16 * MT;
    const long long wq_lo = (long long)(wr0 / A.G) + shift;
    const long long wq_hi = (long long)((min(wr0 + 16 * MT, rows) - 1) / A.G) + shift;
    int wkt_lo = 0, wkt_hi = -1;
    if (wr0 < rows) key_tiles<BN>(A, wq_lo, wq_hi, wkt_lo, wkt_hi);
    long long qpos[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half)
            qpos[mt][half] = (long long)((wr0 + 16 * mt + 8 * half + g) / A.G) + shift;

    const uint16_t* kb = A.k + b * A.k_sb + kh * A.k_sh;
    const uint16_t* vb = A.v + b * A.v_sb + kh * A.v_sh;
    const float sl2 = A.scale * kLog2e;               // exp(scale s) = exp2(sl2 s)

    float o[MT][NO][4];
    float m[MT][2], l[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int n = 0; n < NO; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[mt][n][e] = 0.f;
        m[mt][0] = m[mt][1] = kNegInf;
        l[mt][0] = l[mt][1] = 0.f;
    }
    uint32_t qf[MT][KD][4];

    const int n_tiles = kt_hi - kt_lo + 1;
    if (n_tiles > 0) {
        // q and the first kStages - 1 K/V tiles, one commit group a tile
        load_q<D>(A, Qs, b, kh, r0, rows);
#pragma unroll
        for (int st = 0; st < kStages - 1; ++st) {
            if (st < n_tiles)
                load_kv<D>(A, stages + st * Tile<D>::stage, kb, vb, (kt_lo + st) * BN);
            cp_async_commit();
        }
    }
    for (int i = 0; i < n_tiles; ++i) {
        const int kt = kt_lo + i;
        cp_async_wait<kStages - 2>();
        __syncthreads();              // tile i in place; every warp done with i - 1
        if (i + kStages - 1 < n_tiles)
            load_kv<D>(A, stages + ((i + kStages - 1) % kStages) * Tile<D>::stage, kb, vb,
                       (kt + kStages - 1) * BN);
        cp_async_commit();
        if (i == 0) {
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int kk = 0; kk < KD; ++kk)
                    ldmatrix_x4(qf[mt][kk], Qs + (warp * 16 * MT + mt * 16 + q_row) * DP +
                                                kk * 16 + q_col);
        }
        if (kt < wkt_lo || kt > wkt_hi) continue;

        const uint16_t* Ks = stages + (i % kStages) * Tile<D>::stage;
        const uint16_t* Vs = Ks + BN * DP;
        const int k0 = kt * BN;

        // S = Q K^T (unscaled): rows g, g + 8 of each m-tile; keys n * 8 + 2t
        // and n * 8 + 2t + 1; each K fragment feeds every m-tile
        float s[MT][NS][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int n = 0; n < NS; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
            for (int np = 0; np < NS / 2; ++np) {
                uint32_t bk4[4];
                ldmatrix_x4(bk4, Ks + (np * 16 + k_row) * DP + kk * 16 + k_col);
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    mma_bf16(s[mt][2 * np], qf[mt][kk], bk4[0], bk4[1]);
                    mma_bf16(s[mt][2 * np + 1], qf[mt][kk], bk4[2], bk4[3]);
                }
            }
        }

        // masks, only where the tile is not wholly inside every row's range
        const bool inside = k0 + BN <= A.Sk && (!A.causal || k0 + BN - 1 <= wq_lo) &&
                            (!A.has_window || wq_hi - k0 < A.window);
        if (!inside) {
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int n = 0; n < NS; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const long long kpos = k0 + n * 8 + 2 * t + (e & 1);
                        const long long qp = qpos[mt][e >> 1];
                        bool ok = kpos < A.Sk;
                        if (A.causal) ok = ok && kpos <= qp;
                        if (A.has_window) ok = ok && qp - kpos < A.window;
                        if (!ok) s[mt][n][e] = kNegInf;
                    }
        }

        // online softmax in fp32; a row's four threads form a quad
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
            float mx[2] = {kNegInf, kNegInf};
#pragma unroll
            for (int n = 0; n < NS; ++n) {
                mx[0] = fmaxf(mx[0], fmaxf(s[mt][n][0], s[mt][n][1]));
                mx[1] = fmaxf(mx[1], fmaxf(s[mt][n][2], s[mt][n][3]));
            }
            float c[2], bias[2];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
#pragma unroll
                for (int off = 1; off <= 2; off <<= 1)
                    mx[half] = fmaxf(mx[half], __shfl_xor_sync(kFull, mx[half], off));
                const float mn = fmaxf(m[mt][half], mx[half]);
                c[half] = ex2((m[mt][half] - mn) * sl2);
                bias[half] = -mn * sl2;
                m[mt][half] = mn;
            }
            float sum[2] = {0.f, 0.f};
#pragma unroll
            for (int n = 0; n < NS; ++n) {
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    s[mt][n][e] = s[mt][n][e] > 0.5f * kNegInf
                                      ? ex2(fmaf(s[mt][n][e], sl2, bias[e >> 1]))
                                      : 0.f;
                sum[0] += s[mt][n][0] + s[mt][n][1];
                sum[1] += s[mt][n][2] + s[mt][n][3];
            }
#pragma unroll
            for (int half = 0; half < 2; ++half)   // this thread's share; the quad
                l[mt][half] = l[mt][half] * c[half] + sum[half];   // adds up last
#pragma unroll
            for (int n = 0; n < NO; ++n) {
                o[mt][n][0] *= c[0];
                o[mt][n][1] *= c[0];
                o[mt][n][2] *= c[1];
                o[mt][n][3] *= c[1];
            }
        }

        // O += P V, 16 keys a step: n-tiles 2kk and 2kk + 1 of the scores are
        // the A fragment's columns 0-7 and 8-15, rounded to bf16; each V
        // fragment feeds every m-tile
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
            uint32_t a[MT][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                a[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
                a[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
                a[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
                a[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
            }
#pragma unroll
            for (int np = 0; np < D / 16; ++np) {
                uint32_t bv[4];
                ldmatrix_x4_trans(bv, Vs + (kk * 16 + v_row) * DP + np * 16 + v_col);
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    mma_bf16(o[mt][2 * np], a[mt], bv[0], bv[1]);
                    mma_bf16(o[mt][2 * np + 1], a[mt], bv[2], bv[3]);
                }
            }
        }
    }

#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            float lh = l[mt][half];
#pragma unroll
            for (int off = 1; off <= 2; off <<= 1) lh += __shfl_xor_sync(kFull, lh, off);
            const int pr = wr0 + 16 * mt + 8 * half + g;
            if (pr >= rows) continue;
            const int i = pr / A.G, h = kh * A.G + pr % A.G;
            const long long row = ((long long)b * A.Sq + i) * A.H + h;
            if (A.chunks == 1) {
                const float denom = fmaxf(lh, 1e-30f);
                uint16_t* dst = A.out + row * D + 2 * t;
#pragma unroll
                for (int n = 0; n < NO; ++n)
                    store2(dst + n * 8, o[mt][n][2 * half] / denom,
                           o[mt][n][2 * half + 1] / denom);
            } else {
                const long long prow = (long long)chunk * A.B * A.Sq * A.H + row;
                float* dst = A.part_acc + prow * D + 2 * t;
#pragma unroll
                for (int n = 0; n < NO; ++n)
                    *reinterpret_cast<float2*>(dst + n * 8) =
                        make_float2(o[mt][n][2 * half], o[mt][n][2 * half + 1]);
                if (t == 0)   // m in the scaled score's units, as the combine reads it
                    *reinterpret_cast<float2*>(A.part_ml + prow * 2) =
                        make_float2(m[mt][half] * A.scale, lh);
            }
        }
}

}  // namespace

// q: [B, Sq, H, D], k and v: [B, Sk, K, D] bf16 (their 16 bits) with unit
// stride over D and the given element strides over batch, sequence and
// head; out: [B, Sq, H, D] bf16 contiguous. D is 16, 32, 64, 96 or 128; H is
// a multiple of K. window <= 0 with has_window masks every key. The plan
// (row tiles of 128 packed rows at D <= 64, else 64; key tiles of 64 keys;
// chunks of tiles_per_chunk key tiles from first_tile) comes from the
// wrapper; with chunks > 1, part_acc and part_ml are fp32 scratch of chunks
// * B * Sq * H * D and chunks * B * Sq * H * 2 floats. Launches on `stream` and returns
// cudaGetLastError() (0 on success); 1 (cudaErrorInvalidValue) for a D it
// was not built for or a plan that does not fit the shape.
extern "C" int flash_attention_bf16(
        const uint16_t* q, const uint16_t* k, const uint16_t* v, uint16_t* out,
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
                          return flash::launch<D>(flash_bf16_kernel<D>, Tile<D>::BM,
                                                  kThreads, Tile<D>::smem_bytes, a, s);
                      });
}

extern "C" const char* flash_attention_bf16_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
