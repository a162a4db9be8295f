// Mamba-2 SSD scan, fp32 or bf16 x, b, c (fp32 inside): for each (b, h),
// with a the log-decay, the recurrence h_t = exp(a_t) h_{t-1} + x_t (outer)
// b_t, y_t = h_t c_t, computed in chunks of Q steps. Returns y and the
// final state.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py
// (ssd_scan / _ssd_kernel) and computes what it computes. Per chunk, with
// acum = the inclusive cumsum of a over the chunk and L[i, j] =
// exp(acum_i - acum_j) for j <= i (0 above the diagonal):
//   y     = (C B^T (.) L) X + diag(exp(acum)) C h_in^T           (output)
//   S_c   = (X (.) exp(acum_last - acum))^T B                     (chunk state)
//   h_out = exp(acum_last) h_in + S_c                             (passing)
// A ragged last chunk stops at S, which is what the TPU's padding with
// a = 0, x = 0 amounts to. Group g = h / (H / G) of b and c is read in
// place of a repeat, and x, a, b, c are read in their [B, S, heads, .]
// layout through the strides given.
//
// Bound on the card: operations, per (b h, chunk of Ql steps) Ql (Ql + 1)
// (N + P) flops for the two products over the j <= i triangle, 2 Ql P N
// for the chunk state and, in every chunk after the first, 2 Ql P N for
// the carried read-out and 2 P N for the passing; run on the tensor cores
// in 3xTF32 (495/3 TFLOP/s). Design: the
// TPU kernel walks the chunks in order inside one grid row; here the
// chunks run in parallel, in the decomposition of the reference's
// ssd_chunked:
// - One chunk (S <= Q): one launch. Its "y blocks" (b h, 64-row tile, 64
//   columns of P) build C B^T (.) L once for all their columns, one 32-key
//   tile at a time, and fold it into y at once; its "state blocks" (b h, 64
//   columns of P, 64 of N) write the final state. The state starts at
//   zero, so there is no carried-state term.
// - More chunks: three launches. (1) state blocks for every (b h, chunk)
//   write S_c and the chunk's acum_last to scratch; (2) pass_kernel walks
//   the chunks in order for a slice of the P N state entries, writing the
//   state entering each chunk over S_c and the final state; (3) y blocks
//   for every (b h, chunk, row tile) add exp(acum) C h_in^T.
// - All four products run through mma.sync m16n8k8 TF32 in 3xTF32
//   (tf32_mma.cuh). The masked, decayed C B^T tile stays in the
//   accumulators and feeds the product with X as its A fragment (keys in
//   the order 0, 2, 4, 6, 1, 3, 5, 7). The state product reads X
//   transposed from shared memory, rows padded to 72 floats so those reads
//   hit distinct banks; the y blocks pad rows to N + 4 and 64 + 4 for
//   theirs.
// - B and X tiles are double-buffered with cp.async (16-byte copies where
//   the pointers and strides allow; zeros past S, N and P).
// No atomics: the same bits on every run.
// - bf16 (ssd_scan_bf16): x, b and c are read as bf16 (4 a load, or 1) and
//   widened exactly into the same fp32 tiles, synchronously in place of
//   cp.async; a stays fp32 (the wrapper widens it: [B, S, H] is small).
//   Everything after the load is the fp32 instance's: y is its fp32 result
//   rounded once to bf16 (round to nearest even) and the state is fp32,
//   both equal to the fp32 instance's on the widened inputs, bit for bit.
// The grid is the wrapper's plan
// (kernels/ssd_scan.py: plan_ssd, smem_bytes): its block counts and shared
// memory sizes come in as arguments, and ssd_scan_f32 refuses a plan that
// does not match the decode and the layout below.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

using namespace tf32;

constexpr int kThreads = 128;         // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int BM = 64;                // y rows a block (16 a warp)
constexpr int BK = 32;                // keys (steps) a B / X tile
constexpr int BP = 64;                // columns of P a block
constexpr int BNS = 64;               // columns of N a state block
constexpr int PP = BP + 4;            // row stride of a y block's X tile
constexpr int SP = 72;                // row stride of a state block's tiles
constexpr int kPassThreads = 256;

template <typename In>
struct Args {
    const In* x;
    const float* a;
    const In* b;
    const In* c;
    In* y;
    float* st;                        // [B H, chunks, P, N]: S_c, then h_in
    float* dec;                       // [B H, chunks]: acum_last
    int S, H, G, P, N, Q;
    long long x_sb, x_ss, x_sh, a_sb, a_ss, a_sh;
    long long b_sb, b_ss, b_sg, c_sb, c_ss, c_sg;
    int chunks, row_tiles, last_row_tiles, p_tiles, n_tiles, BH;
    int y_blocks;                     // blocks below this index are y blocks
    int carry;                        // y blocks add C h_in^T (chunks > 1)
    int x_vec, bc_vec, st_vec;        // 4-element copies allowed
};

__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }

// Rows of a y block's C tile and (B, X) stages: a short chunk (every
// call of the FL path) needs fewer, and smaller blocks fit more an SM.
__host__ __device__ inline int c_rows(int Q) { return min(BM, round_up(Q, 16)); }
__host__ __device__ inline int n_stages(int Q) { return Q > BK ? 2 : 1; }

// Shared memory of each role, in floats (the plan's y_smem / state_smem):
// the chunk's cumsum, then for a y block the C tile and the stages, which
// also hold h_in [BP][NP] with more than one chunk; for a state block its
// stages.
inline int y_smem_floats(int Q, int N, int chunks) {
    const int NP = round_up(N, 8) + 4;
    const int stages = n_stages(Q) * (BK * NP + BK * PP);
    const int h_in = chunks > 1 ? BP * NP : 0;
    return round_up(Q, 64) + c_rows(Q) * NP + (stages > h_in ? stages : h_in);
}

inline int state_smem_floats(int Q) { return round_up(Q, 64) + n_stages(Q) * 2 * BK * SP; }

// Rows [row0, row0 + nrows) and columns [col0, col0 + width) of a matrix
// whose row r starts at base + r * rs, into dst (row stride dp), zero where
// row >= lim_rows or col >= lim_cols. With vec, width, col0 and lim_cols
// are multiples of 4 and the rows start on whole 4-element vectors.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int dp, const T* base,
                                          long long rs, int row0, int nrows,
                                          int lim_rows, int col0, int width,
                                          int lim_cols, bool vec) {
    const int step = vec ? 4 : 1, per = width / step;
    for (int e = threadIdx.x; e < nrows * per; e += kThreads) {
        const int r = e / per, cc = (e % per) * step;
        const int row = row0 + r, col = col0 + cc;
        const bool in = row < lim_rows && col < lim_cols;
        const T* src = in ? base + row * rs + col : base;
        if (vec)
            copy4(dst + r * dp + cc, src, in);
        else
            copy1(dst + r * dp + cc, src, in);
    }
}

// acum[0, Ql) = inclusive cumsum of a over the chunk (a block scan, the
// same arithmetic in every block); the caller syncs before reading it.
__device__ __forceinline__ void chunk_cumsum(const float* ab, long long a_ss, int Ql,
                                             float* acum, float* wsum) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    float carry = 0.f;
    for (int s0 = 0; s0 < Ql; s0 += kThreads) {
        const int i = s0 + tid;
        float v = i < Ql ? ab[i * a_ss] : 0.f;
        for (int off = 1; off < 32; off <<= 1) {
            const float up = __shfl_up_sync(0xffffffffu, v, off);
            if (lane >= off) v += up;
        }
        __syncthreads();              // wsum's last readers are done
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
}

// y rows [r0, r0 + 64) of chunk c, columns [p0, p0 + 64) of P.
template <typename In>
__device__ void y_block(const Args<In>& A, float* smem, int bh, int c, int rt, int pt) {
    __shared__ float wsum[kWarps];
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int NK = round_up(A.N, 8), NP = NK + 4;
    const int t0 = c * A.Q, Ql = min(A.Q, A.S - t0);
    const int r0 = rt * BM, p0 = pt * BP;
    const int h = bh % A.H, bb = bh / A.H, gi = h / (A.H / A.G);
    const In* xb = A.x + bb * A.x_sb + h * A.x_sh + t0 * A.x_ss;
    const float* ab = A.a + bb * A.a_sb + h * A.a_sh + t0 * A.a_ss;
    const In* bp = A.b + bb * A.b_sb + gi * A.b_sg + t0 * A.b_ss;
    const In* cp = A.c + bb * A.c_sb + gi * A.c_sg + t0 * A.c_ss;

    float* acum = smem;                          // [round_up(Q, 64)]
    float* Cs = acum + round_up(A.Q, 64);        // [c_rows][NP]
    float* stages = Cs + c_rows(A.Q) * NP;       // 1 or 2 x (B [BK][NP], X [BK][PP])
    const int stage = BK * NP + BK * PP;

    const int last_row = min(r0 + BM, Ql) - 1;   // the block's last row
    const int wr = warp * 16;                    // the warp's first row in the tile
    const bool active = r0 + wr < Ql;
    const int rowA = r0 + wr + g, rowB = rowA + 8;
    const bool carry = A.carry && c > 0;         // h_in of chunk 0 is zero

    auto load_keys = [&](int kt, float* dst) {
        load_tile(dst, NP, bp, A.b_ss, kt * BK, BK, Ql, 0, NK, A.N, A.bc_vec);
        load_tile(dst + BK * NP, PP, xb, A.x_ss, kt * BK, BK, Ql, p0, BP, A.P, A.x_vec);
    };
    load_tile(Cs, NP, cp, A.c_ss, r0, c_rows(A.Q), Ql, 0, NK, A.N, A.bc_vec);
    if (carry)                   // h_in [P, N] rows p0.. into the stages
        load_tile(stages, NP, A.st + ((long long)bh * A.chunks + c) * A.P * A.N, A.N,
                  p0, BP, A.P, 0, NK, A.N, A.st_vec);
    else                         // else the first key tile comes with C
        load_keys(0, stages);
    cp_async_commit();
    chunk_cumsum(ab, A.a_ss, Ql, acum, wsum);
    cp_async_wait<0>();
    __syncthreads();

    const int nt_live = min(BP, A.P - p0) / 8;         // live 8-column tiles of y
    float yacc[BP / 8][4];
#pragma unroll
    for (int n = 0; n < BP / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[n][e] = 0.f;

    if (carry) {
        // y = diag(exp(acum)) C h_in^T: A = C rows scaled, B[k = n][p] = h_in[p][n]
        if (active) {
            const float eA = rowA < Ql ? expf(acum[rowA]) : 0.f;
            const float eB = rowB < Ql ? expf(acum[rowB]) : 0.f;
            const float* hs = stages;
#pragma unroll 2
            for (int kk = 0; kk < NK / 8; ++kk) {
                uint32_t ahi[4], alo[4], bhi[BP / 8][2], blo[BP / 8][2];
                const float* c0 = Cs + (wr + g) * NP + kk * 8 + t;
                split(c0[0] * eA, ahi[0], alo[0]);
                split(c0[8 * NP] * eB, ahi[1], alo[1]);
                split(c0[4] * eA, ahi[2], alo[2]);
                split(c0[8 * NP + 4] * eB, ahi[3], alo[3]);
#pragma unroll
                for (int n = 0; n < BP / 8; ++n) {
                    if (n < nt_live) {
                        const float* h0 = hs + (n * 8 + g) * NP + kk * 8 + t;
                        split(h0[0], bhi[n][0], blo[n][0]);
                        split(h0[4], bhi[n][1], blo[n][1]);
                    }
                }
                mma_3xtf32_row(yacc, ahi, alo, bhi, blo, nt_live);
            }
        }
        __syncthreads();                         // the stages are free again
    }

    // intra-chunk: key tiles 0 .. kt_hi, double-buffered
    const int kt_hi = last_row / BK;
    if (carry) {
        load_keys(0, stages);
        cp_async_commit();
    }
    for (int kt = 0; kt <= kt_hi; ++kt) {
        const int buf = kt & 1;
        if (kt < kt_hi) {
            load_keys(kt + 1, stages + (buf ^ 1) * stage);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();                         // tile kt visible to all warps

        const int k0 = kt * BK;
        if (active && k0 <= r0 + wr + 15) {
            const float* Bs = stages + buf * stage;
            const float* Xs = Bs + BK * NP;
            // G = C B^T: rows g, g + 8; keys n * 8 + 2t, n * 8 + 2t + 1
            float s[BK / 8][4];
#pragma unroll
            for (int n = 0; n < BK / 8; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll 2
            for (int kk = 0; kk < NK / 8; ++kk) {
                uint32_t ahi[4], alo[4], bhi[BK / 8][2], blo[BK / 8][2];
                const float* c0 = Cs + (wr + g) * NP + kk * 8 + t;
                split(c0[0], ahi[0], alo[0]);
                split(c0[8 * NP], ahi[1], alo[1]);
                split(c0[4], ahi[2], alo[2]);
                split(c0[8 * NP + 4], ahi[3], alo[3]);
#pragma unroll
                for (int n = 0; n < BK / 8; ++n) {
                    const float* b0 = Bs + (n * 8 + g) * NP + kk * 8 + t;
                    split(b0[0], bhi[n][0], blo[n][0]);
                    split(b0[4], bhi[n][1], blo[n][1]);
                }
                mma_3xtf32_row(s, ahi, alo, bhi, blo);
            }
            // G (.) L: keys j <= row i < Ql keep exp(acum_i - acum_j), others 0
#pragma unroll
            for (int n = 0; n < BK / 8; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int i = e < 2 ? rowA : rowB;
                    const int j = k0 + n * 8 + 2 * t + (e & 1);
                    s[n][e] = (j <= i && i < Ql) ? s[n][e] * expf(acum[i] - acum[j]) : 0.f;
                }
            // y += (G (.) L) X, 8 keys a step in the order (2t | 2t + 1)
#pragma unroll
            for (int kk = 0; kk < BK / 8; ++kk) {
                uint32_t ahi[4], alo[4], bhi[BP / 8][2], blo[BP / 8][2];
                split(s[kk][0], ahi[0], alo[0]);
                split(s[kk][2], ahi[1], alo[1]);
                split(s[kk][1], ahi[2], alo[2]);
                split(s[kk][3], ahi[3], alo[3]);
                const float* x0 = Xs + (kk * 8 + 2 * t) * PP + g;
#pragma unroll
                for (int n = 0; n < BP / 8; ++n) {
                    if (n < nt_live) {
                        split(x0[n * 8], bhi[n][0], blo[n][0]);
                        split(x0[PP + n * 8], bhi[n][1], blo[n][1]);
                    }
                }
                mma_3xtf32_row(yacc, ahi, alo, bhi, blo, nt_live);
            }
        }
        __syncthreads();                         // every warp is done with stage buf
    }

    if (!active) return;
    const long long y_ss = (long long)A.H * A.P;
    In* yb = A.y + ((long long)bb * A.S + t0) * y_ss + (long long)h * A.P + p0 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int i = half ? rowB : rowA;
        if (i >= Ql) continue;
#pragma unroll
        for (int n = 0; n < BP / 8; ++n)
            if (n < nt_live)
                store2(yb + i * y_ss + n * 8, yacc[n][2 * half], yacc[n][2 * half + 1]);
    }
}

// S_c[p, n] for p in [p0, p0 + 64), n in [n0, n0 + 64) of chunk c: warp w
// owns the 16 rows p0 + 16 w .. and all 64 columns.
template <typename In>
__device__ void state_block(const Args<In>& A, float* smem, int bh, int c, int pt,
                            int ntile) {
    __shared__ float wsum[kWarps];
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int t0 = c * A.Q, Ql = min(A.Q, A.S - t0);
    const int p0 = pt * BP, n0 = ntile * BNS;
    const int h = bh % A.H, bb = bh / A.H, gi = h / (A.H / A.G);
    const In* xb = A.x + bb * A.x_sb + h * A.x_sh + t0 * A.x_ss;
    const float* ab = A.a + bb * A.a_sb + h * A.a_sh + t0 * A.a_ss;
    const In* bp = A.b + bb * A.b_sb + gi * A.b_sg + t0 * A.b_ss;

    float* w = smem;                             // [round_up(Q, 64)]: acum, then weights
    float* stages = w + round_up(A.Q, 64);       // 1 or 2 x (X [BK][SP], B [BK][SP])
    const int stage = 2 * BK * SP;
    const int q_tiles = (Ql + BK - 1) / BK;

    auto load_steps = [&](int qt, float* dst) {
        load_tile(dst, SP, xb, A.x_ss, qt * BK, BK, Ql, p0, BP, A.P, A.x_vec);
        load_tile(dst + BK * SP, SP, bp, A.b_ss, qt * BK, BK, Ql, n0, BNS, A.N, A.bc_vec);
    };
    load_steps(0, stages);
    cp_async_commit();

    // weights exp(acum_last - acum_q), 0 past Ql
    chunk_cumsum(ab, A.a_ss, Ql, w, wsum);
    __syncthreads();
    const float a_last = w[Ql - 1];
    __syncthreads();                             // every thread has read a_last
    for (int q = tid; q < round_up(A.Q, 64); q += kThreads)
        w[q] = q < Ql ? expf(a_last - w[q]) : 0.f;
    if (A.dec != nullptr && pt == 0 && ntile == 0 && tid == 0)
        A.dec[(long long)bh * A.chunks + c] = a_last;

    const int pr = warp * 16;                    // the warp's first row in the tile
    const bool active = p0 + pr < A.P;           // (the tile is 0 past P)
    const int nt_live = (min(BNS, A.N - n0) + 7) / 8;   // live 8-column tiles of N
    float acc[BNS / 8][4];
#pragma unroll
    for (int n = 0; n < BNS / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

    for (int qt = 0; qt < q_tiles; ++qt) {
        const int buf = qt & 1;
        if (qt + 1 < q_tiles) {
            load_steps(qt + 1, stages + (buf ^ 1) * stage);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();                         // tile qt (and w) visible to all warps

        if (active) {
            const float* Xs = stages + buf * stage;
            const float* Bs = Xs + BK * SP;
            const float* wq = w + qt * BK;
#pragma unroll
            for (int kk = 0; kk < BK / 8; ++kk) {
                // A[p][q] = X[q][p] w_q, read transposed: banks 8 t + g
                const float w0 = wq[kk * 8 + t], w1 = wq[kk * 8 + t + 4];
                const float* x0 = Xs + (kk * 8 + t) * SP + pr + g;
                uint32_t ahi[4], alo[4], bhi[BNS / 8][2], blo[BNS / 8][2];
                split(x0[0] * w0, ahi[0], alo[0]);
                split(x0[8] * w0, ahi[1], alo[1]);
                split(x0[4 * SP] * w1, ahi[2], alo[2]);
                split(x0[4 * SP + 8] * w1, ahi[3], alo[3]);
#pragma unroll
                for (int n = 0; n < BNS / 8; ++n) {
                    if (n < nt_live) {
                        const float* b0 = Bs + (kk * 8 + t) * SP + n * 8 + g;
                        split(b0[0], bhi[n][0], blo[n][0]);
                        split(b0[4 * SP], bhi[n][1], blo[n][1]);
                    }
                }
                mma_3xtf32_row(acc, ahi, alo, bhi, blo, nt_live);
            }
        }
        __syncthreads();                         // every warp is done with stage buf
    }

    if (!active) return;
    float* out = A.st + ((long long)bh * A.chunks + c) * A.P * A.N;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int p = p0 + pr + g + 8 * half;
        if (p >= A.P) continue;
#pragma unroll
        for (int n = 0; n < BNS / 8; ++n) {
            const int col = n0 + n * 8 + 2 * t;
            float* dst = out + (long long)p * A.N + col;
            if (A.N % 2 == 0) {          // col even: both or neither below N
                if (col < A.N)
                    *reinterpret_cast<float2*>(dst) =
                        make_float2(acc[n][2 * half], acc[n][2 * half + 1]);
            } else {
                if (col < A.N) dst[0] = acc[n][2 * half];
                if (col + 1 < A.N) dst[1] = acc[n][2 * half + 1];
            }
        }
    }
}

// Blocks [0, y_blocks) are y blocks, the rest state blocks. y blocks go
// row tile by row tile from the last (the most key tiles) to the first;
// within one, chunk-major, then b h, then the P tile.
template <typename In>
__global__ void __launch_bounds__(kThreads) ssd_chunk_kernel(const Args<In> A) {
    extern __shared__ __align__(16) float smem[];
    int x = blockIdx.x;
    if (x < A.y_blocks) {
        int rt = A.row_tiles - 1;
        for (;; --rt) {
            const int nch = A.chunks - 1 + (rt < A.last_row_tiles ? 1 : 0);
            const int cnt = nch * A.BH * A.p_tiles;
            if (x < cnt) break;
            x -= cnt;
        }
        const int pt = x % A.p_tiles;
        x /= A.p_tiles;
        y_block(A, smem, x % A.BH, x / A.BH, rt, pt);
    } else {
        x -= A.y_blocks;
        const int nt = x % A.n_tiles;
        x /= A.n_tiles;
        const int pt = x % A.p_tiles;
        x /= A.p_tiles;
        state_block(A, smem, x % A.BH, x / A.BH, pt, nt);
    }
}

// The state entering each chunk, in chunk order, for one (b h, entry):
// st[c] holds S_c on entry and h_in(c) on exit; h_out the final state.
__global__ void __launch_bounds__(kPassThreads) pass_kernel(
        float* __restrict__ st, const float* __restrict__ dec,
        float* __restrict__ h_out, int chunks, int PN, int blocks_per_bh) {
    const int bh = blockIdx.x / blocks_per_bh;
    const int e = (blockIdx.x % blocks_per_bh) * kPassThreads + threadIdx.x;
    if (e >= PN) return;
    float* s = st + (long long)bh * chunks * PN + e;
    const float* d = dec + (long long)bh * chunks;
    constexpr int kAhead = 8;         // chunks loaded before the first store
    float hv = 0.f;
    for (int c0 = 0; c0 < chunks; c0 += kAhead) {
        float v[kAhead];
#pragma unroll
        for (int k = 0; k < kAhead; ++k)
            v[k] = c0 + k < chunks ? s[(long long)(c0 + k) * PN] : 0.f;
#pragma unroll
        for (int k = 0; k < kAhead; ++k) {
            if (c0 + k < chunks) {
                s[(long long)(c0 + k) * PN] = hv;
                hv = fmaf(expf(d[c0 + k]), hv, v[k]);
            }
        }
    }
    h_out[(long long)bh * PN + e] = hv;
}

template <typename In>
int launch_chunks(const Args<In>& a, int blocks, int bytes, cudaStream_t s) {
    static int allowed = 0;           // the largest size allowed so far
    if (bytes > allowed) {
        const cudaError_t attr = cudaFuncSetAttribute(
            ssd_chunk_kernel<In>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (attr != cudaSuccess) return static_cast<int>(attr);
        allowed = bytes;
    }
    ssd_chunk_kernel<In><<<blocks, kThreads, bytes, s>>>(a);
    return static_cast<int>(cudaGetLastError());
}

// rows of 4 elements start on whole 4-element vectors
template <typename T>
bool aligned4(const T* p, long long s0, long long s1, long long s2) {
    return reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0 && s0 % 4 == 0 &&
           s1 % 4 == 0 && s2 % 4 == 0;
}

template <typename In>
int run(const In* x, const float* a, const In* b, const In* c, In* y, float* h_out,
        float* st, float* dec, int B, int S, int H, int G, int P, int N, int Q,
        int chunks, int row_tiles, int last_row_tiles, int p_tiles, int n_tiles,
        int y_blocks, int state_blocks, int y_smem, int state_smem, long long x_sb,
        long long x_ss, long long x_sh, long long a_sb, long long a_ss, long long a_sh,
        long long b_sb, long long b_ss, long long b_sg, long long c_sb, long long c_ss,
        long long c_sg, void* stream) {
    if (B <= 0 || H <= 0 || S <= 0) return 0;
    const int invalid = static_cast<int>(cudaErrorInvalidValue);
    if (G <= 0 || H % G || P <= 0 || P % 8 || N <= 0 || Q <= 0 || Q > S) return invalid;
    // the plan must be the grid that the block decode and the layout need
    const int last = S - (chunks - 1) * Q, BH = B * H;
    if (chunks < 1 || last < 1 || last > Q || row_tiles != (Q + BM - 1) / BM ||
        last_row_tiles != (last + BM - 1) / BM || p_tiles != (P + BP - 1) / BP ||
        n_tiles != (round_up(N, 8) + BNS - 1) / BNS ||
        y_blocks != BH * p_tiles * ((chunks - 1) * row_tiles + last_row_tiles) ||
        state_blocks != BH * chunks * p_tiles * n_tiles ||
        y_smem != 4 * y_smem_floats(Q, N, chunks) || state_smem != 4 * state_smem_floats(Q))
        return invalid;
    if (chunks > 1 && (st == nullptr || dec == nullptr)) return invalid;
    Args<In> A{x, a, b, c, y, chunks > 1 ? st : h_out, chunks > 1 ? dec : nullptr,
               S, H, G, P, N, Q, x_sb, x_ss, x_sh, a_sb, a_ss, a_sh,
               b_sb, b_ss, b_sg, c_sb, c_ss, c_sg,
               chunks, row_tiles, last_row_tiles, p_tiles, n_tiles, BH, 0, 0,
               aligned4(x, x_sb, x_ss, x_sh),
               N % 4 == 0 && aligned4(b, b_sb, b_ss, b_sg) && aligned4(c, c_sb, c_ss, c_sg),
               N % 4 == 0};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (chunks == 1) {
        A.y_blocks = y_blocks;
        return launch_chunks(A, y_blocks + state_blocks,
                             y_smem > state_smem ? y_smem : state_smem, s);
    }
    A.y_blocks = 0;                               // (1) the chunk states
    int err = launch_chunks(A, state_blocks, state_smem, s);
    if (err) return err;
    const int PN = P * N, per = (PN + kPassThreads - 1) / kPassThreads;
    pass_kernel<<<A.BH * per, kPassThreads, 0, s>>>(A.st, A.dec, h_out, chunks, PN, per);
    err = static_cast<int>(cudaGetLastError());   // (2) state passing
    if (err) return err;
    A.y_blocks = y_blocks;                        // (3) y with the carried state
    A.carry = 1;
    return launch_chunks(A, y_blocks, y_smem, s);
}

}  // namespace

// x: [B, S, H, P], b and c: [B, S, G, N] fp32 (ssd_scan_f32) or bf16
// (ssd_scan_bf16), a: [B, S, H] fp32, with unit stride over the last axis
// (a: over none) and the given element strides; y: [B, S, H, P] of x's type
// and h_out: [B, H, P, N] fp32, contiguous. Q is the chunk (min(chunk,
// S)), P a multiple of 8, H a multiple of G. With more than one chunk, st
// and dec are fp32 scratch of B H chunks P N and B H chunks floats. chunks
// .. state_smem are the wrapper's plan (plan_ssd): the chunks, the row tiles
// of a full and of the last chunk, the P and N tiles, the y and state
// blocks and their shared memory in bytes. Launches on `stream`: one kernel
// for one chunk, three otherwise. Returns cudaGetLastError() (0 on
// success); cudaErrorInvalidValue for a shape it does not take or a plan
// that does not match it.
extern "C" int ssd_scan_f32(const float* x, const float* a, const float* b,
                            const float* c, float* y, float* h_out, float* st,
                            float* dec, int B, int S, int H, int G, int P, int N,
                            int Q, int chunks, int row_tiles, int last_row_tiles,
                            int p_tiles, int n_tiles, int y_blocks, int state_blocks,
                            int y_smem, int state_smem,
                            long long x_sb, long long x_ss, long long x_sh,
                            long long a_sb, long long a_ss, long long a_sh,
                            long long b_sb, long long b_ss, long long b_sg,
                            long long c_sb, long long c_ss, long long c_sg,
                            void* stream) {
    return run(x, a, b, c, y, h_out, st, dec, B, S, H, G, P, N, Q, chunks, row_tiles,
               last_row_tiles, p_tiles, n_tiles, y_blocks, state_blocks, y_smem,
               state_smem, x_sb, x_ss, x_sh, a_sb, a_ss, a_sh, b_sb, b_ss, b_sg, c_sb,
               c_ss, c_sg, stream);
}

extern "C" int ssd_scan_bf16(const uint16_t* x, const float* a, const uint16_t* b,
                             const uint16_t* c, uint16_t* y, float* h_out, float* st,
                             float* dec, int B, int S, int H, int G, int P, int N,
                             int Q, int chunks, int row_tiles, int last_row_tiles,
                             int p_tiles, int n_tiles, int y_blocks, int state_blocks,
                             int y_smem, int state_smem,
                             long long x_sb, long long x_ss, long long x_sh,
                             long long a_sb, long long a_ss, long long a_sh,
                             long long b_sb, long long b_ss, long long b_sg,
                             long long c_sb, long long c_ss, long long c_sg,
                             void* stream) {
    return run(x, a, b, c, y, h_out, st, dec, B, S, H, G, P, N, Q, chunks, row_tiles,
               last_row_tiles, p_tiles, n_tiles, y_blocks, state_blocks, y_smem,
               state_smem, x_sb, x_ss, x_sh, a_sb, a_ss, a_sh, b_sb, b_ss, b_sg, c_sb,
               c_ss, c_sg, stream);
}

extern "C" const char* ssd_scan_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
