// RWKV-6 chunked linear-attention scan — CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel `_rwkv_kernel` / `rwkv6_scan` of
// src/repro/kernels/rwkv6_scan.py.  It computes the same function, chunk by
// chunk of Q rows, in fp32 inside, with per-channel log decays
// l = log2(clip(w, 1e-6, 1)) (base 2 here, so every exponential is one ex2)
// and cum_i = sum_{t <= i} l_t within the chunk:
//     y[i,m] = sum_n r[i,n] 2^(cum_{i-1,n}) S[n,m]                    inter-chunk
//            + sum_{j < i} (sum_n r[i,n] k[j,n] 2^(cum_{i-1,n} - cum_{j,n})) v[j,m]
//            + (sum_n r[i,n] u[n] k[i,n]) v[i,m]                       the bonus
//     S[n,m] <- S[n,m] 2^(cum_last,n) + sum_j k[j,n] 2^(cum_last,n - cum_j,n) v[j,m]
// with y rounded once to r's type and the final S written in fp32.  Any S
// (a partial last chunk is staged with zero rows: r = k = v = 0, l = 0,
// which add nothing to the state and do not decay it), an initial state s0,
// Q <= 128, N a multiple of 4 up to 64; r, k, v and w read through element
// strides (innermost 1), so the model's (B, S, D) -> (B, S, H, N) views are
// read in place.  One thread block owns one (batch row, head) and loops over
// its chunks in order (the TPU's sequential chunk axis), its state in shared
// memory: 128 blocks at the rwkv6-1.6b prefill shape, on 132 SMs.
//
// Bound on this card.  Bytes: r, k, v (bf16) and w (fp32) read once, y and
// the state written once: 52.4 MB at the rwkv6-1.6b prefill shape (r, k, v
// (4, 512, 32, 64), chunk 128), 0.0157 ms at 3.35 TB/s.
//
// Two designs, chosen by the inputs' type:
//
// `fma::` (fp32 inputs; no served path runs them) is the first design: the
// scores in the direct pairwise form 2^(cum_{i-1} - cum_j), one exponential
// for every (i, j < i) pair and channel (Q (Q - 1) / 2 N a chunk and head,
// 274.8 M at the main shape, >= 0.0657 ms at the ex2 rate of 16 an SM a
// clock), and every product as fp32 FMA on the CUDA cores.
//
// `tc::` (bf16, every served path) factors the decays at 16-row tile
// edges.  With l <= 0 the cumulative sum is non-increasing; R_t is the sum
// before tile t, c_j = cum_j - R_t(j) the running sum within j's tile.  For
// i in tile ti and j in tile tj < ti
//     cum_{i-1} - cum_j = c_{i-1} + (R_ti - R_tj+1) + (c_last(tj) - c_j)
// and each of the three parts is <= 0, so an off-diagonal tile pair's scores
// are a plain product (r 2^(c_{i-1})) diag(2^(R_ti - R_tj+1)) (k 2^(c_last -
// c_j))^T with every factor <= 1: nothing overflows, even at w = 1e-6, where
// 16 rows reach -319 in base 2; a factor flushes to 0 only where the true
// weight is below 2^-126.  Only the 8 diagonal tiles keep the direct form
// (the secondary chunking of the public `fla` library's chunk_rwkv6).
// Exponentials a chunk and head: 61,440 on the diagonal tiles, 2 x 8,192 row
// scales, 45 x 64 decays between tile edges (the edge decays of the inter
// term and the state update are the row scales times 2^(R_t) and
// 2^(R_last - R_t+1)): 80,704, against the first design's 536,640; 41.3 M
// at the main shape, >= 0.0099 ms at the ex2 rate.
//  * Tensor cores.  The scores, r 2^(cum_{i-1}) S, att v and the state
//    products k 2^(cum_last - cum_j) v^T run as mma.sync m16n8k8 TF32.  Every
//    fp32 operand is cut into two TF32 parts by masks, big = v with its low
//    13 bits cleared and small = (v - big) likewise (|v - big - small| <
//    2^-20 |v|); v, bf16, is exact in TF32.  Where both operands are fp32
//    (the scores and r S) three products are kept (big big, big small, small
//    big), elsewhere two.  Chosen from the CPU emulation of this arithmetic
//    (tests/_torch_parity.py `rwkv_emulated`, held by
//    tests/test_torch_kernels.py): dropping small x big puts y 10-13 one-ulp
//    limits from the plain version at the main path's widths; two bf16 parts
//    pass the one-ulp check but carry ~9x the fp32-level error (about 5e-5
//    before rounding, the whole 5e-5 budget of the check).
//  * Numerics that stay: the log2-decays summed in fp64, each tile's running
//    sum from its first row (so c is never a difference of large sums), and
//    every decay between tile edges summed from the tiles' fp64 totals
//    before it is narrowed; on the diagonal tiles the exponent c_{i-1} - c_j
//    is taken for j < i only, so every ex2 is of a number <= 0.
//  * Work.  Warp w owns row tile rt (warps w and w + 4 share a scheduler
//    and take tiles k and 7 - k).  It computes its diagonal tile on the CUDA
//    cores with a fixed schedule (lane (a, cq): the row pairs (a, 15 - a) and
//    (a + 4, 11 - a), the 15 pairs j < i of each, channels 4 cq .. and 32 +
//    4 cq ..: no lane idles, no branch, eight lanes of a row on 32 banks),
//    then one pass over the channels, 8 a step, for r S and the off-diagonal
//    scores (kept in registers: an accumulator of the m16n8k8 product is an A
//    fragment of the next one), then att v, and stores its 16 rows of y.
//    The state products are spread over all 8 warps (16 rows n by 32
//    columns m each) and added after a barrier.
//  * Loads.  r, k and v are staged by cp.async into two buffers each, the
//    next chunk's issued a quarter at a time through this one (a burst of
//    them stalls the issuing warps on a full queue); w is read into
//    registers a chunk ahead, also in quarters; l = log2 w from the MUFU
//    (__log2f, about 2^-22 of error).  226,816 bytes of shared memory, one
//    block of 256 threads an SM, 248 registers a thread.
//  * What bounds it (clock stamps at the phase edges on the card, PERF.md
//    section 6, PR 18): about 35 K clocks a chunk, of which the decays take
//    7 K (their barriers 2 K), the diagonal tiles 6 K on every warp (the
//    MUFU), and the products 9.5 K on average, up to 14 K on the warp of row
//    tile 7, whose 7 off-diagonal tile pairs the others wait for at the
//    state's barrier.  Not bytes (5.4x the byte bound).  Tried and slower:
//    the pairs split across two warps each, the diagonal staggered against
//    the products or spread over the light warps, att v and the state
//    products on wgmma (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Params {
  const void* r;        // (B, S, H, N), element strides r_sb, r_ss, r_sh, innermost 1
  const void* k;        // the same, k_*
  const void* v;        // the same, v_*
  const float* w;       // (B, S, H, N) decay in (0, 1), fp32, strides w_*
  const float* u;       // (H, N) bonus, contiguous fp32
  const float* s0;      // (B, H, N, N) contiguous fp32, or null for zeros
  void* y;              // (B, S, H, N) contiguous, r's type
  float* s_out;         // (B, H, N, N) contiguous fp32
  int B, S, H, N, Q;
  long long r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, w_sb, w_ss, w_sh;
  int rkv_vec;          // rows of r, k and v are 16-byte aligned runs
};

// 2^x, one MUFU instruction; 2^(-inf) = 0 and results below 2^-126 flush to 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// fma: the first design, fp32 FMA on the CUDA cores; fp32 inputs only
// ---------------------------------------------------------------------------

namespace fma {

constexpr int THREADS = 1024;
constexpr int NSEG = THREADS / 64;   // row segments of the cumulative sums, one thread a channel each
constexpr int TILE = 16;

__device__ inline float to_float(float v) { return v; }
__device__ inline void from_float(float* p, float v) { *p = v; }

__device__ inline void load4(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ inline void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Shared memory, in floats.  QP = Q rounded up to 16, LD = QP + 4 (rows of
// 16-byte multiples that fall on other banks), NT = QP / 16 tiles:
//   big          cum[QP][N] in fp64 while the chunk's sums are made, then
//                att[QP][QP] transposed: att[j][i] = score of (i, j), j <= i
//   R[NT+1][N]   fp64: the cumulative sum before tile t; R[NT] = the chunk's
//   rt[N][LD]    r transposed, then r_i 2^(cum_{i-1})
//   kt[N][LD]    k transposed, then k_j 2^(cum_last - cum_j)
//   ct[N][LD]    c_j = cum_j - R_t(j), transposed
//   vs[QP][N]    v
//   st[N][N]     the state S[n][m]
//   us[N]        the bonus u
//   dt[NT (NT + 1) / 2][N]   D = R_ti - R_tj for tj <= ti
struct Layout {
  int QP, LD, NT, pairs;
  int big, R, rt, kt, ct, vs, st, us, dt, total;
};

__host__ __device__ inline Layout layout(int Q, int N) {
  Layout L;
  L.QP = (Q + TILE - 1) / TILE * TILE;
  L.LD = L.QP + 4;
  L.NT = L.QP / TILE;
  L.pairs = L.NT * (L.NT + 1) / 2;
  int o = 0;
  L.big = o; o += L.QP * L.QP > 2 * L.QP * N ? L.QP * L.QP : 2 * L.QP * N;
  L.R = o; o += 2 * (L.NT + 1) * N;
  L.rt = o; o += N * L.LD;
  L.kt = o; o += N * L.LD;
  L.ct = o; o += N * L.LD;
  L.vs = o; o += L.QP * N;
  L.st = o; o += N * N;
  L.us = o; o += N;
  L.dt = o; o += L.pairs * N;
  L.total = o;
  return L;
}

// grid: (H, B), THREADS threads.
template <typename T>
__global__ void __launch_bounds__(THREADS) rwkv6_scan_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int N = p.N;
  const Layout L = layout(p.Q, N);
  const int QP = L.QP, LD = L.LD, NT = L.NT;
  double* cum = reinterpret_cast<double*>(smem + L.big);
  float* att = smem + L.big;
  double* R = reinterpret_cast<double*>(smem + L.R);
  float* rt = smem + L.rt;
  float* kt = smem + L.kt;
  float* ct = smem + L.ct;
  float* vs = smem + L.vs;
  float* st = smem + L.st;
  float* us = smem + L.us;
  float* dt = smem + L.dt;

  const int tid = threadIdx.x;
  const int hd = blockIdx.x, b = blockIdx.y;
  const T* r = static_cast<const T*>(p.r) + b * p.r_sb + hd * p.r_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hd * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hd * p.v_sh;
  const float* w = p.w + b * p.w_sb + hd * p.w_sh;
  T* y = static_cast<T*>(p.y) + ((long long)b * p.S * p.H + hd) * N;   // + s * H * N
  const long long y_ss = (long long)p.H * N;
  const long long s_off = ((long long)b * p.H + hd) * N * N;

  for (int e = tid; e < N * N; e += THREADS) st[e] = p.s0 ? p.s0[s_off + e] : 0.f;
  for (int n = tid; n < N; n += THREADS) us[n] = p.u[hd * N + n];

  for (int s0 = 0; s0 < p.S; s0 += p.Q) {
    const int q = min(p.Q, p.S - s0);
    __syncthreads();                      // the previous chunk is read
    // ---- stage the chunk; rows q .. QP-1 are zero (r = k = v = 0, l = 0)
#pragma unroll 4
    for (int e = tid; e < QP * N; e += THREADS) {
      const int j = e / N, n = e - j * N;
      const bool in = j < q;
      const long long s = s0 + j;
      rt[n * LD + j] = in ? to_float(r[s * p.r_ss + n]) : 0.f;
      kt[n * LD + j] = in ? to_float(k[s * p.k_ss + n]) : 0.f;
      vs[e] = in ? to_float(v[s * p.v_ss + n]) : 0.f;
      cum[e] = in ? (double)log2f(fminf(fmaxf(w[s * p.w_ss + n], 1e-6f), 1.f)) : 0.0;
    }
    __syncthreads();

    // ---- cumulative sums per channel in fp64: NSEG segments of QP/NSEG rows
    {
      const int seg = QP / NSEG, n = tid % N, g = tid / N;
      const bool mine = tid < NSEG * N;
      if (mine) {
        double run = 0.0;
        for (int j = g * seg; j < (g + 1) * seg; ++j) cum[j * N + n] = run += cum[j * N + n];
      }
      __syncthreads();
      double off = 0.0;
      if (mine)
        for (int h = 0; h < g; ++h) off += cum[((h + 1) * seg - 1) * N + n];
      __syncthreads();
      if (mine && g > 0)
        for (int j = g * seg; j < (g + 1) * seg; ++j) cum[j * N + n] += off;
    }
    __syncthreads();

    // ---- R (fp64), c (fp32, within the tile)
    for (int e = tid; e < (NT + 1) * N; e += THREADS) {
      const int t = e / N, n = e - t * N;
      R[e] = t == 0 ? 0.0 : cum[(TILE * t - 1) * N + n];
    }
    for (int e = tid; e < QP * N; e += THREADS) {
      const int j = e / N, n = e - j * N, t = j / TILE;
      ct[n * LD + j] = static_cast<float>(cum[e] - (t == 0 ? 0.0 : cum[(TILE * t - 1) * N + n]));
    }
    __syncthreads();
    for (int e = tid; e < L.pairs * N; e += THREADS) {
      const int pr = e / N, n = e - pr * N;
      int ti = 0;
      while ((ti + 1) * (ti + 2) / 2 <= pr) ++ti;
      const int tj = pr - ti * (ti + 1) / 2;
      dt[e] = static_cast<float>(R[ti * N + n] - R[tj * N + n]);
    }
    __syncthreads();                      // cum is read: its space holds att from here

    // ---- scores: one 4 x 4 micro-tile on or below the diagonal at a time
    {
      const int na = QP / 4;
      const int micro = na * (na + 1) / 2;
      for (int m = tid; m < micro; m += THREADS) {
        int A = static_cast<int>((sqrtf(8.f * m + 1.f) - 1.f) * 0.5f);
        while (A * (A + 1) / 2 > m) --A;
        while ((A + 1) * (A + 2) / 2 <= m) ++A;
        const int B = m - A * (A + 1) / 2;
        const int i0 = 4 * A, j0 = 4 * B;
        if (i0 >= q) continue;            // rows past the chunk: y is not written
        const int ti = i0 / TILE, tj = j0 / TILE;
        const float* D = dt + (ti * (ti + 1) / 2 + tj) * N;
        const bool first = i0 % TILE == 0;   // c_{i0-1} lies in the tile before: e = 0
        const bool diag = A == B;         // i0 == j0, D = 0: j < i exponentials, j = i the bonus
        float acc[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
        // one instruction stream for every micro-tile (no divergence within a
        // warp): on the diagonal the exponents of j >= i are -inf before ex2
        for (int n = 0; n < N; ++n) {
          float ri[4], kj[4], cj[4], ci[4];
          load4(rt + n * LD + i0, ri);
          load4(kt + n * LD + j0, kj);
          load4(ct + n * LD + j0, cj);
          load4(ct + n * LD + i0, ci);
          const float dn = D[n];
          const float ud = diag ? us[n] : 0.f;
          // cum_{i-1} - R_ti + D for the four rows
          const float e[4] = {dn + (first ? 0.f : ct[n * LD + i0 - 1]), dn + ci[0], dn + ci[1], dn + ci[2]};
#pragma unroll
          for (int a = 0; a < 4; ++a) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float d = (c >= a && diag) ? -INFINITY : e[a] - cj[c];
              acc[a][c] = fmaf(ri[a] * kj[c], exp2_approx(d), acc[a][c]);
            }
            acc[a][a] = fmaf(ri[a] * kj[a], ud, acc[a][a]);
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float col[4] = {acc[0][c], acc[1][c], acc[2][c], acc[3][c]};
          store4(att + (j0 + c) * QP + i0, col);
        }
      }
    }
    __syncthreads();

    // ---- r_i <- r_i 2^(cum_{i-1}), k_j <- k_j 2^(cum_last - cum_j); both exponents <= 0
    for (int e = tid; e < N * QP; e += THREADS) {
      const int n = e / QP, i = e - n * QP, t = i / TILE;
      const float ei = i % TILE == 0 ? 0.f : ct[n * LD + i - 1];
      rt[n * LD + i] *= exp2_approx(static_cast<float>(R[t * N + n]) + ei);
      kt[n * LD + i] *= exp2_approx(static_cast<float>(R[NT * N + n] - R[t * N + n]) - ct[n * LD + i]);
    }
    __syncthreads();

    // ---- y = att v + r' S: one row group of 4 and 4 columns m0..m0+3 a thread
    {
      const int m0 = 4 * (tid % 16), i0 = 4 * (tid / 16);
      if (i0 < q && m0 < N) {
        float acc[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
        const int jmax = min(i0 + 3, q - 1);
        for (int j = 0; j <= jmax; ++j) {
          float at[4], vj[4];
          load4(att + j * QP + i0, at);
          load4(vs + j * N + m0, vj);
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(at[a], vj[c], acc[a][c]);
        }
        for (int n = 0; n < N; ++n) {
          float ri[4], sv[4];
          load4(rt + n * LD + i0, ri);
          load4(st + n * N + m0, sv);
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(ri[a], sv[c], acc[a][c]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + a;
          if (i >= q) break;
          T* dst = y + (s0 + i) * y_ss + m0;
#pragma unroll
          for (int c = 0; c < 4; ++c) from_float(dst + c, acc[a][c]);
        }
      }
    }
    __syncthreads();                      // y has read the state

    // ---- state: S[n0..n0+3][m0..m0+3] <- S 2^(cum_last) + sum_j k'_j v_j
    {
      const int m0 = 4 * (tid % 16), n0 = 4 * (tid / 16);
      if (m0 < N && n0 < N) {
        float acc[4][4];                  // [n][m]
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
        const int jend = (q + 3) & ~3;    // rows past q are zero
        for (int j = 0; j < jend; j += 4) {
          float kk[4][4], vv[4][4];       // kk[n][row], vv[row][m]
#pragma unroll
          for (int a = 0; a < 4; ++a) load4(kt + (n0 + a) * LD + j, kk[a]);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) load4(vs + (j + jj) * N + m0, vv[jj]);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(kk[a][jj], vv[jj][c], acc[a][c]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float decay = exp2_approx(static_cast<float>(R[NT * N + n0 + a]));
          float sv[4];
          load4(st + (n0 + a) * N + m0, sv);
#pragma unroll
          for (int c = 0; c < 4; ++c) sv[c] = fmaf(sv[c], decay, acc[a][c]);
          store4(st + (n0 + a) * N + m0, sv);
        }
      }
    }
  }

  __syncthreads();
  for (int e = tid; e < N * N; e += THREADS) p.s_out[s_off + e] = st[e];
}

cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t bytes = static_cast<size_t>(layout(p.Q, p.N).total) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rwkv6_scan_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  rwkv6_scan_kernel<float><<<dim3(p.H, p.B), THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace fma

// ---------------------------------------------------------------------------
// tc: the bf16 design, sub-tile-factored decays and tensor-core products
// ---------------------------------------------------------------------------

namespace tc {

constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int QP = 128, NP = 64, NT = QP / 16;   // rows, channels and 16-row tiles of a staged chunk
constexpr int LDB = NP + 8;      // row stride of r, k, v (bf16, 144 bytes)
constexpr int LDC = NP + 4;      // row stride of c and k' (fp32, 272 bytes)
constexpr int LDS = NP + 8;      // row stride of the state St[m][n] (fp32, 288 bytes)
constexpr int LDA = 24;          // row stride of a warp's diagonal tile (fp32)
constexpr int PAIRS = NT * (NT - 1) / 2;          // off-diagonal tile pairs (ti > tj)
constexpr int SPANS = 2 * NT + 1 + PAIRS;         // decays between tile edges, per channel

// Shared memory of a block; every tile has its fixed size (128 rows, 64
// channels, zeros past the chunk and past N), so every address is a constant
// offset:
//   rs, ks, vs [2][QP][LDB]   r, k and v, bf16 as read, two buffers each:
//                       the next chunk's land in the other while this one is computed
//   cw [QP][LDC]        c_j = cum_j - R_t(j), fp32
//   kq [QP][LDC]        k'_j = k_j 2^(c_last(t) - c_j)
//   st [NP][LDS]        the state, transposed: st[m][n] = S[n][m], fp32
//   tot [NT][NP]        each tile's sum of log2-decays, fp64
//   t1, t2 [NT][NP]     2^(R_t), 2^(R_last - R_t+1)
//   pd [PAIRS][NP]      2^(R_ti - R_tj+1), pair ti (ti - 1) / 2 + tj
//   dec [NP], us [NP]   2^(R_last), the bonus u
//   att [WARPS][16][LDA]  each warp's diagonal tile of scores
struct Layout {
  static constexpr size_t rs = 0;
  static constexpr size_t ks = rs + 2 * (size_t)QP * LDB * 2;
  static constexpr size_t vs = ks + 2 * (size_t)QP * LDB * 2;
  static constexpr size_t cw = vs + 2 * (size_t)QP * LDB * 2;
  static constexpr size_t kq = cw + (size_t)QP * LDC * 4;
  static constexpr size_t st = kq + (size_t)QP * LDC * 4;
  static constexpr size_t tot = st + (size_t)NP * LDS * 4;
  static constexpr size_t t1 = tot + (size_t)NT * NP * 8;
  static constexpr size_t t2 = t1 + (size_t)NT * NP * 4;
  static constexpr size_t pd = t2 + (size_t)NT * NP * 4;
  static constexpr size_t dec = pd + (size_t)PAIRS * NP * 4;
  static constexpr size_t us = dec + (size_t)NP * 4;
  static constexpr size_t att = us + (size_t)NP * 4;
  static constexpr size_t bytes = att + (size_t)WARPS * 16 * LDA * 4;
};

// The decays between tile edges, per channel: entry `kind` is 2^(R_hi - R_lo)
// over the tiles [lo, hi): 2^(R_t) for kind t < NT, then 2^(R_last - R_t+1),
// 2^(R_last), then the pairs (ti, tj), tj < ti, in the order of pd: [tj + 1, ti)
__host__ __device__ constexpr int span_lo(int kind) {
  if (kind < NT) return 0;
  if (kind < 2 * NT) return kind - NT + 1;
  if (kind == 2 * NT) return 0;
  int pair = kind - 2 * NT - 1, ti = 1;
  while (pair >= ti) { pair -= ti; ++ti; }
  return pair + 1;
}
__host__ __device__ constexpr int span_hi(int kind) {
  if (kind < NT) return kind;
  if (kind <= 2 * NT) return NT;
  int pair = kind - 2 * NT - 1, ti = 1;
  while (pair >= ti) { pair -= ti; ++ti; }
  return ti;
}

// entries KIND, KIND + 4, ... of channel n, from its fp64 edge sums R; each
// span a constant of the code
template <int KIND>
__device__ __forceinline__ void edge_decays(const double (&R)[NT + 1], int n, float* t1, float* t2, float* dec,
                                            float* pd) {
  if constexpr (KIND < SPANS) {
    constexpr int lo = span_lo(KIND), hi = span_hi(KIND);
    float* dst = KIND < NT ? t1 + KIND * NP : KIND < 2 * NT ? t2 + (KIND - NT) * NP
               : KIND == 2 * NT ? dec : pd + (KIND - 2 * NT - 1) * NP;
    dst[n] = exp2_approx(static_cast<float>(R[hi] - R[lo]));
    edge_decays<KIND + 4>(R, n, t1, t2, dec, pd);
  }
}

__device__ inline float bf_lo(unsigned v) { return __uint_as_float(v << 16); }          // bf16 -> fp32, exact
__device__ inline float bf_hi(unsigned v) { return __uint_as_float(v & 0xffff0000u); }
__device__ inline unsigned lo_bits(unsigned v) { return v << 16; }
__device__ inline unsigned hi_bits(unsigned v) { return v & 0xffff0000u; }
__device__ inline unsigned ld32(const unsigned short* p) { return *reinterpret_cast<const unsigned*>(p); }

// v = big + small + r, both parts TF32 (10 explicit mantissa bits), each cut
// toward zero: |r| < 2^-20 |v|.  One subtraction and two masks
__device__ inline void split(float v, unsigned& big, unsigned& small) {
  big = __float_as_uint(v) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big)) & 0xffffe000u;
}

__device__ inline void mma_tf32(float (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a 4-entry A fragment of fp32 values as its big and small TF32 parts
__device__ inline void split4(const float (&v)[4], unsigned (&big)[4], unsigned (&small)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split(v[e], big[e], small[e]);
}

// big x big + big x small + small x big (small x small, below 2^-20, dropped)
__device__ inline void mma3(float (&d)[4], const unsigned (&ab)[4], const unsigned (&as)[4],
                            const unsigned (&bb)[2], const unsigned (&bs)[2]) {
  mma_tf32(d, ab, bb);
  mma_tf32(d, ab, bs);
  mma_tf32(d, as, bb);
}

// Four 8 x 8 bf16 matrices, transposed: lane 4g + t gets (row 2t, column g)
// in its low half and (row 2t + 1, column g) in its high half of each
__device__ inline void ldmatrix_x4_trans(unsigned (&r)[4], const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ inline void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" :: "r"(d), "l"(src), "r"(bytes) : "memory");
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ inline void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// 16 bytes of a staged bf16 row from column c: the source's columns c .. c + 7
// (zeros past n, or all zeros for a row past the chunk); by cp.async where the
// source rows are 16-byte aligned runs, element by element where not
__device__ inline void stage16(unsigned short* dst, const unsigned short* row, int c, int n, bool valid, bool vec) {
  if (!valid || c >= n) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  } else if (vec) {
    cp_async16(dst, row + c, 2 * min(8, n - c));
  } else {
    union { unsigned short e[8]; uint4 u; } tmp;
#pragma unroll
    for (int i = 0; i < 8; ++i) tmp.e[i] = c + i < n ? row[c + i] : 0;
    *reinterpret_cast<uint4*>(dst) = tmp.u;
  }
}


// Built with -DRWKV6_PHASE_CLOCKS (launch/profile_rwkv6_scan.py --phase-clocks,
// never by the package), lane 0 of every warp of the first 128 blocks writes
// the SM's clock at 13 phase edges of its first 4 chunks; PHASE is empty else.
#ifdef RWKV6_PHASE_CLOCKS
constexpr int CLOCK_BLOCKS = 128, CLOCK_CHUNKS = 4, CLOCK_EDGES = 13;
__device__ long long g_phase_clocks[CLOCK_BLOCKS * WARPS * CLOCK_CHUNKS * CLOCK_EDGES];
#define PHASE(i)                                                                                    \
  do {                                                                                              \
    const int blk = blockIdx.y * gridDim.x + blockIdx.x;                                            \
    if (lane == 0 && blk < CLOCK_BLOCKS && it < CLOCK_CHUNKS)                                       \
      g_phase_clocks[((blk * WARPS + warp) * CLOCK_CHUNKS + it) * CLOCK_EDGES + (i)] = clock64();    \
  } while (0)
#else
#define PHASE(i) do {} while (0)
#endif

// grid: (H, B), THREADS threads; a block owns one (batch row, head) and walks its chunks.
__global__ void __launch_bounds__(THREADS, 1) rwkv6_scan_tc_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  using lay = Layout;
  unsigned short* rs0 = reinterpret_cast<unsigned short*>(smem + lay::rs);
  unsigned short* ks0 = reinterpret_cast<unsigned short*>(smem + lay::ks);
  unsigned short* rs = rs0;
  unsigned short* ks = ks0;
  float* cw = reinterpret_cast<float*>(smem + lay::cw);
  float* kq = reinterpret_cast<float*>(smem + lay::kq);
  float* st = reinterpret_cast<float*>(smem + lay::st);
  double* tot = reinterpret_cast<double*>(smem + lay::tot);
  float* t1 = reinterpret_cast<float*>(smem + lay::t1);
  float* t2 = reinterpret_cast<float*>(smem + lay::t2);
  float* pd = reinterpret_cast<float*>(smem + lay::pd);
  float* dec = reinterpret_cast<float*>(smem + lay::dec);
  float* us = reinterpret_cast<float*>(smem + lay::us);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int hd = blockIdx.x, b = blockIdx.y;
  const int N = p.N, S = p.S, Q = p.Q;
  const unsigned short* r = static_cast<const unsigned short*>(p.r) + b * p.r_sb + hd * p.r_sh;
  const unsigned short* k = static_cast<const unsigned short*>(p.k) + b * p.k_sb + hd * p.k_sh;
  const unsigned short* v = static_cast<const unsigned short*>(p.v) + b * p.v_sb + hd * p.v_sh;
  const float* w = p.w + b * p.w_sb + hd * p.w_sh;
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(p.y) + ((long long)b * S * p.H + hd) * N;   // + s * H * N
  const long long y_ss = (long long)p.H * N;
  const long long s_off = ((long long)b * p.H + hd) * N * N;
  // warp w owns the outputs of row tile rt; warps w and w + 4 share a
  // scheduler, so they take tiles k and 7 - k: 7 off-diagonal pairs each
  const int rt = warp < 4 ? warp : 11 - warp;
  const int i0 = 16 * rt;
  float* att = reinterpret_cast<float*>(smem + lay::att) + warp * 16 * LDA;

  // Loads of a chunk: pieces tid + THREADS i, i in [first, last), of its r
  // and k (rows of 16 pieces) and its v (8); the next chunk's are issued a
  // quarter at a time through this one, so no warp waits long on a full queue
  auto stage_rk = [&](int buf, int s0, int q, int first, int last) {
    unsigned short* rb = rs0 + buf * QP * LDB;
    unsigned short* kb = ks0 + buf * QP * LDB;
    for (int e = tid + first * THREADS; e < min(QP * 16, last * THREADS); e += THREADS) {
      const int row = e / 16, part = e % 16;
      const long long s = s0 + row;
      if (part < 8) stage16(rb + row * LDB + 8 * part, r + s * p.r_ss, 8 * part, N, row < q, p.rkv_vec);
      else stage16(kb + row * LDB + 8 * (part - 8), k + s * p.k_ss, 8 * (part - 8), N, row < q, p.rkv_vec);
    }
  };
  // w of the rows this thread sums (channel tid % 64, tiles tid / 64 and + 4),
  // read straight into registers, a chunk ahead
  float wv[2][16];
  auto load_w = [&](int s0, int q, int part) {     // rows 4 part .. 4 part + 3 of its two tiles
    const int n = tid % NP;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (j / 4 != part) continue;
        const int row = 16 * (tid / NP + 4 * h) + j;
        wv[h][j] = row < q && n < N ? w[(long long)(s0 + row) * p.w_ss + n] : 1.f;
      }
  };
  auto stage_v = [&](int buf, int s0, int q, int first, int last) {
    unsigned short* vb = reinterpret_cast<unsigned short*>(smem + lay::vs) + buf * QP * LDB;
    for (int e = tid + first * THREADS; e < min(QP * 8, last * THREADS); e += THREADS) {
      const int row = e / 8, c = 8 * (e % 8);
      stage16(vb + row * LDB + c, v + (long long)(s0 + row) * p.v_ss, c, N, row < q, p.rkv_vec);
    }
  };

  for (int e = tid; e < WARPS * 16 * LDA; e += THREADS)   // above the diagonal stays zero
    reinterpret_cast<float*>(smem + lay::att)[e] = 0.f;
  for (int e = tid; e < NP * NP; e += THREADS) {
    const int m = e / NP, n = e % NP;
    st[m * LDS + n] = p.s0 && m < N && n < N ? p.s0[s_off + n * N + m] : 0.f;
  }
  for (int n = tid; n < NP; n += THREADS) us[n] = n < N ? p.u[hd * N + n] : 0.f;
  stage_rk(0, 0, min(Q, S), 0, 8);
  stage_v(0, 0, min(Q, S), 0, 4);
  cp_async_commit();
  for (int part = 0; part < 4; ++part) load_w(0, min(Q, S), part);

  for (int s0 = 0, it = 0; s0 < S; s0 += Q, ++it) {
    const int q = min(Q, S - s0);
    const int qp = (q + 15) & ~15;          // rows worked on; rows q .. qp - 1 are zero
    const bool more = s0 + Q < S;
    const int qn = more ? min(Q, S - s0 - Q) : 0;
    const unsigned short* vb = reinterpret_cast<const unsigned short*>(smem + lay::vs) + (it & 1) * QP * LDB;
    PHASE(0);
    cp_async_wait_all();
    __syncthreads();                        // this chunk is staged, the previous one is done
    PHASE(1);
    rs = rs0 + (it & 1) * QP * LDB;
    ks = ks0 + (it & 1) * QP * LDB;
    // a quarter of the next chunk's r, k and v
    auto stage_next = [&](int part) {
      if (more) {
        stage_rk((it + 1) & 1, s0 + Q, qn, 2 * part, 2 * part + 2);
        stage_v((it + 1) & 1, s0 + Q, qn, part, part + 1);
      }
    };
    stage_next(0);

    // ---- log2-decays: channel n, tile tl; l from the MUFU's lg2, the running
    // sum from the tile's first row in fp64, narrowed (c); k' = k 2^(c_last -
    // c); the tile's total
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = tid % NP, tl = tid / NP + 4 * h;
      float c[16];
      double run = 0.0;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int row = 16 * tl + j;
        run += static_cast<double>(__log2f(fminf(fmaxf(wv[h][j], 1e-6f), 1.f)));   // rows past q: w = 1
        c[j] = static_cast<float>(run);
        cw[row * LDC + n] = c[j];
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int row = 16 * tl + j;
        const float kv = row < q ? __uint_as_float(static_cast<unsigned>(ks[row * LDB + n]) << 16) : 0.f;
        kq[row * LDC + n] = kv * exp2_approx(c[15] - c[j]);
      }
      tot[tl * NP + n] = run;
    }
    PHASE(2);
    __syncthreads();
    stage_next(1);
    PHASE(3);
    // ---- decays between tile edges: R_t as fp64 sums of the tiles' totals,
    // each difference taken in fp64, narrowed, then one ex2; channel tid % 64,
    // entries tid / 64 + 4 i
    {
      const int n = tid % NP;
      double R[NT + 1];
      R[0] = 0.0;
#pragma unroll
      for (int tl = 0; tl < NT; ++tl) R[tl + 1] = R[tl] + tot[tl * NP + n];
      switch (tid / NP) {                   // warp-uniform
        case 0: edge_decays<0>(R, n, t1, t2, dec, pd); break;
        case 1: edge_decays<1>(R, n, t1, t2, dec, pd); break;
        case 2: edge_decays<2>(R, n, t1, t2, dec, pd); break;
        default: edge_decays<3>(R, n, t1, t2, dec, pd); break;
      }
    }
    PHASE(4);
    __syncthreads();
    stage_next(2);
    PHASE(5);

    if (i0 < qp) {
      // ---- the diagonal tile, direct form on the CUDA cores: lane (a, cq)
      // takes the row pairs (a, 15 - a) and (a + 4, 11 - a), 15 pairs j < i in
      // each, over channels 4 cq .. 4 cq + 3 and 32 + 4 cq ..; eight lanes of
      // one row read 32 banks.  Every exponent c_i-1 - c_j <= 0, none masked.
      {
        const int a = lane >> 3, cq = lane & 7;
        float acc[2][15], ub[2][2];
#pragma unroll
        for (int pp = 0; pp < 2; ++pp) {
          ub[pp][0] = ub[pp][1] = 0.f;
#pragma unroll
          for (int m = 0; m < 15; ++m) acc[pp][m] = 0.f;
        }
#pragma unroll
        for (int cg = 0; cg < 2; ++cg) {
          const int n = 32 * cg + 4 * cq;
          const float4 u4 = *reinterpret_cast<const float4*>(us + n);
          const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
          for (int pp = 0; pp < 2; ++pp) {
            const int ra_row = a + 4 * pp, rb_row = 15 - ra_row;
            const uint2 ra2 = *reinterpret_cast<const uint2*>(rs + (i0 + ra_row) * LDB + n);
            const uint2 rb2 = *reinterpret_cast<const uint2*>(rs + (i0 + rb_row) * LDB + n);
            const uint2 ka2 = *reinterpret_cast<const uint2*>(ks + (i0 + ra_row) * LDB + n);
            const uint2 kb2 = *reinterpret_cast<const uint2*>(ks + (i0 + rb_row) * LDB + n);
            const float ra[4] = {bf_lo(ra2.x), bf_hi(ra2.x), bf_lo(ra2.y), bf_hi(ra2.y)};
            const float rb[4] = {bf_lo(rb2.x), bf_hi(rb2.x), bf_lo(rb2.y), bf_hi(rb2.y)};
            const float ka[4] = {bf_lo(ka2.x), bf_hi(ka2.x), bf_lo(ka2.y), bf_hi(ka2.y)};
            const float kb[4] = {bf_lo(kb2.x), bf_hi(kb2.x), bf_lo(kb2.y), bf_hi(kb2.y)};
            const float4 ea4 = ra_row ? *reinterpret_cast<const float4*>(cw + (i0 + ra_row - 1) * LDC + n)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
            const float4 eb4 = *reinterpret_cast<const float4*>(cw + (i0 + rb_row - 1) * LDC + n);
            const float ea[4] = {ea4.x, ea4.y, ea4.z, ea4.w}, eb[4] = {eb4.x, eb4.y, eb4.z, eb4.w};
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              ub[pp][0] = fmaf(ra[x] * uu[x], ka[x], ub[pp][0]);
              ub[pp][1] = fmaf(rb[x] * uu[x], kb[x], ub[pp][1]);
            }
#pragma unroll
            for (int m = 0; m < 15; ++m) {
              const bool first = m < ra_row;  // (ra_row, m) while m < ra_row, then (rb_row, m - ra_row)
              const int j = first ? m : m - ra_row;
              const uint2 kj2 = *reinterpret_cast<const uint2*>(ks + (i0 + j) * LDB + n);
              const float4 cj4 = *reinterpret_cast<const float4*>(cw + (i0 + j) * LDC + n);
              const float kj[4] = {bf_lo(kj2.x), bf_hi(kj2.x), bf_lo(kj2.y), bf_hi(kj2.y)};
              const float cj[4] = {cj4.x, cj4.y, cj4.z, cj4.w};
#pragma unroll
              for (int x = 0; x < 4; ++x)
                acc[pp][m] = fmaf((first ? ra[x] : rb[x]) * kj[x], exp2_approx((first ? ea[x] : eb[x]) - cj[x]),
                                  acc[pp][m]);
            }
          }
        }
#pragma unroll
        for (int pp = 0; pp < 2; ++pp) {
#pragma unroll
          for (int m = 0; m < 15; ++m)
#pragma unroll
            for (int o = 1; o < 8; o <<= 1) acc[pp][m] += __shfl_xor_sync(0xffffffffu, acc[pp][m], o);
#pragma unroll
          for (int o = 1; o < 8; o <<= 1) {
            ub[pp][0] += __shfl_xor_sync(0xffffffffu, ub[pp][0], o);
            ub[pp][1] += __shfl_xor_sync(0xffffffffu, ub[pp][1], o);
          }
        }
        if (cq == 0) {
#pragma unroll
          for (int pp = 0; pp < 2; ++pp) {
            const int ra_row = a + 4 * pp, rb_row = 15 - ra_row;
#pragma unroll
            for (int m = 0; m < 15; ++m) {
              if (m < ra_row) att[ra_row * LDA + m] = acc[pp][m];
              else att[rb_row * LDA + m - ra_row] = acc[pp][m];
            }
            att[ra_row * LDA + ra_row] = ub[pp][0];
            att[rb_row * LDA + rb_row] = ub[pp][1];
          }
        }
        __syncwarp();
      }

      PHASE(6);
      // ---- r 2^(cum_i-1) S and the off-diagonal scores, 8 channels a step.
      // The k index of each TF32 product is permuted (slot t <-> channel 2t,
      // slot t + 4 <-> 2t + 1 of each group of 8), the same in both operands,
      // so every operand is one 32- or 64-bit read.  A = r' = r 2^(c_i-1)
      // (rows i0 + g, i0 + g + 8), for r S times 2^(R_rt); B = S, and k' times
      // the pair's 2^(R_rt - R_tj+1); every product in two TF32 parts a side.
      float yacc[NP / 8][4], sc[NT - 1][2][4];
#pragma unroll
      for (int pt = 0; pt < NP / 8; ++pt)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[pt][e] = 0.f;
#pragma unroll
      for (int tj = 0; tj < NT - 1; ++tj)
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[tj][nn][e] = 0.f;
      const float* pdr = pd + (rt * (rt - 1) / 2) * NP;
#pragma unroll 2
      for (int s8 = 0; s8 < NP / 8; ++s8) {
        const int ch = 8 * s8 + 2 * t;
        const unsigned rv0 = ld32(rs + (i0 + g) * LDB + ch), rv1 = ld32(rs + (i0 + g + 8) * LDB + ch);
        const float2 e0 = g ? *reinterpret_cast<const float2*>(cw + (i0 + g - 1) * LDC + ch) : make_float2(0.f, 0.f);
        const float2 e1 = *reinterpret_cast<const float2*>(cw + (i0 + g + 7) * LDC + ch);
        // A slot order: (g, ch), (g + 8, ch), (g, ch + 1), (g + 8, ch + 1)
        const float ar[4] = {bf_lo(rv0) * exp2_approx(e0.x), bf_lo(rv1) * exp2_approx(e1.x),
                             bf_hi(rv0) * exp2_approx(e0.y), bf_hi(rv1) * exp2_approx(e1.y)};
        const float2 d1 = *reinterpret_cast<const float2*>(t1 + rt * NP + ch);
        const float ai[4] = {ar[0] * d1.x, ar[1] * d1.x, ar[2] * d1.y, ar[3] * d1.y};
        unsigned rbig[4], rsmall[4], ibig[4], ismall[4];
        split4(ar, rbig, rsmall);
        split4(ai, ibig, ismall);
#pragma unroll
        for (int pt = 0; pt < NP / 8; ++pt) {
          const float2 sv = *reinterpret_cast<const float2*>(st + (8 * pt + g) * LDS + ch);
          unsigned sbig[2], ssmall[2];
          split(sv.x, sbig[0], ssmall[0]);
          split(sv.y, sbig[1], ssmall[1]);
          mma3(yacc[pt], ibig, ismall, sbig, ssmall);
        }
#pragma unroll
        for (int tj = 0; tj < NT - 1; ++tj) {
          if (tj < rt) {
            const float2 dp = *reinterpret_cast<const float2*>(pdr + tj * NP + ch);
#pragma unroll
            for (int nn = 0; nn < 2; ++nn) {
              const float2 kv = *reinterpret_cast<const float2*>(kq + (16 * tj + 8 * nn + g) * LDC + ch);
              unsigned kbig[2], ksmall[2];
              split(kv.x * dp.x, kbig[0], ksmall[0]);
              split(kv.y * dp.y, kbig[1], ksmall[1]);
              mma3(sc[tj][nn], rbig, rsmall, kbig, ksmall);
            }
          }
        }
      }
      PHASE(7);
      stage_next(3);
      cp_async_commit();
      // w of the next chunk to registers, a quarter at a time while this one finishes
      if (more) load_w(s0 + Q, qn, 0);

      // ---- y += att v over the key tiles tj <= rt.  A score accumulator is
      // an A fragment of the next product without moving (rows g, g + 8; keys
      // 2t, 2t + 1 in slots t, t + 4); att in two TF32 parts, v (bf16) exact.
      auto att_v = [&](const float (&av)[4], int key0) {
        unsigned abig[4], asmall[4];
        split4(av, abig, asmall);
        unsigned xr[2][4];                  // v[key0 + 2t .. + 1][8 pt + g]
#pragma unroll
        for (int h = 0; h < 2; ++h)
          ldmatrix_x4_trans(xr[h], vb + (key0 + (lane & 7)) * LDB + 32 * h + 8 * (lane >> 3));
#pragma unroll
        for (int pt = 0; pt < NP / 8; ++pt) {
          const unsigned bv[2] = {lo_bits(xr[pt / 4][pt % 4]), hi_bits(xr[pt / 4][pt % 4])};
          mma_tf32(yacc[pt], abig, bv);
          mma_tf32(yacc[pt], asmall, bv);
        }
      };
#pragma unroll
      for (int tj = 0; tj < NT - 1; ++tj) {
        if (tj < rt) {
#pragma unroll
          for (int nn = 0; nn < 2; ++nn) {
            const float av[4] = {sc[tj][nn][0], sc[tj][nn][2], sc[tj][nn][1], sc[tj][nn][3]};
            att_v(av, 16 * tj + 8 * nn);
          }
        }
      }
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        const float2 a0 = *reinterpret_cast<const float2*>(att + g * LDA + 8 * nn + 2 * t);
        const float2 a1 = *reinterpret_cast<const float2*>(att + (g + 8) * LDA + 8 * nn + 2 * t);
        const float av[4] = {a0.x, a1.x, a0.y, a1.y};
        att_v(av, i0 + 8 * nn);
      }
      if (more) load_w(s0 + Q, qn, 1);
      // y rows i0 + g, i0 + g + 8, columns 8 pt + 2t, + 1
#pragma unroll
      for (int pt = 0; pt < NP / 8; ++pt) {
        const int col = 8 * pt + 2 * t;
        if (col >= N) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = i0 + g + 8 * half;
          if (i < q)
            *reinterpret_cast<__nv_bfloat162*>(y + (s0 + i) * y_ss + col) =
                __floats2bfloat162_rn(yacc[pt][2 * half], yacc[pt][2 * half + 1]);
        }
      }
      PHASE(8);
      if (more) load_w(s0 + Q, qn, 2);
    } else {
      stage_next(3);
      cp_async_commit();
      if (more) for (int part = 0; part < 3; ++part) load_w(s0 + Q, qn, part);
    }

    PHASE(9);
    // ---- state products dS[n][m] = sum_j (k_j 2^(cum_last - cum_j))[n] v_j[m]:
    // warp w owns rows n0 .. n0 + 15 and columns m0 .. m0 + 31; A = k' 2^(R_last
    // - R_t+1) in two TF32 parts (rows n; slot t <-> row j0 + 2t), B = v exact
    float ds[4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[mt][e] = 0.f;
    const int n0 = 16 * (warp & 3), m0 = 32 * (warp >> 2);
#pragma unroll 2
    for (int j0 = 0; j0 < qp; j0 += 8) {
      const float* d2 = t2 + (j0 / 16) * NP + n0 + g;
      const float* k0 = kq + (j0 + 2 * t) * LDC + n0 + g;
      const float da = d2[0], db = d2[8];
      // A slot order: (n0 + g, j), (n0 + g + 8, j), (n0 + g, j + 1), (n0 + g + 8, j + 1)
      const float av[4] = {k0[0] * da, k0[8] * db, k0[LDC] * da, k0[LDC + 8] * db};
      unsigned abig[4], asmall[4];
      split4(av, abig, asmall);
      unsigned xr[4];
      ldmatrix_x4_trans(xr, vb + (j0 + (lane & 7)) * LDB + m0 + 8 * (lane >> 3));
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const unsigned bv[2] = {lo_bits(xr[mt]), hi_bits(xr[mt])};
        mma_tf32(ds[mt], abig, bv);
        mma_tf32(ds[mt], asmall, bv);
      }
    }
    PHASE(10);
    if (more) load_w(s0 + Q, qn, 3);
    __syncthreads();                        // every warp has read the state
    PHASE(11);
    // ---- S <- S 2^(R_last) + dS, stored transposed
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + g + 8 * (e >> 1), m = m0 + 8 * mt + 2 * t + (e & 1);
        float* sp = st + m * LDS + n;
        *sp = *sp * dec[n] + ds[mt][e];
      }
    }
    PHASE(12);
  }

  __syncthreads();
  for (int e = tid; e < N * N; e += THREADS) {
    const int n = e / N, m = e % N;
    p.s_out[s_off + e] = st[m * LDS + n];
  }
}

cudaError_t launch(const Params& p, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      rwkv6_scan_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Layout::bytes);
  if (err != cudaSuccess) return err;
  rwkv6_scan_tc_kernel<<<dim3(p.H, p.B), THREADS, Layout::bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32 (the FMA kernel), 1 = bfloat16 (the tensor-core kernel)
// (r, k, v and y alike; w, u, s0 and the state are fp32).  strides: 12
// element strides in the order r(b,s,h) k(b,s,h) v(b,s,h) w(b,s,h).  s0 may
// be null.  Returns the cudaError_t of the launch (0 = ok); it does not
// synchronise.
extern "C" int rwkv6_scan_fwd(
    const void* r, const void* k, const void* v, const void* w, const void* u, const void* s0,
    void* y, void* s_out, int B, int S, int H, int N, int Q, int dtype,
    const long long* strides, void* stream) {
  Params p;
  p.r = r; p.k = k; p.v = v; p.w = static_cast<const float*>(w);
  p.u = static_cast<const float*>(u); p.s0 = static_cast<const float*>(s0);
  p.y = y; p.s_out = static_cast<float*>(s_out);
  p.B = B; p.S = S; p.H = H; p.N = N; p.Q = Q;
  p.r_sb = strides[0]; p.r_ss = strides[1]; p.r_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.w_sb = strides[9]; p.w_ss = strides[10]; p.w_sh = strides[11];
  // rows are 16-byte aligned runs where the base and every row stride are
  // (bf16: 8 elements, fp32: 4)
  auto aligned = [](const void* base, const long long* st, int elems) {
    return reinterpret_cast<uintptr_t>(base) % 16 == 0 && st[0] % elems == 0 && st[1] % elems == 0 &&
           st[2] % elems == 0;
  };
  p.rkv_vec = aligned(r, strides, 8) && aligned(k, strides + 3, 8) && aligned(v, strides + 6, 8);
  if (B > 65535 || Q < 1 || Q > 128 || N < 4 || N > 64 || N % 4) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) err = fma::launch(p, s);
  else if (dtype == 1) err = tc::launch(p, s);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

#ifdef RWKV6_PHASE_CLOCKS
// the clocks of the last launch: 128 blocks x 8 warps x 4 chunks x 13 edges
extern "C" int rwkv6_scan_phase_clocks(long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, tc::g_phase_clocks, sizeof(tc::g_phase_clocks)));
}
#endif

extern "C" const char* rwkv6_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
