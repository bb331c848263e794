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
// with y rounded once to r's type and the final S written in fp32.
//
// What differs from the TPU kernel, because the machine does:
//  * The TPU grid is (B * H, chunks) with the chunk axis sequential and the
//    N x N state in VMEM scratch.  Here one thread block owns one (batch
//    row, head) and LOOPS over the chunks in order; its state stays in
//    shared memory for the whole sequence and is written out once.  At the
//    rwkv6-1.6b prefill shape that is B * H = 128 blocks on 132 SMs.
//  * Per chunk the block stages r and k transposed ([n][row], so a thread
//    reads 4 neighbouring rows as one 16-byte load), v as [row][n], all as
//    fp32, and sums the log decays per channel in fp64 (each channel's rows
//    in 16 segments, then the segments' offsets).
//  * The intra-chunk scores are the DIRECT pairwise form,
//    2^((cum_{i-1} - cum_j)), for j < i only: the strictly-lower mask is
//    applied before any exponential (the diagonal is the bonus, above it
//    nothing is computed), so every exponent is <= 0.  It is never factored
//    into 2^(cum_{i-1}) * 2^(-cum_j), which overflows under strong decay
//    (w = 1e-6 over 128 rows: cum reaches -2551 in base 2; within a 16-row
//    tile already 319, past fp32's 128).
//  * The differences are taken without cancellation against large sums:
//    rows are grouped in tiles of 16, R_t is the cumulative sum before
//    tile t (fp64), c_j = cum_j - R_t(j) is kept in fp32 (at most 16 rows of
//    decay) and D = R_ti - R_tj (<= 0, fp32, one per tile pair and channel).
//    cum_{i-1} - cum_j = D + c_{i-1} - c_j, whose parts are each at most
//    16 rows of decay or of the size of the whole exponent: its rounding
//    error is a few ulps of max(|exponent|, 16 rows of decay), where the
//    reference's fp32 (cum_i - l_i) - cum_j carries ulps of |cum| (up to
//    the whole chunk's decay).
//  * One thread computes a 4 x 4 micro-tile of scores (rows i0..i0+3, keys
//    j0..j0+3) over all N channels, 16 exponentials per channel; the 528
//    micro-tiles on or below the diagonal (Q = 128) go one to a thread of
//    1024, so 16 warps an SM keep the special-function units busy (a first
//    version with 256 threads, two rounds of micro-tiles and a branch of its
//    own for the diagonal ones ran at a quarter of their rate).  Every
//    micro-tile runs the same instructions: on the diagonal the exponents
//    of j >= i are set to -inf before ex2 and the bonus added by a select.
//    Then r and k are scaled in place by their decays to the chunk's edges
//    (2^(cum_{i-1}) and 2^(cum_last - cum_j)) and two register-tiled
//    products follow: y = att v + r' S (one 4 x 4 tile a thread) and the
//    state update S = S 2^(cum_last) + k'^T v (4 x 4 tiles).
//  * Any S: a partial last chunk is staged with zero rows (r = k = v = 0,
//    l = 0), which add nothing to the state and do not decay it; their y is
//    not written.  An initial state s0 may be given.  Q <= 128, N a multiple
//    of 4 up to 64 (the wrapper checks).  r, k, v and w are read through
//    element strides (innermost stride 1), so the model's (B, S, D) ->
//    (B, S, H, N) views are read in place.
//
// Bound on this card.  Bytes: r, k, v (bf16) and w (fp32) read once, y and
// the state written once: 52.4 MB at the rwkv6-1.6b prefill shape
// (r, k, v (4, 512, 32, 64), chunk 128), 0.0157 ms at 3.35 TB/s.  What
// binds this design is the exponentials of the pairwise form: 266 M at that
// shape (Q (Q - 1) / 2 pairs x N channels a chunk and head), each one MUFU
// ex2 at 16 an SM a clock, >= 0.064 ms on 132 SMs at 1.98 GHz (the
// products, 2.2 GFLOP of fp32 FMA, >= 0.033 ms at 67 TFLOP/s).  One block of
// 1024 threads an SM (225 KB of shared memory at Q = 128, N = 64).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;
constexpr int NSEG = THREADS / 64;   // row segments of the cumulative sums, one thread a channel each
constexpr int TILE = 16;

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
};

__device__ inline float to_float(float v) { return v; }
__device__ inline float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ inline void from_float(float* p, float v) { *p = v; }
__device__ inline void from_float(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ inline void load4(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ inline void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// 2^x, one MUFU instruction; 2^(-inf) = 0 and results below 2^-126 flush to 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  if (p.B > 65535 || p.Q < 1 || p.Q > 128 || p.N < 4 || p.N > 64 || p.N % 4)
    return cudaErrorInvalidValue;
  const size_t bytes = static_cast<size_t>(layout(p.Q, p.N).total) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rwkv6_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  rwkv6_scan_kernel<T><<<dim3(p.H, p.B), THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v and y alike; w, u, s0 and the
// state are fp32).  strides: 12 element strides in the order r(b,s,h)
// k(b,s,h) v(b,s,h) w(b,s,h).  s0 may be null.  Returns the cudaError_t of
// the launch (0 = ok); it does not synchronise.
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) err = launch<float>(p, s);
  else if (dtype == 1) err = launch<__nv_bfloat16>(p, s);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* rwkv6_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
