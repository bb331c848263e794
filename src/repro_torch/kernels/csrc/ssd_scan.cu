// Mamba2 chunked SSD scan — CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel `_ssd_kernel` / `ssd_scan` of
// src/repro/kernels/ssd_scan.py.  It computes the same function, chunk by
// chunk of Q rows, in fp32 inside:
//     cum_i  = sum_{t <= i} log_l_t                      (within the chunk)
//     y[i,p] = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) x[j,p]
//            + exp(cum_i) sum_n C_i[n] h[p,n]
//     h[p,n] <- h[p,n] exp(cum_last) + sum_j x[j,p] B_j[n] exp(cum_last - cum_j)
// with y rounded once to x's type and the final h written in fp32.
//
// What differs from the TPU kernel, because the machine does:
//  * The TPU grid is (B, chunks) with the chunk axis sequential and all H
//    heads in one program, the (H, P, N) state in VMEM.  The state is
//    head-local, so here one thread block owns one (batch row, head) and
//    LOOPS over the chunks in order; its P x N fp32 state stays in shared
//    memory for the whole sequence and is written out once, at the end.  At
//    the zamba2-1.2b prefill shape that is B * H = 256 blocks.
//  * Per chunk the block stages x of its head (Q x P), B and C (Q x N, both
//    transposed so a thread reads 4 or 8 neighbouring rows as one 16-byte
//    load) as fp32 and the cumulative log decay in fp64, then runs
//    three register-tiled products: att = (C B^T) * decay (8 x 8 tiles, only
//    the tiles on or below the diagonal), y = att x + exp(cum) C h^T (4 x 4
//    tiles, each thread takes row groups g and Q/4 - 1 - g so every thread
//    walks the same number of rows), and the state update (4 x 4 tiles).
//  * The decay is masked BEFORE its exponential: only exp of a non-positive
//    number is ever taken (cum_i - cum_j for j <= i, cum_last - cum_j,
//    cum_i).  exp(cum_i - cum_j) is never factored into exp(cum_i) *
//    exp(-cum_j), which overflows under strong decay (log_l = -13 over 128
//    rows).  The cumulative sum is kept in fp64 and each difference taken
//    there before it is narrowed for expf: over a chunk of 128 rows |cum|
//    reaches ~100, where an fp32 ulp (7.6e-6) of each cum would move the
//    decays of neighbouring rows by ~1e-5 relative.
//  * Any S: a partial last chunk is staged with zero rows (x = 0, B = 0,
//    log_l = 0), which add nothing to the state and do not decay it; their y
//    is not written.  An initial state h0 may be given.  Q <= 128, P and N
//    multiples of 4 up to 64 (the wrapper checks).  x, B and C are read
//    through element strides (innermost stride 1), so the model's slices of
//    its conv output are read in place.
//
// Bound on this card.  Bytes: x, log_l, B, C read once, y and h written
// once (38.8 MB at the zamba2-1.2b prefill shape, 0.0116 ms at 3.35 TB/s).
// Operations: the causal pairs' scores (once per batch row, shared by the
// heads), att x, C h^T and the state update, 3.2 GFLOP there, 0.003 ms at
// the bf16 tensor-core peak.  This first version runs every product as fp32
// FMA on the CUDA cores (>= 0.05 ms at 67 TFLOP/s) and recomputes C B^T in
// every head's block, 64x the scores' operations (2.1 GFLOP more at that
// shape); one block of 256 threads an SM at Q = 128 (186 KB of shared
// memory).  Scores shared across heads and tensor cores are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

struct Params {
  const void* x;        // (B, S, H, P), element strides x_sb, x_ss, x_sh, innermost 1
  const float* l;       // (B, S, H) log decay, fp32, strides l_sb, l_ss, l_sh
  const void* bm;       // (B, S, N), strides b_sb, b_ss, innermost 1
  const void* cm;       // (B, S, N), strides c_sb, c_ss, innermost 1
  const float* h0;      // (B, H, P, N) contiguous fp32, or null for zeros
  void* y;              // (B, S, H, P) contiguous, x's type
  float* h_out;         // (B, H, P, N) contiguous fp32
  int B, S, H, P, N, Q;
  long long x_sb, x_ss, x_sh, l_sb, l_ss, l_sh, b_sb, b_ss, c_sb, c_ss;
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

// Shared memory, in floats; QP = Q rounded up to 8, LD = QP + 4 (rows of
// 16-byte multiples):
//   bt[N][LD]    B of the chunk, transposed: bt[n][j] = B[j, n]
//   ct[N][LD]    C, transposed
//   att[QP][LD]  att transposed: att[j][i] = (C_i . B_j) exp(cum_i - cum_j), j <= i
//   xs[QP][P]    x of the block's head
//   ht[N][P]     the state, transposed: ht[n][p] = h[p, n]
//   cum[QP] (fp64, 2 floats each)   cumulative log decay
//   tail[QP]     exp(cum_last - cum_j)
__host__ __device__ inline size_t smem_floats(int Q, int P, int N) {
  const int QP = (Q + 7) & ~7, LD = QP + 4;
  return (size_t)2 * N * LD + (size_t)QP * LD + (size_t)QP * P + (size_t)N * P + 3 * QP;
}

// grid: (H, B), THREADS threads.
template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_scan_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int P = p.P, N = p.N;
  const int QP = (p.Q + 7) & ~7, LD = QP + 4;
  float* bt = smem;
  float* ct = bt + N * LD;
  float* att = ct + N * LD;
  float* xs = att + QP * LD;
  float* ht = xs + QP * P;
  double* cum = reinterpret_cast<double*>(ht + N * P);
  float* tail = reinterpret_cast<float*>(cum + QP);

  const int tid = threadIdx.x;
  const int hd = blockIdx.x, b = blockIdx.y;
  const T* x = static_cast<const T*>(p.x) + b * p.x_sb + hd * p.x_sh;
  const float* l = p.l + b * p.l_sb + hd * p.l_sh;
  const T* bm = static_cast<const T*>(p.bm) + b * p.b_sb;
  const T* cm = static_cast<const T*>(p.cm) + b * p.c_sb;
  T* y = static_cast<T*>(p.y) + ((long long)b * p.S * p.H + hd) * P;   // + s * H * P
  const long long y_ss = (long long)p.H * P;
  const long long h_off = ((long long)b * p.H + hd) * P * N;

  for (int e = tid; e < P * N; e += THREADS)
    ht[(e % N) * P + e / N] = p.h0 ? p.h0[h_off + e] : 0.f;

  // roles in the y and state phases: 16 column groups of 4 (p0), and 16
  // row-group pairs (y) or state-column groups of 4 (n0)
  const int p0 = 4 * (tid % 16);
  const int tr = tid / 16;
  const int n0 = 4 * tr;

  for (int s0 = 0; s0 < p.S; s0 += p.Q) {
    const int q = min(p.Q, p.S - s0);
    __syncthreads();                      // the previous chunk is read
    // ---- stage the chunk as fp32; rows q .. QP-1 are zero
    for (int e = tid; e < QP * P; e += THREADS) {
      const int j = e / P;
      xs[e] = j < q ? to_float(x[(s0 + j) * p.x_ss + e % P]) : 0.f;
    }
    for (int e = tid; e < QP * N; e += THREADS) {
      const int j = e / N, n = e % N;
      bt[n * LD + j] = j < q ? to_float(bm[(s0 + j) * p.b_ss + n]) : 0.f;
      ct[n * LD + j] = j < q ? to_float(cm[(s0 + j) * p.c_ss + n]) : 0.f;
    }
    for (int j = tid; j < QP; j += THREADS) tail[j] = j < q ? l[(s0 + j) * p.l_ss] : 0.f;
    __syncthreads();
    if (tid == 0) {                       // in row order
      double run = 0.0;
      for (int j = 0; j < QP; ++j) cum[j] = run += tail[j];
    }
    __syncthreads();
    const double last = cum[q - 1];
    for (int j = tid; j < QP; j += THREADS) tail[j] = expf(static_cast<float>(last - cum[j]));

    // ---- att: one 8 x 8 tile on or below the diagonal a thread
    {
      const int nb = QP / 8;
      if (tid < nb * (nb + 1) / 2) {
        int bi = 0;
        while ((bi + 1) * (bi + 2) / 2 <= tid) ++bi;
        const int i0 = 8 * bi, j0 = 8 * (tid - bi * (bi + 1) / 2);
        if (i0 < q) {                     // tiles of padding rows are never read
          float acc[8][8];
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
          for (int n = 0; n < N; ++n) {
            float a[8], bb[8];
            load4(ct + n * LD + i0, a);
            load4(ct + n * LD + i0 + 4, a + 4);
            load4(bt + n * LD + j0, bb);
            load4(bt + n * LD + j0 + 4, bb + 4);
#pragma unroll
            for (int r = 0; r < 8; ++r)
#pragma unroll
              for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], bb[c], acc[r][c]);
          }
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int j = j0 + c;
            float v[8];
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              const int i = i0 + r;
              v[r] = j <= i ? acc[r][c] * expf(static_cast<float>(cum[i] - cum[j])) : 0.f;   // masked first
            }
            store4(att + j * LD + i0, v);
            store4(att + j * LD + i0 + 4, v + 4);
          }
        }
      }
    }
    __syncthreads();

    // ---- y = att x + exp(cum) C h^T: row groups tr and QP/4 - 1 - tr, columns p0..p0+3
    {
      const int ng = QP / 4;
      if (tr < ng / 2 && p0 < P) {
        for (int half = 0; half < 2; ++half) {
          const int i0 = 4 * (half == 0 ? tr : ng - 1 - tr);
          if (i0 >= q) continue;
          float acc[4][4], inter[4][4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = inter[r][c] = 0.f;
          const int jmax = min(i0 + 3, q - 1);
          for (int j = 0; j <= jmax; ++j) {
            float a[4], xv[4];
            load4(att + j * LD + i0, a);
            load4(xs + j * P + p0, xv);
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], xv[c], acc[r][c]);
          }
          for (int n = 0; n < N; ++n) {
            float cv[4], hv[4];
            load4(ct + n * LD + i0, cv);
            load4(ht + n * P + p0, hv);
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int c = 0; c < 4; ++c) inter[r][c] = fmaf(cv[r], hv[c], inter[r][c]);
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = i0 + r;
            if (i >= q) break;
            const float e = expf(static_cast<float>(cum[i]));
            T* dst = y + (s0 + i) * y_ss + p0;
#pragma unroll
            for (int c = 0; c < 4; ++c) from_float(dst + c, acc[r][c] + inter[r][c] * e);
          }
        }
      }
    }
    __syncthreads();                      // y has read the state

    // ---- state: h[p0..p0+3][n0..n0+3] <- h exp(cum_last) + sum_j x_j tail_j B_j
    if (p0 < P && n0 < N) {
      float acc[4][4];                    // [p][n]
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      const int jend = (q + 3) & ~3;      // rows past q are zero
      for (int j = 0; j < jend; j += 4) {
        float w[4], xw[4][4], bv[4][4];   // xw[row][p], bv[n][row]
        load4(tail + j, w);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          load4(xs + (j + jj) * P + p0, xw[jj]);
#pragma unroll
          for (int c = 0; c < 4; ++c) xw[jj][c] *= w[jj];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) load4(bt + (n0 + c) * LD + j, bv[c]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(xw[jj][r], bv[c][jj], acc[r][c]);
      }
      const float decay = expf(static_cast<float>(last));
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float hv[4];
        load4(ht + (n0 + c) * P + p0, hv);
#pragma unroll
        for (int r = 0; r < 4; ++r) hv[r] = hv[r] * decay + acc[r][c];
        store4(ht + (n0 + c) * P + p0, hv);
      }
    }
  }

  __syncthreads();
  for (int e = tid; e < P * N; e += THREADS) p.h_out[h_off + e] = ht[(e % N) * P + e / N];
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  if (p.B > 65535 || p.Q < 1 || p.Q > 128 || p.P > 64 || p.N > 64 || p.P % 4 || p.N % 4)
    return cudaErrorInvalidValue;
  const size_t bytes = smem_floats(p.Q, p.P, p.N) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  ssd_scan_kernel<T><<<dim3(p.H, p.B), THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y alike; log_l, h0 and h are
// fp32).  strides: 10 element strides in the order x(b,s,h) l(b,s,h) B(b,s)
// C(b,s).  h0 may be null.  Returns the cudaError_t of the launch (0 = ok);
// it does not synchronise.
extern "C" int ssd_scan_fwd(
    const void* x, const void* log_l, const void* bm, const void* cm, const void* h0,
    void* y, void* h_out, int B, int S, int H, int P, int N, int Q, int dtype,
    const long long* strides, void* stream) {
  Params p;
  p.x = x; p.l = static_cast<const float*>(log_l); p.bm = bm; p.cm = cm;
  p.h0 = static_cast<const float*>(h0); p.y = y; p.h_out = static_cast<float*>(h_out);
  p.B = B; p.S = S; p.H = H; p.P = P; p.N = N; p.Q = Q;
  p.x_sb = strides[0]; p.x_ss = strides[1]; p.x_sh = strides[2];
  p.l_sb = strides[3]; p.l_ss = strides[4]; p.l_sh = strides[5];
  p.b_sb = strides[6]; p.b_ss = strides[7];
  p.c_sb = strides[8]; p.c_ss = strides[9];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) err = launch<float>(p, s);
  else if (dtype == 1) err = launch<__nv_bfloat16>(p, s);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
