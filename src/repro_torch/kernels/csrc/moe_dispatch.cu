// MoE capacity-bucketed dispatch — CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel `_dispatch_kernel` / `moe_dispatch` of
// src/repro/kernels/moe_dispatch.py.  It computes the same function, the
// GShard dispatch einsum
//     out[e, b, c, :] = sum_t disp[b, t, e, c] * x[b, t, :]
// with fp32 products and an fp32 sum over the tokens in ascending order, the
// result rounded once to x's type.  The reference's (T, E, C) x (T, D) form
// is the case B = 1; the batched form is the model's einsum "bsec,bsd->ebcd".
//
// What differs from the TPU kernel, because the machine does:
//  * The TPU feeds each (C, bt) x (bt, D) block to its matrix unit and
//    carries the (C, D) sum in VMEM across the sequential token axis.  Here
//    one thread block owns one (expert, batch row, tile of CT slots, tile of
//    D columns) and LOOPS over the tokens; the sum stays in registers
//    (CT x N fp32 a thread, N = 16 bytes of x's type) for the whole loop.
//  * The weights of a tile of BT tokens are staged in shared memory as fp32,
//    and a token whose weights in this tile of slots are all zero is skipped:
//    its row of x is never read.  On the model's path `disp` is one-hot (each
//    slot holds at most one token), so a block reads at most CT rows of x and
//    does no multiply-add on a zero.  Skipping a zero weight leaves the same
//    sum in the same token order for any finite x, so a dense `disp` gets the
//    general function.  The one difference from the einsum: a NaN or inf in x
//    under a zero weight gives NaN there (0 * inf) and nothing here.
//  * Any T, C, D >= 1: the ragged edges are masked here, nothing is padded.
//  * disp comes with four element strides and x with two (innermost stride 1),
//    so the caller's layout is read in place; rows of x and out are read and
//    written 16 bytes a thread where they are 16-byte aligned.
//
// Bound on this card: bytes.  disp and x read once and out written once are
// the least traffic (one multiply-add per output element on the model's
// one-hot path, so operations never bind).  This version reads every weight
// of its (expert, batch row, slot tile) once per tile of D columns (from L2
// after the first), and each row of x once per slot that holds it: K times
// in all for top-K routing, against once in the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CT = 8;               // capacity slots a block owns
constexpr int BT = 64;              // tokens whose weights are staged at a time
constexpr int MAX_THREADS = 128;

struct Params {
  const void* disp;
  const void* x;
  void* out;
  int B, T, E, C, D;
  long long d_sb, d_st, d_se, d_sc;   // disp[b, t, e, c]
  long long x_sb, x_st;               // x[b, t, :]
  long long o_se, o_sb, o_sc;         // out[e, b, c, :]
  int vec_ok;                         // rows of x and out are 16-byte aligned
};

__device__ inline float to_float(float v) { return v; }
__device__ inline float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ inline void from_float(float* p, float v) { *p = v; }
__device__ inline void from_float(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// 16 bytes of a row, widened to fp32 / narrowed from it.
template <typename T> struct Vec16;

template <> struct Vec16<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* v) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    uint4 a;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = a;
  }
};

// grid: (E * B, ceil(C / CT), ceil(D / (blockDim.x * N))); each thread owns
// N consecutive columns of the block's CT output rows.
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS) moe_dispatch_kernel(const Params p) {
  constexpr int N = Vec16<T>::N;
  __shared__ float w[BT][CT];       // weights of the staged tokens, as fp32
  __shared__ int live[BT];          // token has a nonzero weight in the tile

  const int tid = threadIdx.x;
  const int e = blockIdx.x / p.B;
  const int b = blockIdx.x % p.B;
  const int c0 = blockIdx.y * CT;
  const int d0 = (blockIdx.z * blockDim.x + tid) * N;
  const bool has_cols = d0 < p.D;
  const bool vec = p.vec_ok && d0 + N <= p.D;

  const T* disp = static_cast<const T*>(p.disp) + b * p.d_sb + e * p.d_se + c0 * p.d_sc;
  const T* x = static_cast<const T*>(p.x) + b * p.x_sb + d0;

  float acc[CT][N];
#pragma unroll
  for (int c = 0; c < CT; ++c)
#pragma unroll
    for (int i = 0; i < N; ++i) acc[c][i] = 0.f;

  for (int t0 = 0; t0 < p.T; t0 += BT) {
    const int nt = min(BT, p.T - t0);
    // stage: one thread a token, its CT weights
    for (int r = tid; r < BT; r += blockDim.x) {
      int any = 0;
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        float v = 0.f;
        if (r < nt && c0 + c < p.C) v = to_float(disp[(t0 + r) * p.d_st + c * p.d_sc]);
        w[r][c] = v;
        any |= (v != 0.f);
      }
      live[r] = any;
    }
    __syncthreads();
    // the branch on live[r] and on each weight is the same for every thread
    for (int r = 0; r < nt; ++r) {
      if (!live[r] || !has_cols) continue;
      const T* row = x + (t0 + r) * p.x_st;
      float xv[N];
      if (vec) {
        Vec16<T>::load(row, xv);
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) xv[i] = d0 + i < p.D ? to_float(row[i]) : 0.f;
      }
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const float wc = w[r][c];
        if (wc != 0.f) {
#pragma unroll
          for (int i = 0; i < N; ++i) acc[c][i] = fmaf(wc, xv[i], acc[c][i]);
        }
      }
    }
    __syncthreads();
  }

  if (!has_cols) return;
  T* out = static_cast<T*>(p.out) + e * p.o_se + b * p.o_sb + d0;
#pragma unroll
  for (int c = 0; c < CT; ++c) {
    if (c0 + c >= p.C) break;
    T* dst = out + (c0 + c) * p.o_sc;
    if (vec) {
      Vec16<T>::store(dst, acc[c]);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i)
        if (d0 + i < p.D) from_float(dst + i, acc[c][i]);
    }
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int N = Vec16<T>::N;
  // as many threads as the columns need, in whole warps, at most MAX_THREADS
  const int chunks = (p.D + N - 1) / N;
  const int in_warps = ((chunks + 31) / 32) * 32;
  const int threads = in_warps < MAX_THREADS ? in_warps : MAX_THREADS;
  const long long d_tiles = (chunks + threads - 1) / threads;
  const long long c_tiles = (p.C + CT - 1) / CT;
  const long long rows = (long long)p.E * p.B;
  if (rows > 0x7fffffffLL || c_tiles > 65535 || d_tiles > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)rows, (unsigned)c_tiles, (unsigned)d_tiles);
  moe_dispatch_kernel<T><<<grid, threads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (disp, x and out alike).  strides: 9
// element strides in the order disp(b,t,e,c) x(b,t) out(e,b,c); the innermost
// strides of x and out are 1.  Returns the cudaError_t of the launch
// (0 = ok); it does not synchronise.
extern "C" int moe_dispatch_fwd(
    const void* disp, const void* x, void* out,
    int B, int T, int E, int C, int D, int dtype,
    const long long* strides, int vec_ok, void* stream) {
  Params p;
  p.disp = disp; p.x = x; p.out = out;
  p.B = B; p.T = T; p.E = E; p.C = C; p.D = D;
  p.d_sb = strides[0]; p.d_st = strides[1]; p.d_se = strides[2]; p.d_sc = strides[3];
  p.x_sb = strides[4]; p.x_st = strides[5];
  p.o_se = strides[6]; p.o_sb = strides[7]; p.o_sc = strides[8];
  p.vec_ok = vec_ok;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) err = launch<float>(p, s);
  else if (dtype == 1) err = launch<__nv_bfloat16>(p, s);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* moe_dispatch_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
