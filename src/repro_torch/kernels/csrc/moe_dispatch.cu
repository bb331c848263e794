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
// What bounds it on this card: bytes.  disp and x read once and out written
// once are the least traffic (93.3 MB at mixtral-8x22b's prefill shape,
// 0.028 ms at 3.35 TB/s); on the model's one-hot path there is one
// multiply-add per kept (token, slot) pair and column, so operations never
// bind.  The TPU kernel feeds (C, bt) x (bt, D) blocks to its matrix unit and
// carries the (C, D) sum in VMEM along a sequential token axis; a first port
// of that shape (one block per slot tile and column tile, every block walking
// all T tokens with a barrier every 64) read disp once per column tile and
// spent its time in a latency-bound walk, 8.9x its bound.
//
// This design compacts first, then gathers, in one launch:
//  * One block owns (a tile of CT = 8 slots, expert e, batch row b) and every
//    column: grid (ceil(C / 8), E, B), 640 blocks of 256 threads at prefill.
//    At 48 registers a thread (one chunk in flight a warp) and 16.6 KB of
//    shared memory, five blocks fit an SM: the whole grid is one wave on 132
//    SMs, with no second, mostly empty wave.  The batch row is the slowest
//    grid axis, so the experts of one row run together and the row's x
//    (6.3 MB) stays in L2 for both of a token's experts.
//  * Compaction: each thread reads one token's 8 weights disp[b, t, e,
//    c0:c0+8] as one 16-byte load (fp32: two), so every weight is read once.
//    A ballot over the warp, per slot, finds the tokens with a nonzero weight;
//    their ranks within the warp (popc of the ballot below the lane) and the
//    counts of the warps before it give each one its place in the slot's list
//    of (t, w) in shared memory, in ascending t; 256 tokens a pass, three
//    barriers a pass.
//  * Gather: the block's rows out[e, b, c, :] are cut into chunks of 32 lanes
//    x 16 bytes; each warp takes one at a time and walks the slot's list in
//    order: a 16-byte load of the row of x, an fp32 multiply-add per element,
//    and one rounding and a 16-byte streaming store (st.global.cs: out is not
//    read again here, so it does not push x out of L2).  A slot with an empty
//    list (about 1 in 5 at mixtral's routing with capacity factor 1.25) is
//    written as zeros without a read.  Each kept row of x is read once per
//    slot that holds it (K = 2 times for top-2 routing, the second mostly
//    from L2); out is written once.
//  * A list holds L = 256 entries.  When a slot of the block has more nonzero
//    weights than that (dense weights over T > 256 tokens: not the model's
//    path), the block switches to token ranges of L tokens: for each chunk it
//    rebuilds the lists range by range, in order, and carries the fp32 sums
//    in registers across the ranges, so the sum stays in ascending t.
//  * One token (a decode step, T = 1) takes a kernel of its own with no list:
//    each thread reads its 16 bytes of the token's row of x and the block's
//    weights together, one round trip, and writes w x rounded once (zeros
//    where w = 0), as the lists would give it; each row is spread over
//    ceil(D / 2048) blocks (96 blocks at mixtral's decode).
//  * Skipping a zero weight leaves the same sum in the same token order for
//    any finite x, so a dense `disp` gets the general function.  The one
//    difference from the einsum: a NaN or inf in x under a zero weight gives
//    NaN there (0 * inf) and nothing here.
//  * Any T, C, D >= 1: ragged edges are masked, nothing is padded.  disp comes
//    with four element strides and x with two (innermost stride 1), so the
//    caller's layout is read in place; weights are read 16 bytes a thread when
//    the slot axis is innermost and aligned, rows of x and out 16 bytes a lane
//    when aligned, element by element otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CT = 8;               // capacity slots a block owns
constexpr int THREADS = 256;        // one token a thread while compacting
constexpr int WARPS = THREADS / 32;
constexpr int L = 256;              // entries a slot's list holds (and tokens in a range)

struct Params {
  const void* disp;
  const void* x;
  void* out;
  int B, T, E, C, D;
  long long d_sb, d_st, d_se, d_sc;   // disp[b, t, e, c]
  long long x_sb, x_st;               // x[b, t, :]
  long long o_se, o_sb, o_sc;         // out[e, b, c, :]
  int vec_ok;                         // rows of x and out are 16-byte aligned
  int disp_vec;                       // disp[b, t, e, c0:c0+8] is one aligned run
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
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
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
    __stcs(reinterpret_cast<uint4*>(p), a);
  }
};

// The CT weights of one token for the block's slots, as fp32 (zeros past C).
template <typename T>
__device__ inline void read_weights(const Params& p, const T* row, int nc, float (&w)[CT]) {
  if (p.disp_vec && nc == CT) {
#pragma unroll
    for (int c = 0; c < CT; c += Vec16<T>::N) Vec16<T>::load(row + c, w + c);
  } else {
#pragma unroll
    for (int c = 0; c < CT; ++c) w[c] = c < nc ? to_float(row[c * p.d_sc]) : 0.f;
  }
}

struct Lists {
  int t[CT][L];            // token of each entry, ascending
  float w[CT][L];          // its weight
  int count[CT];           // entries appended (may pass L: then the block works in ranges)
  int warp_count[WARPS][CT];
};

// Appends the nonzero weights of tokens [t0, t1), t1 - t0 <= THREADS, one a
// thread, to the slots' lists in ascending t.  Entries past L are counted,
// not kept.  Called by every thread of the block; ends with a barrier.
template <typename T>
__device__ void compact(const Params& p, Lists& ls, const T* dsp, int t0, int t1, int nc) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = t0 + tid;
  float w[CT];
  if (t < t1) {
    read_weights(p, dsp + t * p.d_st, nc, w);
  } else {
#pragma unroll
    for (int c = 0; c < CT; ++c) w[c] = 0.f;
  }
  unsigned rank[CT];       // the nonzeros below this lane in the warp
#pragma unroll
  for (int c = 0; c < CT; ++c) {
    const unsigned mask = __ballot_sync(0xffffffffu, w[c] != 0.f);
    if (lane == 0) ls.warp_count[warp][c] = __popc(mask);
    rank[c] = __popc(mask & ((1u << lane) - 1u));
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < CT; ++c) {
    if (w[c] != 0.f) {
      int at = ls.count[c] + rank[c];
      for (int v = 0; v < warp; ++v) at += ls.warp_count[v][c];
      if (at < L) {
        ls.t[c][at] = t;
        ls.w[c][at] = w[c];
      }
    }
  }
  __syncthreads();
  if (tid < CT) {
    int n = 0;
    for (int v = 0; v < WARPS; ++v) n += ls.warp_count[v][tid];
    ls.count[tid] += n;
  }
  __syncthreads();
}

// acc += the first n entries of slot c's list times x at the lane's columns
// col .. col + N - 1, in list order, one fmaf an element
template <typename T>
__device__ inline void accumulate(const Params& p, const Lists& ls, const T* x, int c, int n, int col,
                                  float (&acc)[Vec16<T>::N]) {
  constexpr int N = Vec16<T>::N;
  for (int k = 0; k < n; ++k) {
    const float wk = ls.w[c][k];
    const T* row = x + ls.t[c][k] * p.x_st + col;
    float xv[N];
    if (p.vec_ok && col + N <= p.D) {
      Vec16<T>::load(row, xv);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) xv[i] = col + i < p.D ? to_float(row[i]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = fmaf(wk, xv[i], acc[i]);
  }
}

// grid: (ceil(C / CT), E, B), THREADS threads; T >= 2.
template <typename T>
__global__ void __launch_bounds__(THREADS, 5) moe_dispatch_kernel(const Params p) {
  constexpr int N = Vec16<T>::N;
  constexpr int CHUNK = 32 * N;     // columns of a row one warp pass covers
  __shared__ Lists ls;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * CT, e = blockIdx.y, b = blockIdx.z;
  const int nc = min(CT, p.C - c0);
  const T* dsp = static_cast<const T*>(p.disp) + b * p.d_sb + e * p.d_se + c0 * p.d_sc;
  const T* x = static_cast<const T*>(p.x) + b * p.x_sb;
  T* out = static_cast<T*>(p.out) + e * p.o_se + b * p.o_sb + c0 * p.o_sc;

  // the lists over all T tokens, unless some slot holds more than L
  if (tid < CT) ls.count[tid] = 0;
  __syncthreads();
  bool ranged = false;
  for (int t0 = 0; t0 < p.T && !ranged; t0 += THREADS) {
    compact(p, ls, dsp, t0, min(p.T, t0 + THREADS), nc);
#pragma unroll
    for (int c = 0; c < CT; ++c) ranged |= ls.count[c] > L;     // the same in every thread
  }

  // warp w takes the (slot, chunk of columns) pairs w, w + WARPS, ...
  const int chunks = (p.D + CHUNK - 1) / CHUNK;
  const int items = nc * chunks;
  for (int i0 = 0; i0 < items; i0 += WARPS) {
    const int item = i0 + warp;
    const int c = item < items ? item / chunks : 0, col = (item % chunks) * CHUNK + lane * N;
    const bool mine = item < items && col < p.D;
    float acc[N];
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = 0.f;
    if (!ranged) {
      if (mine) accumulate(p, ls, x, c, min(ls.count[c], L), col, acc);
    } else {
      for (int r0 = 0; r0 < p.T; r0 += L) {     // rebuild the lists for tokens [r0, r0 + L)
        __syncthreads();                         // the previous range's lists are read
        if (tid < CT) ls.count[tid] = 0;
        __syncthreads();
        for (int t0 = r0; t0 < min(p.T, r0 + L); t0 += THREADS)
          compact(p, ls, dsp, t0, min(p.T, min(r0 + L, t0 + THREADS)), nc);
        if (mine) accumulate(p, ls, x, c, ls.count[c], col, acc);
      }
    }
    if (!mine) continue;
    T* dst = out + c * p.o_sc + col;
    if (p.vec_ok && col + N <= p.D) {
      Vec16<T>::store(dst, acc);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i)
        if (col + i < p.D) from_float(dst + i, acc[i]);
    }
  }
}

// One token (a decode step): each thread reads its 16 bytes of the token's
// row of x and the block's weights together, one round trip and no list; w x
// rounded once as the lists would give it, zeros where w = 0.
// grid: (ceil(C / CT) dsplit, E, B), dsplit = ceil(D / (THREADS 16-byte chunks)).
template <typename T>
__global__ void __launch_bounds__(THREADS) moe_dispatch_token_kernel(const Params p) {
  constexpr int N = Vec16<T>::N;
  const int dsplit = (p.D + THREADS * N - 1) / (THREADS * N);
  const int c0 = (blockIdx.x / dsplit) * CT, e = blockIdx.y, b = blockIdx.z;
  const int nc = min(CT, p.C - c0);
  const T* dsp = static_cast<const T*>(p.disp) + b * p.d_sb + e * p.d_se + c0 * p.d_sc;
  const T* x = static_cast<const T*>(p.x) + b * p.x_sb;
  T* out = static_cast<T*>(p.out) + e * p.o_se + b * p.o_sb + c0 * p.o_sc;
  const int col = ((blockIdx.x % dsplit) * THREADS + threadIdx.x) * N;
  if (col >= p.D) return;
  const bool vec = p.vec_ok && col + N <= p.D;
  float xv[N];
  if (vec) {
    Vec16<T>::load(x + col, xv);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) xv[i] = col + i < p.D ? to_float(x[col + i]) : 0.f;
  }
#pragma unroll
  for (int c = 0; c < CT; ++c) {
    if (c >= nc) break;
    const float wk = to_float(dsp[c * p.d_sc]);
    float v[N];
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = wk != 0.f ? fmaf(wk, xv[i], 0.f) : 0.f;
    T* dst = out + c * p.o_sc + col;
    if (vec) {
      Vec16<T>::store(dst, v);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i)
        if (col + i < p.D) from_float(dst + i, v[i]);
    }
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int N = Vec16<T>::N;
  const long long dsplit = p.T == 1 ? (p.D + THREADS * N - 1) / (THREADS * N) : 1;
  const long long blocks_x = (p.C + CT - 1) / CT * dsplit;
  if (blocks_x > 0x7fffffffLL || p.B > 65535 || p.E > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks_x, (unsigned)p.E, (unsigned)p.B);
  if (p.T == 1) moe_dispatch_token_kernel<T><<<grid, THREADS, 0, stream>>>(p);
  else moe_dispatch_kernel<T><<<grid, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (disp, x and out alike).  strides: 9
// element strides in the order disp(b,t,e,c) x(b,t) out(e,b,c); the innermost
// strides of x and out are 1.  vec_ok: rows of x and out are 16-byte aligned;
// disp_vec: the slot axis of disp has stride 1 and every run of 8 slots from
// a multiple of 8 is 16-byte aligned.  Returns the cudaError_t of the launch
// (0 = ok); it does not synchronise.
extern "C" int moe_dispatch_fwd(
    const void* disp, const void* x, void* out,
    int B, int T, int E, int C, int D, int dtype,
    const long long* strides, int vec_ok, int disp_vec, void* stream) {
  Params p;
  p.disp = disp; p.x = x; p.out = out;
  p.B = B; p.T = T; p.E = E; p.C = C; p.D = D;
  p.d_sb = strides[0]; p.d_st = strides[1]; p.d_se = strides[2]; p.d_sc = strides[3];
  p.x_sb = strides[4]; p.x_st = strides[5];
  p.o_se = strides[6]; p.o_sb = strides[7]; p.o_sc = strides[8];
  p.vec_ok = vec_ok;
  p.disp_vec = disp_vec;
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
